"""Data-parallel incremental-count (v2) BPE training over a data mesh.

PyTorch counterpart of ``youtokentome_tpu/parallel/train_delta_sharded.py``:

  * the flat token stream is split across the mesh at word boundaries
    (``_shard_stream``, the JAX package's split): pairs never cross words,
    so the shards count and merge on their own;
  * the exact pair-count table is replicated: candidate selection and the
    prefix acceptance are the same on every shard;
  * per round each shard merges the accepted rules and extracts its
    bounded ``[2*dcap]`` old/new delta buffers, and the shards exchange
    only those; a round in which some shard's buffer overflows (the JAX
    ``lax.pmax``) exchanges every shard's full recount instead.

``train_rounds_delta_sharded`` is the plain version of the JAX program
``_train_delta_sharded``, branch for branch, over N front-compacted
streams: its ``all_gather`` is a ``torch.cat`` of the shards' buffers in
shard order, its ``pmax`` a max over the shards' flags.  By default
``run_training_delta_sharded`` runs the rounds through the kernels of
``ops/delta_sharded_kernels.py`` (hand-written CUDA on the cards, their
plain versions on the CPU); ``plain=True`` runs the plain loop, whose
progress lines equal the JAX host loop's.  Both give the rules of the
one-device trainer at any shard count.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from ..ops.train_delta import (
    _affected_positions,
    _delta_contributions,
    _fit_table,
    _full_recount,
    _next_pow2,
    _pcap_budget,
    _reduce_by_key,
    _unpack_key,
    host_count_table,
)
from ..ops.train_stream import (
    PAD,
    _topk_candidates,
    accept_prefix,
    apply_accepted,
    flatten_word_buckets,
    learned_rules,
    load_snapshot,
    pair_hits,
    run_segments,
    store_rules,
)
from .mesh import DataMesh, data_mesh


def _shard_stream(t, wid, n_dev: int):
    """Split the flat stream into n_dev word-aligned shards, each padded
    to a common power-of-two capacity (the JAX package's
    ``train_sparse_sharded._shard_stream``)."""
    n_live = int((wid >= 0).sum())
    starts = np.nonzero((wid >= 0) & np.concatenate([[True], wid[1:] != wid[:-1]]))[0]
    bounds = [0]
    for d in range(1, n_dev):
        target = d * n_live // n_dev
        j = int(np.searchsorted(starts, target))
        bounds.append(int(starts[min(j, starts.size - 1)]) if starts.size else 0)
    bounds.append(n_live)
    seg_lens = [bounds[d + 1] - bounds[d] for d in range(n_dev)]
    per = max(16, 1 << int(np.ceil(np.log2(max(max(seg_lens), 1)))))
    seg_t = np.full((n_dev, per), PAD, np.int32)
    seg_w = np.full((n_dev, per), PAD, np.int32)
    for d in range(n_dev):
        seg = slice(bounds[d], bounds[d + 1])
        seg_t[d, : seg_lens[d]] = t[seg]
        seg_w[d, : seg_lens[d]] = wid[seg]
    return seg_t, seg_w, per


def shard_plan(t, wid, n_dev: int):
    """The JAX host loop's split and exchange size: (seg_t, seg_w, per,
    dcap).  dcap sizes the per-round delta exchange only (the recount
    branch has its own buffers), so it tracks the typical per-round site
    count; ``YTTM_TRAIN_DCAP`` sets it."""
    seg_t, seg_w, per = _shard_stream(np.asarray(t), np.asarray(wid), n_dev)
    dcap = int(os.environ.get("YTTM_TRAIN_DCAP", "0")) or _next_pow2(
        min(max(1 << 12, per >> 6), 1 << 17)
    )
    return seg_t, seg_w, per, dcap


def train_rounds_delta_sharded(
    ts, wids, freqs, tk, tc, rules, used, used_ids0, limit, vocab_size,
    batch_k=16, pcap=1 << 16, dcap=1 << 12,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, no
    candidate is accepted (done), or the live table exceeds ``pcap``.

    Plain torch version of the JAX ``_train_delta_sharded``: ``ts``/``wids``
    hold each shard's front-compacted stream ([per] int32, on the shard's
    device), ``freqs`` the replicated word frequencies (one a shard); the
    replicated table ``tk``/``tc`` and ``rules`` (updated in place) live on
    one device.  Returns (ts, wids, tk, tc, used, done, overflow, recount
    rounds, each shard's live tokens)."""
    kb = batch_k
    used = int(used)
    ts = [t.to(torch.int32) for t in ts]
    wids = [w.to(torch.int32) for w in wids]
    fws = [(f[w.clamp(min=0).long()] * (w >= 0)).to(torch.int32) for f, w in zip(freqs, wids)]
    home = tk.device
    done = overflow = False
    n_rec = 0
    while not done and not overflow and used < min(vocab_size, int(limit)):
        # replicated candidate selection
        xs, ys = _unpack_key(tk)
        cc, cx, cy = _topk_candidates(tc, xs, ys, kb)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, kb)
        done = n_acc == 0

        # shard-local delta extraction and apply
        deltas, flags = [], []
        for d, (t, wid, fw) in enumerate(zip(ts, wids, fws)):
            a, x, y, z = (v.to(t.device) for v in (acc, cx, cy, zs))
            hit, rix = pair_hits(t, wid, a, x, y)
            aff = _affected_positions(t, wid, hit)
            dk_old, dv_old, _, of_old = _delta_contributions(t, wid, fw, aff, dcap, -1)
            t2, w2, fw2, aff2 = apply_accepted(
                t, wid, a, x, y, z, extra=(fw, aff.to(torch.int32)), hit=hit, rix=rix
            )
            dk_new, dv_new, _, of_new = _delta_contributions(t2, w2, fw2, aff2 != 0, dcap, 1)
            ts[d], wids[d], fws[d] = t2, w2, fw2
            deltas.append((dk_old, dv_old, dk_new, dv_new))
            flags.append(int(of_old or of_new))

        # the delta-vs-recount decision is global (the JAX pmax)
        if max(flags) > 0:
            parts = [_full_recount(t, w, fw, pcap) for t, w, fw in zip(ts, wids, fws)]
            tk, tc, n_live = _reduce_by_key(
                torch.cat([p[0].to(home) for p in parts]),
                torch.cat([p[1].to(home) for p in parts]),
                pcap,
            )
            n_rec += 1
        else:
            gk = torch.cat([torch.cat([d[0], d[2]]).to(home) for d in deltas])
            gv = torch.cat([torch.cat([d[1], d[3]]).to(home) for d in deltas])
            tk, tc, n_live = _reduce_by_key(torch.cat([tk, gk]), torch.cat([tc, gv]), pcap)
        overflow = n_live > pcap
        store_rules(rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
        used += n_acc
    n_stream = [int((t >= 0).sum()) for t in ts]
    return ts, wids, tk, tc, used, done, overflow, n_rec, n_stream


class PlainShardedEngine:
    """Segments of ``train_rounds_delta_sharded`` with the JAX host loop's
    table sizing, overflow retry and re-packing (a slice of every shard to
    the largest live count's power of two, once it halves)."""

    nrec = 0

    def __init__(self, seg_t, seg_w, per: int, freq, rules, used_ids0: int, vocab_size: int,
                 batch_k: int, mesh: DataMesh, pcap: int, dcap: int, table):
        self.vocab_size = vocab_size
        self.used_ids0 = used_ids0
        self.batch_k = batch_k
        self.n = mesh.size
        self.home = mesh.devices[0]
        self.ts = [torch.from_numpy(seg_t[d]).to(dev) for d, dev in enumerate(mesh.devices)]
        self.ws = [torch.from_numpy(seg_w[d]).to(dev) for d, dev in enumerate(mesh.devices)]
        freq = torch.from_numpy(np.ascontiguousarray(freq, np.int32))
        self.freqs = [freq.to(dev) for dev in mesh.devices]
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(self.home)
        self.per, self.pcap, self.dcap = per, pcap, dcap
        self.tk, self.tc = _fit_table(*table, pcap, self.home)
        self.repack = os.environ.get("YTTM_TRAIN_REPACK", "1") != "0"
        self.repack_min = int(os.environ.get("YTTM_TRAIN_REPACK_MIN", str(1 << 14)))

    def segment(self, used: int, limit: int):
        self.ts, self.ws, self.tk, self.tc, used, done, overflow, self.nrec, n_stream = (
            train_rounds_delta_sharded(
                self.ts, self.ws, self.freqs, self.tk, self.tc, self.rules, used,
                self.used_ids0, limit, self.vocab_size, self.batch_k, self.pcap, self.dcap,
            )
        )
        if self.repack and not overflow:
            md = _next_pow2(max(max(n_stream), self.repack_min))
            if md < self.per:
                self.ts = [t[:md] for t in self.ts]
                self.ws = [w[:md] for w in self.ws]
                self.per = md
        return used, done, overflow

    def regrow(self):
        """After an overflow: double pcap and recount from the streams."""
        self.pcap *= 2
        t, wid, freq = (x.cpu().numpy() for x in self.stream())
        live = t >= 0
        uk, uc = host_count_table(t[live], wid[live], freq)
        while self.pcap < uk.size:
            self.pcap *= 2
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, self.home)

    def detail(self) -> str:
        return (
            f"; {self.nrec} recount rounds this segment, exchange "
            f"{self.n}x{2 * self.dcap} delta / {self.n}x{self.pcap} recount keys"
        )

    def stream(self):
        t = torch.cat([t.cpu() for t in self.ts])
        wid = torch.cat([w.cpu() for w in self.ws])
        return t, wid, self.freqs[0]


def make_engine(t, wid, freq, rules, used: int, used_ids0: int, vocab_size: int,
                mesh: DataMesh, batch_k: int = 16, plain: bool = False):
    """The engine that the host loop drives over ``mesh`` from the stream
    ``t``/``wid`` (``used`` ids learned): the stream split by
    ``shard_plan``, then the plain round loop with the JAX host loop's
    ``pcap`` (``plain``) or the kernel engine."""
    t, wid = np.asarray(t), np.asarray(wid)
    seg_t, seg_w, per, dcap = shard_plan(t, wid, mesh.size)
    if plain:
        uk, uc = host_count_table(t, wid, freq)
        # the JAX host loop's budget: its merges left are counted from `used`
        pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used), _next_pow2(int((wid >= 0).sum()) or 1)
        )
        return PlainShardedEngine(
            seg_t, seg_w, per, freq, rules, used_ids0, vocab_size, batch_k, mesh, pcap, dcap,
            (uk, uc),
        )
    from ..ops.delta_sharded_kernels import ShardedKernelEngine

    return ShardedKernelEngine(
        seg_t, seg_w, per, freq, rules, used_ids0, vocab_size, batch_k, mesh, dcap,
        int(t.shape[0]),
    )


def run_training_delta_sharded(
    buckets,
    used_ids0: int,
    vocab_size: int,
    mesh: DataMesh | None = None,
    batch_k: int = 16,
    progress_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume_path: str | None = None,
    progress_cb=None,
    plain: bool = False,
) -> List[Tuple[int, int, int]]:
    """The sharded host loop, with the JAX host loop's contract: the shard
    split, ``pcap`` and ``dcap``, segments of at most ``progress_every``,
    ``checkpoint_every``, 1024 (re-packing) or 1000 ids (the merge log),
    the overflow retry, progress lines with the recount rounds and the
    exchange sizes, and checkpoints in the shared snapshot format.  Rules
    equal the one-device trainer's at any shard count.  ``mesh`` defaults
    to every visible card; ``plain`` picks the plain round loop over the
    kernels."""
    mesh = mesh or data_mesh()
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    if resume_path:
        t, wid, freq, rules, used = load_snapshot(resume_path, used_ids0, vocab_size)
    else:
        t, wid, freq = flatten_word_buckets(buckets)
        rules = np.full((vocab_size, 4), -1, dtype=np.int32)
        used = used_ids0
    engine = make_engine(t, wid, freq, rules, used, used_ids0, vocab_size, mesh, batch_k, plain)
    repack = os.environ.get("YTTM_TRAIN_REPACK", "1") != "0"
    seg = min(
        x
        for x in (
            progress_every,
            checkpoint_every,
            1024 if repack else 0,
            1000 if progress_cb else 0,
            vocab_size,
        )
        if x
    )
    used = run_segments(
        engine, used, used_ids0, vocab_size, seg, progress_every, checkpoint_path,
        checkpoint_every, progress_cb, engine.detail,
    )
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
