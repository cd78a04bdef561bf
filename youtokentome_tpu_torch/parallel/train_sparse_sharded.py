"""Data-parallel site-local (v3) BPE training over a data mesh.

PyTorch counterpart of ``youtokentome_tpu/parallel/train_sparse_sharded.py``:

  * the tombstoned token stream is split across the mesh at word
    boundaries (``train_delta_sharded._shard_stream``, the JAX package's
    split): pairs never cross words, so the shards count and merge on their
    own;
  * the exact pair-count table is replicated: candidate selection and the
    prefix acceptance are the same on every shard;
  * per round each shard merges the accepted rules in place (tombstones)
    and extracts its bounded ``[2*dcap]`` old/new delta buffers of the
    affected positions, and the shards exchange only those; a round in
    which some shard's affected positions pass dcap (the JAX ``lax.pmax``)
    exchanges every shard's full recount instead.

``train_rounds_sparse_sharded`` is the plain version of the JAX program
``_train_sparse_sharded``, branch for branch, over N tombstoned streams:
its ``all_gather`` is a ``torch.cat`` of the shards' buffers in shard
order, its ``pmax`` a max over the shards' affected positions.  By default
``run_training_sparse_sharded`` runs the rounds through the kernels of
``ops/sparse_sharded_kernels.py`` (hand-written CUDA on the cards, their
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
    _next_pow2,
    _pcap_budget,
    _reduce_by_key,
    _unpack_key,
)
from ..ops.train_sparse import _apply_tomb, _host_table_tomb, _pairs_tomb, _site_buffers
from ..ops.train_stream import (
    _topk_candidates,
    accept_prefix,
    flatten_word_buckets,
    learned_rules,
    load_snapshot,
    run_segments,
    segment_ids,
    store_rules,
)
from .mesh import DataMesh, data_mesh
from .train_delta_sharded import PlainShardedEngine, shard_plan


def train_rounds_sparse_sharded(
    ts, wids, freqs, tk, tc, rules, used, used_ids0, limit, vocab_size,
    batch_k=16, pcap=1 << 16, dcap=1 << 12,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, no
    candidate is accepted (done), or the live table exceeds ``pcap``.

    Plain torch version of the JAX ``_train_sparse_sharded``: ``ts``/``wids``
    hold each shard's tombstoned stream and static word ids ([per] int32,
    on the shard's device), ``freqs`` the replicated word frequencies (one
    a shard); the replicated table ``tk``/``tc`` and ``rules`` (updated in
    place) live on one device.  Returns (ts, tk, tc, used, done, overflow,
    recount rounds)."""
    kb = batch_k
    used = int(used)
    ts = [t.to(torch.int32) for t in ts]
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
        if done:  # no merge: the streams and the table stay as they are
            break

        # shard-local tombstone apply and affected positions
        local = []
        for t, wid, fw in zip(ts, wids, fws):
            a, x, y, z = (v.to(t.device) for v in (acc, cx, cy, zs))
            keys, w, live, d = _pairs_tomb(t, wid, fw)
            t2, hit = _apply_tomb(t, keys, live, d, a, x, y, z)
            cs = torch.cumsum(_affected_positions(t, wid, hit).to(torch.int64), 0)
            local.append((t2, keys, w, cs))
        ts = [loc[0] for loc in local]

        # the delta-vs-recount decision is global (the JAX pmax)
        if max(int(cs[-1]) for *_, cs in local) > dcap:
            # each shard's full count reduced to [pcap] (its kind count
            # unchecked, as in the JAX recount fold), gathered and reduced
            parts = [
                _reduce_by_key(*_pairs_tomb(t2, wid, fw)[:2], pcap)
                for t2, wid, fw in zip(ts, wids, fws)
            ]
            tk, tc, n_live = _reduce_by_key(
                torch.cat([p[0].to(home) for p in parts]),
                torch.cat([p[1].to(home) for p in parts]),
                pcap,
            )
            n_rec += 1
        else:
            gk, gv = [tk], [tc]
            for (t2, keys, w, cs), wid, fw in zip(local, wids, fws):
                ko, wo, kn, wn = _site_buffers(dcap, t2, wid, fw, keys, w, cs)
                gk.append(torch.cat([ko, kn]).to(home))
                gv.append(torch.cat([-wo, wn]).to(home))
            tk, tc, n_live = _reduce_by_key(torch.cat(gk), torch.cat(gv), pcap)
        overflow = n_live > pcap
        store_rules(rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
        used += n_acc
    return ts, tk, tc, used, done, overflow, n_rec


class PlainSparseShardedEngine(PlainShardedEngine):
    """Segments of ``train_rounds_sparse_sharded`` with the JAX host loop's
    table sizing and overflow retry (the regrow counts the live tokens of
    the tombstoned streams); the streams never move, so nothing is
    re-packed."""

    def __init__(self, *args):
        super().__init__(*args)
        self.repack = False

    def segment(self, used: int, limit: int):
        self.ts, self.tk, self.tc, used, done, overflow, self.nrec = train_rounds_sparse_sharded(
            self.ts, self.ws, self.freqs, self.tk, self.tc, self.rules, used, self.used_ids0,
            limit, self.vocab_size, self.batch_k, self.pcap, self.dcap,
        )
        return used, done, overflow


def make_engine(t, wid, freq, rules, used: int, used_ids0: int, vocab_size: int,
                mesh: DataMesh, batch_k: int = 16, plain: bool = False):
    """The engine that the host loop drives over ``mesh`` from the
    tombstoned stream ``t``/``wid`` (``used`` ids learned): the stream
    split by ``shard_plan``, then the plain round loop with the JAX host
    loop's ``pcap`` (``plain``) or the kernel engine."""
    t, wid = np.asarray(t), np.asarray(wid)
    seg_t, seg_w, per, dcap = shard_plan(t, wid, mesh.size)
    if plain:
        uk, uc = _host_table_tomb(t, wid, freq)
        # the JAX host loop's budget: its merges left are counted from `used`
        pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used), _next_pow2(int((wid >= 0).sum()) or 1)
        )
        return PlainSparseShardedEngine(
            seg_t, seg_w, per, freq, rules, used_ids0, vocab_size, batch_k, mesh, pcap, dcap,
            (uk, uc),
        )
    from ..ops.sparse_sharded_kernels import SparseShardedKernelEngine

    return SparseShardedKernelEngine(
        seg_t, seg_w, freq, rules, used_ids0, vocab_size, batch_k, mesh, dcap, int(t.shape[0])
    )


def run_training_sparse_sharded(
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
    """The sharded v3 host loop, with the JAX host loop's contract: the
    shard split, ``pcap`` and ``dcap``, segments of at most
    ``progress_every``, ``checkpoint_every`` or 1000 ids (the merge log),
    the overflow retry, progress lines with the recount rounds and the
    exchange sizes, and checkpoints of the shards' streams in the shared
    snapshot format.  Rules equal the one-device trainer's at any shard
    count.  ``mesh`` defaults to every visible card; ``plain`` picks the
    plain round loop over the kernels."""
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
    used = run_segments(
        engine, used, used_ids0, vocab_size,
        segment_ids(progress_every, checkpoint_every, progress_cb, vocab_size),
        progress_every, checkpoint_path, checkpoint_every, progress_cb, engine.detail,
    )
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
