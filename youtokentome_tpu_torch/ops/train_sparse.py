"""The v3 site-local trainer: a tombstoned stream whose positions never move.

PyTorch counterpart of ``youtokentome_tpu/ops/train_sparse.py``.  A merge
writes z at the selected pair starts and PAD (a tombstone) at their live
partners, in place; adjacency and run parity are taken over the live
subsequence (live-rank space), so ``wid`` and the per-position word
frequencies never change.  The exact pair-count table is kept across
rounds and moved by the deltas of the words with a merge site, gathered
into a small or a large site buffer (``dcap0``/``dcap1``), with a full
recount when both overflow.

``train_rounds_sparse`` is the plain version of the JAX program, branch
for branch (any device); ``run_training_sparse`` is the host loop, by
default through the kernels of ``ops/sparse_kernels.py``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from .train_delta import (
    PADKEY,
    _affected_positions,
    _fit_table,
    _next_pow2,
    _pack_keys,
    _pcap_budget,
    _reduce_by_key,
    _unpack_key,
    host_count_table,
)
from .train_stream import (
    BIG,
    PAD,
    _last_index,
    _topk_candidates,
    accept_prefix,
    flatten_word_buckets,
    learned_rules,
    load_snapshot,
    run_segments,
    segment_ids,
    store_rules,
)


def _rank_last(cond: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The JAX cummax(where(cond, d, -1)) for a non-decreasing ``d``."""
    j = _last_index(cond)
    return torch.where(j >= 0, d[j.clamp(min=0)], torch.full_like(d, -1))


def _pairs_tomb(t, wid, fw):
    """Pair keys and parity-masked weights over a tombstoned stream: each
    live position pairs with its next live neighbour in the same word, and
    run parity is taken in live-rank space.  Returns (keys int64, w int32,
    live, d), d the 0-based live rank."""
    n = t.shape[0]
    live = t >= 0
    d = torch.cumsum(live.to(torch.int64), 0) - 1
    # the first live position at or after each position (n when none)
    first = n - 1 - _last_index(live.flip(0)).flip(0)
    nl = torch.cat([first[1:], torch.full((1,), n, dtype=first.dtype, device=t.device)])
    nl_c = nl.clamp(max=n - 1)
    tn = t[nl_c]
    wn = wid[nl_c]
    haspair = live & (nl < n) & (wid >= 0) & (wid == wn)
    eq = haspair & (t == tn)
    off = d - _rank_last(live & ~eq, d) - 1
    counted = haspair & (~eq | (off % 2 == 0))
    w = torch.where(counted, fw, torch.zeros_like(fw)).to(torch.int32)
    keys = _pack_keys(torch.where(haspair, t, torch.full_like(t, BIG)), tn)
    return keys, w, live, d


def _apply_tomb(t, keys, live, d, acc, cx, cy, zs):
    """Merge every accepted rule's occurrences in place: selected pair
    starts take z, their live partners become PAD tombstones; parity
    inside runs of hits in live-rank space."""
    ak = _pack_keys(cx, cy)
    hitk = acc[None, :] & (keys[:, None] == ak[None, :])
    hit = hitk.any(dim=1)
    rix = hitk.to(torch.int8).argmax(dim=1)
    sel = hit & ((d - _rank_last(live & ~hit, d) - 1) % 2 == 0)
    kill = live & ~sel & (d > 0) & (_rank_last(live & sel, d) == d - 1)
    t2 = torch.where(sel, zs[rix], t)
    return torch.where(kill, torch.full_like(t2, PAD), t2), hit


def _gather_affected(cs: torch.Tensor, dcap: int):
    """Positions of the first ``dcap`` set bits of the mask whose cumsum
    is ``cs`` (a batched binary search)."""
    tgt = torch.arange(1, dcap + 1, dtype=cs.dtype, device=cs.device)
    pos = torch.searchsorted(cs, tgt, side="left")
    return pos, tgt <= cs[-1]


def _site_buffers(dcap, t2, wid, fw, keys, w, cs):
    """The site buffers of the first ``dcap`` affected positions: their old
    contributions (keys ``ko``, weights ``wo``, gathered from the pre-apply
    pairs) and the gathered mini-stream's new ones (``kn``, ``wn``)."""
    pos, validj = _gather_affected(cs, dcap)
    posc = pos.clamp(max=t2.shape[0] - 1)
    ko = torch.where(validj, keys[posc], torch.full_like(keys[posc], PADKEY))
    wo = torch.where(validj, w[posc], torch.zeros_like(w[posc]))
    tt = torch.where(validj, t2[posc], torch.full_like(t2[posc], PAD))
    twid = torch.where(validj, wid[posc], torch.full_like(wid[posc], -1))
    tfw = torch.where(validj, fw[posc], torch.zeros_like(fw[posc]))
    kn, wn, _, _ = _pairs_tomb(tt, twid, tfw)
    return ko, wo, kn, wn


def _tier_update(dcap, t2, wid, fw, keys, w, cs, tk, tc, pcap):
    """A site-buffer round: the old contributions of the affected
    positions out, the gathered mini-stream's new contributions in,
    folded into the table."""
    ko, wo, kn, wn = _site_buffers(dcap, t2, wid, fw, keys, w, cs)
    return _reduce_by_key(torch.cat([tk, ko, kn]), torch.cat([tc, -wo, wn]), pcap)


def _recount(t2, wid, fw, pcap):
    """The fallback: every pair of the tombstoned stream counted again."""
    kf, wf, _, _ = _pairs_tomb(t2, wid, fw)
    return _reduce_by_key(kf, wf, pcap)


def train_rounds_sparse(
    t, wid, freq, tk, tc, rules, used, used_ids0, limit, vocab_size,
    batch_k=16, pcap=1 << 16, dcap0=1 << 15, dcap1=1 << 19,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, no
    candidate is accepted (done), or the live table exceeds ``pcap``
    (overflow; the host retries with 2x pcap).  Plain torch version of the
    JAX program on any device: ``t`` [M] int32 tombstoned, ``wid`` [M]
    int32 static, ``tk`` [pcap] int64 keys (PADKEY fill) with ``tc`` [pcap]
    int32 counts, ``rules`` [vocab_size, 4] int32 (updated in place).
    Returns (t, tk, tc, rules, used, done, overflow)."""
    kb = batch_k
    used = int(used)
    t = t.to(torch.int32)
    fw = (freq[wid.clamp(min=0).long()] * (wid >= 0)).to(torch.int32)
    done = overflow = False
    while not done and not overflow and used < min(vocab_size, int(limit)):
        xs, ys = _unpack_key(tk)
        cc, cx, cy = _topk_candidates(tc, xs, ys, kb)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, kb)
        done = n_acc == 0
        if done:  # no merge: the stream and the table stay as they are
            break
        keys, w, live, d = _pairs_tomb(t, wid, fw)
        t2, hit = _apply_tomb(t, keys, live, d, acc, cx, cy, zs)
        cs = torch.cumsum(_affected_positions(t, wid, hit).to(torch.int64), 0)
        n_aff = int(cs[-1])
        if n_aff <= dcap0:
            tk, tc, n_live = _tier_update(dcap0, t2, wid, fw, keys, w, cs, tk, tc, pcap)
        elif n_aff <= dcap1:
            tk, tc, n_live = _tier_update(dcap1, t2, wid, fw, keys, w, cs, tk, tc, pcap)
        else:
            tk, tc, n_live = _recount(t2, wid, fw, pcap)
        overflow = n_live > pcap
        store_rules(rules, acc, cx, cy, cc, zs, int(used_ids0), vocab_size)
        used += n_acc
        t = t2
    return t, tk, tc, rules, used, done, overflow


def _host_table_tomb(t: np.ndarray, wid: np.ndarray, freq: np.ndarray):
    """host_count_table over a tombstoned stream (its live subsequence)."""
    t = np.asarray(t)
    wid = np.asarray(wid)
    live = t >= 0
    return host_count_table(t[live], wid[live], freq)


def site_caps(m: int):
    """The JAX host loop's site buffers (``YTTM_TRAIN_DCAP0``/``DCAP1``)."""
    dcap0 = int(os.environ.get("YTTM_TRAIN_DCAP0", "0")) or _next_pow2(
        min(max(1 << 14, m >> 6), 1 << 17)
    )
    dcap1 = int(os.environ.get("YTTM_TRAIN_DCAP1", "0")) or _next_pow2(max(dcap0 * 2, m >> 3))
    return dcap0, dcap1


class PlainSparseEngine:
    """Segments of ``train_rounds_sparse`` with the JAX host loop's table
    sizing and overflow retry."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.device, self.vocab_size, self.used_ids0, self.batch_k = device, vocab_size, used_ids0, batch_k
        self.t = torch.from_numpy(np.array(t, np.int32)).to(device)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(device)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(device)
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(device)
        m = int(self.t.shape[0])
        self.dcap0, self.dcap1 = site_caps(m)
        uk, uc = host_count_table(t, wid, freq)
        # live pair kinds never exceed the stream's positions
        self.pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used_ids0), _next_pow2(m)
        )
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, device)

    def segment(self, used: int, limit: int):
        self.t, self.tk, self.tc, self.rules, used, done, overflow = train_rounds_sparse(
            self.t, self.wid, self.freq, self.tk, self.tc, self.rules, used, self.used_ids0,
            limit, self.vocab_size, self.batch_k, self.pcap, self.dcap0, self.dcap1,
        )
        return used, done, overflow

    def regrow(self):
        """After an overflow: double pcap and count the live stream again."""
        self.pcap *= 2
        uk, uc = _host_table_tomb(self.t.cpu().numpy(), self.wid.cpu().numpy(), self.freq.cpu().numpy())
        while self.pcap < uk.size:
            self.pcap *= 2
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, self.device)

    def detail(self) -> str:
        return f", {int((self.tk != PADKEY).sum())} live pair kinds / pcap {self.pcap}"

    def stream(self):
        return self.t, self.wid, self.freq


def run_training_sparse(
    buckets,
    used_ids0: int,
    vocab_size: int,
    batch_k: int = 16,
    progress_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume_path: str | None = None,
    progress_cb=None,
    device="cpu",
    plain: bool = False,
) -> List[Tuple[int, int, int]]:
    """The v3 host loop, with the JAX package's contract (progress,
    checkpoints, resume; snapshots compact the tombstoned stream, so every
    trainer resumes them).  ``device`` holds the training state; ``plain``
    picks the plain round loop over the kernels."""
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    if resume_path:
        t, wid, freq, rules, used = load_snapshot(resume_path, used_ids0, vocab_size)
    else:
        t, wid, freq = flatten_word_buckets(buckets)
        rules = np.full((vocab_size, 4), -1, dtype=np.int32)
        used = used_ids0
    if plain:
        engine_cls = PlainSparseEngine
    else:
        from .sparse_kernels import SparseKernelEngine as engine_cls
    engine = engine_cls(t, wid, freq, rules, used_ids0, vocab_size, batch_k, torch.device(device))
    used = run_segments(
        engine, used, used_ids0, vocab_size,
        segment_ids(progress_every, checkpoint_every, progress_cb, vocab_size),
        progress_every, checkpoint_path, checkpoint_every, progress_cb, engine.detail,
    )
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
