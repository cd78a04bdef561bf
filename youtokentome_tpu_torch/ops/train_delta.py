"""Incremental-count BPE trainer (v2): the plain torch round loop and the
host loop around it.

PyTorch counterpart of ``youtokentome_tpu/ops/train_delta.py``.  An exact
pair-count table is kept across rounds; each round takes the tie-ordered
top-k candidates from the table, accepts the longest non-intersecting
prefix, applies it to the stream, and updates the table by word-granular
deltas (the pair contributions of every word with a merge site, removed
before the apply and added after), with a full recount when the delta
volume overflows its buffer.

``train_rounds_delta`` is the plain version of the JAX device program,
step for step, on a flat front-compacted stream and a sorted table; it
runs on any device.  ``run_training_delta`` is the host loop.  By
default it runs the rounds through the trainer's kernels
(``ops/train_kernels.py``: hand-written CUDA on a card, their plain
versions on the CPU); ``plain=True`` runs ``train_rounds_delta`` instead.
Both give the JAX package's rules exactly.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from .train_stream import (
    BIG,
    PAD,
    _last_index,
    _topk_candidates,
    accept_prefix,
    apply_accepted,
    flatten_word_buckets,
    load_snapshot,
    pair_hits,
    pair_keys_and_weights_fw,
    save_snapshot,
    sort_compact,
    store_rules,
)

# The key of an empty or padding table slot: int64 max, which sorts after
# every real key x << 32 | y (token ids are < 2**31).
PADKEY = (1 << 63) - 1


def _pack_keys(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """(x, y) int32 -> int64 keys x << 32 | y; invalid (BIG) -> PADKEY."""
    key = (kx.long() << 32) | ky.long()
    return torch.where(kx == BIG, torch.full_like(key, PADKEY), key)


def _unpack_key(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    invalid = keys == PADKEY
    big = torch.full_like(keys, BIG)
    kx = torch.where(invalid, big, keys >> 32).to(torch.int32)
    ky = torch.where(invalid, big, keys & 0xFFFFFFFF).to(torch.int32)
    return kx, ky


def _compact_kv(keep, keys, vals, cap: int):
    """Front-pack (key, val) entries where ``keep`` into a [cap] buffer
    (PADKEY / 0 fill).  Returns (keys [cap], vals [cap], n_keep); n_keep
    may exceed cap, which is how callers detect overflow."""
    (ko, vo), n_keep = sort_compact(keep, (keys, vals), (PADKEY, 0))
    n = vo.shape[0]
    if n < cap:
        ko = torch.cat([ko, torch.full((cap - n,), PADKEY, dtype=ko.dtype, device=ko.device)])
        vo = torch.cat([vo, torch.zeros(cap - n, dtype=vo.dtype, device=vo.device)])
    return ko[:cap], vo[:cap], n_keep


def _reduce_by_key(keys, vals, cap: int):
    """Sum vals per key, keep positive non-pad totals in key order,
    compact to [cap].  Returns (keys, totals int32, n_keep)."""
    uk, inv = torch.unique(keys, sorted=True, return_inverse=True)
    tot = torch.zeros(uk.shape[0], dtype=torch.int64, device=keys.device)
    tot.index_add_(0, inv, vals.long())
    keep = (uk != PADKEY) & (tot > 0)
    return _compact_kv(keep, uk, tot.to(torch.int32), cap)


def _full_recount(t, wid, fw, pcap):
    """Count every pair from scratch; table compacted to [pcap]."""
    kx, ky, w = pair_keys_and_weights_fw(t, wid, fw)
    keys = _pack_keys(torch.where(w > 0, kx, torch.full_like(kx, BIG)), ky)
    return _reduce_by_key(keys, torch.where(w > 0, w, torch.zeros_like(w)), pcap)


def _affected_positions(t, wid, hit):
    """Per-position flag: does MY word contain any accepted-pair hit?
    A word is affected iff the last hit at or after its start lies in it
    (forward scan) or the next hit at or before its end does (backward)."""
    m = t.shape[0]
    one = torch.ones(1, dtype=torch.bool, device=t.device)
    seg_start = torch.cat([one, wid[1:] != wid[:-1]])
    seg_end = torch.cat([seg_start[1:], one])
    before = _last_index(hit) >= _last_index(seg_start)
    # next hit at or after each position (m when none), and the word's end
    next_hit = m - 1 - _last_index(hit.flip(0)).flip(0)
    we = m - 1 - _last_index(seg_end.flip(0)).flip(0)
    after = (next_hit <= we) & (next_hit < m)
    return before | after


def _delta_contributions(t, wid, fw, aff_pos, dcap, sign):
    """Pair contributions of affected words, compacted to [dcap] with
    ``sign`` applied.  Returns (keys, weights, n, overflow)."""
    kx, ky, w = pair_keys_and_weights_fw(t, wid, fw)
    dk, dv, n = _compact_kv(aff_pos & (w > 0), _pack_keys(kx, ky), sign * w, dcap)
    return dk, dv, n, n > dcap


def train_rounds_delta(
    t, wid, freq, tk, tc, rules, used, used_ids0, limit, vocab_size,
    batch_k=16, pcap=1 << 16, dcap=1 << 15,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, no
    candidate is accepted (done), or the live table exceeds ``pcap``
    (overflow; the host retries with 2x pcap).

    Plain torch version of the JAX ``train_rounds_delta``, on any device:
    ``t``/``wid`` [M] int32 (PAD-padded, front-compacted), ``freq`` [W]
    int32, ``tk`` [pcap] int64 keys (PADKEY fill) with ``tc`` [pcap]
    int32 counts, ``rules`` [vocab_size, 4] int32 (updated in place).
    Returns (t, wid, tk, tc, rules, used, done, overflow, n_stream)."""
    kb = batch_k
    used = int(used)
    used_ids0 = int(used_ids0)
    limit = int(limit)
    t = t.to(torch.int32)
    wid = wid.to(torch.int32)
    fw = (freq[wid.clamp(min=0).long()] * (wid >= 0)).to(torch.int32)
    done = overflow = False
    while not done and not overflow and used < min(vocab_size, limit):
        xs, ys = _unpack_key(tk)
        cc, cx, cy = _topk_candidates(tc, xs, ys, kb)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, kb)
        done = n_acc == 0

        hit, rix = pair_hits(t, wid, acc, cx, cy)
        aff = _affected_positions(t, wid, hit)
        dk_old, dv_old, _, of_old = _delta_contributions(t, wid, fw, aff, dcap, -1)
        t2, w2, fw2, aff2 = apply_accepted(
            t, wid, acc, cx, cy, zs, extra=(fw, aff.to(torch.int32)), hit=hit, rix=rix
        )
        dk_new, dv_new, _, of_new = _delta_contributions(t2, w2, fw2, aff2 != 0, dcap, 1)
        if of_old or of_new:
            tk, tc, n_live = _full_recount(t2, w2, fw2, pcap)
        else:
            tk, tc, n_live = _reduce_by_key(
                torch.cat([tk, dk_old, dk_new]), torch.cat([tc, dv_old, dv_new]), pcap
            )
        overflow = n_live > pcap
        store_rules(rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
        used += n_acc
        t, wid, fw = t2, w2, fw2
    n_stream = int((t >= 0).sum())
    return t, wid, tk, tc, rules, used, done, overflow, n_stream


def host_count_table(t: np.ndarray, wid: np.ndarray, freq: np.ndarray):
    """Exact pair-count table on the host (numpy): sorted uint64 keys
    x << 32 | y and their int32 counts."""
    t = np.asarray(t, np.int64)
    wid = np.asarray(wid, np.int64)
    freq = np.asarray(freq, np.int64)
    m = t.size
    idx = np.arange(m, dtype=np.int64)
    nxt_t = np.concatenate([t[1:], [PAD]])
    nxt_w = np.concatenate([wid[1:], [PAD]])
    valid = (wid >= 0) & (wid == nxt_w)
    eq = valid & (t == nxt_t)
    last_noneq = np.maximum.accumulate(np.where(eq, -1, idx))
    offset = idx - last_noneq - 1
    counted = valid & (~eq | (offset % 2 == 0))
    w = np.where(counted, freq[np.maximum(wid, 0)], 0)
    sel = w > 0
    keys = (t[sel].astype(np.uint64) << 32) | nxt_t[sel].astype(np.uint64)
    uk, inv = np.unique(keys, return_inverse=True)
    cnts = np.bincount(inv, weights=w[sel].astype(np.float64)).astype(np.int64)
    return uk, cnts.astype(np.int32)


def _next_pow2(x: int) -> int:
    return 1 << max(4, int(np.ceil(np.log2(max(int(x), 1)))))


def _pcap_budget(n_live0: int, merges: int) -> int:
    """The JAX package's table size: twice the initial live pairs, or the
    initial pairs plus the new kinds measured per merge (36 / 12 / 4 over
    the first, second and later thousand merges), whichever is larger."""
    m = max(merges, 0)
    grow = 36 * min(m, 1000) + 12 * min(max(m - 1000, 0), 1000) + 4 * max(m - 2000, 0)
    return _next_pow2(max(2 * n_live0, n_live0 + grow, 1 << 14))


def _fit_table(uk, uc, pcap: int, device):
    """The host (uint64-keyed) table laid out at exactly [pcap] on
    ``device``: int64 keys with PADKEY fill, int32 counts."""
    kh = np.asarray(uk, np.uint64)
    assert kh.shape[0] <= pcap, "count table does not fit pcap; live pairs would be dropped"
    n = kh.shape[0]
    ko = np.full(pcap, PADKEY, np.int64)
    ko[:n] = kh.astype(np.int64)
    co = np.zeros(pcap, np.int32)
    co[:n] = np.asarray(uc)[:n]
    return torch.from_numpy(ko).to(device), torch.from_numpy(co).to(device)


class PlainEngine:
    """Segments of ``train_rounds_delta`` with the JAX package's table
    sizing, overflow retry and progressive re-packing."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.device = device
        self.vocab_size = vocab_size
        self.used_ids0 = used_ids0
        self.batch_k = batch_k
        self.t = torch.from_numpy(np.ascontiguousarray(t)).to(device)
        self.wid = torch.from_numpy(np.ascontiguousarray(wid)).to(device)
        self.freq = torch.from_numpy(np.ascontiguousarray(freq, np.int32)).to(device)
        self.rules = torch.from_numpy(np.array(rules)).to(device)  # a copy
        m = t.shape[0]
        self.dcap = int(os.environ.get("YTTM_TRAIN_DCAP", "0")) or _next_pow2(max(1 << 14, m >> 4))
        uk, uc = host_count_table(t, wid, freq)
        self.pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used_ids0), _next_pow2(m)
        )
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, device)
        self.repack = os.environ.get("YTTM_TRAIN_REPACK", "1") != "0"
        self.repack_min = int(os.environ.get("YTTM_TRAIN_REPACK_MIN", str(1 << 14)))

    def segment(self, used: int, limit: int):
        self.t, self.wid, self.tk, self.tc, self.rules, used, done, overflow, n_stream = (
            train_rounds_delta(
                self.t, self.wid, self.freq, self.tk, self.tc, self.rules, used,
                self.used_ids0, limit, self.vocab_size, self.batch_k, self.pcap, self.dcap,
            )
        )
        if self.repack and not overflow:
            md = _next_pow2(max(n_stream, self.repack_min))
            if md < self.t.shape[0]:
                self.t = self.t[:md]
                self.wid = self.wid[:md]
        return used, done, overflow

    def regrow(self):
        """After an overflow: double pcap and recount from the stream."""
        self.pcap *= 2
        uk, uc = host_count_table(self.t.cpu().numpy(), self.wid.cpu().numpy(), self.freq.cpu().numpy())
        while self.pcap < uk.size:
            self.pcap *= 2
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, self.device)

    def stream(self):
        return self.t, self.wid, self.freq


def run_training_delta(
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
    """The host loop, with the JAX package's contract: the merge rounds run in
    segments of at most ``progress_every``, ``checkpoint_every``, 1024
    (re-packing) or 1000 ids (the merge log); after each segment come the
    merge log, the progress line and the checkpoint.  Checkpoints are the
    JAX package's snapshot files.  ``device`` holds the training state;
    ``plain`` picks the plain round loop over the kernels."""
    from .train_kernels import KernelEngine

    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    if resume_path:
        t, wid, freq, rules, used = load_snapshot(resume_path, used_ids0, vocab_size)
    else:
        t, wid, freq = flatten_word_buckets(buckets)
        rules = np.full((vocab_size, 4), -1, dtype=np.int32)
        used = used_ids0

    device = torch.device(device)
    engine_cls = PlainEngine if plain else KernelEngine
    engine = engine_cls(t, wid, freq, rules, used_ids0, vocab_size, batch_k, device)
    # the JAX package caps segments at 1024 ids for re-packing; both engines
    # keep its segment ends, so progress lines and checkpoints fall alike
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
    t_start = time.time()
    while used < vocab_size:
        limit = min(vocab_size, used + seg)
        used, done, overflow = engine.segment(used, limit)
        if overflow:
            engine.regrow()
            continue
        if progress_cb:
            progress_cb(engine.rules.cpu().numpy(), used)
        if progress_every:
            n_merges = used - used_ids0
            dt = time.time() - t_start
            print(
                f"id: {used}/{vocab_size}  merges: {n_merges}  "
                f"({dt:.1f}s, {n_merges / max(dt, 1e-9):.0f} merges/s)",
                file=sys.stderr,
            )
        if checkpoint_path and checkpoint_every and used < vocab_size:
            st, sw, sf = engine.stream()
            save_snapshot(checkpoint_path, st, sw, sf, engine.rules, used, used_ids0)
        if done:
            break

    n = used - used_ids0
    if n < vocab_size - used_ids0:
        print(f"WARNING merged only: {used} pairs of tokens", file=sys.stderr)
    out = engine.rules[:n, :3].cpu().numpy()
    return [tuple(map(int, r)) for r in out]
