"""Tiered hot/cold BPE trainer (v5): the plain torch round loop and the host
loop around it.

PyTorch counterpart of ``youtokentome_tpu/ops/train_tiered.py``.  The
stream is an ``[NB, B]`` block layout (``ops/train_block.py``) with a
512-bit token signature per block; the pair counts are split into a
**hot tier** (every pair whose count exceeds a threshold ``T``, exact) and
a frozen **cold tier** (the full table at the last refresh) plus a
**pending buffer** of each round's signed deltas.  A round selects from
the hot tier while its top count exceeds ``T``; otherwise it runs as a
refresh round: cold + pending fold into the exact full table, selection
takes its top-k with no floor, and ``T`` and the hot tier are re-picked.
An existing pair's count never increases under BPE merges (the JAX
module's note), so while every accepted count is above ``T`` the hot
tier's order is the global order, and the rules equal v2's.  Affected
blocks are found through the signatures, gathered into a ``[KB, B]`` mini
stream at one of three sizes (KB1, KBm, KB2), or the whole stream is
applied when more blocks are affected.

``train_rounds_tiered`` is the plain version of the JAX device program,
step for step; it runs on any device and is the reference for the
trainer's kernels (``ops/tiered_kernels.py``).  ``run_training_tiered``
is the host loop: by default it runs the rounds through the kernels
(hand-written CUDA on a card, their plain versions on the CPU);
``plain=True`` runs ``train_rounds_tiered`` instead.  Both give the JAX
package's rules exactly.

Signatures are int32 words with the JAX package's uint32 bits (torch has
no ``>>`` on uint32 on the CPU); pair keys are the port's int64
``x << 32 | y``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from .train_block import _apply_rowwise, _mini_contribs, _reblock_flat, block_size_for
from .train_delta import (
    PADKEY,
    _compact_kv,
    _fit_table,
    _next_pow2,
    _pcap_budget,
    _reduce_by_key,
    _unpack_key,
    host_count_table,
    run_training_delta,
)
from .train_stream import (
    BIG,
    PAD,
    _topk_candidates,
    accept_prefix,
    flatten_word_buckets,
    load_snapshot,
    pair_hits,
    save_snapshot,
    store_rules,
)

# signature geometry: SIG_W 32-bit words = 512 presence bits per block
SIG_W = 16
_SIG_BITS = SIG_W * 32
_HASH_MULT = 2654435761


def _sig_pos(tok: torch.Tensor) -> torch.Tensor:
    """Token id -> bit position in the block signature: the top 9 bits of
    the uint32 product ``tok * 2654435761``, in int64 (the product is cut
    into 16-bit halves of the multiplier so that nothing overflows)."""
    a = tok.long() & 0xFFFFFFFF
    h = (a * (_HASH_MULT & 0xFFFF) + (((a * (_HASH_MULT >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (h >> 23) & (_SIG_BITS - 1)


def _to_words(pres: torch.Tensor) -> torch.Tensor:
    """[R, 512] presence bits -> [R, SIG_W] int32 words (bit i of word w is
    position 32 w + i; the uint32 bits of the JAX package)."""
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=pres.device)
    w = (pres.reshape(pres.shape[0], SIG_W, 32).long() * weights).sum(dim=2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def sig_build(t2d: torch.Tensor) -> torch.Tensor:
    """[R, B] tokens -> [R, SIG_W] int32 presence signatures (exact for the
    given rows; PAD contributes nothing)."""
    R = t2d.shape[0]
    pres = torch.zeros((R, _SIG_BITS), dtype=torch.bool, device=t2d.device)
    valid = t2d >= 0
    rows = torch.arange(R, device=t2d.device)[:, None].expand_as(t2d)
    pres[rows[valid], _sig_pos(t2d)[valid]] = True
    return _to_words(pres)


def sig_build_host(t2d: np.ndarray, device="cpu") -> torch.Tensor:
    """``sig_build`` of a host (numpy) stream, on ``device``."""
    return sig_build(torch.from_numpy(np.ascontiguousarray(t2d))).to(device)


def sig_prefilter(sig, acc, cx, cy) -> torch.Tensor:
    """Per-block flag: the block MAY hold an occurrence of an accepted
    candidate (both tokens' presence bits set): a conservative superset."""

    def present(c):  # [k] ids -> [NB, k]
        pos = _sig_pos(c)
        words = sig[:, (pos >> 5)]  # [NB, k]
        return ((words >> (pos & 31).to(torch.int32)) & 1) != 0

    return (present(cx) & present(cy) & acc[None, :]).any(dim=1)


def _resplit(fk, fc, hcap: int):
    """Full table -> (hot keys, hot counts, T): T is the count at the
    (hcap/2)-th rank (0 with fewer live entries) and the hot tier holds
    exactly the entries with count > T."""
    pcap = fc.shape[0]
    boundary = hcap // 2
    cs = torch.sort(fc).values
    T = max(int(cs[pcap - boundary] if pcap >= boundary else cs[0]), 0)
    hk, hc, _ = _compact_kv(fc > T, fk, fc, hcap)
    return hk, hc, T


def host_resplit(uk: np.ndarray, uc: np.ndarray, hcap: int, device):
    """``_resplit`` of the host count table (live entries only)."""
    boundary = hcap // 2
    if uc.size >= boundary:
        T = max(int(np.partition(uc, uc.size - boundary)[uc.size - boundary]), 0)
    else:
        T = 0
    sel = uc > T
    hk, hc = _fit_table(uk[sel], uc[sel], hcap, device)
    return hk, hc, T


def _reduce_by_key_signed(keys, vals, cap: int):
    """``_reduce_by_key`` that KEEPS negative totals (a round's net deltas
    carry decays into the hot fold and the pending buffer); zero totals
    and pad keys are dropped."""
    uk, inv = torch.unique(keys, sorted=True, return_inverse=True)
    tot = torch.zeros(uk.shape[0], dtype=torch.int64, device=keys.device)
    tot.index_add_(0, inv, vals.long())
    return _compact_kv((uk != PADKEY) & (tot != 0), uk, tot.to(torch.int32), cap)


def _fills(t, B: int) -> torch.Tensor:
    return (t.reshape(-1, B) >= 0).sum(dim=1)


def _fold_check(t, B: int) -> bool:
    """Can the rows be folded pairwise into half as many?  Pairs the
    emptiest row with the fullest: feasible iff every pair fits a row."""
    fs = torch.sort(_fills(t, B)).values
    nb = fs.shape[0]
    return int((fs[: nb // 2] + fs[nb // 2 :].flip(0)).max()) <= B


def _fold_rows(t, wid, B: int):
    """Halve the row count: rows in stable order of fill, the i-th fullest
    concatenated with the i-th emptiest and front-packed (lossless when
    ``_fold_check`` holds).  Returns (t, wid, sig)."""
    NB = t.shape[0] // B
    order = torch.sort(_fills(t, B), stable=True).indices
    ts = t.reshape(NB, B)[order]
    ws = wid.reshape(NB, B)[order]
    cat_t = torch.cat([ts[NB // 2 :].flip(0), ts[: NB // 2]], dim=1)
    cat_w = torch.cat([ws[NB // 2 :].flip(0), ws[: NB // 2]], dim=1)
    keep = cat_t != PAD
    dst = torch.cumsum(keep.long(), 1) - keep.long()
    rows = torch.arange(NB // 2, device=t.device)[:, None].expand_as(keep)
    nt = torch.full_like(cat_t, PAD)
    nw = torch.full_like(cat_w, PAD)
    nt[rows[keep], dst[keep]] = cat_t[keep]
    nw[rows[keep], dst[keep]] = cat_w[keep]
    nt, nw = nt[:, :B].contiguous(), nw[:, :B].contiguous()
    return nt.reshape(-1), nw.reshape(-1), sig_build(nt)


def _max_word_len(buckets) -> int:
    return max((int((mat >= 0).sum(1).max()) for mat, _ in buckets if mat.size), default=1)


def flatten_word_buckets_blocked_snug(buckets, B: int):
    """Snug block layout (numpy): words grouped by exact length, NB rounded
    up to a multiple of 1024.  Returns (t [NB*B], wid [NB*B], freq)."""
    t, wid, freq = flatten_word_buckets(buckets)
    live = wid >= 0
    tb, wb = _reblock_flat(t[live], wid[live], B)
    NB = tb.size // B
    t2d = tb.reshape(NB, B)
    live_rows = int(np.max(np.nonzero((t2d >= 0).any(axis=1))[0], initial=0)) + 1
    nb2 = min(max(-(-live_rows // 1024) * 1024, 1024), NB)
    return t2d[:nb2].reshape(-1), wb.reshape(NB, B)[:nb2].reshape(-1), freq


def _pad_keys(n: int, device) -> torch.Tensor:
    return torch.full((n,), PADKEY, dtype=torch.int64, device=device)


def train_rounds_tiered(
    t, wid, freq, sig, hk, hc, T, ck, ccold, qk, qv, qn, rules, used, used_ids0, limit,
    vocab_size, batch_k=16, pcap=1 << 16, hcap=1 << 14, dcap=1 << 18, qcap=1 << 20,
    B=128, KB1=1 << 10, KBm=1 << 13, KB2=1 << 14,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, a
    refresh round accepts nothing (done), or a full table exceeds ``pcap``
    (overflow; the host rebuilds every tier from the stream).

    Plain torch version of the JAX ``train_rounds_tiered``, on any device:
    ``t``/``wid`` [NB*B] int32, ``freq`` [W] int32, ``sig`` [NB, SIG_W]
    int32, hot (``hk`` [hcap] int64, ``hc`` int32, ``T``), cold (``ck``
    [pcap], ``ccold``), pending (``qk`` [qcap], ``qv``, ``qn``), ``rules``
    [vocab_size, 4] int32 (updated in place).  Returns (t, wid, sig, (hk,
    hc, T), (ck, ccold), (qk, qv, qn), rules, used, done, overflow,
    n_stream, stats) with stats [rounds, refresh, mid, full]."""
    kb = batch_k
    used, used_ids0, limit = int(used), int(used_ids0), int(limit)
    T, qn = int(T), int(qn)
    m = t.shape[0]
    NB = m // B
    KB1 = min(KB1, NB)
    KBm = min(max(KBm, KB1), NB)
    KB2 = min(max(KB2, KBm), NB)
    dev = t.device
    t = t.to(torch.int32)
    wid = wid.to(torch.int32)
    fw = (freq[wid.clamp(min=0).long()] * (wid >= 0)).to(torch.int32)
    qk, qv = qk.clone(), qv.clone()
    stats = [0, 0, 0, 0]
    done = overflow = False
    while not done and not overflow and used < min(vocab_size, limit):
        # -- selection: hot tier, or a refresh fold of cold + pending
        hxs, hys = _unpack_key(hk)
        cch, cxh, cyh = _topk_candidates(hc, hxs, hys, kb)
        is_refresh = not (int(cch[0]) > T and qn + dcap <= qcap)
        n_live0 = 0
        if is_refresh:
            bk, bc, n_live0 = _reduce_by_key(torch.cat([ck, qk]), torch.cat([ccold, qv]), pcap)
            fx, fy = _unpack_key(bk)
            cc, cx, cy = _topk_candidates(bc, fx, fy, kb)
        else:
            bk, bc = ck, ccold
            cc, cx, cy = cch, cxh, cyh
        overflow_pre = is_refresh and n_live0 > pcap
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, kb, min_count=0 if is_refresh else T)
        if overflow_pre:
            # a refresh-fold overflow invalidates the selection: merge
            # nothing, stop, let the host rebuild
            acc, n_acc = torch.zeros_like(acc), 0
        done = is_refresh and n_acc == 0 and not overflow_pre

        # -- tiered apply
        bflag = sig_prefilter(sig, acc, cx, cy)
        n_baff = int(bflag.sum())
        if n_baff <= KB2:  # tier_mini at KB1, KBm or KB2: the same result
            bidx = torch.nonzero(bflag).flatten()
            mt = t.reshape(NB, B)[bidx].reshape(-1)
            mw = wid.reshape(NB, B)[bidx].reshape(-1)
            mf = fw.reshape(NB, B)[bidx].reshape(-1)
            ko, vo = _mini_contribs(mt, mw, mf)
            mhit, mrix = pair_hits(mt, mw, acc, cx, cy)
            mt2, mw2, mf2 = _apply_rowwise(mt, mw, mf, mhit, mrix, zs, B)
            kn, vn = _mini_contribs(mt2, mw2, mf2)
            dk, dv, n_d = _reduce_by_key_signed(torch.cat([ko, kn]), torch.cat([-vo, vn]), dcap)
            t2, w2, f2, sig2 = t.clone(), wid.clone(), fw.clone(), sig.clone()
            t2.reshape(NB, B)[bidx] = mt2.reshape(-1, B)
            w2.reshape(NB, B)[bidx] = mw2.reshape(-1, B)
            f2.reshape(NB, B)[bidx] = mf2.reshape(-1, B)
            sig2[bidx] = sig_build(mt2.reshape(-1, B))
            delta_ok = n_d <= dcap
        else:  # tier_full: deltas are not representable
            hit, rix = pair_hits(t, wid, acc, cx, cy)
            t2, w2, f2 = _apply_rowwise(t, wid, fw, hit, rix, zs, B)
            sig2 = sig_build(t2.reshape(NB, B))
            dk = _pad_keys(dcap, dev)
            dv = torch.zeros(dcap, dtype=torch.int32, device=dev)
            n_d, delta_ok = 0, False

        # -- table update
        overflow_post = False
        if is_refresh or not delta_ok:  # update_full: new cold, re-split hot
            if delta_ok:
                fk, fc, n_live = _reduce_by_key(torch.cat([bk, dk]), torch.cat([bc, dv]), pcap)
            else:
                kf, wf = _mini_contribs(t2, w2, f2)
                fk, fc, n_live = _reduce_by_key(kf, wf, pcap)
            hk, hc, T = _resplit(fk, fc, hcap)
            ck, ccold = fk, fc
            qk = _pad_keys(qcap, dev)
            qv = torch.zeros(qcap, dtype=torch.int32, device=dev)
            qn = 0
            overflow_post = n_live > pcap
        else:  # update_incremental: deltas into hot, appended to pending
            hk, hc, n_hot = _reduce_by_key(torch.cat([hk, dk]), torch.cat([hc, dv]), hcap)
            if n_hot > hcap:
                T = BIG - 1  # poison T: the next round refreshes
            qk[qn : qn + dcap] = dk
            qv[qn : qn + dcap] = dv
            qn += n_d
        overflow = overflow_pre or overflow_post

        store_rules(rules, acc, cx, cy, cc, zs, used_ids0, vocab_size)
        used += n_acc
        stats[0] += 1
        stats[1] += int(is_refresh)
        stats[2] += int(KB1 < n_baff <= KB2)
        stats[3] += int(n_baff > KB2)
        t, wid, fw, sig = t2, w2, f2, sig2
    n_stream = int((t >= 0).sum())
    return (t, wid, sig, (hk, hc, T), (ck, ccold), (qk, qv, qn), rules, used, done, overflow,
            n_stream, stats)


def tier_sizes(NB: int, B: int, n_live0: int, m: int, merges: int) -> dict:
    """The JAX host loop's table and tier sizes, each under its env knob."""

    def env(name):
        return int(os.environ.get(name, "0"))

    pcap = env("YTTM_TRAIN_PCAP") or min(
        max(_pcap_budget(n_live0, merges), _next_pow2(m) >> 2), _next_pow2(m)
    )
    hcap = env("YTTM_TRAIN_HCAP") or min(_next_pow2(max(1 << 15, 2 * merges)), pcap)
    KB1 = env("YTTM_TRAIN_KB1") or min(max(256, _next_pow2(NB >> 6)), 1 << 11)
    KBm = env("YTTM_TRAIN_KBM") or min(max(4 * KB1, _next_pow2(NB >> 5)), 1 << 13)
    KB2 = env("YTTM_TRAIN_KB2") or min(_next_pow2(max(NB >> 3, KBm)), 1 << 15)
    dcap = env("YTTM_TRAIN_DCAP2") or max(2 * KB1 * B, 1 << 16)
    qcap = env("YTTM_TRAIN_QCAP") or max(4 * dcap, 1 << 20)
    return dict(pcap=pcap, hcap=hcap, KB1=KB1, KBm=KBm, KB2=KB2, dcap=dcap, qcap=qcap)


def tiered_block_size(buckets) -> int:
    """The host loop's B: ``block_size_for`` (0 for a word longer than 512),
    then down to max(``YTTM_TRAIN_B`` or 64, next_pow2(longest word)).
    Blocks of 64 tokens (~8 words) track word hits closer than v4's 128."""
    B = block_size_for(buckets)
    if B:
        floor = int(os.environ.get("YTTM_TRAIN_B", "64"))
        B = max(min(B, max(floor, _next_pow2(_max_word_len(buckets)))), 1)
    return B


def fold_wanted(m: int, B: int, n_stream: int) -> bool:
    """The JAX host loop's fold trigger, before ``_fold_check``: more rows than
    ``YTTM_TRAIN_FOLD_MIN`` and the live stream below 45 % of the slots."""
    return m // B > int(os.environ.get("YTTM_TRAIN_FOLD_MIN", "4096")) and n_stream < int(0.45 * m)


class PlainTieredEngine:
    """Segments of ``train_rounds_tiered`` with the JAX host loop's sizes, row
    fold and overflow rebuild."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, device):
        self.device = dev = torch.device(device)
        self.vocab_size, self.used_ids0, self.batch_k, self.B = vocab_size, used_ids0, batch_k, B
        self.t = torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(dev)
        self.wid = torch.from_numpy(np.ascontiguousarray(wid, np.int32)).to(dev)
        self.freq = torch.from_numpy(np.ascontiguousarray(freq, np.int32)).to(dev)
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(dev)  # a copy
        m = t.shape[0]
        uk, uc = host_count_table(t, wid, freq)
        self.sizes = tier_sizes(m // B, B, uk.size, m, vocab_size - used_ids0)
        self.pcap, self.hcap = self.sizes["pcap"], self.sizes["hcap"]
        self.sig = sig_build_host(np.asarray(t).reshape(-1, B), dev)
        self._tables(uk, uc)
        self.stats = [0, 0, 0, 0]

    def _tables(self, uk, uc):
        dev = self.device
        self.ck, self.ccold = _fit_table(uk, uc, self.pcap, dev)
        self.hk, self.hc, self.T = host_resplit(uk, uc, self.hcap, dev)
        self.qk = _pad_keys(self.sizes["qcap"], dev)
        self.qv = torch.zeros(self.sizes["qcap"], dtype=torch.int32, device=dev)
        self.qn = 0

    def segment(self, used: int, limit: int):
        s = self.sizes
        (self.t, self.wid, self.sig, (self.hk, self.hc, self.T), (self.ck, self.ccold),
         (self.qk, self.qv, self.qn), self.rules, used, done, overflow, n_stream, self.stats) = (
            train_rounds_tiered(
                self.t, self.wid, self.freq, self.sig, self.hk, self.hc, self.T, self.ck,
                self.ccold, self.qk, self.qv, self.qn, self.rules, used, self.used_ids0, limit,
                self.vocab_size, self.batch_k, self.pcap, self.hcap, s["dcap"], s["qcap"],
                self.B, s["KB1"], s["KBm"], s["KB2"],
            )
        )
        if not overflow and fold_wanted(self.t.shape[0], self.B, n_stream) and _fold_check(
            self.t, self.B
        ):
            self.t, self.wid, self.sig = _fold_rows(self.t, self.wid, self.B)
        return used, done, overflow

    def regrow(self):
        """After an overflow: double pcap and rebuild every tier from the
        stream."""
        self.pcap *= 2
        print(f"pair-count table overflow: retrying with pcap={self.pcap}", file=sys.stderr)
        tn, wn = self.t.cpu().numpy(), self.wid.cpu().numpy()
        live = tn >= 0
        uk, uc = host_count_table(tn[live], wn[live], self.freq.cpu().numpy())
        while self.pcap < uk.size:
            self.pcap *= 2
        self.hcap = min(self.hcap, self.pcap)
        self._tables(uk, uc)

    def stream(self):
        return self.t, self.wid, self.freq


def run_training_tiered(
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
    """The host loop, with the JAX package's contract: the block size
    (``YTTM_TRAIN_B`` floors it), the fall-back to the delta trainer for a
    word longer than 512, resume through ``_reblock_flat``, segments of at
    most ``progress_every``, ``checkpoint_every`` or 1000 ids (the merge
    log), the row fold after a segment, and after each segment the merge
    log, the progress line and the checkpoint (the JAX package's snapshot
    files).  ``device`` holds the training state; ``plain`` picks the plain
    round loop over the kernels."""
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    B = tiered_block_size(buckets)
    if B == 0:
        return run_training_delta(
            buckets, used_ids0, vocab_size, batch_k, progress_every, checkpoint_path,
            checkpoint_every, resume_path, progress_cb=progress_cb, device=device, plain=plain,
        )
    if resume_path:
        tt, ww, freq, rules, used = load_snapshot(resume_path, used_ids0, vocab_size)
        t, wid = _reblock_flat(np.asarray(tt), np.asarray(ww), B)
    else:
        t, wid, freq = flatten_word_buckets_blocked_snug(buckets, B)
        rules = np.full((vocab_size, 4), -1, dtype=np.int32)
        used = used_ids0

    if plain:
        engine_cls = PlainTieredEngine
    else:
        from .tiered_kernels import TieredKernelEngine as engine_cls
    engine = engine_cls(t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, torch.device(device))
    seg = min(
        x
        for x in (progress_every, checkpoint_every, 1000 if progress_cb else 0, vocab_size)
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
            st = engine.stats
            print(
                f"id: {used}/{vocab_size}  merges: {n_merges}  "
                f"({dt:.1f}s, {n_merges / max(dt, 1e-9):.0f} merges/s)  "
                f"seg rounds={st[0]} refresh={st[1]} mid={st[2]} "
                f"full={st[3]} m={engine.stream()[0].shape[0]}",
                file=sys.stderr,
            )
        if checkpoint_path and checkpoint_every and used < vocab_size:
            st_t, st_w, st_f = engine.stream()
            save_snapshot(checkpoint_path, st_t, st_w, st_f, engine.rules, used, used_ids0)
        if done:
            break

    n = used - used_ids0
    if n < vocab_size - used_ids0:
        print(f"WARNING merged only: {used} pairs of tokens", file=sys.stderr)
    out = engine.rules[:n, :3].cpu().numpy()
    return [tuple(map(int, r)) for r in out]
