"""The v4 block trainer, and the block-layout helpers v5 shares with it.

PyTorch counterpart of ``youtokentome_tpu/ops/train_block.py``.  The
stream is an ``[NB, B]`` matrix of rows that words never cross: each row
holds whole words, so rows are independent for counting, application and
compaction.  Each round the rows with an accepted pair's hit are flagged;
up to ``KB`` of them are gathered, applied with per-row compaction and
folded into the exact count table as -old/+new contributions (the block
path); above ``KB`` every row is applied and the table recounted (the full
path).

``train_rounds_block`` is the plain version of the JAX program, branch for
branch (any device); ``run_training_block`` is the host loop, by default
through the kernels of ``ops/block_kernels.py``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from .train_delta import (
    BIG,
    PAD,
    _fit_table,
    _next_pow2,
    _pack_keys,
    _pcap_budget,
    _reduce_by_key,
    _unpack_key,
    host_count_table,
    run_training_delta,
)
from .train_stream import (
    _last_index,
    _topk_candidates,
    accept_prefix,
    flatten_word_buckets,
    learned_rules,
    load_snapshot,
    pair_hits,
    pair_keys_and_weights_fw,
    run_segments,
    segment_ids,
    store_rules,
)


def _apply_rowwise(t, wid, fw, hit, rix, zs, B: int):
    """Merge application with per-row compaction: even offsets inside runs
    of hits take z, their right neighbours drop, and each ``[B]`` row
    front-packs its kept entries in order (the JAX function's dimension-1
    sort).  Runs of hits never cross a word, hence never a row."""
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    sel = hit & ((idx - _last_index(~hit) - 1) % 2 == 0)
    new_t = torch.where(sel, zs[rix], t)
    kill = torch.cat([torch.zeros(1, dtype=torch.bool, device=t.device), sel[:-1]])
    keep = (~kill & (new_t != PAD)).reshape(m // B, B)
    dst = torch.cumsum(keep.long(), 1) - keep.long()
    rows = torch.arange(m // B, device=t.device)[:, None].expand_as(keep)
    outs = []
    for a, fill in ((new_t, PAD), (wid, PAD), (fw, 0)):
        o = torch.full((m // B, B), fill, dtype=a.dtype, device=a.device)
        o[rows[keep], dst[keep]] = a.reshape(m // B, B)[keep]
        outs.append(o.reshape(m))
    return tuple(outs)


def _mini_contribs(t, wid, fw):
    """All pair contributions of a (mini) stream, uncompacted: invalid or
    zero-weight entries carry PADKEY / 0 and vanish in a fold."""
    kx, ky, w = pair_keys_and_weights_fw(t, wid, fw)
    keys = _pack_keys(torch.where(w > 0, kx, torch.full_like(kx, BIG)), ky)
    return keys, torch.where(w > 0, w, torch.zeros_like(w))


def train_rounds_block(
    t, wid, freq, tk, tc, rules, used, used_ids0, limit, vocab_size,
    batch_k=16, pcap=1 << 16, B=128, KB=1 << 10,
):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)``, no
    candidate is accepted (done), or the live table exceeds ``pcap``
    (overflow; the host retries with 2x pcap).  Plain torch version of the
    JAX program on any device: ``t``/``wid`` [NB*B] int32 in the block
    layout, ``tk`` [pcap] int64 keys with ``tc`` [pcap] int32 counts,
    ``rules`` updated in place.  Returns (t, wid, tk, tc, rules, used,
    done, overflow, n_stream)."""
    kb = batch_k
    used = int(used)
    NB = t.shape[0] // B
    KB = min(KB, NB)
    t = t.to(torch.int32)
    wid = wid.to(torch.int32)
    fw = (freq[wid.clamp(min=0).long()] * (wid >= 0)).to(torch.int32)
    done = overflow = False
    while not done and not overflow and used < min(vocab_size, int(limit)):
        xs, ys = _unpack_key(tk)
        cc, cx, cy = _topk_candidates(tc, xs, ys, kb)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, kb)
        done = n_acc == 0
        if done:  # no merge: the stream and the table stay as they are
            break
        hit, rix = pair_hits(t, wid, acc, cx, cy)
        bflag = hit.reshape(NB, B).any(dim=1)
        if int(bflag.sum()) <= KB:  # the block path
            bidx = torch.nonzero(bflag).flatten()
            t2d, w2d, f2d = t.reshape(NB, B), wid.reshape(NB, B), fw.reshape(NB, B)
            mt, mw, mf = t2d[bidx].reshape(-1), w2d[bidx].reshape(-1), f2d[bidx].reshape(-1)
            ko, vo = _mini_contribs(mt, mw, mf)
            mhit, mrix = pair_hits(mt, mw, acc, cx, cy)
            mt2, mw2, mf2 = _apply_rowwise(mt, mw, mf, mhit, mrix, zs, B)
            kn, vn = _mini_contribs(mt2, mw2, mf2)
            tk, tc, n_live = _reduce_by_key(torch.cat([tk, ko, kn]), torch.cat([tc, -vo, vn]), pcap)
            t2d, w2d, f2d = t2d.clone(), w2d.clone(), f2d.clone()
            t2d[bidx], w2d[bidx], f2d[bidx] = mt2.reshape(-1, B), mw2.reshape(-1, B), mf2.reshape(-1, B)
            t, wid, fw = t2d.reshape(-1), w2d.reshape(-1), f2d.reshape(-1)
        else:  # the full path: every row applied, the table counted again
            t, wid, fw = _apply_rowwise(t, wid, fw, hit, rix, zs, B)
            kf, wf = _mini_contribs(t, wid, fw)
            tk, tc, n_live = _reduce_by_key(kf, wf, pcap)
        overflow = n_live > pcap
        store_rules(rules, acc, cx, cy, cc, zs, int(used_ids0), vocab_size)
        used += n_acc
    return t, wid, tk, tc, rules, used, done, overflow, int((t >= 0).sum())


def flatten_word_buckets_blocked(buckets, B: int):
    """[(tokens [W, L], freq [W])...] -> block layout (t [NB*B], wid
    [NB*B], freq [WCAP]) in which no word crosses a [B]-token row: each
    length group packs B // L words (their bucket slots, PAD included) a
    row, and NB is a power of two.  The flat layout's pair-mass guard
    applies."""
    _, _, freq = flatten_word_buckets(buckets)
    rows_t: List[np.ndarray] = []
    rows_w: List[np.ndarray] = []
    wbase = 0
    for mat, cnt in buckets:
        W, L = mat.shape
        if L > B:
            raise ValueError(
                f"word length {L} exceeds block size {B}; use the delta trainer for this stream"
            )
        k = max(B // L, 1)
        nb = -(-W // k)
        tm = np.full((nb * k, L), PAD, np.int32)
        tm[:W] = mat.astype(np.int32)
        wm = np.full((nb * k, L), PAD, np.int32)
        wm[:W] = (wbase + np.arange(W, dtype=np.int32))[:, None] * np.ones((1, L), np.int32)
        wm[:W][mat < 0] = PAD
        bt = tm.reshape(nb, k * L)
        bw = wm.reshape(nb, k * L)
        if k * L < B:
            padc = np.full((nb, B - k * L), PAD, np.int32)
            bt = np.concatenate([bt, padc], axis=1)
            bw = np.concatenate([bw, padc], axis=1)
        rows_t.append(bt)
        rows_w.append(bw)
        wbase += W
    at = np.concatenate(rows_t, axis=0) if rows_t else np.zeros((0, B), np.int32)
    aw = np.concatenate(rows_w, axis=0) if rows_w else np.zeros((0, B), np.int32)
    NB = _next_pow2(max(at.shape[0], 1))
    out_t = np.full((NB, B), PAD, np.int32)
    out_w = np.full((NB, B), PAD, np.int32)
    out_t[: at.shape[0]] = at
    out_w[: at.shape[0]] = aw
    return out_t.reshape(-1), out_w.reshape(-1), np.asarray(freq, np.int32)


def block_size_for(buckets, cap: int = 512) -> int:
    """next_pow2(max word length), floored at 128; 0 when some word
    exceeds ``cap`` (the caller falls back to the delta trainer)."""
    max_len = max((mat.shape[1] for mat, _ in buckets), default=1)
    if max_len > cap:
        return 0
    return max(128, _next_pow2(max_len))


def _reblock_flat(t: np.ndarray, wid: np.ndarray, B: int):
    """Re-block a compacted flat stream (snapshot resume): split into
    words, group them by length, pack each group into rows (numpy)."""
    live = wid >= 0
    t = t[live]
    wid = wid[live]
    if t.size == 0:
        return np.full(B, PAD, np.int32), np.full(B, PAD, np.int32)
    starts = np.nonzero(np.concatenate([[True], wid[1:] != wid[:-1]]))[0]
    lens = np.diff(np.concatenate([starts, [t.size]]))
    rows_t: List[np.ndarray] = []
    rows_w: List[np.ndarray] = []
    for L in np.unique(lens):
        L = int(L)
        sel = np.nonzero(lens == L)[0]
        idx2d = starts[sel][:, None] + np.arange(L)[None, :]
        W = sel.size
        k = max(B // L, 1)
        nb = -(-W // k)
        tp = np.full((nb * k, L), PAD, np.int32)
        wp = np.full((nb * k, L), PAD, np.int32)
        tp[:W] = t[idx2d]
        wp[:W] = wid[idx2d]
        bt = tp.reshape(nb, k * L)
        bw = wp.reshape(nb, k * L)
        if k * L < B:
            padc = np.full((nb, B - k * L), PAD, np.int32)
            bt = np.concatenate([bt, padc], axis=1)
            bw = np.concatenate([bw, padc], axis=1)
        rows_t.append(bt)
        rows_w.append(bw)
    at = np.concatenate(rows_t, axis=0)
    aw = np.concatenate(rows_w, axis=0)
    NB = _next_pow2(max(at.shape[0], 1))
    out_t = np.full((NB, B), PAD, np.int32)
    out_w = np.full((NB, B), PAD, np.int32)
    out_t[: at.shape[0]] = at
    out_w[: at.shape[0]] = aw
    return out_t.reshape(-1), out_w.reshape(-1)


def block_kb(m: int, B: int) -> int:
    """The JAX host loop's gather bound (``YTTM_TRAIN_KB``)."""
    return int(os.environ.get("YTTM_TRAIN_KB", "0")) or min(
        _next_pow2(max(1 << 8, (m // B) >> 4)), 1 << 12
    )


class PlainBlockEngine:
    """Segments of ``train_rounds_block`` with the JAX host loop's table
    sizing and overflow retry."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, device):
        self.device, self.vocab_size, self.used_ids0, self.batch_k = device, vocab_size, used_ids0, batch_k
        self.B = B
        self.t = torch.from_numpy(np.array(t, np.int32)).to(device)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(device)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(device)
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(device)
        m = int(self.t.shape[0])
        uk, uc = host_count_table(t, wid, freq)
        self.pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used_ids0), _next_pow2(m)
        )
        self.KB = block_kb(m, B)
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, device)

    def segment(self, used: int, limit: int):
        self.t, self.wid, self.tk, self.tc, self.rules, used, done, overflow, _ = train_rounds_block(
            self.t, self.wid, self.freq, self.tk, self.tc, self.rules, used, self.used_ids0,
            limit, self.vocab_size, self.batch_k, self.pcap, self.B, self.KB,
        )
        return used, done, overflow

    def regrow(self):
        """After an overflow: double pcap and count the live stream again."""
        self.pcap *= 2
        tn, wn = self.t.cpu().numpy(), self.wid.cpu().numpy()
        live = tn >= 0
        uk, uc = host_count_table(tn[live], wn[live], self.freq.cpu().numpy())
        while self.pcap < uk.size:
            self.pcap *= 2
        self.tk, self.tc = _fit_table(uk, uc, self.pcap, self.device)

    def stream(self):
        return self.t, self.wid, self.freq


def run_training_block(
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
    """The v4 host loop, with the JAX package's contract: B =
    next_pow2(max word length) at least 128, the delta trainer for a word
    longer than 512 (called, as the JAX host loop calls it, without the merge
    log), resume through ``_reblock_flat``, progress and checkpoints.
    ``device`` holds the training state; ``plain`` picks the plain round
    loop over the kernels."""
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    B = block_size_for(buckets)
    if B == 0:
        return run_training_delta(
            buckets, used_ids0, vocab_size, batch_k, progress_every, checkpoint_path,
            checkpoint_every, resume_path, device=device, plain=plain,
        )
    if resume_path:
        tt, ww, freq, rules, used = load_snapshot(resume_path, used_ids0, vocab_size)
        t, wid = _reblock_flat(np.asarray(tt), np.asarray(ww), B)
    else:
        t, wid, freq = flatten_word_buckets_blocked(buckets, B)
        rules = np.full((vocab_size, 4), -1, dtype=np.int32)
        used = used_ids0
    if plain:
        engine_cls = PlainBlockEngine
    else:
        from .block_kernels import BlockKernelEngine as engine_cls
    engine = engine_cls(t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, torch.device(device))
    used = run_segments(
        engine, used, used_ids0, vocab_size,
        segment_ids(progress_every, checkpoint_every, progress_cb, vocab_size),
        progress_every, checkpoint_path, checkpoint_every, progress_cb,
    )
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
