"""Block-layout helpers of the v4 block trainer, in plain torch.

PyTorch counterpart of what the v5 tiered trainer (``ops/train_tiered.py``)
takes from ``youtokentome_tpu/ops/train_block.py``.  The stream is an
``[NB, B]`` matrix of rows that words never cross: each row holds whole
words, live tokens first and PAD after them, so rows are independent for
counting, application and compaction.  v4's own round loop
(``train_rounds_block``) comes with a later slice.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .train_delta import BIG, PAD, _next_pow2, _pack_keys
from .train_stream import _last_index, pair_keys_and_weights_fw


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
