"""Flat-stream training: the shared primitives and the v1 trainer.

PyTorch counterpart of ``youtokentome_tpu/ops/train_stream.py``:

  state:  t [M] int32   concatenated unique words (space-prefixed)
          wid [M] int32 word id per token (-1 padding)
          freq [WCAP]   occurrence count per word id

The v1 trainer recounts every pair each round (``_segment_counts_flat``),
takes the tie-ordered top-k, accepts a prefix, applies it and compacts the
stream (``train_rounds_resumable``, its plain round loop);
``run_training_stream`` is its host loop, by default through the kernels
of ``ops/stream_train_kernels.py``.  Every function runs on any device and
computes exactly what its JAX namesake computes; the CUDA kernels of the
trainers are held against these.  Pair keys are int64 ``x << 32 | y`` here and in
the trainer: torch has no ``>>`` on uint32 on the CPU, and one layout
serves every vocab size.  ``flatten_word_buckets`` and the snapshot files
are the JAX package's, byte for byte, so either package resumes the
other's checkpoints.
"""

from __future__ import annotations

import sys
import time
from typing import List, Tuple

import numpy as np
import torch

BIG = 0x7FFFFFFF
PAD = -1


def sort_compact(keep: torch.Tensor, arrays, fills):
    """Order-preserving front-pack of each array's kept entries; the rest
    is filled with ``fills``.  Returns (arrays, n_keep)."""
    n_keep = int(keep.sum())
    outs = []
    for a, f in zip(arrays, fills):
        o = torch.full_like(a, f)
        o[:n_keep] = a[keep]
        outs.append(o)
    return tuple(outs), n_keep


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """x[1:] followed by ``fill``."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype, device=x.device)])


def _last_index(cond: torch.Tensor) -> torch.Tensor:
    """For each position i, the largest j <= i with cond[j], else -1: the
    JAX package's cummax(where(cond, idx, -1)), from a cumsum and a gather
    (torch's cummax runs a slow scan with indices on a card)."""
    pos = torch.nonzero(cond).flatten()
    if pos.numel() == 0:
        return torch.full(cond.shape, -1, dtype=torch.int64, device=cond.device)
    c = torch.cumsum(cond.to(torch.int64), 0)
    return torch.where(c > 0, pos[(c - 1).clamp(min=0)], torch.full_like(c, -1))


def pair_keys_and_weights_fw(t, wid, fw):
    """Adjacent pair keys with the run-parity count mask applied to the
    per-position word frequencies ``fw`` (invalid slots keyed BIG with
    weight 0): inside a run of equal tokens only even offsets count, so a
    run of r tokens counts floor(r/2) pairs (bpe.cpp:140-143)."""
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    nxt_t = _shift_left(t, PAD)
    nxt_w = _shift_left(wid, PAD)
    valid = (wid >= 0) & (wid == nxt_w)
    eq = valid & (t == nxt_t)
    offset = idx - _last_index(~eq) - 1
    counted = valid & (~eq | (offset % 2 == 0))
    w = torch.where(counted, fw, torch.zeros_like(fw)).to(torch.int32)
    big = torch.full_like(t, BIG)
    return torch.where(valid, t, big), torch.where(valid, nxt_t, big), w


def pair_keys_and_weights(t, wid, freq):
    """``pair_keys_and_weights_fw`` with the weights gathered from the word
    frequencies."""
    return pair_keys_and_weights_fw(t, wid, freq[wid.clamp(min=0).long()])


def _segment_counts_flat(kx, ky, wf):
    """Sorted reduce-by-key of the pair keys: (cnt, x, y) in key order,
    each key's total at the last entry of its segment and 0 elsewhere
    (invalid BIG keys sort last and total 0)."""
    key = (kx.long() << 32) | ky.long()
    key_s, order = torch.sort(key)
    w_s = wf[order].long()
    is_end = torch.ones_like(key_s, dtype=torch.bool)
    is_end[:-1] = key_s[1:] != key_s[:-1]
    cw = torch.cumsum(w_s, 0)
    ends = torch.nonzero(is_end).flatten()
    tot = torch.diff(cw[ends], prepend=torch.zeros(1, dtype=cw.dtype, device=cw.device))
    cnt = torch.zeros_like(w_s)
    cnt[ends] = tot
    kx_s = (key_s >> 32).to(torch.int32)
    cnt = torch.where(kx_s != BIG, cnt, torch.zeros_like(cnt))
    return cnt.to(torch.int32), kx_s, (key_s & 0xFFFFFFFF).to(torch.int32)


def accept_prefix(cc, cx, cy, used, vocab_size, kb, min_count=None):
    """Longest prefix of tie-ordered candidates with no intersection
    against an earlier candidate, stopping (not skipping) at the first
    failure: a count at or below the floor, the id budget, or the
    equal-pair guard (a candidate whose count is below the largest count
    of an earlier accepted ``(x, x)`` candidate; see the JAX function's
    note).  Returns (acc [kb] bool, zs [kb] int32, n_acc int)."""
    dev = cc.device
    remaining = vocab_size - int(used)
    floor = 0 if min_count is None else int(min_count)
    j = torch.arange(kb, device=dev)
    earlier = j[None, :] < j[:, None]  # [j, i]: i earlier than j
    inter = earlier & ((cy[None, :] == cx[:, None]) | (cx[None, :] == cy[:, None]))
    eqpair_count = torch.where(cx == cy, cc, torch.full_like(cc, -1))
    prev_eq_max = torch.cat(
        [torch.full((1,), -1, dtype=cc.dtype, device=dev), torch.cummax(eqpair_count, 0).values[:-1]]
    )
    fail = (cc <= floor) | inter.any(dim=1) | (j >= remaining) | (cc < prev_eq_max)
    first_fail = int(torch.where(fail, j, torch.full_like(j, kb)).min())
    acc = j < first_fail
    zs = (int(used) + torch.cumsum(acc.to(torch.int32), 0) - 1).to(torch.int32)
    return acc, zs, first_fail


def pair_hits(t, wid, acc, cx, cy):
    """Per-position flag: (t[i], t[i+1]) is an occurrence of an accepted
    candidate within a word.  Returns (hit, rix), rix the index of the
    first matching candidate."""
    nxt_t = _shift_left(t, PAD)
    nxt_w = _shift_left(wid, PAD)
    valid = (wid >= 0) & (wid == nxt_w)
    hitk = (
        valid[:, None]
        & acc[None, :]
        & (t[:, None] == cx[None, :])
        & (nxt_t[:, None] == cy[None, :])
    )
    return hitk.any(dim=1), hitk.to(torch.int8).argmax(dim=1)


def apply_accepted(t, wid, acc, cx, cy, zs, extra=(), hit=None, rix=None):
    """Merge every accepted rule's occurrences in one pass (accepted rules
    are non-intersecting, so positions are disjoint): even offsets inside
    runs of hits take z, their right neighbours drop out, and the stream
    front-compacts; ``extra`` per-position arrays ride along."""
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    if hit is None:
        hit, rix = pair_hits(t, wid, acc, cx, cy)
    sel = hit & ((idx - _last_index(~hit) - 1) % 2 == 0)
    new_t = torch.where(sel, zs[rix], t)
    kill = torch.cat([torch.zeros(1, dtype=torch.bool, device=t.device), sel[:-1]])
    keep = ~kill & (new_t != PAD)
    outs, _ = sort_compact(keep, (new_t, wid) + tuple(extra), (PAD, PAD) + (0,) * len(extra))
    return outs


def store_rules(rules, acc, cx, cy, cc, zs, used_ids0, vocab_size):
    """Record accepted merges as [x, y, z, count] rows of ``rules`` (in
    place; also returned).  The count feeds the merge log."""
    rows = torch.stack([cx, cy, zs, cc], dim=1).to(torch.int32)
    slot = (zs - used_ids0).long()
    ok = acc & (slot < vocab_size)
    rules[slot[ok]] = rows[ok]
    return rules


def _topk_candidates(cnt, xs, ys, k):
    """Top-k table entries in the reference tie-break order: count
    descending, then max(x, y) ascending, then min(x, y) ascending, then x
    descending (bpe.cpp's pair comparison).  Entries with count <= 0 sort
    after every live one; the order among them is unspecified (acceptance
    stops at the first of them).  Returns (cc, cx, cy), each [k]."""
    live = cnt > 0
    big = torch.full_like(xs, BIG)
    keys = (
        torch.where(live, -cnt, big),
        torch.where(live, torch.maximum(xs, ys), big),
        torch.where(live, torch.minimum(xs, ys), big),
        torch.where(live, -xs, big),
    )
    order = torch.arange(cnt.shape[0], device=cnt.device)
    for key in reversed(keys):  # stable sorts, least significant first
        order = order[torch.sort(key[order], stable=True).indices]
    top = order[:k]
    cc, cx, cy = cnt[top], xs[top], ys[top]
    if top.numel() < k:
        pad = k - top.numel()
        cc = torch.cat([cc, torch.zeros(pad, dtype=cc.dtype, device=cc.device)])
        cx = torch.cat([cx, torch.full((pad,), BIG, dtype=cx.dtype, device=cx.device)])
        cy = torch.cat([cy, torch.full((pad,), BIG, dtype=cy.dtype, device=cy.device)])
    return cc, cx, cy


def train_rounds_resumable(t, wid, freq, rules, used, used_ids0, limit, vocab_size, batch_k=16):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)`` or no
    candidate is accepted (done).  Plain torch version of the JAX program
    on any device: each round counts every pair of the front-compacted
    stream ``t``/``wid`` [M] int32, takes the top ``batch_k`` candidates,
    accepts the longest non-intersecting prefix, merges it and compacts
    the stream; ``rules`` [vocab_size, 4] int32 is updated in place.
    Returns (t, wid, rules, used, done)."""
    used = int(used)
    t = t.to(torch.int32)
    wid = wid.to(torch.int32)
    done = False
    while not done and used < min(vocab_size, int(limit)):
        kx, ky, w = pair_keys_and_weights(t, wid, freq)
        cnt, xs, ys = _segment_counts_flat(kx, ky, w)
        cc, cx, cy = _topk_candidates(cnt, xs, ys, batch_k)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, batch_k)
        done = n_acc == 0
        if n_acc:  # with nothing accepted the compacted stream stays as it is
            t, wid = apply_accepted(t, wid, acc, cx, cy, zs)
        store_rules(rules, acc, cx, cy, cc, zs, int(used_ids0), vocab_size)
        used += n_acc
    return t, wid, rules, used, done


def flatten_word_buckets(buckets) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[(tokens [W, L], freq [W])...] -> (t [M], wid [M], freq [WCAP]).

    M is padded to a power of two, as in the JAX package."""
    ts = []
    ws = []
    fs = []
    wbase = 0
    # the JAX package accumulates counts in int32 (no x64 on a TPU): the
    # total weighted pair mass must stay below 2^31; the port keeps the
    # limit so that both packages accept the same corpora
    mass = sum(
        int((cnt.astype(np.int64) * np.maximum((mat >= 0).sum(1) - 1, 0)).sum())
        for mat, cnt in buckets
    )
    if mass >= 2**31:
        raise ValueError(
            f"corpus too large for a single device pass: weighted pair "
            f"mass {mass} exceeds int32 range; shard the corpus across "
            f"hosts/devices"
        )
    for mat, cnt in buckets:
        valid = mat >= 0
        ts.append(mat[valid].astype(np.int32))
        k = mat.shape[0]
        widm = np.broadcast_to(
            (wbase + np.arange(k, dtype=np.int32))[:, None], mat.shape
        )
        ws.append(widm[valid].astype(np.int32))
        fs.append(cnt.astype(np.int32))
        wbase += k
    t = np.concatenate(ts) if ts else np.zeros(0, np.int32)
    wid = np.concatenate(ws) if ws else np.zeros(0, np.int32)
    freq = np.concatenate(fs) if fs else np.zeros(1, np.int32)
    m = max(16, 1 << int(np.ceil(np.log2(max(t.size, 1)))))
    tp = np.full(m, PAD, np.int32)
    wp = np.full(m, PAD, np.int32)
    tp[: t.size] = t
    wp[: wid.size] = wid
    return tp, wp, freq


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_snapshot(path, t, wid, freq, rules, used: int, used_ids0: int):
    """Portable mid-training snapshot (the JAX package's format): the
    live stream compacted, and only the filled rule rows, so a snapshot
    resumes under either package and any target ``vocab_size`` >= used."""
    t = _np(t)
    wid = _np(wid)
    live = t >= 0
    np.savez(
        path,
        t=t[live],
        wid=wid[live],
        freq=_np(freq),
        rules=_np(rules)[: used - used_ids0],
        used=used,
        used_ids0=used_ids0,
        version=1,
    )


def load_snapshot(path, used_ids0: int, vocab_size: int):
    """Load a save_snapshot file: re-pad the stream to a power of two
    and the rules to the resuming run's [vocab_size, 4] (numpy)."""
    snap = np.load(path)
    if int(snap["used_ids0"]) != used_ids0:
        raise ValueError(
            f"snapshot was trained with {int(snap['used_ids0'])} base ids, "
            f"this corpus/config produces {used_ids0}"
        )
    used = int(snap["used"])
    if used > vocab_size:
        raise ValueError(
            f"snapshot already contains {used} ids > vocab_size={vocab_size}"
        )
    t, wid, freq = snap["t"], snap["wid"], snap["freq"]
    m = max(16, 1 << int(np.ceil(np.log2(max(t.size, 1)))))
    tp = np.full(m, PAD, np.int32)
    wp = np.full(m, PAD, np.int32)
    tp[: t.size] = t
    wp[: wid.size] = wid
    rules_h = np.full((vocab_size, 4), -1, np.int32)
    stored = np.asarray(snap["rules"], np.int32)
    rules_h[: stored.shape[0], : stored.shape[1]] = stored[: used - used_ids0]
    return tp, wp, freq, rules_h, used


def run_segments(engine, used: int, used_ids0: int, vocab_size: int, seg: int,
                 progress_every: int = 0, checkpoint_path=None, checkpoint_every: int = 0,
                 progress_cb=None, detail=None) -> int:
    """The JAX package's host loop over segments of at most ``seg`` ids:
    after an overflow the engine regrows and the segment runs again; after
    each segment come the merge log, the progress line (``detail()`` adds
    to it) and the checkpoint.  ``engine`` has ``segment(used, limit) ->
    (used, done, overflow)``, ``regrow()``, ``rules`` and ``stream()``.
    Returns ``used``."""
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
                f"({dt:.1f}s, {n_merges / max(dt, 1e-9):.0f} merges/s"
                f"{detail() if detail else ''})",
                file=sys.stderr,
            )
        if checkpoint_path and checkpoint_every and used < vocab_size:
            st_t, st_w, st_f = engine.stream()
            save_snapshot(checkpoint_path, st_t, st_w, st_f, engine.rules, used, used_ids0)
        if done:
            break
    return used


def run_to_end(engine, used: int, vocab_size: int) -> int:
    """The host loop of the trainers that report no progress (v0, the
    sharded v1 and v0): segments to ``vocab_size``, the engine regrown
    after an overflow, until done.  Returns ``used``."""
    while used < vocab_size:
        used, done, overflow = engine.segment(used, vocab_size)
        if overflow:
            engine.regrow()
        elif done:
            break
    return used


def segment_ids(progress_every: int, checkpoint_every: int, progress_cb, vocab_size: int) -> int:
    """The JAX host loops' segment length: the smallest of the progress and
    checkpoint intervals, 1000 with the merge log, and the vocab size."""
    return min(
        x for x in (progress_every, checkpoint_every, 1000 if progress_cb else 0, vocab_size) if x
    )


def learned_rules(rules: torch.Tensor, used: int, used_ids0: int, vocab_size: int):
    """The (x, y, z) rule list, with the JAX host loops' early-stop warning."""
    n = used - used_ids0
    if n < vocab_size - used_ids0:
        print(f"WARNING merged only: {used} pairs of tokens", file=sys.stderr)
    return [tuple(map(int, r)) for r in rules[:n, :3].cpu().numpy()]


class PlainStreamEngine:
    """Segments of ``train_rounds_resumable`` (never an overflow: v1 keeps
    no table across rounds)."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        self.t = torch.from_numpy(np.array(t, np.int32)).to(device)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(device)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(device)
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(device)

    def segment(self, used: int, limit: int):
        self.t, self.wid, self.rules, used, done = train_rounds_resumable(
            self.t, self.wid, self.freq, self.rules, used, self.used_ids0, limit,
            self.vocab_size, self.batch_k,
        )
        return used, done, False

    def stream(self):
        return self.t, self.wid, self.freq


def run_training_stream(
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
    """The v1 host loop, with the JAX package's contract: segments of at
    most ``progress_every``, ``checkpoint_every`` or 1000 ids (the merge
    log), and after each the merge log, the progress line and the
    checkpoint (the shared snapshot files).  ``device`` holds the training
    state; ``plain`` picks the plain round loop over the kernels."""
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
        engine_cls = PlainStreamEngine
    else:
        from .stream_train_kernels import StreamKernelEngine as engine_cls
    engine = engine_cls(t, wid, freq, rules, used_ids0, vocab_size, batch_k, torch.device(device))
    used = run_segments(
        engine, used, used_ids0, vocab_size,
        segment_ids(progress_every, checkpoint_every, progress_cb, vocab_size),
        progress_every, checkpoint_path, checkpoint_every, progress_cb,
    )
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
