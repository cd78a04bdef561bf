"""The v1 stream trainer's round as three kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_stream.py:251
train_rounds_resumable`` recounts every pair each round with a 3-array
sort and compacts the whole stream with another.  On a card the round is
three hand-written CUDA kernels (``csrc/train_stream.cu``) over the JAX
program's own stream, front-compacted, in two buffers ``t0``/``w0`` and
``t1``/``w1`` [M]: a round reads one and its apply writes the other, so
the buffer the last apply wrote (``StreamState.t``/``wid``) equals the JAX
program's stream at every segment end, PAD tail included.  Which buffer a
round reads is kept in ``ctl``, so the host enqueues rounds without
reading it.  A fresh open-addressing pair-count table each round (int64
keys ``x << 32 | y``, int32 counts):

  recount        turn to the buffer the last apply wrote, empty the table
                 and count every pair of the live stream
                 (``csrc/stream_count.cuh``: a flat walk, a warp a run of
                 128-slot chunks, each block counting into a table of its
                 own in shared memory); the run parity takes the last
                 non-equal position before each token from a warp max-scan
                 carried from chunk to chunk, so a run may span any number
                 of chunks, warps and blocks
  topk_accept    top-16 live entries in the reference order, accept_prefix,
                 store_rules (the trainers' shared wrapper, ``train_kernels``)
  apply_compact  one launch (for every shard of a card): hits of the
                 accepted pairs, parity along runs of hits (a carried
                 max-scan), z written, right partners dropped, and the
                 kept tokens written in order into the other buffer at
                 offsets from a single-pass chained scan (tiles of 4096
                 slots, decoupled look-back), PAD from the new live end to
                 that buffer's old one

``ctl`` (int32 [19]) holds the round control on the card, so the host
enqueues rounds in batches and reads ``ctl`` once per batch; ``work``
(int64) sums what each round's data gives the kernels (for the bounds).
Each wrapper launches its kernels on a CUDA state (and counts the launch)
and runs its plain torch version on a CPU state; the two leave the same
buffers, ``ctl``, rules and table as a multiset of (key, count) slots (but
for a count that overflows: its table is left unfinished, to be counted
again at twice the size).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda
from .tiered_kernels import _hash_update
from .train_kernels import (
    CTL_OWN,
    DONE,
    EMPTY,
    NACC,
    OCC,
    OVERFLOW,
    USED,
    W_OWN,
    TableState,
    _check,
    _on,
    _stream_ptr,
    initial_cap,
    round_active,
    rules_used,
    topk_accept,
)
from .train_stream import PAD, apply_accepted, pair_keys_and_weights

# ctl: the live tokens of the buffer the round reads, and after its apply;
# past the sharded exchange's slots (delta_sharded_kernels.CTL_N = 16) the
# buffer the round reads (0: t0/w0, 1: t1/w1), the one its apply wrote, and
# the live end that the other buffer still holds (csrc/stream_count.cuh
# StreamCtl)
LIVE, NEXT_LIVE = CTL_OWN, CTL_OWN + 1
BUF, NEXT_BUF, PREV_END = 16, 17, 18
CTL_N = 19
W_LIVE, W_KEEP = W_OWN, W_OWN + 1  # work: live and kept tokens of the applied rounds
TILE = 4096  # slots of a tile of the apply (its look-back descriptors)
TILE_SCRATCH = 3  # the apply's ticket, finished blocks and epoch, before the descriptors


class StreamState(TableState):
    """The kernel trainer's state on one device (see the module note): the
    stream in two buffers, ``t0``/``w0`` and ``t1``/``w1``; ``t`` and
    ``wid`` are the one the last apply wrote (each holds its live tokens
    front-compacted, PAD after them)."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device):
        dev = torch.device(device)
        self.device = dev
        # copies: the kernels update the stream in place
        self.t0 = torch.from_numpy(np.array(t, np.int32)).to(dev)
        self.w0 = torch.from_numpy(np.array(wid, np.int32)).to(dev)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(dev)
        m = self.t0.shape[0]
        self.t1 = torch.full((m,), PAD, dtype=torch.int32, device=dev)
        self.w1 = torch.full((m,), PAD, dtype=torch.int32, device=dev)
        self.tiles = torch.zeros(TILE_SCRATCH + max(1, -(-m // TILE)), dtype=torch.int64,
                                 device=dev)
        self._rows = None
        self.control(rules, used, CTL_N)
        self.ctl[LIVE] = self.ctl[NEXT_LIVE] = int((self.t0 >= 0).sum())
        self.resize(cap)

    def stream_of(self, b: int):
        """Buffer ``b``'s (tokens, word ids)."""
        return (self.t0, self.w0) if b == 0 else (self.t1, self.w1)

    @property
    def t(self):
        return self.stream_of(int(self.ctl[NEXT_BUF]))[0]

    @property
    def wid(self):
        return self.stream_of(int(self.ctl[NEXT_BUF]))[1]


# -- plain torch versions -----------------------------------------------------


def turn(st: StreamState):
    """The count's first step: after an apply, read the buffer it wrote
    (the other one keeps the live end it had)."""
    if int(st.ctl[NEXT_BUF]) != int(st.ctl[BUF]):
        st.ctl[PREV_END] = st.ctl[LIVE]
        st.ctl[BUF] = st.ctl[NEXT_BUF]
    st.ctl[LIVE] = st.ctl[NEXT_LIVE]


def live_pairs(st: StreamState):
    """The keys and weights of the read buffer's counted pairs."""
    n = int(st.ctl[LIVE])
    t, wid = st.stream_of(int(st.ctl[BUF]))
    kx, ky, w = pair_keys_and_weights(t[:n], wid[:n], st.freq)
    on = w > 0
    return (kx[on].long() << 32) | ky[on].long(), w[on]


def recount_plain(st: StreamState, limit: int, vocab_size: int):
    turn(st)
    if not round_active(st, limit, vocab_size):
        return
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    _hash_update(st.keys, st.cnts, st.ctl, OCC, OVERFLOW, *live_pairs(st))


def apply_compact_plain(st: StreamState):
    n_acc = int(st.ctl[NACC])
    if n_acc == 0:
        return
    n, b, end = (int(st.ctl[k]) for k in (LIVE, BUF, PREV_END))
    t, wid = st.stream_of(b)
    dt, dw = st.stream_of(1 - b)
    cx, cy, zs = st.cand[:n_acc, 0], st.cand[:n_acc, 1], st.cand[:n_acc, 2]
    acc = torch.ones(n_acc, dtype=torch.bool, device=st.device)
    t2, w2 = apply_accepted(t[:n], wid[:n], acc, cx, cy, zs)
    keep = int((t2 >= 0).sum())
    dt[:keep] = t2[:keep]
    dw[:keep] = w2[:keep]
    dt[keep:end] = PAD
    dw[keep:end] = PAD
    st.ctl[NEXT_LIVE] = keep
    st.ctl[NEXT_BUF] = 1 - b
    st.work[W_LIVE] += n
    st.work[W_KEEP] += keep


# -- wrappers -----------------------------------------------------------------


def check_aligned(st: StreamState, what: str):
    """The count's and the apply's 16-byte loads need both buffers 16-byte
    aligned."""
    if any(x.data_ptr() % 16 for x in (st.t0, st.w0, st.t1, st.w1)):
        raise ValueError(f"{what} needs a 16-byte aligned stream")


def bufs(st: StreamState) -> tuple:
    """The buffers' addresses, as the C entries take them."""
    return st.t0.data_ptr(), st.w0.data_ptr(), st.t1.data_ptr(), st.w1.data_ptr()


# The v1 count's grid (recount, recount_sharded_kernels.stream_shard_count):
# 0 is one wave of blocks, the trainers' grid; a check sets it > 0 to cap the
# blocks, so that each warp walks many chunks of a short stream.
COUNT_BLOCKS = 0


def recount(st: StreamState, limit: int, vocab_size: int):
    """Turn to the buffer the last apply wrote, empty the table and count
    every pair of the live stream into it (a no-op once the round loop
    stopped); sets ``ctl[OVERFLOW]`` when the table holds more than half its
    slots.  The count's grid: COUNT_BLOCKS."""
    if not _on(st, "recount"):
        return recount_plain(st, limit, vocab_size)
    check_aligned(st, "recount")
    lib = _cuda.load_stream_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_stream_recount(
            *bufs(st), st.freq.data_ptr(), st.t0.shape[0], st.keys.data_ptr(),
            st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), int(limit), int(vocab_size),
            int(COUNT_BLOCKS), _stream_ptr(st.device),
        )
    _check(err, "recount")
    recount.launches += 1


def _apply_rows(states):
    """A device array (on ``states[0]``'s device) of the shards of one card,
    a row each as ``csrc/train_stream.cu`` ApplyShard lays it out: t0, t1,
    w0, w1, ctl, cand, tiles, work.  Rebuilt when a buffer moved."""
    head = states[0]
    for st in states:
        if st.device != head.device:
            raise ValueError("apply_compact takes the shards of one device")
        check_aligned(st, "apply_compact")
    rows = [[st.t0.data_ptr(), st.t1.data_ptr(), st.w0.data_ptr(), st.w1.data_ptr(),
             st.ctl.data_ptr(), st.cand.data_ptr(), st.tiles.data_ptr(), st.work.data_ptr()]
            for st in states]
    if head._rows is None or head._rows[0] != rows:
        head._rows = (rows, torch.tensor(rows, dtype=torch.int64, device=head.device))
    return head._rows[1]


def apply_compact(states):
    """Merge the round's accepted candidates into the streams of ``states``
    (one device's, which took the same candidates), each compacted from the
    buffer the round read into the other: one launch for all of them."""
    if not _on(states[0], "apply_compact"):
        for st in states:
            apply_compact_plain(st)
        return
    rows = _apply_rows(states)
    lib = _cuda.load_stream_train()
    with torch.cuda.device(states[0].device):
        err = lib.yttm_stream_apply(rows.data_ptr(), len(states),
                                    sum(st.t0.shape[0] for st in states),
                                    _stream_ptr(states[0].device))
    _check(err, "apply_compact")
    apply_compact.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
recount.launches = 0
apply_compact.launches = 0


# -- host loop ----------------------------------------------------------------


class StreamKernelEngine:
    """Segments of rounds through the three kernels, for
    ``train_stream.run_training_stream``.  The table starts at a 32nd of
    the stream's length (at least 2^14 slots; ``YTTM_TRAIN_PCAP`` sets it
    to twice that pcap instead) and doubles until a count fits in half of
    it, at the start and whenever a round's count overflows (``regrow``)."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        m = int(np.asarray(t).shape[0])
        cap = initial_cap(m)
        used = rules_used(rules, used_ids0)
        self.st = StreamState(t, wid, freq, rules, used, cap, device)
        self.rebuilds = 0
        while True:  # size the table to the first count
            recount(self.st, vocab_size, vocab_size)
            if not int(self.st.ctl[OVERFLOW]):
                break
            self.st.resize(self.st.cap * 2)
            self.st.ctl[OVERFLOW] = 0

    @property
    def rules(self):
        return self.st.rules

    def segment(self, used: int, limit: int):
        st = self.st
        on_card = st.device.type == "cuda"
        while True:
            # each active round accepts at most batch_k ids, so this many
            # rounds never run past the segment's end
            n = max(1, math.ceil((limit - used) / self.batch_k)) if on_card else 1
            for _ in range(n):
                recount(st, limit, self.vocab_size)
                topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
                apply_compact([st])
            used, done, overflow = (int(v) for v in st.ctl[[USED, DONE, OVERFLOW]].tolist())
            if done or overflow or used >= min(limit, self.vocab_size):
                return used, bool(done), bool(overflow)

    def regrow(self):
        """After a count overflowed: a table twice the size (each round
        counts into a fresh table)."""
        self.rebuilds += 1
        self.st.resize(self.st.cap * 2)
        self.st.ctl[OVERFLOW] = 0

    def stream(self):
        return self.st.t, self.st.wid, self.st.freq
