"""The v4 block trainer's round as three kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_block.py:130
train_rounds_block`` gathers the rows with a hit into a ``[KB, B]`` mini
stream, applies it with a per-row sort and folds the contributions into a
sorted table with another sort, because a TPU cannot scatter into a table.
On a card the round is hand-written CUDA (``csrc/train_block.cu``) over the
JAX program's own ``[NB, B]`` rows (so they equal the JAX program's at
every segment end) and an exact open-addressing pair-count table kept
across rounds (int64 keys ``x << 32 | y``, int32 counts; a key keeps its
slot at count 0 until the next rebuild):

  block_count   count every row's pairs into an empty table (start, and
                rebuild after an overflow)
  topk_accept   top-16 live entries in the reference order, accept_prefix,
                store_rules (the trainers' shared wrapper, ``train_kernels``)
  block_apply   a flat walk of the rows that can hold tokens, each below
                its live extent (``ext``), lists the rows with a hit; with at
                most KB listed (the block path) a warp a listed row takes the
                row's pairs out, merges, front-packs the row in place and
                puts its pairs back; with more (the full path) every row is
                merged, front-packed and counted into the emptied table, in
                the same launch

``ctl`` (int32 [10]) holds the round control on the card, so the host
enqueues rounds in batches and reads ``ctl`` once per batch; ``work``
(int64) sums what each round's data gives the kernels.  Each wrapper
launches its kernels on a CUDA state (and counts the launch) and runs its
plain torch version on a CPU state; the two leave the same rows, ``ctl``,
rules and table as a multiset of (key, count) slots (but for a count that
overflows).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .tiered_kernels import _hash_update, _word_pairs
from .train_block import _apply_rowwise, block_kb
from .train_kernels import (
    CTL_OWN,
    EMPTY,
    ERROR,
    NACC,
    OCC,
    OVERFLOW,
    W_OWN,
    TableEngine,
    TableState,
    _check,
    _on,
    _stream_ptr,
    initial_cap,
    rules_used,
    topk_accept,
)
from .train_stream import pair_hits

NBAFF = CTL_OWN  # the round's listed rows
CTL_N = CTL_OWN + 3  # the apply's grid barrier takes 2 slots after NBAFF (0 between launches)
# work: block-path rows, full-path rounds, the bytes the flag walk and the
# apply must move
W_ROWS, W_FULL, W_READ, W_APPLY = range(W_OWN, W_OWN + 4)
MAX_B = 512  # the widest row the kernels hold in shared memory


class BlockState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    n_own = 1  # NBAFF

    def __init__(self, t, wid, freq, rules, used: int, B: int, cap: int, device):
        if B > MAX_B:
            raise ValueError(f"block size {B} exceeds {MAX_B}")
        dev = torch.device(device)
        self.device, self.B = dev, B
        # copies: the kernels update the rows in place
        self.tok = torch.from_numpy(np.array(t, np.int32)).to(dev)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(dev)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(dev)
        self.NB = self.tok.shape[0] // B
        # each row's live extent (its last live slot + 1); the rows past NL
        # hold no token and never will (the rows only lose tokens)
        self.ext = row_extents(self.tok, B)
        live_rows = torch.nonzero(self.ext).flatten()
        self.NL = int(live_rows[-1]) + 1 if live_rows.numel() else 0
        self.rows = torch.zeros(max(self.NB, 1), dtype=torch.int32, device=dev)
        self.control(rules, used, CTL_N)
        self.resize(cap)




# -- plain torch versions -----------------------------------------------------


def row_extents(tok, B: int):
    """Each [B] row's live extent: its last live slot + 1, 0 for a row of PAD."""
    live = tok.view(-1, B) >= 0
    at = torch.arange(1, B + 1, dtype=torch.int32, device=tok.device)
    return (live * at).amax(dim=1).to(torch.int32)


def block_count_plain(st: BlockState) -> int:
    """Count the rows' pairs into the table; returns the pairs counted."""
    keys, w = _word_pairs(st.tok, st.wid, st.freq, st.tok >= 0)
    _hash_update(st.keys, st.cnts, st.ctl, OCC, OVERFLOW, keys, w)
    return keys.numel()


def _token_pairs(st: BlockState, cx, cy) -> int:
    """The slots whose token and the next one in their row are an accepted
    pair as tokens, word ids unread: where the flag walk reads two word ids."""
    t2d = st.tok.view(st.NB, st.B)
    a, b = t2d[:, :-1], t2d[:, 1:]
    m = torch.zeros_like(a, dtype=torch.bool)
    for x, y in zip(cx.tolist(), cy.tolist()):
        m |= (a == x) & (b == y)
    return int(m.sum())


def block_apply_plain(st: BlockState, KB: int):
    n = int(st.ctl[NACC])
    if n == 0:
        return
    B, NB, NL = st.B, st.NB, st.NL
    cx, cy, zs = st.cand[:n, 0], st.cand[:n, 1], st.cand[:n, 2]
    # the flag walk: each row's extent, its tokens below it, two word ids
    # where a pair of tokens is a candidate
    st.work[W_READ] += 4 * NL + 4 * int(st.ext[:NL].sum()) + 8 * _token_pairs(st, cx, cy)
    acc = torch.ones(n, dtype=torch.bool, device=st.device)
    hit, rix = pair_hits(st.tok, st.wid, acc, cx, cy)
    rows = torch.nonzero(hit.reshape(NB, B).any(dim=1)).flatten()
    st.ctl[NBAFF] = rows.numel()
    zero = torch.zeros_like(st.tok)
    if rows.numel() <= min(KB, NB):  # the block path: the listed rows, in place
        t2d, w2d = st.tok.view(NB, B), st.wid.view(NB, B)
        mt, mw = t2d[rows].reshape(-1), w2d[rows].reshape(-1)
        old_k, old_w = _word_pairs(mt, mw, st.freq, mt >= 0)
        mhit, mrix = pair_hits(mt, mw, acc, cx, cy)
        mt2, mw2, _ = _apply_rowwise(mt, mw, zero[: mt.shape[0]], mhit, mrix, zs, B)
        new_k, new_w = _word_pairs(mt2, mw2, st.freq, mt2 >= 0)
        _hash_update(
            st.keys, st.cnts, st.ctl, OCC, OVERFLOW, torch.cat([old_k, new_k]),
            torch.cat([-old_w, new_w]), err_i=ERROR,
        )
        t2d[rows] = mt2.reshape(-1, B)
        w2d[rows] = mw2.reshape(-1, B)
        st.work[W_ROWS] += rows.numel()
        # the listed rows below their extents read and written (tok and
        # wid), a table entry a pair taken out or put back
        st.work[W_APPLY] += 16 * int(st.ext[rows].sum()) + 12 * (old_k.numel() + new_k.numel())
        st.ext[rows] = row_extents(mt2, B)
        return
    # the full path: every row merged and front-packed, the table counted again
    t2, w2, _ = _apply_rowwise(st.tok, st.wid, zero, hit, rix, zs, B)
    st.tok.copy_(t2)
    st.wid.copy_(w2)
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    counted = block_count_plain(st)
    st.work[W_FULL] += 1
    st.work[W_APPLY] += 16 * int(st.ext[:NL].sum()) + 12 * st.cap + 12 * counted
    st.ext.copy_(row_extents(st.tok, B))


# -- wrappers -----------------------------------------------------------------


def block_count(st: BlockState):
    """Empty the table and count every row's pairs into it; sets
    ``ctl[OVERFLOW]`` when the table holds more than half its slots."""
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    st.ctl[OVERFLOW] = 0
    if not _on(st, "block_count"):
        return block_count_plain(st)
    lib = _cuda.load_block()
    with torch.cuda.device(st.device):
        err = lib.yttm_block_count(
            st.tok.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.B, st.NB,
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "block_count")
    block_count.launches += 1


def block_apply(st: BlockState, KB: int):
    """Merge the round's accepted candidates into the rows with a hit: the
    block path (at most ``KB`` rows, table deltas) or the full path (every
    row, the table counted again); the rows' extents follow."""
    if not _on(st, "block_apply"):
        return block_apply_plain(st, KB)
    lib = _cuda.load_block()
    with torch.cuda.device(st.device):
        err = lib.yttm_block_apply(
            st.tok.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.B, st.NL,
            st.ext.data_ptr(), st.rows.data_ptr(), int(min(KB, st.NB)), st.keys.data_ptr(),
            st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), st.cand.data_ptr(),
            st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "block_apply")
    block_apply.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
block_count.launches = 0
block_apply.launches = 0


# -- host loop ----------------------------------------------------------------


class BlockKernelEngine(TableEngine):
    """Segments of rounds through the kernels, for
    ``train_block.run_training_block``.  The table has 2 * pcap slots
    (``YTTM_TRAIN_PCAP``; by default a 32nd of the stream's slots, at least
    2^14, doubled until the first count fits in half of it) and is rebuilt
    from the rows when more than half of them are taken (``regrow``);
    ``YTTM_TRAIN_KB`` bounds the block path as in the JAX host loop."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, B, device):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        m = int(np.asarray(t).shape[0])
        self.KB = block_kb(m, B)
        cap = initial_cap(m)
        used = rules_used(rules, used_ids0)
        self.st = BlockState(t, wid, freq, rules, used, B, cap, device)
        self._count()

    def count(self):
        block_count(self.st)

    def round(self, limit: int):
        topk_accept(self.st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        block_apply(self.st, self.KB)

    def stream(self):
        return self.st.tok, self.st.wid, self.st.freq
