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
  block_apply   a warp a row flags the rows with a hit and lists them; with
                at most KB listed (the block path) a warp a listed row takes
                the row's pairs out, merges, front-packs the row in place and
                puts its pairs back; with more (the full path) every row is
                merged and front-packed and the table counted again

``ctl`` (int32 [12]) holds the round control on the card, so the host
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

NBAFF, RECOUNT = CTL_OWN, CTL_OWN + 1  # the round's listed rows, its full path
CTL_N = 12
W_ROWS, W_FULL = W_OWN, W_OWN + 1  # work: block-path rows, full-path rounds
MAX_B = 512  # the widest row the kernels hold in shared memory


class BlockState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    n_own = 2  # NBAFF, RECOUNT

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
        self.rows = torch.zeros(max(self.NB, 1), dtype=torch.int32, device=dev)
        self.control(rules, used, CTL_N)
        self.resize(cap)




# -- plain torch versions -----------------------------------------------------


def block_count_plain(st: BlockState):
    keys, w = _word_pairs(st.tok, st.wid, st.freq, st.tok >= 0)
    _hash_update(st.keys, st.cnts, st.ctl, OCC, OVERFLOW, keys, w)


def block_apply_plain(st: BlockState, KB: int):
    n = int(st.ctl[NACC])
    if n == 0:
        return
    B, NB = st.B, st.NB
    cx, cy, zs = st.cand[:n, 0], st.cand[:n, 1], st.cand[:n, 2]
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
        return
    # the full path: every row merged and front-packed, the table counted again
    t2, w2, _ = _apply_rowwise(st.tok, st.wid, zero, hit, rix, zs, B)
    st.tok.copy_(t2)
    st.wid.copy_(w2)
    st.ctl[RECOUNT] = 1
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    block_count_plain(st)
    st.work[W_FULL] += 1


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
    row, the table counted again)."""
    if not _on(st, "block_apply"):
        return block_apply_plain(st, KB)
    lib = _cuda.load_block()
    with torch.cuda.device(st.device):
        err = lib.yttm_block_apply(
            st.tok.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.B, st.NB,
            st.rows.data_ptr(), int(min(KB, st.NB)), st.keys.data_ptr(), st.cnts.data_ptr(),
            st.cap, st.ctl.data_ptr(), st.cand.data_ptr(), st.work.data_ptr(),
            _stream_ptr(st.device),
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
