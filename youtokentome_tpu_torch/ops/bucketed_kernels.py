"""The v0 bucketed trainer's round as three kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_kernel.py:97 train_rounds``
sorts every pair of every bucket each round to find one merge.  On a card
the round is hand-written CUDA (``csrc/train_bucketed.cu``, and the shared
top-k of ``csrc/train_topk.cu`` with k = 1) over the buckets themselves,
kept on the card as one array of rows (row r is ``tok[roff[r],
roff[r+1])``, a bucket's ``[Wb, Lb]`` matrix flattened),
and a fresh open-addressing pair-count table each round (int64 keys
``x << 32 | y``, int32 counts):

  bucket_count   empty the table, then one warp a row adds the row's pairs
                 (run parity inside runs of equal tokens), weighted by the
                 word's frequency
  topk_accept    the top pair in the reference order, its rule row,
                 ``ctl`` (the trainers' shared wrapper, ``train_kernels``,
                 with k = 1)
  bucket_apply   one warp a row merges the pair (even offsets inside runs
                 of hits) and front-packs the row in place, writing only the
                 slots whose value changes (counted in ``work``)

``ctl`` (int32 [8]) holds the round control on the card, so the host
enqueues rounds in batches and reads ``ctl`` once per batch.  Each wrapper
launches its kernel on a CUDA state (and counts the launch) and runs its
plain torch version on a CPU state; the two leave the same rows, ``ctl``,
rules and table as a multiset of (key, count) slots (but for a count that
overflows: its table is left unfinished, to be counted again at twice the
size).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .segment import apply_merge_rows
from .tiered_kernels import _hash_update
from .train_kernel import _pair_arrays
from .train_kernels import (
    BATCH,
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

W_WRITES = W_OWN  # work: the slots the applies changed


class BucketedState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    def __init__(self, buckets, rules, used: int, cap: int, device):
        dev = torch.device(device)
        self.device = dev
        self.shapes = [tuple(np.asarray(t).shape) for t, _ in buckets]
        tok = np.concatenate([np.asarray(t, np.int32).reshape(-1) for t, _ in buckets])
        lens = np.concatenate([np.full(w, l, np.int64) for w, l in self.shapes])
        roff = np.zeros(lens.size + 1, np.int64)
        np.cumsum(lens, out=roff[1:])
        self.n_rows = int(lens.size)
        self.tok = torch.from_numpy(tok).to(dev)
        self.roff = torch.from_numpy(roff.astype(np.int32)).to(dev)
        self.rfreq = torch.from_numpy(
            np.concatenate([np.asarray(f, np.int32) for _, f in buckets])
        ).to(dev)
        self.control(rules, used)
        self.resize(cap)


    def buckets(self):
        """The rows as the JAX program's bucket matrices (views)."""
        out, base = [], 0
        for w, l in self.shapes:
            out.append(self.tok[base : base + w * l].view(w, l))
            base += w * l
        return out



# -- plain torch versions -----------------------------------------------------


def row_pairs(st: BucketedState):
    """The keys and weights of every row's counted pairs."""
    freqs = torch.split(st.rfreq, [w for w, _ in st.shapes])
    keys, ws = [], []
    for mat, f in zip(st.buckets(), freqs):
        kx, ky, w = _pair_arrays(mat, f)
        on = w > 0
        keys.append((kx[on].long() << 32) | ky[on].long())
        ws.append(w[on])
    return torch.cat(keys), torch.cat(ws)


def bucket_count_plain(st: BucketedState, limit: int, vocab_size: int):
    if not round_active(st, limit, vocab_size):
        return
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    _hash_update(st.keys, st.cnts, st.ctl, OCC, OVERFLOW, *row_pairs(st))


def bucket_apply_plain(st: BucketedState):
    if int(st.ctl[NACC]) == 0:
        return
    x, y, z = (int(v) for v in st.cand[0, :3].tolist())
    for mat in st.buckets():
        new = apply_merge_rows(mat, x, y, z)
        st.work[W_WRITES] += int((new != mat).sum())
        mat.copy_(new)


# -- wrappers -----------------------------------------------------------------


def bucket_count(st: BucketedState, limit: int, vocab_size: int):
    """Empty the table and count every row's pairs into it (a no-op once
    the round loop stopped); sets ``ctl[OVERFLOW]`` when the table holds
    more than half its slots."""
    if not _on(st, "bucket_count"):
        return bucket_count_plain(st, limit, vocab_size)
    lib = _cuda.load_bucketed()
    with torch.cuda.device(st.device):
        err = lib.yttm_bucket_count(
            st.tok.data_ptr(), st.roff.data_ptr(), st.rfreq.data_ptr(), st.n_rows,
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), int(limit),
            int(vocab_size), _stream_ptr(st.device),
        )
    _check(err, "bucket_count")
    bucket_count.launches += 1


def bucket_apply(st: BucketedState):
    """Merge the round's pair in every row and front-pack the rows."""
    if not _on(st, "bucket_apply"):
        return bucket_apply_plain(st)
    lib = _cuda.load_bucketed()
    with torch.cuda.device(st.device):
        err = lib.yttm_bucket_apply(
            st.tok.data_ptr(), st.roff.data_ptr(), st.n_rows, st.ctl.data_ptr(),
            st.cand.data_ptr(), st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "bucket_apply")
    bucket_apply.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
bucket_count.launches = 0
bucket_apply.launches = 0


# -- host loop ----------------------------------------------------------------


class BucketedKernelEngine:
    """Rounds through the three kernels, for ``train_kernel.run_training``.
    The table starts at a 32nd of the rows' slots (at least 2^14;
    ``YTTM_TRAIN_PCAP`` sets it to twice that pcap instead) and doubles
    until a count fits in half of it, at the start and whenever a round's
    count overflows (``regrow``)."""

    def __init__(self, buckets, rules, used_ids0, vocab_size, device):
        self.vocab_size, self.used_ids0 = vocab_size, used_ids0
        slots = sum(int(np.asarray(t).size) for t, _ in buckets)
        cap = initial_cap(slots)
        used = rules_used(rules, used_ids0)
        self.st = BucketedState(buckets, rules, used, cap, device)
        self.rebuilds = 0
        while True:  # size the table to the first count
            bucket_count(self.st, vocab_size, vocab_size)
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
            # a round merges at most one pair, so this many rounds never
            # run past the segment's end
            n = min(max(1, limit - used), BATCH) if on_card else 1
            for _ in range(n):
                bucket_count(st, limit, self.vocab_size)
                topk_accept(st, limit, self.vocab_size, self.used_ids0, 1)
                bucket_apply(st)
            used, done, overflow = (int(v) for v in st.ctl[[USED, DONE, OVERFLOW]].tolist())
            if done or overflow or used >= min(limit, self.vocab_size):
                return used, bool(done), bool(overflow)

    def regrow(self):
        """After a count overflowed: a table twice the size (each round
        counts into a fresh table)."""
        self.rebuilds += 1
        self.st.resize(self.st.cap * 2)
        self.st.ctl[OVERFLOW] = 0
