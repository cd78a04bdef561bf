"""The v3 sparse trainer's round as three kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_sparse.py:156
train_rounds_sparse`` finds the next live neighbours with a suffix-min
scan, gathers the affected positions into site buffers with a binary
search and folds their deltas into a sorted table.  On a card the round is
hand-written CUDA (``csrc/train_sparse.cu``) over the JAX program's own
state, the tombstoned stream ``t`` [M] whose positions never move (so it
equals the JAX program's at every segment end), with static ``wid`` and
word frequencies, and an exact open-addressing pair-count table kept
across rounds (int64 keys ``x << 32 | y``, int32 counts; a key keeps its
slot at count 0 until the next rebuild):

  sparse_count   count every word's live pairs into an empty table (start,
                 and rebuild after an overflow)
  topk_accept    top-16 live entries in the reference order, accept_prefix,
                 store_rules (the trainers' shared wrapper, ``train_kernels``)
  sparse_apply   pass 1 lists the words holding an accepted pair among their
                 live tokens (the next live neighbour lies inside the word,
                 tombstones skipped); pass 2, one warp a listed word, walks
                 it with a ballot-compacted live list: old pairs out (parity
                 in live-rank space), z at the selected starts and PAD at
                 their live partners in place, new pairs in

``ctl`` (int32 [8]) holds the round control on the card, so the host
enqueues rounds in batches and reads ``ctl`` once per batch; ``work``
(int64) sums what each round's data gives the kernels.  Each wrapper
launches its kernels on a CUDA state (and counts the launch) and runs its
plain torch version on a CPU state; the two leave the same stream,
``ctl``, rules and table as a multiset of (key, count) slots (but for a
count that overflows).  The JAX program's site-buffer tiers decide nothing
observable; the kernels have one path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .tiered_kernels import _hash_update
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
from .train_sparse import _apply_tomb, _pairs_tomb

NAFF = CTL_OWN  # the round's listed words
W_SITES, W_TOUCH = W_OWN, W_OWN + 1  # work: positions walked, table updates


class SparseState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    n_own = 1  # NAFF

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device):
        dev = torch.device(device)
        self.device = dev
        wid = np.asarray(wid, np.int32)
        in_word = np.flatnonzero(wid >= 0)
        # the words lie end to end (the flat layout): word k is the run of
        # one word id at positions [off[k], off[k + 1])
        assert in_word.size == 0 or in_word[-1] - in_word[0] + 1 == in_word.size
        starts = in_word[np.concatenate([[True], wid[in_word[1:]] != wid[in_word[:-1]]])] if (
            in_word.size) else np.zeros(0, np.int64)
        ends = np.append(starts[1:], in_word[-1] + 1 if in_word.size else 0)
        self.n_words = int(starts.size)
        off = np.append(starts, ends[-1] if self.n_words else 0)
        pw = np.full(wid.size, -1, np.int32)
        pw[in_word] = np.repeat(np.arange(self.n_words, dtype=np.int32), ends - starts)
        self.t = torch.from_numpy(np.array(t, np.int32)).to(dev)  # a copy: updated in place
        self.wid = torch.from_numpy(wid.copy()).to(dev)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(dev)
        self.off = torch.from_numpy(off.astype(np.int32)).to(dev)
        self.pw = torch.from_numpy(pw).to(dev)
        self.fw = torch.from_numpy(np.asarray(freq, np.int32)[wid[starts]]).to(dev)
        self.control(rules, used)
        self.aff = torch.zeros(max(self.n_words, 1), dtype=torch.int32, device=dev)
        self.wmark = torch.zeros(max(self.n_words, 1), dtype=torch.int32, device=dev)
        self.resize(cap)


    def fw_pos(self):
        return (self.freq[self.wid.clamp(min=0).long()] * (self.wid >= 0)).to(torch.int32)



# -- plain torch versions -----------------------------------------------------


def sparse_count_plain(st: SparseState):
    keys, w, _, _ = _pairs_tomb(st.t, st.wid, st.fw_pos())
    on = w > 0
    _hash_update(st.keys, st.cnts, st.ctl, OCC, OVERFLOW, keys[on], w[on])


def sparse_apply_plain(st: SparseState):
    n = int(st.ctl[NACC])
    if n == 0:
        return
    cx, cy, zs = st.cand[:n, 0], st.cand[:n, 1], st.cand[:n, 2]
    acc = torch.ones(n, dtype=torch.bool, device=st.device)
    fw = st.fw_pos()
    keys, w, live, d = _pairs_tomb(st.t, st.wid, fw)
    t2, hit = _apply_tomb(st.t, keys, live, d, acc, cx, cy, zs)
    pw = st.pw.long()
    aff_w = torch.zeros(max(st.n_words, 1), dtype=torch.bool, device=st.device)
    aff_w[pw[hit]] = True
    aff = (pw >= 0) & aff_w[pw.clamp(min=0)]
    st.ctl[NAFF] = int(aff_w.sum())
    keys2, w2, _, _ = _pairs_tomb(t2, st.wid, fw)
    old, new = aff & (w > 0), aff & (w2 > 0)
    _hash_update(
        st.keys, st.cnts, st.ctl, OCC, OVERFLOW, torch.cat([keys[old], keys2[new]]),
        torch.cat([-w[old], w2[new]]), err_i=ERROR,
    )
    st.t.copy_(t2)
    st.work[W_SITES] += int(aff.sum())
    st.work[W_TOUCH] += int(old.sum()) + int(new.sum())


# -- wrappers -----------------------------------------------------------------


def sparse_count(st: SparseState):
    """Empty the table and count every word's live pairs into it; sets
    ``ctl[OVERFLOW]`` when the table holds more than half its slots."""
    st.keys.fill_(EMPTY)
    st.cnts.zero_()
    st.ctl[OCC] = 0
    st.ctl[OVERFLOW] = 0
    if st.n_words == 0:
        return
    if not _on(st, "sparse_count"):
        return sparse_count_plain(st)
    lib = _cuda.load_sparse()
    with torch.cuda.device(st.device):
        err = lib.yttm_sparse_count(
            st.t.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.n_words,
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "sparse_count")
    sparse_count.launches += 1


def sparse_apply(st: SparseState):
    """Merge the round's accepted candidates in place (tombstones) and move
    the table by the listed words' deltas."""
    if not _on(st, "sparse_apply"):
        return sparse_apply_plain(st)
    lib = _cuda.load_sparse()
    with torch.cuda.device(st.device):
        err = lib.yttm_sparse_apply(
            st.t.data_ptr(), st.pw.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(),
            st.n_words, st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            st.cand.data_ptr(), st.aff.data_ptr(), st.wmark.data_ptr(), st.work.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "sparse_apply")
    sparse_apply.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
sparse_count.launches = 0
sparse_apply.launches = 0


# -- host loop ----------------------------------------------------------------


class SparseKernelEngine(TableEngine):
    """Segments of rounds through the kernels, for
    ``train_sparse.run_training_sparse``.  The table has 2 * pcap slots
    (``YTTM_TRAIN_PCAP``; by default a 32nd of the stream's length, at
    least 2^14 slots, doubled until the first count fits in half of it) and
    is rebuilt from the stream when more than half of them are taken
    (``regrow``)."""

    def __init__(self, t, wid, freq, rules, used_ids0, vocab_size, batch_k, device):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        m = int(np.asarray(t).shape[0])
        cap = initial_cap(m)
        used = rules_used(rules, used_ids0)
        self.st = SparseState(t, wid, freq, rules, used, cap, device)
        self._count()

    def count(self):
        sparse_count(self.st)

    def round(self, limit: int):
        topk_accept(self.st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        sparse_apply(self.st)

    def detail(self) -> str:
        return f", {int((self.st.cnts > 0).sum())} live pair kinds / pcap {self.st.cap // 2}"

    def stream(self):
        return self.st.t, self.st.wid, self.st.freq
