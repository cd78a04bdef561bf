"""The v1 stream trainer's round as three kernels, and the loop that drives them.

The JAX program ``youtokentome_tpu/ops/train_stream.py:251
train_rounds_resumable`` recounts every pair each round with a 3-array
sort and compacts the whole stream with another.  On a card the round is
three hand-written CUDA kernels (``csrc/train_stream.cu``) over the JAX
program's own state, the front-compacted flat stream ``t``/``wid`` [M]
(so the stream equals the JAX program's at every segment end), and a
fresh open-addressing pair-count table each round (int64 keys
``x << 32 | y``, int32 counts):

  recount        empty the table and count every pair of the live stream;
                 the run parity takes the last non-equal position before
                 each token from a max-scan with a carry across tiles, so a
                 run may span any number of tiles
  topk_accept    top-16 live entries in the reference order, accept_prefix,
                 store_rules (the trainers' shared wrapper, ``train_kernels``)
  apply_compact  hits of the accepted pairs, parity along runs of hits (a
                 second carried max-scan), z written, right partners
                 dropped, and the whole stream compacted in order (tile
                 counts, an exclusive scan, a scatter)

``ctl`` (int32 [12]) holds the round control on the card, so the host
enqueues rounds in batches and reads ``ctl`` once per batch; ``work``
(int64) sums what each round's data gives the kernels (for the bounds).
Each wrapper launches its kernels on a CUDA state (and counts the launch)
and runs its plain torch version on a CPU state; the two leave the same
stream, ``ctl``, rules and table as a multiset of (key, count) slots (but
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
from .train_stream import apply_accepted, pair_keys_and_weights

LIVE, NEXT_LIVE = CTL_OWN, CTL_OWN + 1  # live tokens this round, and after it
CTL_N = 12
W_LIVE, W_KEEP = W_OWN, W_OWN + 1  # work: live and kept tokens of the applied rounds
TILE = 8192  # positions a block of the scans takes


class StreamState(TableState):
    """The kernel trainer's state on one device (see the module note)."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device):
        dev = torch.device(device)
        self.device = dev
        # copies: the kernels update the stream in place
        self.t = torch.from_numpy(np.array(t, np.int32)).to(dev)
        self.wid = torch.from_numpy(np.array(wid, np.int32)).to(dev)
        self.freq = torch.from_numpy(np.array(freq, np.int32)).to(dev)
        m = self.t.shape[0]
        self.tmp_t = torch.empty(m, dtype=torch.int32, device=dev)
        self.tmp_w = torch.empty(m, dtype=torch.int32, device=dev)
        self.tiles = torch.empty(2 * max(1, -(-m // TILE)), dtype=torch.int32, device=dev)
        self.control(rules, used, CTL_N)
        self.ctl[LIVE] = self.ctl[NEXT_LIVE] = int((self.t >= 0).sum())
        self.resize(cap)




# -- plain torch versions -----------------------------------------------------


def live_pairs(st: StreamState):
    """The keys and weights of the live stream's counted pairs."""
    n = int(st.ctl[LIVE])
    kx, ky, w = pair_keys_and_weights(st.t[:n], st.wid[:n], st.freq)
    on = w > 0
    return (kx[on].long() << 32) | ky[on].long(), w[on]


def recount_plain(st: StreamState, limit: int, vocab_size: int):
    st.ctl[LIVE] = st.ctl[NEXT_LIVE]
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
    n = int(st.ctl[LIVE])
    cx, cy, zs = st.cand[:n_acc, 0], st.cand[:n_acc, 1], st.cand[:n_acc, 2]
    acc = torch.ones(n_acc, dtype=torch.bool, device=st.device)
    t2, w2 = apply_accepted(st.t[:n], st.wid[:n], acc, cx, cy, zs)
    st.t[:n] = t2
    st.wid[:n] = w2
    keep = int((t2 >= 0).sum())
    st.ctl[NEXT_LIVE] = keep
    st.work[W_LIVE] += n
    st.work[W_KEEP] += keep


# -- wrappers -----------------------------------------------------------------


def recount(st: StreamState, limit: int, vocab_size: int):
    """Empty the table and count every pair of the live stream into it (a
    no-op once the round loop stopped); sets ``ctl[OVERFLOW]`` when the
    table holds more than half its slots."""
    if not _on(st, "recount"):
        return recount_plain(st, limit, vocab_size)
    lib = _cuda.load_stream_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_stream_recount(
            st.t.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.t.shape[0],
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            st.tiles.data_ptr(), int(limit), int(vocab_size), _stream_ptr(st.device),
        )
    _check(err, "recount")
    recount.launches += 1


def apply_compact(st: StreamState):
    """Merge the round's accepted candidates and compact the stream."""
    if not _on(st, "apply_compact"):
        return apply_compact_plain(st)
    lib = _cuda.load_stream_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_stream_apply(
            st.t.data_ptr(), st.wid.data_ptr(), st.t.shape[0], st.tmp_t.data_ptr(),
            st.tmp_w.data_ptr(), st.tiles.data_ptr(), st.ctl.data_ptr(), st.cand.data_ptr(),
            st.work.data_ptr(), _stream_ptr(st.device),
        )
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
                apply_compact(st)
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
