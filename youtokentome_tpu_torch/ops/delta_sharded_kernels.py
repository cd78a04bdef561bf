"""The sharded v2 trainer's round as kernels over N shards, and the loop
that drives them.

The JAX program ``youtokentome_tpu/parallel/train_delta_sharded.py:81
_train_delta_sharded`` runs the v2 round on every device of a data mesh
with the pair-count table replicated: the same top-k everywhere, each
shard's merge and its bounded old/new delta buffers, then one exchange
(``all_gather``) that every device folds into its table, or, when some
shard's buffer overflowed (``lax.pmax``), a recount exchange.  Here each
shard is a ``ShardState`` on its device (``parallel.mesh.DataMesh``): its
word-laid stream, as ``TrainState`` lays it out, with its replica of the
exact table, its ``ctl``, a ``[2*dcap]`` delta buffer and a scratch table.
A round, all in hand-written CUDA (``csrc/train_delta_sharded.cu``, and
``csrc/train_topk.cu``):

  topk_accept    on every replica (the shared top-k)
  delta_emit     on every shard: apply_delta's merge, with the listed words'
                 old and new contributions appended to the shard's buffer
                 (DOVF in ``ctl`` when a side passes dcap)
  shard_recount  on every shard: a no-op unless some shard's DOVF is set;
                 else the shard's stream counted into its scratch table
  shard_fold     on every replica: every shard's buffer added into the
                 table, or (some DOVF set) the table rebuilt from the N
                 scratch tables; the kernel picks the branch, so round
                 control stays on the card
  shard_relay    at the JAX host loop's re-pack trigger: the shard's stream
                 laid out again over its live tokens (words that can hold
                 no pair dropped)

The host reads shard 0's ``ctl`` once per batch of rounds, and checks
that every replica's round control and rules agree at each segment end
(after every round on the CPU).  Each wrapper launches its kernel on a
CUDA state (and counts the launch) and runs its plain torch version on a
CPU state; the plain versions compute the same function.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import _cuda
from .train_delta import _next_pow2
from .train_kernels import (
    BATCH,
    CTL_OWN,
    DONE,
    EMPTY,
    ERROR,
    NACC,
    OCC,
    OVERFLOW,
    USED,
    W_OWN,
    TrainState,
    _check,
    _counted_pairs,
    _on,
    _stream_ptr,
    _table_add,
    _table_update,
    initial_cap,
    merge_listed_plain,
    rules_used,
    topk_accept,
)
from .train_stream import PAD

# ctl: NAFF .. DOVF are zeroed by every round's top-k (n_own = 4); POCC is
# the partitioned fold's count of the replica's own part
NAFF, DN_OLD, DN_NEW, DOVF, NREC, LIVE, ROCC, ROVF, POCC = range(CTL_OWN, CTL_OWN + 9)
CTL_N = 16
# work: bytes each kernel must move, summed over the rounds, and the
# buffer entries written
W_EMIT, W_COUNT, W_FOLD, W_RELAY, W_ENTRIES = range(W_OWN, W_OWN + 5)


class Exchange:
    """What a shard's state adds to its trainer's state for the exchange:
    ``ctl`` of CTL_N slots (every replica's shard_fold reads DN_OLD ..
    DOVF and ROVF of every shard), the delta buffer ``dk``/``dv`` (old
    entries at ``[0, dcap)``, new at ``[dcap, 2*dcap)``; ``buffers``) and
    the scratch table ``rkeys``/``rcnts`` of the recount branch, as large
    as the replica.  Mixed in before the trainer's state class."""

    n_own = 4  # NAFF .. DOVF, zeroed by every round's top-k
    _links = None

    def control(self, rules, used: int, ctl_n: int = CTL_N):
        super().control(rules, used, max(ctl_n, CTL_N))

    def resize(self, cap: int):
        super().resize(cap)
        self.rkeys = torch.full((cap,), EMPTY, dtype=torch.int64, device=self.device)
        self.rcnts = torch.zeros(cap, dtype=torch.int32, device=self.device)

    def buffers(self, dcap: int):
        self.dcap = dcap
        self.dk = torch.full((2 * dcap,), EMPTY, dtype=torch.int64, device=self.device)
        self.dv = torch.zeros(2 * dcap, dtype=torch.int32, device=self.device)

    def buffer(self, side: int):
        """The entries of one side (0 old, 1 new) of the delta buffer."""
        n = min(int(self.ctl[DN_OLD + side]), self.dcap)
        o = side * self.dcap
        return self.dk[o : o + n], self.dv[o : o + n]


class ShardState(Exchange, TrainState):
    """One shard of the sharded v2 trainer on its device: the shard's
    stream and the replica of the table (``TrainState``), with the
    exchange's buffers (``Exchange``)."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, dcap: int, device):
        super().__init__(t, wid, freq, rules, used, cap, device)
        # delta_emit's list of the round's words with a hit
        self.aff = torch.zeros(max(self.n_words, 1), dtype=torch.int32, device=self.device)
        self.wid_dev = torch.from_numpy(self.wids).to(self.device)
        self.buffers(dcap)
        self.ctl[LIVE] = int((np.asarray(wid) >= 0).sum())

    def stream(self):
        live = self.tok >= 0
        return self.tok[live], self.wid_dev[self.pwid[live].long()]


def _any(shards, slot: int) -> bool:
    return any(int(s.ctl[slot]) for s in shards)


# -- plain torch versions -----------------------------------------------------


def delta_emit_plain(st: ShardState):
    if int(st.ctl[NACC]) == 0:
        return
    t, t2, aff, w = merge_listed_plain(st)
    dcap = st.dcap
    kept = 0
    for side, tok, sign in ((0, t, -1), (1, t2, 1)):
        keys, counted = _counted_pairs(tok)
        sel = counted & aff & (w > 0)
        n = int(sel.sum())
        k = min(n, dcap)
        st.ctl[DN_OLD + side] = n
        st.dk[side * dcap : side * dcap + k] = keys[sel][:k]
        st.dv[side * dcap : side * dcap + k] = (sign * w[sel][:k]).to(torch.int32)
        if n > dcap:
            st.ctl[DOVF] = 1
        kept += k
    st.ctl[LIVE] += int((t2 >= 0).sum() - (t >= 0).sum())
    st.work[W_EMIT] += 4 * st.tok.shape[0] + 8 * int(aff.sum()) + 12 * kept
    st.work[W_ENTRIES] += kept


def shard_recount_plain(st: ShardState, shards):
    if not _any(shards, DOVF):
        return
    st.rkeys.fill_(EMPTY)
    st.rcnts.zero_()
    st.ctl[ROCC] = 0
    st.ctl[ROVF] = 0
    st.work[W_COUNT] += 4 * st.tok.shape[0] + 8 * st.n_words
    keys, counted = _counted_pairs(st.tok)
    w = st.fw[st.pwid.clamp(min=0).long()]
    _table_add(st.rkeys, st.rcnts, st.ctl, keys[counted], w[counted], ROCC, ROVF)


def shard_fold_plain(st: ShardState, shards):
    dev = st.device
    if _any(shards, DOVF):
        st.keys.fill_(EMPTY)
        st.cnts.zero_()
        st.ctl[OCC] = 0
        st.ctl[NREC] += 1
        if _any(shards, ROVF):
            st.ctl[OVERFLOW] = 1
        rocc = 12 * int(st.ctl[ROCC])
        st.work[W_COUNT] += rocc
        st.work[W_FOLD] += rocc
        ks = torch.cat([s.rkeys.to(dev) for s in shards])
        cs = torch.cat([s.rcnts.to(dev) for s in shards])
        sel = (ks != EMPTY) & (cs > 0)
        _table_update(st, ks[sel], cs[sel])
        st.work[W_FOLD] += 12 * int(st.ctl[OCC])
        return
    parts = [s.buffer(side) for s in shards for side in (0, 1)]
    ks = torch.cat([k.to(dev) for k, _ in parts])
    vs = torch.cat([v.to(dev) for _, v in parts])
    st.work[W_FOLD] += 24 * ks.numel()
    _table_update(st, ks, vs)


def part_lo(p: int, cap: int, n: int) -> int:
    """The first slot of part ``p`` of a table of ``cap`` slots cut in ``n``."""
    return p * cap // n


def key_part(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The part of each key among ``n`` (csrc/shard_exchange.cuh key_part;
    every product stays below 2^63)."""
    m32 = 0xFFFFFFFF
    h = (((keys >> 32) * 0x9E3779B1) & m32) ^ (((keys & m32) * 0x85EBCA77) & m32)
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & m32
    return (h * n) >> 32


def _index(st, shards) -> int:
    return next(i for i, s in enumerate(shards) if s is st)


def shard_part_fold_plain(st: ShardState, shards):
    dev, n, cap = st.device, len(shards), st.cap
    r = _index(st, shards)
    lo, hi = part_lo(r, cap, n), part_lo(r + 1, cap, n)
    st.keys[lo:hi] = EMPTY
    st.cnts[lo:hi] = 0
    st.ctl[NREC] += 1
    if _any(shards, ROVF):
        st.ctl[OVERFLOW] = 1
    st.work[W_FOLD] += 12 * int(st.ctl[ROCC])
    ks = torch.cat([s.rkeys.to(dev) for s in shards])
    cs = torch.cat([s.rcnts.to(dev) for s in shards])
    sel = (ks != EMPTY) & (cs > 0)
    sel &= key_part(ks, n) == r
    uk, inv = torch.unique(ks[sel], return_inverse=True)
    uc = torch.zeros(uk.shape[0], dtype=torch.int64, device=dev).index_add_(0, inv, cs[sel].long())
    fit = min(hi - lo, uk.shape[0])
    st.keys[lo : lo + fit] = uk[:fit]
    st.cnts[lo : lo + fit] = uc[:fit].to(torch.int32)
    st.ctl[POCC] = uk.shape[0] if fit == uk.shape[0] else hi - lo + 1


def shard_gather_plain(st: ShardState, shards):
    dev, n, cap = st.device, len(shards), st.cap
    r = _index(st, shards)
    for p, o in enumerate(shards):
        if p != r:
            lo, hi = part_lo(p, cap, n), part_lo(p + 1, cap, n)
            st.keys[lo:hi] = o.keys[lo:hi].to(dev)
            st.cnts[lo:hi] = o.cnts[lo:hi].to(dev)
    pocc = [int(o.ctl[POCC]) for o in shards]
    full = any(c > part_lo(p + 1, cap, n) - part_lo(p, cap, n) for p, c in enumerate(pocc))
    occ = sum(pocc)
    st.ctl[OCC] = min(occ, cap)
    if full or 2 * occ > cap:
        st.ctl[OVERFLOW] = 1


def _relay_bytes(st: ShardState, mw: int, w: int) -> int:
    """The relay's bytes: the stream, offsets, weights and word ids read
    once, the new ones written once."""
    return 4 * st.tok.shape[0] + 12 * st.n_words + 8 * mw + 12 * w


def _relaid(st: ShardState, tok2, pwid2, off2, fw2, wid2):
    """Take the relaid stream (``mw2`` slots, ``w2`` words) into ``st``."""
    w2, mw2 = fw2.shape[0], int(off2[-1])
    st.work[W_RELAY] += _relay_bytes(st, mw2, w2)
    st.tok, st.pwid, st.off, st.fw, st.wid_dev = tok2, pwid2, off2, fw2, wid2
    st.n_words = w2
    st.ctl[LIVE] = mw2 - w2


def shard_relay_plain(st: ShardState):
    pw = st.pwid.long()
    live = st.tok >= 0
    dev = st.device
    n = torch.zeros(st.n_words, dtype=torch.int64, device=dev).index_add_(
        0, pw[live], torch.ones(int(live.sum()), dtype=torch.int64, device=dev)
    )
    keep = n >= 2
    lens = torch.where(keep, n + 1, torch.zeros_like(n))
    new_off = torch.cumsum(lens, 0) - lens
    new_idx = torch.cumsum(keep.long(), 0) - keep.long()
    mw2 = int(lens.sum())
    tok2 = torch.full((max(mw2, 2),), PAD, dtype=torch.int32, device=dev)
    pwid2 = torch.full((max(mw2, 2),), PAD, dtype=torch.int32, device=dev)
    # live tokens are front-packed in their words: a token's rank in its
    # word is its distance from the word's first slot
    move = live & keep[pw.clamp(min=0)]
    pos = torch.nonzero(move).flatten()
    wm = pw[pos]
    dst = new_off[wm] + (pos - st.off[wm].long())
    tok2[dst] = st.tok[pos]
    pwid2[dst] = new_idx[wm].to(torch.int32)
    off2 = torch.cat([new_off[keep], torch.tensor([mw2], device=dev)]).to(torch.int32)
    _relaid(st, tok2, pwid2, off2, st.fw[keep], st.wid_dev[keep])


# -- wrappers -----------------------------------------------------------------


def _links(st: ShardState, shards):
    """Device arrays (on ``st``'s device) of every shard's pointers: ctl,
    delta buffer keys and values, scratch keys and counts, replica keys and
    counts.  Rebuilt when a buffer moved (a resize)."""
    ptrs = [[s.ctl.data_ptr() for s in shards], [s.dk.data_ptr() for s in shards],
            [s.dv.data_ptr() for s in shards], [s.rkeys.data_ptr() for s in shards],
            [s.rcnts.data_ptr() for s in shards], [s.keys.data_ptr() for s in shards],
            [s.cnts.data_ptr() for s in shards]]
    if st._links is None or st._links[0] != ptrs:
        st._links = (ptrs, [torch.tensor(p, dtype=torch.int64, device=st.device) for p in ptrs])
    return st._links[1]


def delta_emit(st: ShardState):
    """Merge the round's accepted candidates into the shard's stream and
    append its listed words' old and new contributions to its buffer."""
    if st.n_words == 0:
        return
    if not _on(st, "delta_emit"):
        return delta_emit_plain(st)
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_delta_emit(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.tok.shape[0], st.off.data_ptr(),
            st.fw.data_ptr(), st.n_words, st.ctl.data_ptr(), st.cand.data_ptr(),
            st.aff.data_ptr(), st.wmark.data_ptr(), st.dk.data_ptr(), st.dv.data_ptr(), st.dcap,
            st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "delta_emit")
    delta_emit.launches += 1


def shard_recount(st: ShardState, shards):
    """Unless no shard's buffer overflowed: count the shard's stream into
    its scratch table (sets ``ctl[ROVF]`` when it fills more than half)."""
    if not _on(st, "shard_recount"):
        return shard_recount_plain(st, shards)
    ctls = _links(st, shards)[0]
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_recount(
            st.tok.data_ptr(), st.tok.shape[0], st.off.data_ptr(), st.fw.data_ptr(), st.n_words,
            st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            ctls.data_ptr(), len(shards), st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "shard_recount")
    shard_recount.launches += 1


def shard_fold(st: ShardState, shards):
    """Fold the round's exchange into the shard's replica: every shard's
    buffer entries, or, when some buffer overflowed, the table rebuilt from
    every shard's scratch table (its own copied, the others added)."""
    if not _on(st, "shard_fold"):
        return shard_fold_plain(st, shards)
    ctls, dks, dvs, rks, rcs = _links(st, shards)[:5]
    own = _index(st, shards)
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_fold(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), ctls.data_ptr(),
            dks.data_ptr(), dvs.data_ptr(), st.dcap, rks.data_ptr(), rcs.data_ptr(), len(shards),
            own, st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.work.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "shard_fold")
    shard_fold.launches += 1


def shard_part_fold(st: ShardState, shards):
    """The partitioned fold's first half (the engines that recount every
    round): empty the replica's own part and add every shard's scratch
    entries of that part into it."""
    if not _on(st, "shard_part_fold"):
        return shard_part_fold_plain(st, shards)
    ctls, _, _, rks, rcs = _links(st, shards)[:5]
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_part_fold(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), ctls.data_ptr(),
            rks.data_ptr(), rcs.data_ptr(), len(shards), _index(st, shards), st.work.data_ptr(),
            _stream_ptr(st.device),
        )
    _check(err, "shard_part_fold")
    shard_part_fold.launches += 1


def shard_gather(st: ShardState, shards):
    """The partitioned fold's second half, once every replica folded its
    part: copy every other replica's own part in; the occupancy and
    overflow from every part's count."""
    if not _on(st, "shard_gather"):
        return shard_gather_plain(st, shards)
    links = _links(st, shards)
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_gather(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            links[0].data_ptr(), links[5].data_ptr(), links[6].data_ptr(), len(shards),
            _index(st, shards), _stream_ptr(st.device),
        )
    _check(err, "shard_gather")
    shard_gather.launches += 1


def shard_relay(st: ShardState):
    """Lay the shard's stream out again over its live tokens: words with
    fewer than two live tokens go, every other word keeps live + 1 slots.
    Reads the new sizes back (the host is at a segment end)."""
    if st.n_words == 0:
        return
    if not _on(st, "shard_relay"):
        return shard_relay_plain(st)
    lib = _cuda.load_sharded()
    dev, w = st.device, st.n_words
    i32 = dict(dtype=torch.int32, device=dev)
    lens, keep, new_off, new_idx = (torch.empty(w, **i32) for _ in range(4))
    scratch = torch.empty(lib.yttm_shard_relay_scratch(w), **i32)
    totals = torch.zeros(2, **i32)
    stream = _stream_ptr(dev)
    with torch.cuda.device(dev):
        err = lib.yttm_shard_relay_plan(
            st.tok.data_ptr(), st.off.data_ptr(), w, lens.data_ptr(), keep.data_ptr(),
            new_off.data_ptr(), new_idx.data_ptr(), scratch.data_ptr(), totals.data_ptr(), stream,
        )
        _check(err, "shard_relay")
        mw2, w2 = totals.tolist()
        tok2 = torch.full((max(mw2, 2),), PAD, **i32)
        pwid2 = torch.full((max(mw2, 2),), PAD, **i32)
        off2 = torch.empty(w2 + 1, **i32)
        fw2 = torch.empty(w2, **i32)
        wid2 = torch.empty(w2, **i32)
        err = lib.yttm_shard_relay_write(
            st.tok.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.wid_dev.data_ptr(), w,
            lens.data_ptr(), new_off.data_ptr(), new_idx.data_ptr(), tok2.data_ptr(),
            pwid2.data_ptr(), off2.data_ptr(), fw2.data_ptr(), wid2.data_ptr(), w2, mw2, stream,
        )
    _check(err, "shard_relay")
    shard_relay.launches += 1
    _relaid(st, tok2, pwid2, off2, fw2, wid2)


# launches of the CUDA kernels through each wrapper (plain calls not counted)
delta_emit.launches = 0
shard_recount.launches = 0
shard_fold.launches = 0
shard_part_fold.launches = 0
shard_gather.launches = 0
shard_relay.launches = 0


# -- host loop ----------------------------------------------------------------


def _enable_peers(devices):
    """Shards on distinct cards read each other's buffers: each pair of
    cards needs peer access, or the mesh is refused."""
    cards = [d.index for d in devices if d.type == "cuda"]
    if len(cards) < 2:
        return
    lib = _cuda.load_sharded()
    for a in cards:
        for b in cards:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot read cuda:{b}'s memory (no peer access): the sharded "
                    "trainer's exchange needs it between every two cards of the mesh"
                )
            _check(lib.yttm_shard_enable_peer(a, b), "enable_peer")


class ShardEngine:
    """The host loop of a sharded kernel engine over ``shards``, one state a
    shard of the mesh, each with its replica of the table: rounds enqueued
    in batches with shard 0's ``ctl`` read once a batch, the replicas
    checked at each segment end (after every round on the CPU), and the
    exchange (``recount`` on every shard, then ``shard_fold`` on every
    replica; the engines that recount every round replace it).  A subclass
    calls ``_setup``, sets ``shards`` and defines ``recount(st, limit)``
    and ``round(limit)`` (and ``stream()`` for checkpoints)."""

    rebuilds = 0
    nrec = 0

    def _setup(self, mesh, vocab_size: int, used_ids0: int, batch_k: int):
        self.vocab_size = vocab_size
        self.used_ids0 = used_ids0
        self.batch_k = batch_k
        self._devices = mesh.distinct()
        _enable_peers(self._devices)

    @property
    def rules(self):
        return self.shards[0].rules

    def _barrier(self):
        """Order the next step after the last on every card (shards on
        distinct cards; one card's stream orders itself)."""
        if len(self._devices) < 2 or self._devices[0].type != "cuda":
            return
        events = []
        for dev in self._devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        for dev in self._devices:
            for ev in events:
                torch.cuda.current_stream(dev).wait_event(ev)

    def _exchange(self, limit: int):
        shards = self.shards
        for st in shards:
            self.recount(st, limit)
        self._barrier()
        for st in shards:
            shard_fold(st, shards)
        self._barrier()

    def _count(self):
        """Rebuild every replica from the streams (the recount branch,
        forced), doubling the tables until the count fits in half."""
        while True:
            for st in self.shards:
                st.ctl[DOVF] = 1
                st.ctl[OVERFLOW] = 0
            self._exchange(self.vocab_size)
            overflow = int(self.shards[0].ctl[OVERFLOW])
            for st in self.shards:
                st.ctl[DOVF] = 0
                st.ctl[NREC] = 0
            if not overflow:
                return
            for st in self.shards:
                st.resize(st.cap * 2)

    def check_replicas(self):
        """Every replica holds the same round control and rules."""
        head = self.shards[0]
        for st in self.shards[1:]:
            same = torch.equal(st.ctl[:CTL_OWN].to(head.device), head.ctl[:CTL_OWN]) and int(
                st.ctl[NREC]
            ) == int(head.ctl[NREC]) and torch.equal(st.rules.to(head.device), head.rules)
            if not same:
                raise RuntimeError("the sharded trainer's replicas disagree")

    def segment(self, used: int, limit: int):
        shards = self.shards
        head = shards[0]
        for st in shards:
            st.ctl[NREC] = 0
        on_card = head.device.type == "cuda"
        while True:
            # each active round accepts at most batch_k ids, so this many
            # rounds never run past the segment's end
            n = min(BATCH, max(1, math.ceil((limit - used) / self.batch_k))) if on_card else 1
            for _ in range(n):
                self.round(limit)
                if not on_card:
                    self.check_replicas()
            used, done, overflow, error = (
                int(v) for v in head.ctl[[USED, DONE, OVERFLOW, ERROR]].tolist()
            )
            if error:
                raise RuntimeError("training table lost a pair: subtracted a missing key")
            if done or overflow or used >= min(limit, self.vocab_size):
                self.check_replicas()
                self.nrec = int(head.ctl[NREC])
                if not overflow:
                    self._segment_end()
                return used, bool(done), bool(overflow)

    def _segment_end(self):
        """What the engine does at the end of a segment without overflow."""

    def regrow(self):
        """After an overflow: rebuild every replica from the streams, at
        twice the size when the live pairs fill more than a quarter of it."""
        self.rebuilds += 1
        cap = self.shards[0].cap
        n_live = int((self.shards[0].cnts > 0).sum())
        for st in self.shards:
            st.resize(cap * 2 if 4 * n_live > cap else cap)
        self._count()

    def detail(self) -> str:
        """The JAX host loop's progress fields; its pcap is half the table."""
        n = len(self.shards)
        return (
            f"; {self.nrec} recount rounds this segment, exchange "
            f"{n}x{2 * self.dcap} delta / {n}x{self.shards[0].cap // 2} recount keys"
        )


class ShardedKernelEngine(ShardEngine):
    """Segments of rounds through the kernels over the mesh's shards, for
    ``parallel.train_delta_sharded.run_training_delta_sharded``.  Every
    replica starts at ``initial_cap`` slots of the whole stream's ``m``
    and is rebuilt when an insert finds it more than half full; ``per`` is
    the JAX host loop's padded shard length, which sets the re-pack trigger."""

    relays = 0

    def __init__(self, seg_t, seg_w, per: int, freq, rules, used_ids0: int, vocab_size: int,
                 batch_k: int, mesh, dcap: int, m: int):
        self._setup(mesh, vocab_size, used_ids0, batch_k)
        self.dcap = dcap
        self.per = per
        self.repack = os.environ.get("YTTM_TRAIN_REPACK", "1") != "0"
        self.repack_min = int(os.environ.get("YTTM_TRAIN_REPACK_MIN", str(1 << 14)))
        used = rules_used(rules, used_ids0)
        cap = initial_cap(m)
        self.shards = [
            ShardState(seg_t[d], seg_w[d], freq, rules, used, cap, dcap, dev)
            for d, dev in enumerate(mesh.devices)
        ]
        self.dropped = [0] * len(self.shards)  # live tokens the relays dropped
        self._count()

    def recount(self, st, limit: int):
        shard_recount(st, self.shards)

    def round(self, limit: int):
        for st in self.shards:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        for st in self.shards:
            delta_emit(st)
        self._barrier()
        self._exchange(limit)

    def _segment_end(self):
        """At the JAX host loop's re-pack trigger (the largest shard's live
        tokens, relaid words' included, halved past ``per``): relay every
        shard."""
        if not self.repack:
            return
        live = [int(st.ctl[LIVE]) for st in self.shards]
        md = _next_pow2(max(max(n + d for n, d in zip(live, self.dropped)), self.repack_min))
        if md >= self.per:
            return
        for i, st in enumerate(self.shards):
            shard_relay(st)
            self.dropped[i] += live[i] - int(st.ctl[LIVE])
        self.per = md
        self.relays += 1

    def stream(self):
        parts = [st.stream() for st in self.shards]
        t = torch.cat([p[0].cpu() for p in parts])
        wid = torch.cat([p[1].cpu() for p in parts])
        return t, wid, self.shards[0].freq
