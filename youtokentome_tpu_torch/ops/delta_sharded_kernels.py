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
  delta_emit     one launch for every shard of a card: apply_delta's merge,
                 with the claimed words' old and new contributions appended
                 to their shard's buffer (DOVF in ``ctl`` when a side passes
                 dcap)
  shard_recount  on every shard, only when some shard's DOVF is set: the
                 shard's stream counted into its scratch table
  shard_fold     one launch for every replica of a card: every shard's
                 buffer added into each replica (the delta entry), or, when
                 some DOVF is set, each replica rebuilt from the N scratch
                 tables (the rebuild entry)
  shard_relay    at the JAX host loop's re-pack trigger: the shard's stream
                 laid out again over its live tokens (words that can hold
                 no pair dropped)

Two routes drive a round, chosen by the engine and the mesh, never one for
the other's failure.  On a mesh whose shards share one card,
``ShardedKernelEngine`` (and the sharded v3 engine,
``sparse_sharded_kernels``) replays the round graph (``shard_rounds``,
``csrc/round_graph.cuh``): every shard's top-k and shard-local half, then a
gate kernel that picks the branch on the card, the recount and the rebuild
under one IF node, the delta fold under another; the host issues one call
a batch of rounds.  Everywhere else the per-call wrappers run each round
from the host: across processes (``ProcessShardedEngine``, for
``parallel.distributed``: every other process's shard is a ``MirrorShard``
that the exchange fills through the host each round, and the host, which
reads every ctl, launches only the branch's kernels), for shards on
distinct cards (the recount and both fold entries each round, each deciding
on the card), for the checks (``graph = False``) and on the CPU.  The host
reads shard 0's ``ctl`` once per batch of rounds, and checks that every
replica's round control and rules agree at each segment end (after every
round on the CPU).  Each wrapper launches its kernel on a CUDA state (and
counts the launch) and runs its plain torch version on a
CPU state; the plain versions compute the same function.
"""

from __future__ import annotations

import ctypes
import math
import os
import sys
import time

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
    K_MAX,
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
    _reps = None
    _emit = None

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

    def emit_row(self) -> list:
        """The shard's row of its card's emit (``csrc/shard_exchange.cuh``
        EmitShard): its stream, the word of each position and the stream's
        end (``emit_stream``), then offsets, weights, word count, ctl,
        candidates, claim marks, buffer and work."""
        stream, words, end = self.emit_stream()
        return [stream.data_ptr(), words.data_ptr(), end, self.off.data_ptr(),
                self.fw.data_ptr(), self.n_words, self.ctl.data_ptr(), self.cand.data_ptr(),
                self.wmark.data_ptr(), self.dk.data_ptr(), self.dv.data_ptr(),
                self.work.data_ptr()]


class ShardState(Exchange, TrainState):
    """One shard of the sharded v2 trainer on its device: the shard's
    stream and the replica of the table (``TrainState``), with the
    exchange's buffers (``Exchange``)."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, dcap: int, device):
        super().__init__(t, wid, freq, rules, used, cap, device)
        self.wid_dev = torch.from_numpy(self.wids).to(self.device)
        self.buffers(dcap)
        self.ctl[LIVE] = int((np.asarray(wid) >= 0).sum())

    def stream(self):
        live = self.tok >= 0
        return self.tok[live], self.wid_dev[self.pwid[live].long()]

    def emit_stream(self):
        return self.tok, self.pwid, self.tok.shape[0]


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
    w = st.fw[st.pwid[counted].long()]
    _table_add(st.rkeys, st.rcnts, st.ctl, keys[counted], w, ROCC, ROVF)


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


def fold_delta_plain(reps, shards):
    """The fold's delta entry (``shard_fold`` on ``reps``, replicas of one
    device), plain: unless some shard's DOVF is set, every shard's written
    entries, each side's first min(DN, dcap) in shard order, added into
    each replica."""
    if _any(shards, DOVF):
        return
    parts = [s.buffer(side) for s in shards for side in (0, 1)]
    for st in reps:
        ks = torch.cat([k.to(st.device) for k, _ in parts])
        vs = torch.cat([v.to(st.device) for _, v in parts])
        st.work[W_FOLD] += 24 * ks.numel()
        _table_update(st, ks, vs)


def fold_rebuild_plain(reps, shards):
    """The fold's rebuild entry, plain: only when some shard's DOVF is set,
    each replica takes its own shard's scratch table as it lies (OCC its
    ROCC), then every other shard's live scratch entries; NREC counts the
    rebuild, and some shard's ROVF sets OVERFLOW."""
    if not _any(shards, DOVF):
        return
    rovf = _any(shards, ROVF)
    for st in reps:
        st.keys.copy_(st.rkeys)
        st.cnts.copy_(st.rcnts)
        rocc = int(st.ctl[ROCC])
        st.ctl[OCC] = rocc
        st.ctl[NREC] += 1
        if rovf:
            st.ctl[OVERFLOW] = 1
        st.work[W_COUNT] += 12 * rocc
        st.work[W_FOLD] += 12 * rocc
        others = [s for s in shards if s is not st]
        if others:
            ks = torch.cat([s.rkeys.to(st.device) for s in others])
            cs = torch.cat([s.rcnts.to(st.device) for s in others])
            sel = (ks != EMPTY) & (cs > 0)
            _table_update(st, ks[sel], cs[sel])
        st.work[W_FOLD] += 12 * int(st.ctl[OCC])


def part_lo(p: int, cap: int, n: int) -> int:
    """The first slot of part ``p`` of a table of ``cap`` slots cut in ``n``
    (csrc/part_list.cuh)."""
    return p * cap // n


def key_part(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The part of each key among ``n`` (csrc/part_list.cuh key_part; every
    product stays below 2^63)."""
    m32 = 0xFFFFFFFF
    h = (((keys >> 32) * 0x9E3779B1) & m32) ^ (((keys & m32) * 0x85EBCA77) & m32)
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & m32
    return (h * n) >> 32


def _index(st, shards) -> int:
    return next(i for i, s in enumerate(shards) if s is st)


def _check_parts(shards):
    """Every shard's scratch table lists its claims among len(shards) parts
    (the fold reads pcnt[r] and part r's list of each)."""
    if any(s.n_parts != len(shards) for s in shards):
        raise ValueError(f"shard_part_fold: part lists of {[s.n_parts for s in shards]} parts "
                         f"on a mesh of {len(shards)} shards")


def shard_part_fold_plain(st: ShardState, shards):
    """Replica ``st``'s part r emptied and rebuilt from the entries of every
    shard's part-r list (``recount_sharded_kernels.RecountShard``): no other
    scratch slot is read; a list that dropped claims marks the part full
    (POCC past its size) and nothing is added."""
    _check_parts(shards)
    dev, n, cap = st.device, len(shards), st.cap
    r = _index(st, shards)
    lo, hi = part_lo(r, cap, n), part_lo(r + 1, cap, n)
    st.keys[lo:hi] = EMPTY
    st.cnts[lo:hi] = 0
    st.ctl[NREC] += 1
    if _any(shards, ROVF):
        st.ctl[OVERFLOW] = 1
    st.work[W_FOLD] += 12 * int(st.ctl[ROCC])
    words = fill_words(cap, n)
    bits = st.fill[int(st.fill[2 * words]) * words :][:words]
    bits.zero_()
    if any(int(s.pcnt[r]) > hi - lo for s in shards):
        st.ctl[POCC] = hi - lo + 1
        return
    slots = [s.part_list(r) for s in shards]
    ks = torch.cat([s.rkeys[i].to(dev) for s, i in zip(shards, slots)])
    cs = torch.cat([s.rcnts[i].to(dev) for s, i in zip(shards, slots)])
    sel = cs > 0
    uk, inv = torch.unique(ks[sel], return_inverse=True)
    uc = torch.zeros(uk.shape[0], dtype=torch.int64, device=dev).index_add_(0, inv, cs[sel].long())
    fit = min(hi - lo, uk.shape[0])
    st.keys[lo : lo + fit] = uk[:fit]
    st.cnts[lo : lo + fit] = uc[:fit].to(torch.int32)
    st.ctl[POCC] = uk.shape[0] if fit == uk.shape[0] else hi - lo + 1
    set_bits(bits, torch.arange(fit, device=dev))


def fill_words(cap: int, n: int) -> int:
    """The int32 words of each of a replica's two fill lists, bitmaps of its
    largest part's slots (csrc/train_delta_sharded.cu fill_words); the word
    after both picks the one the next fold fills."""
    return (-(-cap // n) + 31) // 32


def set_bits(bits: torch.Tensor, i: torch.Tensor):
    """Set bits ``i`` (distinct) of the int32 bitmap ``bits``."""
    words = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    words.index_add_(0, i // 32, torch.ones_like(i) << (i % 32))
    bits |= torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def bit_slots(bits: torch.Tensor) -> torch.Tensor:
    """The set bits of the int32 bitmap ``bits``, in order (int64)."""
    b = bits.long() & 0xFFFFFFFF
    on = ((b[:, None] >> torch.arange(32, device=bits.device)) & 1).bool()
    return torch.nonzero(on.flatten()).flatten()


def shard_gather_plain(st: ShardState, shards):
    """Replica ``st`` takes every other replica p's own part at the slots
    that p's two fill lists name (this round's claims, and the last round's,
    which p's refold may have left empty): the only slots where p's part
    changed since the last gather; then turns its own fill lists."""
    dev, n, cap = st.device, len(shards), st.cap
    r = _index(st, shards)
    words = fill_words(cap, n)
    for p, o in enumerate(shards):
        if p != r:
            slots = bit_slots(o.fill[:words] | o.fill[words : 2 * words]) + part_lo(p, cap, n)
            st.keys[slots.to(dev)] = o.keys[slots].to(dev)
            st.cnts[slots.to(dev)] = o.cnts[slots].to(dev)
    st.fill[2 * words] ^= 1
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
    counts, and (the shards that recount every round) the scratch table's
    part lists and their counts.  Rebuilt when a buffer moved (a resize)."""
    ptrs = [[s.ctl.data_ptr() for s in shards], [s.dk.data_ptr() for s in shards],
            [s.dv.data_ptr() for s in shards], [s.rkeys.data_ptr() for s in shards],
            [s.rcnts.data_ptr() for s in shards], [s.keys.data_ptr() for s in shards],
            [s.cnts.data_ptr() for s in shards]]
    if hasattr(st, "plist"):
        ptrs += [[s.plist.data_ptr() for s in shards], [s.pcnt.data_ptr() for s in shards],
                 [s.fill.data_ptr() for s in shards]]
    if st._links is None or st._links[0] != ptrs:
        st._links = (ptrs, [torch.tensor(p, dtype=torch.int64, device=st.device) for p in ptrs])
    return st._links[1]


def _emit_rows(states, name: str):
    """A device array (on ``states[0]``'s device) of the shards of one
    card, a row each (``emit_row``) for the emit ``name``.  Rebuilt when a
    buffer moved or a size changed (a relay, a resize)."""
    head = states[0]
    rows = [st.emit_row() for st in states]
    for st, row in zip(states, rows):
        if st.device != head.device or st.dcap != head.dcap:
            raise ValueError(f"{name} takes the shards of one device, with one dcap")
        if row[0] % 16:
            raise ValueError(f"{name} needs a 16-byte aligned stream")
    if head._emit is None or head._emit[0] != rows:
        head._emit = (rows, torch.tensor(rows, dtype=torch.int64, device=head.device))
    return head._emit[1]


def delta_emit(states):
    """Merge the round's accepted candidates into the streams of
    ``states`` (the shards of one device, which took the same candidates)
    and append each one's claimed words' old and new contributions to its
    buffer: one launch for all of them; a shard without words is skipped."""
    if not any(st.n_words for st in states):
        return
    if not _on(states[0], "delta_emit"):
        for st in states:
            if st.n_words:
                delta_emit_plain(st)
        return
    rows = _emit_rows(states, "delta_emit")
    lib = _cuda.load_sharded()
    with torch.cuda.device(states[0].device):
        err = lib.yttm_shard_delta_emit_card(rows.data_ptr(), len(states), states[0].dcap,
                                             _stream_ptr(states[0].device))
    _check(err, "delta_emit")
    delta_emit.launches += 1


def _replicas(reps, shards):
    """A device array (on ``reps[0]``'s device) of the fold's replicas, a
    row each as ``csrc/train_delta_sharded.cu`` Replica lays it out: keys,
    counts, ctl, work, its shard's scratch keys and counts, its shard's
    index.  Rebuilt when a buffer moved."""
    head = reps[0]
    rows = [[st.keys.data_ptr(), st.cnts.data_ptr(), st.ctl.data_ptr(), st.work.data_ptr(),
             st.rkeys.data_ptr(), st.rcnts.data_ptr(), _index(st, shards)] for st in reps]
    if head._reps is None or head._reps[0] != rows:
        head._reps = (rows, torch.tensor(rows, dtype=torch.int64, device=head.device))
    return head._reps[1]


def shard_recount(st: ShardState, shards):
    """Unless no shard's buffer overflowed: count the shard's stream into
    its scratch table (sets ``ctl[ROVF]`` when it fills more than half)."""
    if not _on(st, "shard_recount"):
        return shard_recount_plain(st, shards)
    ctls = _links(st, shards)[0]
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_recount(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.fw.data_ptr(), st.tok.shape[0],
            st.n_words, st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            ctls.data_ptr(), len(shards), st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "shard_recount")
    shard_recount.launches += 1


def shard_fold(reps, shards, rebuild=None):
    """Fold the round's exchange into the replicas ``reps`` (states of one
    device), one launch an entry for all of them: the delta entry adds
    every shard's buffer entries; the rebuild entry, when some buffer
    overflowed, rebuilds each replica from every shard's scratch table (its
    own copied, the others added).  ``rebuild`` True or False launches that
    entry alone (the host knows the branch); None launches both, each a
    no-op unless its branch is the round's (decided on the card)."""
    if not _on(reps[0], "shard_fold"):
        if rebuild is not True:
            fold_delta_plain(reps, shards)
        if rebuild is not False:
            fold_rebuild_plain(reps, shards)
        return
    head = reps[0]
    ctls, dks, dvs, rks, rcs = _links(head, shards)[:5]
    rows = _replicas(reps, shards)
    lib = _cuda.load_sharded()
    with torch.cuda.device(head.device):
        stream = _stream_ptr(head.device)
        if rebuild is not True:
            _check(lib.yttm_shard_fold_delta(
                rows.data_ptr(), len(reps), head.cap, ctls.data_ptr(), dks.data_ptr(),
                dvs.data_ptr(), head.dcap, len(shards), stream,
            ), "shard_fold")
            shard_fold.launches += 1
        if rebuild is not False:
            _check(lib.yttm_shard_fold_rebuild(
                rows.data_ptr(), len(reps), head.cap, ctls.data_ptr(), rks.data_ptr(),
                rcs.data_ptr(), len(shards), None, stream,
            ), "shard_fold")
            shard_fold.launches += 1


def shard_part_fold(st: ShardState, shards):
    """The partitioned fold's first half (the engines that recount every
    round): empty the replica's own part and add the entries of every
    shard's list of that part into it, each claimed slot set in the
    replica's fill list of the round."""
    if not _on(st, "shard_part_fold"):
        return shard_part_fold_plain(st, shards)
    _check_parts(shards)
    links = _links(st, shards)
    lib = _cuda.load_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_shard_part_fold(
            st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            links[0].data_ptr(), links[3].data_ptr(), links[4].data_ptr(), links[7].data_ptr(),
            links[8].data_ptr(), len(shards), _index(st, shards), st.fill.data_ptr(),
            st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "shard_part_fold")
    shard_part_fold.launches += 1


def shard_gather(reps, shards):
    """The partitioned fold's second half, once every replica folded its
    part, on the replicas ``reps`` (states of one device), one launch: each
    copies every other replica's own part in at the slots that replica's
    two fill lists name, then turns its own lists; the occupancy and
    overflow from every part's count."""
    if not _on(reps[0], "shard_gather"):
        for st in reps:
            shard_gather_plain(st, shards)
        return
    head = reps[0]
    links = _links(head, shards)
    rows = _replicas(reps, shards)
    lib = _cuda.load_sharded()
    with torch.cuda.device(head.device):
        err = lib.yttm_shard_gather(
            rows.data_ptr(), len(reps), head.cap, links[0].data_ptr(), links[5].data_ptr(),
            links[6].data_ptr(), links[9].data_ptr(), len(shards), _stream_ptr(head.device),
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
    mw = st.tok.shape[0]
    with torch.cuda.device(dev):
        err = lib.yttm_shard_relay_plan(
            st.tok.data_ptr(), st.pwid.data_ptr(), st.off.data_ptr(), mw, w, lens.data_ptr(),
            keep.data_ptr(), new_off.data_ptr(), new_idx.data_ptr(), scratch.data_ptr(),
            totals.data_ptr(), stream,
        )
        _check(err, "shard_relay")
        mw2, w2 = totals.tolist()
        # the scatter writes every slot, and PAD in the slots past mw2 that
        # the least stream of 2 slots adds
        n2 = max(mw2, 2)
        tok2 = torch.empty(n2, **i32)
        pwid2 = torch.empty(n2, **i32)
        off2 = torch.empty(w2 + 1, **i32)
        fw2 = torch.empty(w2, **i32)
        wid2 = torch.empty(w2, **i32)
        err = lib.yttm_shard_relay_write(
            st.tok.data_ptr(), st.pwid.data_ptr(), mw, st.off.data_ptr(), st.fw.data_ptr(),
            st.wid_dev.data_ptr(), w, lens.data_ptr(), new_off.data_ptr(), new_idx.data_ptr(),
            tok2.data_ptr(), pwid2.data_ptr(), off2.data_ptr(), fw2.data_ptr(), wid2.data_ptr(),
            w2, mw2, n2, stream,
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


# -- the round graph ------------------------------------------------------------


def _graph_row(st: ShardState) -> list:
    """A shard's buffers and sizes for the round graph, in the order of
    ``csrc/round_graph.cuh`` GraphShard."""
    return [st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.blk_hi.data_ptr(),
            st.blk_lo.data_ptr(), st.n_blk, st.ticket.data_ptr(), st.ctl.data_ptr(),
            st.cand.data_ptr(), st.rules.data_ptr(), st.work.data_ptr(), st.tok.data_ptr(),
            st.pwid.data_ptr(), st.tok.shape[0], st.off.data_ptr(), st.fw.data_ptr(),
            st.n_words, st.rkeys.data_ptr(), st.rcnts.data_ptr()]


def _address(fn) -> int:
    """The address of a ctypes function of a loaded library."""
    return ctypes.cast(fn, ctypes.c_void_p).value


class _ShardGraph:
    """An instantiated round graph, its launch entry, the key it was built
    over and the device arrays it reads; freed by its free entry."""

    def __init__(self, launch, free, handle: int, key: tuple, arrays):
        self.launch, self.free, self.handle = launch, free, handle
        self.key, self.arrays = key, arrays

    def __del__(self):
        self.free(self.handle)


def shard_rounds(eng, n: int, limit: int):
    """n rounds of ``eng`` (a sharded kernel engine whose shards share one
    card) as n replays of its round graph, in one call: every shard's top-k
    and shard-local half, then the gate and the branch it picks on the card.
    The graph (``eng.graph_entry``: its library's loader and build entry,
    whose ``_launch`` and ``_free`` entries go with it) is built anew when a
    shard's buffer or size, or the limit, changed.  Counts n launches of the
    top-k a shard and of the fold, and the engine counts its shard-local
    wrapper's (``graph_launched``); the recount branch counts its runs on the
    card (``count_graph_runs``)."""
    if not 0 < eng.batch_k <= K_MAX:
        raise ValueError(f"batch_k must be in 1..{K_MAX}, got {eng.batch_k}")
    shards = eng.shards
    head = shards[0]
    links = _links(head, shards)[:5]
    reps = _replicas(shards, shards)
    rows = np.array([eng.graph_row(st) for st in shards], dtype=np.int64)
    extra = eng.graph_addresses()
    key = (rows.tobytes(), int(limit), tuple(a.data_ptr() for a in links), reps.data_ptr(),
           tuple(extra))
    g = eng.round_graph
    if g is None or g.key != key:
        t0 = time.perf_counter()
        eng.round_graph = None  # one instantiation of a graph at a time
        load, name = eng.graph_entry
        lib = load()
        topk = _address(_cuda.load_topk().yttm_topk_accept)
        handle = ctypes.c_void_p()
        with torch.cuda.device(head.device):
            err = getattr(lib, name)(
                ctypes.byref(handle), rows.ctypes.data, len(shards), reps.data_ptr(),
                *(a.data_ptr() for a in links), head.dcap, topk, *extra,
                int(limit), eng.vocab_size, eng.used_ids0, eng.batch_k, head.n_own,
                eng.runs.data_ptr(),
            )
        _check(err, "shard_rounds graph")
        eng.round_graph = g = _ShardGraph(getattr(lib, name + "_launch"),
                                          getattr(lib, name + "_free"), handle.value, key,
                                          (links, reps))
        eng.graph_builds += 1
        eng.graph_build_s += time.perf_counter() - t0
    with torch.cuda.device(head.device):
        err = g.launch(g.handle, int(n), _stream_ptr(head.device))
    _check(err, "shard_rounds")
    topk_accept.launches += n * len(shards)
    eng.graph_launched(n)
    shard_fold.launches += n
    eng.replays += n


def count_graph_runs(eng) -> int:
    """Read the round graph's counters (a read of the card: call it where
    the host waits anyway): the recount branch's runs since the last call
    are handed to ``eng.graph_recounted`` (a launch of the recount a shard)
    and returned; ``eng.gate_runs`` takes the gate's runs (the replays)."""
    gate, rec = eng.runs.tolist()
    new = rec - eng.rec_runs
    eng.graph_recounted(new)
    eng.gate_runs, eng.rec_runs = gate, rec
    return new


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
    exchange (``recount`` on every shard, then ``shard_fold`` on the
    replicas of each card; the engines that recount every round replace
    it).  A subclass calls ``_setup``, sets ``shards`` and defines
    ``recount(st, limit)`` and ``round(limit)`` (and ``stream()`` for
    checkpoints).  An engine that takes the round graph's route calls
    ``_graph_setup`` and defines ``graph_entry``, ``graph_row(st)`` (a
    shard's GraphShard row), ``graph_launched(n)`` and
    ``graph_recounted(runs)`` (its wrappers' launches in n replays and in
    the recount branch's runs)."""

    rebuilds = 0
    nrec = 0
    count_exchanges = 0  # forced recounts (the first count, and after each overflow)
    # the round graph's route (``_graph_setup``): its C build entry (the
    # loader of its library, its name), and what its runs count
    graph = False
    graph_entry = None
    round_graph = None
    replays = 0  # round graph replays issued
    graph_builds = 0
    graph_build_s = 0.0  # the builds' host seconds (capture and instantiation)
    gate_runs = 0  # the graph's gate runs, counted on the card
    rec_runs = 0  # its recount branch's runs, counted on the card
    seg_rec_runs = 0  # those of the last segment, which NREC counts too

    def _setup(self, mesh, vocab_size: int, used_ids0: int, batch_k: int):
        self.vocab_size = vocab_size
        self.used_ids0 = used_ids0
        self.batch_k = batch_k
        self._devices = mesh.distinct()
        _enable_peers(self._devices)

    def _graph_setup(self):
        """Take the round graph's route when every shard is on one card
        (``graph``; set it False for the per-call route)."""
        self.graph = len(self._devices) == 1 and self._devices[0].type == "cuda"
        self.round_graph = None
        self.runs = torch.zeros(2, dtype=torch.int64, device=self.head.device)

    def graph_addresses(self) -> list:
        """The entry addresses that the graph's build entry takes after the
        top-k's."""
        return []

    @property
    def local(self):
        """The shards whose states this process holds: every shard of the
        mesh, unless it spans processes (``ProcessShardedEngine``)."""
        return self.shards

    @property
    def head(self):
        return self.local[0]

    @property
    def rules(self):
        return self.head.rules

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

    def _exchange(self, limit: int, recount=None):
        """The round's exchange: ``recount`` None lets the card pick the
        branch (every shard's recount, then both fold entries, each a no-op
        unless its branch is the round's); True or False, where the host
        knows the branch, launches only its kernels."""
        if recount is not False:
            for st in self.local:
                self.recount(st, limit)
            self._barrier()
        self._fold(recount)
        self._barrier()

    def _fold(self, rebuild):
        """``shard_fold`` on the local replicas, one call a card."""
        for dev in self._devices:
            reps = [st for st in self.local if st.device == dev]
            if reps:
                shard_fold(reps, self.shards, rebuild)

    def _count(self):
        """Rebuild every replica from the streams (the recount branch,
        forced), doubling the tables until the count fits in half."""
        while True:
            for st in self.local:
                st.ctl[DOVF] = 1
                st.ctl[OVERFLOW] = 0
            self._exchange(self.vocab_size, recount=True)
            self.count_exchanges += 1
            overflow = int(self.head.ctl[OVERFLOW])
            for st in self.local:
                st.ctl[DOVF] = 0
                st.ctl[NREC] = 0
            if not overflow:
                return
            for st in self.shards:
                st.resize(st.cap * 2)

    def check_replicas(self):
        """Every replica holds the same round control and rules."""
        head = self.head
        for st in self.local[1:]:
            same = torch.equal(st.ctl[:CTL_OWN].to(head.device), head.ctl[:CTL_OWN]) and int(
                st.ctl[NREC]
            ) == int(head.ctl[NREC]) and torch.equal(st.rules.to(head.device), head.rules)
            if not same:
                raise RuntimeError("the sharded trainer's replicas disagree")

    def run_rounds(self, n: int, limit: int):
        """n rounds through the round graph (``graph``), or up to n through
        the per-call wrappers: fewer when a round knows it accepted nothing
        (returns False); on the CPU the replicas are checked after every
        round."""
        if self.graph:
            return shard_rounds(self, n, limit)
        on_card = self.head.device.type == "cuda"
        for _ in range(n):
            ended = self.round(limit) is False
            if not on_card:
                self.check_replicas()
            if ended:
                return

    def segment(self, used: int, limit: int):
        head = self.head
        for st in self.local:
            st.ctl[NREC] = 0
        on_card = head.device.type == "cuda"
        while True:
            # each active round accepts at most batch_k ids, so this many
            # rounds never run past the segment's end
            n = min(BATCH, max(1, math.ceil((limit - used) / self.batch_k))) if on_card else 1
            self.run_rounds(n, limit)
            used, done, overflow, error = (
                int(v) for v in head.ctl[[USED, DONE, OVERFLOW, ERROR]].tolist()
            )
            if error:
                raise RuntimeError("training table lost a pair: subtracted a missing key")
            if done or overflow or used >= min(limit, self.vocab_size):
                self.check_replicas()
                self.nrec = int(head.ctl[NREC])
                if self.graph:
                    self.seg_rec_runs = count_graph_runs(self)
                if not overflow:
                    self._segment_end()
                return used, bool(done), bool(overflow)

    def _segment_end(self):
        """What the engine does at the end of a segment without overflow."""

    def regrow(self):
        """After an overflow: rebuild every replica from the streams, at
        twice the size when the live pairs fill more than a quarter of it."""
        self.rebuilds += 1
        cap = self.head.cap
        n_live = int((self.head.cnts > 0).sum())
        for st in self.shards:
            st.resize(cap * 2 if 4 * n_live > cap else cap)
        self._count()

    def detail(self) -> str:
        """The JAX host loop's progress fields; its pcap is half the table."""
        n = len(self.shards)
        return (
            f"; {self.nrec} recount rounds this segment, exchange "
            f"{n}x{2 * self.dcap} delta / {n}x{self.head.cap // 2} recount keys"
        )


class ShardedKernelEngine(ShardEngine):
    """Segments of rounds through the kernels over the mesh's shards, for
    ``parallel.train_delta_sharded.run_training_delta_sharded``.  Every
    replica starts at ``initial_cap`` slots of the whole stream's ``m``
    and is rebuilt when an insert finds it more than half full; ``per`` is
    the JAX host loop's padded shard length, which sets the re-pack trigger.
    ``graph`` picks the route of a batch of rounds: True (the default when
    every shard is on one card) replays the round graph (``shard_rounds``),
    False runs ``round`` through the per-call wrappers (shards on distinct
    cards, the CPU, and checks that set it)."""

    relays = 0
    graph_entry = (_cuda.load_sharded, "yttm_shard_graph")

    def __init__(self, seg_t, seg_w, per: int, freq, rules, used_ids0: int, vocab_size: int,
                 batch_k: int, mesh, dcap: int, m: int):
        self._setup(mesh, vocab_size, used_ids0, batch_k)
        self.dcap = dcap
        self.per = per
        self.repack = os.environ.get("YTTM_TRAIN_REPACK", "1") != "0"
        self.repack_min = int(os.environ.get("YTTM_TRAIN_REPACK_MIN", str(1 << 14)))
        used = rules_used(rules, used_ids0)
        cap = initial_cap(m)
        self.shards = self._place([
            ShardState(seg_t[d], seg_w[d], freq, rules, used, cap, dcap, dev)
            for d, dev in enumerate(mesh.devices)
        ])
        self.dropped = [0] * len(self.local)  # live tokens the relays dropped
        self._graph_setup()
        self._count()

    def _place(self, states):
        """The shard list that the kernels read, from this process's states."""
        return states

    def _most(self, n: int) -> int:
        """The largest ``n`` over the processes that share the mesh."""
        return n

    def recount(self, st, limit: int):
        shard_recount(st, self.shards)

    def round(self, limit: int):
        for st in self.local:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        for dev in self._devices:
            delta_emit([st for st in self.local if st.device == dev])
        self._barrier()
        return self._exchange(limit)

    def graph_row(self, st) -> list:
        return _graph_row(st)

    def graph_addresses(self) -> list:
        # the emit's shard array (its rows follow the graph rows' pointers
        # and sizes, which key the graph)
        return [_emit_rows(self.shards, "delta_emit").data_ptr()]

    def graph_launched(self, n: int):
        if any(st.n_words for st in self.shards):
            delta_emit.launches += n

    def graph_recounted(self, runs: int):
        shard_recount.launches += runs * len(self.shards)

    def _segment_end(self):
        """At the JAX host loop's re-pack trigger (the largest shard's live
        tokens, relaid words' included, halved past ``per``): relay every
        shard."""
        if not self.repack:
            return
        live = [int(st.ctl[LIVE]) for st in self.local]
        most = self._most(max(n + d for n, d in zip(live, self.dropped)))
        md = _next_pow2(max(most, self.repack_min))
        if md >= self.per:
            return
        for i, st in enumerate(self.local):
            shard_relay(st)
            self.dropped[i] += live[i] - int(st.ctl[LIVE])
        self.per = md
        self.relays += 1

    def stream(self):
        """The live stream of this process's shards, in shard order."""
        parts = [st.stream() for st in self.local]
        t = torch.cat([p[0].cpu() for p in parts])
        wid = torch.cat([p[1].cpu() for p in parts])
        return t, wid, self.head.freq


# -- across processes -----------------------------------------------------------

# ids a step of the process engine's segment: run_training_delta_sharded's
# segment while it re-packs, so that the relay trigger and the replica check
# come where the one-process host loop has them
RELAY_IDS = 1024
# the least entries a side that a shard sends with its ctl in gather 1
WINDOW_MIN = 256


class MirrorShard:
    """Another process's shard as this process's kernels read it: its
    ``ctl``, its delta buffer and its scratch table, laid out as a
    ``ShardState``'s (``Exchange``) and written by the exchange: the
    buffer's written entries at 0 and ``dcap``, the scratch table's occupied
    entries at its front with EMPTY after them (the fold adds every other
    shard's scratch entries wherever they lie).  It holds no replica
    (``keys``/``cnts`` are empty): only the partitioned fold of v1 and v0
    reads another shard's replica."""

    buffer = Exchange.buffer

    def __init__(self, cap: int, dcap: int, device):
        self.device = torch.device(device)
        self.ctl = torch.zeros(CTL_N, dtype=torch.int32, device=self.device)
        self.keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self.cnts = torch.empty(0, dtype=torch.int32, device=self.device)
        Exchange.buffers(self, dcap)
        self.resize(cap)

    def resize(self, cap: int):
        self.cap = cap
        self.rkeys = torch.full((cap,), EMPTY, dtype=torch.int64, device=self.device)
        self.rcnts = torch.zeros(cap, dtype=torch.int32, device=self.device)


class ProcessShardedEngine(ShardedKernelEngine):
    """The sharded kernel engine over a mesh that spans processes
    (``parallel.distributed``).  Process ``comm.rank`` drives ``mesh``, its
    ``counts[rank]`` shards, which are shards ``offset .. offset +
    counts[rank] - 1`` of the global order (the ranks' shards in rank
    order); every other index holds a ``MirrorShard``, so the kernels read
    the shards in the same order in every process.  ``comm.fixed(t)``
    gathers a host tensor from every process in rank order (a new leading
    axis) and ``comm.max(n)`` takes the largest ``n``.  A round:

      topk_accept    on every local replica
      delta_emit     on the local shards, one launch
      gather 1       every shard's ctl with the first ``window`` entries of
                     each side of its buffer (the replicas' round control
                     checked equal); unless some DOVF is set, the written
                     entries that passed the window gathered again
      shard_recount  on every local shard, only when some DOVF is set
      gather 2       only then: every shard's ctl again (ROCC, ROVF) and its
                     scratch table's occupied entries
      shard_fold     the branch's entry, one launch for the local replicas

    The payloads go through the host (a device-to-host copy, the gather, a
    host-to-device copy into the mirrors), so the host reads ctl every
    round: the one-process engine's BATCH rounds between two reads do not
    hold here (a batch ends at its first round that accepted nothing).
    Every process takes every collective in the same order: a shard with no
    word still sends its (empty) entries.  The relay trigger is the largest
    live count over the processes; the replica check at each segment end
    also compares the head replicas' control and rules across them.  An
    overflow prints the JAX host loop's line on rank 0."""

    cross_checks = 0

    def __init__(self, seg_t, seg_w, per: int, freq, rules, used_ids0: int, vocab_size: int,
                 batch_k: int, mesh, dcap: int, m: int, comm, counts):
        self.comm = comm
        self.counts = list(counts)
        self.offset = sum(self.counts[: comm.rank])
        self.window = min(WINDOW_MIN, dcap)
        super().__init__(seg_t, seg_w, per, freq, rules, used_ids0, vocab_size, batch_k, mesh,
                         dcap, m)
        self.graph = False  # the exchange goes through the host every round

    @property
    def local(self):
        return self._own

    def _place(self, states):
        self._own = states
        head = states[0]
        shards = [MirrorShard(head.cap, self.dcap, head.device) for _ in range(sum(self.counts))]
        shards[self.offset : self.offset + len(states)] = states
        self.mirrors = [(g, s) for g, s in enumerate(shards) if isinstance(s, MirrorShard)]
        return shards

    def _most(self, n: int) -> int:
        return self.comm.max(n)

    def _gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Every shard's row, in global order, from ``rows`` (one a local
        shard, on the host): one gather, each rank's rows padded to the
        most shards a rank holds."""
        pad = torch.zeros((max(self.counts), *rows.shape[1:]), dtype=rows.dtype)
        pad[: rows.shape[0]] = rows
        got = self.comm.fixed(pad)
        return torch.cat([got[r, :c] for r, c in enumerate(self.counts)])

    def _write(self, pairs):
        """Copy each host tensor of ``pairs`` (device view, host tensor)
        into its view, through one host-to-device copy."""
        pairs = [(dst, h) for dst, h in pairs if h.numel()]
        if not pairs:
            return
        flat = torch.cat([h.reshape(-1).long() for _, h in pairs]).to(self.head.device)
        o = 0
        for dst, h in pairs:
            dst.copy_(flat[o : o + h.numel()])
            o += h.numel()

    def _entries(self, mine: torch.Tensor, n: torch.Tensor) -> dict:
        """Gather every shard's entries: ``mine`` holds this process's, each
        local shard's ``n[g]`` keys then its ``n[g]`` values (int64, on
        the host), ``n`` every shard's count in global order.  Returns each
        mirror's (keys, values) on the host, by global index."""
        starts = np.cumsum([0] + self.counts)
        per_rank = [2 * int(n[starts[r] : starts[r + 1]].sum()) for r in range(len(self.counts))]
        width = max(per_rank)
        if width == 0 or not self.mirrors:
            return {}
        pay = torch.zeros(width, dtype=torch.int64)
        pay[: mine.numel()] = mine
        got = self.comm.fixed(pay)
        flat = torch.cat([got[r, :w] for r, w in enumerate(per_rank) if r != self.comm.rank])
        out, o = {}, 0
        for g, _ in self.mirrors:
            k = int(n[g])
            out[g] = flat[o : o + k], flat[o + k : o + 2 * k]
            o += 2 * k
        return out

    def _exchange(self, limit: int, recount=None):
        """Gather 1: every shard's ctl and the first ``window`` entries of
        each side of its buffer, in one row (one device-to-host copy, one
        gather); the replicas' round control checked equal (the host reads
        the branch there: ``recount`` is not needed).  Then the
        recount branch (some DOVF set: shard_recount, gather 2), or the
        delta entries (gathered again, written prefixes only, when a side
        passed the window); the mirrors written through one host-to-device
        copy; the branch's fold entry on the local replicas.  The window
        follows the round's most entries a side (a power of two, WINDOW_MIN
        .. dcap), the same in every process.  False, with no fold, when no
        replica accepted a candidate and none recounts: no shard emitted, so
        the round (past the segment's end, or done) ends its batch."""
        w, dcap, dev = self.window, self.dcap, self.head.device
        rows = self._gather_rows(torch.stack([
            torch.cat([st.ctl.long(), st.dk[:w], st.dk[dcap : dcap + w], st.dv[:w].long(),
                       st.dv[dcap : dcap + w].long()]).to(dev)
            for st in self.local
        ]).cpu())
        ctl = rows[:, :CTL_N]
        if not bool((ctl[:, :CTL_OWN] == ctl[0, :CTL_OWN]).all()):
            raise RuntimeError("the processes' replicas disagree on the round control")
        recount = bool(ctl[:, DOVF].any())
        if not ctl[0, NACC] and not recount:
            return False
        if recount:
            self._write([(m.ctl, ctl[g]) for g, m in self.mirrors])
            for st in self.local:
                self.recount(st, limit)
            self._barrier()
            self._share_scratch()
        else:
            self._share_deltas(rows, ctl[:, [DN_OLD, DN_NEW]].clamp(max=dcap))
        self._fold(recount)
        self._barrier()

    def _share_deltas(self, rows: torch.Tensor, sides: torch.Tensor):
        """The delta branch's mirrors: ctl and each side's written entries
        (``sides``: every shard's count of each), from gather 1's windows,
        or gathered again when a side passed the window."""
        w, dcap = self.window, self.dcap
        most = int(sides.max())
        if most > w:
            mine = []
            for g, st in enumerate(self.local, self.offset):
                a, b = (int(x) for x in sides[g])
                dk = torch.cat([st.dk[:a], st.dk[dcap : dcap + b]])
                dv = torch.cat([st.dv[:a], st.dv[dcap : dcap + b]]).long()
                mine.append(torch.cat([dk, dv]).to(self.head.device))
            got = self._entries(torch.cat(mine).cpu(), sides.sum(1))
        pairs = []
        for g, m in self.mirrors:
            a, b = (int(x) for x in sides[g])
            if most > w:
                keys, vals = got[g]
            else:
                win = rows[g, CTL_N:]
                keys = torch.cat([win[:a], win[w : w + b]])
                vals = torch.cat([win[2 * w : 2 * w + a], win[3 * w : 3 * w + b]])
            pairs += [(m.ctl, rows[g, :CTL_N]), (m.dk[:a], keys[:a]), (m.dv[:a], vals[:a]),
                      (m.dk[dcap : dcap + b], keys[a:]), (m.dv[dcap : dcap + b], vals[a:])]
        self._write(pairs)
        self.window = min(dcap, max(WINDOW_MIN, _next_pow2(most)))

    def _share_scratch(self):
        """Gather 2: every shard's ctl (ROCC, ROVF) with its scratch table's
        occupied entries, into the mirrors' ctl and the front of their
        scratch tables (EMPTY after them)."""
        dev = self.head.device
        mine, sizes = [], []
        for st in self.local:
            live = st.rkeys != EMPTY
            keys = st.rkeys[live]
            sizes.append(keys.numel())
            mine.append(torch.cat([keys, st.rcnts[live].long()]).to(dev))
        ctl = torch.stack([st.ctl.long().to(dev) for st in self.local]).cpu()
        rows = self._gather_rows(torch.cat([ctl, torch.tensor(sizes)[:, None]], 1))
        got = self._entries(torch.cat(mine).cpu(), rows[:, CTL_N])
        pairs = []
        for g, m in self.mirrors:
            m.rkeys.fill_(EMPTY)
            m.rcnts.zero_()
            keys, vals = got.get(g, (rows[g, :0], rows[g, :0]))
            pairs += [(m.ctl, rows[g, :CTL_N]), (m.rkeys[: keys.numel()], keys),
                      (m.rcnts[: keys.numel()], vals)]
        self._write(pairs)

    def check_replicas(self):
        """The local replicas agree, and every process's head replica holds
        the same round control, recount rounds and rules."""
        super().check_replicas()
        head = self.head
        rec = torch.cat([head.ctl[:CTL_OWN].cpu(), head.ctl[NREC : NREC + 1].cpu(),
                         head.rules.flatten().cpu()])
        got = self.comm.fixed(rec)
        if not bool((got == got[0]).all()):
            raise RuntimeError("the processes' replicas disagree")
        self.cross_checks += 1

    def segment(self, used: int, limit: int):
        """Rounds to ``limit`` in steps of at most RELAY_IDS ids while
        re-packing (each step ends as a one-process segment does: the
        replica check, then the relay trigger); ``nrec`` sums the steps'."""
        nrec = 0
        while True:
            step = min(limit, used + RELAY_IDS) if self.repack else limit
            used, done, overflow = super().segment(used, step)
            nrec += self.nrec
            if done or overflow or used >= limit:
                self.nrec = nrec
                return used, done, overflow

    def regrow(self):
        super().regrow()
        if self.comm.rank == 0:
            # the JAX host loop's line; pcap is half the slots
            print(f"pair-count table overflow: retrying with pcap={self.head.cap // 2}",
                  file=sys.stderr)
