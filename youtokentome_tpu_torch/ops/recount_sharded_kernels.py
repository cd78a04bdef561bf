"""The sharded v1 and v0 trainers' rounds as kernels over N shards, and the
loops that drive them.

The JAX programs ``youtokentome_tpu/parallel/train_stream_sharded.py:42
_train_sharded`` (v1) and ``youtokentome_tpu/parallel/train_sharded.py:38
_train_rounds_sharded`` (v0) recount every pair each round: every device
gathers every shard's pair keys (``all_gather``), counts them into the same
replicated table, takes the same top-k (v0: the argmax) and applies the
accepted merges to its own shard.  Here each shard is a state on its device,
one-device v1's ``StreamState`` (its front-compacted stream) or v0's
``BucketedState`` (its rows), each with a replica of the table, the
exchange's ``ctl`` and scratch table (``delta_sharded_kernels.Exchange``)
and the scratch table's part lists (``RecountShard``).  A table of ``cap``
slots is cut into N parts (``csrc/part_list.cuh``): part p is the slots
``[p*cap/N, (p+1)*cap/N)`` of a replica and holds the keys whose
``key_part`` is p; part p's list, ``plist[p*cap/N, (p+1)*cap/N)``, holds the
scratch slots that keys of part p claimed in the shard's last count, and
``pcnt[p]`` counts them (past the part's size they are counted and dropped,
and the part is full).  Replica r's fill lists, ``fill``, two bitmaps of
its largest part's slots and the word that picks the next fold's, name the
slots of its own part that its last two folds claimed.  A round, all in
hand-written CUDA:

  stream_shard_count  on every shard: v1's count (``csrc/train_stream.cu``,
                      ``csrc/stream_count.cuh``: a flat walk into each
                      block's table in shared memory, the block's claims
                      listed by part once a block)
  bucket_shard_count  (v0: ``csrc/train_bucketed.cu``'s count, the same flat
                      walk and block table over the shard's rows, its claims
                      listed once a block too)
                      into the shard's scratch table, emptied first, its
                      occupancy and overflow in ``ctl``'s scratch slots
  shard_part_fold     on every replica (``csrc/train_delta_sharded.cu``):
                      the replica's own part r of the table emptied and
                      rebuilt from the entries of every shard's part-r list,
                      so each entry is read and inserted once over all
                      replicas, each slot it claims set in its fill list
  shard_gather        once a card over its replicas, once all parts are
                      folded: every other replica p's part copied in at the
                      slots that p's two fill lists name (the only slots
                      where it changed since the last gather), in one pass
                      over the slots in order; the parts' counts
                      summed into the occupancy (an overflowed scratch
                      table, a full part or a table more than half full sets
                      OVERFLOW on every replica; the host doubles the tables
                      and the segment runs again, nothing applied)
  topk_accept         on every replica (k = 1 for v0)
  apply_compact       once a card over its shards' streams (each compacted
                      into its other buffer; v0: ``bucket_apply``, once a
                      card over its shards' rows)

The host reads shard 0's ``ctl`` once per batch of rounds and checks that
every replica's round control and rules agree at each segment end.  Each
wrapper launches its kernels on a CUDA state (and counts the launch) and
runs its plain torch version on a CPU state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from . import bucketed_kernels as bk
from . import stream_train_kernels as stk
from .bucketed_kernels import BucketedState, bucket_apply, row_pairs
from .delta_sharded_kernels import (
    ROCC,
    ROVF,
    Exchange,
    ShardEngine,
    bit_slots,
    fill_words,
    key_part,
    part_lo,
    shard_gather,
    shard_part_fold,
)
from .stream_train_kernels import (
    StreamState,
    apply_compact,
    bufs,
    check_aligned,
    live_pairs,
    turn,
)
from .tiered_kernels import _hash_update
from .train_kernels import (
    EMPTY,
    OVERFLOW,
    _check,
    _on,
    _stream_ptr,
    initial_cap,
    round_active,
    rules_used,
    topk_accept,
)


class RecountShard(Exchange):
    """A shard that counts into its scratch table every round: the top-k
    zeroes none of its own slots (v1's live counts and buffers carry over
    rounds, and nothing but the fold writes a replica's table); its delta
    buffer (one entry) is never read.  Its scratch table's part lists among
    ``n_parts`` (the mesh's shards): ``plist`` [cap] and ``pcnt``
    [n_parts]; its replica's fill lists, ``fill`` (the module note); all
    empty with the table."""

    n_own = 0

    def resize(self, cap: int):
        super().resize(cap)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.plist = torch.zeros(cap, **i32)
        self.pcnt = torch.zeros(self.n_parts, **i32)
        self.fill = torch.zeros(2 * fill_words(cap, self.n_parts) + 1, **i32)

    def fill_list(self, l: int, r: int) -> torch.Tensor:
        """The slots that fill list ``l`` names, in order (int64), this
        state being replica ``r`` (its own part, part r)."""
        words = fill_words(self.cap, self.n_parts)
        return bit_slots(self.fill[l * words :][:words]) + part_lo(r, self.cap, self.n_parts)

    def fill_next(self) -> int:
        """The fill list that the next fold fills (the other holds the last
        fold's claims once the gather has turned them)."""
        return int(self.fill[2 * fill_words(self.cap, self.n_parts)])

    def part_list(self, p: int) -> torch.Tensor:
        """The scratch slots of part ``p``'s list (int64; the first ones,
        when the list dropped claims)."""
        lo, hi = part_lo(p, self.cap, self.n_parts), part_lo(p + 1, self.cap, self.n_parts)
        return self.plist[lo : lo + min(int(self.pcnt[p]), hi - lo)].long()


class StreamShardState(RecountShard, StreamState):
    """One shard of the sharded v1 trainer: its front-compacted stream."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device, n_parts: int):
        self.n_parts = n_parts
        super().__init__(t, wid, freq, rules, used, cap, device)
        self.buffers(1)


class BucketedShardState(RecountShard, BucketedState):
    """One shard of the sharded v0 trainer: its block of every bucket's rows."""

    def __init__(self, buckets, rules, used: int, cap: int, device, n_parts: int):
        self.n_parts = n_parts
        super().__init__(buckets, rules, used, cap, device)
        self.buffers(1)


def _clear_scratch(st):
    st.rkeys.fill_(EMPTY)
    st.rcnts.zero_()
    st.pcnt.zero_()
    st.ctl[ROCC] = 0
    st.ctl[ROVF] = 0


def _list_parts(st):
    """List every claimed slot of the scratch table in its key's part (in
    slot order), as the counts list their claims."""
    n, cap = st.n_parts, st.cap
    slots = torch.nonzero(st.rkeys != EMPTY).flatten()
    parts = key_part(st.rkeys[slots], n)
    for p in range(n):
        mine = slots[parts == p]
        lo = part_lo(p, cap, n)
        k = min(mine.numel(), part_lo(p + 1, cap, n) - lo)
        st.plist[lo : lo + k] = mine[:k].to(torch.int32)
        st.pcnt[p] = mine.numel()


# -- plain torch versions -----------------------------------------------------


def stream_shard_count_plain(st: StreamShardState, limit: int, vocab_size: int):
    turn(st)
    if not round_active(st, limit, vocab_size):
        return
    _clear_scratch(st)
    if int(st.ctl[stk.LIVE]):
        _hash_update(st.rkeys, st.rcnts, st.ctl, ROCC, ROVF, *live_pairs(st))
    _list_parts(st)


def bucket_shard_count_plain(st: BucketedShardState, limit: int, vocab_size: int):
    if not round_active(st, limit, vocab_size):
        return
    _clear_scratch(st)
    _hash_update(st.rkeys, st.rcnts, st.ctl, ROCC, ROVF, *row_pairs(st))
    _list_parts(st)


# -- wrappers -----------------------------------------------------------------


def stream_shard_count(st: StreamShardState, limit: int, vocab_size: int):
    """Turn to the buffer the last apply wrote, empty the shard's scratch
    table and count its live stream into it, each claimed slot listed in
    its key's part (a no-op once the round loop stopped); sets
    ``ctl[ROVF]`` when the table holds more than half its slots.  The
    count's grid: ``stream_train_kernels.COUNT_BLOCKS``."""
    if not _on(st, "stream_shard_count"):
        return stream_shard_count_plain(st, limit, vocab_size)
    check_aligned(st, "stream_shard_count")
    lib = _cuda.load_stream_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_stream_shard_count(
            *bufs(st), st.freq.data_ptr(), st.t0.shape[0], st.rkeys.data_ptr(),
            st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(), st.plist.data_ptr(),
            st.pcnt.data_ptr(), st.n_parts, int(limit), int(vocab_size),
            int(stk.COUNT_BLOCKS), _stream_ptr(st.device),
        )
    _check(err, "stream_shard_count")
    stream_shard_count.launches += 1


def bucket_shard_count(st: BucketedShardState, limit: int, vocab_size: int):
    """Empty the shard's scratch table and count its rows' pairs into it,
    each claimed slot listed in its key's part (a no-op once the round loop
    stopped); sets ``ctl[ROVF]`` when the table holds more than half its
    slots.  The count's grid: ``bucketed_kernels.COUNT_BLOCKS``."""
    if not _on(st, "bucket_shard_count"):
        return bucket_shard_count_plain(st, limit, vocab_size)
    bk.check_aligned(st, "bucket_shard_count")
    lib = _cuda.load_bucketed()
    with torch.cuda.device(st.device):
        err = lib.yttm_bucket_shard_count(
            st.tok.data_ptr(), st.tok.shape[0], st.bk.data_ptr(), len(st.shapes),
            st.rfreq.data_ptr(), st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap,
            st.ctl.data_ptr(), st.plist.data_ptr(), st.pcnt.data_ptr(), st.n_parts, int(limit),
            int(vocab_size), int(bk.COUNT_BLOCKS), _stream_ptr(st.device),
        )
    _check(err, "bucket_shard_count")
    bucket_shard_count.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
stream_shard_count.launches = 0
bucket_shard_count.launches = 0


# -- host loops ---------------------------------------------------------------


class RecountShardEngine(ShardEngine):
    """A round: every shard counted into its scratch table, every replica
    rebuilt from them (each its own part, then the others' parts copied),
    the top-k on every replica, the apply on every shard.  The tables start
    at ``initial_cap`` slots and double when a count overflows (at the
    start, and whenever a round's count does)."""

    def _exchange(self, limit: int, recount=None):
        """Every exchange recounts: ``recount`` changes nothing."""
        shards = self.shards
        for st in shards:
            self.recount(st, limit)
        self._barrier()
        for st in shards:
            shard_part_fold(st, shards)
        self._barrier()
        for dev in self._devices:
            shard_gather([st for st in shards if st.device == dev], shards)
        self._barrier()

    def round(self, limit: int):
        self._exchange(limit)
        for st in self.shards:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        self.apply()
        self._barrier()

    def regrow(self):
        """After a count overflowed: tables twice the size (each round counts
        into fresh ones)."""
        self.rebuilds += 1
        for st in self.shards:
            st.resize(st.cap * 2)
            st.ctl[OVERFLOW] = 0
            st.ctl[ROVF] = 0


class StreamShardedKernelEngine(RecountShardEngine):
    """The sharded v1 rounds, for
    ``parallel.train_stream_sharded.run_training_stream_sharded``; ``m`` is
    the whole stream's length."""

    def __init__(self, seg_t, seg_w, freq, rules, used_ids0: int, vocab_size: int, batch_k: int,
                 mesh, m: int):
        self._setup(mesh, vocab_size, used_ids0, batch_k)
        used = rules_used(rules, used_ids0)
        cap = initial_cap(m)
        self.shards = [
            StreamShardState(seg_t[d], seg_w[d], freq, rules, used, cap, dev, len(mesh.devices))
            for d, dev in enumerate(mesh.devices)
        ]
        self._count()

    def recount(self, st, limit: int):
        stream_shard_count(st, limit, self.vocab_size)

    def apply(self):
        """One launch a card over its shards' streams."""
        for dev in self._devices:
            apply_compact([st for st in self.shards if st.device == dev])


class BucketedShardedKernelEngine(RecountShardEngine):
    """The sharded v0 rounds (one merge a round), for
    ``parallel.train_sharded.run_training_sharded``: ``shard_buckets`` holds
    each shard's list of (tokens, freq) row blocks."""

    def __init__(self, shard_buckets, rules, used_ids0: int, vocab_size: int, mesh):
        self._setup(mesh, vocab_size, used_ids0, 1)
        used = rules_used(rules, used_ids0)
        slots = sum(int(np.asarray(t).size) for bks in shard_buckets for t, _ in bks)
        cap = initial_cap(slots)
        self.shards = [
            BucketedShardState(shard_buckets[d], rules, used, cap, dev, len(mesh.devices))
            for d, dev in enumerate(mesh.devices)
        ]
        self._count()

    def recount(self, st, limit: int):
        bucket_shard_count(st, limit, self.vocab_size)

    def apply(self):
        """One launch a card over its shards' rows."""
        for dev in self._devices:
            bucket_apply([st for st in self.shards if st.device == dev])
