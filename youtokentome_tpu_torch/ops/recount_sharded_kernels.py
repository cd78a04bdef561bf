"""The sharded v1 and v0 trainers' rounds as kernels over N shards, and the
loops that drive them.

The JAX programs ``youtokentome_tpu/parallel/train_stream_sharded.py:42
_train_sharded`` (v1) and ``youtokentome_tpu/parallel/train_sharded.py:38
_train_rounds_sharded`` (v0) recount every pair each round: every device
gathers every shard's pair keys (``all_gather``), counts them into the same
replicated table, takes the same top-k (v0: the argmax) and applies the
accepted merges to its own shard.  Here each shard is a state on its device,
one-device v1's ``StreamState`` (its front-compacted stream) or v0's
``BucketedState`` (its rows), each with a replica of the table and the
exchange's ``ctl`` and scratch table (``delta_sharded_kernels.Exchange``).
A round, all in hand-written CUDA:

  stream_shard_count  on every shard: v1's recount (``csrc/train_stream.cu``)
  bucket_shard_count  (v0: ``csrc/train_bucketed.cu``'s count) into the
                      shard's scratch table, its occupancy and overflow in
                      ``ctl``'s scratch slots
  shard_part_fold     on every replica (``csrc/train_delta_sharded.cu``):
                      the replica's own part of the table (part r of N, the
                      keys whose ``key_part`` is r) emptied and rebuilt from
                      every shard's scratch entries of that part, so each
                      entry is inserted once over all replicas
  shard_gather        on every replica, once all parts are folded: every
                      other replica's part copied in, the parts' counts
                      summed into the occupancy (an overflowed scratch table
                      or a table more than half full sets OVERFLOW on every
                      replica; the host doubles the tables and the segment
                      runs again, nothing applied)
  topk_accept         on every replica (k = 1 for v0)
  apply_compact       on every shard (v0: ``bucket_apply``)

The host reads shard 0's ``ctl`` once per batch of rounds and checks that
every replica's round control and rules agree at each segment end.  Each
wrapper launches its kernels on a CUDA state (and counts the launch) and
runs its plain torch version on a CPU state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .bucketed_kernels import BucketedState, bucket_apply, row_pairs
from .delta_sharded_kernels import (
    ROCC,
    ROVF,
    Exchange,
    ShardEngine,
    shard_gather,
    shard_part_fold,
)
from .stream_train_kernels import (
    LIVE,
    NEXT_LIVE,
    StreamState,
    apply_compact,
    live_pairs,
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
    zeroes none of its own slots (v1's LIVE and NEXT_LIVE carry over
    rounds); its delta buffer (one entry) is never read."""

    n_own = 0


class StreamShardState(RecountShard, StreamState):
    """One shard of the sharded v1 trainer: its front-compacted stream."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, device):
        super().__init__(t, wid, freq, rules, used, cap, device)
        self.buffers(1)


class BucketedShardState(RecountShard, BucketedState):
    """One shard of the sharded v0 trainer: its block of every bucket's rows."""

    def __init__(self, buckets, rules, used: int, cap: int, device):
        super().__init__(buckets, rules, used, cap, device)
        self.buffers(1)


def _clear_scratch(st):
    st.rkeys.fill_(EMPTY)
    st.rcnts.zero_()
    st.ctl[ROCC] = 0
    st.ctl[ROVF] = 0


# -- plain torch versions -----------------------------------------------------


def stream_shard_count_plain(st: StreamShardState, limit: int, vocab_size: int):
    st.ctl[LIVE] = st.ctl[NEXT_LIVE]
    if not round_active(st, limit, vocab_size):
        return
    _clear_scratch(st)
    if int(st.ctl[LIVE]):
        _hash_update(st.rkeys, st.rcnts, st.ctl, ROCC, ROVF, *live_pairs(st))


def bucket_shard_count_plain(st: BucketedShardState, limit: int, vocab_size: int):
    if not round_active(st, limit, vocab_size):
        return
    _clear_scratch(st)
    _hash_update(st.rkeys, st.rcnts, st.ctl, ROCC, ROVF, *row_pairs(st))


# -- wrappers -----------------------------------------------------------------


def stream_shard_count(st: StreamShardState, limit: int, vocab_size: int):
    """Empty the shard's scratch table and count its live stream into it (a
    no-op once the round loop stopped); sets ``ctl[ROVF]`` when the table
    holds more than half its slots."""
    if not _on(st, "stream_shard_count"):
        return stream_shard_count_plain(st, limit, vocab_size)
    lib = _cuda.load_stream_train()
    with torch.cuda.device(st.device):
        err = lib.yttm_stream_shard_count(
            st.t.data_ptr(), st.wid.data_ptr(), st.freq.data_ptr(), st.t.shape[0],
            st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            st.tiles.data_ptr(), int(limit), int(vocab_size), _stream_ptr(st.device),
        )
    _check(err, "stream_shard_count")
    stream_shard_count.launches += 1


def bucket_shard_count(st: BucketedShardState, limit: int, vocab_size: int):
    """Empty the shard's scratch table and count its rows' pairs into it (a
    no-op once the round loop stopped); sets ``ctl[ROVF]`` when the table
    holds more than half its slots."""
    if not _on(st, "bucket_shard_count"):
        return bucket_shard_count_plain(st, limit, vocab_size)
    lib = _cuda.load_bucketed()
    with torch.cuda.device(st.device):
        err = lib.yttm_bucket_shard_count(
            st.tok.data_ptr(), st.roff.data_ptr(), st.rfreq.data_ptr(), st.n_rows,
            st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(), int(limit),
            int(vocab_size), _stream_ptr(st.device),
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

    def _exchange(self, limit: int):
        shards = self.shards
        for st in shards:
            self.recount(st, limit)
        self._barrier()
        for st in shards:
            shard_part_fold(st, shards)
        self._barrier()
        for st in shards:
            shard_gather(st, shards)
        self._barrier()

    def round(self, limit: int):
        self._exchange(limit)
        for st in self.shards:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        for st in self.shards:
            self.apply(st)
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
            StreamShardState(seg_t[d], seg_w[d], freq, rules, used, cap, dev)
            for d, dev in enumerate(mesh.devices)
        ]
        self._count()

    def recount(self, st, limit: int):
        stream_shard_count(st, limit, self.vocab_size)

    def apply(self, st):
        apply_compact(st)


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
            BucketedShardState(shard_buckets[d], rules, used, cap, dev)
            for d, dev in enumerate(mesh.devices)
        ]
        self._count()

    def recount(self, st, limit: int):
        bucket_shard_count(st, limit, self.vocab_size)

    def apply(self, st):
        bucket_apply(st)
