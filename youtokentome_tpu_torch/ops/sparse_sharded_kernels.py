"""The sharded v3 trainer's round as kernels over N shards, and the loop
that drives them.

The JAX program ``youtokentome_tpu/parallel/train_sparse_sharded.py:86
_train_sparse_sharded`` runs the v3 round on every device of a data mesh
with the pair-count table replicated: the same top-k everywhere, each
shard's tombstone apply with its bounded old/new delta buffers, then one
exchange that every device folds into its table or, when some shard's
affected positions passed dcap (``lax.pmax``), a recount exchange.  Here
each shard is a ``SparseShardState`` on its device: the v3 state of
``sparse_kernels.SparseState`` (the tombstoned stream, whose positions never
move, with static ``wid`` and the exact table) with the exchange's ``ctl``,
``[2*dcap]`` delta buffer and scratch table (``delta_sharded_kernels.Exchange``).
A round, all in hand-written CUDA (``csrc/train_sparse_sharded.cu``, the
shared top-k of ``csrc/train_topk.cu`` and ``shard_fold`` of
``csrc/train_delta_sharded.cu``):

  topk_accept           on every replica (the shared top-k)
  sparse_emit           on every shard: sparse_apply's merge, with the listed
                        words' old and new contributions appended to the
                        shard's buffer; DOVF in ``ctl`` when the listed words'
                        positions, tombstones included, pass dcap (JAX's
                        ``n_aff > dcap``)
  sparse_shard_recount  on every shard: a no-op unless some shard's DOVF is
                        set; else the shard's tombstoned stream counted into
                        its scratch table
  shard_fold            on every replica (``delta_sharded_kernels``)

The host reads shard 0's ``ctl`` once per batch of rounds and checks that
every replica's round control and rules agree at each segment end.  Each
wrapper launches its kernels on a CUDA state (and counts the launch) and
runs its plain torch version on a CPU state; the plain versions compute the
same function.
"""

from __future__ import annotations

import torch

from . import _cuda
from .delta_sharded_kernels import (
    DN_OLD,
    DOVF,
    LIVE,
    NAFF,
    ROCC,
    ROVF,
    W_COUNT,
    W_EMIT,
    W_ENTRIES,
    Exchange,
    ShardEngine,
    _any,
    _links,
)
from .sparse_kernels import SparseState
from .tiered_kernels import _hash_update
from .train_kernels import (
    EMPTY,
    NACC,
    _check,
    _on,
    _stream_ptr,
    initial_cap,
    rules_used,
    topk_accept,
)
from .train_sparse import _apply_tomb, _pairs_tomb

NPOS = LIVE  # v3: the positions of the round's listed words, tombstones included


class SparseShardState(Exchange, SparseState):
    """One shard of the sharded v3 trainer on its device (see the module
    note); ``end`` is the end of its last word."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, dcap: int, device):
        super().__init__(t, wid, freq, rules, used, cap, device)
        self.buffers(dcap)
        self.end = int(self.off[-1])


# -- plain torch versions -----------------------------------------------------


def sparse_emit_plain(st: SparseShardState):
    n = int(st.ctl[NACC])
    st.ctl[NPOS] = 0
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
    n_pos = int(aff.sum())
    st.ctl[NPOS] = n_pos
    if n_pos > st.dcap:
        st.ctl[DOVF] = 1
    keys2, w2, _, _ = _pairs_tomb(t2, st.wid, fw)
    dcap, kept = st.dcap, 0
    for side, (k, v, sign) in enumerate(((keys, w, -1), (keys2, w2, 1))):
        sel = aff & (v > 0)
        n_side = int(sel.sum())
        m = min(n_side, dcap)
        st.ctl[DN_OLD + side] = n_side
        st.dk[side * dcap : side * dcap + m] = k[sel][:m]
        st.dv[side * dcap : side * dcap + m] = (sign * v[sel][:m]).to(torch.int32)
        if n_side > dcap:
            st.ctl[DOVF] = 1
        kept += m
    st.t.copy_(t2)
    st.work[W_EMIT] += 4 * st.end + 8 * n_pos + 12 * kept
    st.work[W_ENTRIES] += kept


def sparse_shard_recount_plain(st: SparseShardState, shards):
    if not _any(shards, DOVF):
        return
    st.rkeys.fill_(EMPTY)
    st.rcnts.zero_()
    st.ctl[ROCC] = 0
    st.ctl[ROVF] = 0
    st.work[W_COUNT] += 4 * st.end + 8 * st.n_words
    keys, w, _, _ = _pairs_tomb(st.t, st.wid, st.fw_pos())
    on = w > 0
    _hash_update(st.rkeys, st.rcnts, st.ctl, ROCC, ROVF, keys[on], w[on])


# -- wrappers -----------------------------------------------------------------


def sparse_emit(st: SparseShardState):
    """Merge the round's accepted candidates into the shard's tombstoned
    stream and append its listed words' old and new contributions to its
    buffer."""
    if st.n_words == 0:
        return
    if not _on(st, "sparse_emit"):
        return sparse_emit_plain(st)
    lib = _cuda.load_sparse_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_sparse_shard_emit(
            st.t.data_ptr(), st.pw.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.n_words,
            st.end, st.ctl.data_ptr(), st.cand.data_ptr(), st.aff.data_ptr(),
            st.wmark.data_ptr(), st.dk.data_ptr(), st.dv.data_ptr(), st.dcap,
            st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "sparse_emit")
    sparse_emit.launches += 1


def sparse_shard_recount(st: SparseShardState, shards):
    """Unless no shard's DOVF is set: count the shard's tombstoned stream
    into its scratch table (sets ``ctl[ROVF]`` when it fills more than
    half)."""
    if not _on(st, "sparse_shard_recount"):
        return sparse_shard_recount_plain(st, shards)
    ctls = _links(st, shards)[0]
    lib = _cuda.load_sparse_sharded()
    with torch.cuda.device(st.device):
        err = lib.yttm_sparse_shard_recount(
            st.t.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.n_words, st.end,
            st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            ctls.data_ptr(), len(shards), st.work.data_ptr(), _stream_ptr(st.device),
        )
    _check(err, "sparse_shard_recount")
    sparse_shard_recount.launches += 1


# launches of the CUDA kernels through each wrapper (plain calls not counted)
sparse_emit.launches = 0
sparse_shard_recount.launches = 0


# -- host loop ----------------------------------------------------------------


class SparseShardedKernelEngine(ShardEngine):
    """Segments of rounds through the kernels over the mesh's shards, for
    ``parallel.train_sparse_sharded.run_training_sparse_sharded``.  Every
    replica starts at ``initial_cap`` slots of the whole stream's ``m`` and
    is rebuilt from the streams when an insert finds it more than half
    full.  The tombstoned streams never move, so nothing is relaid."""

    def __init__(self, seg_t, seg_w, freq, rules, used_ids0: int, vocab_size: int, batch_k: int,
                 mesh, dcap: int, m: int):
        self._setup(mesh, vocab_size, used_ids0, batch_k)
        self.dcap = dcap
        used = rules_used(rules, used_ids0)
        cap = initial_cap(m)
        self.shards = [
            SparseShardState(seg_t[d], seg_w[d], freq, rules, used, cap, dcap, dev)
            for d, dev in enumerate(mesh.devices)
        ]
        self._count()

    def recount(self, st, limit: int):
        sparse_shard_recount(st, self.shards)

    def round(self, limit: int):
        for st in self.shards:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        for st in self.shards:
            sparse_emit(st)
        self._barrier()
        self._exchange(limit)

    def stream(self):
        """The shards' tombstoned streams end to end (a snapshot keeps their
        live tokens, as the JAX host loop's does)."""
        t = torch.cat([st.t.cpu() for st in self.shards])
        wid = torch.cat([st.wid.cpu() for st in self.shards])
        return t, wid, self.shards[0].freq
