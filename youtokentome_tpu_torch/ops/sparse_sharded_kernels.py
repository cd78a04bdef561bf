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
  sparse_emit           one launch for the shards of a card: sparse_apply's
                        merge in one flat pass of the tombstoned streams, with
                        the claimed words' old and new contributions appended
                        to each shard's buffer; DOVF in ``ctl`` when a shard's
                        claimed words' positions, tombstones included, pass
                        dcap (JAX's ``n_aff > dcap``)
  sparse_shard_recount  on every shard, only when some shard's DOVF is set:
                        the shard's tombstoned stream counted into its scratch
                        table (``csrc/tomb_count.cuh``, the one-device
                        ``sparse_count``'s flat count)
  shard_fold            one launch for the replicas of a card
                        (``delta_sharded_kernels``): the delta fold, or the
                        rebuild when some DOVF is set

Two routes, as the sharded v2 engine's (``delta_sharded_kernels``): on a
mesh whose shards share one card the engine replays the round graph
(``shard_rounds``; its build entry ``yttm_sparse_shard_graph`` captures the
top-k and the folds through their entries' addresses), whose gate picks the
branch on the card and runs only its kernels; elsewhere (distinct cards,
the CPU, ``graph = False``) the host launches every kernel of a round, the
recount and both fold entries each a no-op unless its branch is the round's.
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
    CTL_N,
    DN_OLD,
    DOVF,
    LIVE,
    NAFF,
    POCC,
    ROCC,
    ROVF,
    W_COUNT,
    W_EMIT,
    W_ENTRIES,
    Exchange,
    ShardEngine,
    _address,
    _any,
    _emit_rows,
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
# sparse_emit's ctl slots past the exchange's, 0 between launches: the
# positions summed so far (a shard's), the blocks done (the card's first
# shard's); csrc/train_sparse_sharded.cu derives them alike, and _lib checks
# that its ctl holds as many slots
NPOS_RUN, EMIT_DONE = POCC + 1, POCC + 2


class SparseShardState(Exchange, SparseState):
    """One shard of the sharded v3 trainer on its device (see the module
    note)."""

    def __init__(self, t, wid, freq, rules, used: int, cap: int, dcap: int, device):
        super().__init__(t, wid, freq, rules, used, cap, device)
        self.buffers(dcap)

    def control(self, rules, used: int, ctl_n: int = CTL_N):
        super().control(rules, used, EMIT_DONE + 1)

    def emit_stream(self):
        return self.t, self.pw, self.end


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


def sparse_emit(states):
    """Merge the round's accepted candidates into the tombstoned streams of
    ``states`` (the shards of one device, which took the same candidates)
    and append each one's claimed words' old and new contributions to its
    buffer: one launch for all of them; a shard without words is skipped."""
    if not any(st.n_words for st in states):
        return
    if not _on(states[0], "sparse_emit"):
        for st in states:
            if st.n_words:
                sparse_emit_plain(st)
        return
    rows = _emit_rows(states, "sparse_emit")
    lib = _lib()
    with torch.cuda.device(states[0].device):
        err = lib.yttm_sparse_shard_emit_card(rows.data_ptr(), len(states), states[0].dcap,
                                              _stream_ptr(states[0].device))
    _check(err, "sparse_emit")
    sparse_emit.launches += 1


def sparse_shard_recount(st: SparseShardState, shards, blocks: int = 0):
    """Unless no shard's DOVF is set: count the shard's tombstoned stream
    into its scratch table (sets ``ctl[ROVF]`` when it fills more than
    half); the count on one wave of blocks, or on at most ``blocks``."""
    if not _on(st, "sparse_shard_recount"):
        return sparse_shard_recount_plain(st, shards)
    ctls = _links(st, shards)[0]
    lib = _lib()
    with torch.cuda.device(st.device):
        err = lib.yttm_sparse_shard_recount(
            st.t.data_ptr(), st.pw.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.n_words,
            st.end, st.rkeys.data_ptr(), st.rcnts.data_ptr(), st.cap, st.ctl.data_ptr(),
            ctls.data_ptr(), len(shards), st.work.data_ptr(), blocks, _stream_ptr(st.device),
        )
    _check(err, "sparse_shard_recount")
    sparse_shard_recount.launches += 1


def _lib():
    """The sharded v3 trainer's library, its ctl layout checked against
    this module's: a launch past a shard's ctl would write outside it."""
    lib = _cuda.load_sparse_sharded()
    n = lib.yttm_sparse_shard_ctl_n()
    if n != EMIT_DONE + 1:
        raise RuntimeError(f"train_sparse_sharded.cu uses {n} ctl slots, this module {EMIT_DONE + 1}")
    return lib


# launches of the CUDA kernels through each wrapper (plain calls not counted)
sparse_emit.launches = 0
sparse_shard_recount.launches = 0


# -- host loop ----------------------------------------------------------------


class SparseShardedKernelEngine(ShardEngine):
    """Segments of rounds through the kernels over the mesh's shards, for
    ``parallel.train_sparse_sharded.run_training_sparse_sharded``.  Every
    replica starts at ``initial_cap`` slots of the whole stream's ``m`` and
    is rebuilt from the streams when an insert finds it more than half
    full.  The tombstoned streams never move, so nothing is relaid.
    ``graph`` picks the route of a batch of rounds: True (the default when
    every shard is on one card) replays the round graph, False runs
    ``round`` through the per-call wrappers."""

    graph_entry = (_lib, "yttm_sparse_shard_graph")

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
        self._graph_setup()
        self._count()

    def graph_row(self, st) -> list:
        """A shard's row of the round graph (``csrc/round_graph.cuh``
        GraphShard: t, pw and the end of its words in tok, pwid and Mw)."""
        return [st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.blk_hi.data_ptr(),
                st.blk_lo.data_ptr(), st.n_blk, st.ticket.data_ptr(), st.ctl.data_ptr(),
                st.cand.data_ptr(), st.rules.data_ptr(), st.work.data_ptr(), st.t.data_ptr(),
                st.pw.data_ptr(), st.end, st.off.data_ptr(), st.fw.data_ptr(), st.n_words,
                st.rkeys.data_ptr(), st.rcnts.data_ptr()]

    def graph_addresses(self) -> list:
        """The fold's two entries, which the graph captures by address, and
        the emit's shard array (its rows follow the graph rows' pointers and
        sizes, which key the graph)."""
        lib = _cuda.load_sharded()
        return [_address(lib.yttm_shard_fold_delta), _address(lib.yttm_shard_fold_rebuild),
                _emit_rows(self.shards, "sparse_emit").data_ptr()]

    def graph_launched(self, n: int):
        if any(st.n_words for st in self.shards):
            sparse_emit.launches += n

    def graph_recounted(self, runs: int):
        sparse_shard_recount.launches += runs * len(self.shards)

    def recount(self, st, limit: int):
        sparse_shard_recount(st, self.shards)

    def round(self, limit: int):
        for st in self.shards:
            topk_accept(st, limit, self.vocab_size, self.used_ids0, self.batch_k)
        for dev in self._devices:
            sparse_emit([st for st in self.shards if st.device == dev])
        self._barrier()
        self._exchange(limit)

    def stream(self):
        """The shards' tombstoned streams end to end (a snapshot keeps their
        live tokens, as the JAX host loop's does)."""
        t = torch.cat([st.t.cpu() for st in self.shards])
        wid = torch.cat([st.wid.cpu() for st in self.shards])
        return t, wid, self.shards[0].freq
