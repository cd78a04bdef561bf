"""Multi-process BPE training over ``torch.distributed``.

PyTorch counterpart of ``youtokentome_tpu/parallel/distributed.py``.  Every
process holds a shard of the corpus (split at word boundaries by the
caller) and drives the shards of its own data mesh (``parallel.mesh
.DataMesh``); the shards of all processes, in rank order, are the global
mesh that the sharded v2 trainer runs over.  All agreement between the
processes comes from host folds gathered in rank order, so they are the
same in every process: the alphabet from the global character counts,
the word-id bases, the global word frequencies, the exact initial table
(the plain round loop's), the common padded shard length and the delta
buffer size.  The rules are bit-identical to the one-process trainer's on
the concatenated corpus, and every process returns the same ``BPEState``.

Usage (the same program in every process):

    from youtokentome_tpu_torch.parallel import distributed as dist
    dist.initialize()                       # torchrun's env://, or pass args
    state = dist.train_from_codepoints_distributed(local_cps, 30000)
    if torch.distributed.get_rank() == 0:
        state.dump("model.yttm")

The collectives gather CPU tensors (gloo by default: it runs on the CPU,
and with several processes on one card, where NCCL refuses two ranks on
one device); the kernel engine stages its exchange through the host
(``ops.delta_sharded_kernels.ProcessShardedEngine``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..encoder import resolve_device
from ..host import preprocess
from ..models.state import BPEState, BpeConfig, check_config
from ..ops.train_delta import _fit_table, _next_pow2, _pcap_budget
from ..ops.train_sparse import _host_table_tomb
from ..ops.train_stream import PAD, flatten_word_buckets
from ..train import rename_tokens
from .mesh import DataMesh, default_mesh
from .train_delta_sharded import PlainShardedEngine, _shard_stream, delta_cap


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    **kwargs,
) -> None:
    """Join the default process group (idempotent).  With no arguments
    torchrun's ``env://`` variables drive it (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with them, process
    ``process_id`` of ``num_processes`` meets the others at
    ``coordinator_address`` (``host:port``)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, **kwargs,
        )


class HostGather:
    """``all_gather`` of host tensors over the default process group, in
    rank order, with the calls, the bytes gathered (every rank's payload,
    this one's included) and the seconds spent counted."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def fixed(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape and dtype everywhere), stacked on
        a new leading axis."""
        t = t.detach().cpu().contiguous()
        out = torch.empty((self.world, *t.shape), dtype=t.dtype)
        t0 = time.perf_counter()
        dist.all_gather(list(out.unbind(0)), t)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        return out

    def var(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's 1-D ``t`` (lengths may differ): the sizes first,
        then the payloads padded to the largest."""
        t = t.detach().cpu().reshape(-1)
        sizes = self.fixed(torch.tensor([t.numel()], dtype=torch.int64)).reshape(-1).tolist()
        pad = torch.zeros(max(max(sizes), 1), dtype=t.dtype)
        pad[: t.numel()] = t
        got = self.fixed(pad)
        return [got[r, :n] for r, n in enumerate(sizes)]

    def cat(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """This rank's ``parts`` concatenated, then every rank's in rank
        order, on the device of ``parts[0]``."""
        mine = torch.cat(parts)
        return torch.cat(self.var(mine)).to(mine.device)

    def max(self, n: int) -> int:
        return int(self.fixed(torch.tensor([n], dtype=torch.int64)).max())


class GlobalMesh:
    """The shards of every process: ``local``, this rank's data mesh, and
    ``counts``, each rank's shard count.  The global order is the ranks'
    shards in rank order: local shard i is global shard ``offset + i``."""

    def __init__(self, local: DataMesh, counts: List[int], rank: int):
        self.local = local
        self.counts = list(counts)
        self.offset = sum(self.counts[:rank])


def global_mesh(mesh: Optional[DataMesh] = None, device=None,
                comm: Optional[HostGather] = None) -> GlobalMesh:
    """This rank's data mesh (``mesh``; else every visible device of
    ``device``'s kind, or ``device`` alone) with every rank's shard count,
    gathered once."""
    if mesh is None:
        dev = resolve_device(device)
        mesh = default_mesh(dev) or DataMesh([dev])
    comm = comm or HostGather()
    counts = comm.fixed(torch.tensor([mesh.size], dtype=torch.int64)).reshape(-1).tolist()
    return GlobalMesh(mesh, counts, comm.rank)


# -- host folds across the processes (deterministic: rank order) -------------


def _allgather_var(arr: np.ndarray, comm: HostGather) -> List[np.ndarray]:
    """Every rank's 1-D array (lengths may differ), in rank order."""
    return [p.numpy() for p in comm.var(torch.from_numpy(np.ascontiguousarray(arr)))]


def _global_alphabet(cps: np.ndarray, comm: HostGather):
    """The global character counts (the same in every process): every
    rank's local counts gathered and folded, as the reference merges its
    threads' character counts (bpe.cpp:1013-1021).  Returns (unique
    characters, counts, characters in all)."""
    uniq, cnt, data_len = preprocess.char_frequencies(cps)
    parts_u = _allgather_var(uniq.astype(np.int64), comm)
    parts_c = _allgather_var(cnt.astype(np.int64), comm)
    dl = int(comm.fixed(torch.tensor([data_len], dtype=torch.int64)).sum())
    gu, inv = np.unique(np.concatenate(parts_u), return_inverse=True)
    gc = np.zeros(gu.size, np.int64)
    np.add.at(gc, inv, np.concatenate(parts_c))
    return gu.astype(uniq.dtype), gc, dl


def _fold_global_table(t_loc: np.ndarray, w_loc: np.ndarray, gfreq: np.ndarray,
                       comm: HostGather):
    """The exact global pair-count table from every rank's stream shard
    (word ids global, weights ``gfreq``): sorted uint64 keys and int32
    counts."""
    lk, lc = _host_table_tomb(t_loc, w_loc, gfreq)
    ak = np.concatenate(_allgather_var(lk.astype(np.uint64).view(np.int64), comm))
    ac = np.concatenate(_allgather_var(lc.astype(np.int64), comm))
    gk, inv = np.unique(ak.view(np.uint64), return_inverse=True)
    gcnt = np.zeros(gk.size, np.int64)
    np.add.at(gcnt, inv, ac)
    return gk, gcnt.astype(np.int32)


class PlainProcessEngine(PlainShardedEngine):
    """Segments of ``train_rounds_delta_sharded`` over this rank's shards,
    its ``all_gather`` and ``pmax`` the processes' collectives, with the
    JAX host loop's ``pcap`` and overflow retry (the exact global table
    folded from every rank's live stream) and no re-pack (the JAX host loop
    has none)."""

    def __init__(self, *args, comm: HostGather):
        super().__init__(*args)
        self.comm = comm
        self.repack = False
        self.gather = comm.cat
        self.pmax = lambda flags: comm.max(max(flags))

    def regrow(self):
        self.pcap *= 2
        if self.comm.rank == 0:
            print(f"pair-count table overflow: retrying with pcap={self.pcap}", file=sys.stderr)
        t, wid, freq = (x.cpu().numpy() for x in self.stream())
        gk, gcv = _fold_global_table(t, wid, freq, self.comm)
        while self.pcap < gk.size:
            self.pcap *= 2
        self.tk, self.tc = _fit_table(gk, gcv, self.pcap, self.home)


def train_from_codepoints_distributed(
    local_cps: np.ndarray,
    vocab_size: int,
    config: Optional[BpeConfig] = None,
    batch_k: int = 16,
    progress_every: int = 0,
    *,
    device=None,
    mesh: Optional[DataMesh] = None,
    plain: bool = False,
) -> BPEState:
    """Train over the corpus formed by every process's ``local_cps`` (split
    at word boundaries by the caller, in rank order); returns the same
    BPEState in every process, bit-identical to one-process training on the
    concatenated corpus.  ``mesh`` is this rank's data mesh (default: every
    visible device of ``device``'s kind, or ``device`` alone; ``device``
    defaults to the card, and raises without one).  The kernels run the
    rounds (``ProcessShardedEngine``); ``plain`` runs the plain round loop
    of the JAX program instead.  Only rank 0 prints, the JAX host loop's
    lines."""
    config = check_config(config or BpeConfig(), vocab_size)
    special = config.special_tokens
    n_specials = special.n_special_tokens()
    comm = HostGather()
    rank = comm.rank
    gmesh = global_mesh(mesh, device, comm)

    gu, gc, data_len = _global_alphabet(local_cps, comm)
    if rank == 0:
        print(f"number of unique characters in the training data: {gu.size}", file=sys.stderr)
    alphabet = preprocess.build_alphabet(gu, gc, data_len, config.character_coverage, n_specials)
    used_ids0 = len(alphabet.char2id) + n_specials
    if used_ids0 > vocab_size:
        raise ValueError(
            "Incorrect arguments. Vocabulary size too small. Set vocab_size>="
            + str(used_ids0)
            + ".  Current value for vocab_size="
            + str(vocab_size)
        )

    # local words against the global alphabet; word ids offset by the
    # ranks before this one, so that the frequencies index globally
    buckets = preprocess.training_word_buckets(local_cps, alphabet)
    t, wid, freq = flatten_word_buckets(buckets)
    seg_t, seg_w, per = _shard_stream(t, wid, gmesh.local.size)
    # word counts, padded shard lengths, live tokens and stream lengths
    sizes = comm.fixed(torch.tensor(
        [freq.size, per, int((wid >= 0).sum()), t.size], dtype=torch.int64)).numpy()
    wbase = int(sizes[:rank, 0].sum())
    wid = np.where(wid >= 0, wid + wbase, wid).astype(np.int32)
    seg_w = np.where(seg_w >= 0, seg_w + wbase, seg_w).astype(np.int32)
    gfreq = np.concatenate(_allgather_var(freq.astype(np.int32), comm)).astype(np.int32)

    # every rank's shards padded to the common length
    gper = int(sizes[:, 1].max())
    if gper > per:
        pad_t = np.full((gmesh.local.size, gper), PAD, np.int32)
        pad_w = np.full((gmesh.local.size, gper), PAD, np.int32)
        pad_t[:, :per] = seg_t
        pad_w[:, :per] = seg_w
        seg_t, seg_w = pad_t, pad_w
    dcap = delta_cap(gper)
    rules = np.full((vocab_size, 4), -1, np.int32)
    if plain:
        uk, uc = _fold_global_table(t, wid, gfreq, comm)
        m_live = int(sizes[:, 2].sum())
        pcap = int(os.environ.get("YTTM_TRAIN_PCAP", "0")) or min(
            _pcap_budget(uk.size, vocab_size - used_ids0), _next_pow2(m_live)
        )
        engine = PlainProcessEngine(
            seg_t, seg_w, gper, gfreq, rules, used_ids0, vocab_size, batch_k, gmesh.local, pcap,
            dcap, (uk, uc), comm=comm,
        )
    else:
        from ..ops.delta_sharded_kernels import ProcessShardedEngine

        engine = ProcessShardedEngine(
            seg_t, seg_w, gper, gfreq, rules, used_ids0, vocab_size, batch_k, gmesh.local, dcap,
            int(sizes[:, 3].sum()), comm, gmesh.counts,
        )

    # the JAX host loop's loop (youtokentome_tpu/parallel/distributed.py:253-308)
    used = used_ids0
    seg = min(x for x in (progress_every, vocab_size) if x)
    t_start = time.time()
    while used < vocab_size:
        limit = min(vocab_size, used + seg)
        used, done, overflow = engine.segment(used, limit)
        if overflow:
            engine.regrow()
            continue
        if progress_every and rank == 0:
            n_merges = used - used_ids0
            dt = time.time() - t_start
            print(
                f"id: {used}/{vocab_size}  merges: {n_merges}  "
                f"({dt:.1f}s, {n_merges / max(dt, 1e-9):.0f} merges/s)",
                file=sys.stderr,
            )
        if done:
            break

    n = used - used_ids0
    if n < vocab_size - used_ids0 and rank == 0:
        print(f"WARNING merged only: {used} pairs of tokens", file=sys.stderr)
    learned = [tuple(map(int, r)) for r in engine.rules[:n, :3].cpu().numpy()]
    char2id, learned = rename_tokens(alphabet.char2id, learned, special, vocab_size)
    return BPEState(char2id=char2id, rules=learned, special_tokens=special)
