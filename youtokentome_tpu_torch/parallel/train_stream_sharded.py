"""Data-parallel flat-stream (v1) BPE training over a data mesh.

PyTorch counterpart of ``youtokentome_tpu/parallel/train_stream_sharded.py``:
the deduplicated-word token stream is split across the mesh at word
boundaries (``train_delta_sharded._shard_stream``, the JAX package's
split); each round every shard's pair keys are gathered and counted into
one replicated count, the tie-ordered top-k and the prefix acceptance run
on every replica, and the accepted merges are applied shard-locally, each
shard front-compacting its own stream.

``train_rounds_stream_sharded`` is the plain version of the JAX program
``_train_sharded``, branch for branch: its ``all_gather`` is a
``torch.cat`` of the shards' pair keys in shard order.  By default
``run_training_stream_sharded`` runs the rounds through the kernels of
``ops/recount_sharded_kernels.py`` (hand-written CUDA on the cards, their
plain versions on the CPU); ``plain=True`` runs the plain loop.  Both give
the rules of the one-device trainer at any shard count.  Like the JAX
host loop it prints no progress and writes no checkpoint.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from ..ops.train_stream import (
    _segment_counts_flat,
    _topk_candidates,
    accept_prefix,
    apply_accepted,
    flatten_word_buckets,
    learned_rules,
    pair_keys_and_weights,
    run_to_end,
    store_rules,
)
from .mesh import DataMesh, data_mesh
from .train_delta_sharded import _shard_stream


def train_rounds_stream_sharded(ts, wids, freqs, rules, used, used_ids0, limit, vocab_size,
                                batch_k=16):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)`` or no
    candidate is accepted (done).

    Plain torch version of the JAX ``_train_sharded``: ``ts``/``wids`` hold
    each shard's front-compacted stream ([per] int32, on the shard's
    device), ``freqs`` the replicated word frequencies (one a shard);
    ``rules`` (updated in place) lives on one device, where the gathered
    keys are counted.  Returns (ts, wids, used, done, the last round's
    count (cnt, xs, ys) or None)."""
    used = int(used)
    home = rules.device
    done = False
    count = None
    while not done and used < min(vocab_size, int(limit)):
        parts = [pair_keys_and_weights(t, w, f) for t, w, f in zip(ts, wids, freqs)]
        kx, ky, w = (torch.cat([p[i].to(home) for p in parts]) for i in range(3))
        count = _segment_counts_flat(kx, ky, w)
        cc, cx, cy = _topk_candidates(*count, batch_k)
        acc, zs, n_acc = accept_prefix(cc, cx, cy, used, vocab_size, batch_k)
        done = n_acc == 0
        if n_acc:  # with nothing accepted the compacted streams stay as they are
            for d, (t, wid) in enumerate(zip(ts, wids)):
                a, x, y, z = (v.to(t.device) for v in (acc, cx, cy, zs))
                ts[d], wids[d] = apply_accepted(t, wid, a, x, y, z)
        store_rules(rules, acc, cx, cy, cc, zs, int(used_ids0), vocab_size)
        used += n_acc
    return ts, wids, used, done, count


class PlainStreamShardedEngine:
    """Segments of ``train_rounds_stream_sharded`` (never an overflow: the
    count is gathered afresh every round); ``count`` keeps the last round's
    count."""

    count = None

    def __init__(self, seg_t, seg_w, freq, rules, used_ids0: int, vocab_size: int, batch_k: int,
                 mesh: DataMesh):
        self.vocab_size, self.used_ids0, self.batch_k = vocab_size, used_ids0, batch_k
        self.ts = [torch.from_numpy(seg_t[d]).to(dev) for d, dev in enumerate(mesh.devices)]
        self.ws = [torch.from_numpy(seg_w[d]).to(dev) for d, dev in enumerate(mesh.devices)]
        freq = torch.from_numpy(np.ascontiguousarray(freq, np.int32))
        self.freqs = [freq.to(dev) for dev in mesh.devices]
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(mesh.devices[0])

    def segment(self, used: int, limit: int):
        self.ts, self.ws, used, done, count = train_rounds_stream_sharded(
            self.ts, self.ws, self.freqs, self.rules, used, self.used_ids0, limit,
            self.vocab_size, self.batch_k,
        )
        self.count = count or self.count
        return used, done, False


def make_engine(buckets, used_ids0: int, vocab_size: int, mesh: DataMesh, batch_k: int = 16,
                plain: bool = False):
    """The engine that the host loop drives over ``mesh``: the flattened
    stream split as the JAX driver splits it, then the plain round loop
    (``plain``) or the kernel engine."""
    t, wid, freq = flatten_word_buckets(buckets)
    seg_t, seg_w, _ = _shard_stream(np.asarray(t), np.asarray(wid), mesh.size)
    rules = np.full((vocab_size, 4), -1, dtype=np.int32)
    if plain:
        return PlainStreamShardedEngine(seg_t, seg_w, freq, rules, used_ids0, vocab_size,
                                        batch_k, mesh)
    from ..ops.recount_sharded_kernels import StreamShardedKernelEngine

    return StreamShardedKernelEngine(seg_t, seg_w, freq, rules, used_ids0, vocab_size, batch_k,
                                     mesh, int(np.asarray(t).shape[0]))


def run_training_stream_sharded(
    buckets,
    used_ids0: int,
    vocab_size: int,
    mesh: DataMesh | None = None,
    batch_k: int = 16,
    plain: bool = False,
) -> List[Tuple[int, int, int]]:
    """Rules of the one-device trainer at any shard count.  ``mesh``
    defaults to every visible card; ``plain`` picks the plain round loop
    over the kernels."""
    mesh = mesh or data_mesh()
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    engine = make_engine(buckets, used_ids0, vocab_size, mesh, batch_k, plain)
    used = run_to_end(engine, used_ids0, vocab_size)
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
