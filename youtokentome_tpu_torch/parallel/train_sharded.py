"""Data-parallel bucketed (v0) BPE training over a data mesh.

PyTorch counterpart of ``youtokentome_tpu/parallel/train_sharded.py``: each
length bucket's rows are split across the mesh (``shard_rows``, padded with
PAD rows of frequency 0 to a multiple of the shard count, then cut into
contiguous row blocks, as the JAX host wrapper lays them out); each round
every shard's pair arrays are gathered and counted into one replicated
count, the tie-broken argmax is taken on every replica, and the one merge
is applied to every shard's rows.

``train_rounds_sharded`` is the plain version of the JAX program
``_train_rounds_sharded``, branch for branch: its ``all_gather`` is a
``torch.cat`` of the shards' pair arrays in shard order.  By default
``run_training_sharded`` runs the rounds through the kernels of
``ops/recount_sharded_kernels.py`` (hand-written CUDA on the cards, their
plain versions on the CPU); ``plain=True`` runs the plain loop.  Both give
the rules of the one-device trainer at any shard count.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.segment import apply_merge_rows
from ..ops.train_kernel import _argmax_tiebreak, _pair_arrays, _segment_counts
from ..ops.train_stream import learned_rules, run_to_end
from .mesh import DataMesh, data_mesh


def shard_rows(buckets, n_dev: int):
    """Each shard's list of (tokens, freq) row blocks: every bucket padded
    with PAD rows of frequency 0 to a multiple of ``n_dev`` rows and cut
    into ``n_dev`` contiguous blocks (numpy)."""
    shards = [[] for _ in range(n_dev)]
    for toks, freq in buckets:
        toks, freq = np.asarray(toks, np.int32), np.asarray(freq, np.int32)
        w = toks.shape[0]
        wp = -(-w // n_dev) * n_dev
        if wp != w:
            toks = np.concatenate([toks, np.full((wp - w, toks.shape[1]), -1, np.int32)])
            freq = np.concatenate([freq, np.zeros(wp - w, np.int32)])
        per = wp // n_dev
        for d in range(n_dev):
            shards[d].append((toks[d * per : (d + 1) * per], freq[d * per : (d + 1) * per]))
    return shards


def train_rounds_sharded(shards, rules, used: int, used_ids0: int, limit: int, vocab_size: int):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)`` or no
    pair is left (done).

    Plain torch version of the JAX ``_train_rounds_sharded``: ``shards``
    holds each shard's list of (tokens [Wb/N, Lb] int32, freq int32) on the
    shard's device; ``rules`` (updated in place) lives on one device, where
    the gathered pairs are counted.  Returns (shards, used, done, the last
    round's count (cnt, xs, ys) or None)."""
    used = int(used)
    home = rules.device
    done = False
    count = None
    while used < min(vocab_size, int(limit)):
        parts = [_pair_arrays(t, f) for bks in shards for t, f in bks]
        kx, ky, wf = (torch.cat([p[i].to(home) for p in parts]) for i in range(3))
        count = _segment_counts(kx, ky, wf)
        c, xb, yb = _argmax_tiebreak(*count)
        if c <= 0:
            done = True
            break
        shards = [[(apply_merge_rows(t, xb, yb, used), f) for t, f in bks] for bks in shards]
        rules[used - used_ids0] = torch.tensor([xb, yb, used, c], dtype=torch.int32)
        used += 1
    return shards, used, done, count


class PlainBucketedShardedEngine:
    """Segments of ``train_rounds_sharded`` (no table to overflow);
    ``count`` keeps the last round's count."""

    count = None

    def __init__(self, shard_buckets, rules, used_ids0: int, vocab_size: int, mesh: DataMesh):
        self.used_ids0, self.vocab_size = used_ids0, vocab_size
        self.shards = [
            [(torch.from_numpy(t).to(dev), torch.from_numpy(f).to(dev)) for t, f in bks]
            for bks, dev in zip(shard_buckets, mesh.devices)
        ]
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(mesh.devices[0])

    def segment(self, used: int, limit: int):
        self.shards, used, done, count = train_rounds_sharded(
            self.shards, self.rules, used, self.used_ids0, limit, self.vocab_size
        )
        self.count = count or self.count
        return used, done, False


def make_engine(buckets, used_ids0: int, vocab_size: int, mesh: DataMesh, plain: bool = False):
    """The engine that the host loop drives over ``mesh``: the rows split
    by ``shard_rows``, then the plain round loop (``plain``) or the kernel
    engine."""
    shard_buckets = shard_rows(buckets, mesh.size)
    rules = np.full((vocab_size, 4), -1, dtype=np.int32)
    if plain:
        return PlainBucketedShardedEngine(shard_buckets, rules, used_ids0, vocab_size, mesh)
    from ..ops.recount_sharded_kernels import BucketedShardedKernelEngine

    return BucketedShardedKernelEngine(shard_buckets, rules, used_ids0, vocab_size, mesh)


def run_training_sharded(
    buckets: Sequence[Tuple[np.ndarray, np.ndarray]],
    used_ids0: int,
    vocab_size: int,
    mesh: DataMesh | None = None,
    plain: bool = False,
) -> List[Tuple[int, int, int]]:
    """Rules of the one-device trainer at any shard count.  ``mesh``
    defaults to every visible card; ``plain`` picks the plain round loop
    over the kernels."""
    mesh = mesh or data_mesh()
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    engine = make_engine(buckets, used_ids0, vocab_size, mesh, plain)
    used = run_to_end(engine, used_ids0, vocab_size)
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
