"""Data-parallel greedy encoding over a data mesh.

PyTorch counterpart of ``youtokentome_tpu/parallel/encode_sharded.py``
(the reference's sentence-block fan-out, encode_parallel
bpe.cpp:1697-1738): the ``[B, L]`` word rows are cut into N equal slices
in row order, one per shard; the rule tables are replicated once on each
distinct device of the mesh (and kept); each shard merges its slice with
the greedy kernel (``csrc/encode_greedy.cu``, int32 or uint16 wire) on
its own device; the results are gathered in row order.  Rows are
independent, so no exchange is needed.  On the CPU the kernel's plain
version runs on each slice.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..ops.encode_kernel import EncoderTables, encode_greedy, encode_greedy_u16
from .mesh import DataMesh, data_mesh


def replicate(tables: EncoderTables, mesh: DataMesh) -> List[EncoderTables]:
    """``tables`` on each shard's device: copied once per distinct device
    and kept on ``tables`` for later calls."""
    cache = tables.__dict__.setdefault("_replicas", {})
    for dev in mesh.distinct():
        if dev not in cache:
            t = tables.table
            cache[dev] = EncoderTables(
                dataclasses.replace(t, kx=t.kx.to(dev), ky=t.ky.to(dev), val=t.val.to(dev)),
                tables.rules_z.to(dev),
                tables.n_rules,
            )
    return [cache[dev] for dev in mesh.devices]


def shard_rows(tokens: torch.Tensor, mesh: DataMesh) -> List[torch.Tensor]:
    """The N equal row slices of ``tokens`` (B must divide by N), each on
    its shard's device (asynchronous copies from pinned memory)."""
    n = mesh.size
    b = tokens.shape[0]
    if b % n:
        raise ValueError(f"{b} rows do not split into {n} equal shards")
    per = b // n
    out = []
    for d, dev in enumerate(mesh.devices):
        part = tokens[d * per : (d + 1) * per]
        if part.device != dev:
            if dev.type == "cuda" and part.device.type == "cpu":
                part = part.pin_memory().to(dev, non_blocking=True)
            else:
                part = part.to(dev)
        out.append(part.contiguous())
    return out


def encode_greedy_sharded(
    tables: EncoderTables, tokens: torch.Tensor, mesh: DataMesh
) -> List[torch.Tensor]:
    """Start a ``[B, L]`` int32 greedy encode with the rows sharded over
    the mesh; returns each shard's result on its device, without waiting
    (concatenated in shard order they are the rows in order)."""
    reps = replicate(tables, mesh)
    return [encode_greedy(t, part) for t, part in zip(reps, shard_rows(tokens, mesh))]


def encode_greedy_sharded_u16(
    tables: EncoderTables, tokens_u16: torch.Tensor, unk_id: int, mesh: DataMesh
) -> List[torch.Tensor]:
    """uint16-wire variant of ``encode_greedy_sharded`` (placeholders
    leave as ``unk_id``, PAD as 0xFFFF)."""
    reps = replicate(tables, mesh)
    return [
        encode_greedy_u16(t, part, unk_id)
        for t, part in zip(reps, shard_rows(tokens_u16, mesh))
    ]


def encode_batch_sharded(
    tables: EncoderTables, tokens: np.ndarray, mesh: DataMesh | None = None
) -> np.ndarray:
    """Greedy-encode an int32 ``[B, L]`` batch sharded over the mesh
    (dropout-free): B is padded with PAD rows to a multiple of the shard
    count, and the result sliced back to B rows."""
    mesh = mesh or data_mesh()
    n = mesh.size
    b, length = tokens.shape
    bp = -(-b // n) * n
    if bp != b:
        tokens = np.concatenate([tokens, np.full((bp - b, length), -1, dtype=tokens.dtype)])
    parts = encode_greedy_sharded(tables, torch.from_numpy(np.ascontiguousarray(tokens)), mesh)
    return np.concatenate([p.cpu().numpy() for p in parts])[:b]
