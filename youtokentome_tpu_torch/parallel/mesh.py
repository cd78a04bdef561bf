"""Data mesh: the devices that the shards of a sharded program run on.

PyTorch counterpart of ``youtokentome_tpu/parallel/mesh.py``.  A JAX mesh
is one process driving N devices along the ``data`` axis; here one
process drives an ordered list of ``torch.device``s, one per shard, and
a sharded program splits its data in that order, keeps a replica of the
replicated state on each shard's device, and gathers in shard order.

A device may appear more than once: N shards on one card (or N shards on
the CPU, where the kernels' plain versions run) run the sharded program
with its exchange, without N cards.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch


class DataMesh:
    """The shards' devices, in shard order."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a data mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        types = {d.type for d in self.devices}
        if len(types) != 1 or types - {"cuda", "cpu"}:
            raise ValueError(f"a data mesh holds cuda or cpu devices of one kind, not {types}")
        self.devices = [
            torch.device("cuda", d.index if d.index is not None else 0) if d.type == "cuda" else d
            for d in self.devices
        ]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in first-appearance order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


def visible_devices(device: torch.device) -> List[torch.device]:
    """Every device of ``device``'s kind that this process sees: the
    cards ``cuda:0 .. cuda:n-1``, or the one CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def data_mesh(n: int | None = None, device=None) -> DataMesh:
    """A mesh over the first ``n`` (all, when None) visible devices of
    ``device``'s kind (``cuda`` when None)."""
    devices = visible_devices(torch.device(device or "cuda"))
    if n is not None:
        devices = devices[:n]
    return DataMesh(devices)


def default_mesh(device) -> DataMesh | None:
    """The mesh that training and encoding on ``device`` shard over by
    default: every visible device of its kind, at most ``YTTM_DEVICES``
    of them when that is set; None with one device (``YTTM_DEVICES=1``
    turns sharding off)."""
    devices = visible_devices(device)
    cap = int(os.environ.get("YTTM_DEVICES", "0"))
    if cap:
        devices = devices[:cap]
    return DataMesh(devices) if len(devices) > 1 else None
