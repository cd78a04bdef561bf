"""Open-addressing hash map for (uint32, uint32) -> int32 rule ranks.

PyTorch counterpart of ``youtokentome_tpu/ops/hashmap.py``.  The table
is built on the host with numpy, exactly as the JAX package builds it
(same ``_mix`` hash, same wave-wise linear-probe insertion, same
capacity), so both packages hold bit-identical tables.  The device copy
lives in a ``PairTable`` of torch tensors on the chosen device; the CUDA
encode kernel (``csrc/encode_greedy.cu``) probes it directly, and
``PairTable.lookup`` is the plain torch version of that probe.

Key layout: ``kx``/``ky`` hold the uint32 keys as int32 tensors with the
same bits (EMPTY_KEY 0xFFFFFFFF reads as -1), since torch has no
arithmetic on uint32.  Key equality on int32 bits is uint32 equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EMPTY_KEY = np.uint32(0xFFFFFFFF)
MISS = np.int32(0x7FFFFFFF)

_M32 = 0xFFFFFFFF


def _mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cheap avalanche hash of a key pair (murmur-style finalizer), on
    numpy uint32 arrays; wraps modulo 2**32."""
    x = x * np.uint32(0x9E3779B1)
    y = y * np.uint32(0x85EBCA77)
    h = (x ^ y) + np.uint32(0x165667B1)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x2545F491)
    h = h ^ (h >> np.uint32(13))
    return h


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), with no int64
    overflow: the 16-bit halves of ``a`` times a 32-bit constant stay
    below 2**48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return ((((hi * c) & _M32) << 16) + lo * c) & _M32


def mix_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``_mix`` in int64 torch arithmetic (torch on the CPU has no ``>>``
    on uint32).  ``x``/``y`` are int64 in [0, 2**32); returns int64 in
    [0, 2**32) equal to numpy's uint32 ``_mix``."""
    x = _mulmod32(x, 0x9E3779B1)
    y = _mulmod32(y, 0x85EBCA77)
    h = ((x ^ y) + 0x165667B1) & _M32
    h = h ^ (h >> 15)
    h = _mulmod32(h, 0x2545F491)
    return h ^ (h >> 13)


@dataclasses.dataclass
class PairTable:
    """Pair -> value map on one device.  ``kx``/``ky``/``val`` are int32
    tensors of length ``cap`` (a power of two); ``max_probes`` is the
    longest probe sequence any key needed at build time."""

    kx: torch.Tensor
    ky: torch.Tensor
    val: torch.Tensor
    max_probes: int
    cap: int

    def lookup(self, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
        """Vectorized lookup over int32 tensors of any shape; absent keys
        return MISS.  Negative queries never match (stored keys are
        < 2**31)."""
        h = mix_torch(qx.long() & _M32, qy.long() & _M32)
        out = torch.full(qx.shape, int(MISS), dtype=torch.int32, device=qx.device)
        found = torch.zeros(qx.shape, dtype=torch.bool, device=qx.device)
        for p in range(self.max_probes):
            slot = (h + p) & (self.cap - 1)
            tkx = self.kx[slot]
            hit = ~found & (tkx == qx) & (self.ky[slot] == qy) & (tkx != -1)
            out = torch.where(hit, self.val[slot], out)
            found |= hit
        return out


def build_pair_table_np(keys_x, keys_y, values, min_cap: int = 16):
    """Host-side construction (numpy), identical to the JAX package's
    ``build_pair_table``.  Keys must be unique pairs.  Returns
    (kx uint32, ky uint32, val int32, max_probes, cap)."""
    keys_x = np.asarray(keys_x, dtype=np.uint32)
    keys_y = np.asarray(keys_y, dtype=np.uint32)
    values = np.asarray(values, dtype=np.int32)
    n = keys_x.size
    cap = max(min_cap, 1 << int(np.ceil(np.log2(max(1, 2 * n)))))
    kx = np.full(cap, EMPTY_KEY, dtype=np.uint32)
    ky = np.full(cap, EMPTY_KEY, dtype=np.uint32)
    val = np.zeros(cap, dtype=np.int32)
    maskv = cap - 1

    h = _mix(keys_x, keys_y).astype(np.int64) & maskv
    max_probes = 1
    probe = 0
    pending = np.arange(n)
    slots = h.copy()
    # Vectorized batched insertion: resolve collisions wave by wave.  No
    # key is ever removed, so every slot between a key's home slot and its
    # final slot is occupied: a probe may stop at the first empty slot.
    while pending.size:
        s = slots[pending]
        free = kx[s] == EMPTY_KEY
        # first pending key targeting each slot wins it if the slot is free
        _, first_idx = np.unique(s, return_index=True)
        winners_mask = np.zeros(pending.size, dtype=bool)
        winners_mask[first_idx] = True
        can_place = winners_mask & free
        placed = pending[can_place]
        ps = s[can_place]
        kx[ps] = keys_x[placed]
        ky[ps] = keys_y[placed]
        val[ps] = values[placed]
        rest = pending[~can_place]
        slots[rest] = (slots[rest] + 1) & maskv
        pending = rest
        probe += 1
        max_probes = max(max_probes, probe)
        if probe > cap:
            raise RuntimeError("hash table insertion failed (table full)")
    return kx, ky, val, int(max_probes), cap


def pair_table_from_numpy(kx, ky, val, max_probes: int, cap: int, device) -> PairTable:
    """Move host arrays (uint32 keys, int32 values) onto ``device``."""

    def dev(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32, copy=True)).to(device)

    return PairTable(dev(kx), dev(ky), dev(val), int(max_probes), int(cap))


def build_pair_table(keys_x, keys_y, values, device, min_cap: int = 16) -> PairTable:
    """Build on the host, then place the table on ``device``."""
    return pair_table_from_numpy(
        *build_pair_table_np(keys_x, keys_y, values, min_cap), device=device
    )
