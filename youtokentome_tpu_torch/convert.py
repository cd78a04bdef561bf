"""Carry device state across from the JAX package, as numpy arrays.

The ``.yttm`` model is shared through the byte-identical codec
(``models/state.py``).  To hold both packages on the identical device
state, the tests hand the JAX package's arrays over as numpy arrays:
an encoder's ``EncoderTables`` (``np.asarray(t.table.kx)`` and so on) to
``tables_from_numpy``, and the delta trainer's state to
``train_state_from_numpy`` and ``table_keys_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.encode_kernel import EncoderTables
from .ops.hashmap import pair_table_from_numpy
from .ops.train_delta import PADKEY, _fit_table


def tables_from_numpy(
    kx, ky, val, max_probes: int, cap: int, rules_z, n_rules: int, device
) -> EncoderTables:
    """Build the port's ``EncoderTables`` on ``device`` from host arrays:
    ``kx``/``ky`` uint32 [cap], ``val`` int32 [cap], ``rules_z`` int32."""
    table = pair_table_from_numpy(kx, ky, val, max_probes, cap, device)
    z = torch.from_numpy(np.array(rules_z, dtype=np.int32, copy=True)).to(device)
    return EncoderTables(table, z, int(n_rules))


def train_state_from_numpy(t, wid, freq, uk, uc, rules, pcap: int, device):
    """The delta trainer's state for ``ops.train_delta.train_rounds_delta``
    on ``device``: the stream ``t``/``wid`` and ``freq`` (int32), the host
    count table ``uk`` (uint64 x << 32 | y) / ``uc`` (int32) of
    ``host_count_table`` laid out at ``pcap``, and ``rules`` [vocab, 4].
    Returns (t, wid, freq, tk, tc, rules) tensors."""

    def dev(a):
        return torch.from_numpy(np.array(a, dtype=np.int32, copy=True)).to(device)

    tk, tc = _fit_table(uk, uc, pcap, device)
    return dev(t), dev(wid), dev(freq), tk, tc, dev(rules)


def table_keys_from_numpy(*components) -> np.ndarray:
    """The JAX trainer's device key layout -> the port's int64 keys: one
    uint32 component ``x << 16 | y`` below vocab 65536, two components
    (x, y) above; all-ones components are padding (-> PADKEY)."""
    if len(components) == 1:
        k = np.asarray(components[0], np.uint32)
        pad = k == 0xFFFFFFFF
        keys = (k.astype(np.int64) >> 16) << 32 | (k.astype(np.int64) & 0xFFFF)
    else:
        x, y = (np.asarray(c, np.uint32) for c in components)
        pad = x == 0xFFFFFFFF
        keys = x.astype(np.int64) << 32 | y.astype(np.int64)
    return np.where(pad, np.int64(PADKEY), keys)
