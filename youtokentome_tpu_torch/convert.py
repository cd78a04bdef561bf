"""Carry an encode table across from the JAX package.

The ``.yttm`` model is shared through the byte-identical codec
(``models/state.py``).  To hold both packages on the identical device
table, the tests hand the JAX package's ``EncoderTables`` arrays over as
numpy arrays (``np.asarray(t.table.kx)`` and so on) to
``tables_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.encode_kernel import EncoderTables
from .ops.hashmap import pair_table_from_numpy


def tables_from_numpy(
    kx, ky, val, max_probes: int, cap: int, rules_z, n_rules: int, device
) -> EncoderTables:
    """Build the port's ``EncoderTables`` on ``device`` from host arrays:
    ``kx``/``ky`` uint32 [cap], ``val`` int32 [cap], ``rules_z`` int32."""
    table = pair_table_from_numpy(kx, ky, val, max_probes, cap, device)
    z = torch.from_numpy(np.array(rules_z, dtype=np.int32, copy=True)).to(device)
    return EncoderTables(table, z, int(n_rules))
