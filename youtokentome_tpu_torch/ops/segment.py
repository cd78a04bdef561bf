"""Row primitives of the encode merge round, in plain torch.

PyTorch counterparts of ``youtokentome_tpu/ops/segment.py``:

* ``select_leftmost_nonoverlapping`` turns a "this adjacent pair
  matches" mask into the subset a left-to-right non-overlapping scan
  would merge (even offsets inside each run of consecutive hits, the
  floor(run/2) rule for equal pairs);
* ``compact_rows`` front-packs the surviving tokens of each row.

The CUDA encode kernel does both inside a thread block; these are its
plain versions.
"""

from __future__ import annotations

import torch

PAD = -1  # padding slot in token tensors


def select_leftmost_nonoverlapping(hit: torch.Tensor) -> torch.Tensor:
    """Subset of ``hit`` [B, N] a left-to-right non-overlapping scan takes:
    positions whose offset from the start of their run of consecutive
    hits is even."""
    idx = torch.arange(hit.shape[-1], device=hit.device).expand_as(hit)
    nonhit_idx = torch.where(hit, torch.full_like(idx, -1), idx)
    last_nonhit = torch.cummax(nonhit_idx, dim=-1).values
    offset = idx - last_nonhit - 1
    return hit & (offset % 2 == 0)


def compact_rows(vals: torch.Tensor, keep: torch.Tensor, pad_val: int = PAD) -> torch.Tensor:
    """Stable front-pack of ``vals[keep]`` per row; tail filled with pad."""
    b, n = vals.shape
    cs = torch.cumsum(keep.to(torch.int64), dim=1)
    dest = torch.where(keep, cs - 1, torch.full_like(cs, n))  # dropped -> slot n
    out = torch.full((b, n + 1), pad_val, dtype=vals.dtype, device=vals.device)
    out.scatter_(1, dest, torch.where(keep, vals, torch.full_like(vals, pad_val)))
    return out[:, :n]
