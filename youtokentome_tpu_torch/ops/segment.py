"""Row primitives of the encode merge round, in plain torch.

PyTorch counterparts of ``youtokentome_tpu/ops/segment.py``:

* ``select_leftmost_nonoverlapping`` turns a "this adjacent pair
  matches" mask into the subset a left-to-right non-overlapping scan
  would merge (even offsets inside each run of consecutive hits, the
  floor(run/2) rule for equal pairs);
* ``pair_count_mask`` says which adjacent positions count for pair
  statistics (the same rule for runs of equal tokens);
* ``compact_rows`` front-packs the surviving tokens of each row;
* ``apply_merge_rows`` merges one pair in every row (the v0 trainer's
  apply).

The CUDA encode kernel does the first and third inside a thread block, and
``csrc/train_bucketed.cu`` the last two a warp a row; these are their
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


def pair_count_mask(left: torch.Tensor, right: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Which adjacent positions count for pair statistics: inside a run of
    equal tokens only even offsets count (the reference skips i+1 whenever
    v[i] == v[i+1] == v[i+2]); pairs of unequal tokens always count."""
    eq = (left == right) & valid
    return valid & (~eq | select_leftmost_nonoverlapping(eq))


def apply_merge_rows(tokens: torch.Tensor, x, y, z) -> torch.Tensor:
    """Merge occurrences of pair (x, y) -> z in each row [B, L], left to
    right and non-overlapping, then front-pack each row."""
    left = tokens[:, :-1]
    right = tokens[:, 1:]
    valid = (left != PAD) & (right != PAD)
    sel = select_leftmost_nonoverlapping(valid & (left == x) & (right == y))
    pad = torch.zeros((tokens.shape[0], 1), dtype=torch.bool, device=tokens.device)
    sel_l = torch.cat([sel, pad], dim=1)  # aligned with token i
    sel_r = torch.cat([pad, sel], dim=1)  # aligned with token i + 1
    merged = torch.where(sel_l, torch.full_like(tokens, int(z)), tokens)
    return compact_rows(merged, ~sel_r & (tokens != PAD))
