"""The v0 bucketed trainer: one merge a round over length buckets.

PyTorch counterpart of ``youtokentome_tpu/ops/train_kernel.py``.  Words
arrive as length buckets ``[(tokens [Wb, Lb], freq [Wb]), ...]`` (PAD = -1).
Each round recounts every adjacent pair of every row (weighted by the
word's frequency, run parity inside runs of equal tokens), takes the
argmax under the reference's tie-break order (count descending, then
max(x, y), min(x, y) ascending, then x descending) and merges that pair in
every row.  This is the formulation the reference's stress test proves
equal to its own trainer.

``train_rounds`` is the plain round loop (any device); ``run_training``
is the host entry point, by default through the kernels of
``ops/bucketed_kernels.py`` (hand-written CUDA on a card, their plain
versions on the CPU).
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .segment import PAD, apply_merge_rows, pair_count_mask
from .train_stream import BIG, _segment_counts_flat, learned_rules, run_to_end

# _segment_counts_flat sorts the pair keys and totals each segment, as the
# JAX package's _segment_counts does for the bucketed pairs
_segment_counts = _segment_counts_flat


def _pair_arrays(tokens: torch.Tensor, freq: torch.Tensor):
    """Flattened (key_x, key_y, weight) of every adjacent position."""
    left = tokens[:, :-1]
    right = tokens[:, 1:]
    valid = (left != PAD) & (right != PAD)
    counted = pair_count_mask(left, right, valid)
    w = torch.where(counted, freq[:, None], torch.zeros_like(left)).to(torch.int32)
    big = torch.full_like(left, BIG)
    return torch.where(valid, left, big).reshape(-1), torch.where(valid, right, big).reshape(-1), w.reshape(-1)


def _argmax_tiebreak(cnt: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The reference's first candidate as four masked reductions:
    (count, x, y)."""
    c = cnt.max()
    mx = torch.maximum(x, y)
    mn = torch.minimum(x, y)
    big = torch.full_like(x, BIG)
    e1 = cnt == c
    m1 = torch.where(e1, mx, big).min()
    e2 = e1 & (mx == m1)
    m2 = torch.where(e2, mn, big).min()
    e3 = e2 & (mn == m2)
    xb = torch.where(e3, x, torch.full_like(x, -1)).max()
    return int(c), int(xb), int(m1 + m2 - xb)


def train_rounds(buckets, rules, used: int, used_ids0: int, limit: int, vocab_size: int):
    """Merge rounds until ``used`` reaches ``min(vocab_size, limit)`` or no
    pair is left (done).  Plain torch version of the JAX program, on any
    device: ``buckets`` a list of (tokens [Wb, Lb] int32, freq [Wb] int32),
    ``rules`` [vocab_size, 4] int32 (updated in place).  Returns (buckets,
    rules, used, done)."""
    used = int(used)
    done = False
    while used < min(vocab_size, int(limit)):
        parts = [_pair_arrays(t, f) for t, f in buckets]
        kx, ky, wf = (torch.cat([p[i] for p in parts]) for i in range(3))
        c, xb, yb = _argmax_tiebreak(*_segment_counts(kx, ky, wf))
        if c <= 0:
            done = True
            break
        buckets = [(apply_merge_rows(t, xb, yb, used), f) for t, f in buckets]
        rules[used - used_ids0] = torch.tensor([xb, yb, used, c], dtype=torch.int32)
        used += 1
    return buckets, rules, used, done


class PlainBucketedEngine:
    """Segments of ``train_rounds`` on the buckets (no table to overflow)."""

    def __init__(self, buckets, rules, used_ids0, vocab_size, device):
        self.used_ids0, self.vocab_size = used_ids0, vocab_size
        self.buckets = [
            (torch.from_numpy(np.array(t, np.int32)).to(device),
             torch.from_numpy(np.array(f, np.int32)).to(device))
            for t, f in buckets
        ]
        self.rules = torch.from_numpy(np.array(rules, np.int32)).to(device)

    def segment(self, used: int, limit: int):
        self.buckets, self.rules, used, done = train_rounds(
            self.buckets, self.rules, used, self.used_ids0, limit, self.vocab_size
        )
        return used, done, False


def run_training(
    buckets: Sequence[Tuple[np.ndarray, np.ndarray]],
    used_ids0: int,
    vocab_size: int,
    device=None,
    plain: bool = False,
) -> List[Tuple[int, int, int]]:
    """The learned (x, y, z) rule list (before the special-id renaming).
    Runs on ``cuda`` unless ``device`` asks for ``cpu``; ``plain`` picks
    the plain round loop over the kernels."""
    from ..encoder import resolve_device

    dev = resolve_device(device)
    if not buckets:
        print(f"WARNING merged only: {used_ids0} pairs of tokens", file=sys.stderr)
        return []
    rules = np.full((vocab_size, 4), -1, dtype=np.int32)
    if plain:
        engine = PlainBucketedEngine(buckets, rules, used_ids0, vocab_size, dev)
    else:
        from .bucketed_kernels import BucketedKernelEngine

        engine = BucketedKernelEngine(buckets, rules, used_ids0, vocab_size, dev)
    used = run_to_end(engine, used_ids0, vocab_size)
    return learned_rules(engine.rules, used, used_ids0, vocab_size)
