"""Reference-parity training stderr.

The reference prints the full training config at startup (print_config,
bpe.cpp:1352-1366) and a merge log line for every 1000th minted id *by
default* (bpe.cpp:1198-1219).  The trainers run their merge loop on
device in segments; the drivers hand each segment's accumulated rule
rows ([x, y, z, count] — store_rules keeps the accepted candidate's
exact count) to ``MergeLog``, which reconstructs the subword strings
incrementally on the host and prints the reference's exact format.

Opt out with YTTM_TRAIN_LOG=0.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np


def log_enabled() -> bool:
    return os.environ.get("YTTM_TRAIN_LOG", "1") != "0"


def print_config(input_path, model_path, vocab_size, config) -> None:
    """Mirror of print_config (bpe.cpp:1352-1366)."""
    if not log_enabled():
        return
    st = config.special_tokens
    err = sys.stderr
    print("Training parameters", file=err)
    print(f"  input: {input_path}", file=err)
    print(f"  model: {model_path}", file=err)
    print(f"  vocab_size: {vocab_size}", file=err)
    print(f"  n_threads: {config.n_threads}", file=err)
    # C++ std::cerr << double: minimal digits ("1", "0.9998")
    print(f"  character_coverage: {config.character_coverage:g}", file=err)
    print(f"  pad: {st.pad_id}", file=err)
    print(f"  unk: {st.unk_id}", file=err)
    print(f"  bos: {st.bos_id}", file=err)
    print(f"  eos: {st.eos_id}", file=err)
    print("", file=err)


class MergeLog:
    """The per-1000-ids merge log (bpe.cpp:1198-1219): drivers call the
    instance with the (device-fetched) rules array after each segment;
    new rows update the incremental recipe strings and every row whose
    id is a multiple of ``every`` prints

        id: z=x+y    freq: N    subword: sz=sx+sy

    with the reference's exact column padding."""

    def __init__(self, char2id: Dict[int, int], every: int = 1000):
        # internal base ids -> rendered characters (the space meta-symbol
        # U+2581 already holds its own id in char2id)
        self._s: Dict[int, str] = {
            int(i): chr(int(cp)) for cp, i in char2id.items()
        }
        self._seen = 0
        self.every = every

    def __call__(self, rules: np.ndarray, used: int) -> None:
        rules = np.asarray(rules)
        n = rules.shape[0]
        # rows are filled in order; stop at the first unfilled (-1) row
        for i in range(self._seen, n):
            x, y, z = int(rules[i, 0]), int(rules[i, 1]), int(rules[i, 2])
            if z < 0:
                break
            cnt = int(rules[i, 3]) if rules.shape[1] > 3 else -1
            sx = self._s.get(x, "")
            sy = self._s.get(y, "")
            sz = sx + sy
            self._s[z] = sz
            self._seen = i + 1
            if not log_enabled() or z % self.every != 0:
                continue
            line = f"id: {z}={x}+{y}"
            pad = len(str(z)) + 1 + len(str(x)) + 1 + len(str(y))
            line += " " * max(0, 26 - pad)
            line += f"freq: {cnt}"
            pad = 5 + len(str(cnt))
            line += " " * max(0, 15 - pad)
            line += f"  subword: {sz}={sx}+{sy}"
            print(line, file=sys.stderr)
