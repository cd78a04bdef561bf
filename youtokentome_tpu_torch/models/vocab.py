"""Host-side vocabulary utilities: recipes, piece rendering, decode.

Mirrors BaseEncoder::fill_from_state and the id/subword conversion
surface (bpe.cpp:1667-1894).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .state import (
    BOS_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    SPACE_TOKEN,
    UNK_TOKEN,
    BPEState,
)


class Vocabulary:
    """Derived lookup tables for a trained model (bpe.cpp:1667-1690)."""

    def __init__(self, state: BPEState):
        self.state = state
        self.id2char: Dict[int, int] = {v: k for k, v in state.char2id.items()}
        self.rule2id: Dict[tuple, int] = {
            (x, y): i for i, (x, y, _) in enumerate(state.rules)
        }
        self.recipe: Dict[int, List[int]] = {i: [i] for i in self.id2char}
        for x, y, z in state.rules:
            self.recipe[z] = self.recipe[x] + self.recipe[y]
        # token id -> rendered piece (reference token2word, bpe.cpp:86-94)
        self.piece: Dict[int, str] = {
            tid: "".join(chr(self.id2char[t]) for t in r)
            for tid, r in self.recipe.items()
        }
        self.reversed_recipe: Dict[str, int] = {
            p: tid for tid, p in self.piece.items()
        }
        st = state.special_tokens
        self.reversed_recipe[BOS_TOKEN] = st.bos_id
        self.reversed_recipe[EOS_TOKEN] = st.eos_id

    def vocab_size(self) -> int:
        return self.state.vocab_size()

    def id_to_subword(self, idx: int, replace_space: bool = False) -> str:
        """bpe.cpp:1774-1807."""
        st = self.state.special_tokens
        n = self.vocab_size()
        if idx < 0 or idx >= n:
            raise ValueError(
                "id must be in the range [0, vocab_size - 1]. Current value: "
                f"vocab_size = {n}; id={idx};"
            )
        if idx == st.unk_id:
            return UNK_TOKEN
        if idx == st.pad_id:
            return PAD_TOKEN
        if idx == st.bos_id:
            return BOS_TOKEN
        if idx == st.eos_id:
            return EOS_TOKEN
        piece = self.piece.get(idx)
        if piece is None:
            # id holes happen when training stopped early but custom
            # special ids sit beyond the materialized range (the
            # reference hits a bare assert here, bpe.cpp:1797)
            raise ValueError(
                f"id {idx} is not materialized in this model: training "
                f"stopped early and left a hole below a custom special id"
            )
        if replace_space and piece and ord(piece[0]) == SPACE_TOKEN:
            return " " + piece[1:]
        return piece

    def subword_to_id(self, token: str) -> int:
        """bpe.cpp:1809-1826; unknown -> unk_id."""
        st = self.state.special_tokens
        if token == UNK_TOKEN:
            return st.unk_id
        if token == PAD_TOKEN:
            return st.pad_id
        if token == BOS_TOKEN:
            return st.bos_id
        if token == EOS_TOKEN:
            return st.eos_id
        return self.reversed_recipe.get(token, st.unk_id)

    def vocabulary(self) -> List[str]:
        """bpe.cpp:1884-1894."""
        return [self.id_to_subword(i) for i in range(self.vocab_size())]

    # -- vectorized decode -------------------------------------------------

    def _piece_table(self):
        """Lazy flat byte table of rendered pieces (replace_space=True,
        bpe.cpp:1798-1804): (bytes flat uint8, offsets int64)."""
        if not hasattr(self, "_pt_flat"):
            n = self.vocab_size()

            def render(i: int) -> bytes:
                try:
                    return self.id_to_subword(i, replace_space=True).encode()
                except ValueError:
                    return b""  # id hole (early stop below a custom special)

            blobs = [render(i) for i in range(n)]
            lens = np.fromiter((len(b) for b in blobs), dtype=np.int64, count=n)
            off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=off[1:])
            self._pt_flat = np.frombuffer(b"".join(blobs), dtype=np.uint8)
            self._pt_off = off
        return self._pt_flat, self._pt_off

    def decode_flat(
        self,
        flat_ids: np.ndarray,
        sentinel: int,
        ignore_ids: Optional[Iterable[int]] = None,
    ) -> bytes:
        """Decode a flat id stream with line sentinels to text bytes.

        Vectorized equivalent of per-line BaseEncoder::decode
        (bpe.cpp:1843-1861): pieces are concatenated per line and the
        first emitted piece's leading space is stripped.  Pieces never
        contain '\n' (newline is a space char and cannot enter the
        alphabet), so the per-line strip is a global replace.
        """
        flat, off = self._piece_table()
        ids = np.asarray(flat_ids, dtype=np.int64)
        is_sent = ids == sentinel
        real = ids[~is_sent]
        if real.size:
            lo, hi = int(real.min()), int(real.max())
            n = self.vocab_size()
            if lo < 0 or hi >= n:
                bad = lo if lo < 0 else hi
                raise ValueError(
                    "id must be in the range [0, vocab_size - 1]. Current value: "
                    f"vocab_size = {n}; id={bad};"
                )
        keep = ~is_sent
        if ignore_ids is not None:
            ig = np.asarray(sorted(set(ignore_ids)), dtype=np.int64)
            if ig.size:
                keep &= ~np.isin(ids, ig)
        # map: sentinels -> a virtual '\n' piece appended to the table
        nl_flat = np.concatenate([flat, np.frombuffer(b"\n", dtype=np.uint8)])
        nl_off = np.concatenate([off, off[-1:] + 1])
        nl_id = off.size - 1
        sel_ids = np.where(is_sent, nl_id, ids)[keep | is_sent]
        lens = nl_off[sel_ids + 1] - nl_off[sel_ids]
        total = int(lens.sum())
        starts = nl_off[sel_ids]
        row_off = np.cumsum(lens) - lens
        pos = np.arange(total, dtype=np.int64) - np.repeat(row_off, lens)
        out = nl_flat[np.repeat(starts, lens) + pos].tobytes()
        # strip one leading space per line (the reference strips the first
        # emitted piece's leading space, bpe.cpp:1854-1856)
        out = out.replace(b"\n ", b"\n")
        if out.startswith(b" "):
            out = out[1:]
        return out

    def decode_ids(
        self, ids: Sequence[int], ignore_ids: Optional[Iterable[int]] = None
    ) -> str:
        """bpe.cpp:1843-1861: concatenate pieces with the leading space of
        the first emitted piece stripped."""
        ignore = set(ignore_ids) if ignore_ids is not None else set()
        out: List[str] = []
        first = True
        for idx in ids:
            if idx in ignore:
                continue
            sub = self.id_to_subword(int(idx), replace_space=True)
            if first and sub.startswith(" "):
                sub = sub[1:]
            out.append(sub)
            first = False
        return "".join(out)
