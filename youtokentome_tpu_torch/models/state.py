"""BPE model state, configuration, and the `.yttm` text codec.

TPU-native re-implementation of the reference model-state layer
(reference: youtokentome/cpp/utils.{h,cpp}).  The on-disk format is
byte-compatible with the reference so conformance tests can load models
produced by either implementation:

    n_chars n_rules\n
    <codepoint> <id>\n      x n_chars   (any order)
    <x> <y> <z>\n           x n_rules   (in merge order; rank = line index)
    <unk> <pad> <bos> <eos>\n

(reference dump/load: utils.cpp:50-91; specials order unk pad bos eos:
utils.cpp:10-17.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# U+2581 LOWER ONE EIGHTH BLOCK, the space meta-symbol (utils.h:9).
SPACE_TOKEN = 9601

# Sentinel for invalid UTF-8 input (utf8.h:9).
INVALID_UNICODE = 0x0FFFFFFF

# Literal rendering of special tokens (bpe.h:12-15).
UNK_TOKEN = "<UNK>"
PAD_TOKEN = "<PAD>"
BOS_TOKEN = "<BOS>"
EOS_TOKEN = "<EOS>"

# ASCII whitespace accepted by the reference: C isspace() in the C locale
# for ch < 256, plus the space meta-symbol (utils.cpp:99-101).
_ASCII_SPACES = frozenset({9, 10, 11, 12, 13, 32})


def is_space(ch: int) -> bool:
    """True for chars treated as word separators (utils.cpp:99-101)."""
    return ch in _ASCII_SPACES or ch == SPACE_TOKEN


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Reserved ids; -1 means "absent" (utils.h:24-43)."""

    pad_id: int = -1
    unk_id: int = -1
    bos_id: int = -1
    eos_id: int = -1

    def n_special_tokens(self) -> int:
        return sum(x != -1 for x in (self.pad_id, self.unk_id, self.bos_id, self.eos_id))

    def taken_id(self, idx: int) -> bool:
        return idx in (self.pad_id, self.unk_id, self.bos_id, self.eos_id)

    def max_id(self) -> int:
        return max(0, self.pad_id, self.unk_id, self.bos_id, self.eos_id)


@dataclasses.dataclass
class BpeConfig:
    """Training configuration (utils.h:45-54)."""

    character_coverage: float = 1.0
    n_threads: int = -1
    special_tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)


@dataclasses.dataclass
class BPEState:
    """A trained BPE model: alphabet, merge rules, special token ids.

    ``char2id`` maps unicode codepoint -> token id.  ``rules`` is the
    ordered merge table; rule k merges (x, y) -> z and has rank k.
    (reference: utils.h:66-74)
    """

    char2id: Dict[int, int] = dataclasses.field(default_factory=dict)
    rules: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    special_tokens: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)

    # ---- codec -----------------------------------------------------------

    def dumps(self) -> str:
        st = self.special_tokens
        lines = [f"{len(self.char2id)} {len(self.rules)}"]
        # Reference dump order is hash-map iteration order (unspecified);
        # we write sorted by id for reproducible files.  Loaders accept any
        # order.
        for cp, idx in sorted(self.char2id.items(), key=lambda kv: kv[1]):
            lines.append(f"{cp} {idx}")
        for x, y, z in self.rules:
            lines.append(f"{x} {y} {z}")
        lines.append(f"{st.unk_id} {st.pad_id} {st.bos_id} {st.eos_id}")
        return "\n".join(lines) + "\n"

    def dump(self, file_name: str) -> None:
        with open(file_name, "w") as fout:
            fout.write(self.dumps())

    @classmethod
    def loads(cls, text: str) -> "BPEState":
        toks = text.split()
        it = iter(toks)

        def nxt() -> int:
            try:
                return int(next(it))
            except StopIteration:
                raise ValueError("Truncated model file") from None

        n, m = nxt(), nxt()
        char2id: Dict[int, int] = {}
        for _ in range(n):
            cp = nxt()
            char2id[cp] = nxt()
        rules = [(nxt(), nxt(), nxt()) for _ in range(m)]
        st = SpecialTokens(unk_id=nxt(), pad_id=nxt(), bos_id=nxt(), eos_id=nxt())
        return cls(char2id=char2id, rules=rules, special_tokens=st)

    @classmethod
    def load(cls, file_name: str) -> "BPEState":
        try:
            with open(file_name, "r") as fin:
                text = fin.read()
        except OSError:
            raise ValueError("Can not open file with model: " + file_name) from None
        return cls.loads(text)

    # ---- derived views ---------------------------------------------------

    def vocab_size(self) -> int:
        """rules + alphabet + present specials (bpe.cpp:1692-1695)."""
        return len(self.rules) + len(self.char2id) + self.special_tokens.n_special_tokens()


def check_config(config: BpeConfig, vocab_size: int) -> BpeConfig:
    """Validate and normalise a training config (bpe.cpp:1295-1350).

    Returns a new config with n_threads resolved and clamped to [1, 8].
    Raises ValueError with reference-compatible messages.
    """
    import os

    cc = config.character_coverage
    if cc <= 0 or cc > 1:
        raise ValueError(
            "coverage value must be in the range (0, 1]. Current value of coverage = "
            + str(cc)
        )
    st = config.special_tokens
    if st.unk_id < 0 or st.unk_id >= vocab_size:
        raise ValueError(
            "unk_id: must be in the range [0, vocab_size - 1]. Current value of "
            f"vocab_size = {vocab_size}; unk_id = {st.unk_id}"
        )
    for name, val in (("pad_id", st.pad_id), ("bos_id", st.bos_id), ("eos_id", st.eos_id)):
        if val < -1 or val >= vocab_size:
            raise ValueError(
                f"{name} must be in the range [-1, vocab_size - 1]. Current value of "
                f"vocab_size = {vocab_size}; {name} = {val}"
            )
    present = [i for i in (st.pad_id, st.bos_id, st.eos_id) if i != -1] + [st.unk_id]
    if len(set(present)) != len(present):
        raise ValueError("All ids of special tokens must be different.")

    n_threads = config.n_threads
    if n_threads == -1:
        n_threads = os.cpu_count() or 1
    n_threads = min(8, max(1, n_threads))
    return BpeConfig(cc, n_threads, st)
