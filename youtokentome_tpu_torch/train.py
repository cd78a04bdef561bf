"""End-to-end BPE training: host preprocessing + device merge rounds.

PyTorch counterpart of ``youtokentome_tpu/train.py``:

  read file -> UTF-8 decode (vectorized)            host    host/utf8.py
  char frequencies + coverage alphabet              host    host/preprocess.py
  word split + exact dedup + id mapping             host    host/preprocess.py
  merge rounds (one device, or a data mesh)         device  ops/train_*.py,
                                                            parallel/, kernels
  special-id renaming + model dump                  host    rename_tokens

Training runs on ``cuda`` unless the caller asks for ``cpu``; on the CPU
the kernels' plain torch versions run the rounds.  ``YTTM_TRAIN_IMPL``
picks the trainer as the JAX package does: ``auto`` (the v2 trainer
sharded over a data mesh of the cards when more than one is visible, at
most ``YTTM_DEVICES``, and the stream has ``YTTM_SHARD_MIN_TOKENS`` live
tokens; else the v5 tiered trainer at 2^22 or more live tokens, the v2
delta trainer below), ``tiered`` (v5), ``delta`` (v2), ``sparse`` (v3
tombstones; on the data mesh that ``auto`` would take, or on ``mesh=``,
the sharded v3 trainer), ``stream`` (v1, a full recount every round) and
``block`` (v4); any other value trains with v2.  All give the same rules;
v1, v3 and v4 are independent checks of v2 and v5.  The sharded v1 and v0
trainers (``parallel.train_stream_sharded``, ``parallel.train_sharded``)
are reached by their own entry points, as in the JAX package.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import progress
from .encoder import resolve_device
from .host import preprocess
from .host.utf8 import decode_utf8_bytes
from .models.state import BPEState, BpeConfig, SpecialTokens, check_config
from .ops.train_block import run_training_block
from .ops.train_delta import run_training_delta
from .ops.train_sparse import run_training_sparse
from .ops.train_stream import run_training_stream
from .ops.train_tiered import run_training_tiered
from .parallel.train_delta_sharded import run_training_delta_sharded
from .parallel.train_sparse_sharded import run_training_sparse_sharded

# live tokens at and above which ``auto`` takes the tiered trainer
# (youtokentome_tpu/train.py:136-144)
TIERED_MIN_TOKENS = 1 << 22


def _training_mesh(buckets, dev):
    """The data mesh that ``auto`` trains on (youtokentome_tpu/train.py:34-57):
    every visible card of ``dev``'s kind, at most ``YTTM_DEVICES``, when
    there is more than one and the stream has at least
    ``YTTM_SHARD_MIN_TOKENS`` (2^17) live tokens; else None."""
    from .parallel.mesh import default_mesh

    mesh = default_mesh(dev)
    if mesh is None:
        return None
    min_tokens = int(os.environ.get("YTTM_SHARD_MIN_TOKENS", str(1 << 17)))
    if sum(int((mat >= 0).sum()) for mat, _ in buckets) < min_tokens:
        return None
    return mesh


def rename_tokens(
    char2id: Dict[int, int],
    rules: List[Tuple[int, int, int]],
    special: SpecialTokens,
    n_tokens: int,
) -> Tuple[Dict[int, int], List[Tuple[int, int, int]]]:
    """Permute ids so user special ids are honoured (bpe.cpp:814-837)."""
    renaming: Dict[int, int] = {}
    cur = special.n_special_tokens()
    for i in range(n_tokens):
        if not special.taken_id(i):
            renaming[cur] = i
            cur += 1
    new_char2id = {ch: renaming[idx] for ch, idx in char2id.items()}
    new_rules = [(renaming[x], renaming[y], renaming[z]) for x, y, z in rules]
    return new_char2id, new_rules


def train_from_codepoints(
    cps: np.ndarray,
    vocab_size: int,
    config: BpeConfig,
    device=None,
    mesh=None,
) -> BPEState:
    """``mesh`` (a ``parallel.mesh.DataMesh``) replaces the mesh that
    ``auto`` and ``sparse`` discover: on a mesh ``auto`` trains the sharded
    v2 trainer and ``sparse`` the sharded v3 trainer."""
    config = check_config(config, vocab_size)
    impl = os.environ.get("YTTM_TRAIN_IMPL", "auto")
    dev = resolve_device(device)
    special = config.special_tokens
    n_specials = special.n_special_tokens()

    uniq, cnt, data_len = preprocess.char_frequencies(cps)
    print(
        f"number of unique characters in the training data: {uniq.size}",
        file=sys.stderr,
    )
    alphabet = preprocess.build_alphabet(
        uniq, cnt, data_len, config.character_coverage, n_specials
    )
    print(f"number of deleted characters: {alphabet.removed.size}", file=sys.stderr)
    print(
        f"number of unique characters left: {uniq.size - alphabet.removed.size}",
        file=sys.stderr,
    )

    used_ids0 = len(alphabet.char2id) + n_specials
    if used_ids0 > vocab_size:
        raise ValueError(
            "Incorrect arguments. Vocabulary size too small. Set vocab_size>="
            + str(used_ids0)
            + ".  Current value for vocab_size="
            + str(vocab_size)
        )

    buckets = preprocess.training_word_buckets(cps, alphabet)
    # a data mesh for auto and sparse (youtokentome_tpu/train.py:119-127)
    if impl in ("auto", "sparse"):
        mesh = mesh or _training_mesh(buckets, dev)
    else:
        mesh = None
    if mesh is not None:
        # sparse on a mesh trains the sharded v3 trainer, auto the sharded v2
        trainer = run_training_sparse_sharded if impl == "sparse" else run_training_delta_sharded
        where = dict(mesh=mesh)
    else:
        if impl == "auto":
            tiered = sum(int((mat >= 0).sum()) for mat, _ in buckets) >= TIERED_MIN_TOKENS
            impl = "tiered" if tiered else "delta"
        # YTTM_TRAIN_IMPL -> its trainer (youtokentome_tpu/train.py:128-146);
        # an unknown name trains with v2, as in the JAX package; the tiered
        # and block trainers fall back to v2 themselves when a word exceeds
        # their block cap
        trainer = {
            "sparse": run_training_sparse,
            "stream": run_training_stream,
            "block": run_training_block,
            "tiered": run_training_tiered,
        }.get(impl, run_training_delta)
        where = dict(device=dev)
    rules = trainer(
        buckets,
        used_ids0,
        vocab_size,
        batch_k=int(os.environ.get("YTTM_TRAIN_BATCH_K", "16")),
        progress_every=int(os.environ.get("YTTM_TRAIN_PROGRESS", "0")),
        checkpoint_path=os.environ.get("YTTM_TRAIN_CHECKPOINT") or None,
        checkpoint_every=int(os.environ.get("YTTM_TRAIN_CHECKPOINT_EVERY", "0")),
        resume_path=os.environ.get("YTTM_TRAIN_RESUME") or None,
        # the reference logs a merge line every 1000 ids by default
        # (bpe.cpp:1198-1219); YTTM_TRAIN_LOG=0 silences it
        progress_cb=(
            progress.MergeLog(alphabet.char2id) if progress.log_enabled() else None
        ),
        **where,
    )
    char2id, rules = rename_tokens(alphabet.char2id, rules, special, vocab_size)
    return BPEState(char2id=char2id, rules=rules, special_tokens=special)


def train(
    data_path: str,
    model_path: Optional[str],
    vocab_size: int,
    config: Optional[BpeConfig] = None,
    device=None,
    mesh=None,
) -> BPEState:
    """File-based training (train_bpe, bpe.cpp:1368-1388); ``mesh`` as in
    ``train_from_codepoints``."""
    config = config or BpeConfig()
    config = check_config(config, vocab_size)
    dev = resolve_device(device)
    # the reference prints the full config before reading the corpus
    # (print_config, bpe.cpp:1374)
    progress.print_config(data_path, model_path or "", vocab_size, config)
    print("reading file...", file=sys.stderr)
    try:
        with open(data_path, "rb") as f:
            raw = f.read()
    except OSError:
        raise ValueError("Failed to open file: " + data_path) from None
    cps = decode_utf8_bytes(raw, keep_invalid=True)
    print("learning bpe...", file=sys.stderr)
    state = train_from_codepoints(cps, vocab_size, config, device=dev, mesh=mesh)
    if model_path:
        state.dump(model_path)
        print(f"model saved to: {model_path}", file=sys.stderr)
    return state
