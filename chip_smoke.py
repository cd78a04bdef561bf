#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``youtokentome_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
builds the port's kernels from the sources, holds every kernel against
its plain torch version (and the encode kernel against the C++ host
merger), drives the encode path at the full width of a vocab-30000 model
over a 100 MB corpus, trains a vocab-30000 model on the same corpus with
the v2 and the v5 trainers, the four differential trainers, and v2, v3, v1
and v0 sharded over a 4-shard data mesh on the one card, and prints
timings.  Phases, in
order (any failure exits nonzero):

  1. device and build: the card's name and power limit; nvcc/g++ builds;
     the selection and apply kernels' registers, shared and local memory
     (``cuobjdump -res-usage``); every device function that a phase times
     by name is a kernel of the built libraries
  2. kernel vs plain version: random rows for every cap 8..512 at
     R = 8192, int32 and uint16 wire, exact equality with the plain torch
     version (on the card) and with the C++ ``RuleTable.merge_words``
  3. main path: ``BPE(model).encode(lines)`` with no knob set takes the
     device arm (novel tokens > 2**22); ids equal the host arm's; a
     subword encode (matrix path); ``Encoder.encode_stream_cli`` over
     10 MiB chunks equal to the host arm's bytes; a decode round trip
  4. times: MB/s of both arms, the kernel's per-launch time for each
     (R, cap) with CUDA events, and the plain version's time
  5. training (csrc/train_delta.cu, and csrc/train_topk.cu: the top-k that
     every trainer but v5 shares): pair_count, topk_accept (also on
     tie-heavy tables, narrow and wide ids, at k = 1, 2, 15 and 16),
     apply_delta and relay each equal to its plain version on the 100 MB
     corpus's state; the selection's edge tables (``phase_select_checks``: 2^14,
     2^17 and 2^22 slots, ids from 0, up to 65535 and from 70000, no live
     slot, one, 15, a tie at the 16th place across blocks; tier_select's
     hot, refresh and hot-overflow rounds on tie-heavy hot and full
     tables); the applies' edge rounds (``phase_apply_checks``: apply_delta
     and phase 6's apply_blocks on crafted streams, ids from 5 and from
     70000: runs of equal ids, chained candidates, words of 33-600 tokens,
     rows of 64 and 128 slots full and nearly empty, a round hitting nearly
     every word, one hitting none, a v2 table that the round fills past
     half); a 10 MB prefix at
     vocab 8000 through the kernels (small table, rebuilt) and the plain
     round loop in lockstep, equal at every segment end; the main path
     ``BPE.train(data, model, vocab_size=30000)``, launches counted (the
     stream's relay among them), rules
     equal to the plain round loop's on the card, the model's encode and
     decode round trip; times: preprocessing, merge loop, rounds,
     merges/s, each kernel's device ms (torch.profiler; the apply's
     device functions also over the first 100 rounds and the rest) and
     its plain version's; the run once more, one round at a time, to sum the work
     that its data gives each kernel, for the bounds, and to time the
     selection's library yardstick (one ``torch.topk`` of the table's
     packed words a round; v5: of the hot table's).  ``BPE.train`` runs
     here with ``YTTM_TRAIN_IMPL=delta``: with no knob the corpus takes v5
  6. training with the v5 tiered trainer (csrc/train_tiered.cu): the count,
     tier_select, apply_blocks and resplit each equal to its plain version
     on the 100 MB corpus's block stream (a refresh round, two hot rounds,
     a forced refresh; T against both of the JAX package's definitions; a
     resplit at a small hcap, so T > 0, and a hot round at that T whose
     cold keys stay out of the hot table), fold_rows on its stream and on
     a foldable cut of it; the 10 MB prefix at vocab 8000 through the
     kernels and the plain tiered round loop in lockstep (a hot tier of
     1024, a small pcap, folds from 64 rows: refreshes, rebuilds and a
     fold), equal at every segment end, the hot tier exact; the main
     path ``BPE.train(data, model, vocab_size=30000)`` with no knob takes
     v5 (launches counted, none of v2's), its rules equal the v2 plain
     round loop's from phase 5, ``BPE.train`` timed twice and split
     (``train_split``: reading, preprocessing, the trainer's layout and
     engine, merge loop, the rest); times and bounds as in phase 5, with
     the refresh rounds and folds
  7. BPE-dropout (csrc/encode_dropout.cu), run after phase 4: the kernel
     equals its plain version (same seed) for every cap 8..512 at R = 8192,
     p 0.1 and 0.5; p = 0 equals the greedy kernel, p = 1 returns its input;
     the main path ``BPE.encode(lines, dropout_prob=0.1)`` over the 100 MB
     corpus on the native route (no launch) and with YTTM_DROPOUT_NATIVE=0
     (the kernel, launches counted); a 2000-line sample decodes back; the
     two routes' mean ids a line agree within 5 standard errors; a subword
     dropout encode spells the sample; the kernel again on every input of
     the main path, equal to its plain version; times and bounds
  8. the flat stream backend (csrc/stream_encode.cu: stream_build,
     stream_dedup, stream_merge), run after phase 7: each kernel equals its
     plain version on the corpus's first 1 MiB chunk and on a crafted chunk
     (invalid bytes, multi-byte chars, every whitespace kind, a
     10,000-char word); the main path ``YTTM_ENCODE_BACKEND=stream
     BPE.encode(lines)`` over 100 MB gives phase 3's ids (launches
     counted), and the CLI's ``encode_bytes_flat`` route phase 3's CLI
     bytes; every stage again on every chunk of the corpus, equal to its
     plain version; times and bounds
  9. the differential trainers, run after phase 6: v1 stream
     (csrc/train_stream.cu), v3 sparse (csrc/train_sparse.cu), v4 block
     (csrc/train_block.cu) and v0 bucketed (csrc/train_bucketed.cu), each
     with the shared top-k.  Each kernel equals its plain version on the
     100 MB corpus's state for two rounds, and v4's block_apply again past
     its full-path rounds, through a round of its block path; the 10 MB prefix at vocab 8000 through each kernel engine and
     its plain round loop in lockstep, equal at every segment end (stream or
     rows, the live table, rules, used and done): v3 and v4 with a small
     table (rebuilt), v3's plain loop with tiny site buffers (its recount
     branch), v4 with a tiny KB (its full path), v0 for its first ids; v1,
     v3 and v0 on a crafted stream whose runs span tiles; the main path
     ``BPE.train`` with ``YTTM_TRAIN_IMPL=stream|sparse|block`` and
     ``ops.train_kernel.run_training`` at vocab 30000, launches counted,
     rules equal to phase 5's v2 rules; times (merge loop, merges/s, each
     kernel's device ms) and bounds from the work each run's data gave the
     kernels (the top-k's keys: at k = 16 phase 5's, whose rounds see the
     same live counts; at k = 1 counted in v0's run, on the card); the
     plain versions timed over each run's first ids
 10. the data mesh, 4 shards on card 0 (one card: the sharded engine and its
     exchange, not multi-card scaling).  Encode (row 11, run after phase 8):
     every main-path chunk through the sharded route equals the one-device
     kernel; ``BPE.encode(lines)`` through an Encoder on the mesh gives
     phase 3's ids; times and bounds.  Training (rows 12a-b, run after
     phase 9; csrc/train_delta_sharded.cu): on the 100 MB state,
     delta_emit, shard_recount and shard_fold each equal their plain
     versions for two rounds in both branches (the recount branch forced by
     a tiny dcap), and shard_relay at the first re-pack; the 10 MB prefix at
     vocab 8000 with 2 and 4 shards, the kernel engine and the plain sharded
     loop in lockstep (tiny dcap, small kernel tables: recount rounds and
     rebuilds), every replica's table equal to the plain loop's live table
     at every segment end; the main path ``train.train(corpus, model,
     30000, mesh=...)`` with no knob takes the sharded trainer, launches
     counted, rules equal to phase 5's v2 rules; times (merge loop twice,
     merges/s, recount rounds, exchange volume), each kernel's device ms
     beside the loop's time, bounds from the run's work counters, plain
     versions over its first ids
 11. the other sharded trainers on 4 shards of card 0, run after phase 10:
     v3 (csrc/train_sparse_sharded.cu: sparse_emit, sparse_shard_recount,
     with phase 10's shard_fold), v1 and v0 (their shard counts in
     csrc/train_stream.cu and csrc/train_bucketed.cu, the partitioned fold
     shard_part_fold and shard_gather, the top-k and the applies on every
     shard).  On the 100 MB
     state each kernel equals its plain version for two rounds (v3 in both
     of shard_fold's branches, the recount branch forced by a tiny dcap);
     the 10 MB prefix at vocab 8000 (v0: its first ids) with 2 and 4 shards,
     each kernel engine and its plain sharded loop in lockstep, equal at
     every segment end (streams or rows, every replica's live table, rules;
     v3 with tiny dcap and small tables); the main paths at vocab 30000,
     each run once under torch.profiler with launches counted:
     ``train.train`` with ``YTTM_TRAIN_IMPL=sparse`` on the mesh,
     ``run_training_stream_sharded`` and ``run_training_sharded``, rules
     equal to phase 5's v2 rules; times, bounds and plain versions as in
     phase 10, and v3's merge loop twice more without the profiler

The second-to-last line is a JSON ``kernels`` record, the line before
it the card; the last line is ``{"ok": true, "device": {...}}``.  It
exits nonzero without printing a result when no CUDA card is present or
the port is not importable.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Integer operations outside the tensor cores issue on the CUDA cores:
# the data sheet's float32 rate (67 TFLOP/s) is the peak used for them.
OPS_PER_S = 67e12
# Integer instructions the kernel needs per ranked pair and round: the
# hash (9), one probe (4), the min, selection and compaction (7).
OPS_PER_PAIR = 20
# ~0.1 s of card time at the H100's clocks: longer than the host takes to
# enqueue any timed batch of launches below
SLEEP_CYCLES = 200_000_000
CAPS = (8, 16, 32, 64, 128, 256, 512)
TIERS = (512, 2048, 8192)
SEED = 0
VOCAB = 30000
CORPUS_MB = 100
WORD_LIST = 2_000_000
WORDS_PER_LINE = 12
CLI_CHUNK = 10 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


# -- phase 1 ----------------------------------------------------------------


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip()


def phase_device_and_build() -> dict:
    from youtokentome_tpu_torch.host import fastio, fasttok
    from youtokentome_tpu_torch.ops import _cuda

    card = card_line()
    log(f"[1] card: {card}")
    t0 = time.perf_counter()
    # one compiler per source, all started together
    with ThreadPoolExecutor(14) as ex:
        futs = [ex.submit(f) for f in (_cuda.load, _cuda.load_dropout, _cuda.load_stream,
                                       _cuda.load_topk, _cuda.load_train, _cuda.load_tiered,
                                       _cuda.load_stream_train, _cuda.load_sparse,
                                       _cuda.load_block, _cuda.load_bucketed,
                                       _cuda.load_sharded, _cuda.load_sparse_sharded,
                                       fasttok._load, fastio._load)]
        for f in futs:
            f.result()
    build_s = time.perf_counter() - t0
    check(fasttok.available(), "the C++ tokenizer did not build")
    check(fastio._load() is not None, "the C++ formatter did not build")
    log(f"[1] kernels and host helpers built in {build_s:.2f} s")
    libs = [lib._name for lib in _cuda._libs.values()]
    for line in resource_usage(libs, ("topk_select_kernel", "tier_hot_kernel", "tier_full_kernel",
                                      "delta_apply_kernel", "tier_apply_kernel",
                                      "mark_words_kernel", "emit_words_kernel")):
        log(f"[1] {line}")
    log(f"[1] name maps: the {check_name_maps(libs)} device functions the phases time by name "
        f"are kernels of the built libraries")
    return {"card": card, "build_s": build_s}


def resource_usage(libs, kernels) -> list:
    """What ``cuobjdump -res-usage`` reports of the named kernels in the
    built libraries: registers, shared memory and local memory (spills) a
    thread.  A line saying so when the toolkit has no cuobjdump."""
    from youtokentome_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return [f"resource usage: no {tool}"]
    out = []
    for lib in libs:
        res = subprocess.run([str(tool), "-res-usage", lib], capture_output=True, text=True)
        lines = res.stdout.splitlines()
        for fn_line, use in zip(lines, lines[1:]):
            name = next((k for k in kernels if k in fn_line), None)
            if name and fn_line.strip().startswith("Function"):
                tmpl = "<1>" if "ILi1E" in fn_line else ("<16>" if "ILi16E" in fn_line else "")
                out.append(f"resource usage {name}{tmpl}: " + " ".join(
                    f for f in use.split() if f.split(":")[0] in ("REG", "SHARED", "LOCAL", "STACK")))
    return out


def device_functions(libs) -> set:
    """The device functions (mangled names) that ``cuobjdump -res-usage``
    lists in the built libraries; None without cuobjdump."""
    from youtokentome_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    names = set()
    for lib in libs:
        res = subprocess.run([str(tool), "-res-usage", lib], capture_output=True, text=True,
                             check=True)
        names.update(ln.split()[1].rstrip(":") for ln in res.stdout.splitlines()
                     if ln.strip().startswith("Function"))
    return names


def check_name_maps(libs) -> int:
    """Every device function name that a phase sums the profiler's times
    by (the *_DEVICE_FNS maps, the stream stages' shared scans, the encode
    and dropout kernels) is a kernel of the built libraries: a kernel
    renamed or merged without its map would read 0 ms, or part of its
    time, without an error."""
    built = device_functions(libs)
    if built is None:
        log("[1] name maps: no cuobjdump, not checked")
        return 0
    maps = [TRAIN_DEVICE_FNS, TIERED_DEVICE_FNS, DIFF_DEVICE_FNS, STREAM_DEVICE_FNS,
            SHARD_DEVICE_FNS, OTHER_DEVICE_FNS,
            {"shared": tuple(f for f in STREAM_SHARED_FNS if f.endswith("_kernel")),
             "encode": ("encode_greedy_kernel", "encode_dropout_kernel")}]
    listed = {f for m in maps for names in m.values() for f in names}
    # a mangled name holds the function's name after its length
    missing = sorted(f for f in listed
                     if not any(f"{len(f)}{f}" in name for name in built))
    check(not missing, f"device functions listed for the profiler but not built: {missing}")
    return len(listed)


# -- phase 2 ----------------------------------------------------------------


def hand_model():
    """A small model whose rules include every equal pair of letters (run
    parity) and merged-token pairs; placeholders come from the rows."""
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens

    rng = np.random.default_rng(SEED)
    letters = list(range(5, 13))  # a..h; 4 is the space meta-symbol
    char2id = {9601: 4, **{97 + i: t for i, t in enumerate(letters)}}
    pairs = [(x, y) for x in letters for y in letters]
    rng.shuffle(pairs)
    rules, seen, z = [], set(), 13
    for x, y in pairs:
        rules.append((x, y, z)); seen.add((x, y)); z += 1
    while len(rules) < 400:
        ids = [4] + letters + [r[2] for r in rules]
        x, y = (int(v) for v in rng.choice(ids, 2))
        if rng.random() < 0.1:
            y = x  # equal pairs of merged tokens
        if (x, y) in seen:
            continue
        rules.append((x, y, z)); seen.add((x, y)); z += 1
    return BPEState(char2id, rules, SpecialTokens(0, 1, 2, 3))


def random_rows(rng, n_rows: int, cap: int, letters) -> np.ndarray:
    """Front-packed rows for bucket ``cap``: a space token, then runs of
    equal letters with unknown-run placeholders (numbered per row) mixed
    in; one row in 16 is empty."""
    lo = 2 if cap == 8 else cap // 2 + 1
    mat = np.full((n_rows, cap), -1, np.int32)
    lens = rng.integers(lo, cap + 1, n_rows)
    lens[rng.random(n_rows) < 1 / 16] = 0
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            continue
        runs = np.repeat(rng.choice(letters, n), rng.geometric(0.5, n))[: n - 1]
        ph = rng.random(runs.size) < 0.04
        runs[ph] = 10**9 + np.arange(int(ph.sum()))
        mat[i, 0] = 4
        mat[i, 1:n] = runs
    return mat


def host_merge_rows(rtab, mat: np.ndarray) -> np.ndarray:
    """The C++ greedy merger on the rows' non-PAD prefixes, re-padded."""
    lens = (mat >= 0).sum(axis=1)
    off = np.zeros(mat.shape[0] + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    rf, ro = rtab.merge_words(mat[mat >= 0], off)
    out = np.full_like(mat, -1)
    rl = np.diff(ro)
    cols = np.arange(mat.shape[1])[None, :] < rl[:, None]
    out[cols] = rf
    return out


def phase_kernel_checks(caps=CAPS, n_rows=TIERS[-1], dev="cuda:0") -> dict:
    import torch

    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    state = hand_model()
    tables = ek.EncoderTables.from_state(state, dev)
    rtab = fasttok.RuleTable(state.rules)
    unk = state.special_tokens.unk_id
    rng = np.random.default_rng(SEED + 1)
    letters = list(range(5, 13))
    rows_by_cap, max_err = {}, 0
    for cap in caps:
        mat = random_rows(rng, n_rows, cap, letters)
        rows_by_cap[cap] = mat
        want = host_merge_rows(rtab, mat)
        x = torch.from_numpy(mat).to(dev)
        got = ek.encode_greedy(tables, x)
        plain = ek.encode_greedy_plain(tables, x)
        got_np = got.cpu().numpy()
        max_err = max(max_err, int(np.abs(got_np.astype(np.int64) - plain.cpu().numpy()).max()))
        check(torch.equal(got, plain), f"int32 kernel != plain version at cap {cap}")
        check(np.array_equal(got_np, want), f"int32 kernel != C++ merger at cap {cap}")

        x16 = torch.from_numpy(ek.pack_tokens_u16(mat)).to(dev)
        got16 = ek.encode_greedy_u16(tables, x16, unk)
        plain16 = ek.encode_greedy_u16_plain(tables, x16, unk)
        want16 = np.where(want < 0, ek.U16_PAD, np.where(want >= ek.PLACEHOLDER_START, unk, want))
        g16 = got16.cpu().numpy().astype(np.int64)
        max_err = max(max_err, int(np.abs(g16 - plain16.cpu().numpy().astype(np.int64)).max()))
        check(np.array_equal(g16, plain16.cpu().numpy().astype(np.int64)),
              f"u16 kernel != plain version at cap {cap}")
        check(np.array_equal(g16, want16), f"u16 kernel != C++ merger at cap {cap}")
        merged = int((mat >= 0).sum() - (want >= 0).sum())
        log(f"[2] cap {cap:3d} R {n_rows}: int32 and u16 kernels == plain == C++ "
            f"merger ({merged} merges)")
    return {"tables": tables, "rows": rows_by_cap, "max_err": max_err, "unk": unk}


# -- phase 3 ----------------------------------------------------------------


def build_corpus(seed: int = SEED):
    """Zipf 1/r over a seeded list of random a-z words, lengths Poisson(6)
    clipped to 2-14, WORDS_PER_LINE words a line (the recipe of the
    repo's bench.py).  Returns (word list, lines)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.poisson(6, WORD_LIST), 2, 14)
    letters = (rng.integers(0, 26, int(lens.sum())) + 97).astype(np.uint8).tobytes().decode()
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    words = [letters[a:b] for a, b in zip(starts, ends)]
    probs = 1.0 / np.arange(1, WORD_LIST + 1)
    probs /= probs.sum()
    n_words = int(CORPUS_MB * 1_000_000 / (float(lens.mean()) + 1.0))
    idx = rng.choice(WORD_LIST, size=n_words, p=probs)
    sel = np.asarray(words, dtype=object)[idx].tolist()
    lines = [" ".join(sel[i : i + WORDS_PER_LINE]) for i in range(0, n_words, WORDS_PER_LINE)]
    return words, lines


def build_model(words, vocab_size: int = VOCAB):
    """A vocab-``vocab_size`` model from a seed: all letter pairs (equal
    pairs included), then, for the most frequent words in order, chain
    rules merging the word's current tokens (C++ merger over the rules so
    far, refreshed every 16 words) into one token.  Every z is new and
    increasing, so the model is valid."""
    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens

    rng = np.random.default_rng(SEED + 2)
    space, a = 4, 5
    char2id = {9601: space, **{97 + i: a + i for i in range(26)}}
    st = SpecialTokens(pad_id=0, unk_id=1, bos_id=2, eos_id=3)
    n_rules = vocab_size - len(char2id) - st.n_special_tokens()
    pairs = [(a + i, a + j) for i in range(26) for j in range(26)]
    rng.shuffle(pairs)
    rules = np.zeros((n_rules, 3), np.int32)
    rule_of = {}
    z = a + 26
    for x, y in pairs:
        rules[len(rule_of)] = (x, y, z); rule_of[(x, y)] = z; z += 1
    wi = 0
    while len(rule_of) < n_rules:
        batch = words[wi : wi + 16]
        wi += 16
        toks = [[space] + [a + ord(c) - 97 for c in w] for w in batch]
        off = np.zeros(len(toks) + 1, np.int64)
        np.cumsum([len(t) for t in toks], out=off[1:])
        rf, ro = fasttok.RuleTable(rules[: len(rule_of)]).merge_words(
            np.concatenate(toks).astype(np.int32), off
        )
        for u in range(len(toks)):
            cur = rf[ro[u] : ro[u + 1]].tolist()
            acc = cur[0]
            for t in cur[1:]:
                if (acc, t) not in rule_of:
                    if len(rule_of) == n_rules:
                        break
                    rules[len(rule_of)] = (acc, t, z); rule_of[(acc, t)] = z; z += 1
                acc = rule_of[(acc, t)]
    state = BPEState(char2id, [tuple(r) for r in rules.tolist()], st)
    check(state.vocab_size() == vocab_size, "model vocab size")
    return state, wi


def cli_chunks(blob: bytes):
    """Newline-aligned chunks of at most 10 MiB, as the CLI reads them."""
    start = 0
    while start < len(blob):
        end = min(start + CLI_CHUNK, len(blob))
        if end < len(blob):
            nl = blob.rfind(b"\n", start, end)
            if nl > start:
                end = nl + 1
        yield blob[start:end]
        start = end


class merge_arm:
    """Force YTTM_ENCODE_MERGE for a block (None: the default policy)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.old = os.environ.pop("YTTM_ENCODE_MERGE", None)
        if self.mode is not None:
            os.environ["YTTM_ENCODE_MERGE"] = self.mode

    def __exit__(self, *exc):
        os.environ.pop("YTTM_ENCODE_MERGE", None)
        if self.old is not None:
            os.environ["YTTM_ENCODE_MERGE"] = self.old


def timed(fn):
    """(fn(), host seconds): every call here ends in a host copy of its
    result, so the host clock covers the device work."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_main_path(work: Path, corpus, device=None) -> dict:
    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.models.state import BPEState
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    words, lines = corpus
    t0 = time.perf_counter()
    state, n_model_words = build_model(words)
    model_path = work / "vocab30k.yttm"
    state.dump(str(model_path))
    check(BPEState.load(str(model_path)) == state, "model codec round trip")
    log(f"[3] model: vocab {state.vocab_size()}, {len(state.rules)} rules from the "
        f"{n_model_words} most frequent words ({time.perf_counter() - t0:.1f} s)")

    blob = ("\n".join(lines) + "\n").encode()
    n_bytes = len(blob)
    alpha_cps = np.sort(np.array(list(state.char2id), np.uint32))
    alpha_ids = np.array([state.char2id[int(c)] for c in alpha_cps], np.int32)
    (wf, wo, _, _), tokenize_s = timed(lambda: fasttok.tokenize(blob, alpha_cps, alpha_ids, 4))
    novel = int(wf.size)
    thr = int(os.environ.get("YTTM_HOST_MERGE_TOKENS", str(1 << 22)))
    log(f"[3] {n_bytes} bytes, {wo.size - 1} distinct words, {novel} novel tokens "
        f"(host-merge threshold {thr})")
    check(novel > thr, "novel tokens must exceed the host-merge threshold")
    sample = lines[:2000]

    # -- the main path, counted --
    with merge_arm(None):
        bpe = yttm.BPE(str(model_path), device=device)
        check(device is not None or bpe.device.type == "cuda", "BPE runs on cuda by default")
        ek.encode_greedy.launches = 0
        ek.encode_greedy_u16.launches = 0
        ids_main, main_s = timed(lambda: bpe.encode(lines))
        subwords = bpe.encode(sample, output_type=yttm.OutputType.SUBWORD)
        enc = Encoder(state, device=device)
        with merge_arm("device"):
            cli_main, cli_main_s = timed(lambda: b"".join(enc.encode_stream_cli(cli_chunks(blob))))
        decoded = bpe.decode(ids_main[: len(sample)])
        launches = {
            "encode_greedy": ek.encode_greedy.launches,
            "encode_greedy_u16": ek.encode_greedy_u16.launches,
        }
    log(f"[3] main path launches: {launches}")
    if bpe.device.type == "cuda":
        check(launches["encode_greedy_u16"] > 0, "the id encode did not launch the u16 kernel")
        check(launches["encode_greedy"] > 0, "the subword encode did not launch the int32 kernel")

    n_vocab = state.vocab_size()
    check(all(0 <= min(s) and max(s) < n_vocab for s in ids_main if s), "ids out of range")
    sub_ids = [[bpe.subword_to_id(p) for p in s] for s in subwords]
    check(sub_ids == ids_main[: len(sample)], "subwords do not map back to the ids")
    check(all("".join(s).replace("▁", " ")[1:] == t for s, t in zip(subwords, sample)),
          "subwords do not spell the text")
    check(decoded == sample, "decode round trip")
    log(f"[3] subwords map to the ids and spell the text; decode round trip of "
        f"{len(sample)} lines")

    # -- both arms, one turn each (device, host), fresh encoders each time,
    #    outside the counted window: the API call (cold word cache, then
    #    warm: no novel word left to merge), the CLI engine, and the merge
    #    stage alone on all the corpus's novel words
    turns = []
    for arm in ("device", "host"):
        with merge_arm(arm):
            api = yttm.BPE(str(model_path), device=device)
            ids, api_s = timed(lambda: api.encode(lines))
            check(ids == ids_main, f"{arm}-arm ids != the main path's")
            del ids
            ids, warm_s = timed(lambda: api.encode(lines))
            check(ids == ids_main, f"{arm}-arm warm-cache ids != the main path's")
            del ids, api
            enc = Encoder(state, device=device)
            out, cli_s = timed(lambda: b"".join(enc.encode_stream_cli(cli_chunks(blob))))
            check(out == cli_main, f"{arm}-arm encode_stream_cli bytes != the main path's")
            stage = Encoder(state, device=device)
            _, merge_s = timed(lambda: stage._merge_collect(stage._merge_dispatch(wf, wo)))
        turns.append({"arm": arm, "api_mbps": n_bytes / 1e6 / api_s,
                      "api_warm_mbps": n_bytes / 1e6 / warm_s,
                      "cli_mbps": n_bytes / 1e6 / cli_s, "merge_s": merge_s})
    log(f"[3] ids and encode_stream_cli bytes ({len(cli_main)}): device arm == host arm")
    _, bucket_s = timed(lambda: Encoder._bucket_rows(wf, wo))
    main_path = {"api_mbps": n_bytes / 1e6 / main_s, "cli_device_mbps": n_bytes / 1e6 / cli_main_s,
                 "tokenize_s": tokenize_s, "bucket_packing_s": bucket_s}

    # the main path's kernel inputs: the novel words' length buckets
    buckets = Encoder._bucket_rows(wf, wo)
    return {"launches": launches, "turns": turns, "main_path": main_path, "buckets": buckets,
            "unk": state.special_tokens.unk_id, "tables": bpe._encoder.tables,
            "model_path": model_path, "state": state, "ids": ids_main, "cli": cli_main,
            "blob": blob, "device": device}


# -- phase 4 ----------------------------------------------------------------


def event_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events.  A sleep
    kernel queued first keeps the card busy while the host enqueues all
    the calls, so the wrappers' host cost between launches is not counted
    as device time (a call that waits on the host, as the plain version
    does every round, still counts its waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_us_per_call(fn, n: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn`` (no sync)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)  # the card stays busy: only the host is timed
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def ranked_pairs(tables, x) -> int:
    """Adjacent token pairs the kernel ranks on rows ``x``: each row's
    valid pairs in every round it runs (its rounds with a rule, and the
    last one, which finds none)."""
    import torch

    from youtokentome_tpu_torch.ops import encode_kernel as ek

    total, toks = 0, x
    runs = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(x.shape[1]):
        valid = (toks[:, :-1] != ek.PAD) & (toks[:, 1:] != ek.PAD) & runs[:, None]
        total += int(valid.sum())
        toks, active = ek.merge_round(tables, toks)
        runs &= active[:, 0]
        if not bool(runs.any()):
            break
    return total


def phase_times(card: str, kchk: dict, main: dict) -> list:
    import torch

    from youtokentome_tpu_torch.encoder import DEVICE_BATCH
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    dev = torch.device("cuda", 0)
    tables, unk = kchk["tables"], kchk["unk"]
    x = torch.from_numpy(np.ascontiguousarray(kchk["rows"][CAPS[0]][:TIERS[0]])).to(dev)
    log(f"[4] host cost of one wrapper call (R {TIERS[0]}, cap {CAPS[0]}): "
        f"{host_us_per_call(lambda: ek.encode_greedy(tables, x)):.1f} us ({card})")
    log(f"[4] per-launch device times on random rows ({card}); "
        f"bound = R*L*(in+out bytes) / 3.35 TB/s")
    log("[4] variant   R     cap   kernel_ms   bound_ms   plain_ms")
    for cap, mat in kchk["rows"].items():
        for r in TIERS:
            x = torch.from_numpy(np.ascontiguousarray(mat[:r])).to(dev)
            x16 = torch.from_numpy(ek.pack_tokens_u16(mat[:r])).to(dev)
            for name, fk, fp, nb in (
                ("int32", lambda: ek.encode_greedy(tables, x),
                 lambda: ek.encode_greedy_plain(tables, x), 8),
                ("u16", lambda: ek.encode_greedy_u16(tables, x16, unk),
                 lambda: ek.encode_greedy_u16_plain(tables, x16, unk), 4),
            ):
                k_ms = event_ms(fk, 10)
                p_ms = event_ms(fp, 1)
                b_ms = r * cap * nb / HBM_BYTES_PER_S * 1e3
                log(f"[4] {name:6s} {r:5d} {cap:5d} {k_ms:11.4f} {b_ms:10.5f} {p_ms:10.3f}")

    # the main path's own inputs: every bucket chunk of the 100 MB encode
    tables, unk = main["tables"], main["unk"]
    chunks = []
    for _, mat in main["buckets"]:
        for c0 in range(0, mat.shape[0], DEVICE_BATCH):
            chunks.append(np.ascontiguousarray(mat[c0 : c0 + DEVICE_BATCH]))
    x32 = [torch.from_numpy(c).to(dev) for c in chunks]
    x16 = [torch.from_numpy(ek.pack_tokens_u16(c)).to(dev) for c in chunks]
    elems = sum(c.size for c in chunks)
    shapes = sorted({c.shape for c in chunks})
    pairs = sum(ranked_pairs(tables, x) for x in x32)
    ops_ms = pairs * OPS_PER_PAIR / OPS_PER_S * 1e3
    log(f"[4] main-path inputs: {pairs} ranked pairs, operations bound {ops_ms:.5f} ms")
    rows = []
    for name, xs, fk, fp, nb in (
        ("encode_greedy", x32, lambda x: ek.encode_greedy(tables, x),
         lambda x: ek.encode_greedy_plain(tables, x), 8),
        ("encode_greedy_u16", x16, lambda x: ek.encode_greedy_u16(tables, x, unk),
         lambda x: ek.encode_greedy_u16_plain(tables, x, unk), 4),
    ):
        k_ms = event_ms(lambda: [fk(x) for x in xs], 5)
        p_ms = event_ms(lambda: [fp(x) for x in xs], 1)
        b_ms = elems * nb / HBM_BYTES_PER_S * 1e3
        rows.append({"name": name, "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_ms, ops_ms),
                     "bound_by": "bytes" if b_ms >= ops_ms else "operations", "ops_ms": ops_ms})
        log(f"[4] main-path inputs ({len(xs)} launches, shapes {shapes}): {name} "
            f"kernel {k_ms:.4f} ms, bytes bound {b_ms:.5f} ms, plain {p_ms:.3f} ms")
    mp = main["main_path"]
    log(f"[4] main path (default policy): API {mp['api_mbps']:.2f} MB/s; CLI engine, device "
        f"arm: {mp['cli_device_mbps']:.2f} MB/s; C++ tokenize {mp['tokenize_s']:.3f} s; "
        f"bucket packing {mp['bucket_packing_s']:.3f} s ({card})")
    for t in main["turns"]:
        log(f"[4] {t['arm']:6s} arm: API {t['api_mbps']:.2f} MB/s (warm cache "
            f"{t['api_warm_mbps']:.2f}), CLI engine {t['cli_mbps']:.2f} MB/s, merge stage "
            f"{t['merge_s']:.3f} s ({card})")
    return rows


# -- phase 5: training -------------------------------------------------------

TRAIN_VOCAB = 30000
MID_MB = 10
MID_VOCAB = 8000
# a table this small (pcap 256, 512 slots) overflows and is rebuilt several
# times in the mid-size run
MID_PCAP = 256
TRAIN_SEG = 1000  # ids per segment, as run_training_delta sets it with the merge log on
TRAIN_KERNELS = ("pair_count", "topk_accept", "apply_delta", "relay")
# the device functions of each wrapper, as the profiler names them
TRAIN_DEVICE_FNS = {
    "pair_count": ("pair_count_kernel",),
    "topk_accept": ("topk_select_kernel",),
    "apply_delta": ("delta_apply_kernel",),
    "relay": ("relay_len_kernel", "relay_write_kernel", "tile_sums_kernel", "tile_offsets_kernel",
              "scan_apply_kernel"),
}
# integer operations per element, for the operations bound: a table slot
# in topk_accept (load, compare with the list's last, loop: 10), a stream
# position in apply_delta's pass 1 (two loads, 16 compares: 20) and in
# pair_count (loads, parity scan, hash and probe: 40)
OPS_PER_SLOT, OPS_PER_POS, OPS_PER_COUNTED = 10, 20, 40
TRAIN_REPLACES = {name: "youtokentome_tpu/ops/train_delta.py:210" for name in TRAIN_KERNELS}
# the kernel engine lays its word-laid stream out again where the JAX host
# loop slices its front-compacted one (the re-pack)
TRAIN_REPLACES["relay"] = "youtokentome_tpu/ops/train_delta.py:473"
# the trainers' shared top-k (v2, v1, v3, v4, and v0 with k = 1)
TOPK_SOURCE = "youtokentome_tpu_torch/csrc/train_topk.cu"


_PREPARED = {}  # training_buckets' results by path: the phases only read them


def training_buckets(path: Path, fresh: bool = False):
    """Host preprocessing of a corpus file, as ``train.train`` does it:
    (buckets, alphabet, used_ids0), kept per path; ``fresh`` does it again
    (phase 5 times it)."""
    from youtokentome_tpu_torch.host import preprocess, utf8

    if not fresh and str(path) in _PREPARED:
        return _PREPARED[str(path)]
    cps = utf8.decode_utf8_bytes(path.read_bytes(), keep_invalid=True)
    uniq, cnt, n = preprocess.char_frequencies(cps)
    al = preprocess.build_alphabet(uniq, cnt, n, 1.0, 4)
    out = preprocess.training_word_buckets(cps, al), al, len(al.char2id) + 4
    _PREPARED[str(path)] = out
    return out


def clone_state(st):
    import copy

    import torch

    new = copy.copy(st)
    for k, v in vars(st).items():
        if isinstance(v, torch.Tensor):
            setattr(new, k, v.clone())
    return new


def same_state(a, b, what: str) -> None:
    """Kernel state ``a`` and plain state ``b`` agree: stream, the table as
    a multiset of (key, count) slots, ctl, rules and the accepted rows."""
    import torch

    check(torch.equal(a.tok, b.tok), f"{what}: streams differ")
    ka, ca = a.table()
    kb, cb = b.table()
    check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: tables differ")
    check(torch.equal(a.ctl, b.ctl), f"{what}: ctl {a.ctl.tolist()} != {b.ctl.tolist()}")
    check(torch.equal(a.rules, b.rules), f"{what}: rules differ")
    n = int(a.ctl[4])  # n_acc
    check(torch.equal(a.cand[:n], b.cand[:n]), f"{what}: accepted rows differ")
    check(int(ca.min(initial=0)) >= 0, f"{what}: a negative pair count")


def plain_pair_count(st) -> None:
    """pair_count's plain version behind the wrapper's table reset."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    st.keys.fill_(tk.EMPTY)
    st.cnts.zero_()
    st.ctl[tk.OCC] = 0
    st.ctl[tk.OVERFLOW] = 0
    tk.pair_count_plain(st)


def tie_entries(n: int, base: int, rng):
    """Unique pairs of ids in [base, base + 700) from n draws, equal pairs
    common, with counts 1-4 (many ties) and a tenth of them 0 (dead)."""
    x = rng.integers(0, 700, n)
    y = np.where(rng.random(n) < 0.2, x, rng.integers(0, 700, n))
    keys = np.unique(((x + base).astype(np.int64) << 32) | (y + base))
    cnts = rng.integers(1, 5, keys.size).astype(np.int32)
    cnts[rng.random(keys.size) < 0.1] = 0
    return keys, cnts


def tie_table(st, base: int, seed: int) -> None:
    """Fill ``st``'s table with tie_entries from a quarter of its slots."""
    rng = np.random.default_rng(seed)
    keys, cnts = tie_entries(st.cap // 4, base, rng)
    place(st.keys, st.cnts, keys, cnts, rng.permutation(st.cap)[: keys.size])


# the selection's edge tables: the minimum table (2^14 slots), v5's hot
# table (2^17) and v2's last table (2^22); ids on both sides of the narrow
# word's limit (65535) and above it; batch sizes k
SELECT_CAPS = (1 << 14, 1 << 17, 1 << 22)
SELECT_BASES = (0, 65535 - 699, 70000)
SELECT_KS = (1, 2, 15, 16)
SELECT_USED0 = 30  # ids an edge table's round starts from


def select_state(cap: int, dev, vocab: int = TRAIN_VOCAB):
    """An empty table state of ``cap`` slots for the shared top-k alone."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    st = tk.TableState()
    st.device = torch.device(dev)
    st.control(np.full((vocab, 4), -1, np.int32), SELECT_USED0)
    st.resize(cap)
    return st


def place(keys_t, cnts_t, keys: np.ndarray, cnts: np.ndarray, slots: np.ndarray) -> None:
    """Empty the table keys_t/cnts_t and put keys/cnts at ``slots``."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    keys_t.fill_(tk.EMPTY)
    cnts_t.zero_()
    at = torch.from_numpy(slots).to(keys_t.device)
    keys_t[at] = torch.from_numpy(keys.astype(np.int64)).to(keys_t.device)
    cnts_t[at] = torch.from_numpy(cnts.astype(np.int32)).to(keys_t.device)


def edge_tables(cap: int, base: int, seed: int):
    """(what, keys, counts, slots) of the selection's edge tables at ``cap``
    slots, ids from ``base``: no live slot (dead keys only), one, 15, and a
    tie at the 16th place that spans blocks (10 keys above 40 of one
    count, spread evenly over the table: over the blocks of the selection,
    which take 1024 slots each in turn)."""
    rng = np.random.default_rng(seed)
    x = rng.permutation(700)[:100] + base
    y = rng.permutation(700)[:100] + base
    keys = (x.astype(np.int64) << 32) | y
    out = [("no live slot", keys[:20], np.zeros(20, np.int32), rng.permutation(cap)[:20]),
           ("one live slot", keys[:1], np.array([3], np.int32), np.array([cap - 1]))]
    c15 = rng.integers(1, 4, 15)
    out.append(("15 live slots", keys[:15], c15, rng.permutation(cap)[:15]))
    cnt = np.concatenate([rng.integers(20, 30, 10), np.full(40, 7)]).astype(np.int32)
    spread = rng.permutation(np.linspace(0, cap - 1, 50).astype(np.int64))
    out.append(("a tie at the 16th place across blocks", keys[:50], cnt, spread))
    return out


def same_select(a, b, what: str) -> None:
    """Kernel and plain table states agree after a top-k: the table, ctl,
    rules, the accepted rows and the work counters."""
    import torch

    ka, ca = a.table()
    kb, cb = b.table()
    check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: tables differ")
    check(torch.equal(a.ctl, b.ctl), f"{what}: ctl {a.ctl.tolist()} != {b.ctl.tolist()}")
    check(torch.equal(a.rules, b.rules), f"{what}: rules differ")
    n = int(a.ctl[4])  # n_acc
    check(torch.equal(a.cand[:n], b.cand[:n]), f"{what}: accepted rows differ")
    check(torch.equal(a.work, b.work), f"{what}: work {a.work.tolist()} != {b.work.tolist()}")


def select_pair(st, what: str, k: int, vocab: int = TRAIN_VOCAB) -> int:
    """topk_accept and its plain version from clones of ``st``; returns the
    number accepted."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    a, b = clone_state(st), clone_state(st)
    limit = SELECT_USED0 + TRAIN_SEG
    tk.topk_accept(a, limit, vocab, SELECT_USED0, k)
    tk.topk_accept_plain(b, limit, vocab, SELECT_USED0, k)
    same_select(a, b, f"topk_accept k {k}, {what}")
    check(int(a.ticket[0]) == 0, f"topk_accept k {k}, {what}: the ticket was left at {a.ticket}")
    return int(a.ctl[4])


def phase_select_checks(dev) -> dict:
    """The selection (topk_accept and tier_select) against its plain
    version on its edge tables: at the minimum table, v5's hot-table size
    and v2's last table, with ids from 0, up to 65535 and from 70000 (both
    the narrow words and the wide ones, chosen at launch from vocab or
    after a block met a wide id), at k = 1, 2, 15 and 16: tie-heavy tables,
    no live slot, one, 15, and a tie at the 16th place across blocks; then
    tier_select's hot round with T > 0, refresh round and hot overflow on
    tie-heavy hot and full tables."""
    t0 = time.perf_counter()
    n = 0
    for cap in SELECT_CAPS:
        for base in SELECT_BASES:
            vocabs = (TRAIN_VOCAB, 80000) if base >= 65536 else (TRAIN_VOCAB,)
            for vocab in vocabs:
                st = select_state(cap, dev, vocab)
                tie_table(st, base, cap + base)
                for k in SELECT_KS:
                    select_pair(st, f"a tie table of {cap} slots, ids from {base}, vocab {vocab}",
                                k, vocab)
                    n += 1
                for what, keys, cnts, slots in edge_tables(cap, base, cap + base):
                    place(st.keys, st.cnts, keys, cnts, slots)
                    for k in SELECT_KS:
                        got = select_pair(st, f"{what}, {cap} slots, ids from {base}", k, vocab)
                        n += 1
                        if what == "no live slot":
                            check(got == 0, f"{what}: {got} accepted")
    log(f"[5] topk_accept == plain on {n} edge cases: tie tables, no live slot, one, 15, a tie "
        f"at the 16th place across blocks; {SELECT_CAPS} slots, ids from {SELECT_BASES}, "
        f"k {SELECT_KS} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    m = tiered_select_checks(dev)
    log(f"[6] tier_select == plain on {m} tie-heavy hot and full tables: hot rounds at T > 0, "
        f"refresh rounds, hot overflows ({time.perf_counter() - t0:.1f} s)")
    return {"topk": n, "tiered": m}


# tier_select's tie tables: (full slots, hot slots) at the minimum and at
# the main path's sizes
TIERED_SELECT_CAPS = ((1 << 14, 1 << 14), (1 << 23, 1 << 17))


def tiered_tie_tables(st, base: int, seed: int, T: int) -> None:
    """Fill ``st``'s full table with tie_entries from a quarter of its
    slots (as tie_table), lift up to a quarter of the hot table's slots of
    them to counts 5-8, and make the hot table every key above ``T`` with
    its count (T in 4..8: a valid hot tier)."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    rng = np.random.default_rng(seed)
    keys, cnts = tie_entries(st.cap // 4, base, rng)
    hot = rng.permutation(keys.size)[: min(st.hslots // 4, keys.size // 8)]
    cnts[hot] = rng.integers(5, 9, hot.size)
    place(st.keys, st.cnts, keys, cnts, rng.permutation(st.cap)[: keys.size])
    up = cnts > T
    place(st.hkeys, st.hcnts, keys[up], cnts[up], rng.permutation(st.hslots)[: int(up.sum())])
    st.ctl[tk.THRESH] = T


def tiered_select_checks(dev) -> int:
    """tier_select against its plain version on tiered_tie_tables: a hot
    round at T = 4 (the floor cuts its acceptance), a refresh round (T = 8:
    no hot key), a hot overflow; narrow ids, ids up to 65535, wide ids."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    n = 0
    for cap, hslots in TIERED_SELECT_CAPS:
        for base in SELECT_BASES:
            rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
            st = tk.TieredState(np.full(64, -1), np.full(64, -1), np.ones(1, np.int32), rules,
                                SELECT_USED0, 16, cap, hslots, dev)
            for case, T, ovf in (("hot", 4, 0), ("refresh", 8, 0), ("hot overflow", 4, 1)):
                tiered_tie_tables(st, base, cap + base + T, T)
                st.ctl[tk.HOT_OVF] = ovf
                a, b = clone_state(st), clone_state(st)
                limit = SELECT_USED0 + TRAIN_SEG
                tk.tier_select(a, limit, TRAIN_VOCAB, SELECT_USED0)
                tk.tier_select_plain(b, limit, TRAIN_VOCAB, SELECT_USED0, 16)
                what = f"tier_select, {case}, {cap}/{hslots} slots, ids from {base}"
                same_tiered(a, b, what)
                check(int(a.ticket[0]) == 0, f"{what}: the ticket was left at {a.ticket}")
                refresh = int(a.ctl[tk.REFRESH])
                check(refresh == (case != "hot") and int(a.ctl[tk.NACC]) > 0,
                      f"{what}: refresh {refresh}, {int(a.ctl[tk.NACC])} accepted")
                n += 1
    return n

# the applies' edge checks: ids from 5 and from 70000 (above the narrow
# words' 65535), v5 rows of these sizes
APPLY_BASES = (5, 70000)
APPLY_BS = (64, 128)
APPLY_HCAP = 64  # T is the count at rank 32: cold keys in every round


def edge_words(base: int, rng, long_v2: bool):
    """Words (lists of ids from ``base``) for the applies' edge checks: runs
    of one id of every length 1-9 inside other ids (run parity), chains of
    candidates, words of 33-60 tokens (and one of 600 when ``long_v2``), and
    2,000 random words over six ids (nearly every one holds a candidate)."""
    a, b, c, d = base, base + 1, base + 2, base + 3
    words = [[d] + [a] * r + [b] for r in range(1, 10)]
    words += [[a] * 7, [a, a, d, a, a, a, d, a], [b, c, d], [b, c, d, c, d], [c, d, b, c],
              [b, c, c, d], [d, a, a, b, c, d]]
    for n in (33, 40, 60):
        words.append([base + int(v) for v in rng.integers(0, 4, n)])
    if long_v2:
        words.append([base + int(v) for v in rng.integers(0, 4, 600)])
    for n in rng.integers(2, 15, 2000):
        words.append([base + int(v) for v in rng.integers(0, 6, n)])
    return words


def edge_rounds(base: int):
    """(what, candidates [x, y]) of the applies' edge rounds: equal ids in
    runs, chains ((b, c) with (c, d), (d, a) with (a, a)) and a pair
    absent from the words; then 16 pairs of the six ids, which nearly every
    word holds (the contended keys); then pairs that no word holds."""
    a, b, c, d = base, base + 1, base + 2, base + 3
    many = [(base + i, base + j) for i in range(6) for j in range(6) if i != j][:15]
    return [("run parity and chains", [(a, a), (b, c), (c, d), (d, a), (base + 50, base + 51)]),
            ("nearly every word hit", [(a, a)] + many),
            ("no word hit", [(base + 60, base + 61), (base + 62, base + 60)])]


def set_round(st, cands, used: int) -> None:
    """Make ``cands`` ([x, y] pairs) the accepted rows of a new round of
    kernel state ``st`` (z from ``used`` on); ctl slots as a selection
    leaves them (v2 and v5 share the slots below CTL_OWN)."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    rows = np.array([[x, y, used + j, 1] for j, (x, y) in enumerate(cands)], np.int32)
    st.cand.zero_()
    st.cand[: len(cands)] = torch_of(rows, st.device)
    st.ctl[tk.NACC] = len(cands)
    st.ctl[tk.ROUND] += 1


def torch_of(a: np.ndarray, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def flat_words(words, rng):
    """(t, wid, freq) of a flat stream holding ``words`` in order, weights
    1-5."""
    t = np.concatenate([np.asarray(w, np.int32) for w in words])
    wid = np.repeat(np.arange(len(words), dtype=np.int32), [len(w) for w in words])
    return t, wid, rng.integers(1, 6, len(words)).astype(np.int32)


def row_words(words, B: int, rng):
    """(t, wid, freq) of a block stream of rows of B slots holding
    ``words`` in order: words packed while they fit, every fifth row holding
    one word only (nearly empty), a row of B tokens first (full)."""
    full = [[words[0][0]] * B]
    rows, cur = [], []
    for w in full + list(words):
        if cur and (sum(map(len, cur)) + len(w) > B or len(rows) % 5 == 4):
            rows.append(cur)
            cur = []
        cur.append(w)
    rows.append(cur)
    t = np.full((len(rows), B), -1, np.int32)
    wid = np.full((len(rows), B), -1, np.int32)
    k = 0
    for r, row in enumerate(rows):
        at = 0
        for w in row:
            t[r, at : at + len(w)] = w
            wid[r, at : at + len(w)] = k
            at += len(w)
            k += 1
    return t.reshape(-1), wid.reshape(-1), rng.integers(1, 6, k).astype(np.int32)


def phase_apply_checks(dev) -> dict:
    """apply_delta (v2) and apply_blocks (v5) against their plain versions
    on crafted streams (``edge_words``, ids from 5 and from 70000), in each
    of ``edge_rounds``: v2 with a table of twice the count's slots and
    one snug to them (the round's new pairs may pass half of it: the
    overflow flag), v5 with rows of 64 and 128 slots, full and nearly
    empty, in a hot round (T above 0: cold keys stay out of the hot table) and
    a refresh round.  The tables as key -> count maps (count-0 slots
    included), the streams, signatures and ctl (OCC, OVERFLOW, the hot
    table's, NBAFF and the round's stats) must be equal."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tdk
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t0 = time.perf_counter()
    n, ovf = 0, 0
    for base in APPLY_BASES:
        rng = np.random.default_rng(base)
        used = base + 100
        t, wid, freq = flat_words(edge_words(base, rng, True), rng)
        rules = np.full((used + 64, 4), -1, np.int32)
        for what, cands in edge_rounds(base):
            cap = 1 << 14
            for snug in (False, True):
                st = tk.TrainState(t, wid, freq, rules, used, cap, dev)
                tk.pair_count(st)
                occ0 = int(st.ctl[tk.OCC])
                check(not int(st.ctl[tk.OVERFLOW]), "the edge count overflowed")
                set_round(st, cands, used)
                p_st = clone_state(st)
                tk.apply_delta(st)
                tk.apply_delta_plain(p_st)
                label = f"apply_delta, {what}, ids from {base}, {cap} slots"
                same_state(st, p_st, label)
                check(not int(st.ctl[tk.ERROR]), f"{label}: the table lost a pair")
                ovf += int(st.ctl[tk.OVERFLOW])
                n += 1
                # then a table snug to the slots the count and the round
                # take (never full), which the round may fill past half
                cap = max(td._next_pow2(2 * occ0), td._next_pow2(int(st.ctl[tk.OCC])))
        for B in APPLY_BS:
            t, wid, freq = row_words(edge_words(base, rng, False), B, rng)
            st = tdk.TieredState(t, wid, freq, rules, used, B, 1 << 14, 1 << 12, dev)
            p_st = clone_state(st)
            tdk.apply_blocks(st, count_mode=True)
            plain_tiered_count(p_st)
            same_tiered(st, p_st, f"apply_blocks count mode, B {B}, ids from {base}")
            # the hot tier as a refresh round's resplit leaves it, T above 0
            st.ctl[[tdk.REFRESH, tdk.NACC]] = 1
            tdk.resplit(st, APPLY_HCAP)
            st.ctl[[tdk.REFRESH, tdk.NACC]] = 0
            check(int(st.ctl[tdk.THRESH]) > 0 and not int(st.ctl[tdk.HOT_OVF]),
                  f"the edge rows' hot tier: T {int(st.ctl[tdk.THRESH])}")
            for what, cands in edge_rounds(base):
                for refresh in (0, 1):
                    k_st = clone_state(st)
                    set_round(k_st, cands, used)
                    k_st.ctl[[tdk.REFRESH, tdk.ACTIVE, tdk.ZLO, tdk.NBAFF]] = torch_of(
                        np.array([refresh, 1, used, 0], np.int32), dev)
                    p_st = clone_state(k_st)
                    tdk.apply_blocks(k_st, 4, 64)
                    tdk.apply_blocks_plain(p_st, False, 4, 64)
                    label = (f"apply_blocks, {what}, {'refresh' if refresh else 'hot'} round, "
                             f"B {B}, ids from {base}")
                    same_tiered(k_st, p_st, label)
                    check(int(k_st.ticket[0]) == 0 and int(k_st.hits[0]) == 0,
                          f"{label}: the ticket and row count were left at {k_st.ticket}, {k_st.hits}")
                    if not refresh and not int(k_st.ctl[tdk.HOT_OVF]):
                        check_hot_tier(k_st, label)
                    n += 1
    log(f"[5-6] apply_delta and apply_blocks == plain on {n} edge rounds: run parity, chained "
        f"candidates, words of 33-600 tokens, rows of {APPLY_BS} slots full and nearly empty, "
        f"ids from {APPLY_BASES}, a round hitting nearly every word, one hitting none; "
        f"{ovf} of the v2 rounds set the overflow flag ({time.perf_counter() - t0:.1f} s)")
    return {"rounds": n, "overflows": ovf}


def phase_train_kernels(buckets, used0: int, dev) -> dict:
    """Each training kernel against its plain version on the card, on the
    main path's state (the 100 MB corpus's stream and table)."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_stream as ts

    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
    eng = tk.KernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB, 16, dev)
    st = eng.st
    log(f"[5] main-path state: {st.tok.shape[0]} stream slots, {st.n_words} words, "
        f"table {st.cap} slots")
    plain = clone_state(st)
    plain_pair_count(plain)
    same_state(st, plain, "pair_count")
    uk, uc = td.host_count_table(t, wid, freq)
    keys, cnts = st.table()
    check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
          "pair_count != the host count table")
    log(f"[5] pair_count == plain == host count table ({uk.size} pairs)")

    # rounds on the real table: topk_accept, then apply_delta, each
    # against its plain version from the identical state
    k_st, p_st = clone_state(st), clone_state(st)
    for r in range(3):
        limit = used0 + TRAIN_SEG
        tk.topk_accept(k_st, limit, TRAIN_VOCAB, used0)
        tk.topk_accept_plain(p_st, limit, TRAIN_VOCAB, used0, 16)
        same_state(k_st, p_st, f"topk_accept round {r}")
        tk.apply_delta(k_st)
        tk.apply_delta_plain(p_st)
        same_state(k_st, p_st, f"apply_delta round {r}")
        log(f"[5] round {r}: topk_accept and apply_delta == plain "
            f"({int(k_st.ctl[tk.NACC])} accepted, {int(k_st.ctl[tk.NAFF])} words hit)")
    # the stream laid out again over its live tokens
    k_r, p_r = clone_state(k_st), clone_state(k_st)
    tk.relay(k_r)
    tk.relay_plain(p_r)
    check(all(torch.equal(getattr(k_r, f), getattr(p_r, f)) for f in ("tok", "pwid", "off", "fw")),
          "relay: the relaid streams differ")
    kt, kw = k_r.stream()
    pt, pw = k_st.stream()
    check(torch.equal(kt, pt) and torch.equal(kw, pw), "relay: the live stream changed")
    log(f"[5] relay == plain ({k_st.tok.shape[0]} -> {k_r.tok.shape[0]} slots, the live stream "
        f"unchanged)")

    # tie-heavy tables at the main path's size, narrow and wide ids, for
    # every batch size the selection's two queues serve
    for base in (0, 70000):
        for seed in range(3):
            for k in SELECT_KS:
                k_st = clone_state(st)
                tie_table(k_st, base, seed)
                p_st = clone_state(k_st)
                tk.topk_accept(k_st, used0 + TRAIN_SEG, TRAIN_VOCAB, used0, k)
                tk.topk_accept_plain(p_st, used0 + TRAIN_SEG, TRAIN_VOCAB, used0, k)
                same_state(k_st, p_st,
                           f"topk_accept k {k} on a tie table (base {base}, seed {seed})")
        log(f"[5] topk_accept == plain on tie-heavy tables of {st.cap} slots, ids from {base}, "
            f"k {SELECT_KS} (last: {int(k_st.ctl[tk.NACC])} accepted)")
    return {"st": st}


def complete_segment(eng, used: int, limit: int):
    """Rounds up to ``limit`` (or done), rebuilding the table on overflow."""
    while True:
        used, done, overflow = eng.segment(used, limit)
        if not overflow:
            return used, done
        eng.regrow()


def write_prefix(corpus_path: Path, work: Path) -> Path:
    """The corpus's first MID_MB MB (whole lines), for the mid-size runs."""
    blob = corpus_path.read_bytes()
    mid_path = work / "corpus_10mb.txt"
    mid_path.write_bytes(blob[: blob.rfind(b"\n", 0, MID_MB * 1_000_000) + 1])
    return mid_path


def phase_train_mid(mid_path: Path, dev) -> dict:
    """A 10 MB prefix at vocab 8000: the kernel engine (with a small table,
    so that it is rebuilt) and the plain round loop, both on the card, in
    lockstep: stream, live table and rules equal after every segment."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_stream as ts

    cut = mid_path.stat().st_size
    buckets, _, used0 = training_buckets(mid_path)
    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((MID_VOCAB, 4), -1, np.int32)
    with env_set(YTTM_TRAIN_PCAP=str(MID_PCAP)):
        kern = tk.KernelEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, dev)
    plain = td.PlainEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, dev)
    used, segs, t0 = used0, 0, time.perf_counter()
    while used < MID_VOCAB:
        limit = min(MID_VOCAB, used + TRAIN_SEG)
        ku, kd = complete_segment(kern, used, limit)
        pu, pd = complete_segment(plain, used, limit)
        check((ku, kd) == (pu, pd), f"segment to {limit}: kernel {ku, kd} != plain {pu, pd}")
        kt, kw = kern.st.stream()
        live = plain.t >= 0
        check(torch.equal(kt, plain.t[live]) and torch.equal(kw, plain.wid[live]),
              f"segment to {limit}: streams differ")
        keys, cnts = kern.st.table()
        check(int(cnts.min(initial=0)) >= 0, "a negative pair count")
        n = int((plain.tc > 0).sum())
        check(np.array_equal(keys[cnts > 0], plain.tk[:n].cpu().numpy())
              and np.array_equal(cnts[cnts > 0], plain.tc[:n].cpu().numpy()),
              f"segment to {limit}: live tables differ")
        check(torch.equal(kern.rules, plain.rules), f"segment to {limit}: rules differ")
        used, segs = ku, segs + 1
        if kd:
            break
    check(kern.rebuilds >= 1, "the mid-size run never rebuilt its table")
    log(f"[5] mid-size: {cut} bytes, vocab {MID_VOCAB}: kernels == plain round loop at all "
        f"{segs} segment ends (stream, live table, rules); {kern.rebuilds} table rebuilds, "
        f"final table {kern.st.cap} slots ({time.perf_counter() - t0:.1f} s)")
    return {"rebuilds": kern.rebuilds, "segments": segs}


def run_engine(eng, vocab: int, used: int):
    """run_training_delta's loop over segments of TRAIN_SEG ids."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    while used < vocab:
        limit = min(vocab, used + TRAIN_SEG)
        used, done, overflow = eng.segment(used, limit)
        if overflow:
            eng.regrow()
            continue
        check(int(eng.st.cnts.min()) >= 0, "a negative pair count")
        check(not int(eng.st.ctl[tk.ERROR]), "the table lost a pair")
        if done:
            break
    return used


def library_topk_ms(keys, cnts, k: int = 16) -> float:
    """The library yardstick of a round's selection half: ms of one
    ``torch.topk`` (CUDA events) over the table's words in the selection's
    order (``train_kernels.order_words``, made outside the timed window).
    It ranks candidates only, without the acceptance; the port never calls
    it."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    live = keys != tk.EMPTY
    zero = torch.zeros_like(keys)
    xs = torch.where(live, keys >> 32, zero).to(torch.int32)
    ys = torch.where(live, keys & 0xFFFFFFFF, zero).to(torch.int32)
    words = tk.order_words(cnts, xs, ys)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.topk(words, k)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def selection_keys(cnts, k: int):
    """The keys that one round's selection over the counts ``cnts`` must
    read (a 0-d tensor on their device; no sync): those of the live slots
    whose count reaches the k-th largest count (every live slot while
    fewer than k live).  A slot below that count ranks after k others
    whatever its key, so its count alone rules it out."""
    import torch

    if k == 1:
        bar = cnts.max()
    else:
        bar = torch.topk(cnts, min(k, cnts.numel()), sorted=False).values.min()
    return (cnts >= bar.clamp(min=1)).sum()


class KeyTally:
    """A topk_accept that also sums, on the device, the keys each active
    round's selection must read (``selection_keys``; a round is active
    when the top-k counts it in ``work``).  Swapped in for the name an
    engine module calls, it leaves the launch counts to the real wrapper."""

    def __init__(self, real):
        self.real, self.total = real, None

    def __call__(self, st, limit, vocab_size, used_ids0, k=16):
        from youtokentome_tpu_torch.ops import train_kernels as tk

        r0 = st.work[tk.W_ROUNDS].clone()
        self.real(st, limit, vocab_size, used_ids0, k)
        add = selection_keys(st.cnts, k) * (st.work[tk.W_ROUNDS] - r0)
        self.total = add if self.total is None else self.total + add

    def keys(self) -> int:
        return int(self.total) if self.total is not None else 0


def run_work(engine, vocab: int):
    """The main path's run once more, one round at a time (a round accepts
    up to 16 ids whatever its segment's end, so these are the same rounds),
    summing the work that this run's data gives each kernel, for the bounds:

      pair_count   per launch: the live tokens, the words' offsets and
                   weights, and the slots the count fills (key and count)
      topk_accept  per round: every slot's count, the keys of the slots
                   whose count reaches the round's 16th (selection_keys),
                   the accepted rows; and library_topk_ms before each call
      apply_delta  per round: the live tokens; per word with a hit, its
                   offset and weight and its live slots written back; per
                   slot whose count the round changes (a key whose net
                   delta is not 0), its key read and its count read and
                   written
    """
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    w = {"count_launches": 0, "count_bytes": 0, "count_tokens": 0, "topk_bytes": 0,
         "topk_slots": 0, "topk_keys": 0, "apply_bytes": 0, "apply_tokens": 0, "rounds": 0,
         "apply_keys": 0, "apply_union_keys": 0, "library_ms": 0.0}

    count = tk.pair_count

    def counted(st):
        count(st)  # the wrapper adds its launch to the name it runs under: counted's
        w["count_launches"] += 1
        n_tok = int((st.tok >= 0).sum())
        w["count_tokens"] += n_tok
        w["count_bytes"] += n_tok * 4 + st.n_words * 8 + int(st.ctl[tk.OCC]) * 12

    counted.launches = 0
    with swapped(tk, pair_count=counted):
        eng = engine()
        st = eng.st
        while True:
            keys = int(selection_keys(st.cnts, eng.batch_k))
            w["library_ms"] += library_topk_ms(st.keys, st.cnts)
            tk.topk_accept(st, vocab, vocab, eng.used_ids0, eng.batch_k)
            n_acc = int(st.ctl[tk.NACC])
            if n_acc:
                w["rounds"] += 1
                w["topk_slots"] += st.cap
                w["topk_keys"] += keys
                w["topk_bytes"] += st.cap * 4 + keys * 8 + n_acc * 16
                before, keys0, cnts0 = st.tok.clone(), st.keys.clone(), st.cnts.clone()
                tk.apply_delta(st)
                n_aff = int(st.ctl[tk.NAFF])
                # a word with a hit changes: the words whose slots changed
                hit = torch.zeros(st.n_words, dtype=torch.bool, device=st.device)
                hit[st.pwid[(before != st.tok) & (st.pwid >= 0)].long()] = True
                check(int(hit.sum()) == n_aff, f"{n_aff} words hit, {int(hit.sum())} changed")
                pos = (st.pwid >= 0) & hit[st.pwid.clamp(min=0).long()]
                old_k, old_c = tk._counted_pairs(before)
                new_k, new_c = tk._counted_pairs(st.tok)
                # the keys the round's net deltas move, against the union
                # of the hit words' old and new pairs (logged only)
                changed = int(((st.cnts != cnts0) | (st.keys != keys0)).sum())
                w["apply_keys"] += changed
                w["apply_union_keys"] += torch.unique(
                    torch.cat([old_k[old_c & pos], new_k[new_c & pos]])).numel()
                n_tok = int((before >= 0).sum())
                w["apply_tokens"] += n_tok
                w["apply_bytes"] += (n_tok * 4 + n_aff * 12 + int((before[pos] >= 0).sum()) * 4
                                     + changed * 16)
            used, done, overflow = (int(v) for v in st.ctl[[tk.USED, tk.DONE, tk.OVERFLOW]].tolist())
            if overflow:
                eng.regrow()
            elif done or used >= vocab:
                break
    return eng, w


class swapped:
    """Replace attributes of a module for a block."""

    def __init__(self, mod, **attrs):
        self.mod, self.attrs = mod, attrs

    def __enter__(self):
        self.old = {k: getattr(self.mod, k) for k in self.attrs}
        for k, v in self.attrs.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.mod, k, v)


class env_set:
    """Set environment variables for a block."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plain_v2_rules(corpus_path: Path):
    """The v2 plain round loop on the card over the 100 MB corpus at vocab
    30000 (phase 5's reference rules): (rules, seconds)."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td

    buckets, _, used0 = training_buckets(corpus_path)
    t0 = time.perf_counter()
    rules = td.run_training_delta(buckets, used0, TRAIN_VOCAB, device=torch.device("cuda", 0),
                                  plain=True)
    return rules, time.perf_counter() - t0


def phase_train_main(corpus_path: Path, work: Path, sample, plain) -> dict:
    """The main path: ``BPE.train`` on the 100 MB corpus at vocab 30000 with
    no knob set, launches counted; its rules against the plain round loop
    on the card (``plain``: ``plain_v2_rules``, run beside the other
    checks); the model encodes and decodes; then timed replicas."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_stream as ts
    from youtokentome_tpu_torch.train import rename_tokens

    dev = torch.device("cuda", 0)
    model_path = work / "trained30k.yttm"
    for name in TRAIN_KERNELS:
        getattr(tk, name).launches = 0
    t0 = time.perf_counter()
    with env_set(YTTM_TRAIN_IMPL="delta"):  # the v2 kernels' path; auto takes v5 here
        bpe = yttm.BPE.train(data=str(corpus_path), model=str(model_path), vocab_size=TRAIN_VOCAB)
    train_s = time.perf_counter() - t0
    launches = {name: getattr(tk, name).launches for name in TRAIN_KERNELS}
    log(f"[5] BPE.train with YTTM_TRAIN_IMPL=delta: {train_s:.2f} s; launches {launches}")
    check(bpe.device.type == "cuda", "BPE.train runs on cuda by default")
    for name, n in launches.items():
        check(n > 0, f"the main path did not launch {name}")
    state = BPEState.load(str(model_path))
    check(state.vocab_size() == TRAIN_VOCAB, f"trained vocab {state.vocab_size()}")

    t0 = time.perf_counter()
    buckets, al, used0 = training_buckets(corpus_path, fresh=True)
    prep_s = time.perf_counter() - t0
    plain_rules, plain_loop_s = plain
    char2id, want = rename_tokens(al.char2id, plain_rules, SpecialTokens(0, 1, 2, 3), TRAIN_VOCAB)
    check(state.rules == want and state.char2id == char2id,
          "BPE.train's rules != the plain round loop's on the card")
    log(f"[5] BPE.train's {len(state.rules)} rules == the plain round loop's on the card "
        f"({plain_loop_s:.1f} s, in a worker process beside the other checks)")
    ids = bpe.encode(sample)
    check(bpe.decode(ids) == sample, "the trained model's decode round trip")
    check(all(0 <= min(s) and max(s) < TRAIN_VOCAB for s in ids if s), "ids out of range")
    log(f"[5] the trained model encodes and decodes {len(sample)} lines back")

    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)

    def engine():
        return tk.KernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB, 16, dev)

    # the merge loop alone, timed by the host clock
    eng = engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    used = run_engine(eng, TRAIN_VOCAB, used0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(torch.equal(eng.rules[: used - used0, :3].cpu(), torch.tensor(plain_rules)),
          "the timed kernel run's rules differ")
    rounds, st, relaid = int(eng.st.ctl[tk.ROUND]), eng.st, eng.relaid
    merges = used - used0
    log(f"[5] merge loop (kernels): {loop_s:.3f} s, {rounds} rounds, {merges} merges, "
        f"{merges / loop_s:.0f} merges/s, {eng.rebuilds} table rebuilds, table {st.cap} slots, "
        f"relays (slots before, after) {relaid}")
    t0 = time.perf_counter()
    w_eng, work = run_work(engine, TRAIN_VOCAB)
    check(torch.equal(w_eng.rules, st.rules) and work["rounds"] == rounds,
          "the round-by-round run differs from the main path's")
    log(f"[5] the run's work, one round at a time ({time.perf_counter() - t0:.1f} s): {work}")

    # device time of each kernel over the same run, from the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_engine(engine(), TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
    dev_us = {name: 0.0 for name in TRAIN_KERNELS}
    fn_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name, fns in TRAIN_DEVICE_FNS.items():
            for f in fns:
                if f in ev.key:
                    dev_us[name] += us
                    fn_us[f] = (us, ev.count)
    log("[5] device functions: " + ", ".join(
        f"{f} {us / 1e3:.3f} ms / {n} calls" for f, (us, n) in sorted(fn_us.items())))
    log(f"[5] apply_delta, first {SPLIT_ROUNDS} launches / the rest, ms: " + ", ".join(
        f"{f} {a:.3f} / {b:.3f}" for f, (a, b) in sorted(first_rest_ms(
            prof, TRAIN_DEVICE_FNS["apply_delta"]).items())))
    kernel_ms = {name: dev_us[name] / 1e3 for name in TRAIN_KERNELS}
    for name, v in kernel_ms.items():
        check(v > 0, f"the profiler recorded no device time for {name}")
    log("[5] device ms summed over the run (torch.profiler): "
        + ", ".join(f"{k} {v:.3f}" for k, v in kernel_ms.items()))

    # the plain versions over the same run, each call synchronised
    plain_ms = {name: 0.0 for name in TRAIN_KERNELS}

    def timed_plain(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a, **k)
            torch.cuda.synchronize()
            plain_ms[name] += (time.perf_counter() - t0) * 1e3
        return run

    with swapped(
        tk,
        pair_count=timed_plain("pair_count", plain_pair_count),
        topk_accept=timed_plain(
            "topk_accept", lambda st, limit, v, u0, k=16: tk.topk_accept_plain(st, limit, v, u0, k)),
        apply_delta=timed_plain("apply_delta", tk.apply_delta_plain),
        relay=timed_plain("relay", tk.relay_plain),
    ):
        eng = engine()
        run_engine(eng, TRAIN_VOCAB, used0)
    check(torch.equal(eng.rules, st.rules), "the plain versions' rules differ")
    log(f"[5] plain versions over the same run (synchronised calls): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))

    # bounds, from this run's inputs and the work its data gave each
    # kernel (run_work): each input read once, each output written once
    # (a relay: each word's live tokens and one separator read, the m2
    # slots of the new stream and their words written, the words' offsets
    # and weights read and written; the dead slots are never needed)
    bytes_ = {"pair_count": work["count_bytes"], "topk_accept": work["topk_bytes"],
              "apply_delta": work["apply_bytes"],
              "relay": sum(4 * m2 + 8 * m2 + 16 * st.n_words for _, m2 in relaid)}
    ops = {
        "pair_count": work["count_tokens"] * OPS_PER_COUNTED,
        "topk_accept": work["topk_slots"] * OPS_PER_SLOT,
        "apply_delta": work["apply_tokens"] * OPS_PER_POS,
        "relay": sum(m2 for _, m2 in relaid) * OPS_PER_POS,
    }
    rows = []
    for name in TRAIN_KERNELS:
        b_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        o_ms = ops[name] / OPS_PER_S * 1e3
        rows.append({"name": name, "launches": launches[name], "ms": kernel_ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "library_ms": work["library_ms"] if name == "topk_accept" else None})
        log(f"[5] {name}: {launches[name]} launches, {kernel_ms[name]:.3f} ms on the card, "
            f"bound {max(b_ms, o_ms):.4f} ms ({rows[-1]['bound_by']}), plain {plain_ms[name]:.1f} ms"
            + (f", library (torch.topk of the packed words, selection only) "
               f"{work['library_ms']:.3f} ms" if name == "topk_accept" else ""))
    log(f"[5] times: preprocessing {prep_s:.2f} s, BPE.train {train_s:.2f} s, merge loop "
        f"{loop_s:.3f} s, {rounds} rounds, {merges / loop_s:.0f} merges/s, "
        f"plain round loop {plain_loop_s:.1f} s")
    # the keys each round's selection must read, for the other trainers at
    # k = 16: their rounds see the same live counts (the same rules, round
    # by round; select_keys_of checks the round count)
    return {"rows": rows, "plain_rules": plain_rules, "loop_s": loop_s,
            "select_keys": {"rounds": work["rounds"], "keys": work["topk_keys"]}}


def select_keys_of(w, select_keys: dict, replicas: int, what: str) -> int:
    """The keys that a run's top-k rounds must read (each replica its own),
    from another run over the same rounds: ``select_keys`` is that run's
    {"rounds", "keys"}; ``w`` this run's work counters, summed over its
    replicas, whose rounds must be ``replicas`` times as many."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    rounds = int(w[tk.W_ROUNDS])
    check(rounds == replicas * select_keys["rounds"],
          f"{what}: {rounds} top-k rounds, not {replicas} x {select_keys['rounds']}")
    return replicas * select_keys["keys"]

# -- phase 6: training with the v5 tiered trainer -----------------------------

SPLIT_ROUNDS = 100  # the first rounds, timed apart from the rest


def first_rest_ms(prof, fns, n: int = SPLIT_ROUNDS) -> dict:
    """Per device function whose name contains one of ``fns``: the ms of its
    first ``n`` launches (a round launches each apply function once: the
    first ``n`` rounds) and of the rest, from the profiler's events."""
    import torch

    evs = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            continue
        for f in fns:
            if f in ev.name:
                evs.setdefault(f, []).append((ev.time_range.start, ev.time_range.elapsed_us()))
    out = {}
    for f, v in evs.items():
        v.sort()
        out[f] = (sum(us for _, us in v[:n]) / 1e3, sum(us for _, us in v[n:]) / 1e3)
    return out


def train_split(corpus_path: Path, model_path: Path):
    """``BPE.train`` on the corpus at vocab TRAIN_VOCAB with no knob, its
    seconds split by the host clock: reading and decoding the file,
    preprocessing (characters, alphabet, word buckets), the trainer's own
    set-up (its stream laid out on the host, then the engine built on the
    card, synchronised), the merge loop, and the rest (the rules renamed,
    the model written).  Works on any checkout of the package whose trainer
    is v5 or v2 (``ops/train_tiered.py``, ``ops/train_delta.py``).  Returns
    the split and the trained ``BPE``."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import train as tr
    from youtokentome_tpu_torch.ops import tiered_kernels as tdk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    at = {}

    def marked(key, fn):
        def run(*a, **k):
            at[key] = time.perf_counter()
            out = fn(*a, **k)
            at[key + "_end"] = time.perf_counter()
            return out
        return run

    def built(cls):
        class Built(cls):
            def __init__(self, *a, **k):
                at["engine"] = time.perf_counter()
                super().__init__(*a, **k)
                torch.cuda.synchronize()
                at["engine_end"] = time.perf_counter()
        return Built

    t0 = time.perf_counter()
    with swapped(tr, train_from_codepoints=marked("prep", tr.train_from_codepoints),
                 run_training_tiered=marked("trainer", tr.run_training_tiered),
                 run_training_delta=marked("trainer", tr.run_training_delta)), \
            swapped(tdk, TieredKernelEngine=built(tdk.TieredKernelEngine)), \
            swapped(tk, KernelEngine=built(tk.KernelEngine)):
        bpe = yttm.BPE.train(data=str(corpus_path), model=str(model_path), vocab_size=TRAIN_VOCAB)
    end = time.perf_counter()
    return bpe, {
        "total_s": end - t0, "read_s": at["prep"] - t0, "prep_s": at["trainer"] - at["prep"],
        "layout_s": at["engine"] - at["trainer"], "engine_s": at["engine_end"] - at["engine"],
        "loop_s": at["trainer_end"] - at["engine_end"], "rest_s": end - at["trainer_end"]}


TIERED_KERNELS = ("tier_select", "apply_blocks", "resplit", "fold_rows")
# the device functions of each wrapper, as the profiler names them
TIERED_DEVICE_FNS = {
    "tier_select": ("tier_hot_kernel", "tier_full_kernel"),
    "apply_blocks": ("tier_find_kernel", "tier_apply_kernel", "tier_count_kernel"),
    "resplit": ("resplit_pass_kernel", "hot_clear_kernel", "hot_fill_kernel"),
    "fold_rows": ("fold_fills_kernel", "fold_hist_kernel", "fold_scan_kernel",
                  "fold_place_kernel", "fold_check_kernel", "fold_write_kernel"),
}
TIERED_REPLACES = {
    "tier_select": "youtokentome_tpu/ops/train_tiered.py:193",
    "apply_blocks": "youtokentome_tpu/ops/train_tiered.py:193",
    "resplit": "youtokentome_tpu/ops/train_tiered.py:193",
    "fold_rows": "youtokentome_tpu/ops/train_tiered.py:496",
}
# the 10 MB lockstep run: a hot tier of 1024 entries (refresh rounds), a
# pcap of 1024 (the 702 initial pairs fit; the pairs that merges make do not:
# rebuilds), folds from 64 rows on
MID_HCAP, MID_TIERED_PCAP, MID_FOLD_MIN = 1024, 1024, 64
# integer operations per element, for the operations bound: a table slot
# scanned by a top-k or the resplit's radix passes (10), a row's signature
# test (20), a position of a listed or folded row (40)
OPS_PER_ROW, OPS_PER_ROWPOS = 20, 40
# the phase's hot tier small enough that T comes out above 0 on the main
# path's state (a rank of 128 among its ~1k live pairs), so that the radix
# select runs all its passes and a hot round meets cold keys
SMALL_HCAP = 256


def tiered_inputs(buckets):
    """The tiered host loop's block size and snug block stream."""
    from youtokentome_tpu_torch.ops import train_tiered as tt

    B = tt.tiered_block_size(buckets)
    t, wid, freq = tt.flatten_word_buckets_blocked_snug(buckets, B)
    return t, wid, freq, B


def same_tiered(a, b, what: str) -> None:
    """Kernel state ``a`` and plain state ``b`` agree: stream, signatures,
    both tables as multisets of (key, count) slots (the hot one unless it
    overflowed), ctl, rules and the accepted rows."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    check(torch.equal(a.tok, b.tok) and torch.equal(a.wid, b.wid), f"{what}: streams differ")
    check(torch.equal(a.sig, b.sig), f"{what}: signatures differ")
    ka, ca = a.table()
    kb, cb = b.table()
    check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: full tables differ")
    check(int(ca.min(initial=0)) >= 0, f"{what}: a negative pair count")
    check(torch.equal(a.ctl, b.ctl), f"{what}: ctl {a.ctl.tolist()} != {b.ctl.tolist()}")
    if not int(a.ctl[tk.HOT_OVF]):
        ka, ca = a.hot_table()
        kb, cb = b.hot_table()
        check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: hot tables differ")
    check(torch.equal(a.rules, b.rules), f"{what}: rules differ")
    n = int(a.ctl[tk.NACC])
    check(torch.equal(a.cand[:n], b.cand[:n]), f"{what}: accepted rows differ")


def plain_tiered_count(st) -> None:
    """apply_blocks's count mode, plain, behind the wrapper's table reset."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    st.keys.fill_(tk.EMPTY)
    st.cnts.zero_()
    st.ctl[[tk.OCC, tk.OVERFLOW]] = 0
    tk.apply_blocks_plain(st, True, 0, 0)


def check_threshold(st, hcap: int, what: str) -> int:
    """T after a resplit equals the JAX package's two definitions (the
    sorted full table with its zeros, and the live entries only), and the
    hot table holds exactly the keys above it."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk
    from youtokentome_tpu_torch.ops import train_tiered as tt

    T = int(st.ctl[tk.THRESH])
    keys, cnts = st.table()
    _, _, t_sorted = tt._resplit(st.keys.cpu(), st.cnts.cpu(), hcap)
    live = cnts > 0
    _, _, t_host = tt.host_resplit(keys[live].astype(np.uint64), cnts[live], hcap, "cpu")
    check(T == t_sorted == t_host, f"{what}: T {T}, _resplit {t_sorted}, host_resplit {t_host}")
    hk, hc = st.hot_table()
    check(np.array_equal(hk, keys[cnts > T]) and np.array_equal(hc, cnts[cnts > T]),
          f"{what}: the hot table is not the keys above T")
    return T


def check_hot_tier(st, what: str) -> int:
    """The kernel engine's hot-tier invariant between resplits: every key of
    the hot table is in the full table with the same count (no partial
    count), and every key of the full table above T is in the hot table.
    Returns the number of live cold keys (in the full table only)."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    T = int(st.ctl[tk.THRESH])
    keys, cnts = st.table()
    hk, hc = st.hot_table()
    at = np.minimum(np.searchsorted(keys, hk), max(keys.size - 1, 0))
    check(keys.size > 0 and np.array_equal(keys[at], hk) and np.array_equal(cnts[at], hc),
          f"{what}: a hot count differs from the full table's")
    check(np.isin(keys[cnts > T], hk).all(), f"{what}: a key above T {T} is not in the hot table")
    return int(np.count_nonzero(~np.isin(keys, hk) & (cnts > 0)))


def phase_tiered_kernels(buckets, used0: int, dev) -> dict:
    """Each tiered kernel against its plain version on the card, on the
    main path's state (the 100 MB corpus's block stream and tables): the
    count, a refresh round with its resplit, two hot rounds, a forced
    refresh round; a resplit at a small hcap (T above 0: every pass of the
    radix select) and a hot round at that T, which meets cold keys; and the
    row fold (its plan on this stream, and a fold of the rows cut to their
    first words, both through the host loop's trigger)."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_tiered as tt

    t, wid, freq, B = tiered_inputs(buckets)
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
    eng = tk.TieredKernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB, 16, B, dev)
    st = eng.st
    log(f"[6] main-path state: B {B}, {st.NB} rows ({st.tok.shape[0]} slots), full table "
        f"{st.cap} slots, hot table {st.hslots} slots (hcap {eng.hcap}), tiers {eng.sizes}")
    plain = clone_state(st)
    plain_tiered_count(plain)
    same_tiered(st, plain, "apply_blocks count mode")
    uk, uc = td.host_count_table(t, wid, freq)
    keys, cnts = st.table()
    check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
          "the count != the host count table")
    check(torch.equal(st.sig, tt.sig_build_host(t.reshape(-1, B), dev)), "signatures != sig_build")
    log(f"[6] apply_blocks count mode == plain == host count table ({uk.size} pairs); "
        f"signatures == sig_build")

    kb1, kb2 = eng._kb()
    k_st, p_st = clone_state(st), clone_state(st)
    for r in range(4):
        if r == 3:  # force a refresh round
            k_st.ctl[tk.HOT_OVF] = 1
            p_st.ctl[tk.HOT_OVF] = 1
        limit = used0 + TRAIN_SEG
        tk.tier_select(k_st, limit, TRAIN_VOCAB, used0)
        tk.tier_select_plain(p_st, limit, TRAIN_VOCAB, used0, 16)
        same_tiered(k_st, p_st, f"tier_select round {r}")
        tk.apply_blocks(k_st, kb1, kb2)
        tk.apply_blocks_plain(p_st, False, kb1, kb2)
        same_tiered(k_st, p_st, f"apply_blocks round {r}")
        tk.resplit(k_st, eng.hcap)
        tk.resplit_plain(p_st, eng.hcap // 2)
        same_tiered(k_st, p_st, f"resplit round {r}")
        refresh = int(k_st.ctl[tk.REFRESH])
        check(refresh == (r in (0, 3)), f"round {r}: refresh {refresh}")
        note = ""
        if refresh:
            note = f", T {check_threshold(k_st, eng.hcap, f'round {r}')} (== both JAX definitions)"
        log(f"[6] round {r} ({'refresh' if refresh else 'hot'}): tier_select, apply_blocks and "
            f"resplit == plain ({int(k_st.ctl[tk.NACC])} accepted, {int(k_st.ctl[tk.NBAFF])} rows "
            f"listed{note})")

    # round 3 was a refresh round that merged, so a resplit is due again:
    # at a small hcap, T is the count at rank 128, above 0
    tk.resplit(k_st, SMALL_HCAP)
    tk.resplit_plain(p_st, SMALL_HCAP // 2)
    same_tiered(k_st, p_st, f"resplit at hcap {SMALL_HCAP}")
    T = check_threshold(k_st, SMALL_HCAP, f"resplit at hcap {SMALL_HCAP}")
    check(T > 0, f"resplit at hcap {SMALL_HCAP}: T {T}")
    check_hot_tier(k_st, f"resplit at hcap {SMALL_HCAP}")
    # a hot round at that T: its words' pairs hold cold keys, whose deltas
    # go to the full table only
    tk.tier_select(k_st, used0 + TRAIN_SEG, TRAIN_VOCAB, used0)
    tk.tier_select_plain(p_st, used0 + TRAIN_SEG, TRAIN_VOCAB, used0, 16)
    same_tiered(k_st, p_st, f"tier_select at T {T}")
    check(not int(k_st.ctl[tk.REFRESH]) and int(k_st.ctl[tk.NACC]) > 0,
          f"the round at T {T} is not a hot round that merges")
    before = k_st.cnts.clone()
    tk.apply_blocks(k_st, kb1, kb2)
    tk.apply_blocks_plain(p_st, False, kb1, kb2)
    same_tiered(k_st, p_st, f"apply_blocks at T {T}")
    changed = k_st.keys[k_st.cnts != before]
    cold = int((~torch.isin(changed, k_st.hkeys)).sum())
    check(cold > 0, f"the hot round at T {T} changed no cold key")
    n_cold = check_hot_tier(k_st, f"the hot round at T {T}")
    log(f"[6] resplit at hcap {SMALL_HCAP} == plain, T {T} (== both JAX definitions); a hot round "
        f"at that T == plain ({int(k_st.ctl[tk.NACC])} accepted, {int(k_st.ctl[tk.NBAFF])} rows "
        f"listed, {changed.numel()} counts changed, {cold} of them cold keys left out of the hot "
        f"table); hot counts == full counts, every key above T hot, {n_cold} cold keys")

    # the fold through the host loop's trigger (a low YTTM_TRAIN_FOLD_MIN):
    # the plan on the main-path stream, then the fold of the rows cut to
    # their first word (under 45 % full), kernel vs plain
    with env_set(YTTM_TRAIN_FOLD_MIN="1"):
        k_f, p_f = clone_state(k_st), clone_state(k_st)
        folded = tk.fold_rows(k_f)
        check(tk.fold_rows_plain(p_f) == folded, "fold_rows: plans disagree")
        same_tiered(k_f, p_f, "fold_rows plan on the main-path stream")
        most = int(k_f.ctl[tk.FOLD_MAX])
        w2d = k_st.wid.reshape(-1, B)
        first = (w2d == w2d[:, :1]) & (k_st.tok.reshape(-1, B) >= 0)
        k_f = clone_state(k_st)
        k_f.tok = torch.where(first, k_st.tok.reshape(-1, B), -1).reshape(-1)
        k_f.wid = torch.where(first, w2d, -1).reshape(-1)
        p_f = clone_state(k_f)
        check(tk.fold_rows(k_f), "fold_rows did not fold the first-word rows")
        check(tk.fold_rows_plain(p_f), "fold_rows_plain did not fold the first-word rows")
        same_tiered(k_f, p_f, "fold_rows on the first-word rows")
    log(f"[6] fold_rows == plain: the plan on the main-path stream (largest pair fill {most} "
        f"of {B}; folded: {folded}), and the fold of the first-word rows ({k_st.NB} -> "
        f"{k_f.NB} rows)")
    return {"B": B}


def tiered_full_table(plain):
    """The plain engine's exact full table, cold + pending: sorted (keys,
    counts) of the live pairs (numpy)."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td

    keys = torch.cat([plain.ck, plain.qk])
    fk, fc, n = td._reduce_by_key(keys, torch.cat([plain.ccold, plain.qv]), keys.shape[0])
    return fk[:n].cpu().numpy(), fc[:n].cpu().numpy()


def phase_tiered_mid(mid_path: Path, dev) -> dict:
    """The 10 MB prefix at vocab 8000 through the tiered kernel engine and
    the plain tiered round loop, both on the card, in lockstep, with a hot
    tier of 1024 (refresh rounds), a pcap of 1024 (rebuilds) and folds
    from 64 rows: stream, signatures, the live full table and rules
    equal after every segment, and the kernel engine's hot tier exact
    (``check_hot_tier``) wherever it has not overflowed."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk
    from youtokentome_tpu_torch.ops import train_tiered as tt

    buckets, _, used0 = training_buckets(mid_path)
    t, wid, freq, B = tiered_inputs(buckets)
    rules = np.full((MID_VOCAB, 4), -1, np.int32)
    t0 = time.perf_counter()
    with env_set(YTTM_TRAIN_HCAP=str(MID_HCAP), YTTM_TRAIN_FOLD_MIN=str(MID_FOLD_MIN),
                 YTTM_TRAIN_PCAP=str(MID_TIERED_PCAP)):
        kern = tk.TieredKernelEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, B, dev)
        plain = tt.PlainTieredEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, B, dev)
        used, segs, refresh, nb0, hot_ends = used0, 0, 0, kern.st.NB, 0
        while used < MID_VOCAB:
            limit = min(MID_VOCAB, used + TRAIN_SEG)
            ku, kd = complete_segment(kern, used, limit)
            refresh += kern.stats[1]
            pu, pd = complete_segment(plain, used, limit)
            what = f"segment to {limit}"
            check((ku, kd) == (pu, pd), f"{what}: kernel {ku, kd} != plain {pu, pd}")
            st = kern.st
            check(torch.equal(st.tok, plain.t) and torch.equal(st.wid, plain.wid),
                  f"{what}: streams differ")
            check(torch.equal(st.sig, plain.sig), f"{what}: signatures differ")
            keys, cnts = st.table()
            check(int(cnts.min(initial=0)) >= 0, f"{what}: a negative pair count")
            fk, fc = tiered_full_table(plain)
            check(np.array_equal(keys[cnts > 0], fk) and np.array_equal(cnts[cnts > 0], fc),
                  f"{what}: live full tables differ")
            check(torch.equal(kern.rules, plain.rules), f"{what}: rules differ")
            if not int(st.ctl[tk.HOT_OVF]):
                check_hot_tier(st, what)
                hot_ends += int(st.ctl[tk.THRESH]) > 0
            used, segs = ku, segs + 1
            if kd:
                break
    check(kern.rebuilds >= 1, "the tiered mid-size run never rebuilt its table")
    check(kern.folds >= 1, "the tiered mid-size run never folded its rows")
    check(refresh >= 2, "the tiered mid-size run refreshed no more than once")
    check(hot_ends >= 1, "no segment of the tiered mid-size run ended with a hot tier above T > 0")
    log(f"[6] mid-size tiered: vocab {MID_VOCAB}, B {B}: kernels == plain tiered round loop at "
        f"all {segs} segment ends (stream, signatures, live full table, rules); hot counts == "
        f"full counts and every key above T hot ({hot_ends} ends with T > 0); {refresh} "
        f"refresh rounds, {kern.rebuilds} table rebuilds, {kern.folds} folds ({nb0} -> "
        f"{kern.st.NB} rows) ({time.perf_counter() - t0:.1f} s)")
    return {"segments": segs, "refresh": refresh, "rebuilds": kern.rebuilds, "folds": kern.folds}


def run_tiered(eng, vocab: int, used: int) -> int:
    """run_training_tiered's loop over segments of TRAIN_SEG ids."""
    while used < vocab:
        used, done = complete_segment(eng, used, min(vocab, used + TRAIN_SEG))
        check(int(eng.st.cnts.min()) >= 0, "a negative pair count")
        if done:
            break
    return used


def run_tiered_work(engine, vocab: int):
    """The main path's tiered run once more through the engine's own
    segments, with each kernel's wrapper wrapped to read the state around
    every call (the same rounds; each call now waits for the card), summing
    the work that this run's data gives each kernel, for the bounds (bytes;
    each input read once, each output written once):

      tier_select   per round: the hot table's counts and the keys of its
                    slots whose count reaches its 16th (selection_keys); on
                    a refresh round the full table's too; the accepted rows
      apply_blocks  per round that merges: every row's signature; per listed
                    row (NBAFF) its tokens and word ids read and written and
                    its signature written; per slot whose count the round
                    changed, in either table, its key read and its count
                    read and written; a count: the live tokens, the filled
                    slots and every signature
      resplit       the full table's counts, the keys above T read and
                    written into the hot table, the hot table cleared
      fold_rows     the plan: the stream's tokens, fills and order; a fold:
                    the stream read, half of it and its signatures written

    Returns the engine, each kernel's bytes and operations, and the counts
    of rounds and refresh rounds, with library_topk_ms summed over the hot
    tables before each tier_select."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    w = {name: 0 for name in TIERED_KERNELS}
    ops = {name: 0 for name in TIERED_KERNELS}
    n = {"rounds": 0, "refresh": 0, "library_ms": 0.0}
    real = {name: getattr(tk, name) for name in TIERED_KERNELS}

    def select(st, limit, vocab_size, used_ids0, k=tk.K_MAX):
        n["library_ms"] += library_topk_ms(st.hkeys, st.hcnts)  # the hot pass's yardstick
        real["tier_select"](st, limit, vocab_size, used_ids0, k)  # it moves no count
        n_acc, refresh, active = (int(v) for v in st.ctl[[tk.NACC, tk.REFRESH, tk.ACTIVE]].tolist())
        if active:
            n["rounds"] += 1
            n["refresh"] += refresh
            w["tier_select"] += st.hslots * 4 + int(selection_keys(st.hcnts, k)) * 8 + n_acc * 16
            ops["tier_select"] += st.hslots * 10
            if refresh:
                w["tier_select"] += st.cap * 4 + int(selection_keys(st.cnts, k)) * 8
                ops["tier_select"] += st.cap * 10

    def apply(st, kb1=0, kb2=0, count_mode=False):
        if count_mode:
            real["apply_blocks"](st, kb1, kb2, count_mode)
            n_tok = int((st.tok >= 0).sum())
            w["apply_blocks"] += n_tok * 8 + int(st.ctl[tk.OCC]) * 12 + st.NB * 64
            ops["apply_blocks"] += n_tok * OPS_PER_ROWPOS
            return
        cnts, hcnts = st.cnts.clone(), st.hcnts.clone()
        real["apply_blocks"](st, kb1, kb2)
        if int(st.ctl[tk.NACC]):
            n_rows = int(st.ctl[tk.NBAFF])
            changed = int((st.cnts != cnts).sum()) + int((st.hcnts != hcnts).sum())
            w["apply_blocks"] += st.NB * 64 + n_rows * (st.B * 16 + 64) + changed * 16
            ops["apply_blocks"] += st.NB * OPS_PER_ROW + n_rows * st.B * OPS_PER_ROWPOS

    def split(st, hcap):
        refresh, n_acc, overflow = (int(v) for v in st.ctl[[tk.REFRESH, tk.NACC, tk.OVERFLOW]].tolist())
        real["resplit"](st, hcap)
        if refresh and n_acc and not overflow:
            w["resplit"] += st.cap * 4 + int(st.ctl[tk.HOCC]) * 24 + st.hslots * 12
            ops["resplit"] += st.cap * 10

    def fold(st):
        m, NB, due = st.NB * st.B, st.NB, tk._fold_due(st)
        folded = real["fold_rows"](st)
        if due:
            w["fold_rows"] += m * 4 + NB * 8
            ops["fold_rows"] += m * 2
        if folded:
            w["fold_rows"] += m * 8 + m // 2 * 8 + NB // 2 * 64
            ops["fold_rows"] += m * 2
        return folded

    for f in (select, apply, split, fold):
        f.launches = 0  # the real wrappers count their launches under these names
    with swapped(tk, tier_select=select, apply_blocks=apply, resplit=split, fold_rows=fold):
        eng = engine()
        run_tiered(eng, vocab, eng.used_ids0)
    return eng, w, ops, n


def phase_tiered_main(corpus_path: Path, work: Path, sample, v2_rules) -> dict:
    """The main path: ``BPE.train`` on the 100 MB corpus at vocab 30000 with
    no knob set takes the v5 tiered trainer, launches counted (the v2
    kernels none); its rules against the v2 plain round loop's on the card
    (phase 5); the model encodes and decodes; then timed replicas."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens
    from youtokentome_tpu_torch.ops import tiered_kernels as tk
    from youtokentome_tpu_torch.ops import train_kernels as v2
    from youtokentome_tpu_torch.train import rename_tokens

    dev = torch.device("cuda", 0)
    model_path = work / "trained30k_tiered.yttm"
    for name in TIERED_KERNELS:
        getattr(tk, name).launches = 0
    for name in TRAIN_KERNELS:
        getattr(v2, name).launches = 0
    check("YTTM_TRAIN_IMPL" not in os.environ, "a trainer is forced")
    bpe, split = train_split(corpus_path, model_path)
    train_s = split["total_s"]
    launches = {name: getattr(tk, name).launches for name in TIERED_KERNELS}
    v2_launches = {name: getattr(v2, name).launches for name in TRAIN_KERNELS}
    log(f"[6] main path BPE.train (auto): {train_s:.2f} s; launches {launches}, v2 {v2_launches}")
    check(bpe.device.type == "cuda", "BPE.train runs on cuda by default")
    for name, n in launches.items():
        check(n > 0, f"the main path did not launch {name}")
    check(not any(v2_launches.values()), "the main path launched v2 kernels")
    _, again = train_split(corpus_path, work / "trained30k_tiered_again.yttm")
    log("[6] BPE.train (auto) split by the host clock, s (first run, second run): " + ", ".join(
        f"{k[:-2]} {split[k]:.3f}, {again[k]:.3f}" for k in split))
    state = BPEState.load(str(model_path))
    check(BPEState.load(str(work / "trained30k_tiered_again.yttm")).rules == state.rules,
          "the second BPE.train's rules differ")
    buckets, al, used0 = training_buckets(corpus_path)
    char2id, want = rename_tokens(al.char2id, v2_rules, SpecialTokens(0, 1, 2, 3), TRAIN_VOCAB)
    check(state.rules == want and state.char2id == char2id,
          "BPE.train's v5 rules != the v2 plain round loop's on the card")
    log(f"[6] BPE.train's {len(state.rules)} rules (v5 kernels) == the v2 plain round loop's")
    ids = bpe.encode(sample)
    check(bpe.decode(ids) == sample, "the trained model's decode round trip")
    log(f"[6] the trained model encodes and decodes {len(sample)} lines back")

    t, wid, freq, B = tiered_inputs(buckets)
    del buckets
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
    want_rules = torch.tensor(v2_rules)

    def engine():
        return tk.TieredKernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB, 16, B, dev)

    # the merge loop alone, timed by the host clock
    eng = engine()
    nb0 = eng.st.NB
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    used = run_tiered(eng, TRAIN_VOCAB, used0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(torch.equal(eng.rules[: used - used0, :3].cpu(), want_rules),
          "the timed tiered run's rules differ")
    rounds, st = int(eng.st.ctl[tk.ROUND]), eng.st
    merges = used - used0
    log(f"[6] merge loop (tiered kernels): {loop_s:.3f} s, {rounds} rounds, {eng.folds} folds "
        f"({nb0} -> {st.NB} rows of {B}), {eng.rebuilds} table rebuilds, {merges} merges, "
        f"{merges / loop_s:.0f} merges/s")
    t0 = time.perf_counter()
    w_eng, wbytes, wops, counts = run_tiered_work(engine, TRAIN_VOCAB)
    check(torch.equal(w_eng.rules, st.rules) and counts["rounds"] == rounds
          and w_eng.folds == eng.folds, "the round-by-round tiered run differs from the main path's")
    refresh = counts["refresh"]
    log(f"[6] the run's work, one round at a time ({time.perf_counter() - t0:.1f} s): "
        f"{refresh} refresh rounds; bytes {wbytes}, operations {wops}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_tiered(engine(), TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
    dev_us = {name: 0.0 for name in TIERED_KERNELS}
    fn_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name, fns in TIERED_DEVICE_FNS.items():
            for f in fns:
                if f in ev.key:
                    dev_us[name] += us
                    fn_us[f] = (us, ev.count)
    log("[6] device functions: " + ", ".join(
        f"{f} {us / 1e3:.3f} ms / {n} calls" for f, (us, n) in sorted(fn_us.items())))
    log(f"[6] apply_blocks, first {SPLIT_ROUNDS} launches / the rest, ms: " + ", ".join(
        f"{f} {a:.3f} / {b:.3f}" for f, (a, b) in sorted(first_rest_ms(
            prof, TIERED_DEVICE_FNS["apply_blocks"]).items())))
    kernel_ms = {name: dev_us[name] / 1e3 for name in TIERED_KERNELS}
    for name, v in kernel_ms.items():
        check(v > 0, f"the profiler recorded no device time for {name}")

    plain_ms = {name: 0.0 for name in TIERED_KERNELS}

    def timed_plain(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            plain_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def apply_plain(st, kb1=0, kb2=0, count_mode=False):
        if count_mode:
            plain_tiered_count(st)
        else:
            tk.apply_blocks_plain(st, False, kb1, kb2)

    with swapped(
        tk,
        tier_select=timed_plain(
            "tier_select", lambda st, limit, v, u0, k=16: tk.tier_select_plain(st, limit, v, u0, k)),
        apply_blocks=timed_plain("apply_blocks", apply_plain),
        resplit=timed_plain("resplit", lambda st, hcap: tk.resplit_plain(st, hcap // 2)),
        fold_rows=timed_plain("fold_rows", tk.fold_rows_plain),
    ):
        p_eng = engine()
        run_tiered(p_eng, TRAIN_VOCAB, used0)
    check(torch.equal(p_eng.rules, st.rules), "the tiered plain versions' rules differ")
    log("[6] plain versions over the same run (synchronised calls): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))

    rows = []
    for name in TIERED_KERNELS:
        b_ms = wbytes[name] / HBM_BYTES_PER_S * 1e3
        o_ms = wops[name] / OPS_PER_S * 1e3
        rows.append({"name": name, "launches": launches[name], "ms": kernel_ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "library_ms": counts["library_ms"] if name == "tier_select" else None})
        log(f"[6] {name}: {launches[name]} launches, {kernel_ms[name]:.3f} ms on the card, "
            f"bound {max(b_ms, o_ms):.4f} ms ({rows[-1]['bound_by']}), plain "
            f"{plain_ms[name]:.1f} ms")
    log(f"[6] times: BPE.train {train_s:.2f} s, merge loop {loop_s:.3f} s, {rounds} rounds, "
        f"{refresh} refresh rounds, {eng.folds} folds, {merges / loop_s:.0f} merges/s")
    return {"rows": rows}


# -- phase 7: BPE-dropout ----------------------------------------------------

DROPOUT_P = 0.1
DROPOUT_SEED = 0x5EED0D20
DROPOUT_REPLACES = "youtokentome_tpu/ops/encode_kernel.py:160"
# integer operations of the dropout kernel beyond its pair lookups
# (OPS_PER_PAIR each: every pair once, and the two pairs a merge makes):
# the coin of a candidate (three murmur steps and the finalizer, ~24) and
# its compare and min (~6)
OPS_PER_COIN = 30


def profiled_ms(prof, names) -> float:
    """Device milliseconds the profiler gives the functions whose names
    contain one of ``names``."""
    us = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            us += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
    return us / 1e3


def synced(fn):
    """(fn(), milliseconds), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_dropout_kernels(kchk: dict, dev="cuda:0") -> None:
    """The dropout kernel against its plain version on phase 2's rows
    (R = 8192, every cap), and its two ends: p = 0 and p = 1."""
    import torch

    from youtokentome_tpu_torch.ops import encode_kernel as ek

    tables = kchk["tables"]
    for cap, mat in kchk["rows"].items():
        x = torch.from_numpy(mat).to(dev)
        merges = {}
        for p in (0.1, 0.5):
            got = ek.encode_dropout(tables, x, p, DROPOUT_SEED, cap)
            want = ek.encode_dropout_plain(tables, x, p, DROPOUT_SEED, cap)
            check(torch.equal(got, want), f"dropout kernel != plain at cap {cap}, p {p}")
            merges[p] = int((x >= 0).sum() - (got >= 0).sum())
        check(torch.equal(ek.encode_dropout(tables, x, 0.0, DROPOUT_SEED), ek.encode_greedy(tables, x)),
              f"dropout at p 0 != the greedy kernel at cap {cap}")
        check(torch.equal(ek.encode_dropout(tables, x, 1.0, DROPOUT_SEED), x),
              f"dropout at p 1 changed the rows at cap {cap}")
        log(f"[7] cap {cap:3d} R {x.shape[0]}: dropout kernel == plain at p 0.1 and 0.5 "
            f"({merges[0.1]} and {merges[0.5]} merges); p 0 == greedy kernel, p 1 == input")


def phase_dropout_main(main: dict, lines, card: str) -> dict:
    """The main path: ``BPE.encode(lines, dropout_prob=0.1)`` over the 100 MB
    corpus on the native route and, with YTTM_DROPOUT_NATIVE=0, through the
    kernel (launches counted); checks; then the kernel, its plain version
    and its work on every input the main path gave it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import encoder as encoder_mod
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    n_bytes = len(main["blob"])
    sample = lines[:2000]
    bpe = yttm.BPE(str(main["model_path"]), device=main["device"])
    real = ek.encode_dropout
    calls = []

    def recorded(tables, toks, p, seed, row0=0):
        calls.append((toks, seed, row0))
        return real(tables, toks, p, seed, row0)

    ek.encode_dropout.launches = 0
    with env_set(YTTM_DROPOUT_NATIVE="1"):
        native, native_s = timed(lambda: bpe.encode(
            lines, dropout_prob=DROPOUT_P, generator=torch.Generator().manual_seed(1)))
    check(ek.encode_dropout.launches == 0, "the native dropout route launched the kernel")
    with env_set(YTTM_DROPOUT_NATIVE="0"), swapped(encoder_mod, encode_dropout=recorded):
        ek.encode_dropout.launches = 0
        kern, kern_s = timed(lambda: bpe.encode(
            lines, dropout_prob=DROPOUT_P, generator=torch.Generator().manual_seed(2)))
        launches = ek.encode_dropout.launches
    log(f"[7] main path BPE.encode(lines, dropout_prob={DROPOUT_P}): native route {native_s:.2f} s "
        f"({n_bytes / 1e6 / native_s:.2f} MB/s, no launch); YTTM_DROPOUT_NATIVE=0 {kern_s:.2f} s "
        f"({n_bytes / 1e6 / kern_s:.2f} MB/s), encode_dropout launches {launches} ({card})")
    check(bpe.device.type != "cuda" or launches == len(calls) > 0,
          "the kernel route did not launch encode_dropout")
    for name, ids in (("native", native), ("kernel", kern)):
        check(bpe.decode(ids[: len(sample)]) == sample, f"{name}-route dropout ids do not decode back")
    ln = np.array([len(r) for r in native], np.float64)
    lk = np.array([len(r) for r in kern], np.float64)
    greedy = float(np.mean([len(r) for r in main["ids"]]))
    se = float(np.sqrt(ln.var(ddof=1) / ln.size + lk.var(ddof=1) / lk.size))
    z = (lk.mean() - ln.mean()) / se
    check(abs(z) < 5, f"mean ids a line: kernel {lk.mean():.4f}, native {ln.mean():.4f} ({z:.2f} SE)")
    check(min(ln.mean(), lk.mean()) > greedy, "dropout did not lengthen the encoding")
    subs = bpe.encode(sample, output_type=yttm.OutputType.SUBWORD, dropout_prob=DROPOUT_P)
    check(all("".join(s).replace("▁", " ")[1:] == t for s, t in zip(subs, sample)),
          "dropout subwords do not spell the text")
    log(f"[7] {len(sample)} lines decode back on both routes; mean ids a line: kernel "
        f"{lk.mean():.4f}, native {ln.mean():.4f} ({z:+.2f} SE), greedy {greedy:.4f}; dropout "
        f"subwords spell the sample")
    del native, kern, subs

    # the kernel on every input of the main path, under the profiler; the
    # plain version on the same inputs, each call synchronised, equal
    tables = bpe._encoder.tables
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [real(tables, x, DROPOUT_P, seed, row0) for x, seed, row0 in calls]
        torch.cuda.synchronize()
    k_ms = profiled_ms(prof, ("encode_dropout_kernel",))
    check(k_ms > 0, "the profiler recorded no device time for encode_dropout")
    p_ms, merges = 0.0, 0
    for (x, seed, row0), out in zip(calls, outs):
        want, ms = synced(lambda: ek.encode_dropout_plain(tables, x, DROPOUT_P, seed, row0))
        p_ms += ms
        check(torch.equal(out, want), "dropout kernel != plain on a main-path input")
        merges += int((x >= 0).sum() - (out >= 0).sum())
    del outs
    # the work this run's data gives the kernel, counted by the kernel
    # itself in one more pass (coins drawn, merges, initial pair lookups)
    work = torch.zeros(3, dtype=torch.int64, device=tables.rules_z.device)
    if work.is_cuda:
        for x, seed, row0 in calls:
            real(tables, x, DROPOUT_P, seed, row0, work=work)
    coins, k_merges, pairs = work.tolist()
    check(not work.is_cuda or k_merges == merges, f"the kernel counted {k_merges} merges, not {merges}")
    elems = sum(x.numel() for x, _, _ in calls)
    shapes = sorted({tuple(x.shape) for x, _, _ in calls})
    b_ms = elems * 8 / HBM_BYTES_PER_S * 1e3
    o_ms = ((pairs + 2 * merges) * OPS_PER_PAIR + coins * OPS_PER_COIN) / OPS_PER_S * 1e3
    log(f"[7] main-path inputs ({launches} launches, shapes {shapes}): kernel == plain on every "
        f"one; {pairs} pairs, {coins} coins, {merges} merges; kernel {k_ms:.3f} ms "
        f"(torch.profiler), bytes bound {b_ms:.4f} ms, operations "
        f"bound {o_ms:.4f} ms, plain {p_ms:.1f} ms ({card})")
    row = {"name": "encode_dropout", "launches": launches, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    return {"row": row, "native_mbps": n_bytes / 1e6 / native_s, "kernel_mbps": n_bytes / 1e6 / kern_s}


# -- phase 8: the flat stream backend -----------------------------------------

STREAM_KERNELS = ("stream_build", "stream_dedup", "stream_merge")
STREAM_REPLACES = {
    "stream_build": "youtokentome_tpu/ops/stream_kernel.py:159",
    "stream_dedup": "youtokentome_tpu/ops/stream_kernel.py:240",
    "stream_merge": "youtokentome_tpu/ops/stream_kernel.py:361",
}
# each stage is profiled in a window of its own: its kernels, the shared
# scans, its memsets and copies
STREAM_DEVICE_FNS = {
    "stream_build": ("decode_kernel", "gather_chars_kernel", "classify_kernel",
                     "segment_base_kernel", "emit_kernel"),
    "stream_dedup": ("word_starts_kernel", "word_hash_kernel", "word_insert_kernel",
                     "word_rep_kernel", "words_out_kernel", "tokens_out_kernel"),
    "stream_merge": ("merge_words_kernel", "occ_len_kernel", "fill_tail_kernel", "expand_kernel"),
}
STREAM_SHARED_FNS = ("tile_sums_kernel", "tile_offsets_kernel", "scan_apply_kernel", "Memset",
                     "Memcpy DtoD")
# integer operations a byte of the build (decode, class, search: 20) and a
# token of the dedup (two hashes and the table probe: 20)
OPS_PER_BYTE, OPS_PER_TOKEN = 20, 20


def crafted_chunk(lines) -> bytes:
    """Corpus lines, then invalid bytes (a lone continuation, an invalid
    lead, a truncated 3-byte char, a surrogate, an overlong char), 2-, 3-
    and 4-byte chars, unknown chars, every whitespace kind and U+2581,
    empty lines, a 10,000-char word, and a chunk that ends mid-char."""
    rng = np.random.default_rng(SEED + 3)
    long_word = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), 10_000))
    return (("\n".join(lines[:200]) + "\n").encode()
            + b"\x80\xff ab\xe2\x82 \xed\xa0\x80 \xc0\xaf xyz\t\r\v\f\xe2\x96\x81ab "
            + "\u00e9t\u00e9 \u20ac \U0001F600 Qq QQ\n\n".encode()
            + long_word.encode() + b" ab\n" + b"ab " * 50 + b"\n\xf0\x9f")


def same_words(a, b) -> bool:
    """Two ``StreamWords`` agree: counts, the unique stream, and the valid
    prefixes of the per-word arrays."""
    import torch

    counts = [(int(getattr(a, f)), int(getattr(b, f))) for f in ("n_tokens", "n_words", "n_unique")]
    if any(x != y for x, y in counts):
        return False
    _, nw, nu = (c[0] for c in counts)
    return (torch.equal(a.ut, b.ut) and torch.equal(a.uwid, b.uwid)
            and torch.equal(a.occ_uid[:nw], b.occ_uid[:nw])
            and torch.equal(a.ustart[:nu], b.ustart[:nu]) and torch.equal(a.ulen[:nu], b.ulen[:nu]))


def phase_stream_kernels(main: dict, lines, dev="cuda:0") -> None:
    """Each stream kernel against its plain version on the corpus's first
    1 MiB chunk and on a crafted chunk (fed the plain version's inputs)."""
    import torch

    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.ops import stream_kernel as sk

    enc = Encoder(main["state"], device=main["device"] or dev)
    st = enc._stream
    first = next(sk.StreamEncoder.chunks(main["blob"], sk.DEFAULT_CHUNK))
    for name, data in (("first 1 MiB chunk", first), ("crafted chunk", crafted_chunk(lines))):
        x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        kt, kw, kn = sk.stream_build(x, st.alpha_cps, st.alpha_ids, st.space_id)
        pt, pw, pn = sk.build_stream(x, st.alpha_cps, st.alpha_ids, st.space_id)
        check(int(kn) == int(pn) and torch.equal(kt, pt) and torch.equal(kw, pw),
              f"stream_build != plain on the {name}")
        kd, pd = sk.stream_dedup(pt, pw, pn), sk.dedup_words(pt, pw, pn)
        check(same_words(kd, pd), f"stream_dedup != plain on the {name}")
        for unk in (None, main["unk"]):
            ko, kk = sk.stream_merge(enc.tables, pd, unk)
            po, pk = sk.stream_merge_plain(enc.tables, pd, unk)
            check(int(kk) == int(pk) and torch.equal(ko, po),
                  f"stream_merge != plain on the {name} (unk {unk})")
        nu = int(pd.n_unique)
        longest = int(pd.ulen[:nu].max())
        check(name == "first 1 MiB chunk" or longest > 512, "no word past the shared-memory path")
        log(f"[8] {name} ({len(data)} bytes): stream_build, stream_dedup and stream_merge (int32 "
            f"and u16) == plain ({int(pn)} tokens, {int(pd.n_words)} words, {nu} unique, longest "
            f"{longest} tokens, {int(pk)} ids)")


def unique_rows(w):
    """The unique words of ``w`` as front-packed rows, for ranked_pairs."""
    import torch

    nu = int(w.n_unique)
    start, length = w.ustart[:nu].long(), w.ulen[:nu].long()
    width = max(int(length.max()), 2) if nu else 2
    col = torch.arange(width, device=w.ut.device)[None, :]
    idx = (start[:, None] + col).clamp(max=w.ut.numel() - 1)
    return torch.where(col < length[:, None], w.ut[idx], -1).contiguous()


def phase_stream_main(main: dict, lines, card: str) -> dict:
    """The main path: ``YTTM_ENCODE_BACKEND=stream BPE.encode(lines)`` over
    100 MB (launches counted) gives phase 3's ids; the CLI route
    ``encode_bytes_flat`` + ``format_ids`` gives phase 3's CLI bytes; then
    each stage over every chunk of the corpus: the kernel under the
    profiler, its plain version (equal, each call synchronised), and the
    work its data needs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.host.fastio import format_ids
    from youtokentome_tpu_torch.ops import stream_kernel as sk

    blob, unk = main["blob"], main["unk"]
    n_bytes = len(blob)
    wrappers = {name: getattr(sk, name) for name in STREAM_KERNELS}
    with env_set(YTTM_ENCODE_BACKEND="stream"):
        bpe = yttm.BPE(str(main["model_path"]), device=main["device"])
        for f in wrappers.values():
            f.launches = 0
        ids, api_s = timed(lambda: bpe.encode(lines))
        launches = {name: f.launches for name, f in wrappers.items()}
    log(f"[8] main path YTTM_ENCODE_BACKEND=stream BPE.encode(lines): {api_s:.2f} s "
        f"({n_bytes / 1e6 / api_s:.2f} MB/s); launches {launches} ({card})")
    for name, n in launches.items():
        check(bpe.device.type != "cuda" or n > 0, f"the stream backend did not launch {name}")
    check(ids == main["ids"], "stream-backend ids != phase 3's")
    del ids
    enc = Encoder(main["state"], device=main["device"])
    out, cli_s = timed(lambda: b"".join(format_ids(*enc.encode_bytes_flat(c))
                                        for c in cli_chunks(blob)))
    check(out == main["cli"], "the encode_bytes_flat CLI route's bytes != phase 3's")
    del out
    log(f"[8] ids == phase 3's native ids; CLI route encode_bytes_flat + format_ids: {cli_s:.2f} s "
        f"({n_bytes / 1e6 / cli_s:.2f} MB/s), bytes == phase 3's CLI bytes ({card})")

    st, tables, dev = enc._stream, enc.tables, enc.device
    chunks = [torch.frombuffer(bytearray(c), dtype=torch.uint8).to(dev)
              for c in sk.StreamEncoder.chunks(blob, sk.DEFAULT_CHUNK)]
    k_ms = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        built = [sk.stream_build(x, st.alpha_cps, st.alpha_ids, st.space_id) for x in chunks]
        torch.cuda.synchronize()
    k_ms["stream_build"] = profiled_ms(prof, STREAM_DEVICE_FNS["stream_build"] + STREAM_SHARED_FNS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        words = [sk.stream_dedup(*b) for b in built]
        torch.cuda.synchronize()
    k_ms["stream_dedup"] = profiled_ms(prof, STREAM_DEVICE_FNS["stream_dedup"] + STREAM_SHARED_FNS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        merged = [sk.stream_merge(tables, w, unk) for w in words]
        torch.cuda.synchronize()
    k_ms["stream_merge"] = profiled_ms(prof, STREAM_DEVICE_FNS["stream_merge"] + STREAM_SHARED_FNS)
    for name, v in k_ms.items():
        check(v > 0, f"the profiler recorded no device time for {name}")

    p_ms = dict.fromkeys(STREAM_KERNELS, 0.0)
    n = dict.fromkeys(("tokens", "unique_tokens", "words", "unique", "ids", "pairs"), 0)
    for x, (kt, kw, kn), w, (ko, kk) in zip(chunks, built, words, merged):
        (pt, pw, pn), ms = synced(lambda: sk.build_stream(x, st.alpha_cps, st.alpha_ids, st.space_id))
        p_ms["stream_build"] += ms
        check(int(kn) == int(pn) and torch.equal(kt, pt) and torch.equal(kw, pw),
              "stream_build != plain on a corpus chunk")
        pd, ms = synced(lambda: sk.dedup_words(kt, kw, kn))
        p_ms["stream_dedup"] += ms
        check(same_words(w, pd), "stream_dedup != plain on a corpus chunk")
        (po, pk), ms = synced(lambda: sk.stream_merge_plain(tables, w, unk))
        p_ms["stream_merge"] += ms
        check(int(kk) == int(pk) and torch.equal(ko, po), "stream_merge != plain on a corpus chunk")
        n["tokens"] += int(kn)
        n["unique_tokens"] += int(w.n_tokens)
        n["words"] += int(w.n_words)
        n["unique"] += int(w.n_unique)
        n["ids"] += int(kk)
        n["pairs"] += ranked_pairs(tables, unique_rows(w))
    del built, words, merged
    log(f"[8] every stage == plain on all {len(chunks)} chunks; work: {n_bytes} bytes, {n}")
    bytes_ = {
        "stream_build": n_bytes + 8 * n["tokens"],
        "stream_dedup": 8 * n["tokens"] + 8 * n["unique_tokens"] + 4 * n["words"] + 8 * n["unique"],
        "stream_merge": 4 * n["unique_tokens"] + 8 * n["unique"] + 4 * n["words"] + 2 * n["ids"],
    }
    ops = {"stream_build": n_bytes * OPS_PER_BYTE, "stream_dedup": n["tokens"] * OPS_PER_TOKEN,
           "stream_merge": n["pairs"] * OPS_PER_PAIR}
    rows = []
    for name in STREAM_KERNELS:
        b_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        o_ms = ops[name] / OPS_PER_S * 1e3
        rows.append({"name": name, "launches": launches[name], "ms": k_ms[name],
                     "plain_ms": p_ms[name], "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations"})
        log(f"[8] {name}: {launches[name]} launches, {k_ms[name]:.3f} ms on the card "
            f"(torch.profiler, {len(chunks)} chunks), bound {max(b_ms, o_ms):.4f} ms "
            f"({rows[-1]['bound_by']}), plain {p_ms[name]:.1f} ms ({card})")
    return {"rows": rows, "api_mbps": n_bytes / 1e6 / api_s, "cli_mbps": n_bytes / 1e6 / cli_s}



# -- phase 9: the differential trainers ---------------------------------------

DIFF_TRAINERS = ("stream", "sparse", "block", "bucketed")
# each trainer's kernel module, wrappers and the names of its JSON rows
DIFF_MODULES = {
    "stream": "stream_train_kernels", "sparse": "sparse_kernels", "block": "block_kernels",
    "bucketed": "bucketed_kernels",
}
DIFF_KERNELS = {
    "stream": ("recount", "topk_accept", "apply_compact"),
    "sparse": ("sparse_count", "topk_accept", "sparse_apply"),
    "block": ("block_count", "topk_accept", "block_apply"),
    "bucketed": ("bucket_count", "topk_accept", "bucket_apply"),
}
DIFF_ROW_NAMES = {
    ("stream", "topk_accept"): "stream_topk_accept",
    ("sparse", "topk_accept"): "sparse_topk_accept",
    ("block", "topk_accept"): "block_topk_accept",
    ("bucketed", "topk_accept"): "bucket_topk_accept",
}
# the device functions of each wrapper, as the profiler names them
DIFF_DEVICE_FNS = {
    ("stream", "recount"): ("clear_kernel", "eq_tiles_kernel", "count_tiles_kernel"),
    ("stream", "topk_accept"): ("topk_select_kernel",),
    ("stream", "apply_compact"): ("hit_tiles_kernel", "select_tiles_kernel", "scatter_kernel"),
    ("sparse", "sparse_count"): ("count_words_kernel",),
    ("sparse", "topk_accept"): ("topk_select_kernel",),
    ("sparse", "sparse_apply"): ("mark_live_words_kernel", "apply_words_kernel"),
    ("block", "block_count"): ("count_all_rows_kernel",),
    ("block", "topk_accept"): ("topk_select_kernel",),
    ("block", "block_apply"): ("flag_rows_kernel", "apply_rows_kernel", "full_clear_kernel",
                               "full_recount_kernel"),
    ("bucketed", "bucket_count"): ("clear_kernel", "count_rows_kernel"),
    ("bucketed", "topk_accept"): ("topk_select_kernel",),
    ("bucketed", "bucket_apply"): ("apply_rows_kernel",),
}
DIFF_SOURCES = {
    "stream": "youtokentome_tpu_torch/csrc/train_stream.cu",
    "sparse": "youtokentome_tpu_torch/csrc/train_sparse.cu",
    "block": "youtokentome_tpu_torch/csrc/train_block.cu",
    "bucketed": "youtokentome_tpu_torch/csrc/train_bucketed.cu",
}
DIFF_REPLACES = {
    "stream": "youtokentome_tpu/ops/train_stream.py:251",
    "sparse": "youtokentome_tpu/ops/train_sparse.py:156",
    "block": "youtokentome_tpu/ops/train_block.py:130",
    "bucketed": "youtokentome_tpu/ops/train_kernel.py:97",
}
# scratch each plain/kernel comparison skips (filled in another order, or
# kept only by the kernels)
DIFF_SCRATCH = ("tmp_t", "tmp_w", "tiles", "blk_hi", "blk_lo", "aff", "wmark", "rows")
MID_SITE_CAPS = ("64", "256")  # v3's plain site buffers on the 10 MB prefix
MID_KB = 4  # v4's gather bound on the 10 MB prefix: most rounds take the full path
MID_V0_IDS = 500  # v0's lockstep depth on the 10 MB prefix (one merge a round)
# ids over which the plain versions of phase 9 are timed (v0: one merge a
# round, ~50 ms a plain round at 100 MB)
PLAIN_IDS = {"stream": 1000, "sparse": 1000, "block": 1000, "bucketed": 200}


def diff_module(name: str):
    import importlib

    return importlib.import_module("youtokentome_tpu_torch.ops." + DIFF_MODULES[name])


def diff_wrapper(mod, k: str):
    """Wrapper ``k`` of a trainer's round: its module's, or the shared
    top-k of ``train_kernels``."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    return getattr(tk if k == "topk_accept" else mod, k)


def diff_engine(name: str, buckets, used0: int, vocab: int, dev, plain: bool = False):
    """A kernel (or plain) engine of trainer ``name`` on ``buckets``."""
    from youtokentome_tpu_torch.ops import train_block as tb
    from youtokentome_tpu_torch.ops import train_kernel as tk0
    from youtokentome_tpu_torch.ops import train_sparse as sp
    from youtokentome_tpu_torch.ops import train_stream as ts

    rules = np.full((vocab, 4), -1, np.int32)
    mod = diff_module(name)
    if name == "bucketed":
        cls = tk0.PlainBucketedEngine if plain else mod.BucketedKernelEngine
        return cls(buckets, rules, used0, vocab, dev)
    if name == "block":
        B = tb.block_size_for(buckets)
        t, wid, freq = tb.flatten_word_buckets_blocked(buckets, B)
        cls = tb.PlainBlockEngine if plain else mod.BlockKernelEngine
        return cls(t, wid, freq, rules, used0, vocab, 16, B, dev)
    t, wid, freq = ts.flatten_word_buckets(buckets)
    if name == "sparse":
        cls = sp.PlainSparseEngine if plain else mod.SparseKernelEngine
    else:
        cls = ts.PlainStreamEngine if plain else mod.StreamKernelEngine
    return cls(t, wid, freq, rules, used0, vocab, 16, dev)


def run_diff(eng, vocab: int, used: int, seg: int = TRAIN_SEG) -> int:
    """The host loop over segments of ``seg`` ids."""
    while used < vocab:
        used, done = complete_segment(eng, used, min(vocab, used + seg))
        if done:
            break
    return used


def diff_rows(name: str, eng):
    """The stream or rows of an engine, kernel or plain, as one tensor pair."""
    import torch

    if hasattr(eng, "st"):
        st = eng.st
        if name == "bucketed":
            return st.tok, st.tok
        if name == "block":
            return st.tok, st.wid
        return st.t, st.wid
    if name == "bucketed":
        flat = torch.cat([t.reshape(-1) for t, _ in eng.buckets])
        return flat, flat
    return eng.t, eng.wid


def same_diff(name: str, kern, plain, what: str) -> None:
    """Kernel engine and plain engine agree: stream or rows, rules, and
    (v3, v4) the kernel table's live entries == the plain loop's table."""
    import torch

    kt, kw = diff_rows(name, kern)
    pt, pw = diff_rows(name, plain)
    check(torch.equal(kt, pt) and torch.equal(kw, pw), f"{what}: streams differ")
    check(torch.equal(kern.rules, plain.rules), f"{what}: rules differ")
    if name in ("sparse", "block"):
        keys, cnts = kern.st.table()
        check(int(cnts.min(initial=0)) >= 0, f"{what}: a negative pair count")
        n = int((plain.tc > 0).sum())
        check(np.array_equal(keys[cnts > 0], plain.tk[:n].cpu().numpy())
              and np.array_equal(cnts[cnts > 0], plain.tc[:n].cpu().numpy()),
              f"{what}: live tables differ")


def lockstep(name: str, kern, plain, used0: int, vocab: int, seg: int, what: str) -> int:
    """Both engines segment by segment to ``vocab``; equal at every end."""
    used, segs = used0, 0
    while used < vocab:
        limit = min(vocab, used + seg)
        ku, kd = complete_segment(kern, used, limit)
        pu, pd = complete_segment(plain, used, limit)
        check((ku, kd) == (pu, pd), f"{what}, segment to {limit}: kernel {ku, kd} != plain {pu, pd}")
        same_diff(name, kern, plain, f"{what}, segment to {limit}")
        used, segs = ku, segs + 1
        if kd:
            break
    return segs


def same_diff_state(a, b, what: str) -> None:
    """Kernel state ``a`` and plain state ``b``: every tensor but scratch
    equal, the table as a multiset of (key, count) slots."""
    import torch

    for k, v in vars(a).items():
        if not isinstance(v, torch.Tensor) or k in DIFF_SCRATCH or k in ("keys", "cnts"):
            continue
        check(torch.equal(v, getattr(b, k)), f"{what}: {k} differs")
    ka, ca = a.table()
    kb, cb = b.table()
    check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: tables differ")
    check(int(ca.min(initial=0)) >= 0, f"{what}: a negative pair count")


def diff_round(name: str, mod, st, used0: int, plain: bool, kb: int = 0) -> None:
    """One round of trainer ``name``'s wrappers (or their plain versions;
    ``kb`` bounds v4's block path)."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    V = TRAIN_VOCAB
    topk = tk.topk_accept_plain if plain else tk.topk_accept
    if name == "stream":
        (mod.recount_plain if plain else mod.recount)(st, V, V)
        topk(st, V, V, used0, 16)
        (mod.apply_compact_plain if plain else mod.apply_compact)(st)
    elif name == "bucketed":
        (mod.bucket_count_plain if plain else mod.bucket_count)(st, V, V)
        topk(st, V, V, used0, 1)
        (mod.bucket_apply_plain if plain else mod.bucket_apply)(st)
    else:
        topk(st, V, V, used0, 16)
        if name == "sparse":
            (mod.sparse_apply_plain if plain else mod.sparse_apply)(st)
        else:
            (mod.block_apply_plain if plain else mod.block_apply)(st, kb)


def count_plain(mod, name: str, st) -> None:
    """A v3 or v4 count's plain version behind its wrapper's table reset."""
    st.keys.fill_(mod.EMPTY)
    st.cnts.zero_()
    st.ctl[mod.OCC] = 0
    st.ctl[mod.OVERFLOW] = 0
    getattr(mod, name + "_count_plain")(st)


def phase_diff_kernels(buckets, used0: int, dev) -> None:
    """Each differential trainer's kernels against their plain versions on
    the main path's state (the 100 MB corpus): its count, then two rounds,
    each wrapper from a clone of the same state; v4 also from a later state,
    past its full-path rounds, through rounds of its block path."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    for name in DIFF_TRAINERS:
        mod = diff_module(name)
        eng = diff_engine(name, buckets, used0, TRAIN_VOCAB, dev)
        st = eng.st
        if name in ("sparse", "block"):  # the count the engine made, again
            k_st, p_st = clone_state(st), clone_state(st)
            getattr(mod, name + "_count")(k_st)
            count_plain(mod, name, p_st)
            same_diff_state(k_st, p_st, f"{name}: count")
        k_st, p_st = clone_state(st), clone_state(st)
        for r in range(2):
            diff_round(name, mod, k_st, used0, False, getattr(eng, "KB", 0))
            diff_round(name, mod, p_st, used0, True, getattr(eng, "KB", 0))
            same_diff_state(k_st, p_st, f"{name}: round {r}")
        log(f"[9] {name}: every kernel == its plain version on the 100 MB state "
            f"(2 rounds, {int(k_st.ctl[tk.USED]) - used0} ids, table {st.cap} slots)")
        if name == "block":
            block_path_rounds(mod, eng, used0)


def block_path_rounds(mod, eng, used0: int, most: int = 8) -> None:
    """v4's block_apply against its plain version on the 100 MB state where
    the rounds take the block path: the engine runs on, 100 ids a segment,
    until a segment's rounds all took the block path (the first rounds mix
    both paths); then rounds from clones of that state, equal after each,
    until one of them took the block path."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    used = used0
    while True:
        check(used < TRAIN_VOCAB, "v4 at 100 MB never settled on its block path")
        rows0, full0 = int(eng.st.work[mod.W_ROWS]), int(eng.st.work[mod.W_FULL])
        used = run_diff(eng, min(TRAIN_VOCAB, used + 100), used)
        if int(eng.st.work[mod.W_FULL]) == full0 and int(eng.st.work[mod.W_ROWS]) > rows0:
            break
    k_st, p_st = clone_state(eng.st), clone_state(eng.st)
    rows0, full0 = int(k_st.work[mod.W_ROWS]), int(k_st.work[mod.W_FULL])
    for r in range(most):
        diff_round("block", mod, k_st, used0, False, eng.KB)
        diff_round("block", mod, p_st, used0, True, eng.KB)
        same_diff_state(k_st, p_st, f"block: block-path round {r} from {used} ids")
        if int(k_st.work[mod.W_ROWS]) > rows0:
            break
    rows = int(k_st.work[mod.W_ROWS]) - rows0
    check(rows > 0, f"v4 at 100 MB took no block-path round in {most} rounds from {used} ids")
    log(f"[9] block: block_apply == plain through {r + 1} rounds from {used} ids "
        f"({int(k_st.ctl[tk.USED]) - used} ids, {rows} block-path rows of at most KB = {eng.KB}, "
        f"{int(k_st.work[mod.W_FULL]) - full0} full-path rounds)")


def crafted_buckets():
    """Words whose runs span tiles of 8192 positions: 20,001 a's, 9,000 b's
    then 9,000 a's, an alternation, and short words; (buckets, used0)."""
    words = [
        ([4] + [5] * 20001, 3),
        ([4] + [6] * 9000 + [5] * 9000, 1),
        ([4] + [5, 6] * 5000, 2),
        ([4, 5, 6, 5, 6], 7),
        ([4, 6, 6, 6, 5], 5),
        ([4, 7, 5, 5, 7], 4),
    ]
    buckets = [(np.array([w], np.int32), np.array([f], np.int32)) for w, f in words]
    return buckets, 8


def phase_diff_mid(mid_path: Path, dev) -> dict:
    """The 10 MB prefix at vocab 8000 through each differential trainer's
    kernel engine and its plain round loop, both on the card, in lockstep,
    with each forced branch; then the crafted stream."""
    from youtokentome_tpu_torch.ops import train_sparse as sp

    buckets, _, used0 = training_buckets(mid_path)
    out = {}
    recounts = []
    real_recount = sp._recount

    def counted_recount(*a, **k):
        recounts.append(1)
        return real_recount(*a, **k)

    for name in DIFF_TRAINERS:
        t0 = time.perf_counter()
        vocab = min(MID_VOCAB, used0 + MID_V0_IDS) if name == "bucketed" else MID_VOCAB
        env = {}
        if name in ("sparse", "block"):
            env["YTTM_TRAIN_PCAP"] = str(MID_PCAP)
        if name == "block":
            env["YTTM_TRAIN_KB"] = str(MID_KB)
        with env_set(**env):
            kern = diff_engine(name, buckets, used0, vocab, dev)
        penv = {"YTTM_TRAIN_DCAP0": MID_SITE_CAPS[0], "YTTM_TRAIN_DCAP1": MID_SITE_CAPS[1]} if (
            name == "sparse") else ({"YTTM_TRAIN_KB": str(MID_KB)} if name == "block" else {})
        with env_set(**penv):
            plain = diff_engine(name, buckets, used0, vocab, dev, plain=True)
        with swapped(sp, _recount=counted_recount):
            segs = lockstep(name, kern, plain, used0, vocab, TRAIN_SEG, f"{name} mid-size")
        work = kern.st.work.tolist()
        note = ""
        if name in ("sparse", "block"):
            check(kern.rebuilds >= 1, f"the {name} mid-size run never rebuilt its table")
            note += f", {kern.rebuilds} table rebuilds"
        if name == "sparse":
            check(len(recounts) >= 1, "the v3 plain loop never took its recount branch")
            note += f", {len(recounts)} plain recount rounds"
        if name == "block":
            mod = diff_module(name)
            check(work[mod.W_FULL] >= 1 and work[mod.W_ROWS] >= 1,
                  "the v4 mid-size run missed its block or its full path")
            note += f", {work[mod.W_FULL]} full-path rounds, {work[mod.W_ROWS]} block-path rows"
        out[name] = segs
        log(f"[9] mid-size {name}: kernels == plain round loop at all {segs} segment ends to "
            f"{vocab} (stream, rules{', live table' if name in ('sparse', 'block') else ''})"
            f"{note} ({time.perf_counter() - t0:.1f} s)")

    cb, cu0 = crafted_buckets()
    for name in ("stream", "sparse", "bucketed"):
        t0 = time.perf_counter()
        kern = diff_engine(name, cb, cu0, cu0 + 120, dev)
        plain = diff_engine(name, cb, cu0, cu0 + 120, dev, plain=True)
        segs = lockstep(name, kern, plain, cu0, cu0 + 120, 10, f"{name} crafted")
        log(f"[9] crafted runs across tiles, {name}: kernels == plain round loop at all {segs} "
            f"segment ends ({time.perf_counter() - t0:.1f} s)")
    return out


def diff_work(name: str, eng, count_calls, keys: int) -> tuple:
    """Bytes and operations that the run's data gave each kernel (each
    input read once, each output written once), from the engine's work
    counters and ``keys``, the keys its top-k rounds must read:
    {wrapper: (bytes, ops)}."""
    from youtokentome_tpu_torch.ops import train_kernels as tk

    mod = diff_module(name)
    st, w = eng.st, [int(v) for v in eng.st.work.tolist()]
    rounds, occ, slots = w[tk.W_ROUNDS], w[tk.W_OCC], w[tk.W_SLOTS]
    topk = (slots * 4 + keys * 8 + rounds * 16 * 16, slots * OPS_PER_SLOT)
    if name == "stream":
        # the count reads t and wid of each live token and the word
        # frequencies once (freq [W] stays in L2)
        live, n_words = w[mod.W_LIVE], int(st.freq.shape[0])
        return {"recount": (live * 8 + rounds * n_words * 4 + occ * 12, live * OPS_PER_COUNTED),
                "topk_accept": topk,
                "apply_compact": (live * 8 + w[mod.W_KEEP] * 8, live * OPS_PER_POS)}
    if name == "sparse":
        end = int(st.off[-1])
        count_b = sum(end * 4 + o * 12 for o in count_calls)
        return {"sparse_count": (count_b, len(count_calls) * end * OPS_PER_COUNTED),
                "topk_accept": topk,
                "sparse_apply": (rounds * end * 4 + w[mod.W_SITES] * 8 + w[mod.W_TOUCH] * 16,
                                 rounds * end * OPS_PER_POS // 2 + w[mod.W_SITES] * OPS_PER_COUNTED)}
    if name == "block":
        m = st.NB * st.B
        count_b = sum(m * 8 + o * 12 for o in count_calls)
        rows = w[mod.W_ROWS] + w[mod.W_FULL] * st.NB
        return {"block_count": (count_b, len(count_calls) * m * OPS_PER_COUNTED),
                "topk_accept": topk,
                "block_apply": (rounds * m * 8 + rows * st.B * 16,
                                rounds * m * OPS_PER_POS // 2 + rows * st.B * OPS_PER_COUNTED)}
    # apply: every slot and row offset read, the slots the merge changed
    # written (most rows hold no hit)
    slots_rows = int(st.tok.shape[0])
    return {"bucket_count": (rounds * (slots_rows * 4 + st.n_rows * 8) + occ * 12,
                             rounds * slots_rows * OPS_PER_COUNTED),
            "topk_accept": (slots * 4 + keys * 8 + rounds * 16, slots * OPS_PER_SLOT),
            "bucket_apply": (rounds * (slots_rows + st.n_rows + 1) * 4 + w[mod.W_WRITES] * 4,
                             rounds * slots_rows * OPS_PER_POS)}


class Tracer:
    """The PyTorch profiler's kineto tracer (CUDA activity) over a run:
    each kernel's duration summed by name from the tracer's raw events
    (building the profiler's event tree for key_averages takes minutes on a
    run of a million launches).  ``cycle()`` closes the tracer's window and
    opens the next, so that a long run's records are taken in parts."""

    def __init__(self):
        import collections

        self.by_name = collections.Counter()

    def _start(self):
        from torch.autograd.profiler import profile

        tracer = profile(use_cpu=False, use_device="cuda", use_kineto=True)
        tracer._prepare_trace()
        tracer._start_trace()

    def _stop(self):
        from torch._C._autograd import _disable_profiler

        for ev in _disable_profiler().events():
            if str(ev.device_type()).endswith("CUDA"):
                self.by_name[ev.name()] += ev.duration_ns()

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self._start()
        return self

    def cycle(self):
        self._stop()
        self._start()

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._stop()

    def ms(self, fns: dict) -> dict:
        """Device ms of each key of ``fns``, summed over the kernels whose
        names hold one of its function names."""
        import re

        ms = {k: 0.0 for k in fns}
        for fn_name, ns in self.by_name.items():
            for k, names in fns.items():
                if any(re.search(r"(^|[^A-Za-z0-9_])" + f + r"[(<]", fn_name) for f in names):
                    ms[k] += ns / 1e6
        return ms


def traced(fn, fns: dict, tracer=None):
    """Run ``fn`` under a Tracer (``tracer``, when given, for ``fn`` to
    cycle): (device ms of each key of ``fns``, the run's wall seconds, what
    ``fn`` returns)."""
    import torch

    with tracer or Tracer() as tr:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr.ms(fns), wall, out


def profiled(name: str, fn):
    """Run ``fn`` under the profiler: (device ms of each wrapper of trainer
    ``name``, the run's wall seconds, what ``fn`` returns)."""
    return traced(fn, {k: DIFF_DEVICE_FNS[(name, k)] for k in DIFF_KERNELS[name]})


def plain_diff(name: str, engine, vocab: int, used0: int) -> dict:
    """ms of the plain versions of trainer ``name``'s wrappers over a run to
    ``vocab``, each call synchronised."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    mod = diff_module(name)
    ms = {k: 0.0 for k in DIFF_KERNELS[name]}

    def timed(k, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[k] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    repl = {}
    for k in DIFF_KERNELS[name]:
        if k in ("sparse_count", "block_count"):
            repl[k] = timed(k, lambda st: count_plain(mod, name, st))
        elif k == "topk_accept":
            repl[k] = timed(k, lambda st, limit, v, u0, kk=16: tk.topk_accept_plain(st, limit, v, u0, kk))
        else:
            repl[k] = timed(k, getattr(mod, k + "_plain"))
    with swapped(mod, **repl):
        eng = engine()
        used = run_diff(eng, vocab, used0)
    return ms, eng, used


def phase_diff_main(corpus_path: Path, work: Path, sample, v2_rules, card: str,
                    select_keys: dict) -> dict:
    """The main path of each differential trainer at vocab 30000: launches
    counted, rules against phase 5's v2 rules; the merge loop timed and the
    device ms of each kernel over a replica of the run under the profiler
    (v0's main path, ``run_training``, is its merge loop: it runs once,
    under the profiler); the plain versions over the run's first PLAIN_IDS
    ids; bounds from the run's work counters, the top-k's keys at k = 16
    from phase 5's rounds (``select_keys``) and at k = 1 counted in v0's
    run (KeyTally: a few reductions a round on the card, inside its time).
    Returns the rows, the times and v0's {"rounds", "keys"}."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.models.state import BPEState, SpecialTokens
    from youtokentome_tpu_torch.ops import train_kernel as tk0
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.train import rename_tokens

    dev = torch.device("cuda", 0)
    buckets, al, used0 = training_buckets(corpus_path)
    char2id, want = rename_tokens(al.char2id, v2_rules, SpecialTokens(0, 1, 2, 3), TRAIN_VOCAB)
    want_rules = torch.tensor(v2_rules)
    rows, res, keys1 = [], {}, None
    for name in DIFF_TRAINERS:
        mod = diff_module(name)
        for k in DIFF_KERNELS[name]:
            diff_wrapper(mod, k).launches = 0

        def engine(name=name):
            return diff_engine(name, buckets, used0, TRAIN_VOCAB, dev)

        def replica(vocab):
            eng = engine()
            return eng, run_diff(eng, vocab, used0)

        count_calls = []
        if name == "bucketed":
            # v0's main path is its merge loop alone (~55 s on the card): it
            # runs once, under the profiler, which gives each kernel's device
            # time; its engine gives the run's work
            engines = []

            class Recorded(mod.BucketedKernelEngine):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    engines.append(self)

            tally = KeyTally(mod.topk_accept)
            with swapped(mod, BucketedKernelEngine=Recorded, topk_accept=tally):
                kernel_ms, train_s, got = profiled(
                    name, lambda: tk0.run_training(buckets, used0, TRAIN_VOCAB))
            check(got == v2_rules, "v0 run_training's rules != phase 5's v2 rules")
            what = "ops.train_kernel.run_training (under torch.profiler)"
            launches = {k: diff_wrapper(mod, k).launches for k in DIFF_KERNELS[name]}
            eng = engines[0]
            used, loop_s = int(eng.st.ctl[tk.USED]), train_s
        else:
            t0 = time.perf_counter()
            model_path = work / f"trained30k_{name}.yttm"
            with env_set(YTTM_TRAIN_IMPL=name):
                bpe = yttm.BPE.train(data=str(corpus_path), model=str(model_path),
                                     vocab_size=TRAIN_VOCAB)
            train_s = time.perf_counter() - t0
            check(bpe.device.type == "cuda", "BPE.train runs on cuda by default")
            state = BPEState.load(str(model_path))
            check(state.rules == want and state.char2id == char2id,
                  f"BPE.train's {name} rules != phase 5's v2 rules")
            what = f"BPE.train with YTTM_TRAIN_IMPL={name}"
            launches = {k: diff_wrapper(mod, k).launches for k in DIFF_KERNELS[name]}
            if name in ("sparse", "block"):
                real_count = getattr(mod, name + "_count")

                def counted(st, real_count=real_count, mod=mod):
                    real_count(st)
                    count_calls.append(int(st.ctl[tk.OCC]))
                counted.launches = 0
                ctx = swapped(mod, **{name + "_count": counted})
            else:
                ctx = swapped(mod)
            with ctx:
                eng = engine()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                used = run_diff(eng, TRAIN_VOCAB, used0)
                torch.cuda.synchronize()
                loop_s = time.perf_counter() - t0
            check(torch.equal(eng.rules[: used - used0, :3].cpu(), want_rules),
                  f"the timed {name} run's rules differ")
            kernel_ms, prof_s, (p_eng, p_used) = profiled(name, lambda: replica(TRAIN_VOCAB))
            check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules),
                  f"the profiled {name} run's rules differ")
            log(f"[9] {name}: a replica of the merge loop under torch.profiler took {prof_s:.3f} s "
                f"against {loop_s:.3f} s without")
        for k, n in launches.items():
            check(n > 0, f"the {name} main path did not launch {k}")
        log(f"[9] {what}: {train_s:.2f} s, rules == phase 5's v2 rules; launches {launches}")
        for k, v in kernel_ms.items():
            check(v > 0, f"the profiler recorded no device time for {name} {k}")
        merges, rounds = used - used0, int(eng.st.ctl[tk.ROUND])
        log(f"[9] {name} merge loop (kernels): {loop_s:.3f} s, {rounds} rounds, {merges} merges, "
            f"{merges / loop_s:.0f} merges/s, {eng.rebuilds} table rebuilds, table "
            f"{eng.st.cap} slots; work {eng.st.work.tolist()}")
        if name == "bucketed":
            keys1 = {"rounds": int(eng.st.work[tk.W_ROUNDS]), "keys": tally.keys()}
            keys = keys1["keys"]
        else:
            keys = select_keys_of(eng.st.work, select_keys, 1, f"the {name} run")
        work_bo = diff_work(name, eng, count_calls, keys)
        plain_vocab = min(TRAIN_VOCAB, used0 + PLAIN_IDS[name])
        prefix_ms = profiled(name, lambda: replica(plain_vocab))[0]
        plain_ms, p_eng, p_used = plain_diff(name, engine, plain_vocab, used0)
        check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules[: p_used - used0]),
              f"the {name} plain versions' rules differ")
        log(f"[9] {name} over the first {plain_vocab - used0} ids: kernels (torch.profiler) "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in prefix_ms.items())
            + "; plain versions (synchronised) "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))
        for k in DIFF_KERNELS[name]:
            b, o = work_bo[k]
            b_ms, o_ms = b / HBM_BYTES_PER_S * 1e3, o / OPS_PER_S * 1e3
            row = {"name": DIFF_ROW_NAMES.get((name, k), k), "trainer": name, "kernel": k,
                   "launches": launches[k], "ms": kernel_ms[k], "plain_ms": plain_ms[k],
                   "plain_ids": plain_vocab - used0, "prefix_ms": prefix_ms[k],
                   "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
            rows.append(row)
            log(f"[9] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms "
                f"over the first {row['plain_ids']} ids (kernel {prefix_ms[k]:.3f} ms) ({card})")
        res[name] = {"train_s": train_s, "loop_s": loop_s, "rounds": rounds,
                     "merges_per_s": merges / loop_s}
        log(f"[9] times {name}: {what} {train_s:.2f} s, merge loop {loop_s:.3f} s, {rounds} "
            f"rounds, {merges / loop_s:.0f} merges/s ({card})")
    return {"rows": rows, "times": res, "select_keys1": keys1}


# -- phase 10: the data mesh (sharded encode, sharded v2 training) -----------

SHARDS = 4  # shards of the data mesh, all on card 0
SHARD_SOURCE = "youtokentome_tpu_torch/csrc/train_delta_sharded.cu"
SHARD_KERNELS = ("delta_emit", "shard_recount", "shard_fold", "shard_relay")
# the device functions of each wrapper, as the profiler names them
SHARD_DEVICE_FNS = {
    "topk_accept": ("topk_select_kernel",),
    "delta_emit": ("mark_words_kernel", "emit_words_kernel"),
    "shard_recount": ("recount_clear_kernel", "recount_kernel"),
    "shard_fold": ("fold_prep_kernel", "fold_kernel", "fold_done_kernel"),
    "shard_relay": ("relay_len_kernel", "relay_write_kernel", "tile_sums_kernel",
                    "tile_offsets_kernel", "scan_apply_kernel"),
}
SHARD_REPLACES = {
    "topk_accept": "youtokentome_tpu/parallel/train_delta_sharded.py:81",
    "delta_emit": "youtokentome_tpu/parallel/train_delta_sharded.py:81",
    "shard_recount": "youtokentome_tpu/parallel/train_delta_sharded.py:81",
    "shard_fold": "youtokentome_tpu/parallel/train_delta_sharded.py:81",
    "shard_relay": "youtokentome_tpu/parallel/train_delta_sharded.py:212",
}
SHARD_ENCODE_REPLACES = "youtokentome_tpu/parallel/encode_sharded.py:40"
MID_DCAP = 64  # the 10 MB lockstep's delta buffers: most rounds take the recount branch
SHARD_PLAIN_IDS = 200  # ids the plain versions are timed over
SHARD_PLAIN_EVERY = 4  # the sharded merge's plain version is timed on every 4th chunk


def card_mesh(n: int = SHARDS, dev="cuda:0"):
    """n shards, all on ``dev``."""
    from youtokentome_tpu_torch.parallel.mesh import DataMesh

    return DataMesh([dev] * n)


def phase_shard_encode(main: dict, lines, times: list, card: str, dev="cuda:0") -> dict:
    """Row 11: the greedy merges sharded over 4 shards on the card.  Every
    main-path chunk through the sharded route (int32 and uint16 wire, and
    encode_batch_sharded's padding) equals the one-device kernel; the main
    path ``BPE.encode(lines)`` through an Encoder on the mesh gives phase
    3's ids, its merges launched through the sharded route; the merge
    kernel's device ms over the main path's chunks (torch.profiler), and
    over every SHARD_PLAIN_EVERY-th chunk beside the plain version's on
    those chunks' shards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.encoder import DEVICE_BATCH, Encoder
    from youtokentome_tpu_torch.ops import encode_kernel as ek
    from youtokentome_tpu_torch.parallel import encode_sharded as es

    mesh = card_mesh(dev=dev)
    tables, unk = main["tables"], main["unk"]
    chunks = [np.ascontiguousarray(mat[c0 : c0 + DEVICE_BATCH])
              for _, mat in main["buckets"] for c0 in range(0, mat.shape[0], DEVICE_BATCH)]
    check(all(c.shape[0] % SHARDS == 0 for c in chunks), "a main-path chunk does not split")
    x16 = [torch.from_numpy(ek.pack_tokens_u16(c)).to(dev) for c in chunks]
    for c, x in zip(chunks, x16):
        x32 = torch.from_numpy(c).to(dev)
        check(torch.equal(torch.cat(es.encode_greedy_sharded(tables, x32, mesh)),
                          ek.encode_greedy(tables, x32)), "sharded int32 merge != one device")
        check(torch.equal(torch.cat(es.encode_greedy_sharded_u16(tables, x, unk, mesh)),
                          ek.encode_greedy_u16(tables, x, unk)), "sharded u16 merge != one device")
    odd = chunks[0][: chunks[0].shape[0] - 1]
    check(np.array_equal(es.encode_batch_sharded(tables, odd, mesh),
                         ek.encode_greedy(tables, torch.from_numpy(odd).to(dev)).cpu().numpy()),
          "encode_batch_sharded (padded rows) != one device")
    log(f"[10] sharded merges ({SHARDS} shards on cuda:0) == one device on all {len(chunks)} "
        f"main-path chunks, int32 and u16, and a padded batch")

    # the main path, counted
    calls = []
    route = es.encode_greedy_sharded_u16

    def spy(*a):
        calls.append(1)
        return route(*a)

    bpe = yttm.BPE(str(main["model_path"]), device=dev)
    bpe._encoder = Encoder(main["state"], device=dev, mesh=mesh)
    ek.encode_greedy_u16.launches = 0
    with swapped(es, encode_greedy_sharded_u16=spy):
        ids, enc_s = timed(lambda: bpe.encode(lines))
    launches = ek.encode_greedy_u16.launches
    check(ids == main["ids"], "the sharded encode's ids != phase 3's")
    check(len(calls) > 0 and launches == SHARDS * len(calls),
          f"the sharded encode launched {launches} merges in {len(calls)} sharded calls")
    n_bytes = len(main["blob"])
    log(f"[10] BPE.encode over {n_bytes} bytes with a {SHARDS}-shard mesh: ids == phase 3's; "
        f"{len(calls)} sharded merges, {launches} kernel launches; {n_bytes / 1e6 / enc_s:.2f} MB/s "
        f"({card})")
    del ids

    # the merge kernel's device ms from torch.profiler: through the sharded
    # route and on one device over every main-path chunk, and through the
    # sharded route over every SHARD_PLAIN_EVERY-th chunk, the chunks the
    # plain version is timed on
    def merge_ms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return profiled_ms(prof, ("encode_greedy_kernel",))

    k_ms = merge_ms(lambda: [es.encode_greedy_sharded_u16(tables, x, unk, mesh) for x in x16])
    one_ms = merge_ms(lambda: [ek.encode_greedy_u16(tables, x, unk) for x in x16])
    part = x16[::SHARD_PLAIN_EVERY]
    part_ms = merge_ms(lambda: [es.encode_greedy_sharded_u16(tables, x, unk, mesh) for x in part])
    check(min(k_ms, one_ms, part_ms) > 0, "the profiler recorded no device time for the merge")
    _, p_ms = synced(lambda: [ek.encode_greedy_u16_plain(tables, p, unk)
                              for x in part for p in x.chunk(SHARDS)])
    row2 = next(t for t in times if t["name"] == "encode_greedy_u16")
    elems = sum(c.size for c in chunks)
    b_ms = elems * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = row2["ops_ms"]
    row = {"name": "encode_greedy_u16_sharded", "launches": launches, "ms": k_ms, "plain_ms": p_ms,
           "plain_chunks": len(part), "prefix_ms": part_ms, "bound_ms": max(b_ms, ops_ms),
           "bound_by": "bytes" if b_ms >= ops_ms else "operations"}
    log(f"[10] sharded u16 merge over the main path's {len(x16)} chunks ({SHARDS * len(x16)} "
        f"launches): kernel {k_ms:.4f} ms (torch.profiler; one device, same chunks: {one_ms:.4f} "
        f"ms), bound {row['bound_ms']:.5f} ms; plain {p_ms:.1f} ms over every "
        f"{SHARD_PLAIN_EVERY}th chunk ({len(part)} chunks; kernel {part_ms:.4f} ms) ({card})")
    return {"row": row, "mbps": n_bytes / 1e6 / enc_s}


def shard_engine(buckets, used0: int, vocab: int, n: int = SHARDS, plain: bool = False,
                 dev="cuda:0"):
    """The sharded trainer's kernel (or plain) engine on ``buckets``, its
    shards on ``dev``, as ``run_training_delta_sharded`` builds it."""
    from youtokentome_tpu_torch.ops import train_stream as ts
    from youtokentome_tpu_torch.parallel import train_delta_sharded as tds

    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((vocab, 4), -1, np.int32)
    return tds.make_engine(t, wid, freq, rules, used0, used0, vocab, card_mesh(n, dev), 16, plain)


def clone_shards(shards, dcap: int = 0):
    """Copies of a kernel engine's shard states (new buffers of ``dcap``
    entries a side when given)."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    out = []
    for st in shards:
        c = clone_state(st)
        c._links = None
        if dcap:
            c.dcap = dcap
            c.dk = torch.full((2 * dcap,), tk.EMPTY, dtype=torch.int64, device=st.device)
            c.dv = torch.zeros(2 * dcap, dtype=torch.int32, device=st.device)
        out.append(c)
    return out


def scratch_table(st):
    """A shard's scratch table as a sorted (key, count) multiset (numpy)."""
    keys, cnts = st.rkeys.cpu().numpy(), st.rcnts.cpu().numpy()
    used = keys != -1
    order = np.argsort(keys[used], kind="stable")
    return keys[used][order], cnts[used][order]


def same_shard(a, b, what: str, buffers: bool = True, stream=("tok",)) -> None:
    """Kernel and plain shard states agree: stream (the attributes named in
    ``stream``), the replica and the scratch table as multisets, ctl, work,
    rules and (when no side passed dcap) each side of the delta buffer as a
    multiset."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    for k in stream:
        check(torch.equal(getattr(a, k), getattr(b, k)), f"{what}: streams ({k}) differ")
    for t, (ka, ca), (kb, cb) in (("table", a.table(), b.table()),
                                  ("scratch table", scratch_table(a), scratch_table(b))):
        check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: {t}s differ")
    check(torch.equal(a.ctl, b.ctl), f"{what}: ctl {a.ctl.tolist()} != {b.ctl.tolist()}")
    check(torch.equal(a.work, b.work), f"{what}: work {a.work.tolist()} != {b.work.tolist()}")
    check(torch.equal(a.rules, b.rules), f"{what}: rules differ")
    if buffers and not int(a.ctl[dsk.DOVF]):
        for side in (0, 1):
            (ka, va), (kb, vb) = a.buffer(side), b.buffer(side)
            ia, ib = np.lexsort((va.cpu().numpy(), ka.cpu().numpy())), np.lexsort(
                (vb.cpu().numpy(), kb.cpu().numpy()))
            check(np.array_equal(ka.cpu().numpy()[ia], kb.cpu().numpy()[ib])
                  and np.array_equal(va.cpu().numpy()[ia], vb.cpu().numpy()[ib]),
                  f"{what}: buffer side {side} differs")


def shard_round(ks, ps, used0: int, limit: int, what: str) -> bool:
    """One round through the kernels on ``ks`` and the plain versions on
    ``ps``, compared after each step; returns whether it recounted."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    for a, b in zip(ks, ps):
        tk.topk_accept(a, limit, TRAIN_VOCAB, used0)
        tk.topk_accept_plain(b, limit, TRAIN_VOCAB, used0, 16)
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.delta_emit(a)
        dsk.delta_emit_plain(b)
        same_shard(a, b, f"{what}, delta_emit shard {i}")
    recount = any(int(a.ctl[dsk.DOVF]) for a in ks)
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.shard_recount(a, ks)
        dsk.shard_recount_plain(b, ps)
        same_shard(a, b, f"{what}, shard_recount shard {i}")
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.shard_fold(a, ks)
        dsk.shard_fold_plain(b, ps)
        same_shard(a, b, f"{what}, shard_fold replica {i}")
    return recount


class checked_relay:
    """Within the block, each shard_relay is held against its plain version
    on a copy of the state it relays; counts the relays checked."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        import torch

        from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

        self.dsk, self.real = dsk, dsk.shard_relay

        def relay(st):
            plain = clone_shards([st])[0]
            self.real(st)
            dsk.shard_relay_plain(plain)
            for k in ("tok", "pwid", "off", "fw", "wid_dev", "ctl", "work"):
                check(torch.equal(getattr(st, k), getattr(plain, k)), f"shard_relay: {k} differs")
            check(st.n_words == plain.n_words, "shard_relay: word counts differ")
            self.n += 1

        relay.launches = 0
        dsk.shard_relay = relay
        return self

    def __exit__(self, *exc):
        self.dsk.shard_relay = self.real


def phase_shard_kernels(buckets, used0: int, dev="cuda:0") -> None:
    """Each sharded kernel against its plain version on the 100 MB corpus's
    state split into 4 shards on the card: the replicas' first count (the
    recount branch, forced) against the host table; two rounds with tiny
    buffers (dcap MID_DCAP: the recount branch) and two with buffers
    large enough for the delta branch, every step compared; shard_relay at
    the first re-pack (the largest shard's live tokens halved)."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_stream as ts

    t, wid, freq = ts.flatten_word_buckets(buckets)
    uk, uc = td.host_count_table(t, wid, freq)
    eng = shard_engine(buckets, used0, TRAIN_VOCAB, dev=dev)
    for i, st in enumerate(eng.shards):
        keys, cnts = st.table()
        check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
              f"replica {i}'s first count != the host count table")
    log(f"[10] {SHARDS} shards of {[st.n_words for st in eng.shards]} words, dcap {eng.dcap}, "
        f"tables {eng.shards[0].cap} slots: every replica's first count == the host table "
        f"({uk.size} pairs)")
    branches = {}
    for dcap in (MID_DCAP, 1 << 22):
        ks, ps = clone_shards(eng.shards, dcap), clone_shards(eng.shards, dcap)
        for r in range(2):
            rec = shard_round(ks, ps, used0, used0 + TRAIN_SEG, f"dcap {dcap}, round {r}")
            branches.setdefault(dcap, []).append("recount" if rec else "delta")
        log(f"[10] dcap {dcap}: two rounds, delta_emit, shard_recount and shard_fold == plain "
            f"on every shard ({branches[dcap]}; {[int(a.ctl[dsk.DN_OLD]) for a in ks]} old "
            f"entries)")
    check(branches[MID_DCAP] == ["recount"] * 2 and branches[1 << 22] == ["delta", "delta"],
          f"the kernel checks did not take both branches: {branches}")
    used = used0
    with checked_relay() as rel:
        while eng.relays == 0:
            used, done = complete_segment(eng, used, min(TRAIN_VOCAB, used + TRAIN_SEG))
            check(not done and used < TRAIN_VOCAB, "no relay before the end")
    check(rel.n == SHARDS, f"{rel.n} relays checked")
    log(f"[10] shard_relay == plain on every shard at {used} ids (streams of "
        f"{[int(st.off[-1]) for st in eng.shards]} slots)")


def phase_shard_mid(mid_path: Path, dev="cuda:0", ns=(2, 4)) -> dict:
    """The 10 MB prefix at vocab MID_VOCAB with ``ns`` shards on the card: the
    kernel engine and the plain sharded loop in lockstep, with tiny delta
    buffers (recount rounds) and small kernel tables (rebuilds):
    rules, used and done equal at every segment end, and every replica's
    table equal to the plain loop's live table (the engine checks that its
    replicas agree); every relay held against its plain version."""
    import torch

    buckets, _, used0 = training_buckets(mid_path)
    out = {}
    t0 = time.perf_counter()
    for n in ns:
        # the plain loop keeps the JAX host loop's pcap: its recount fold drops
        # the keys past pcap of each shard's count unseen (ROADMAP.md)
        with env_set(YTTM_TRAIN_DCAP=str(MID_DCAP)):
            plain = shard_engine(buckets, used0, MID_VOCAB, n, plain=True, dev=dev)
            with env_set(YTTM_TRAIN_PCAP=str(MID_PCAP)):
                kern = shard_engine(buckets, used0, MID_VOCAB, n, dev=dev)
        used, segs, nrec = used0, 0, 0
        with checked_relay() as rel:
            while used < MID_VOCAB:
                limit = min(MID_VOCAB, used + TRAIN_SEG)
                ku, kd = complete_segment(kern, used, limit)
                pu, pd = complete_segment(plain, used, limit)
                check((ku, kd) == (pu, pd), f"{n} shards, segment to {limit}: {ku, kd} != {pu, pd}")
                check(torch.equal(kern.rules, plain.rules), f"{n} shards, to {limit}: rules differ")
                m = int((plain.tc > 0).sum())
                for i, st in enumerate(kern.shards):
                    keys, cnts = st.table()
                    check(int(cnts.min(initial=0)) >= 0, "a negative pair count")
                    check(np.array_equal(keys[cnts > 0], plain.tk[:m].cpu().numpy())
                          and np.array_equal(cnts[cnts > 0], plain.tc[:m].cpu().numpy()),
                          f"{n} shards, to {limit}: replica {i} != the plain loop's live table")
                used, segs, nrec = ku, segs + 1, nrec + kern.nrec
                if kd:
                    break
        check(kern.rebuilds >= 1 and nrec > 0,
              f"{n} shards: {kern.rebuilds} rebuilds, {nrec} recount rounds")
        out[n] = {"segments": segs, "rebuilds": kern.rebuilds, "recounts": nrec, "relays": rel.n}
        log(f"[10] 10 MB, vocab {MID_VOCAB}, {n} shards, dcap {MID_DCAP}: kernels == plain sharded "
            f"loop at all {segs} segment ends (rules, every replica's live table); "
            f"{kern.rebuilds} rebuilds, {nrec} recount rounds, {rel.n} relays checked, plain "
            f"pcap {plain.pcap}")
    log(f"[10] 10 MB lockstep, {ns} shards: {time.perf_counter() - t0:.1f} s")
    return out


def run_shards(eng, vocab: int, used: int) -> tuple:
    """The sharded host loop over segments of TRAIN_SEG ids: (used,
    recount rounds)."""
    nrec = 0
    while used < vocab:
        while True:
            used, done, overflow = eng.segment(used, min(vocab, used + TRAIN_SEG))
            nrec += eng.nrec
            if not overflow:
                break
            eng.regrow()
        if done:
            break
    return used, nrec


def shard_profiled(fn):
    """(device ms of each sharded wrapper, what ``fn`` returns), from the
    profiler."""
    ms, _, out = traced(fn, SHARD_DEVICE_FNS)
    return ms, out


def phase_shard_main(corpus_path: Path, work: Path, sample, v2_rules, card: str,
                     select_keys: dict, dev="cuda:0") -> dict:
    """The main path: ``train.train(corpus, model, vocab_size=30000,
    mesh=<4 shards on cuda:0>)`` with no knob takes the sharded trainer
    (not v5), launches counted, rules equal to phase 5's v2 rules, the
    model encodes and decodes; the merge loop timed twice; each kernel's
    device ms over a replica under the profiler, beside the loop's time;
    bounds from the run's work counters, the top-k's keys from phase 5's
    rounds (``select_keys``); the plain versions over the first
    SHARD_PLAIN_IDS ids."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import train as tr
    from youtokentome_tpu_torch.models.state import BPEState, BpeConfig, SpecialTokens
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.train import rename_tokens

    wrappers = {"topk_accept": tk.topk_accept, **{k: getattr(dsk, k) for k in SHARD_KERNELS}}
    for w in wrappers.values():
        w.launches = 0
    calls = {"sharded": 0, "tiered": 0}
    real_sharded, real_tiered = tr.run_training_delta_sharded, tr.run_training_tiered

    def sharded(*a, **k):
        calls["sharded"] += 1
        return real_sharded(*a, **k)

    def tiered(*a, **k):
        calls["tiered"] += 1
        return real_tiered(*a, **k)

    model_path = work / "trained30k_sharded.yttm"
    check("YTTM_TRAIN_IMPL" not in os.environ, "YTTM_TRAIN_IMPL is set")
    t0 = time.perf_counter()
    with swapped(tr, run_training_delta_sharded=sharded, run_training_tiered=tiered):
        tr.train(str(corpus_path), str(model_path), TRAIN_VOCAB,
                 BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)), device=dev, mesh=card_mesh(dev=dev))
    train_s = time.perf_counter() - t0
    t_phase = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    check(calls == {"sharded": 1, "tiered": 0}, f"auto on a mesh took {calls}")
    for k, n in launches.items():
        check(n > 0, f"the sharded main path did not launch {k}")
    buckets, al, used0 = training_buckets(corpus_path)
    char2id, want = rename_tokens(al.char2id, v2_rules, SpecialTokens(0, 1, 2, 3), TRAIN_VOCAB)
    state = BPEState.load(str(model_path))
    check(state.rules == want and state.char2id == char2id,
          "the sharded train.train's rules != phase 5's v2 rules")
    bpe = yttm.BPE(str(model_path), device=dev)
    ids = bpe.encode(sample)
    check(bpe.decode(ids) == sample, "the sharded model's decode round trip")
    log(f"[10] train.train on a {SHARDS}-shard mesh, no knob: the sharded trainer (not v5), "
        f"{train_s:.2f} s, rules == phase 5's v2 rules, {len(sample)} lines decode back; "
        f"launches {launches}")

    want_rules = torch.tensor(v2_rules)
    loops = []
    for _ in range(2):  # twice, so that the host's spread shows beside the loop's time
        eng = shard_engine(buckets, used0, TRAIN_VOCAB, dev=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        used, nrec = run_shards(eng, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
        check(torch.equal(eng.rules[: used - used0, :3].cpu(), want_rules),
              "the timed run's rules differ")
    loop_s = loops[0]
    rounds, merges = int(eng.shards[0].ctl[tk.ROUND]), used - used0
    w = np.sum([st.work.cpu().numpy() for st in eng.shards], axis=0)
    entries = int(w[dsk.W_ENTRIES])
    log(f"[10] merge loop ({SHARDS} shards): {loop_s:.3f} s (again: {loops[1]:.3f} s), {rounds} "
        f"rounds, {merges} merges, "
        f"{merges / loop_s:.0f} merges/s, {nrec} recount rounds, {eng.rebuilds} rebuilds, "
        f"{eng.relays} relays, dcap {eng.dcap}, tables {eng.shards[0].cap} slots ({card})")
    log(f"[10] exchange: {entries} buffer entries written ({entries * 12 / max(rounds, 1):.0f} B a "
        f"round, each read by {SHARDS} replicas); capacity {SHARDS}x{2 * eng.dcap} entries "
        f"({SHARDS * 2 * eng.dcap * 12} B) a delta round, {SHARDS}x{eng.shards[0].cap} slots "
        f"({SHARDS * eng.shards[0].cap * 12} B) a recount round")

    def replica(vocab):
        e = shard_engine(buckets, used0, vocab, dev=dev)
        return e, run_shards(e, vocab, used0)[0]

    kernel_ms, prof_s, (p_eng, p_used) = traced(lambda: replica(TRAIN_VOCAB), SHARD_DEVICE_FNS)
    check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules),
          "the profiled run's rules differ")
    for k, v in kernel_ms.items():
        check(v > 0, f"the profiler recorded no device time for {k}")
    busy_s = sum(kernel_ms.values()) / 1e3
    log(f"[10] the loop's kernels: {busy_s:.3f} s on the card, {busy_s / min(loops):.1%} of the "
        f"faster unprofiled loop ({min(loops):.3f} s); the replica under torch.profiler took "
        f"{prof_s:.3f} s ({card})")
    plain_vocab = used0 + SHARD_PLAIN_IDS
    prefix_ms, _ = shard_profiled(lambda: replica(plain_vocab))
    plain_ms = {k: 0.0 for k in SHARD_DEVICE_FNS}

    def timed_plain(k, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a, **kw)
            torch.cuda.synchronize()
            plain_ms[k] += (time.perf_counter() - t0) * 1e3
        return run

    with swapped(dsk, topk_accept=timed_plain(
            "topk_accept", lambda st, limit, v, u0, kk=16: tk.topk_accept_plain(st, limit, v, u0, kk)),
            **{k: timed_plain(k, getattr(dsk, k + "_plain")) for k in SHARD_KERNELS}):
        pe = shard_engine(buckets, used0, plain_vocab, dev=dev)
        pu, _ = run_shards(pe, plain_vocab, used0)
    check(torch.equal(pe.rules[: pu - used0, :3].cpu(), want_rules[: pu - used0]),
          "the plain versions' rules differ")

    # bounds: the bytes each kernel must move, from the run's work counters
    # (each input read once, each output written once), operations at
    # OPS_PER_POS a 4-byte word
    rounds_all, slots = int(w[tk.W_ROUNDS]), int(w[tk.W_SLOTS])
    keys = select_keys_of(w, select_keys, SHARDS, "the sharded v2 run")
    bytes_ = {"topk_accept": slots * 4 + keys * 8 + rounds_all * 16 * 16,
              "delta_emit": int(w[dsk.W_EMIT]), "shard_recount": int(w[dsk.W_COUNT]),
              "shard_fold": int(w[dsk.W_FOLD]), "shard_relay": int(w[dsk.W_RELAY])}
    ops = {k: (slots * OPS_PER_SLOT if k == "topk_accept" else b // 4 * OPS_PER_POS)
           for k, b in bytes_.items()}
    rows = []
    for k in SHARD_DEVICE_FNS:
        b_ms, o_ms = bytes_[k] / HBM_BYTES_PER_S * 1e3, ops[k] / OPS_PER_S * 1e3
        row = {"name": "topk_accept_sharded" if k == "topk_accept" else k, "kernel": k,
               "launches": launches[k], "ms": kernel_ms[k], "plain_ms": plain_ms[k],
               "plain_ids": SHARD_PLAIN_IDS, "prefix_ms": prefix_ms[k],
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        rows.append(row)
        log(f"[10] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms over the "
            f"first {SHARD_PLAIN_IDS} ids (kernel {prefix_ms[k]:.3f} ms) ({card})")
    log(f"[10] the main path's timings took {time.perf_counter() - t_phase:.1f} s after train.train")
    return {"rows": rows, "train_s": train_s, "loop_s": loop_s, "loop2_s": loops[1],
            "busy_s": busy_s, "rounds": rounds, "merges_per_s": merges / loop_s, "recounts": nrec}


# -- phase 11: the other sharded trainers (v3, v1, v0) on the data mesh ------

OTHER_TRAINERS = ("sparse", "stream", "bucketed")
# each trainer's wrappers, in round order
OTHER_KERNELS = {
    "sparse": ("topk_accept", "sparse_emit", "sparse_shard_recount", "shard_fold"),
    "stream": ("stream_shard_count", "shard_part_fold", "shard_gather", "topk_accept",
               "apply_compact"),
    "bucketed": ("bucket_shard_count", "shard_part_fold", "shard_gather", "topk_accept",
                 "bucket_apply"),
}
# the names of their JSON rows (the new kernels keep their own)
OTHER_ROW_NAMES = {
    ("sparse", "topk_accept"): "sparse_sharded_topk_accept",
    ("sparse", "shard_fold"): "sparse_sharded_shard_fold",
    ("stream", "shard_part_fold"): "stream_sharded_part_fold",
    ("stream", "shard_gather"): "stream_sharded_gather",
    ("stream", "topk_accept"): "stream_sharded_topk_accept",
    ("stream", "apply_compact"): "stream_sharded_apply_compact",
    ("bucketed", "shard_part_fold"): "bucket_sharded_part_fold",
    ("bucketed", "shard_gather"): "bucket_sharded_gather",
    ("bucketed", "topk_accept"): "bucket_sharded_topk_accept",
    ("bucketed", "bucket_apply"): "bucket_sharded_apply",
}
# the device functions of each wrapper, as the profiler names them
OTHER_DEVICE_FNS = {
    "topk_accept": ("topk_select_kernel",),
    "shard_fold": ("fold_prep_kernel", "fold_kernel", "fold_done_kernel"),
    "shard_part_fold": ("part_prep_kernel", "part_fold_kernel"),
    "shard_gather": ("gather_kernel",),
    "sparse_emit": ("mark_live_words_kernel", "emit_live_words_kernel"),
    "sparse_shard_recount": ("sparse_recount_clear_kernel", "sparse_recount_kernel"),
    "stream_shard_count": ("clear_kernel", "eq_tiles_kernel", "count_tiles_kernel"),
    "apply_compact": ("hit_tiles_kernel", "select_tiles_kernel", "scatter_kernel"),
    "bucket_shard_count": ("clear_kernel", "count_rows_kernel"),
    "bucket_apply": ("apply_rows_kernel",),
}
OTHER_SOURCES = {
    "topk_accept": TOPK_SOURCE,
    "shard_fold": SHARD_SOURCE,
    "shard_part_fold": SHARD_SOURCE,
    "shard_gather": SHARD_SOURCE,
    "sparse_emit": "youtokentome_tpu_torch/csrc/train_sparse_sharded.cu",
    "sparse_shard_recount": "youtokentome_tpu_torch/csrc/train_sparse_sharded.cu",
    "stream_shard_count": "youtokentome_tpu_torch/csrc/train_stream.cu",
    "apply_compact": "youtokentome_tpu_torch/csrc/train_stream.cu",
    "bucket_shard_count": "youtokentome_tpu_torch/csrc/train_bucketed.cu",
    "bucket_apply": "youtokentome_tpu_torch/csrc/train_bucketed.cu",
}
OTHER_REPLACES = {
    "sparse": "youtokentome_tpu/parallel/train_sparse_sharded.py:86",
    "stream": "youtokentome_tpu/parallel/train_stream_sharded.py:42",
    "bucketed": "youtokentome_tpu/parallel/train_sharded.py:38",
}
OTHER_STREAMS = {"sparse": ("t",), "stream": ("t", "wid"), "bucketed": ("tok",)}
# v0's depth in the sharded 10 MB lockstep, and the ids the plain versions
# are timed over (v0's below SHARD_PLAIN_IDS: one merge a round)
OTHER_V0_IDS = 300
OTHER_PLAIN_IDS = {"sparse": SHARD_PLAIN_IDS, "stream": SHARD_PLAIN_IDS, "bucketed": 50}
# rounds a window of the tracer over a main path holds: held in one window,
# the v0 main path's ~30,000 rounds ran about a quarter longer
TRACE_WINDOW = 4096


def other_wrapper(name: str, k: str):
    """Wrapper ``k`` of the sharded trainer ``name``: (its module, the
    wrapper)."""
    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
    from youtokentome_tpu_torch.ops import stream_train_kernels as stk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    home = {"topk_accept": tk, "shard_fold": dsk, "shard_part_fold": dsk, "shard_gather": dsk,
            "sparse_emit": ssk,
            "sparse_shard_recount": ssk, "stream_shard_count": rsk, "bucket_shard_count": rsk,
            "apply_compact": stk, "bucket_apply": bk}[k]
    return home, getattr(home, k)


def other_engine(name: str, buckets, used0: int, vocab: int, n: int = SHARDS,
                 plain: bool = False, dev="cuda:0"):
    """The kernel (or plain) engine of sharded trainer ``name`` on
    ``buckets``, its shards on ``dev``, as its host loop builds it."""
    from youtokentome_tpu_torch.ops import train_stream as ts
    from youtokentome_tpu_torch.parallel import train_sharded as tsh
    from youtokentome_tpu_torch.parallel import train_sparse_sharded as tss
    from youtokentome_tpu_torch.parallel import train_stream_sharded as tst

    mesh = card_mesh(n, dev)
    if name == "bucketed":
        return tsh.make_engine(buckets, used0, vocab, mesh, plain)
    if name == "stream":
        return tst.make_engine(buckets, used0, vocab, mesh, 16, plain)
    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((vocab, 4), -1, np.int32)
    return tss.make_engine(t, wid, freq, rules, used0, used0, vocab, mesh, 16, plain)


def other_round(name: str, ks, ps, used0: int, limit: int, what: str) -> bool:
    """One round of sharded trainer ``name`` through the kernels on ``ks``
    and the plain versions on ``ps``, compared after each step; returns
    the branch that v3's fold took (the others fold in parts)."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    stream = OTHER_STREAMS[name]
    V, kb = TRAIN_VOCAB, (1 if name == "bucketed" else 16)
    for k in OTHER_KERNELS[name]:
        home, fn = other_wrapper(name, k)
        plain = getattr(home, k + "_plain")
        rec = any(int(a.ctl[dsk.DOVF]) for a in ks)
        for i, (a, b) in enumerate(zip(ks, ps)):
            if k == "topk_accept":
                fn(a, limit, V, used0, kb)
                plain(b, limit, V, used0, kb)
            elif k in ("sparse_shard_recount", "shard_fold", "shard_part_fold", "shard_gather"):
                fn(a, ks)
                plain(b, ps)
            elif k in ("stream_shard_count", "bucket_shard_count"):
                fn(a, limit, V)
                plain(b, limit, V)
            else:
                fn(a)
                plain(b)
            same_shard(a, b, f"{what}, {k} on shard {i}", buffers=name == "sparse", stream=stream)
    return ("recount" if rec else "delta") if name == "sparse" else "parts"


def phase_other_shard_kernels(buckets, used0: int, dev="cuda:0") -> None:
    """Row 13: each kernel of the sharded v3, v1 and v0 trainers against its
    plain version on the 100 MB corpus's state split into 4 shards on the
    card, for two rounds, every step compared: v3 with tiny buffers (dcap
    MID_DCAP: sparse_shard_recount and shard_fold's recount branch) and with
    buffers large enough for the delta branch, after its replicas' first
    count against the host table; v1's and v0's shard counts and the
    partitioned fold (shard_part_fold, shard_gather), the top-k and the
    applies."""
    from youtokentome_tpu_torch.ops import train_sparse as sp
    from youtokentome_tpu_torch.ops import train_stream as ts

    t0 = time.perf_counter()
    t, wid, freq = ts.flatten_word_buckets(buckets)
    uk, uc = sp._host_table_tomb(np.asarray(t), np.asarray(wid), np.asarray(freq))
    for name in OTHER_TRAINERS:
        eng = other_engine(name, buckets, used0, TRAIN_VOCAB, dev=dev)
        if name == "sparse":
            for i, st in enumerate(eng.shards):
                keys, cnts = st.table()
                check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
                      f"v3 replica {i}'s first count != the host count table")
        branches = []
        for dcap in ((MID_DCAP, 1 << 22) if name == "sparse" else (0,)):
            ks, ps = clone_shards(eng.shards, dcap), clone_shards(eng.shards, dcap)
            for r in range(2):
                branches.append(other_round(name, ks, ps, used0, used0 + TRAIN_SEG,
                                            f"{name} sharded, dcap {dcap}, round {r}"))
        want = ["recount"] * 2 + ["delta"] * 2 if name == "sparse" else ["parts"] * 2
        check(branches == want, f"{name} sharded: the fold took {branches}, not {want}")
        sizes = [st.n_rows if name == "bucketed" else int((st.t >= 0).sum()) for st in eng.shards]
        log(f"[11] {name} sharded ({SHARDS} shards of {sizes} {'rows' if name == 'bucketed' else 'tokens'}, "
            f"tables {eng.shards[0].cap} slots): every kernel == its plain version for 2 rounds "
            f"({branches})")
    log(f"[11] kernel checks: {time.perf_counter() - t0:.1f} s")


def other_live_table(name: str, plain):
    """The plain loop's live table (v3) or last count (v1, v0) as sorted
    (keys, counts) numpy arrays."""
    import torch

    if name == "sparse":
        live = plain.tc > 0
        return plain.tk[live].cpu().numpy(), plain.tc[live].cpu().numpy()
    cnt, xs, ys = plain.count
    on = cnt > 0
    keys = (xs[on].long() << 32) | ys[on].long()
    order = torch.argsort(keys)
    return keys[order].cpu().numpy(), cnt[on][order].cpu().numpy()


def other_streams(name: str, plain):
    """Each shard's stream or rows of a plain engine, as the kernel states'
    OTHER_STREAMS attributes hold them."""
    import torch

    if name == "bucketed":
        return [(torch.cat([t.reshape(-1) for t, _ in bks]),) for bks in plain.shards]
    if name == "stream":
        return list(zip(plain.ts, plain.ws))
    return [(t,) for t in plain.ts]


def phase_other_shard_mid(mid_path: Path, dev="cuda:0", names=OTHER_TRAINERS,
                          ns=(2, 4)) -> dict:
    """The 10 MB prefix at vocab MID_VOCAB (v0: its first OTHER_V0_IDS
    ids) with ``ns`` shards on the card: the kernel engine of each sharded
    trainer of ``names`` and its plain sharded loop in lockstep, equal at
    every segment end:
    each shard's stream or rows, every replica's live table (v1, v0: the
    last round's count), rules, used and done.  v3 runs with tiny delta
    buffers (recount rounds) and small kernel tables (rebuilds)."""
    import torch

    buckets, _, used0 = training_buckets(mid_path)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        vocab = min(MID_VOCAB, used0 + OTHER_V0_IDS) if name == "bucketed" else MID_VOCAB
        for n in ns:
            env = {"YTTM_TRAIN_DCAP": str(MID_DCAP)} if name == "sparse" else {}
            with env_set(**env):
                plain = other_engine(name, buckets, used0, vocab, n, plain=True, dev=dev)
                with env_set(YTTM_TRAIN_PCAP=str(MID_PCAP)):
                    kern = other_engine(name, buckets, used0, vocab, n, dev=dev)
            used, segs, nrec = used0, 0, 0
            while used < vocab:
                limit = min(vocab, used + TRAIN_SEG)
                ku, kd = complete_segment(kern, used, limit)
                pu, pd = complete_segment(plain, used, limit)
                what = f"{name}, {n} shards, segment to {limit}"
                check((ku, kd) == (pu, pd), f"{what}: {ku, kd} != {pu, pd}")
                check(torch.equal(kern.rules, plain.rules), f"{what}: rules differ")
                pk, pc = other_live_table(name, plain)
                for i, st in enumerate(kern.shards):
                    keys, cnts = st.table()
                    check(int(cnts.min(initial=0)) >= 0, f"{what}: a negative pair count")
                    check(np.array_equal(keys[cnts > 0], pk) and np.array_equal(cnts[cnts > 0], pc),
                          f"{what}: replica {i}'s live table differs")
                for i, (st, want) in enumerate(zip(kern.shards, other_streams(name, plain))):
                    for k, w in zip(OTHER_STREAMS[name], want):
                        check(torch.equal(getattr(st, k), w), f"{what}: shard {i}'s {k} differs")
                used, segs, nrec = ku, segs + 1, nrec + kern.nrec
                if kd:
                    break
            if name == "sparse":
                check(kern.rebuilds >= 1 and nrec > 0,
                      f"v3, {n} shards: {kern.rebuilds} rebuilds, {nrec} recount rounds")
            out[(name, n)] = {"segments": segs, "rebuilds": kern.rebuilds, "recounts": nrec}
            log(f"[11] 10 MB, {name} sharded to {vocab}, {n} shards: kernels == plain sharded loop "
                f"at all {segs} segment ends (streams, every replica's live table, rules); "
                f"{kern.rebuilds} rebuilds, {nrec} recount rounds, tables {kern.shards[0].cap} slots")
        log(f"[11] 10 MB lockstep, {name}, {ns} shards: {time.perf_counter() - t0:.1f} s")
    return out


def other_profiled(name: str, fn, tracer=None):
    """Run ``fn`` under the profiler: (device ms of each wrapper of the
    sharded trainer ``name``, the run's wall seconds, what ``fn``
    returns)."""
    return traced(fn, {k: OTHER_DEVICE_FNS[k] for k in OTHER_KERNELS[name]}, tracer)


def other_work(name: str, eng, keys: int) -> dict:
    """Bytes and operations that the run's data gave each kernel of the
    sharded trainer ``name`` (each input read once, each output written
    once), from the shards' work counters and ``keys``, the keys its top-k
    rounds must read: {wrapper: (bytes, ops)}."""
    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import stream_train_kernels as stk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    w = np.sum([st.work.cpu().numpy() for st in eng.shards], axis=0).astype(np.int64)
    head = eng.shards[0].work.cpu().numpy().astype(np.int64)
    rounds, occ, slots = int(w[tk.W_ROUNDS]), int(w[tk.W_OCC]), int(w[tk.W_SLOTS])
    kb = 1 if name == "bucketed" else 16
    fold = (int(w[dsk.W_FOLD]), int(w[dsk.W_FOLD]) // 4 * OPS_PER_POS)
    out = {"topk_accept": (slots * 4 + keys * 8 + rounds * 16 * kb, slots * OPS_PER_SLOT)}
    if name == "sparse":
        out["shard_fold"] = fold
    else:
        # each shard's live pairs read once, then every replica's live
        # entries written (its occupancy, which the top-k sums)
        out["shard_part_fold"] = fold
        out["shard_gather"] = (occ * 12, occ * OPS_PER_POS)
    # the counts write each round's live pairs at least once (the replica's
    # occupancy, summed over the rounds)
    head_occ = int(head[tk.W_OCC])
    if name == "sparse":
        out["sparse_emit"] = (int(w[dsk.W_EMIT]), int(w[dsk.W_EMIT]) // 4 * OPS_PER_POS)
        out["sparse_shard_recount"] = (int(w[dsk.W_COUNT]), int(w[dsk.W_COUNT]) // 4 * OPS_PER_COUNTED)
    elif name == "stream":
        live = int(w[stk.W_LIVE])
        out["stream_shard_count"] = (live * 8 + head_occ * 12, live * OPS_PER_COUNTED)
        out["apply_compact"] = (live * 8 + int(w[stk.W_KEEP]) * 8, live * OPS_PER_POS)
    else:
        head_rounds = int(head[tk.W_ROUNDS])
        slots_rows = sum(int(st.tok.shape[0]) for st in eng.shards)
        rows = sum(st.n_rows for st in eng.shards)
        out["bucket_shard_count"] = (head_rounds * (slots_rows * 4 + rows * 8) + head_occ * 12,
                                     head_rounds * slots_rows * OPS_PER_COUNTED)
        out["bucket_apply"] = (head_rounds * (slots_rows + rows + len(eng.shards)) * 4
                               + int(w[bk.W_WRITES]) * 4, head_rounds * slots_rows * OPS_PER_POS)
    return out


def plain_other(name: str, engine, vocab: int, used0: int):
    """ms of the plain versions of the sharded trainer ``name``'s wrappers
    over a run to ``vocab``, each call synchronised: (ms, engine, used)."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
    from youtokentome_tpu_torch.ops import train_stream as ts

    ms = {k: 0.0 for k in OTHER_KERNELS[name]}

    def timed(k, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[k] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    plain = {k: timed(k, getattr(other_wrapper(name, k)[0], k + "_plain"))
             for k in OTHER_KERNELS[name]}
    mod = ssk if name == "sparse" else rsk  # where the engine finds its wrappers
    own = {k: f for k, f in plain.items() if k != "shard_fold"}
    with swapped(mod, **own), swapped(dsk, **{k: plain[k] for k in ("shard_fold",) if k in plain}):
        eng = engine(vocab)
        used = ts.run_to_end(eng, used0, vocab)
    return ms, eng, used


def phase_other_shard_main(corpus_path: Path, work: Path, sample, v2_rules, card: str,
                           select_keys: dict, dev="cuda:0", prepared=None) -> dict:
    """The main paths of row 13 on 4 shards of the card at vocab 30000, each
    run once under torch.profiler, its launches counted: ``train.train``
    with ``YTTM_TRAIN_IMPL=sparse`` and a mesh (the sharded v3 trainer; its
    model's rules equal phase 5's v2 rules, and it encodes and decodes),
    ``run_training_stream_sharded`` and ``run_training_sharded`` (rules
    equal phase 5's v2 rules); the merge loop timed inside each run (from
    the engine's first count to the end); each kernel's device ms from the
    profiler; bounds from the run's work counters, the top-k's keys from
    the rounds of phase 5 (k = 16) and of v0 in phase 9 (k = 1):
    ``select_keys`` {16: ..., 1: ...}; the plain versions over the first
    OTHER_PLAIN_IDS ids beside the kernels' device ms there; v3's merge
    loop twice more without the profiler, beside its kernels' device
    time.  ``prepared`` is the corpus's (buckets, alphabet, used_ids0) when
    the caller has them."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import train as tr
    from youtokentome_tpu_torch.models.state import BPEState, BpeConfig, SpecialTokens
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_stream as ts
    from youtokentome_tpu_torch.parallel import train_sharded as tsh
    from youtokentome_tpu_torch.parallel import train_stream_sharded as tst
    from youtokentome_tpu_torch.train import rename_tokens

    buckets, al, used0 = prepared or training_buckets(corpus_path)
    char2id, want = rename_tokens(al.char2id, v2_rules, SpecialTokens(0, 1, 2, 3), TRAIN_VOCAB)
    want_rules = torch.tensor(v2_rules)
    engine_cls = {"sparse": (ssk, "SparseShardedKernelEngine"),
                  "stream": (rsk, "StreamShardedKernelEngine"),
                  "bucketed": (rsk, "BucketedShardedKernelEngine")}
    rows, res = [], {}
    for name in OTHER_TRAINERS:
        for k in OTHER_KERNELS[name]:
            other_wrapper(name, k)[1].launches = 0
        mod, cls_name = engine_cls[name]
        engines, marks = [], []

        tracer = Tracer()

        class Recorded(getattr(mod, cls_name)):
            total_nrec = 0
            rounds = 0

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                engines.append(self)

            def round(self, limit):
                super().round(limit)
                self.rounds += 1
                if self.rounds % TRACE_WINDOW == 0:
                    tracer.cycle()

            def segment(self, used, limit):
                out = super().segment(used, limit)
                self.total_nrec += self.nrec
                return out

        mesh = card_mesh(dev=dev)
        t0 = time.perf_counter()
        with swapped(mod, **{cls_name: Recorded}):
            if name == "sparse":
                model_path = work / "trained30k_sparse_sharded.yttm"
                calls = []
                real = tr.run_training_sparse_sharded

                def spy(*a, **kw):
                    calls.append(1)
                    return real(*a, **kw)

                with env_set(YTTM_TRAIN_IMPL="sparse"), swapped(tr, run_training_sparse_sharded=spy):
                    kernel_ms, wall, _ = other_profiled(name, lambda: tr.train(
                        str(corpus_path), str(model_path), TRAIN_VOCAB,
                        BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)), device=dev, mesh=mesh),
                        tracer)
                check(calls == [1], "train.train with YTTM_TRAIN_IMPL=sparse on a mesh did not take "
                      "the sharded v3 trainer")
                state = BPEState.load(str(model_path))
                check(state.rules == want and state.char2id == char2id,
                      "the sharded v3 train.train's rules != phase 5's v2 rules")
                bpe = yttm.BPE(str(model_path), device=dev)
                check(bpe.decode(bpe.encode(sample)) == sample, "the sharded v3 model's round trip")
                what = "train.train with YTTM_TRAIN_IMPL=sparse"
            else:
                run = tst.run_training_stream_sharded if name == "stream" else tsh.run_training_sharded
                kernel_ms, wall, got = other_profiled(
                    name, lambda: run(buckets, used0, TRAIN_VOCAB, mesh), tracer)
                check(got == v2_rules, f"{name} sharded rules != phase 5's v2 rules")
                what = f"parallel.{run.__module__.rsplit('.', 1)[1]}.{run.__name__}"
        end = time.perf_counter()
        train_s = end - t0
        eng = engines[0]
        loop_s = end - marks[0]
        launches = {k: other_wrapper(name, k)[1].launches for k in OTHER_KERNELS[name]}
        for k, n in launches.items():
            check(n > 0, f"the {name} sharded main path did not launch {k}")
        for k, v in kernel_ms.items():
            check(v > 0, f"the profiler recorded no device time for {name} sharded {k}")
        head = eng.shards[0]
        used = int(head.ctl[tk.USED])
        check(torch.equal(eng.rules[: used - used0, :3].cpu(), want_rules),
              f"the {name} sharded engine's rules differ")
        merges, rounds = used - used0, int(head.ctl[tk.ROUND])
        w = np.sum([st.work.cpu().numpy() for st in eng.shards], axis=0)
        extra, res_extra = "", {}
        if name == "sparse":
            entries = int(w[dsk.W_ENTRIES])
            res_extra = {"recounts": eng.total_nrec, "exchange_b": entries * 12 / max(rounds, 1)}
            extra = (f", {eng.total_nrec} recount rounds, {entries} buffer entries "
                     f"({res_extra['exchange_b']:.0f} B a round, each read by {SHARDS} replicas), "
                     f"dcap {eng.dcap}")
        log(f"[11] {what} on {SHARDS} shards of {dev}: {train_s:.2f} s under torch.profiler, "
            f"launches {launches}")
        log(f"[11] {name} sharded merge loop: {loop_s:.3f} s (under torch.profiler), {rounds} rounds, "
            f"{merges} merges, {merges / loop_s:.0f} merges/s, {eng.rebuilds} table rebuilds, tables "
            f"{head.cap} slots{extra} ({card})")
        kb = 1 if name == "bucketed" else 16
        work_bo = other_work(name, eng, select_keys_of(
            w, select_keys[kb], SHARDS, f"the {name} sharded run"))

        def engine(vocab, name=name):
            return other_engine(name, buckets, used0, vocab, dev=dev)

        def replica(vocab):
            e = engine(vocab)
            return e, ts.run_to_end(e, used0, vocab)

        if name == "sparse":
            loops = []
            for _ in range(2):
                e = engine(TRAIN_VOCAB)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u = ts.run_to_end(e, used0, TRAIN_VOCAB)
                torch.cuda.synchronize()
                loops.append(time.perf_counter() - t0)
                check(torch.equal(e.rules[: u - used0, :3].cpu(), want_rules),
                      "the unprofiled sharded v3 run's rules differ")
            busy_s = sum(kernel_ms.values()) / 1e3
            res_extra.update(loops_s=loops, busy_s=busy_s)
            log(f"[11] sparse sharded merge loop without the profiler: {loops[0]:.3f} s, "
                f"{loops[1]:.3f} s; its kernels {busy_s:.3f} s on the card under the profiler, "
                f"{busy_s / min(loops):.1%} of the faster loop ({card})")

        plain_ids = OTHER_PLAIN_IDS[name]
        plain_vocab = used0 + plain_ids
        prefix_ms = other_profiled(name, lambda: replica(plain_vocab))[0]
        plain_ms, p_eng, p_used = plain_other(name, engine, plain_vocab, used0)
        check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules[: p_used - used0]),
              f"the {name} sharded plain versions' rules differ")
        for k in OTHER_KERNELS[name]:
            b, o = work_bo[k]
            b_ms, o_ms = b / HBM_BYTES_PER_S * 1e3, o / OPS_PER_S * 1e3
            row = {"name": OTHER_ROW_NAMES.get((name, k), k), "trainer": name, "kernel": k,
                   "launches": launches[k], "ms": kernel_ms[k], "plain_ms": plain_ms[k],
                   "plain_ids": plain_ids, "prefix_ms": prefix_ms[k],
                   "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
            rows.append(row)
            log(f"[11] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms over the "
                f"first {plain_ids} ids (kernel {prefix_ms[k]:.3f} ms) ({card})")
        res[name] = {"train_s": train_s, "loop_s": loop_s, "rounds": rounds,
                     "merges_per_s": merges / loop_s, **res_extra}
        del engines[:]
    return {"rows": rows, "times": res}


def other_rows(other: dict) -> list:
    """Phase 11's rows of the ``kernels`` record."""
    return [
        {
            "name": r["name"], "route": "cuda", "source": OTHER_SOURCES[r["kernel"]],
            "replaces": OTHER_REPLACES[r["trainer"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "plain_ids": r["plain_ids"],
            "prefix_ms": r["prefix_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "equal": True,
        }
        for r in other["rows"]
    ]


def log_other(other: dict, card: str) -> None:
    log(f"[11] {SHARDS} shards on cuda:0, merge loops (under torch.profiler): " + ", ".join(
        f"{k} {v['loop_s']:.3f} s ({v['merges_per_s']:.0f} merges/s, {v['rounds']} rounds"
        + (", without the profiler " + ", ".join(f"{x:.3f} s" for x in v["loops_s"])
           if "loops_s" in v else "") + ")"
        for k, v in other["times"].items()) + f" ({card})")



# -- the check-only phases, run side by side -----------------------------------

# worker processes for the mid-size lockstep runs and phase 5's plain round
# loop: they time nothing that the record keeps, so they run side by side
# (each on the card), before any timed phase and with none beside them
CHECK_WORKERS = 6


def _check_worker_init() -> None:
    import torch

    torch.set_num_threads(1)


def run_checks(corpus_path: Path, mid_path: Path) -> dict:
    """Phase 5's v2 plain round loop over the 100 MB corpus and every
    mid-size lockstep run (phases 5, 6, 9, 10 and 11 on the 10 MB prefix),
    in CHECK_WORKERS spawned processes; a failed check fails the run.
    Returns {"plain_v2": (rules, seconds)}."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    dev = torch.device("cuda", 0)
    jobs = {
        "plain_v2": (plain_v2_rules, corpus_path),
        "shard_mid_4": (phase_shard_mid, mid_path, dev, (4,)),
        "shard_mid_2": (phase_shard_mid, mid_path, dev, (2,)),
        "diff_mid": (phase_diff_mid, mid_path, dev),
        **{f"other_mid_{name}_{n}": (phase_other_shard_mid, mid_path, dev, (name,), (n,))
           for name in OTHER_TRAINERS for n in (4, 2)},
        "train_mid": (phase_train_mid, mid_path, dev),
        "tiered_mid": (phase_tiered_mid, mid_path, dev),
    }
    t0 = time.perf_counter()
    with ProcessPoolExecutor(CHECK_WORKERS, mp_context=mp.get_context("spawn"),
                             initializer=_check_worker_init) as ex:
        futs = {k: ex.submit(*job) for k, job in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    log(f"[2] the check-only runs ({len(jobs)}) in {CHECK_WORKERS} worker processes: "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import youtokentome_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)

    info = phase_device_and_build()
    kchk = phase_kernel_checks()
    t0 = time.perf_counter()
    corpus = build_corpus()
    corpus_path = work / "corpus_100mb.txt"
    corpus_path.write_text("\n".join(corpus[1]) + "\n")
    log(f"[3] corpus: {len(corpus[1])} lines, {len(corpus[0])}-word list "
        f"({time.perf_counter() - t0:.1f} s)")
    mid_path = write_prefix(corpus_path, work)
    checks = run_checks(corpus_path, mid_path)
    main_res = phase_main_path(work, corpus)
    times = phase_times(info["card"], kchk, main_res)
    phase_dropout_kernels(kchk)
    dropout = phase_dropout_main(main_res, corpus[1], info["card"])
    phase_stream_kernels(main_res, corpus[1])
    stream = phase_stream_main(main_res, corpus[1], info["card"])
    shard_enc = phase_shard_encode(main_res, corpus[1], times, info["card"])
    sample = corpus[1][:2000]
    del corpus, main_res["buckets"], main_res["ids"], main_res["cli"], main_res["blob"]
    dev = torch.device("cuda", 0)
    buckets, _, used0 = training_buckets(corpus_path)
    phase_train_kernels(buckets, used0, dev)
    del buckets
    phase_select_checks(dev)
    phase_apply_checks(dev)
    train = phase_train_main(corpus_path, work, sample, checks["plain_v2"])
    buckets, _, used0 = training_buckets(corpus_path)
    phase_tiered_kernels(buckets, used0, dev)
    del buckets
    tiered = phase_tiered_main(corpus_path, work, sample, train["plain_rules"])
    buckets, _, used0 = training_buckets(corpus_path)
    phase_diff_kernels(buckets, used0, dev)
    del buckets
    diff = phase_diff_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                           train["select_keys"])
    buckets, _, used0 = training_buckets(corpus_path)
    phase_shard_kernels(buckets, used0)
    del buckets
    shard = phase_shard_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                             train["select_keys"])
    prepared = training_buckets(corpus_path)
    phase_other_shard_kernels(prepared[0], prepared[2])
    other = phase_other_shard_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                                   {16: train["select_keys"], 1: diff["select_keys1"]},
                                   prepared=prepared)

    source = "youtokentome_tpu_torch/csrc/encode_greedy.cu"
    replaces = {
        "encode_greedy": "youtokentome_tpu/ops/encode_kernel.py:95",
        "encode_greedy_u16": "youtokentome_tpu/ops/encode_kernel.py:148",
    }
    kernels = [
        {
            "name": t["name"], "route": "cuda", "source": source,
            "replaces": replaces[t["name"]], "launches": main_res["launches"][t["name"]],
            "max_abs_err": kchk["max_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "equal": True,
        }
        for t in times
    ] + [
        {
            "name": r["name"], "route": "cuda",
            "source": TOPK_SOURCE if r["name"] == "topk_accept" else (
                "youtokentome_tpu_torch/csrc/train_delta.cu"),
            "replaces": TRAIN_REPLACES[r["name"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "equal": True,
        }
        for r in train["rows"]
    ] + [
        {
            "name": r["name"], "route": "cuda", "source": "youtokentome_tpu_torch/csrc/train_tiered.cu",
            "replaces": TIERED_REPLACES[r["name"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "equal": True,
        }
        for r in tiered["rows"]
    ] + [
        {
            "name": r["name"], "route": "cuda", "source": source_of, "replaces": replaces_of,
            "launches": r["launches"], "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "equal": True,
        }
        for r, source_of, replaces_of in
        [(dropout["row"], "youtokentome_tpu_torch/csrc/encode_dropout.cu", DROPOUT_REPLACES)]
        + [(r, "youtokentome_tpu_torch/csrc/stream_encode.cu", STREAM_REPLACES[r["name"]])
           for r in stream["rows"]]
    ] + [
        {
            "name": r["name"], "route": "cuda",
            "source": TOPK_SOURCE if r["kernel"] == "topk_accept" else DIFF_SOURCES[r["trainer"]],
            "replaces": DIFF_REPLACES[r["trainer"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "plain_ids": r["plain_ids"],
            "prefix_ms": r["prefix_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "equal": True,
        }
        for r in diff["rows"]
    ] + [
        {
            "name": r["name"], "route": "cuda", "source": source, "replaces": SHARD_ENCODE_REPLACES,
            "launches": r["launches"], "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "plain_chunks": r["plain_chunks"], "prefix_ms": r["prefix_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "equal": True,
        }
        for r in [shard_enc["row"]]
    ] + [
        {
            "name": r["name"], "route": "cuda",
            "source": TOPK_SOURCE if r["kernel"] == "topk_accept" else SHARD_SOURCE,
            "replaces": SHARD_REPLACES[r["kernel"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "plain_ids": r["plain_ids"],
            "prefix_ms": r["prefix_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "equal": True,
        }
        for r in shard["rows"]
    ] + other_rows(other)
    log(f"[7] dropout routes: native {dropout['native_mbps']:.2f} MB/s, kernel "
        f"{dropout['kernel_mbps']:.2f} MB/s; [8] stream backend: API {stream['api_mbps']:.2f} "
        f"MB/s, CLI {stream['cli_mbps']:.2f} MB/s ({info['card']})")
    log("[9] merge loops: " + ", ".join(
        f"{k} {v['loop_s']:.3f} s ({v['merges_per_s']:.0f} merges/s)"
        for k, v in diff["times"].items()) + f" ({info['card']})")
    log(f"[10] {SHARDS} shards on cuda:0: encode {shard_enc['mbps']:.2f} MB/s; train.train "
        f"{shard['train_s']:.2f} s, merge loop {shard['loop_s']:.3f} s and {shard['loop2_s']:.3f} s "
        f"({shard['merges_per_s']:.0f} "
        f"merges/s, {shard['rounds']} rounds, {shard['recounts']} recount rounds) ({info['card']})")
    log_other(other, info["card"])
    log(f"[4] build {info['build_s']:.2f} s, whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(info["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
