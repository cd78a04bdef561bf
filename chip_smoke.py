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
timings, then trains it again with two processes of two shards each on
the card.  Phase 1 runs first; then the check-only runs (every mid-size
lockstep run and phase 5's plain round loop) in worker processes while
this process runs every edge check and every kernel-against-plain check
on the 100 MB corpus's state (phases 2, 5-7, 9-11's checks); then the
main paths, in the order 3-4, 7, 8, 10 (encode), 5, 6, 9, 10, 11, 12.
``[t]`` lines give each stage's seconds.  The phases (any failure exits
nonzero):

  1. device and build: the card's name and power limit; nvcc/g++ builds;
     the selection and apply kernels' registers, shared and local memory
     (``cuobjdump -res-usage``); every device function that a phase times
     by name is a kernel of the built libraries
  2. kernel vs plain version: random rows for every cap 8..512 at
     R = 8192, int32 and uint16 wire, exact equality with the plain torch
     version (on the card) and with the C++ ``RuleTable.merge_words``; edge
     rows at every cap (``phase_encode_edges``: all-PAD rows, runs of equal
     pairs, placeholders on both wires, full rows, rows that merge to one
     token), with the model's rules and with none
  3. main path: ``BPE(model).encode(lines)`` with no knob set takes the
     device arm (novel tokens > 2**22); ids equal the host arm's; a
     subword encode (matrix path); ``Encoder.encode_stream_cli`` over
     10 MiB chunks equal to the host arm's bytes (both arms over the first
     1/ARM_SHARE of the lines); a decode round trip
  4. times: MB/s of both arms, the kernel's per-launch time for each
     (R, cap) with CUDA events, and the plain version's time
  5. training (csrc/train_delta.cu, and csrc/train_topk.cu: the top-k that
     every trainer but v5 shares): pair_count, topk_accept (also on
     tie-heavy tables, narrow and wide ids, at k = 1, 2, 15 and 16),
     apply_delta and relay each equal to its plain version on the 100 MB
     corpus's state; pair_count's edge streams (``phase_count_checks``: a
     run of 1,000 equal tokens, words of 33-600 tokens, ids from 5 and
     70000, more distinct keys a block than its shared table holds, and a
     table that overflows at its first count, then regrown to the main
     path's table); the selection's edge tables (``phase_select_checks``: 2^14,
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
     merges/s, each kernel's device ms (torch.profiler; the count's by
     CUDA events at its launches; the apply's device functions also over
     the first 100 rounds and the rest) and
     its plain version's (a round's kernels over the first 1000 ids, beside
     their device ms there; the relay over the run, the count over the run
     on copies of its states); the run
     once more, one round at a time, to sum the work
     that its data gives each kernel, for the bounds, and to time the
     selection's library yardstick (one ``torch.topk`` of the table's
     packed words a round; v5: of the hot table's).  ``BPE.train`` runs
     here with ``YTTM_TRAIN_IMPL=delta``: with no knob the corpus takes v5
  6. training with the v5 tiered trainer (csrc/train_tiered.cu): the count,
     tier_select, apply_blocks and resplit each equal to its plain version
     on the 100 MB corpus's block stream (a refresh round, two hot rounds,
     a forced refresh; T against both of the JAX package's definitions; a
     resplit at a small hcap, so T > 0, and a hot round at that T whose
     cold keys stay out of the hot table), the kept live count, the fold's
     plan on its stream (fills, the stable order, FOLD_MAX), and the plan and
     the fold on a foldable cut of it and on rows whose fills tie across the
     plan's blocks; the resplit on crafted tables
     (``phase_resplit_checks``: one, two and three passes, ties, a top count
     below the table's, fewer live keys than the boundary, a full list, the
     full table's size; no run after a round with no refresh, no merge or
     an overflow); the 10 MB prefix at vocab 8000 through the kernel engine
     (the round graph), the same engine through the per-call wrappers and
     the plain tiered round loop in lockstep (a hot tier of 1024, a small
     pcap, folds from 64 rows: refreshes, rebuilds and a fold), the two
     kernel routes equal in every field and the plain loop's stream, table
     and rules at every segment end, the hot tier exact, the kept live
     count exact and the fold planned only where ``fold_wanted`` holds
     (also at every segment end of the 100 MB run, both routes); the main path
     ``BPE.train(data, model, vocab_size=30000)`` with no knob takes v5
     (launches counted, none of v2's; the resplit's runs read from the
     card equal the rounds where one was due; its device ms by CUDA events
     at those runs), its rules equal the v2 plain round loop's from phase
     5,
     ``BPE.train`` timed twice and split (``train_split``: reading,
     preprocessing, the trainer's layout and engine, merge loop, the rest);
     the merge loop through the round graph and through the per-call
     wrappers; times, plain versions (the fold's over the run) and bounds
     as in phase 5, with the refresh rounds and
     folds, the resplit's library yardstick (one ``torch.kthvalue`` of
     the live counts a due round) and the fold plan's (one stable
     ``torch.sort`` of the fills a plan, the order only)
  7. BPE-dropout (csrc/encode_dropout.cu), run after phase 4: the kernel
     equals its plain version (same seed) for every cap 8..512 at R = 8192,
     p 0.1 and 0.5; p = 0 equals the greedy kernel, p = 1 returns its input;
     the main path ``BPE.encode(lines, dropout_prob=0.1)`` over the first
     1/DROPOUT_SHARE of the 100 MB corpus's lines on the native route (no
     launch) and with YTTM_DROPOUT_NATIVE=0
     (the kernel, launches counted); a 2000-line sample decodes back; the
     two routes' mean ids a line agree within 5 standard errors; a subword
     dropout encode spells the sample; the kernel again on every input of
     the main path, equal to its plain version; times and bounds
  8. the flat stream backend (csrc/stream_encode.cu: stream_build,
     stream_dedup, stream_merge), run after phase 7: each kernel equals its
     plain version on the corpus's first 1 MiB chunk and on a crafted chunk
     (invalid bytes, multi-byte chars, every whitespace kind, a
     10,000-char word); the main path ``YTTM_ENCODE_BACKEND=stream
     BPE.encode(lines)`` over the first 1/STREAM_SHARE of the 100 MB
     corpus's lines gives phase 3's ids (launches counted), and the CLI's
     ``encode_bytes_flat`` route phase 3's CLI bytes; every stage again on
     every chunk of those lines, equal to its plain version; times and
     bounds
  9. the differential trainers, run after phase 6: v1 stream
     (csrc/train_stream.cu), v3 sparse (csrc/train_sparse.cu), v4 block
     (csrc/train_block.cu) and v0 bucketed (csrc/train_bucketed.cu), each
     with the shared top-k.  Each kernel equals its plain version on the
     100 MB corpus's state for two rounds, and v4's block_apply again past
     its full-path rounds, through a round of its block path (that round
     once more under torch.profiler: the flag walk and the apply, one launch
     each, no clear or recount); block_apply on crafted rows
     (``phase_block_apply_checks``: hits at slots B-2 and B-1, runs across
     32-slot edges, rows of PAD gaps without a hit on full-path rounds, KB
     at the rows with a hit and one less, ids from 5 and 70000, B = 128 and
     512; the rows' extents the rows'); v3's
     sparse_count (csrc/tomb_count.cuh) on the tombstoned edge streams
     (``phase_tomb_checks``: tombstone runs across 128-slot chunks, equal
     runs split by tombstones, equal ids across word boundaries, words all
     tombstones but a few tokens, ids from 5 and 70000; on one wave of
     blocks and on one block), into a table that overflows at its first
     count and is regrown, and on the main run's trained, tombstoned state,
     each equal to its plain version and the host count; v1's count
     (csrc/stream_count.cuh, through recount and through stream_shard_count
     with its part lists) on pair_count's edge streams and on v1's own
     (``phase_stream_count_checks``: runs across 48 chunk edges, one-token
     and frequency-0 words, a PAD tail, ids from 5 and 70000; one wave and
     one block, counted twice) and into a table that overflows at its
     first count, equal to its plain version and the host count; the 10 MB prefix
     at vocab 8000 through each kernel engine and
     its plain round loop in lockstep, equal at every segment end (stream or
     rows, the live table, rules, used and done): v3 and v4 with a small
     table (rebuilt), v3's plain loop with tiny site buffers (its recount
     branch), v4 with a tiny KB (its full path), v0 for its first ids; v1,
     v3 and v0 on a crafted stream whose runs span tiles; the main path
     ``BPE.train`` with ``YTTM_TRAIN_IMPL=stream|sparse|block`` and
     ``ops.train_kernel.run_training`` at vocab 30000 (v0 to its first
     V0_MAIN_IDS ids), launches counted, rules equal to phase 5's v2 rules
     (v0's to their first V0_MAIN_IDS); times (merge loop, merges/s, each
     kernel's device ms, sparse_count's by CUDA events at its launches)
     and bounds from the work each run's data gave the
     kernels (the top-k's keys: at k = 16 phase 5's, whose rounds see the
     same live counts; at k = 1 counted in v0's run, on the card); the
     plain versions timed over each run's first ids
 10. the data mesh, 4 shards on card 0 (one card: the sharded engine and its
     exchange, not multi-card scaling).  Encode (row 11, run after phase 8):
     every main-path chunk through the sharded route equals the one-device
     kernel; ``BPE.encode(lines)`` through an Encoder on the mesh gives
     phase 3's ids; times and bounds.  Training (rows 12a-b, run after
     phase 9; csrc/train_delta_sharded.cu): delta_emit (one launch for
     1, 2 and 4 shards of the card, one of them without words) equal to
     its plain version shard by shard on crafted streams (runs, chains,
     words of 1-600 tokens, warps claiming 85 words a step, a buffer
     that overflows partway), and both relays (v2's and shard_relay) on
     crafted streams with every word kept and with words dropped; on the
     100 MB state, delta_emit, shard_recount and shard_fold each equal
     their plain versions for two rounds in both branches (the recount
     branch forced by a tiny dcap), and shard_relay at the first re-pack;
     the 10 MB prefix at
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
     shard).  sparse_emit (one launch for 1, 2 and 4 shards of the card, one
     without words) against its plain version shard by shard on tombstoned
     edge words (``phase_sparse_emit_checks``: pairs split by 1-300
     tombstones across 16-byte groups, lanes' 8 positions, 32-slot chunks
     and warps' 256 positions, runs split by tombstones, words of 1-600
     positions, buffers that overflow partway).  The counts' part lists and
     the partitioned fold on crafted
     shards of a 3-shard mesh (``phase_part_fold_checks``: a folded edge
     stream equal to the host count, each replica's fold unchanged by
     poisoned scratch slots that no part-r list names, and a scratch
     overflow, a part the shards overfill together and a list that drops
     claims, each setting OVERFLOW on every replica; v0's count on rows
     whose blocks claim more slots than their stage holds).  On the 100 MB
     state each kernel equals its plain version for two rounds (v3 in both
     of shard_fold's branches, the recount branch forced by a tiny dcap),
     and sparse_shard_recount on phase 9's tombstoned edge streams (its gate
     shut, then opened by another shard's DOVF) and regrown table; the 10
     MB prefix at vocab 8000 (v0: its first ids) with 2 and 4 shards, each
     kernel engine and its plain sharded loop in lockstep, equal at every
     segment end (streams or rows, every replica's live table, rules; v3
     with tiny dcap and small tables, through its round graph at 4 shards,
     the recount branch's runs counted on the card equal to NREC and the
     gate's to the replays, and per call at 2); the main paths at vocab 30000,
     each run once under torch.profiler with launches counted:
     ``train.train`` with ``YTTM_TRAIN_IMPL=sparse`` on the mesh,
     ``run_training_stream_sharded`` and ``run_training_sharded`` (v0 to its
     first V0_MAIN_IDS ids), rules equal to phase 5's v2 rules (v3 through its round graph: launches
     checked against replays, recount rounds and counts, one sparse_emit a
     replay for the card); times, bounds and
     plain versions as in phase 10, and v3's merge loop twice more without
     the profiler, sparse_shard_recount by CUDA events at its runs, the v3
     kernels over the first ids by CUDA events, and sparse_shard_recount on
     the main run's trained shards against its plain version
 12. multi-process training (parallel/distributed.py), run after phase 11:
     two processes (``chip_smoke.py --dist-worker``, gloo on localhost),
     each with 2 shards on card 0 (4 in all, as phase 10), train the 100 MB
     corpus split at a word boundary at vocab 30000 through
     ``train_from_codepoints_distributed``: rules and char2id equal to
     phase 5's v2 rules on both ranks, rows 12a-12b launched on every rank
     (counts set to 0 just before, read just after), the cross-rank
     replica check at every segment end, only rank 0 printing; the 10 MB
     prefix at vocab 8000 with ``YTTM_TRAIN_PCAP`` pinned to the initial
     pair kinds: the JAX host loop's overflow line on rank 0, rules equal to
     the one-process v2 kernels'; the merge loop's time, rounds, recount
     rounds and the collectives' calls, bytes and seconds (the exchange
     goes through the host: the ranks share the one card)

The second-to-last line is a JSON ``kernels`` record, the line before
it the card; the last line is ``{"ok": true, "device": {...}}``.
``compare_tree`` is not part of the run: called from a parent's and a
change's unpacked trees in turns, it prints the numbers the greedy merge
and v5's round are compared by (``.claude/skills/verify/SKILL.md``).  It
exits nonzero without printing a result when no CUDA card is present or
the port is not importable.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
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
# phase 3 holds both merge arms to the main path's ids and CLI bytes over
# the first 1/ARM_SHARE of the corpus's lines (the main path itself runs
# over all of it); phase 8 drives the stream backend over the first
# 1/STREAM_SHARE
ARM_SHARE = 4
STREAM_SHARE = 4
# the greedy merge's device functions (csrc/encode_greedy.cu), as the
# profiler names them: rows of up to 32 slots, and longer rows
ENCODE_DEVICE_FNS = ("encode_short_kernel", "encode_long_kernel")
# the same for BPE-dropout (csrc/encode_dropout.cu)
DROPOUT_DEVICE_FNS = ("encode_dropout_short_kernel", "encode_dropout_long_kernel")
# the stream merge's words kernels (csrc/stream_encode.cu): words of up to
# 512 tokens on warp lanes, longer words a block each
MERGE_WORDS_FNS = ("merge_words_kernel", "merge_long_words_kernel")
# row lengths and widths where the dropout and stream merge kernels change
# layout: 8, 16 or 32 lanes, a warp, the warp's routine (P = 2..16), a
# block past 512 tokens
EDGE_LENGTHS = (1, 2, 8, 9, 16, 17, 32, 33, 512)
EDGE_WIDTHS = (1, 2, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 256, 257, 512)


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
                                      "delta_emit_kernel", "relay_len_kernel",
                                      "relay_write_kernel", "tier_count_kernel", "resplit_kernel",
                                      "encode_short_kernel", "encode_long_kernel",
                                      "pair_count_kernel", "tomb_count_kernel", "fold_plan_kernel",
                                      "stream_count_kernel", "part_fold_kernel",
                                      "apply_compact_kernel", "rows_count_kernel",
                                      "encode_dropout_short_kernel", "encode_dropout_long_kernel",
                                      "merge_words_kernel", "merge_long_words_kernel",
                                      "sparse_emit_kernel", "flag_rows_kernel",
                                      "apply_rows_kernel")):
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
                args = re.search(r"I((?:L[a-z]\d+E)+)E", fn_line)
                tmpl = f"<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>" if args else ""
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
             "encode": ENCODE_DEVICE_FNS + DROPOUT_DEVICE_FNS}]
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


def edge_rows(state, cap: int, rng) -> tuple:
    """Front-packed edge rows of width ``cap`` for the hand model: all-PAD
    rows, one and two tokens, runs of one letter of every length (run
    parity) and of two alternating letters, unknown-run placeholders first,
    last, side by side and inside runs, full rows, and the letters of rules
    whose words merge back to one token.  Returns the rows and the count of
    rule words that merge back."""
    from youtokentome_tpu_torch.host import fasttok

    letters = list(range(5, 13))
    ph = 10**9
    rows = [[], [], [], [5], [4, 5], [ph], [ph, ph + 1], [5, ph], [ph, 5]]
    for n in range(2, cap + 1, 1 if cap <= 32 else max(1, cap // 24)):
        a, b = (int(v) for v in rng.choice(letters, 2, replace=False))
        rows += [[a] * n, [4] + [a] * (n - 1), [a, b] * (n // 2) + [a] * (n % 2)]
        run = [a] * n
        run[int(rng.integers(0, n))] = ph
        rows.append(run)
        rows.append([ph + i if i % 3 == 0 else a for i in range(n)])
    for _ in range(8):
        n = cap
        row = [int(v) for v in rng.choice(letters, n)]
        k = int(rng.integers(0, n))
        row[k:k + 2] = [ph + 7, ph + 8][: len(row[k:k + 2])]
        rows.append(row)
    # the letters of a rule's token, when the greedy merge gives it back
    expand = {t: [t] for t in [4] + letters}
    for x, y, z in state.rules:
        expand[z] = expand[x] + expand[y]
    cands = [v for v in expand.values() if 2 <= len(v) <= cap]
    rtab = fasttok.RuleTable(state.rules)
    wf = np.concatenate([np.asarray(v, np.int32) for v in cands])
    off = np.zeros(len(cands) + 1, np.int64)
    np.cumsum([len(v) for v in cands], out=off[1:])
    _, ro = rtab.merge_words(wf, off)
    whole = [v for v, n in zip(cands, np.diff(ro)) if n == 1]
    rows += whole[:64]
    mat = np.full((len(rows), cap), -1, np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r[:cap]
    return mat, len(whole)


def phase_encode_edges(dev="cuda:0") -> int:
    """The greedy kernel on edge rows at every bucket width 8..512, both
    wires: equal to its plain version and to the C++ merger, with the
    model's rules and with none (the rows come back unchanged, placeholders
    as unk on the uint16 wire).  Returns the rows checked."""
    import torch

    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.models.state import BPEState
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    state = hand_model()
    bare = BPEState(state.char2id, [], state.special_tokens)
    unk = state.special_tokens.unk_id
    rtab = fasttok.RuleTable(state.rules)
    rng = np.random.default_rng(SEED + 3)
    n_rows = 0
    for cap in CAPS:
        mat, n_whole = edge_rows(state, cap, rng)
        want = host_merge_rows(rtab, mat)
        check(n_whole > 0 and bool(((want >= 0).sum(axis=1) == 1).any()),
              f"cap {cap}: no edge row merges to one token")
        for st, ref in ((state, want), (bare, mat)):
            tables = ek.EncoderTables.from_state(st, dev)
            x = torch.from_numpy(mat).to(dev)
            got = ek.encode_greedy(tables, x)
            check(torch.equal(got, ek.encode_greedy_plain(tables, x)),
                  f"edge rows, cap {cap}, {len(st.rules)} rules: int32 kernel != plain version")
            check(np.array_equal(got.cpu().numpy(), ref),
                  f"edge rows, cap {cap}, {len(st.rules)} rules: int32 kernel != C++ merger")
            x16 = torch.from_numpy(ek.pack_tokens_u16(mat)).to(dev)
            got16 = ek.encode_greedy_u16(tables, x16, unk)
            check(torch.equal(got16, ek.encode_greedy_u16_plain(tables, x16, unk)),
                  f"edge rows, cap {cap}, {len(st.rules)} rules: u16 kernel != plain version")
            ref16 = np.where(ref < 0, ek.U16_PAD, np.where(ref >= ek.PLACEHOLDER_START, unk, ref))
            check(np.array_equal(got16.cpu().numpy().astype(np.int64), ref16),
                  f"edge rows, cap {cap}, {len(st.rules)} rules: u16 kernel != C++ merger")
        n_rows += mat.shape[0]
        log(f"[2] edge rows, cap {cap:3d}: {mat.shape[0]} rows ({n_whole} merging to one token), "
            f"int32 and u16 kernels == plain == C++ merger, with the rules and with none")
    return n_rows


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


def lines_prefix(lines, blob: bytes, ids, cli: bytes, share: int) -> tuple:
    """The first 1/``share`` of the corpus's ``lines``: (those lines, their
    bytes in ``blob``, their ids in ``ids``, their lines of the CLI bytes
    ``cli``, one output line an input line)."""
    part = lines[: len(lines) // share]
    cut = 0
    for _ in part:
        cut = cli.index(b"\n", cut) + 1
    return part, blob[: sum(len(t.encode()) + 1 for t in part)], ids[: len(part)], cli[:cut]


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
    #    outside the counted window, over the first 1/ARM_SHARE of the
    #    lines: the API call (cold word cache, then warm: no novel word left
    #    to merge), the CLI engine; and the merge stage alone on all the
    #    corpus's novel words
    check(cli_main.count(b"\n") == len(lines), "the CLI bytes are not one line an input line")
    part, part_blob, part_ids, part_cli = lines_prefix(lines, blob, ids_main, cli_main, ARM_SHARE)
    n_part = len(part_blob)
    turns = []
    for arm in ("device", "host"):
        with merge_arm(arm):
            api = yttm.BPE(str(model_path), device=device)
            ids, api_s = timed(lambda: api.encode(part))
            check(ids == part_ids, f"{arm}-arm ids != the main path's")
            del ids
            ids, warm_s = timed(lambda: api.encode(part))
            check(ids == part_ids, f"{arm}-arm warm-cache ids != the main path's")
            del ids, api
            enc = Encoder(state, device=device)
            out, cli_s = timed(lambda: b"".join(enc.encode_stream_cli(cli_chunks(part_blob))))
            check(out == part_cli, f"{arm}-arm encode_stream_cli bytes != the main path's")
            stage = Encoder(state, device=device)
            _, merge_s = timed(lambda: stage._merge_collect(stage._merge_dispatch(wf, wo)))
        turns.append({"arm": arm, "api_mbps": n_part / 1e6 / api_s,
                      "api_warm_mbps": n_part / 1e6 / warm_s,
                      "cli_mbps": n_part / 1e6 / cli_s, "merge_s": merge_s})
    log(f"[3] over the first {len(part)} lines ({n_part} bytes): ids and encode_stream_cli bytes "
        f"({len(part_cli)}): device arm == host arm == the main path's")
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


def bucket_split(tables, unk, chunks, dev) -> dict:
    """The greedy kernel's device ms over the chunks of each bucket width
    (CUDA events), both wires: {cap: (launches, rows, int32 ms, u16 ms)}."""
    import torch

    from youtokentome_tpu_torch.ops import encode_kernel as ek

    out = {}
    for cap in sorted({c.shape[1] for c in chunks}):
        mine = [c for c in chunks if c.shape[1] == cap]
        x32 = [torch.from_numpy(c).to(dev) for c in mine]
        x16 = [torch.from_numpy(ek.pack_tokens_u16(c)).to(dev) for c in mine]
        out[cap] = (len(mine), sum(c.shape[0] for c in mine),
                    event_ms(lambda: [ek.encode_greedy(tables, x) for x in x32], 5),
                    event_ms(lambda: [ek.encode_greedy_u16(tables, x, unk) for x in x16], 5))
    return out


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
    for cap, (n, r, ms32, ms16) in bucket_split(tables, unk, chunks, dev).items():
        log(f"[4] main-path bucket {cap}: {n} launches, {r} rows: encode_greedy {ms32:.4f} ms "
            f"({ms32 / n * 1e3:.2f} us a launch), encode_greedy_u16 {ms16:.4f} ms "
            f"({ms16 / n * 1e3:.2f} us a launch) ({card})")
    mp = main["main_path"]
    log(f"[4] main path (default policy): API {mp['api_mbps']:.2f} MB/s; CLI engine, device "
        f"arm: {mp['cli_device_mbps']:.2f} MB/s; C++ tokenize {mp['tokenize_s']:.3f} s; "
        f"bucket packing {mp['bucket_packing_s']:.3f} s ({card})")
    for t in main["turns"]:
        log(f"[4] {t['arm']:6s} arm, the first 1/{ARM_SHARE} of the lines: API "
            f"{t['api_mbps']:.2f} MB/s (warm cache "
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
# the kernels of a round, whose plain versions are timed over the main
# path's first TRAIN_PLAIN_IDS ids (the rounds' host-bound plain versions
# took ~90 s of the script over the whole run); the others run at segment
# ends and are timed over the whole run
TRAIN_ROUND_KERNELS = ("topk_accept", "apply_delta")
TRAIN_PLAIN_IDS = 1000
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
                    check(int(k_st.ticket[0]) == 0 and not bool(k_st.hits.any()),
                          f"{label}: the tickets and row count were left at {k_st.ticket}, "
                          f"{k_st.hits}")
                    if not refresh and not int(k_st.ctl[tdk.HOT_OVF]):
                        check_hot_tier(k_st, label)
                    n += 1
    log(f"[5-6] apply_delta and apply_blocks == plain on {n} edge rounds: run parity, chained "
        f"candidates, words of 33-600 tokens, rows of {APPLY_BS} slots full and nearly empty, "
        f"ids from {APPLY_BASES}, a round hitting nearly every word, one hitting none; "
        f"{ovf} of the v2 rounds set the overflow flag ({time.perf_counter() - t0:.1f} s)")
    return {"rounds": n, "overflows": ovf}


# pair_count's edge streams: ids from 5 and from 70000 (above the narrow
# words' 65535); a stream of random pairs long enough that every block of
# the count meets more distinct keys than its shared table holds (2048
# slots): the H100 holds at most 1,056 blocks of 256 threads (8 an SM), so a
# block takes at least COUNT_WIDE_SLOTS / 1056 slots
COUNT_BASES = (5, 70000)
COUNT_WIDE_SLOTS, COUNT_WIDE_IDS, COUNT_MAX_BLOCKS = 4_000_000, 3000, 1056
COUNT_SMALL_CAP = 512  # the main path's 702 pairs overflow it at the first count


def count_edge_words(base: int, rng):
    """The words of pair_count's first edge stream, ids from ``base``: the
    applies' edge words (runs of 1-9 equal ids, chains, words of 33-60
    tokens and one of 600) with a word that is a run of 1,000 equal tokens
    and 40 words of 33-600 tokens."""
    words = edge_words(base, rng, True) + [[base] * 1000]
    lens = rng.integers(33, 601, 40)
    return words + [[base + int(v) for v in rng.integers(0, 8, n)] for n in lens]


def count_edge_streams(base: int, rng):
    """(what, t, wid, freq) of pair_count's edge streams, ids from ``base``:
    ``count_edge_words``; and words of 2-14 random ids out of
    COUNT_WIDE_IDS over ~COUNT_WIDE_SLOTS slots."""
    t, wid, freq = flat_words(count_edge_words(base, rng), rng)
    out = [("edge words, a run of 1000, words of 33-600 tokens", t, wid, freq)]
    lens = rng.integers(2, 15, COUNT_WIDE_SLOTS // 9)
    t = (rng.integers(0, COUNT_WIDE_IDS, int(lens.sum())) + base).astype(np.int32)
    wid = np.repeat(np.arange(lens.size, dtype=np.int32), lens)
    out.append((f"{lens.size} words of random pairs of {COUNT_WIDE_IDS} ids", t, wid,
                rng.integers(1, 6, lens.size).astype(np.int32)))
    return out


STREAM_EDGE_CHUNKS = 48  # 128-slot chunk edges a run of v1's edge stream crosses (6 blocks' edges)
STREAM_PAD = 300  # the PAD tail after the live end of v1's edge stream


def stream_edge_streams(base: int, rng):
    """(what, t, wid, freq) of v1's count's edge stream, ids from ``base``:
    the flat stream (no separator, PAD after the live end) that
    csrc/stream_count.cuh walks 128-slot chunks at a time, eight warps a
    block.  Runs of equal tokens (2-69) cross each of the first
    STREAM_EDGE_CHUNKS chunk edges (every 8th a block's edge in a grid of
    one wave), some from their word's first token, some behind another;
    an id equal on both sides of a word boundary at some edges (no pair
    across); filler words of 1-6 tokens (one-token words among them), a
    quarter of them of frequency 0; then a run of 1,001, an alternation of
    400 and a run of 300 split by one token, each across several chunks; the
    last word ends at the live end, STREAM_PAD slots of PAD after it."""
    words, fr, pos = [], [], 0

    def add(w, f):
        nonlocal pos
        words.append([base + int(v) for v in w])
        fr.append(f)
        pos += len(w)

    for k in range(1, STREAM_EDGE_CHUNKS + 1):
        edge, r = 128 * k, int(rng.integers(2, 70))
        start = edge - int(rng.integers(1, r))  # the run covers [start, start + r) and the edge
        lead = k % 3 == 0  # the run behind another token of its word
        if start - lead < pos:
            continue
        while pos < start - lead:
            add(rng.integers(3, 40, min(int(rng.integers(1, 7)), start - lead - pos)),
                int(rng.integers(0, 4)) * int(rng.integers(1, 6)))
        if k % 4 == 1 and not lead and words:  # the same id ends the word before
            words[-1][-1] = base
        add(([2] if lead else []) + [0] * r + [1], int(rng.integers(1, 6)))
    add([0] * 1001, 3)
    add([0, 1] * 200, 2)
    add([1] * 150 + [2] + [1] * 150, 1)
    t = np.concatenate([np.asarray(w, np.int32) for w in words] + [np.full(STREAM_PAD, -1, np.int32)])
    wid = np.concatenate([np.full(len(w), i, np.int32) for i, w in enumerate(words)]
                         + [np.full(STREAM_PAD, -1, np.int32)])
    return [(f"runs across {STREAM_EDGE_CHUNKS} chunk edges, one-token and frequency-0 words, "
             f"long runs, a PAD tail", t, wid, np.asarray(fr, np.int32))]


STREAM_BUFFERS = ("t0", "w0", "t1", "w1")  # v1's two stream buffers (StreamState)
COMPACT_TILE = 4096  # slots of a tile of v1's apply (csrc/train_stream.cu): 8 warps of 4 chunks
COMPACT_ROUNDS = 5  # the apply's edge rounds: odd, so that the stream ends in the second buffer
COMPACT_USED = 100  # the edge rounds' first new id, past the stream's ids (from the base)


def compact_edge_stream(base: int, rng):
    """(t, wid, freq, cands) of v1's apply edge stream, ids from ``base``,
    and its first round's 16 candidates ([x, y]): 4 pairs of equal ids and
    12 of distinct ids, no id in two of them.  Across each of the first 48
    128-slot chunk edges and every 512-slot warp edge up to 15,360: a run of
    one equal candidate's id (2-71 tokens, odd and even) inside a word,
    from the edge or across it; a candidate pair split by the edge; or a
    word boundary at the edge with the same equal id on both sides (no hit
    across it); at the 4096-slot tile edges among them, the last three in
    turn.  Filler words of
    1-6 other ids between; a run of 4,500 equal ids across the tile edge at
    16,384; the last word ends with a candidate pair (a hit at the live
    end), and 300 slots of PAD follow."""
    E = [base + i for i in range(4)]
    A = [base + 4 + i for i in range(12)]
    B = [base + 16 + i for i in range(12)]
    cands = [(e, e) for e in E] + list(zip(A, B))
    words = []
    pos = 0

    def add(w):
        nonlocal pos
        words.append([int(v) for v in w])
        pos += len(w)

    def fill_to(at):
        while pos < at:
            add(base + 28 + rng.integers(0, 32, min(int(rng.integers(1, 7)), at - pos)))

    edges = sorted(set([128 * k for k in range(1, 49)] + [512 * k for k in range(1, 31)]))
    for k, e in enumerate(edges):
        # a tile edge: a split pair, a word boundary, a run from it
        kind, x = (k % 4 if e % COMPACT_TILE else (e // COMPACT_TILE) % 4), E[k % 4]
        r = int(rng.integers(2, 71))
        r += r % 2 != (k // 4) % 2  # odd and even lengths
        if kind == 0:  # a run across the edge, behind a filler token of its word
            start = e - int(rng.integers(1, r))
            if start - 1 < pos:
                continue
            fill_to(start - 1)
            add([base + 28] + [x] * r)
        elif kind == 1:  # a candidate pair split by the edge
            if e - 2 < pos:
                continue
            fill_to(e - 2)
            i = k % 12
            add([base + 29, A[i], B[i], base + 30])
        elif kind == 2:  # a word boundary inside a run of x
            if e - 2 < pos:
                continue
            fill_to(e - 2)
            add([x, x])
            add([x] * r)
        else:  # a run from the edge
            if e < pos:
                continue
            fill_to(e)
            add([x] * r + [base + 31])
    fill_to(4 * COMPACT_TILE - 1800)
    add([E[1]] * 4500)
    fill_to(pos + 50)
    add([base + 33, A[0], B[0]])
    t = np.concatenate([np.asarray(w, np.int32) for w in words] + [np.full(300, -1, np.int32)])
    wid = np.concatenate([np.full(len(w), i, np.int32) for i, w in enumerate(words)]
                         + [np.full(300, -1, np.int32)])
    return t, wid, rng.integers(1, 6, len(words)).astype(np.int32), cands


def compact_cands(t, wid, k: int = 16) -> list:
    """Up to ``k`` candidates for the next edge round of a stream: its most
    frequent pairs of one word (ties by key), no id in two of them."""
    live = t >= 0
    t, wid = t[live].astype(np.int64), wid[live]
    same = wid[:-1] == wid[1:]
    keys, cnt = np.unique((t[:-1][same] << 32) | t[1:][same], return_counts=True)
    out, ids = [], set()
    for j in np.lexsort((keys, -cnt)):
        x, y = int(keys[j] >> 32), int(keys[j] & 0xFFFFFFFF)
        if x in ids or y in ids:
            continue
        out.append((x, y))
        ids |= {x, y}
        if len(out) == k:
            break
    return out


def row_edge_buckets(base: int, rng):
    """v0's count edge rows, ids from ``base``, as buckets [(tokens [W, L],
    freq [W])] laid out as the preprocessing lays them out (widths 8-1024,
    then odd ones; a power of two of rows, at least 8, a bucket, its
    padding rows of PAD at frequency 0 at its end): rows that fill their
    width, many with the same id ending one row and starting the next (no
    pair across), runs of equal ids (1-20) over six ids, rows of one id to
    their width; words of 1025, 1031 and 1100 tokens (buckets of their own
    odd widths, one with two words); an eighth of the words of frequency
    0."""
    out = []
    for L, W, n in ((8, 64, 50), (16, 32, 30), (32, 16, 13), (1024, 8, 3), (1025, 8, 1),
                    (1031, 8, 2), (1100, 8, 1)):
        mat = np.full((W, L), -1, np.int32)
        for r in range(n):
            k = L if r % 3 != 1 else int(rng.integers(1, L + 1))
            row = []
            while len(row) < k:
                row += [base + int(rng.integers(0, 6))] * int(rng.integers(1, 21))
            if r % 5 == 0:
                row = [base + 1] * k
            mat[r, :k] = row[:k]
        for r in range(0, n - 1, 3):  # the next row starts with this row's last id
            mat[r + 1, 0] = mat[r, (mat[r] >= 0).sum() - 1]
        freq = rng.integers(1, 6, W).astype(np.int32)
        freq[rng.random(W) < 0.125] = 0
        freq[n:] = 0
        out.append((mat, freq))
    return out


# v0's apply edge rows: (width, rows, live rows) a bucket, the last an odd
# width past 1024 (a word of its own width)
APPLY_BUCKETS = ((8, 64, 48), (16, 32, 24), (128, 8, 6), (1024, 4, 3), (1029, 2, 2))
APPLY_GRIDS = (0, 1, 3)  # the apply checks' grids: one wave, then 1 and 3 blocks


def apply_edge_cands(base: int) -> list:
    """The rounds (x, y, z) of v0's apply edge checks, ids from ``base``: a
    pair of equal ids (E E), a pair of two (A B), then pairs of the merged
    ids (runs of E E's merge, an odd run's merge before its last E, the
    merged A B alternations) and a filler pair."""
    E, A, B, F = base, base + 1, base + 2, base + 3
    z = base + 40
    return [(E, E, z), (A, B, z + 1), (z, z, z + 2), (z, E, z + 3), (z + 1, z + 1, z + 4),
            (F, F + 1, z + 5)]


def apply_edge_buckets(base: int, rng):
    """v0's apply edge rows, ids from ``base``, as buckets [(tokens [W, L],
    freq [W])] of APPLY_BUCKETS, laid out as the preprocessing lays them
    out (padding rows of PAD at frequency 0 at each bucket's end): rows of
    runs of E (1-21 tokens, odd and even), A B alternations and fillers;
    rows that fill their width; rows of E to their width; rows whose last
    pair is A B or E E (a hit at a row's last pair), full or ending before
    PAD; full rows whose last id and the next row's first are A and B, or E
    and E (no pair across rows)."""
    E, A, B, F = base, base + 1, base + 2, base + 3

    def segment():
        k = int(rng.integers(0, 5))
        if k == 0:
            return [E] * int(rng.integers(1, 22))
        if k == 1:
            return [A, B] * int(rng.integers(1, 4))
        if k == 2:
            return [F, F + 1]
        return [F + int(v) for v in rng.integers(0, 6, int(rng.integers(1, 6)))]

    out = []
    for L, W, n in APPLY_BUCKETS:
        mat = np.full((W, L), -1, np.int32)
        for r in range(n):
            kind = r % 6
            k = int(rng.integers(2, L + 1)) if kind in (1, 5) else L
            row = [E] * k if kind == 2 else []
            while len(row) < k:
                row += segment()
            row = row[:k]
            if kind in (3, 5):
                row[-2:] = [A, B]
            elif kind == 4:
                row[-3:] = [F, E, E]
            mat[r, :k] = row
        for r in range(0, n - 1, 3):  # a full row, and the next row's first id
            if mat[r, -1] >= 0:
                mat[r, -1], mat[r + 1, 0] = (A, B) if r % 2 else (E, E)
        freq = rng.integers(1, 6, W).astype(np.int32)
        freq[n:] = 0
        out.append((mat, freq))
    return out


def apply_quiet_rows(base: int, rng):
    """Rows (buckets of widths 8, 16 and 1029) of ids that no round of
    ``apply_edge_cands`` merges: a shard without a hit."""
    out = []
    for L, W in ((8, 16), (16, 8), (1029, 1)):
        mat = rng.integers(base + 20, base + 26, (W, L)).astype(np.int32)
        mat[W // 2 :, L // 2 :] = -1
        out.append((mat, rng.integers(1, 6, W).astype(np.int32)))
    return out


FOLD_PARTS, FOLD_CAP = 3, 64  # the fold checks' mesh: parts of 21, 21 and 22 slots
FOLD_CASES = ("scratch overflow", "parts union", "list drops claims")


def pairs_of_part(n: int, part: int, count: int, seed: int) -> np.ndarray:
    """``count`` distinct pairs (x, y) of ids 4-2999 whose key lies in part
    ``part`` of ``n`` (csrc/part_list.cuh key_part)."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    rng = np.random.default_rng(seed)
    xy = np.unique(rng.integers(4, 3000, (40 * count * n, 2)), axis=0)
    mine = xy[(dsk.key_part(torch.from_numpy((xy[:, 0] << 32) | xy[:, 1]), n) == part).numpy()]
    check(len(mine) >= count, f"{len(mine)} pairs of part {part} of {n}")
    return mine[rng.permutation(len(mine))[:count]]


def pair_words(pairs) -> tuple:
    """(t, wid, freq) of a flat stream of two-token words, each one pair of
    weight 1."""
    t = np.asarray(pairs, np.int32).reshape(-1)
    wid = np.repeat(np.arange(len(pairs), dtype=np.int32), 2)
    return t, wid, np.ones(len(pairs), np.int32)


def fold_case_pairs(case: str) -> list:
    """Each shard's pairs (FOLD_PARTS shards, scratch tables of FOLD_CAP
    slots) for one of FOLD_CASES: shard 0 with 36 keys, past half its table
    (ROVF); three disjoint shards of 8 keys a part, 24 a part together
    against parts of 21-22 slots; shard 0 with 30 keys, all of part 0, more
    than its list of 21 holds (and less than half the table)."""
    n = FOLD_PARTS
    if case == "scratch overflow":
        pairs = [pairs_of_part(n, p, 12, 10 + p) for p in range(n)]
        return [np.concatenate(pairs)] + [pairs[0][:4]] * (n - 1)
    if case == "parts union":
        parts = [pairs_of_part(n, p, 24, 20 + p) for p in range(n)]
        return [np.concatenate([q[8 * s : 8 * s + 8] for q in parts]) for s in range(n)]
    return [pairs_of_part(n, 0, 30, 40)] + [pairs_of_part(n, 1, 4, 41)] * (n - 1)


GATHER_ROUNDS = 5  # the listed gather's rounds: the tables regrow before round 2; round 4 fills a part


def gather_round_pairs(r: int) -> list:
    """Each shard's pairs (FOLD_PARTS shards) in round ``r`` of the listed
    gather's checks: from a pool of 24 keys a part, a window of them a part
    that moves from round to round (keys leave and join, so the filled slots
    move), each key on one shard and the window's first on every shard
    (counts summed); 8 and 6 keys a part in rounds 0-1 (tables of FOLD_CAP
    slots), 10 and 18 in rounds 2-3 (tables regrown to twice that); in round 4, 45
    keys of part 0 against its 42 slots (a full part)."""
    n = FOLD_PARTS
    if r == 4:
        full = pairs_of_part(n, 0, 45, 70)
        return [full[s::n] for s in range(n)]
    pool = [pairs_of_part(n, p, 24, 60 + p) for p in range(n)]
    lo, size = ((0, 8), (4, 6), (8, 10), (2, 18))[r]
    out = []
    for s in range(n):
        mine = [q[lo : lo + size] for q in pool]
        out.append(np.concatenate([np.concatenate([m[:1], m[1:][s::n]]) for m in mine]))
    return out


def stream_shard_of(t, wid, freq, dev, cap: int = FOLD_CAP, n: int = FOLD_PARTS):
    """A sharded v1 shard state of a flat stream (its scratch table listed
    among ``n`` parts), ids below its rules' end."""
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk

    vocab = int(np.max(t)) + 16
    return rsk.StreamShardState(t, wid, freq, np.full((vocab, 4), -1, np.int32), vocab - 8, cap,
                                dev, n)


TOMB_WORD_SLOTS = 5000  # the long words that are all tombstones but for a few tokens


def tomb_lay(groups, base: int, rng, period: int = 128):
    """(t, wid, freq) of a v3 stream holding each group of words (lists of
    ids, -1 a tombstone) after a filler word of live random ids from
    ``base``: 2-130 of them, or, for a group given as (words, k), as many as
    start the group k slots past a multiple of ``period`` (a 128-slot
    chunk's first slot).  Seven positions that belong to no word end the
    stream; weights 1-5."""
    words, pos = [], 0
    for g in groups:
        gw, k = g if isinstance(g, tuple) else (g, None)
        n = int(rng.integers(2, 131)) if k is None else 2 + (k - pos - 2) % period
        words.append([base + int(v) for v in rng.integers(0, 6, n)])
        words += gw
        pos += n + sum(len(w) for w in gw)
    t, wid, freq = flat_words(words, rng)
    tail = np.full(7, -1, np.int32)
    return np.concatenate([t, tail]), np.concatenate([wid, tail]), freq


def tomb_edge_streams(base: int, rng):
    """(what, t, wid, freq) of the tombstoned count's edge streams
    (csrc/tomb_count.cuh, which sparse_count and sparse_shard_recount run),
    ids from ``base``; the CPU tests (tests/test_torch_train_sparse.py) hold
    the plain versions against the JAX package's host count on the same
    streams.  A filler word of random length comes before each pattern, so
    that the patterns fall across 128-slot chunk boundaries at many offsets:
    count_edge_words with a third of their positions tombstoned; runs of one
    id split by runs of 1-300 tombstones (2-5 live tokens, and runs of 600
    with a quarter tombstoned), started anywhere and two slots before a
    chunk's end; adjacent words whose boundary ids are equal, boundaries on
    a chunk's first slot, with and without tombstones beside them; words of
    TOMB_WORD_SLOTS slots that are all tombstones but for a few tokens (an
    equal run among them, tokens on a chunk's first and last slots), an
    all-tombstone word and a one-token word."""
    a, b, c = base, base + 1, base + 2
    t, wid, freq = flat_words(count_edge_words(base, rng), rng)
    t = np.where(rng.random(t.size) < 1 / 3, -1, t).astype(np.int32)
    out = [("edge words, a third of their positions tombstones", t, wid, freq)]

    def split_run(n_live, gaps):
        w = [c]
        for i in range(n_live):
            w += [a] + [-1] * (gaps[i] if i < len(gaps) else 0)
        return w + [b]

    groups = []
    for gaps in ([1], [3, 3], [40], [130], [300, 1], [1, 130, 2], [127, 129, 128]):
        for n_live in (2, 3, 4, 5):
            groups += [[split_run(n_live, gaps)], ([split_run(n_live, gaps)], 126)]
    for _ in range(3):
        groups.append([[c] + [-1 if v else a for v in rng.random(600) < 0.25] + [b]])
    out.append(("runs of one id split by tombstone runs across chunks",
                *tomb_lay(groups, base, rng)))

    groups = [([[c, a, a], [a, a, c]], 125), [[c, a, a], [a, a, c]],
              ([[c, a, a, -1, -1], [-1, a, a, c]], 123), [[a] * 5 + [-1] * 130, [-1] * 3 + [a] * 4],
              ([[b, a], [a]], 126), ([[a], [a], [a, a]], 127), ([[a, -1], [-1, a, a]], 126)]
    for _ in range(30):
        groups.append([[-1 if v < 0.3 else a for v in rng.random(int(n))]
                       for n in rng.integers(1, 10, int(rng.integers(2, 4)))])
    out.append(("equal ids on both sides of word boundaries", *tomb_lay(groups, base, rng)))

    def sparse_word(live):
        w = [-1] * TOMB_WORD_SLOTS
        for at, v in live:
            w[at] = v
        return w

    groups = [([sparse_word([(0, c), (1000, a), (1023, a), (1024, a), (2175, a), (3000, b),
                             (4999, a)])], 0),
              [[-1] * 300], ([sparse_word([(5, a), (4990, a)])], 0), [[a]],
              ([sparse_word([(127, a), (128, a), (129, a), (4000, b)])], 0)]
    out.append(("words all tombstones but a few tokens", *tomb_lay(groups, base, rng)))
    return out


def tomb_state(kernel: str, t, wid, freq, dev, cap: int):
    """A state of ``kernel``'s trainer on the stream: (the state, the shards
    its count reads): a SparseState, or a SparseShardState beside a second
    shard of the same stream."""
    from youtokentome_tpu_torch.ops import sparse_kernels as spk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk

    rules = np.full((int(max(t.max(), 0)) + 16, 4), -1, np.int32)
    if kernel == "sparse_count":
        st = spk.SparseState(t, wid, freq, rules, rules.shape[0], cap, dev)
        return st, [st]
    shards = [ssk.SparseShardState(t, wid, freq, rules, rules.shape[0], cap, MID_DCAP, dev)
              for _ in range(2)]
    return shards[0], shards


def tomb_count(kernel: str, st, shards, plain: bool, blocks: int = 0) -> None:
    """``kernel`` on ``st`` (its plain version with ``plain``; the kernel on
    at most ``blocks`` blocks when > 0), the recount's gate opened by the
    other shard's DOVF."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import sparse_kernels as spk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk

    if kernel == "sparse_count":
        if plain:
            count_plain(spk, "sparse", st)
        else:
            spk.sparse_count(st, blocks)
        return
    shards[-1].ctl[dsk.DOVF] = 1
    if plain:
        ssk.sparse_shard_recount_plain(st, shards)
    else:
        ssk.sparse_shard_recount(st, shards, blocks)


def tomb_slots(kernel: str) -> tuple:
    """The ctl slots of the table's occupancy and overflow that ``kernel``
    writes."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    return (tk.OCC, tk.OVERFLOW) if kernel == "sparse_count" else (dsk.ROCC, dsk.ROVF)


def tomb_table(kernel: str, st):
    """The table the count filled, as a sorted (keys, counts) multiset."""
    return st.table() if kernel == "sparse_count" else scratch_table(st)


def tomb_same(kernel: str, a, b, what: str) -> None:
    if kernel == "sparse_count":
        same_diff_state(a, b, what)
    else:
        same_shard(a, b, what, buffers=False, stream=("t",))


def tomb_check(kernel: str, st, shards, uk, uc, what: str) -> int:
    """``kernel`` on clones of ``st`` (among ``shards``) on one wave of
    blocks and on one block (each warp many chunks) against its plain
    version and the host count (uk, uc); returns the checks made."""
    occ, ovf = tomb_slots(kernel)
    i = next(j for j, s in enumerate(shards) if s is st)
    p = [clone_state(s) for s in shards]
    tomb_count(kernel, p[i], p, True)
    for blocks in (0, 1):
        k = [clone_state(s) for s in shards]
        for s in k:
            s._links = None
        tomb_count(kernel, k[i], k, False, blocks)
        label = f"{kernel} on {blocks or 'one wave of'} block(s), {what}"
        tomb_same(kernel, k[i], p[i], label)
        keys, cnts = tomb_table(kernel, k[i])
        check(np.array_equal(keys, np.asarray(uk, np.int64)) and np.array_equal(cnts, uc),
              f"{label}: != the host count table")
        check(int(k[i].ctl[occ]) == keys.size and not int(k[i].ctl[ovf]),
              f"{label}: occupancy {int(k[i].ctl[occ])} of {keys.size}, overflow "
              f"{int(k[i].ctl[ovf])}")
    return 2


def phase_tomb_checks(kernel: str, main_st, main_shards, dev) -> dict:
    """The tombstoned count (``kernel``: "sparse_count", phase 9, or
    "sparse_shard_recount", phase 11) against its plain version and the
    host count table (``_host_table_tomb``) on tomb_edge_streams, ids from
    5 and 70000, on one wave of blocks and on one (the recount's gate shut:
    its scratch table untouched; opened by the other shard's DOVF); then
    the main path's state (``main_st`` among ``main_shards``) counted into
    COUNT_SMALL_CAP slots, which overflow at the first count (the kernel and
    the plain version), again at twice the size until it fits, equal to the
    host count of its stream."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_sparse as sp

    t0 = time.perf_counter()
    n = 0
    for base in COUNT_BASES:
        rng = np.random.default_rng(base + 7)
        for what, t, wid, freq in tomb_edge_streams(base, rng):
            uk, uc = sp._host_table_tomb(t, wid, freq)
            st, shards = tomb_state(kernel, t, wid, freq, dev, td._next_pow2(4 * max(uk.size, 1)))
            label = f"{what}, ids from {base}"
            if kernel == "sparse_shard_recount" and st.device.type == "cuda":
                from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk

                st.rkeys.fill_(7)
                ssk.sparse_shard_recount(st, shards)
                torch.cuda.synchronize()
                check(bool((st.rkeys == 7).all()), f"{label}: the shut recount wrote its table")
                st.rkeys.fill_(tk.EMPTY)
            n += tomb_check(kernel, st, shards, uk, uc, label)
            log(f"[{9 if kernel == 'sparse_count' else 11}] {kernel}, {label}: == plain == host "
                f"count table on one wave and on one block ({t.size} slots, "
                f"{int((t >= 0).sum())} live, {uk.size} keys)")
    occ, ovf = tomb_slots(kernel)
    i = next(j for j, s in enumerate(main_shards) if s is main_st)
    uk, uc = sp._host_table_tomb(main_st.t.cpu().numpy(), main_st.wid.cpu().numpy(),
                                 main_st.freq.cpu().numpy())
    p = [clone_state(s) for s in main_shards]
    k = [clone_state(s) for s in main_shards]
    for s in p + k:
        s._links = None
        s.resize(COUNT_SMALL_CAP)
    tomb_count(kernel, p[i], p, True)
    check(int(p[i].ctl[ovf]) == 1, "the plain count did not overflow its small table")
    sizes = []
    while True:
        tomb_count(kernel, k[i], k, False)
        sizes.append((k[i].cap, int(k[i].ctl[ovf])))
        if not sizes[-1][1]:
            break
        for s in k:
            s._links = None
            s.resize(s.cap * 2)
    check(sizes[0] == (COUNT_SMALL_CAP, 1), f"{kernel} into {COUNT_SMALL_CAP} slots: {sizes}")
    keys, cnts = tomb_table(kernel, k[i])
    check(np.array_equal(keys, np.asarray(uk, np.int64)) and np.array_equal(cnts, uc)
          and int(k[i].ctl[occ]) == keys.size, f"{kernel}: the regrown count != the host count")
    log(f"[{9 if kernel == 'sparse_count' else 11}] {kernel} == plain == host count table on {n} "
        f"edge counts; into {COUNT_SMALL_CAP} slots the main path's count sets its overflow "
        f"(kernel and plain), counted again at {[c for c, _ in sizes[1:]]} slots it equals the "
        f"host count ({time.perf_counter() - t0:.1f} s)")
    return {"checks": n, "regrown": sizes}


def tomb_state_check(kernel: str, states, what: str) -> None:
    """The tombstoned count on clones of a trained run's states (every
    shard's, for the recount, its gate opened) against its plain version and
    the host count of each state's stream, on one wave and on one block."""
    from youtokentome_tpu_torch.ops import train_sparse as sp

    t0 = time.perf_counter()
    for i, st in enumerate(states):
        uk, uc = sp._host_table_tomb(st.t.cpu().numpy(), st.wid.cpu().numpy(),
                                     st.freq.cpu().numpy())
        live = int((st.t >= 0).sum())
        tomb_check(kernel, st, states, uk, uc, f"{what}, state {i}")
        log(f"[{9 if kernel == 'sparse_count' else 11}] {kernel} on {what}'s state {i} ({live} "
            f"live of {st.end} slots, {uk.size} keys): == plain == host count table on one wave "
            f"and on one block ({time.perf_counter() - t0:.1f} s)")


def phase_count_checks(main_st, dev) -> dict:
    """pair_count against its plain version and the host count table on
    ``count_edge_streams`` (ids from 5 and 70000; the random-pair stream
    gives each block more distinct keys than its shared table holds, so
    some go straight to the global table), and on the main path's stream
    into a table that overflows at its first count: OVERFLOW set by the
    kernel and the plain version, then counted again at twice the size
    until it fits (the engine's loop), the table equal to the host count."""
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t0 = time.perf_counter()
    n = 0
    for base in COUNT_BASES:
        rng = np.random.default_rng(base + 1)
        rules = np.full((base + COUNT_WIDE_IDS + 16, 4), -1, np.int32)
        for what, t, wid, freq in count_edge_streams(base, rng):
            uk, uc = td.host_count_table(t, wid, freq)
            st = tk.TrainState(t, wid, freq, rules, base + COUNT_WIDE_IDS,
                               td._next_pow2(4 * uk.size), dev)
            p_st = clone_state(st)
            tk.pair_count(st)
            plain_pair_count(p_st)
            label = f"pair_count, {what}, ids from {base}"
            same_state(st, p_st, label)
            keys, cnts = st.table()
            check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
                  f"{label}: != the host count table")
            check(not int(st.ctl[tk.OVERFLOW]), f"{label}: overflowed")
            per_block = st.tok.shape[0] // COUNT_MAX_BLOCKS
            head = st.tok[: per_block + 1].cpu().numpy()
            on = (head[:-1] >= 0) & (head[1:] >= 0)
            pairs = np.unique(head[:-1][on].astype(np.int64) << 32 | head[1:][on])
            log(f"[5] {label}: == plain == host count table ({st.tok.shape[0]} slots, {uk.size} "
                f"keys; the first {per_block} slots, the fewest a block takes, hold "
                f"{pairs.size} pairs)")
            n += 1
    check(pairs.size > 2048, f"the random-pair stream gives a block {pairs.size} pairs")
    # a table that overflows at its first count
    k_st, p_st = clone_state(main_st), clone_state(main_st)
    k_st.resize(COUNT_SMALL_CAP)
    p_st.resize(COUNT_SMALL_CAP)
    plain_pair_count(p_st)
    check(int(p_st.ctl[tk.OVERFLOW]) == 1, "the plain count did not overflow its small table")
    sizes = []
    while True:
        tk.pair_count(k_st)
        sizes.append((k_st.cap, int(k_st.ctl[tk.OVERFLOW])))
        if not sizes[-1][1]:
            break
        k_st.resize(k_st.cap * 2)
    check(sizes[0] == (COUNT_SMALL_CAP, 1), f"pair_count into {COUNT_SMALL_CAP} slots: {sizes}")
    main_keys, main_cnts = main_st.table()
    keys, cnts = k_st.table()
    check(np.array_equal(keys, main_keys) and np.array_equal(cnts, main_cnts)
          and int(k_st.ctl[tk.OCC]) == keys.size, "the regrown count != the main path's count")
    log(f"[5] pair_count == plain == host count table on {n} edge streams; into "
        f"{COUNT_SMALL_CAP} slots the main path's count sets OVERFLOW (kernel and plain), "
        f"counted again at {[c for c, _ in sizes[1:]]} slots it equals the main path's table "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"streams": n, "regrown": sizes}


def stream_count(st, plain: bool, blocks: int = 0) -> None:
    """v1's count of ``st`` up to its rules' end: ``recount`` on a
    one-device state, ``stream_shard_count`` on a shard (the kernel on at
    most ``blocks`` blocks when > 0, else one wave: ``COUNT_BLOCKS``), or
    their plain versions."""
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import stream_train_kernels as stk

    v = st.rules.shape[0]
    shard = isinstance(st, rsk.StreamShardState)
    if plain:
        (rsk.stream_shard_count_plain if shard else stk.recount_plain)(st, v, v)
        return
    stk.COUNT_BLOCKS = blocks
    try:
        (rsk.stream_shard_count if shard else stk.recount)(st, v, v)
    finally:
        stk.COUNT_BLOCKS = 0


def phase_stream_count_checks(main_st, dev) -> dict:
    """v1's count (csrc/stream_count.cuh) through both entries, recount and
    stream_shard_count (its scratch table listed among 3 parts), against
    their plain versions and the host count table on ``count_edge_streams``
    and ``stream_edge_streams`` (ids from 5 and 70000), on one wave of
    blocks and on one block (each warp walks many chunks), each counted
    twice (the second clear empties the table and the lists the first
    count filled); then the main
    path's state into a table that overflows at its first count (kernel and
    plain), counted again at twice the size until it fits, equal to the
    main path's table."""
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import stream_train_kernels as stk
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t0 = time.perf_counter()
    n = 0
    for base in COUNT_BASES:
        streams = count_edge_streams(base, np.random.default_rng(base + 1)) + stream_edge_streams(
            base, np.random.default_rng(base + 3))
        vocab = base + COUNT_WIDE_IDS + 16
        rules = np.full((vocab, 4), -1, np.int32)
        for what, t, wid, freq in streams:
            uk, uc = td.host_count_table(t, wid, freq)
            cap = td._next_pow2(4 * uk.size)
            for parts in (0, FOLD_PARTS):
                st = (rsk.StreamShardState(t, wid, freq, rules, vocab - 16, cap, dev, parts)
                      if parts else stk.StreamState(t, wid, freq, rules, vocab - 16, cap, dev))
                p_st = clone_state(st)
                stream_count(p_st, True)
                for blocks in (0, 1):
                    k_st = clone_state(st)
                    for again in range(2):
                        stream_count(k_st, False, blocks)
                        label = (f"{'stream_shard_count' if parts else 'recount'}, {what}, ids "
                                 f"from {base}, {blocks or 'a wave of'} blocks, count {again + 1}")
                        if parts:
                            same_shard(k_st, p_st, label, buffers=False, stream=("t", "wid"))
                            keys, cnts = scratch_table(k_st)
                            ovf = k_st.ctl[rsk.ROVF]
                        else:
                            same_diff_state(k_st, p_st, label)
                            keys, cnts = k_st.table()
                            ovf = k_st.ctl[tk.OVERFLOW]
                        check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
                              f"{label}: != the host count table")
                        check(not int(ovf), f"{label}: overflowed")
                n += 1
            log(f"[9] v1's count, {what}, ids from {base}: recount and stream_shard_count (lists "
                f"of {FOLD_PARTS} parts) == plain == host count table ({t.size} slots, {uk.size} "
                f"keys; one wave and one block, two counts each)")
    # a table that overflows at its first count
    k_st, p_st = clone_state(main_st), clone_state(main_st)
    k_st.resize(COUNT_SMALL_CAP)
    p_st.resize(COUNT_SMALL_CAP)
    stream_count(p_st, True)
    check(int(p_st.ctl[tk.OVERFLOW]) == 1, "v1's plain count did not overflow its small table")
    sizes = []
    while True:
        stream_count(k_st, False)
        sizes.append((k_st.cap, int(k_st.ctl[tk.OVERFLOW])))
        if not sizes[-1][1]:
            break
        k_st.resize(k_st.cap * 2)
        k_st.ctl[tk.OVERFLOW] = 0
    check(sizes[0] == (COUNT_SMALL_CAP, 1), f"recount into {COUNT_SMALL_CAP} slots: {sizes}")
    main_keys, main_cnts = main_st.table()
    keys, cnts = k_st.table()
    check(np.array_equal(keys, main_keys) and np.array_equal(cnts, main_cnts)
          and int(k_st.ctl[tk.OCC]) == keys.size, "v1's regrown count != the main path's count")
    log(f"[9] v1's count == plain == host count table on {n} stream and entry pairs; into "
        f"{COUNT_SMALL_CAP} slots the main path's count sets OVERFLOW (kernel and plain), counted "
        f"again at {[c for c, _ in sizes[1:]]} slots it equals the main path's table "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"streams": n, "regrown": sizes}


def compact_round(ks, ps, cands, used: int, what: str, shards: bool) -> None:
    """One round of v1's apply on kernel states ``ks`` (one launch for all
    of them) and plain states ``ps``: each counted (which turns its
    buffers), ``cands`` set as the round's accepted rows, applied; both
    buffers, ctl, work and the tables (with the shards' lists) compared."""
    from youtokentome_tpu_torch.ops import stream_train_kernels as stk

    for a, b in zip(ks, ps):
        stream_count(a, False)
        stream_count(b, True)
        set_round(a, cands, used)
        set_round(b, cands, used)
    stk.apply_compact(ks)
    for b in ps:
        stk.apply_compact_plain(b)
    for i, (a, b) in enumerate(zip(ks, ps)):
        label = f"{what}, shard {i}" if shards else what
        if shards:
            same_shard(a, b, label, buffers=False, stream=STREAM_BUFFERS)
        else:
            same_diff_state(a, b, label)
        check(int(a.ctl[stk.NEXT_BUF]) != int(a.ctl[stk.BUF]),
              f"{label}: the apply did not write the other buffer")
    head = ks[0].tiles[:stk.TILE_SCRATCH].tolist()
    check(head[:2] == [0, 0], f"{what}: the apply left its ticket and block count at {head[:2]}")


def phase_compact_checks(dev) -> dict:
    """v1's apply (csrc/train_stream.cu apply_compact) against its plain
    version on ``compact_edge_stream`` (ids from 5 and 70000), COMPACT_ROUNDS
    rounds (odd: the stream ends in the second buffer), each round's 16
    candidates the edge stream's first, then ``compact_cands`` of the plain
    stream: on one state, and on the stream cut at word boundaries into 3
    shards with a fourth that holds no token, all 4 in one launch a round.
    After every round both buffers, ctl (the buffers' turn, the live counts),
    work and the tables agree, the other buffer still holds the round's
    input, and the apply's ticket is back at 0 (on the card: its epoch
    moved on once a round)."""
    import torch

    from youtokentome_tpu_torch.ops import stream_train_kernels as stk

    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    n = 0
    for base in COUNT_BASES:
        t, wid, freq, first = compact_edge_stream(base, np.random.default_rng(base + 5))
        used0 = base + COMPACT_USED
        vocab = used0 + 16 * COMPACT_ROUNDS + 16
        rules = np.full((vocab, 4), -1, np.int32)
        live = int((t >= 0).sum())
        cuts = np.searchsorted(wid[:live], np.linspace(0, wid[live - 1] + 1, 4)[1:-1])
        shard_of = [(np.r_[t[a:b], np.full(20, -1, np.int32)],
                     np.r_[wid[a:b], np.full(20, -1, np.int32)])
                    for a, b in zip(np.r_[0, cuts], np.r_[cuts, live])]
        shard_of.append((np.full(16, -1, np.int32), np.full(16, -1, np.int32)))
        for shards in (False, True):
            if shards:
                ks = [stream_shard_of(a, b, freq, dev, 1 << 14, len(shard_of))
                      for a, b in shard_of]
            else:
                ks = [stk.StreamState(t, wid, freq, rules, used0, 1 << 16, dev)]
            ps = [clone_state(st) for st in ks]
            used, cands = used0, first
            for r in range(COMPACT_ROUNDS):
                if r:
                    cur = [(p.t.cpu().numpy(), p.wid.cpu().numpy()) for p in ps]
                    cands = compact_cands(np.concatenate([c[0] for c in cur]),
                                          np.concatenate([c[1] for c in cur]))
                what = (f"apply_compact, {'4 shards in one launch' if shards else 'one state'}, "
                        f"ids from {base}, round {r + 1}")
                compact_round(ks, ps, cands, used, what, shards)
                used += len(cands)
                n += 1
            for a in ks:
                check(int(a.ctl[stk.NEXT_BUF]) == COMPACT_ROUNDS % 2 and
                      (not on_card or int(a.tiles[stk.TILE_SCRATCH - 1]) == COMPACT_ROUNDS),
                      f"apply_compact after {COMPACT_ROUNDS} rounds: buffer "
                      f"{int(a.ctl[stk.NEXT_BUF])}, epoch {int(a.tiles[stk.TILE_SCRATCH - 1])}")
    log(f"[9] v1's apply == plain on {n} edge rounds ({COMPACT_ROUNDS} a stream, ids from "
        f"{COUNT_BASES}): runs of hits across 128-slot chunk, 512-slot warp and "
        f"{COMPACT_TILE}-slot tile edges, 16 candidates, a hit at the live end, one state and 4 "
        f"shards (one empty) in one launch; both buffers, ctl and work after every round, the "
        f"stream in the second buffer after the last ({time.perf_counter() - t0:.1f} s)")
    return {"rounds": n}


def bucket_count(st, plain: bool, blocks: int = 0) -> None:
    """v0's count of ``st`` up to its rules' end: ``bucket_count`` on a
    one-device state, ``bucket_shard_count`` on a shard (the kernel on at
    most ``blocks`` blocks when > 0, else one wave: ``COUNT_BLOCKS``), or
    their plain versions."""
    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk

    v = st.rules.shape[0]
    shard = isinstance(st, rsk.BucketedShardState)
    if plain:
        (rsk.bucket_shard_count_plain if shard else bk.bucket_count_plain)(st, v, v)
        return
    bk.COUNT_BLOCKS = blocks
    try:
        (rsk.bucket_shard_count if shard else bk.bucket_count)(st, v, v)
    finally:
        bk.COUNT_BLOCKS = 0


def phase_row_count_checks(main_st, dev) -> dict:
    """v0's count (csrc/train_bucketed.cu's flat walk into pair_count.cuh's
    block table) through both entries, bucket_count and bucket_shard_count
    (its scratch table listed among 3 parts), against their plain versions
    on ``row_edge_buckets`` (ids from 5 and 70000: full rows with the same
    id across their ends, runs, padding rows, odd widths past 1024) whole
    and as the middle of 3 shards of its rows (odd slot counts a bucket), on
    one wave of blocks and on one block (each warp walks many chunks), each
    counted twice; then the main path's state into a table that overflows
    at its first count, counted again at twice the size until it fits,
    equal to the main path's table."""
    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.parallel.train_sharded import shard_rows

    t0 = time.perf_counter()
    n = 0
    for base in COUNT_BASES:
        buckets = row_edge_buckets(base, np.random.default_rng(base + 7))
        vocab = base + 40
        rules = np.full((vocab, 4), -1, np.int32)
        for rows, parts in ((buckets, 0), (buckets, FOLD_PARTS),
                            (shard_rows(buckets, FOLD_PARTS)[1], FOLD_PARTS)):
            st = (rsk.BucketedShardState(rows, rules, vocab - 10, 1 << 12, dev, parts) if parts
                  else bk.BucketedState(rows, rules, vocab - 10, 1 << 12, dev))
            p_st = clone_state(st)
            bucket_count(p_st, True)
            for blocks in (0, 1):
                k_st = clone_state(st)
                for again in range(2):
                    bucket_count(k_st, False, blocks)
                    label = (f"{'bucket_shard_count' if parts else 'bucket_count'}, "
                             f"{'a third of ' if rows is not buckets else ''}the edge rows, ids "
                             f"from {base}, {blocks or 'a wave of'} blocks, count {again + 1}")
                    if parts:
                        same_shard(k_st, p_st, label, buffers=False)
                        check(not int(k_st.ctl[rsk.ROVF]), f"{label}: overflowed")
                    else:
                        same_diff_state(k_st, p_st, label)
                        check(not int(k_st.ctl[tk.OVERFLOW]), f"{label}: overflowed")
            n += 1
        log(f"[9] v0's count, the edge rows ({sum(m.size for m, _ in buckets)} slots, widths "
            f"{[m.shape[1] for m, _ in buckets]}), ids from {base}: bucket_count and "
            f"bucket_shard_count (lists of {FOLD_PARTS} parts; all rows and a third) == plain "
            f"(one wave and one block, two counts each)")
    k_st, p_st = clone_state(main_st), clone_state(main_st)
    k_st.resize(COUNT_SMALL_CAP)
    p_st.resize(COUNT_SMALL_CAP)
    bucket_count(p_st, True)
    check(int(p_st.ctl[tk.OVERFLOW]) == 1, "v0's plain count did not overflow its small table")
    sizes = []
    while True:
        bucket_count(k_st, False)
        sizes.append((k_st.cap, int(k_st.ctl[tk.OVERFLOW])))
        if not sizes[-1][1]:
            break
        k_st.resize(k_st.cap * 2)
        k_st.ctl[tk.OVERFLOW] = 0
    check(sizes[0] == (COUNT_SMALL_CAP, 1), f"bucket_count into {COUNT_SMALL_CAP} slots: {sizes}")
    main_keys, main_cnts = main_st.table()
    keys, cnts = k_st.table()
    check(np.array_equal(keys, main_keys) and np.array_equal(cnts, main_cnts)
          and int(k_st.ctl[tk.OCC]) == keys.size, "v0's regrown count != the main path's count")
    log(f"[9] v0's count == plain on {n} row sets; into {COUNT_SMALL_CAP} slots the main path's "
        f"count sets OVERFLOW (kernel and plain), counted again at {[c for c, _ in sizes[1:]]} "
        f"slots it equals the main path's table ({time.perf_counter() - t0:.1f} s)")
    return {"row_sets": n, "regrown": sizes}


def row_apply(states, blocks: int) -> None:
    """v0's apply of one round on ``states`` (one card's), the kernel on at
    most ``blocks`` blocks when > 0, else one wave (``APPLY_BLOCKS``)."""
    from youtokentome_tpu_torch.ops import bucketed_kernels as bk

    bk.APPLY_BLOCKS = blocks
    try:
        bk.bucket_apply(states)
    finally:
        bk.APPLY_BLOCKS = 0


def same_rows(ks, ps, what: str) -> None:
    """Kernel and plain v0 states agree after an apply: rows, ctl and work
    (W_WRITES, the slots that changed)."""
    import torch

    for i, (a, b) in enumerate(zip(ks, ps)):
        check(torch.equal(a.tok, b.tok), f"{what}: state {i}'s rows differ")
        check(torch.equal(a.ctl, b.ctl), f"{what}: state {i}'s ctl {a.ctl.tolist()} != "
              f"{b.ctl.tolist()}")
        check(torch.equal(a.work, b.work), f"{what}: state {i}'s work {a.work.tolist()} != "
              f"{b.work.tolist()}")


def phase_row_apply_checks(main_st, used0: int, dev) -> dict:
    """v0's apply (csrc/train_bucketed.cu's flat walk of the rows) against
    its plain version, through both entries (one state; 4 states of a card
    in one launch): on ``apply_edge_buckets`` (ids from 5 and 70000: widths
    8-1024 and 1029, runs of equal ids, hits at rows' last pairs, full rows
    whose ends meet the next row's same ids, padding rows) whole, and cut in
    3 shards with a fourth that never holds a hit, the rounds of
    ``apply_edge_cands`` in turn, on each grid of APPLY_GRIDS (one wave, then
    1 and 3 blocks: warp runs that end inside rows, those of the odd width
    too); rows, ctl and work (W_WRITES) after every round; then the main
    path's state (the 100 MB rows) through one round on one wave and on 64
    blocks."""
    import torch

    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.parallel.train_sharded import shard_rows

    t0 = time.perf_counter()
    n, writes = 0, 0
    for base in COUNT_BASES:
        rng = np.random.default_rng(base + 11)
        buckets = apply_edge_buckets(base, rng)
        quiet = apply_quiet_rows(base, rng)
        vocab = base + 64
        rules = np.full((vocab, 4), -1, np.int32)
        for label, parts in (("one state", [buckets]),
                             ("4 states in one launch", shard_rows(buckets, 3) + [quiet])):
            for blocks in APPLY_GRIDS:
                ks = [bk.BucketedState(b, rules, vocab - 10, 1 << 10, dev) for b in parts]
                ps = [clone_state(st) for st in ks]
                for r, xyz in enumerate(apply_edge_cands(base)):
                    for st in ks + ps:
                        st.cand[0, :3] = torch.tensor(xyz, dtype=torch.int32, device=st.device)
                        st.ctl[tk.NACC] = 1
                    row_apply(ks, blocks)
                    for st in ps:
                        bk.bucket_apply_plain(st)
                    same_rows(ks, ps, f"bucket_apply, the edge rows, ids from {base}, {label}, "
                                      f"{blocks or 'a wave of'} blocks, round {r + 1} {xyz}")
                    n += 1
                writes += sum(int(st.work[bk.W_WRITES]) for st in ks)
                if len(ks) > 1:
                    check(int(ks[-1].work[bk.W_WRITES]) == 0, "the state without a hit was written")
    check(writes > 0, "the apply's edge rounds wrote no slot")
    base = clone_state(main_st)
    v = int(base.rules.shape[0])
    tk.topk_accept_plain(base, v, v, used0, 1)
    check(int(base.ctl[tk.NACC]) == 1, "the main path's state accepted no pair")
    main_writes = []
    for blocks in (0, 64):
        ks, ps = [clone_state(base)], [clone_state(base)]
        row_apply(ks, blocks)
        bk.bucket_apply_plain(ps[0])
        same_rows(ks, ps, f"bucket_apply, the 100 MB rows, {blocks or 'a wave of'} blocks")
        main_writes.append(int(ks[0].work[bk.W_WRITES]) - int(base.work[bk.W_WRITES]))
    check(min(main_writes) > 0, "the main path's round wrote no slot")
    log(f"[9] v0's apply == plain on {n} edge rounds (ids from {COUNT_BASES}, widths "
        f"{[b[0] for b in APPLY_BUCKETS]}; one state, and 4 states in one launch, one without a "
        f"hit; grids {APPLY_GRIDS}; {writes} slots written) and on the 100 MB rows "
        f"({int(main_st.tok.shape[0])} slots, {main_writes[0]} written, one wave and 64 blocks) "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"rounds": n, "writes": writes}


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
    phase_count_checks(st, dev)

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


LIBRARY_EVERY = 8  # rounds between two samples of a library yardstick on a main path


def library_note(row: dict, sample) -> str:
    """The log's words for a row's library yardstick."""
    if row.get("library_ms") is None:
        return ""
    return (f"; library {row['library_ms']:.3f} ms ({len(sample.events)} samples, one every "
            f"{LIBRARY_EVERY} rounds, scaled to the {row['launches']} launches)")


class LibrarySample:
    """A library yardstick timed on every LIBRARY_EVERY-th round of a run
    and scaled to its wrapper's launches: each sample enqueues its PyTorch
    calls between two CUDA events on the current stream, a sleep kernel
    ahead of them, without a wait on the host, so that the run goes on as
    it would (its device time grows by the samples' and the sleeps').  Its wrappers (``topk``, ``gather``, ``rounds``) are
    swapped in for the names an engine module calls; they leave the launch
    counts to the real wrappers."""

    def __init__(self):
        self.events, self.calls = [], 0

    def _timed(self, fn):
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)  # so that the host's enqueue is not timed
        a.record()
        fn()
        b.record()
        self.events.append((a, b))

    def topk_of(self, keys, cnts, k: int) -> None:
        """A sample of library_topk_ms: one torch.topk over the table's words
        (ordered outside the events)."""
        import torch

        from youtokentome_tpu_torch.ops import train_kernels as tk

        live = keys != tk.EMPTY
        zero = torch.zeros_like(keys)
        words = tk.order_words(cnts, torch.where(live, keys >> 32, zero).to(torch.int32),
                               torch.where(live, keys & 0xFFFFFFFF, zero).to(torch.int32))
        self._timed(lambda: torch.topk(words, k))

    def topk(self, real, per_round: int = 1):
        """A topk_accept that samples the table of the first of the
        ``per_round`` replicas that a round's calls take (they hold the same
        table) every LIBRARY_EVERY rounds."""
        def run(st, limit, vocab_size, used_ids0, k=16):
            if self.calls % (LIBRARY_EVERY * per_round) == 0:
                self.topk_of(st.keys, st.cnts, k)
            self.calls += 1
            return real(st, limit, vocab_size, used_ids0, k)
        return run

    def rounds(self, real):
        """A shard_rounds (the round graph's route) cut at every
        LIBRARY_EVERY-th replay, where it samples the head replica's table,
        which the next replay's top-k reads."""
        def run(eng, n: int, limit: int):
            while n > 0:
                if eng.replays % LIBRARY_EVERY == 0:
                    self.topk_of(eng.head.keys, eng.head.cnts, eng.batch_k)
                step = min(n, LIBRARY_EVERY - eng.replays % LIBRARY_EVERY)
                real(eng, step, limit)
                n -= step
        return run

    def gather(self, real):
        """A shard_gather that, every LIBRARY_EVERY rounds, copies with
        ``Tensor.copy_`` every other part of each replica of the card's
        launch (keys and counts, N - 1 slices each) from its owner into
        tables of its own (allocated outside the events)."""
        import torch

        from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

        def run(reps, shards):
            if self.calls % LIBRARY_EVERY == 0:
                n, cap = len(shards), shards[0].cap
                into = [(torch.empty_like(st.keys), torch.empty_like(st.cnts)) for st in reps]

                def copies():
                    for st, (keys, cnts) in zip(reps, into):
                        for p, o in enumerate(shards):
                            if o is not st:
                                lo, hi = dsk.part_lo(p, cap, n), dsk.part_lo(p + 1, cap, n)
                                keys[lo:hi].copy_(o.keys[lo:hi])
                                cnts[lo:hi].copy_(o.cnts[lo:hi])
                self._timed(copies)
            self.calls += 1
            return real(reps, shards)
        return run

    def ms(self, launches: int):
        """The samples' ms scaled to ``launches`` (a sample stands for one
        launch), or None without a sample."""
        if not self.events:
            return None
        self.events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / len(self.events) * launches


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
                   weights, and the slots the count fills (key and count);
                   and its kernel's device ms alone by CUDA events
                   (``count_ms``; the wrapper's table reset outside them)
                   and its plain version's ms on a copy of the state
                   (``count_plain_ms``, synchronised)
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

    from youtokentome_tpu_torch.ops import _cuda
    from youtokentome_tpu_torch.ops import train_kernels as tk

    w = {"count_launches": 0, "count_bytes": 0, "count_tokens": 0, "topk_bytes": 0,
         "topk_slots": 0, "topk_keys": 0, "apply_bytes": 0, "apply_tokens": 0, "rounds": 0,
         "apply_keys": 0, "apply_union_keys": 0, "library_ms": 0.0, "count_ms": 0.0,
         "count_plain_ms": 0.0}

    count = tk.pair_count

    def counted(st):
        if st.device.type != "cuda":
            count(st)
        else:
            # the plain version on a copy (its table's layout is its own);
            # then the wrapper's table reset, and its kernel alone between
            # CUDA events, a sleep kernel ahead so that the host's enqueue
            # is not timed
            _, ms = synced(lambda: plain_pair_count(clone_state(st)))
            w["count_plain_ms"] += ms
            st.keys.fill_(tk.EMPTY)
            st.cnts.zero_()
            st.ctl[[tk.OCC, tk.OVERFLOW]] = 0
            lib = _cuda.load_train()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
            a.record()
            err = lib.yttm_train_pair_count(
                st.tok.data_ptr(), st.pwid.data_ptr(), st.fw.data_ptr(), st.tok.shape[0],
                st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            b.record()
            b.synchronize()
            check(err == 0, f"pair_count kernel launch failed: CUDA error {err}")
            w["count_ms"] += a.elapsed_time(b)
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
    # the count's ms by CUDA events at its launches (run_work): late in this
    # script the profiler has missed the record of one of its four launches
    n_count = fn_us.get("pair_count_kernel", (0, 0))[1]
    check(n_count <= work["count_launches"],
          f"the profiler recorded {n_count} counts, the run made {work['count_launches']}")
    kernel_ms["pair_count"] = work["count_ms"]
    log(f"[5] pair_count: {work['count_ms']:.3f} ms over its {work['count_launches']} launches "
        f"(CUDA events); the profiler recorded {n_count} of them "
        f"({fn_us.get('pair_count_kernel', (0, 0))[0] / 1e3:.3f} ms)")

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

    # the round's kernels over the run's first TRAIN_PLAIN_IDS ids (beside
    # their device ms over the same ids); the segment ends' (the count and
    # the relay) over the whole run, the rounds on the card
    plain_vocab = used0 + TRAIN_PLAIN_IDS
    with swapped(
        tk,
        topk_accept=timed_plain(
            "topk_accept", lambda st, limit, v, u0, k=16: tk.topk_accept_plain(st, limit, v, u0, k)),
        apply_delta=timed_plain("apply_delta", tk.apply_delta_plain),
    ):
        eng = engine()
        run_engine(eng, plain_vocab, used0)
    check(torch.equal(eng.rules[:TRAIN_PLAIN_IDS], st.rules[:TRAIN_PLAIN_IDS]),
          "the plain versions' rules differ")
    with swapped(tk, relay=timed_plain("relay", tk.relay_plain)):
        eng = engine()
        run_engine(eng, TRAIN_VOCAB, used0)
    check(torch.equal(eng.rules, st.rules), "the plain relay's rules differ")
    plain_ms["pair_count"] = work["count_plain_ms"]  # on copies, in run_work
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_engine(engine(), plain_vocab, used0)
        torch.cuda.synchronize()
    prefix_ms = {name: profiled_ms(prof, TRAIN_DEVICE_FNS[name]) for name in TRAIN_ROUND_KERNELS}
    log(f"[5] plain versions (synchronised calls), {', '.join(TRAIN_ROUND_KERNELS)} over the "
        f"first {TRAIN_PLAIN_IDS} ids (the kernels' ms there: "
        + ", ".join(f"{k} {v:.3f}" for k, v in prefix_ms.items()) + "), the others over the "
        "run (the count on copies of its states): "
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
                     "library_ms": work["library_ms"] if name == "topk_accept" else None,
                     **prefix_of(name, prefix_ms, TRAIN_PLAIN_IDS)})
        log(f"[5] {name}: {launches[name]} launches, {kernel_ms[name]:.3f} ms on the card, "
            f"bound {max(b_ms, o_ms):.4f} ms ({rows[-1]['bound_by']}; bytes {bytes_[name]}), "
            f"plain {plain_ms[name]:.1f} ms" + plain_span(rows[-1])
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


def prefix_of(name: str, prefix_ms: dict, ids: int) -> dict:
    """The keys a row of the kernels record adds when its plain version
    was timed over the first ``ids`` ids: those and the kernel's ms there."""
    return {"plain_ids": ids, "prefix_ms": prefix_ms[name]} if name in prefix_ms else {}


def prefix_keys(row: dict) -> dict:
    """A row's plain_ids and prefix_ms, where it has them."""
    return {k: row[k] for k in ("plain_ids", "prefix_ms") if k in row}


def plain_span(row: dict) -> str:
    """Where a row's plain ms was timed, for the log."""
    if "plain_ids" not in row:
        return " over the run"
    return f" over the first {row['plain_ids']} ids (kernel {row['prefix_ms']:.3f} ms)"


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
TIERED_ROUND_KERNELS = ("tier_select", "apply_blocks", "resplit")  # see TRAIN_ROUND_KERNELS
# the device functions of each wrapper, as the profiler names them
# (apply_blocks's count mode, tier_count_kernel, is timed by CUDA events:
# its own row, tier_count)
TIERED_DEVICE_FNS = {
    "tier_select": ("tier_hot_kernel", "tier_full_kernel"),
    "apply_blocks": ("tier_find_kernel", "tier_apply_kernel"),
    "resplit": ("resplit_kernel",),
    "fold_rows": ("fold_plan_kernel", "fold_write_kernel"),
}
TIERED_REPLACES = {
    "tier_select": "youtokentome_tpu/ops/train_tiered.py:193",
    "apply_blocks": "youtokentome_tpu/ops/train_tiered.py:193",
    "resplit": "youtokentome_tpu/ops/train_tiered.py:193",
    "fold_rows": "youtokentome_tpu/ops/train_tiered.py:496",
    # the JAX host loop's count (host_count_table) and signatures (sig_build)
    "tier_count": "youtokentome_tpu/ops/train_tiered.py:608",
}
# the 10 MB lockstep run: a hot tier of 1024 entries (refresh rounds), a
# pcap of 1024 (the 702 initial pairs fit; the pairs that merges make do not:
# rebuilds), folds from 64 rows on
MID_HCAP, MID_TIERED_PCAP, MID_FOLD_MIN = 1024, 1024, 64
# integer operations per element, for the operations bound: a table slot
# scanned by a top-k or the resplit's radix passes (10), a row's signature
# test (20), a position of a listed or folded row (40)
OPS_PER_ROW, OPS_PER_ROWPOS = 20, 40
# ~1 ms of card time ahead of each timed resplit: longer than the host takes
# to enqueue the launch and its events
SPLIT_SLEEP_CYCLES = 2_000_000
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

    # the kept live count after the count and five rounds
    live = int(k_st.ctl[tk.LIVE])
    check(live == int((k_st.tok >= 0).sum()) == int(p_st.ctl[tk.LIVE]),
          f"ctl[LIVE] {live} != the stream's live tokens")
    # the fold's plan on the main-path stream; through the host loop's
    # trigger (a low YTTM_TRAIN_FOLD_MIN) the fold of the rows cut to their
    # first word (under 45 % full), and of a crafted stream whose fills tie
    # across every block of the plan; kernel vs plain
    most = fold_plan_check(clone_state(k_st), clone_state(k_st), "the main-path stream")
    with env_set(YTTM_TRAIN_FOLD_MIN="1"):
        check(not tk.fold_due(k_st, live), "the main-path stream calls for a fold")
        w2d = k_st.wid.reshape(-1, B)
        first = (w2d == w2d[:, :1]) & (k_st.tok.reshape(-1, B) >= 0)
        k_f = clone_state(k_st)
        k_f.tok = torch.where(first, k_st.tok.reshape(-1, B), -1).reshape(-1)
        k_f.wid = torch.where(first, w2d, -1).reshape(-1)
        k_f.ctl[tk.LIVE] = int((k_f.tok >= 0).sum())  # as a count would set it
        fold_plan_check(clone_state(k_f), clone_state(k_f), "the first-word rows")
        fold_check(k_f, "the first-word rows")
        ties = tie_fill_rows(B, dev)
        fold_plan_check(clone_state(ties), clone_state(ties), "the tied rows")
        fold_check(ties, "the tied rows")
    log(f"[6] fold_rows == plain: the plan (fills, the stable order == torch.sort(fills, "
        f"stable=True), FOLD_MAX) on the main-path stream (largest pair fill {most} of {B}; no "
        f"fold wanted at {live} live tokens), on the first-word rows and on {TIE_ROWS} rows whose "
        f"fills tie across the plan's blocks; the fold of both ({k_st.NB} -> {k_f.NB} rows)")
    return {"B": B}


# the fold's tied rows: fills from this set (ties across every block of the
# plan, and every pair of an emptiest and a fullest row fits), and the rows
TIE_FILLS, TIE_ROWS = (4, 16, 16, 30), 200_000


def tie_fill_rows(B: int, dev):
    """A tiered state of TIE_ROWS rows of B slots, each row one word of a
    fill from TIE_FILLS (random ids from 5), ctl[LIVE] set as a count
    would set it."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    rng = np.random.default_rng(11)
    fills = rng.choice(np.array(TIE_FILLS), TIE_ROWS)
    live = np.arange(B)[None, :] < fills[:, None]
    t = np.where(live, rng.integers(5, 55, (TIE_ROWS, B)), -1).astype(np.int32)
    wid = np.where(live, np.arange(TIE_ROWS)[:, None], -1).astype(np.int32)
    st = tk.TieredState(t.reshape(-1), wid.reshape(-1), np.ones(TIE_ROWS, np.int32),
                        np.full((64, 4), -1, np.int32), 60, B, 1 << 14, 1 << 12, dev)
    st.ctl[tk.LIVE] = int(live.sum())
    return st


def fold_plan_check(k_st, p_st, what: str) -> int:
    """The fold's plan, kernel (on k_st) vs plain (on p_st): fills, order
    and ctl; the order is torch.sort(fills, stable=True)'s.  Returns
    FOLD_MAX."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    fills, order = tk.fold_plan(k_st)
    p_fills, p_order = tk.fold_plan_plain(p_st)
    check(torch.equal(fills, p_fills), f"fold plan on {what}: fills differ")
    check(torch.equal(order, p_order), f"fold plan on {what}: orders differ")
    check(torch.equal(order.long(), torch.sort(fills, stable=True).indices),
          f"fold plan on {what}: the order is not torch.sort(fills, stable=True)'s")
    same_tiered(k_st, p_st, f"fold plan on {what}")
    return int(k_st.ctl[tk.FOLD_MAX])


def fold_check(st, what: str) -> None:
    """fold_rows (plan and fold) against fold_rows_plain on ``st``, which
    must fold."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    live = int(st.ctl[tk.LIVE])
    p_st = clone_state(st)
    check(tk.fold_rows(st, live), f"fold_rows did not fold {what}")
    check(tk.fold_rows_plain(p_st, live), f"fold_rows_plain did not fold {what}")
    same_tiered(st, p_st, f"fold_rows on {what}")
    check(int(st.ctl[tk.LIVE]) == int((st.tok >= 0).sum()), f"the fold of {what} changed LIVE")


# the resplit's crafted tables: (name, slots, live keys, count range, boundary,
# the top count the round claims: None for the true one)
RESPLIT_CASES = (
    ("one pass", 1 << 14, 5000, (1, 2000), 300, None),
    ("two passes", 1 << 14, 5000, (1, 1 << 20), 300, None),
    ("three passes", 1 << 14, 5000, (1, 1 << 30), 300, None),
    ("ties at T", 1 << 14, 5000, (7, 9), 1000, None),
    ("a top count below the table's", 1 << 14, 5000, (1, 1 << 20), 300, 50),
    ("fewer live keys, one pass", 1 << 14, 200, (1, 1500), 1000, None),
    ("fewer live keys, two passes", 1 << 14, 200, (1, 1 << 22), 1000, None),
    ("a list past its capacity", 1 << 14, 5000, (1, 1 << 20), 300, None),
    ("one key", 1 << 12, 1, (5, 5), 1, None),
    ("the full table's size", 1 << 23, 1_500_000, (1, 1 << 19), 32768, None),
)


def resplit_state(dev, cap: int, n_live: int, lo_hi, boundary: int, top, rng):
    """A tiered state whose full table holds ``n_live`` distinct keys at
    random slots with counts drawn from ``lo_hi`` (and count-0 slots), a
    hot table of 4 * boundary slots, and a round that refreshed and merged
    (the resplit is due), its first accepted count ``top``."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    t = np.array([5, 6, -1, -1, -1, -1, -1, -1], np.int32)
    hslots = max(1 << 10, 1 << int(np.ceil(np.log2(4 * boundary))))
    st = tk.TieredState(t, np.array([0, 0, -1, -1, -1, -1, -1, -1], np.int32),
                        np.ones(1, np.int32), np.full((8, 4), -1, np.int32), 100, 8, cap,
                        hslots, dev)
    slots = rng.choice(cap, size=min(cap // 2, n_live + n_live // 8), replace=False)
    keys = (rng.choice(1 << 24, size=slots.size, replace=False).astype(np.int64) << 32) | 7
    cnts = rng.integers(lo_hi[0], lo_hi[1] + 1, slots.size).astype(np.int32)
    cnts[n_live:] = 0  # claimed slots whose count fell to 0
    place(st.keys, st.cnts, keys, cnts, slots)
    st.ctl[tk.OCC] = slots.size
    st.ctl[tk.REFRESH] = 1
    st.ctl[tk.NACC] = 1
    st.cand[0, 3] = int(cnts.max()) if top is None else top
    # a stale hot table and T, which the resplit replaces
    st.hkeys[:4] = torch.arange(4, device=st.hkeys.device)
    st.hcnts[:4] = 1
    st.ctl[tk.THRESH] = 3
    return st


def phase_resplit_checks(dev) -> int:
    """The resplit kernel against its plain version on crafted tables: one,
    two and three passes, ties at T, a claimed top count below the table's
    (the pass that finds counts above it), fewer live keys than the
    boundary (T = 0) with one pass and with more, a list past its capacity
    (the table scanned again), one key, the full table's size; a round that
    needs no resplit (no refresh, no merge, an overflow) leaves the state as
    it was.  Each due run adds one to the kernel's count of runs and leaves
    its scratch zeroed.  Returns the cases checked."""
    import torch

    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    rng = np.random.default_rng(SEED + 4)
    for name, cap, n_live, lo_hi, boundary, top in RESPLIT_CASES:
        st = resplit_state(dev, cap, n_live, lo_hi, boundary, top, rng)
        if name == "a list past its capacity":  # OCC understated: the list is tried
            st.slots = st.slots[:3]
            st.ctl[tk.OCC] = 0
        plain = clone_state(st)
        runs = int(st.sel[tk.SEL_RUNS])
        tk.resplit(st, 2 * boundary)
        tk.resplit_plain(plain, boundary)
        same_tiered(st, plain, f"resplit, {name}")
        live = st.cnts[st.cnts > 0]
        T = int(st.ctl[tk.THRESH])
        want = tk.resplit_threshold(st.cnts, boundary)
        check(T == want, f"resplit, {name}: T {T} != {want}")
        check((T == 0) == (live.numel() < boundary), f"resplit, {name}: T {T}, {live.numel()} live")
        on_card = st.device.type == "cuda"
        check(int(st.sel[tk.SEL_RUNS]) == runs + on_card, f"resplit, {name}: runs not counted")
        rest = torch.ones(tk.SEL_N, dtype=torch.bool, device=st.sel.device)
        rest[[tk.SEL_GEN, tk.SEL_RUNS]] = False  # the barrier's generation, the runs
        check(not bool(st.sel[rest].any()), f"resplit, {name}: the scratch was not left zeroed")
        log(f"[6] resplit, {name}: {cap} slots, {live.numel()} live keys, boundary {boundary}: "
            f"T {T}, {int(st.ctl[tk.HOCC])} hot keys == plain")
    for what, slot, value in (("no refresh", tk.REFRESH, 0), ("no merge", tk.NACC, 0),
                              ("an overflow", tk.OVERFLOW, 1)):
        st = resplit_state(dev, 1 << 14, 5000, (1, 1 << 20), 300, None, rng)
        st.ctl[slot] = value
        before = clone_state(st)
        tk.resplit(st, 600)
        tk.resplit_plain(before, 300)
        same_tiered(st, before, f"resplit after {what}")
        check(torch.equal(st.hkeys, before.hkeys) and int(st.ctl[tk.THRESH]) == 3
              and int(st.sel[tk.SEL_RUNS]) == 0, f"resplit after {what} changed the state")
    log("[6] resplit after no refresh, no merge or an overflow: no run, the state unchanged")
    return len(RESPLIT_CASES) + 3


def tiered_full_table(plain):
    """The plain engine's exact full table, cold + pending: sorted (keys,
    counts) of the live pairs (numpy)."""
    import torch

    from youtokentome_tpu_torch.ops import train_delta as td

    keys = torch.cat([plain.ck, plain.qk])
    fk, fc, n = td._reduce_by_key(keys, torch.cat([plain.ccold, plain.qv]), keys.shape[0])
    return fk[:n].cpu().numpy(), fc[:n].cpu().numpy()


def same_routes(a, b, what: str) -> None:
    """Two kernel engines' states after the same rounds, one through the
    round graph and one through the per-call wrappers: stream, signatures,
    ctl (T among it), both tables as multisets, rules and the resplit's
    runs on the card."""
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    same_tiered(a, b, what)
    check(int(a.sel[tk.SEL_RUNS]) == int(b.sel[tk.SEL_RUNS]),
          f"{what}: resplit runs {int(a.sel[tk.SEL_RUNS])} != {int(b.sel[tk.SEL_RUNS])}")


def phase_tiered_mid(mid_path: Path, dev) -> dict:
    """The 10 MB prefix at vocab 8000 through the tiered kernel engine (the
    round graph), the same engine through the per-call wrappers, and the
    plain tiered round loop, all on the card, in lockstep, with a hot tier
    of 1024 (refresh rounds), a pcap of 1024 (rebuilds) and folds from 64
    rows: the two kernel routes' states equal after every segment
    (``same_routes``: stream, signatures, ctl with T, both tables, rules,
    resplit runs); stream, signatures, the live full table and rules equal
    to the plain loop's; the kernel engine's hot tier exact
    (``check_hot_tier``) wherever it has not overflowed; and in both
    routes the kept live count equal to the stream's live tokens at every
    segment end, the fold's plan run exactly where ``fold_wanted`` holds
    (``FoldEnds``)."""
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
        calls = tk.TieredKernelEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, B, dev)
        calls.graph = False
        plain = tt.PlainTieredEngine(t, wid, freq, rules, used0, MID_VOCAB, 16, B, dev)
        used, segs, refresh, nb0, hot_ends = used0, 0, 0, kern.st.NB, 0
        k_ends, c_ends = FoldEnds(), FoldEnds()
        while used < MID_VOCAB:
            limit = min(MID_VOCAB, used + TRAIN_SEG)
            with swapped(tk, fold_rows=k_ends):
                ku, kd = complete_segment(kern, used, limit)
            refresh += kern.stats[1]
            with swapped(tk, fold_rows=c_ends):
                cu, cd = complete_segment(calls, used, limit)
            pu, pd = complete_segment(plain, used, limit)
            what = f"segment to {limit}"
            check((ku, kd) == (cu, cd) == (pu, pd),
                  f"{what}: graph {ku, kd}, per call {cu, cd}, plain {pu, pd}")
            check(kern.stats == calls.stats, f"{what}: stats {kern.stats} != {calls.stats}")
            same_routes(kern.st, calls.st, what)
            st = kern.st
            check(int(st.ctl[tk.LIVE]) == int((st.tok >= 0).sum()),
                  f"{what}: ctl[LIVE] != the stream's live tokens")
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
    check(k_ends.log == c_ends.log, "the two kernel routes' fold plans differ")
    check(refresh >= 2, "the tiered mid-size run refreshed no more than once")
    check(hot_ends >= 1, "no segment of the tiered mid-size run ended with a hot tier above T > 0")
    runs = int(kern.st.sel[tk.SEL_RUNS]) if kern.st.device.type == "cuda" else None
    check(runs is None or runs >= 2, f"the tiered mid-size run resplit {runs} times")
    log(f"[6] mid-size tiered: vocab {MID_VOCAB}, B {B}: the round graph == the per-call "
        f"route (stream, signatures, ctl and T, both tables, rules, {runs} resplit runs) == "
        f"plain tiered round loop at all {segs} segment ends (stream, signatures, live full "
        f"table, rules); hot counts == full counts and every key above T hot ({hot_ends} ends "
        f"with T > 0); {refresh} refresh rounds, {kern.rebuilds} table rebuilds, {kern.folds} "
        f"folds ({nb0} -> {kern.st.NB} rows); {k_ends.summary()} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"segments": segs, "refresh": refresh, "rebuilds": kern.rebuilds, "folds": kern.folds}


def run_tiered(eng, vocab: int, used: int) -> int:
    """run_training_tiered's loop over segments of TRAIN_SEG ids."""
    while used < vocab:
        used, done = complete_segment(eng, used, min(vocab, used + TRAIN_SEG))
        check(int(eng.st.cnts.min()) >= 0, "a negative pair count")
        if done:
            break
    return used


class FoldEnds:
    """``tiered_kernels.fold_rows`` for a run, swapped in under its name:
    at each segment end it checks that the live count the engine kept on
    the card (``ctl[LIVE]``, passed as ``live``) equals the stream's live
    tokens, and that the fold's plan runs exactly where ``fold_due`` holds
    (on the card, by its launch count, which the real wrapper adds under
    this name); ``log`` keeps (slots, rows, plan due, folded) of each end,
    and ``on_plan(st)`` is called before each plan."""

    def __init__(self, on_plan=None):
        from youtokentome_tpu_torch.ops import tiered_kernels as tk

        self.tk, self.real, self.on_plan = tk, tk.fold_rows, on_plan
        self.launches = 0
        self.log = []

    def __call__(self, st, live: int) -> bool:
        tk = self.tk
        n_live = int((st.tok >= 0).sum())
        end = len(self.log)
        check(live == int(st.ctl[tk.LIVE]) == n_live,
              f"segment end {end}: ctl[LIVE] {live} != the stream's {n_live} live tokens")
        due = tk.fold_due(st, live)
        if due and self.on_plan:
            self.on_plan(st)
        m, NB, before = st.NB * st.B, st.NB, self.launches
        folded = self.real(st, live)
        if st.device.type == "cuda":
            check(self.launches - before == int(due),
                  f"segment end {end}: the plan launched {self.launches - before} times, "
                  f"fold_due {due}")
        self.log.append((m, NB, due, folded))
        return folded

    def summary(self) -> str:
        plans = sum(d for _, _, d, _ in self.log)
        folds = sum(f for _, _, _, f in self.log)
        return (f"ctl[LIVE] == the stream's live tokens at all {len(self.log)} segment ends; the "
                f"fold's plan ran at the {plans} where fold_wanted held, {folds} folds")


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
                    read and written; the live count, 4 B for each block of
                    the launch (the tokens its merges removed, sent in the
                    high word of its ticket)
      tier_count    apply_blocks's count mode (the start and each rebuild:
                    tier_count_kernel): every slot's token and word id read,
                    every word's weight, every row's signature and the
                    filled slots written; its device ms by CUDA events
                    around each count (``count_ms``, ``counts``)
      resplit       the full table's counts, the keys above T read and
                    written into the hot table, the hot table cleared
      fold_rows     a plan, at the segment ends where it runs (fold_due): the
                    stream's tokens, fills and order; a fold: the stream
                    read, half of it and its signatures written

    The engine takes the per-call route (the round graph would bypass the
    wrapped wrappers; both routes run the same kernels on the same rounds).
    Returns the engine, each kernel's bytes and operations, and the counts
    of rounds, refresh rounds and rounds where a resplit was due, with the
    resplit's device ms over those (CUDA events), with
    library_topk_ms summed over the hot tables before each tier_select,
    library_kth_ms over the live counts of each due round and
    library_sort_ms over the fills of each plan that runs; the live
    counter's bytes (``live_bytes``, in apply_blocks') and the FoldEnds of
    the run."""
    import torch

    from youtokentome_tpu_torch.ops import _cuda
    from youtokentome_tpu_torch.ops import tiered_kernels as tk

    w = {name: 0 for name in TIERED_KERNELS + ("tier_count",)}
    ops = {name: 0 for name in TIERED_KERNELS + ("tier_count",)}
    n = {"rounds": 0, "refresh": 0, "due": 0, "library_ms": 0.0, "split_library_ms": 0.0,
         "split_ms": 0.0, "sort_library_ms": 0.0, "live_bytes": 0, "split_runs": [],
         "counts": 0, "count_ms": 0.0}
    grids = {}

    def apply_grid(st) -> int:
        if st.device.type != "cuda":
            return 1
        if st.B not in grids:
            with torch.cuda.device(st.device):
                grids[st.B] = _cuda.load_tiered().yttm_tiered_apply_grid(st.B)
            check(grids[st.B] > 0, f"apply grid for B {st.B}: error {-grids[st.B]}")
        return grids[st.B]
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
            # the count's device ms by CUDA events, a sleep kernel ahead so
            # that the host's enqueue is not timed
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
            a.record()
            real["apply_blocks"](st, kb1, kb2, count_mode)
            b.record()
            b.synchronize()
            n["count_ms"] += a.elapsed_time(b)
            n["counts"] += 1
            w["tier_count"] += (st.tok.numel() * 8 + st.freq.numel() * 4 + st.NB * 64
                                + int(st.ctl[tk.OCC]) * 12)
            ops["tier_count"] += int((st.tok >= 0).sum()) * OPS_PER_ROWPOS
            return
        cnts, hcnts = st.cnts.clone(), st.hcnts.clone()
        real["apply_blocks"](st, kb1, kb2)
        if int(st.ctl[tk.NACC]):
            n_rows = int(st.ctl[tk.NBAFF])
            changed = int((st.cnts != cnts).sum()) + int((st.hcnts != hcnts).sum())
            live_bytes = 4 * apply_grid(st)
            n["live_bytes"] += live_bytes
            w["apply_blocks"] += (st.NB * 64 + n_rows * (st.B * 16 + 64) + changed * 16
                                  + live_bytes)
            ops["apply_blocks"] += st.NB * OPS_PER_ROW + n_rows * st.B * OPS_PER_ROWPOS

    def split(st, hcap):
        refresh, n_acc, overflow = (int(v) for v in st.ctl[[tk.REFRESH, tk.NACC, tk.OVERFLOW]].tolist())
        if not (refresh and n_acc and not overflow):
            return real["resplit"](st, hcap)
        # the kernel's device ms by CUDA events, a sleep kernel ahead so that
        # the host's enqueue is not timed
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        a.record()
        real["resplit"](st, hcap)
        b.record()
        b.synchronize()
        n["split_ms"] += a.elapsed_time(b)
        n["split_runs"].append((int(st.ctl[tk.USED]), a.elapsed_time(b)))
        n["due"] += 1
        n["split_library_ms"] += library_kth_ms(st.cnts, hcap // 2)
        w["resplit"] += st.cap * 4 + int(st.ctl[tk.HOCC]) * 24 + st.hslots * 12
        ops["resplit"] += st.cap * 10

    def on_plan(st):
        fills = (st.tok.reshape(-1, st.B) >= 0).sum(1).to(torch.int32)
        n["sort_library_ms"] += library_sort_ms(fills)

    fold = FoldEnds(on_plan)
    for f in (select, apply, split):
        f.launches = 0  # the real wrappers count their launches under these names
    with swapped(tk, tier_select=select, apply_blocks=apply, resplit=split, fold_rows=fold):
        eng = engine()
        eng.graph = False
        run_tiered(eng, vocab, eng.used_ids0)
    for m, NB, due, folded in fold.log:
        if due:
            w["fold_rows"] += m * 4 + NB * 8
            ops["fold_rows"] += m * 2
        if folded:
            w["fold_rows"] += m * 8 + m // 2 * 8 + NB // 2 * 64
            ops["fold_rows"] += m * 2
    n["fold_ends"] = fold
    return eng, w, ops, n


def library_sort_ms(fills) -> float:
    """The library yardstick of the fold's plan, for the order only: ms of
    one ``torch.sort(fills, stable=True)`` (CUDA events) of the rows'
    fills (computed before the timed window).  It gives neither the pair
    check nor the fold; the port never calls it."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.sort(fills, stable=True)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def library_kth_ms(cnts, boundary: int) -> float:
    """The library yardstick of the resplit's select step: ms of one
    ``torch.kthvalue`` (CUDA events) of the table's live counts (taken out
    of the table before the timed window) for the boundary-th largest; 0
    with fewer live counts (T is then 0).  It finds T only, without the hot
    table; the port never calls it."""
    import torch

    live = cnts[cnts > 0]
    if live.numel() < boundary:
        return 0.0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.kthvalue(live, live.numel() - boundary + 1)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


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
    log(f"[6] merge loop (tiered kernels, the round graph): {loop_s:.3f} s, {rounds} rounds, "
        f"{eng.folds} folds ({nb0} -> {st.NB} rows of {B}), {eng.rebuilds} table rebuilds, "
        f"{merges} merges, {merges / loop_s:.0f} merges/s")
    # the same loop through the per-call wrappers (resplit's on every round)
    c_eng = engine()
    c_eng.graph = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_tiered(c_eng, TRAIN_VOCAB, used0)
    torch.cuda.synchronize()
    calls_s = time.perf_counter() - t0
    check(torch.equal(c_eng.rules, st.rules), "the per-call route's rules differ")
    log(f"[6] merge loop through the per-call wrappers: {calls_s:.3f} s (the round graph: "
        f"{loop_s:.3f} s)")
    t0 = time.perf_counter()
    w_eng, wbytes, wops, counts = run_tiered_work(engine, TRAIN_VOCAB)
    check(torch.equal(w_eng.rules, st.rules) and counts["rounds"] == rounds
          and w_eng.folds == eng.folds, "the round-by-round tiered run differs from the main path's")
    refresh = counts["refresh"]
    check(launches["resplit"] == counts["due"] == int(st.sel[tk.SEL_RUNS]),
          f"resplit ran {launches['resplit']} times on the main path ({int(st.sel[tk.SEL_RUNS])} "
          f"in the timed run), but {counts['due']} rounds were due")
    ends = counts["fold_ends"]
    check(sum(d for _, _, d, _ in ends.log) == launches["fold_rows"],
          f"the main path planned {launches['fold_rows']} folds, the round-by-round run "
          f"{sum(d for _, _, d, _ in ends.log)}")
    log(f"[6] the run's work, one round at a time ({time.perf_counter() - t0:.1f} s): "
        f"{refresh} refresh rounds, {counts['due']} due a resplit (the kernel's runs on the card: "
        f"{launches['resplit']} on the main path); bytes {wbytes} (the live counter's "
        f"{counts['live_bytes']} of apply_blocks'), operations {wops}")
    log(f"[6] fold_rows, the per-call route: {ends.summary()}")

    torch.cuda.synchronize()
    graph_ends = FoldEnds()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, swapped(tk, fold_rows=graph_ends):
        run_tiered(engine(), TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
    check([e[2:] for e in graph_ends.log] == [e[2:] for e in ends.log],
          "the round graph's fold plans differ from the per-call route's")
    log(f"[6] fold_rows, the round graph (profiled run): {graph_ends.summary()}")
    dev_us = {name: 0.0 for name in TIERED_KERNELS}
    fn_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name, fns in TIERED_DEVICE_FNS.items():
            for f in fns:
                if f in ev.key:
                    dev_us[name] += us
                    fn_us[f] = (us, ev.count)
        if "tier_count_kernel" in ev.key:  # tier_count's row is timed by CUDA events
            fn_us["tier_count_kernel"] = (us, ev.count)
    log("[6] device functions: " + ", ".join(
        f"{f} {us / 1e3:.3f} ms / {n} calls" for f, (us, n) in sorted(fn_us.items())))
    log(f"[6] apply_blocks, first {SPLIT_ROUNDS} launches / the rest, ms: " + ", ".join(
        f"{f} {a:.3f} / {b:.3f}" for f, (a, b) in sorted(first_rest_ms(
            prof, TIERED_DEVICE_FNS["apply_blocks"]).items())))
    # the resplit's device ms by CUDA events at its due launches
    # (run_tiered_work): late in this script the profiler has missed some
    # of the cooperative resplit kernel's records (16 and 20 of 49 runs in
    # the round graph, 4 of 3,247 launches of the per-call route), though
    # it held all of them in shorter processes and every other kernel's
    n_split = fn_us.get("resplit_kernel", (0, 0))[1]
    check(n_split <= counts["due"],
          f"the profiler recorded {n_split} resplit runs, {counts['due']} rounds were due")
    dev_us["resplit"] = counts["split_ms"] * 1e3
    log(f"[6] resplit: {counts['split_ms']:.3f} ms over its {counts['due']} runs (CUDA events); "
        f"the profiler recorded {n_split} of them ({fn_us.get('resplit_kernel', (0, 0))[0] / 1e3:.3f} "
        f"ms)")
    kernel_ms = {name: dev_us[name] / 1e3 for name in TIERED_KERNELS}
    for name, v in kernel_ms.items():
        check(v > 0, f"the profiler recorded no device time for {name}")

    plain_ms = {name: 0.0 for name in TIERED_KERNELS + ("tier_count",)}

    def timed_plain(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            plain_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        run.launches = 0  # the engine counts the card's resplit runs under this name
        return run

    def apply_plain(st, kb1=0, kb2=0, count_mode=False):
        if count_mode:  # its own row's, timed apart below
            plain_tiered_count(st)
        else:
            timed_plain("apply_blocks", tk.apply_blocks_plain)(st, False, kb1, kb2)

    apply_plain.launches = 0

    # the round's kernels over the run's first TRAIN_PLAIN_IDS ids (beside
    # their device ms over the same ids: the resplit's by CUDA events at its
    # due runs there); the fold, at segment ends, over the whole run, the
    # rounds on the card
    plain_vocab = used0 + TRAIN_PLAIN_IDS
    with swapped(
        tk,
        tier_select=timed_plain(
            "tier_select", lambda st, limit, v, u0, k=16: tk.tier_select_plain(st, limit, v, u0, k)),
        apply_blocks=apply_plain,
        resplit=timed_plain("resplit", lambda st, hcap: tk.resplit_plain(st, hcap // 2)),
    ):
        p_eng = engine()
        p_eng.graph = False
        run_tiered(p_eng, plain_vocab, used0)
    check(torch.equal(p_eng.rules[:TRAIN_PLAIN_IDS], st.rules[:TRAIN_PLAIN_IDS]),
          "the tiered plain versions' rules differ")
    with swapped(tk, fold_rows=timed_plain("fold_rows", tk.fold_rows_plain)):
        p_eng = engine()
        run_tiered(p_eng, TRAIN_VOCAB, used0)
    check(torch.equal(p_eng.rules, st.rules), "the plain fold's rules differ")
    # the count's plain version on the main path's first stream, apart: its
    # table's slots lie where a plain insert puts them, which the kernels'
    # rounds do not read
    timed_plain("tier_count", plain_tiered_count)(engine().st)
    plain_ms["tier_count"] *= counts["counts"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_tiered(engine(), plain_vocab, used0)
        torch.cuda.synchronize()
    prefix_ms = {name: profiled_ms(prof, TIERED_DEVICE_FNS[name])
                 for name in TIERED_ROUND_KERNELS if name != "resplit"}
    prefix_ms["resplit"] = sum(ms for used, ms in counts["split_runs"] if used <= plain_vocab)
    log(f"[6] plain versions (synchronised calls), {', '.join(TIERED_ROUND_KERNELS)} over the "
        f"first {TRAIN_PLAIN_IDS} ids (the kernels' ms there: "
        + ", ".join(f"{k} {v:.3f}" for k, v in prefix_ms.items()) + "), fold_rows over the run, "
        "tier_count a count of the main path's stream times the run's counts: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))

    # the count has its own row: its launches come out of apply_blocks's
    launches["tier_count"] = counts["counts"]
    launches["apply_blocks"] -= counts["counts"]
    kernel_ms["tier_count"] = counts["count_ms"]
    log(f"[6] tier_count: {counts['counts']} counts, {counts['count_ms']:.3f} ms (CUDA events; "
        f"the profiler's tier_count_kernel: {fn_us.get('tier_count_kernel', (0, 0))[0] / 1e3:.3f} "
        f"ms / {fn_us.get('tier_count_kernel', (0, 0))[1]} calls)")
    check(counts["counts"] > 0 and counts["count_ms"] > 0, "tier_count was not timed")
    rows = []
    for name in TIERED_KERNELS + ("tier_count",):
        b_ms = wbytes[name] / HBM_BYTES_PER_S * 1e3
        o_ms = wops[name] / OPS_PER_S * 1e3
        rows.append({"name": name, "launches": launches[name], "ms": kernel_ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "library_ms": {"tier_select": counts["library_ms"],
                                    "resplit": counts["split_library_ms"],
                                    "fold_rows": counts["sort_library_ms"]}.get(name),
                     **prefix_of(name, prefix_ms, TRAIN_PLAIN_IDS)})
        lib_ms = rows[-1]["library_ms"]
        log(f"[6] {name}: {launches[name]} launches, {kernel_ms[name]:.3f} ms on the card, "
            f"bound {max(b_ms, o_ms):.4f} ms ({rows[-1]['bound_by']}; bytes {wbytes[name]}), "
            f"plain {plain_ms[name]:.1f} ms" + plain_span(rows[-1])
            + (f", library {lib_ms:.3f} ms" if lib_ms is not None else ""))
    log(f"[6] times: BPE.train {train_s:.2f} s, merge loop {loop_s:.3f} s (per-call route "
        f"{calls_s:.3f} s), {rounds} rounds, {refresh} refresh rounds, {counts['due']} resplits, "
        f"{eng.folds} folds, {merges / loop_s:.0f} merges/s")
    return {"rows": rows}


def compare_tree(work: Path, parts=("train", "sharded", "recount", "v4")) -> dict:
    """The numbers the training kernels' redesigns are held to, for the
    package of the current directory's tree (run it in the parent's
    unpacked tree and in the change's, in turns, from one process each,
    loading this file by its path): ``BPE.train`` twice, split
    (``train_split``), v5's merge loop three times by the host clock, one
    profiled v5 loop (device ms and launches of every function: the fold's
    and the applies' among them) and one profiled v2 loop (the count's);
    phase 10's sharded v2 loop (4 shards on the card) twice by the host
    clock, then once traced (each wrapper's device ms and launches: the
    fold's and the recount's among them), and the sharded v3 loop
    (``compare_v3``); the trainers that recount every round: v1's loop and
    the sharded v1 loop (4 shards) to vocab 30000 and v0's and the sharded
    v0 loop to their first V0_MAIN_IDS ids, each twice by the host clock, then once
    traced (each wrapper's device ms and launches, the count's, the
    fold's and the apply's device functions by name, in either tree); v4's
    loop (``compare_v4``).  ``parts`` picks the sections: "train" (the first
    five), "sharded" (the sharded v2 and v3 loops), "recount" (the
    recounting trainers), "v4".  The corpus is written
    to ``work`` by the first caller and read by the others.  Prints and
    returns the numbers."""
    work.mkdir(parents=True, exist_ok=True)
    corpus_path = work / "corpus_100mb.txt"
    if not corpus_path.exists():
        corpus_path.write_text("\n".join(build_corpus()[1]) + "\n")
    out = {"tree": os.getcwd(), "card": card_line()}
    buckets, _, used0 = training_buckets(corpus_path)
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
    if "train" in parts:
        out.update(compare_train(corpus_path, work, buckets, used0, rules))
    if "sharded" in parts:
        out.update(compare_sharded(buckets, used0))
    if "recount" in parts:
        out.update(compare_recount(buckets, used0))
    if "v4" in parts:
        out.update(compare_v4(buckets, used0))
    print("COMPARE " + json.dumps(out), flush=True)
    return out


def compare_train(corpus_path: Path, work: Path, buckets, used0: int, rules) -> dict:
    """compare_tree's "train" section."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from youtokentome_tpu_torch.ops import tiered_kernels as tk
    from youtokentome_tpu_torch.ops import train_kernels as v2
    from youtokentome_tpu_torch.ops import train_stream as ts

    dev = torch.device("cuda", 0)
    out = {"train_split": [train_split(corpus_path, work / f"cmp{i}.yttm")[1] for i in range(2)]}
    t, wid, freq, B = tiered_inputs(buckets)

    def engine():
        return tk.TieredKernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB, 16, B, dev)

    loops = []
    for _ in range(3):
        eng = engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_tiered(eng, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
    out["loop_s"] = loops
    out["rounds"], out["folds"] = int(eng.st.ctl[tk.ROUND]), eng.folds

    def device_fns(prof) -> dict:
        fns = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if us:
                fns[ev.key[:60]] = (round(us / 1e3, 4), ev.count)
        return fns

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_tiered(engine(), TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
    out["v5_device_fns"] = device_fns(prof)
    t2, w2, f2 = ts.flatten_word_buckets(buckets)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng = v2.KernelEngine(t2, w2, f2, rules, used0, TRAIN_VOCAB, 16, dev)
        run_engine(eng, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
    out["v2_device_fns"] = device_fns(prof)
    sums = {"fold_rows": ("fold_",), "apply_blocks": ("tier_find", "tier_apply", "tier_count"),
            "pair_count": ("pair_count",)}
    fns = {**out["v5_device_fns"], **out["v2_device_fns"]}
    out["rows_ms"] = {
        name: round(sum(ms for k, (ms, _) in fns.items() if any(p in k for p in keys)), 4)
        for name, keys in sums.items()}
    return out


def compare_sharded(buckets, used0: int) -> dict:
    """compare_tree's "sharded" section."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as v2

    out = {}
    loops = []
    for _ in range(2):
        eng = shard_engine(buckets, used0, TRAIN_VOCAB)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, nrec = run_shards(eng, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
    out["shard_loop_s"], out["shard_recounts"] = loops, nrec
    out["shard_rounds"] = int(eng.shards[0].ctl[v2.ROUND])
    wrappers = {"topk_accept": v2.topk_accept, **{k: getattr(dsk, k) for k in SHARD_KERNELS}}
    for w in wrappers.values():
        w.launches = 0
    with Tracer() as tr:
        t0 = time.perf_counter()
        run_shards(shard_engine(buckets, used0, TRAIN_VOCAB), TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        out["shard_traced_s"] = time.perf_counter() - t0
    out["shard_ms"] = {k: round(v, 4) for k, v in tr.ms(COMPARE_SHARD_FNS).items()}
    # the fold's and the recount's device functions one by one
    out["shard_fns"] = tr.ms({f: (f,) for k in ("shard_fold", "shard_recount")
                              for f in COMPARE_SHARD_FNS[k]})
    out["shard_launches"] = {k: w.launches for k, w in wrappers.items()}
    out.update(compare_v3(buckets, used0))
    return out


def compare_recount(buckets, used0: int) -> dict:
    """compare_tree's "recount" section."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as v2
    from youtokentome_tpu_torch.ops import train_stream as ts

    dev = torch.device("cuda", 0)
    out = {}
    v0_vocab = min(TRAIN_VOCAB, used0 + V0_MAIN_IDS)
    runs = {
        "v1": (lambda: diff_engine("stream", buckets, used0, TRAIN_VOCAB, dev),
               lambda e: run_diff(e, TRAIN_VOCAB, used0),
               {k: DIFF_DEVICE_FNS[("stream", k)] for k in DIFF_KERNELS["stream"]}),
        "v0": (lambda: diff_engine("bucketed", buckets, used0, v0_vocab, dev),
               lambda e: run_diff(e, v0_vocab, used0),
               {k: DIFF_DEVICE_FNS[("bucketed", k)] for k in DIFF_KERNELS["bucketed"]}),
        "sharded_v1": (lambda: other_engine("stream", buckets, used0, TRAIN_VOCAB),
                       lambda e: ts.run_to_end(e, used0, TRAIN_VOCAB),
                       {k: OTHER_DEVICE_FNS[k] for k in OTHER_KERNELS["stream"]}),
        "sharded_v0": (lambda: other_engine("bucketed", buckets, used0, v0_vocab),
                       lambda e: ts.run_to_end(e, used0, v0_vocab),
                       {k: OTHER_DEVICE_FNS[k] for k in OTHER_KERNELS["bucketed"]}),
    }
    for name, (engine, run, fns) in runs.items():
        fns = {k: fns[k] + COMPARE_RECOUNT_FNS.get(k, ()) for k in fns}
        wrappers = {k: (diff_wrapper(diff_module({"v1": "stream", "v0": "bucketed"}[name]), k)
                        if name in ("v1", "v0")
                        else other_wrapper("bucketed" if name == "sharded_v0" else "stream", k)[1])
                    for k in fns}
        loops = []
        for _ in range(2):
            e = engine()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(e)
            torch.cuda.synchronize()
            loops.append(round(time.perf_counter() - t0, 4))
        head = e.st if name in ("v1", "v0") else e.shards[0]
        out[f"{name}_loop_s"] = loops
        out[f"{name}_rounds"], out[f"{name}_cap"] = int(head.ctl[v2.ROUND]), head.cap
        out[f"{name}_rules"] = int(torch.sum(e.rules[:, 0] >= 0))
        for w in wrappers.values():
            w.launches = 0
        with Tracer() as tr:
            run(engine())
        out[f"{name}_ms"] = {k: round(v, 4) for k, v in tr.ms(fns).items()}
        out[f"{name}_fns"] = {f: round(v, 4) for f, v in tr.ms(
            {f: (f,) for k in fns if k != "topk_accept" for f in fns[k]}).items() if v}
        out[f"{name}_launches"] = {k: w.launches for k, w in wrappers.items()}
    return out


def launch_split(records, n_top: int) -> dict:
    """The launches of a traced kernel (Tracer records) by device time: the
    ms of the n_top longest, and the rest's ms and 10th, 50th and 90th
    percentile us."""
    us = np.sort(np.array([ns for _, ns in records], np.float64))[::-1] / 1e3
    rest = us[n_top:]
    return {"n": int(us.size), "top_ms": round(float(us[:n_top].sum()) / 1e3, 4),
            "rest_ms": round(float(rest.sum()) / 1e3, 4),
            "rest_us_p10_50_90": [round(float(np.percentile(rest, q)), 2) for q in (10, 50, 90)]
            if rest.size else []}


def compare_v4(buckets, used0: int) -> dict:
    """compare_tree's "v4" section: v4's merge loop to vocab 30000 twice by
    the host clock, then once traced: each wrapper's device ms and launches
    and block_apply's device functions by name, in either tree
    (COMPARE_V4_FNS); the rounds, and the block-path rows and full-path
    rounds of the last timed run."""
    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    dev = torch.device("cuda", 0)
    mod = diff_module("block")
    loops = []
    for _ in range(2):
        e = diff_engine("block", buckets, used0, TRAIN_VOCAB, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_diff(e, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        loops.append(round(time.perf_counter() - t0, 4))
    out = {"v4_loop_s": loops, "v4_rounds": int(e.st.ctl[tk.ROUND]),
           "v4_rules": int(torch.sum(e.rules[:, 0] >= 0)),
           "v4_rows_full": [int(e.st.work[mod.W_ROWS]), int(e.st.work[mod.W_FULL])],
           "v4_work": e.st.work.tolist()}
    wrappers = {k: diff_wrapper(mod, k) for k in DIFF_KERNELS["block"]}
    for w in wrappers.values():
        w.launches = 0
    with Tracer(keep=("flag_rows_kernel", "apply_rows_kernel")) as tr:
        run_diff(diff_engine("block", buckets, used0, TRAIN_VOCAB, dev), TRAIN_VOCAB, used0)
    # the launches by their device time: the longest as many as the
    # full-path rounds, and the rest
    out["v4_split"] = {f: launch_split(tr.records.get(f, []), out["v4_rows_full"][1])
                       for f in ("flag_rows_kernel", "apply_rows_kernel")}
    out["v4_ms"] = {k: round(v, 4) for k, v in tr.ms(COMPARE_V4_FNS).items()}
    out["v4_fns"] = {f: round(v, 4) for f, v in tr.ms(
        {f: (f,) for f in COMPARE_V4_FNS["block_apply"]}).items() if v}
    out["v4_records"] = {f: int(v) for f, v in tr.ms(
        {f: (f,) for f in COMPARE_V4_FNS["block_apply"]}, counts=True).items() if v}
    out["v4_launches"] = {k: w.launches for k, w in wrappers.items()}
    return out


def compare_emit(work: Path) -> dict:
    """The numbers sharded v2's per-card emit and the flat relays are held
    to, for the package of the current directory's tree (run it in the
    parent's unpacked tree and in the change's, in turns, from one process
    each, loading this file by its path): the 100 MB sharded v2 loop (4
    shards on the card, the round graph) twice by the host clock, then once
    traced: each wrapper's device ms and launches (the emit's device
    functions in either tree), the relay's device functions by name, and
    the emit's launches in order (the first SPLIT_ROUNDS rounds' ms, the
    rest's, and the rest's 10th, 50th and 90th percentile us a round); the
    one-device v2 loop traced (its relay's functions).  Prints one
    ``COMPARE_EMIT {json}`` line and returns it."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.ops import train_stream as ts

    work.mkdir(parents=True, exist_ok=True)
    corpus_path = work / "corpus_100mb.txt"
    if not corpus_path.exists():
        corpus_path.write_text("\n".join(build_corpus()[1]) + "\n")
    out = {"tree": os.getcwd(), "card": card_line()}
    buckets, _, used0 = training_buckets(corpus_path)
    run_shards(shard_engine(buckets, used0, used0 + SHARD_PLAIN_IDS), used0 + SHARD_PLAIN_IDS,
               used0)  # builds the kernels outside the timed loops
    loops = []
    for _ in range(2):
        eng = shard_engine(buckets, used0, TRAIN_VOCAB)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, nrec = run_shards(eng, TRAIN_VOCAB, used0)
        torch.cuda.synchronize()
        loops.append(round(time.perf_counter() - t0, 4))
    out.update(shard_loop_s=loops, recounts=nrec, rebuilds=eng.rebuilds, relays=eng.relays,
               rounds=int(eng.shards[0].ctl[tk.ROUND]))
    wrappers = {"topk_accept": tk.topk_accept, **{k: getattr(dsk, k) for k in SHARD_KERNELS}}
    for w in wrappers.values():
        w.launches = 0
    relay_fns = {f: (f,) for f in TRAIN_DEVICE_FNS["relay"]}
    with Tracer(keep=SHARD_DEVICE_FNS["delta_emit"]) as tr:
        run_shards(shard_engine(buckets, used0, TRAIN_VOCAB), TRAIN_VOCAB, used0)
    out["shard_ms"] = {k: round(v, 4) for k, v in tr.ms(
        {**COMPARE_SHARD_FNS, "shard_relay": SHARD_DEVICE_FNS["shard_relay"], **relay_fns}).items()}
    out["shard_launches"] = {k: w.launches for k, w in wrappers.items()}
    recs = tr.records.get(SHARD_DEVICE_FNS["delta_emit"][0])
    if recs:  # the per-card emit: one launch a round
        per = np.array([ns for _, ns in sorted(recs)]) / 1e3
        rest = per[SPLIT_ROUNDS:]
        out["emit_rounds"] = {
            "first_ms": round(float(per[:SPLIT_ROUNDS].sum()) / 1e3, 4),
            "rest_ms": round(float(rest.sum()) / 1e3, 4),
            "rest_us_p10_50_90": [round(float(np.percentile(rest, q)), 2) for q in (10, 50, 90)]}
    t, wid, freq = ts.flatten_word_buckets(buckets)
    rules = np.full((TRAIN_VOCAB, 4), -1, np.int32)
    ms, _, _ = traced(lambda: run_engine(tk.KernelEngine(t, wid, freq, rules, used0, TRAIN_VOCAB,
                                                         16, torch.device("cuda", 0)),
                                         TRAIN_VOCAB, used0), dict(TRAIN_DEVICE_FNS, **relay_fns))
    out["v2_ms"] = {k: round(v, 4) for k, v in ms.items()}
    print("COMPARE_EMIT " + json.dumps(out), flush=True)
    return out


def compare_v3(buckets, used0: int) -> dict:
    """compare_tree's v3 numbers: the sharded v3 loop (4 shards on the card,
    the engine's own route) twice by the host clock, then once traced (each
    wrapper's device ms and launches, every device function of the recount
    and the fold by name, in either tree); its recount by CUDA events where
    it counts (``sparse_recount_events``, the per-call route); the
    one-device v3 run's count by CUDA events around each call of its
    wrapper (the wrapper's table reset inside them, done once before them
    too, so that it runs on a table it already emptied)."""
    import torch

    from youtokentome_tpu_torch.ops import sparse_kernels as spk
    from youtokentome_tpu_torch.ops import train_stream as ts

    out = {}
    loops = []
    for _ in range(2):
        e = other_engine("sparse", buckets, used0, TRAIN_VOCAB)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.run_to_end(e, used0, TRAIN_VOCAB)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
    out["v3_loop_s"], out["v3_graph"] = loops, bool(getattr(e, "graph", False))
    wrappers = {k: other_wrapper("sparse", k)[1] for k in OTHER_KERNELS["sparse"]}
    for w in wrappers.values():
        w.launches = 0
    with Tracer(keep=("sparse_emit_kernel",)) as tr:
        t0 = time.perf_counter()
        ts.run_to_end(other_engine("sparse", buckets, used0, TRAIN_VOCAB), used0, TRAIN_VOCAB)
        torch.cuda.synchronize()
        out["v3_traced_s"] = time.perf_counter() - t0
    if "sparse_emit_kernel" in tr.records:  # the one launch a round: its rounds by device time
        out["v3_emit_split"] = launch_split(tr.records["sparse_emit_kernel"], 0)
    out["v3_ms"] = {k: round(v, 4) for k, v in tr.ms(COMPARE_V3_FNS).items()}
    out["v3_fold_ms"] = out["v3_ms"]["shard_fold"]
    out["v3_fns"] = tr.ms({f: (f,) for k in ("shard_fold", "sparse_shard_recount")
                           for f in COMPARE_V3_FNS[k]})
    out["v3_launches"] = {k: w.launches for k, w in wrappers.items()}
    ms, runs, _, _ = sparse_recount_events(
        lambda v: other_engine("sparse", buckets, used0, v), TRAIN_VOCAB, used0)
    out["v3_recount_event_ms"], out["v3_recount_runs"] = round(ms, 4), runs
    real, count_ms = spk.sparse_count, []

    def timed(st, *rest):
        st.keys.fill_(spk.EMPTY)
        st.cnts.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        a.record()
        real(st, *rest)
        b.record()
        b.synchronize()
        count_ms.append(round(a.elapsed_time(b), 4))

    timed.launches = 0
    with swapped(spk, sparse_count=timed):
        run_diff(diff_engine("sparse", buckets, used0, TRAIN_VOCAB, torch.device("cuda", 0)),
                 TRAIN_VOCAB, used0)
    out["sparse_count_event_ms"] = count_ms
    return out


# -- phase 7: BPE-dropout ----------------------------------------------------

DROPOUT_P = 0.1
# the dropout path's depth: the first 1/DROPOUT_SHARE of the corpus's lines
# (its kernel is held against its plain version on every input it gives,
# ~100 s of plain calls over the whole corpus)
DROPOUT_SHARE = 4
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


def traced_ms(run, names):
    """(run(), the device ms of the functions whose names contain one of
    ``names``, the timer, the profiler): torch.profiler's records of the
    run; or, where it kept none of them (now and then late in this script,
    cause not found), the run again between CUDA events (``event_ms``, a
    span on the card's clock) and no profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    ms = profiled_ms(prof, names)
    if ms > 0:
        return out, ms, "torch.profiler", prof
    return out, event_ms(run, 1), "CUDA events: torch.profiler kept no record", None


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


def dropout_edge_rows(width: int, rng) -> np.ndarray:
    """Front-packed rows of ``width`` slots for the hand model: all-PAD
    filler rows; every edge length that fits, and the full width, as a run
    of one letter, random letters after a space, random letters, and random
    letters with placeholders first, inside and last; then 512 rows of
    random lengths, so that the groups of one warp freeze in different
    rounds."""
    letters = list(range(5, 13))
    rows = [[] for _ in range(4)]
    for n in sorted({k for k in EDGE_LENGTHS if k <= width} | {width}):
        rand = [int(v) for v in rng.choice(letters, n)]
        marked = list(rand)
        for k in {0, n // 2, n - 1}:
            marked[k] = 10**9 + k
        rows += [[rand[0]] * n, [4] + rand[1:], rand, marked]
    rows += [[int(v) for v in rng.choice(letters, int(n))] for n in rng.integers(0, width + 1, 512)]
    mat = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    return mat


def phase_dropout_edges(tables, dev="cuda:0") -> int:
    """The dropout kernel on edge rows at every width where its layout
    changes (EDGE_WIDTHS): equal to its plain version at p 0.1, 0.5 and
    0.9, with the merges it counts equal to the plain version's; p 0 equal
    to the greedy kernel, p 1 to the rows.  Returns the rows checked."""
    import torch

    from youtokentome_tpu_torch.ops import encode_kernel as ek

    rng = np.random.default_rng(SEED + 4)
    n_rows = 0
    for width in EDGE_WIDTHS:
        x = torch.from_numpy(dropout_edge_rows(width, rng)).to(dev)
        for p in (0.1, 0.5, 0.9):
            work = torch.zeros(3, dtype=torch.int64, device=dev) if x.is_cuda else None
            got = ek.encode_dropout(tables, x, p, DROPOUT_SEED, width, work=work)
            want = ek.encode_dropout_plain(tables, x, p, DROPOUT_SEED, width)
            check(torch.equal(got, want), f"dropout kernel != plain on edge rows, width {width}, p {p}")
            merges = int((x >= 0).sum() - (want >= 0).sum())
            counted = merges if work is None else int(work[1])  # the kernel counts on the card
            check(counted == merges, f"edge rows, width {width}, p {p}: the kernel counted "
                  f"{counted} merges, not {merges}")
        check(torch.equal(ek.encode_dropout(tables, x, 0.0, DROPOUT_SEED), ek.encode_greedy(tables, x)),
              f"dropout at p 0 != the greedy kernel on edge rows, width {width}")
        check(torch.equal(ek.encode_dropout(tables, x, 1.0, DROPOUT_SEED), x),
              f"dropout at p 1 changed the edge rows, width {width}")
        n_rows += x.shape[0]
    log(f"[7] edge rows ({n_rows}, widths {EDGE_WIDTHS}): dropout kernel == plain at p 0.1, 0.5 "
        f"and 0.9, merges counted == plain's; p 0 == greedy kernel, p 1 == input")
    return n_rows


def phase_dropout_main(main: dict, lines, card: str) -> dict:
    """The main path: ``BPE.encode(lines, dropout_prob=0.1)`` over the first
    1/DROPOUT_SHARE of the 100 MB corpus's lines on the native route and,
    with YTTM_DROPOUT_NATIVE=0, through the kernel (launches counted);
    checks; then the kernel, its plain version and its work on every input
    the main path gave it."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import encoder as encoder_mod
    from youtokentome_tpu_torch.ops import encode_kernel as ek

    lines = lines[: len(lines) // DROPOUT_SHARE]
    n_bytes = sum(len(t.encode()) + 1 for t in lines)
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
    log(f"[7] main path BPE.encode(lines, dropout_prob={DROPOUT_P}) over the first {len(lines)} "
        f"lines ({n_bytes} bytes): native route {native_s:.2f} s "
        f"({n_bytes / 1e6 / native_s:.2f} MB/s, no launch); YTTM_DROPOUT_NATIVE=0 {kern_s:.2f} s "
        f"({n_bytes / 1e6 / kern_s:.2f} MB/s), encode_dropout launches {launches} ({card})")
    check(bpe.device.type != "cuda" or launches == len(calls) > 0,
          "the kernel route did not launch encode_dropout")
    for name, ids in (("native", native), ("kernel", kern)):
        check(bpe.decode(ids[: len(sample)]) == sample, f"{name}-route dropout ids do not decode back")
    ln = np.array([len(r) for r in native], np.float64)
    lk = np.array([len(r) for r in kern], np.float64)
    greedy = float(np.mean([len(r) for r in main["ids"][: len(lines)]]))
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
    outs, k_ms, timer, _ = traced_ms(
        lambda: [real(tables, x, DROPOUT_P, seed, row0) for x, seed, row0 in calls],
        DROPOUT_DEVICE_FNS)
    check(k_ms > 0, "no device time for encode_dropout")
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
        f"({timer}), bytes bound {b_ms:.4f} ms, operations "
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
    "stream_merge": MERGE_WORDS_FNS + ("occ_len_kernel", "fill_tail_kernel", "expand_kernel"),
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


def check_stream_chunk(enc, name: str, data: bytes, unk: int, dev) -> dict:
    """Each stream kernel against its plain version on one chunk (each fed
    the plain version's inputs), the merge on both wires.  Returns the
    chunk's counts and its unique words' lengths."""
    import torch

    from youtokentome_tpu_torch.ops import stream_kernel as sk

    st = enc._stream
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    kt, kw, kn = sk.stream_build(x, st.alpha_cps, st.alpha_ids, st.space_id)
    pt, pw, pn = sk.build_stream(x, st.alpha_cps, st.alpha_ids, st.space_id)
    check(int(kn) == int(pn) and torch.equal(kt, pt) and torch.equal(kw, pw),
          f"stream_build != plain on the {name}")
    kd, pd = sk.stream_dedup(pt, pw, pn), sk.dedup_words(pt, pw, pn)
    check(same_words(kd, pd), f"stream_dedup != plain on the {name}")
    for u in (None, unk):
        ko, kk = sk.stream_merge(enc.tables, pd, u)
        po, pk = sk.stream_merge_plain(enc.tables, pd, u)
        check(int(kk) == int(pk) and torch.equal(ko, po),
              f"stream_merge != plain on the {name} (unk {u})")
    nu = int(pd.n_unique)
    return {"tokens": int(pn), "words": int(pd.n_words), "unique": nu, "ids": int(pk),
            "ulen": pd.ulen[:nu].cpu().numpy()}


def stream_edge_chunks(rng) -> dict:
    """Chunks for the hand model (letters a-h) whose unique words sit at the
    merge kernel's layout edges (a word of n tokens: a space and n - 1
    chars; a lone unknown char is one placeholder): ``edges`` words of 2,
    8, 9, 16, 17, 32, 33 and 512 tokens and NEWLINE pseudo-words of 1, some
    with placeholders first, inside and last, each word up to three times,
    in random order; ``long`` one line (no NEWLINE word) of words of 33-512
    tokens only; ``monster`` words of 513 and 2000 tokens among short ones."""

    def words(lengths, per: int):
        out = []
        for n in lengths:
            for i in range(per):
                chars = [str(c) for c in rng.choice(list("abcdefgh"), n - 1)]
                if i % 4 == 3 and n >= 4:
                    for k in {0, (n - 1) // 2, n - 2}:
                        chars[k] = "z"
                out += ["".join(chars)] * int(rng.integers(1, 4))
        rng.shuffle(out)
        return out

    def text(ws, per_line: int):
        return "\n".join(" ".join(ws[i : i + per_line]) for i in range(0, len(ws), per_line))

    edges = words(EDGE_LENGTHS[1:], 24)
    return {
        "edge-length chunk": (text(edges, 9) + "\n\n\n").encode(),
        "all-long chunk": " ".join(words((33, 34, 64, 65, 128, 129, 256, 257, 511, 512), 6)).encode(),
        "monster-word chunk": (text(words((3, 5, 16, 513, 2000), 3), 4) + "\n").encode(),
    }


def phase_stream_edges(dev="cuda:0") -> None:
    """The stream kernels against their plain versions on the hand model's
    edge chunks: unique words at every length class of the merge kernel,
    a chunk whose unique words all exceed 32 tokens, and words past 512."""
    from youtokentome_tpu_torch.encoder import Encoder

    state = hand_model()
    enc = Encoder(state, device=dev)
    for name, data in stream_edge_chunks(np.random.default_rng(SEED + 5)).items():
        got = check_stream_chunk(enc, name, data, state.special_tokens.unk_id, dev)
        ulen = got.pop("ulen")
        check(name != "all-long chunk" or int(ulen.min()) > 32, "a unique word of <= 32 tokens")
        check(name != "monster-word chunk" or int(ulen.max()) > 512, "no word past 512 tokens")
        lens = sorted(set(ulen.tolist()))
        log(f"[8] {name} ({len(data)} bytes): stream_build, stream_dedup and stream_merge (int32 "
            f"and u16) == plain ({got}; unique word lengths {lens[:12]}{'...' if len(lens) > 12 else ''}"
            f"{lens[-3:] if len(lens) > 12 else ''})")


def phase_stream_kernels(main: dict, lines, dev="cuda:0") -> None:
    """Each stream kernel against its plain version on the corpus's first
    1 MiB chunk and on a crafted chunk (fed the plain version's inputs)."""
    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.ops import stream_kernel as sk

    enc = Encoder(main["state"], device=main["device"] or dev)
    first = next(sk.StreamEncoder.chunks(main["blob"], sk.DEFAULT_CHUNK))
    for name, data in (("first 1 MiB chunk", first), ("crafted chunk", crafted_chunk(lines))):
        got = check_stream_chunk(enc, name, data, main["unk"], dev)
        longest = int(got.pop("ulen").max())
        check(name == "first 1 MiB chunk" or longest > 512, "no word past the warp path")
        log(f"[8] {name} ({len(data)} bytes): stream_build, stream_dedup and stream_merge (int32 "
            f"and u16) == plain ({got['tokens']} tokens, {got['words']} words, {got['unique']} "
            f"unique, longest {longest} tokens, {got['ids']} ids)")


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
    the first 1/STREAM_SHARE of the 100 MB corpus's lines (launches
    counted) gives phase 3's ids; the CLI route ``encode_bytes_flat`` +
    ``format_ids`` gives phase 3's CLI bytes; then each stage over every
    chunk of those lines: the kernel under the profiler, its plain version
    (equal, each call synchronised), and the work its data needs."""
    import torch

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch.encoder import Encoder
    from youtokentome_tpu_torch.host.fastio import format_ids
    from youtokentome_tpu_torch.ops import stream_kernel as sk

    lines, blob, want_ids, want_cli = lines_prefix(lines, main["blob"], main["ids"], main["cli"],
                                                   STREAM_SHARE)
    unk = main["unk"]
    n_bytes = len(blob)
    wrappers = {name: getattr(sk, name) for name in STREAM_KERNELS}
    with env_set(YTTM_ENCODE_BACKEND="stream"):
        bpe = yttm.BPE(str(main["model_path"]), device=main["device"])
        for f in wrappers.values():
            f.launches = 0
        ids, api_s = timed(lambda: bpe.encode(lines))
        launches = {name: f.launches for name, f in wrappers.items()}
    log(f"[8] main path YTTM_ENCODE_BACKEND=stream BPE.encode(lines) over the first {len(lines)} "
        f"lines ({n_bytes} bytes): {api_s:.2f} s "
        f"({n_bytes / 1e6 / api_s:.2f} MB/s); launches {launches} ({card})")
    for name, n in launches.items():
        check(bpe.device.type != "cuda" or n > 0, f"the stream backend did not launch {name}")
    check(ids == want_ids, "stream-backend ids != phase 3's")
    del ids
    enc = Encoder(main["state"], device=main["device"])
    out, cli_s = timed(lambda: b"".join(format_ids(*enc.encode_bytes_flat(c))
                                        for c in cli_chunks(blob)))
    check(out == want_cli, "the encode_bytes_flat CLI route's bytes != phase 3's")
    del out
    log(f"[8] ids == phase 3's native ids; CLI route encode_bytes_flat + format_ids: {cli_s:.2f} s "
        f"({n_bytes / 1e6 / cli_s:.2f} MB/s), bytes == phase 3's CLI bytes ({card})")

    st, tables, dev = enc._stream, enc.tables, enc.device
    chunks = [torch.frombuffer(bytearray(c), dtype=torch.uint8).to(dev)
              for c in sk.StreamEncoder.chunks(blob, sk.DEFAULT_CHUNK)]
    stages = {  # each stage over every chunk, from the last stage's results
        "stream_build": lambda _: [sk.stream_build(x, st.alpha_cps, st.alpha_ids, st.space_id)
                                   for x in chunks],
        "stream_dedup": lambda built: [sk.stream_dedup(*b) for b in built],
        "stream_merge": lambda words: [sk.stream_merge(tables, w, unk) for w in words],
    }
    k_ms, timer, results = {}, {}, [None]
    for name, run in stages.items():
        arg = results[-1]
        out, k_ms[name], timer[name], prof = traced_ms(
            lambda: run(arg), STREAM_DEVICE_FNS[name] + STREAM_SHARED_FNS)
        results.append(out)
        check(k_ms[name] > 0, f"no device time for {name}")
    # the merge itself; the rest expands (events do not split it)
    words_ms = profiled_ms(prof, MERGE_WORDS_FNS) if prof else None
    built, words, merged = results[1:]
    del results, out

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
        split = ""
        if name == "stream_merge" and words_ms is not None:
            rows[-1]["merge_words_ms"] = words_ms
            split = f" ({', '.join(MERGE_WORDS_FNS)} {words_ms:.3f}, the rest {k_ms[name] - words_ms:.3f})"
        log(f"[8] {name}: {launches[name]} launches, {k_ms[name]:.3f} ms on the card{split} "
            f"({timer[name]}, {len(chunks)} chunks), bound {max(b_ms, o_ms):.4f} ms "
            f"({rows[-1]['bound_by']}), plain {p_ms[name]:.1f} ms ({card})")
    return {"rows": rows, "api_mbps": n_bytes / 1e6 / api_s, "cli_mbps": n_bytes / 1e6 / cli_s}



def compare_encode(work: Path, dev="cuda:0") -> dict:
    """The numbers the encode kernels' redesigns are held to, for the
    package of the current directory's tree (run it in a parent's unpacked
    tree and in the change's, in turns, each from a process of its own that
    loads this file by its path, as compare_tree): rows 1-2, the greedy
    kernels on the main path's bucket chunks (CUDA events); row 3, the
    dropout kernel on every input of the kernel route's 100 MB encode
    (torch.profiler and CUDA events) and that encode's MB/s; row 4c,
    stream_merge on the corpus's chunks (torch.profiler, split into the
    words kernels and the rest; CUDA events) and the stream CLI route's
    MB/s twice.  The corpus and the model are written to ``work`` by the
    first caller and read by the others.  A digest of every kernel output
    and of the CLI bytes must agree across trees.  Prints and returns the
    numbers."""
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    import youtokentome_tpu_torch as yttm
    from youtokentome_tpu_torch import encoder as encoder_mod
    from youtokentome_tpu_torch.encoder import DEVICE_BATCH, Encoder
    from youtokentome_tpu_torch.host import fasttok
    from youtokentome_tpu_torch.host.fastio import format_ids
    from youtokentome_tpu_torch.models.state import BPEState
    from youtokentome_tpu_torch.ops import encode_kernel as ek
    from youtokentome_tpu_torch.ops import stream_kernel as sk

    dev = torch.device(dev)
    work.mkdir(parents=True, exist_ok=True)
    corpus_path, model_path = work / "corpus_100mb.txt", work / "vocab30k.yttm"
    if not model_path.exists():
        words, lines = build_corpus()
        corpus_path.write_text("\n".join(lines) + "\n")
        build_model(words)[0].dump(str(model_path))
    blob = corpus_path.read_bytes()
    lines = blob.decode().split("\n")[:-1]
    state = BPEState.load(str(model_path))
    unk = state.special_tokens.unk_id
    out = {"tree": os.getcwd(), "card": card_line()}
    digest = hashlib.sha256()

    def fold(ts):
        for x in ts:
            digest.update(x.cpu().numpy().tobytes())

    # rows 1-2
    alpha_cps = np.sort(np.array(list(state.char2id), np.uint32))
    alpha_ids = np.array([state.char2id[int(c)] for c in alpha_cps], np.int32)
    wf, wo, _, _ = fasttok.tokenize(blob, alpha_cps, alpha_ids, 4)
    chunks = [np.ascontiguousarray(mat[c0 : c0 + DEVICE_BATCH])
              for _, mat in Encoder._bucket_rows(wf, wo) for c0 in range(0, mat.shape[0], DEVICE_BATCH)]
    tables = ek.EncoderTables.from_state(state, dev)
    x32 = [torch.from_numpy(c).to(dev) for c in chunks]
    x16 = [torch.from_numpy(ek.pack_tokens_u16(c)).to(dev) for c in chunks]
    out["encode_greedy_ms"] = event_ms(lambda: [ek.encode_greedy(tables, x) for x in x32], 5)
    out["encode_greedy_u16_ms"] = event_ms(lambda: [ek.encode_greedy_u16(tables, x, unk) for x in x16], 5)
    fold(ek.encode_greedy(tables, x) for x in x32)
    fold(ek.encode_greedy_u16(tables, x, unk) for x in x16)
    out["greedy_launches"] = len(chunks)
    del x32, x16

    # row 3
    bpe = yttm.BPE(str(model_path), device=dev)
    real, calls = ek.encode_dropout, []

    def recorded(tables, toks, p, seed, row0=0):
        calls.append((toks, seed, row0))
        return real(tables, toks, p, seed, row0)

    with env_set(YTTM_DROPOUT_NATIVE="0"), swapped(encoder_mod, encode_dropout=recorded):
        _, kern_s = timed(lambda: bpe.encode(
            lines, dropout_prob=DROPOUT_P, generator=torch.Generator().manual_seed(2)))
    out["dropout_kernel_route_mbps"] = len(blob) / 1e6 / kern_s
    dtables = bpe._encoder.tables
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [real(dtables, x, DROPOUT_P, seed, row0) for x, seed, row0 in calls]
        torch.cuda.synchronize()
    out["encode_dropout_ms"] = profiled_ms(prof, ("encode_dropout",))
    # the same inputs at p 1 (one round, no merge) and p 0 (a merge a
    # round until none is left): a launch's fixed cost against its rounds'
    for p in (1.0, 0.0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fold(real(dtables, x, p, seed, row0) for x, seed, row0 in calls)
            torch.cuda.synchronize()
        out[f"encode_dropout_p{p:g}_ms"] = profiled_ms(prof, ("encode_dropout",))
    out["encode_dropout_event_ms"] = event_ms(
        lambda: [real(dtables, x, DROPOUT_P, seed, row0) for x, seed, row0 in calls], 1)
    out["dropout_launches"] = len(calls)
    fold(outs)
    del calls, outs

    # row 4c and the stream CLI route
    enc = Encoder(state, device=dev)
    st = enc._stream
    xs = [torch.frombuffer(bytearray(c), dtype=torch.uint8).to(dev)
          for c in sk.StreamEncoder.chunks(blob, sk.DEFAULT_CHUNK)]
    words = [sk.stream_dedup(*sk.stream_build(x, st.alpha_cps, st.alpha_ids, st.space_id))
             for x in xs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        merged = [sk.stream_merge(enc.tables, w, unk) for w in words]
        torch.cuda.synchronize()
    out["stream_merge_ms"] = profiled_ms(prof, STREAM_DEVICE_FNS["stream_merge"] + STREAM_SHARED_FNS)
    out["merge_words_ms"] = profiled_ms(prof, MERGE_WORDS_FNS)
    out["stream_merge_rest_ms"] = out["stream_merge_ms"] - out["merge_words_ms"]
    out["stream_merge_event_ms"] = event_ms(
        lambda: [sk.stream_merge(enc.tables, w, unk) for w in words], 3)
    out["stream_launches"] = len(words)
    fold(o[: int(n)] for o, n in merged)
    del xs, words, merged
    cli_s = []
    for _ in range(2):
        cli, s = timed(lambda: b"".join(format_ids(*enc.encode_bytes_flat(c)) for c in cli_chunks(blob)))
        cli_s.append(s)
    digest.update(cli)
    out["stream_cli_mbps"] = [len(blob) / 1e6 / s for s in cli_s]
    out["digest"] = digest.hexdigest()
    print("COMPARE_ENCODE " + json.dumps(out), flush=True)
    return out


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
    ("stream", "recount"): ("clear_kernel", "stream_count_kernel"),
    ("stream", "topk_accept"): ("topk_select_kernel",),
    ("stream", "apply_compact"): ("apply_compact_kernel",),
    ("sparse", "sparse_count"): ("tomb_count_kernel",),
    ("sparse", "topk_accept"): ("topk_select_kernel",),
    ("sparse", "sparse_apply"): ("mark_live_words_kernel", "apply_words_kernel"),
    ("block", "block_count"): ("count_all_rows_kernel",),
    ("block", "topk_accept"): ("topk_select_kernel",),
    ("block", "block_apply"): ("flag_rows_kernel", "apply_rows_kernel"),
    ("bucketed", "bucket_count"): ("clear_kernel", "rows_count_kernel"),
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
DIFF_SCRATCH = ("tiles", "blk_hi", "blk_lo", "aff", "wmark", "rows")
MID_SITE_CAPS = ("64", "256")  # v3's plain site buffers on the 10 MB prefix
MID_KB = 4  # v4's gather bound on the 10 MB prefix: most rounds take the full path
MID_V0_IDS = 500  # v0's lockstep depth on the 10 MB prefix (one merge a round)
# ids over which the plain versions of phase 9 are timed (v0: one merge a
# round, ~50 ms a plain round at 100 MB)
PLAIN_IDS = {"stream": 1000, "sparse": 1000, "block": 1000, "bucketed": 200}
# v0's depth on its main paths (phases 9 and 11): one merge a round, so its
# first V0_MAIN_IDS ids take about a tenth of the 29,969 rounds of a run to
# vocab 30000 (~95 s of the 4-shard run under the profiler); its rules are
# held against the first V0_MAIN_IDS of phase 5's
V0_MAIN_IDS = 3000


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
        if plain:
            mod.apply_compact_plain(st)
        else:
            mod.apply_compact([st])
    elif name == "bucketed":
        (mod.bucket_count_plain if plain else mod.bucket_count)(st, V, V)
        topk(st, V, V, used0, 1)
        if plain:
            mod.bucket_apply_plain(st)
        else:
            mod.bucket_apply([st])
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
        if name == "sparse":
            phase_tomb_checks("sparse_count", st, [st], dev)
        if name == "stream":
            phase_stream_count_checks(st, dev)
            phase_compact_checks(dev)
        if name == "bucketed":
            phase_row_count_checks(st, dev)
            phase_row_apply_checks(st, used0, dev)
        if name == "block":
            phase_block_apply_checks(dev)
        k_st, p_st = clone_state(st), clone_state(st)
        for r in range(3 if name == "stream" else 2):  # v1: odd, its stream in the second buffer
            diff_round(name, mod, k_st, used0, False, getattr(eng, "KB", 0))
            diff_round(name, mod, p_st, used0, True, getattr(eng, "KB", 0))
            same_diff_state(k_st, p_st, f"{name}: round {r}")
        log(f"[9] {name}: every kernel == its plain version on the 100 MB state "
            f"({r + 1} rounds, {int(k_st.ctl[tk.USED]) - used0} ids, table {st.cap} slots)")
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
        before = clone_state(k_st)
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
    if before.device.type == "cuda":
        block_round_launches(mod, before, used0, eng.KB)


def block_round_launches(mod, st, used0: int, kb: int) -> None:
    """What a round of v4's block_apply enqueues, from ``st`` after its
    top-k, at KB = ``kb`` (the block path) and 0 (the full path): the call
    captured into a CUDA graph (libcuda's cuStreamBeginCapture; the graph is
    never run) holds two kernel nodes, the walk and the apply, and nothing
    else, so no clear or recount.  The entry picks no launch by the round's
    data (the apply takes its path on the card), so the capture shows what
    every round launches, without torch.profiler's records.  Then the round
    itself, which must take the block path."""
    import ctypes

    import torch

    from youtokentome_tpu_torch.ops import train_kernels as tk

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(res: int, what: str) -> None:
        check(res == 0, f"{what}: CUresult {res}")

    x = clone_state(st)
    tk.topk_accept(x, TRAIN_VOCAB, TRAIN_VOCAB, used0, 16)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    torch.cuda.synchronize()
    handle = ctypes.c_void_p(side.cuda_stream)
    for k in (kb, 0):
        graph = ctypes.c_void_p()
        ok(cu.cuStreamBeginCapture_v2(handle, 2), "cuStreamBeginCapture")  # relaxed mode
        try:
            with torch.cuda.stream(side):
                mod.block_apply(x, k)
        finally:
            ended = cu.cuStreamEndCapture(handle, ctypes.byref(graph))
        ok(ended, "cuStreamEndCapture")
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        kinds = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
            kinds.append(kind.value)
        ok(cu.cuGraphDestroy(graph), "cuGraphDestroy")
        want = len(DIFF_DEVICE_FNS[("block", "block_apply")])
        check(kinds == [0] * want,  # CU_GRAPH_NODE_TYPE_KERNEL
              f"block_apply at KB {k} enqueued nodes of types {kinds}, not {want} kernels")
    full0 = int(x.work[mod.W_FULL])
    mod.block_apply(x, kb)
    check(int(x.work[mod.W_FULL]) == full0, "the captured round did not take the block path")
    log(f"[9] block: a round of block_apply enqueues {want} kernels and nothing else on either "
        f"path (its call captured into a CUDA graph at KB {kb} and at 0)")


BLOCK_EDGE_BS = (128, 512)  # v4's row widths that the apply's edge checks take


def block_edge_rows(B: int, base: int, rng):
    """(t, wid, freq) of v4 rows of B slots for block_apply's edge checks,
    ids from ``base``, each row a list of (first slot, word): words ending
    at slots B-2 and B-1 whose last pair is a candidate of edge_rounds;
    runs of (a, a) and chains (b, c, d, a) across a 32-slot edge; rows of
    words of two rare ids (e, f) only, PAD between and inside their slots
    (no candidate in any round: on a full-path round they are front-packed
    all the same); a row of B tokens; random rows of words of 2-14 ids over
    six, PAD gaps of 0-3 slots between them; then rows of PAD up to a power
    of two."""
    a, b, c, d = (base + i for i in range(4))
    e, f = base + 6, base + 7
    rows = [[(B - 3, [c, a, a])], [(0, [e, f]), (B - 2, [d, a])], [(B - 4, [b, c, d, a])],
            [(20, [d] + [a] * 40 + [b])], [(31, [a, a, a])], [(30, [b, a, a, a, a, a])],
            [(28, [b, c, d, a, a, b, c, d])], [(B // 4 + 8, [d] + [a] * 70 + [c])], [(0, [a] * B)]]
    for k in range(6):
        rows.append([(3 * k, [e, f, e]), (40 + k, [f, f, e, e, f][: 2 + k % 4]),
                     (B // 2 + k, [e] * (k + 2))])
    for _ in range(40):
        row, at = [], int(rng.integers(0, 4))
        while True:
            n = int(rng.integers(2, 15))
            if at + n > B:
                break
            row.append((at, [base + int(v) for v in rng.integers(0, 6, n)]))
            at += n + int(rng.integers(0, 4))
        rows.append(row)
    NB = 1 << (len(rows) + 2).bit_length()
    t = np.full((NB, B), -1, np.int32)
    wid = np.full((NB, B), -1, np.int32)
    k = 0
    for r, row in enumerate(rows):
        for at, w in row:
            t[r, at : at + len(w)] = w
            wid[r, at : at + len(w)] = k
            k += 1
    return t.reshape(-1), wid.reshape(-1), rng.integers(1, 6, k).astype(np.int32)


def phase_block_apply_checks(dev) -> dict:
    """block_apply against block_apply_plain on ``block_edge_rows`` (B =
    128 and 512, ids from 5 and 70000), in each of ``edge_rounds``, at KB =
    the round's rows with a hit (the block path) and one less (the full
    path), from the rows' first count, and once more from each result in
    the round that hits nearly every word: rows, extents, table, ctl and
    work (the bytes each pass must move) equal, each extent the row's last
    live slot + 1, the path the round took the plain version's."""
    import torch

    from youtokentome_tpu_torch.ops import block_kernels as bk

    t0 = time.perf_counter()
    n_checks, paths = 0, set()
    for B in BLOCK_EDGE_BS:
        for base in APPLY_BASES:
            rng = np.random.default_rng(base + B)
            t, wid, freq = block_edge_rows(B, base, rng)
            rules = np.full((base + 200, 4), -1, np.int32)
            st = bk.BlockState(t, wid, freq, rules, 0, B, 1 << 12, dev)
            bk.block_count(st)
            many = dict(edge_rounds(base))["nearly every word hit"]
            for what, cands in edge_rounds(base):
                probe = clone_state(st)
                set_round(probe, cands, base + 100)
                bk.block_apply_plain(probe, st.NB)
                hits = int(probe.ctl[bk.NBAFF])
                for kb in sorted({hits, max(hits - 1, 0)}):
                    k_st, p_st = clone_state(st), clone_state(st)
                    for r, (rw, cs) in enumerate(((what, cands), ("nearly every word hit", many))):
                        for x in (k_st, p_st):
                            set_round(x, cs, base + 100 + 20 * r)
                            x.ctl[bk.NBAFF] = 0  # as the round's top-k leaves it
                        full0 = int(k_st.work[bk.W_FULL])
                        bk.block_apply(k_st, kb if r == 0 else st.NB)
                        bk.block_apply_plain(p_st, kb if r == 0 else st.NB)
                        label = (f"block_apply, B {B}, ids from {base}, {rw} (round {r}), "
                                 f"KB {kb if r == 0 else st.NB}")
                        same_diff_state(k_st, p_st, label)
                        check(torch.equal(k_st.ext, bk.row_extents(k_st.tok, B)),
                              f"{label}: the extents are not the rows'")
                        full = int(k_st.work[bk.W_FULL]) > full0
                        check(full == (int(k_st.ctl[bk.NBAFF]) > (kb if r == 0 else st.NB)),
                              f"{label}: the path taken")
                        paths.add((r == 0 and kb < hits, full))
                        n_checks += 1
    check({(True, True), (False, False)} <= paths, f"the edge checks missed a path: {paths}")
    log(f"[9] block_apply == plain on {n_checks} edge rounds (B {BLOCK_EDGE_BS}, ids from "
        f"{APPLY_BASES}; hits at slots B-2 and B-1, runs across 32-slot edges, rows of PAD "
        f"gaps front-packed on full-path rounds, KB at the rows with a hit and one less; the "
        f"extents the rows') ({time.perf_counter() - t0:.1f} s)")
    return {"checks": n_checks}


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
        # the apply: the bytes its flag walk and its row applies must move,
        # summed by the kernels (W_READ: each filled row's extent and tokens
        # below it, two word ids a candidate pair of tokens; W_APPLY: the
        # applied rows below their extents read and written, a table entry a
        # pair, the whole table on a full-path round)
        read, apply = w[mod.W_READ], w[mod.W_APPLY]
        return {"block_count": (count_b, len(count_calls) * m * OPS_PER_COUNTED),
                "topk_accept": topk,
                "block_apply": (read + apply, read // 4 * OPS_PER_POS // 2
                                + apply // 16 * OPS_PER_COUNTED)}
    # apply: every slot read, the slots the merge changed written (most rows
    # hold no hit); no row offsets (the walk takes a slot's row from the
    # bucket table)
    slots_rows = int(st.tok.shape[0])
    return {"bucket_count": (rounds * (slots_rows * 4 + st.n_rows * 8) + occ * 12,
                             rounds * slots_rows * OPS_PER_COUNTED),
            "topk_accept": (slots * 4 + keys * 8 + rounds * 16, slots * OPS_PER_SLOT),
            "bucket_apply": (rounds * slots_rows * 4 + w[mod.W_WRITES] * 4,
                             rounds * slots_rows * OPS_PER_POS)}


class Tracer:
    """The PyTorch profiler's kineto tracer (CUDA activity) over a run:
    each kernel's duration summed by name from the tracer's raw events
    (building the profiler's event tree for key_averages takes minutes on a
    run of a million launches).  ``cycle()`` closes the tracer's window and
    opens the next, so that a long run's records are taken in parts."""

    def __init__(self, keep=()):
        import collections

        self.by_name = collections.Counter()
        self.events = collections.Counter()  # records by name
        self.keep = keep  # function names whose records are kept, (start, ns)
        self.records = {}

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
                self.events[ev.name()] += 1
                for f in self.keep:
                    if f in ev.name():
                        self.records.setdefault(f, []).append((ev.start_ns(), ev.duration_ns()))

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

    def ms(self, fns: dict, counts: bool = False) -> dict:
        """Device ms of each key of ``fns``, summed over the kernels whose
        names hold one of its function names (``counts``: their records
        instead)."""
        import re

        ms = {k: 0.0 for k in fns}
        for fn_name, ns in (self.events if counts else self.by_name).items():
            for k, names in fns.items():
                if any(re.search(r"(^|[^A-Za-z0-9_])" + f + r"[(<]", fn_name) for f in names):
                    ms[k] += ns if counts else ns / 1e6
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


def each_state(fn):
    """A wrapper that takes the states of a card (v1's apply_compact, v0's
    bucket_apply) made of ``fn``, the plain version that takes one."""
    def run(states):
        for st in states:
            fn(st)
    return run


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
        elif k in ("apply_compact", "bucket_apply"):  # the wrapper takes the states of a card
            repl[k] = timed(k, each_state(getattr(mod, k + "_plain")))
        else:
            repl[k] = timed(k, getattr(mod, k + "_plain"))
    with swapped(mod, **repl):
        eng = engine()
        used = run_diff(eng, vocab, used0)
    return ms, eng, used


def sparse_count_event_ms(st) -> float:
    """sparse_count on the v3 state ``st``: the wrapper's table reset, then
    its kernel alone between CUDA events, a sleep kernel ahead so that the
    host's enqueue is not timed; returns the kernel's ms."""
    import torch

    from youtokentome_tpu_torch.ops import _cuda
    from youtokentome_tpu_torch.ops import sparse_kernels as spk

    st.keys.fill_(spk.EMPTY)
    st.cnts.zero_()
    st.ctl[[spk.OCC, spk.OVERFLOW]] = 0
    lib = _cuda.load_sparse()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
    a.record()
    err = lib.yttm_sparse_count(
        st.t.data_ptr(), st.pw.data_ptr(), st.off.data_ptr(), st.fw.data_ptr(), st.end,
        st.keys.data_ptr(), st.cnts.data_ptr(), st.cap, st.ctl.data_ptr(), 0,
        torch.cuda.current_stream().cuda_stream)
    b.record()
    b.synchronize()
    check(err == 0, f"sparse_count kernel launch failed: CUDA error {err}")
    return a.elapsed_time(b)


def phase_diff_main(corpus_path: Path, work: Path, sample, v2_rules, card: str,
                    select_keys: dict) -> dict:
    """The main path of each differential trainer at vocab 30000 (v0 to its
    first V0_MAIN_IDS ids): launches
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

        count_calls, count_ms = [], []
        library = LibrarySample()  # torch.topk's yardstick, in the profiled run
        if name == "bucketed":
            # v0's main path is its merge loop alone (to V0_MAIN_IDS ids): it
            # runs once, under the profiler, which gives each kernel's device
            # time; its engine gives the run's work
            engines = []

            class Recorded(mod.BucketedKernelEngine):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    engines.append(self)

            tally = KeyTally(mod.topk_accept)
            v0_vocab = min(TRAIN_VOCAB, used0 + V0_MAIN_IDS)
            with swapped(mod, BucketedKernelEngine=Recorded, topk_accept=library.topk(tally)):
                kernel_ms, train_s, got = profiled(
                    name, lambda: tk0.run_training(buckets, used0, v0_vocab))
            check(got == v2_rules[: v0_vocab - used0],
                  f"v0 run_training's rules != the first {v0_vocab - used0} of phase 5's v2 rules")
            what = f"ops.train_kernel.run_training to vocab {v0_vocab} (under torch.profiler)"
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

                def counted(st, real_count=real_count, name=name):
                    if name == "sparse" and st.device.type == "cuda":
                        count_ms.append(sparse_count_event_ms(st))
                    else:
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
            with swapped(mod, topk_accept=library.topk(mod.topk_accept)):
                kernel_ms, prof_s, (p_eng, p_used) = profiled(name, lambda: replica(TRAIN_VOCAB))
            check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules),
                  f"the profiled {name} run's rules differ")
            log(f"[9] {name}: a replica of the merge loop under torch.profiler took {prof_s:.3f} s "
                f"against {loop_s:.3f} s without")
            if name == "sparse":
                # the count by CUDA events at its launches in the timed run
                # (late in the script the tracer drops records)
                log(f"[9] sparse_count by CUDA events at its {len(count_ms)} launches: "
                    f"{sum(count_ms):.3f} ms ({', '.join(f'{v:.3f}' for v in count_ms)}); the "
                    f"profiler's replica {kernel_ms['sparse_count']:.3f} ms")
                check(len(count_ms) == launches["sparse_count"] and sum(count_ms) > 0,
                      f"sparse_count timed at {len(count_ms)} launches of "
                      f"{launches['sparse_count']}")
                kernel_ms["sparse_count"] = sum(count_ms)
                tomb_state_check("sparse_count", [eng.st], "the 100 MB v3 run")
        for k, n in launches.items():
            check(n > 0, f"the {name} main path did not launch {k}")
        log(f"[9] {what}: {train_s:.2f} s, rules == phase 5's v2 rules (their first "
            f"{used - used0}); launches {launches}")
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
                   "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
                   "library_ms": library.ms(launches[k]) if k == "topk_accept" else None}
            rows.append(row)
            log(f"[9] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms "
                f"over the first {row['plain_ids']} ids (kernel {prefix_ms[k]:.3f} ms) ({card})"
                + library_note(row, library))
        res[name] = {"train_s": train_s, "loop_s": loop_s, "rounds": rounds,
                     "merges_per_s": merges / loop_s}
        log(f"[9] times {name}: {what} {train_s:.2f} s, merge loop {loop_s:.3f} s, {rounds} "
            f"rounds, {merges / loop_s:.0f} merges/s ({card})")
    return {"rows": rows, "times": res, "select_keys1": keys1}


# -- phase 10: the data mesh (sharded encode, sharded v2 training) -----------

SHARDS = 4  # shards of the data mesh, all on card 0
SHARD_SOURCE = "youtokentome_tpu_torch/csrc/train_delta_sharded.cu"
SHARD_KERNELS = ("delta_emit", "shard_recount", "shard_fold", "shard_relay")
# shard_fold's device functions: its two entries, and the round graph's gate
# that picks between them
SHARD_FOLD_FNS = ("fold_delta_kernel", "rebuild_copy_kernel", "rebuild_add_kernel",
                  "rebuild_done_kernel", "round_gate_kernel")
# the device functions of each wrapper, as the profiler names them
SHARD_DEVICE_FNS = {
    "topk_accept": ("topk_select_kernel",),
    "delta_emit": ("delta_emit_kernel",),
    "shard_recount": ("recount_clear_kernel", "pair_count_kernel"),
    "shard_fold": SHARD_FOLD_FNS,
    "shard_relay": ("relay_len_kernel", "relay_write_kernel", "tile_sums_kernel",
                    "tile_offsets_kernel", "scan_apply_kernel"),
}
# the sharded v2 wrappers' device functions in either tree that compare_tree
# may run: the emit's, the fold's and the recount's before their redesign too
COMPARE_SHARD_FNS = {
    "topk_accept": ("topk_select_kernel",),
    "delta_emit": ("mark_words_kernel", "emit_words_kernel", "delta_emit_kernel"),
    "shard_recount": ("recount_clear_kernel", "recount_kernel", "pair_count_kernel"),
    "shard_fold": ("fold_prep_kernel", "fold_kernel", "fold_done_kernel") + SHARD_FOLD_FNS,
}


# v4's device functions in either tree that compare_tree may run: the
# apply's clear and recount before its redesign too
COMPARE_V4_FNS = {
    **{k: DIFF_DEVICE_FNS[("block", k)] for k in DIFF_KERNELS["block"]},
    "block_apply": ("flag_rows_kernel", "apply_rows_kernel", "full_clear_kernel",
                    "full_recount_kernel"),
}


# the device functions in either tree that compare_tree may run, besides
# their own: v1's apply and v0's count before their redesign
COMPARE_RECOUNT_FNS = {
    "apply_compact": ("hit_tiles_kernel", "select_tiles_kernel", "scatter_kernel"),
    "bucket_count": ("count_rows_kernel",),
    "bucket_shard_count": ("count_rows_kernel",),
}


# the sharded v3 wrappers' device functions in either tree that compare_tree
# may run: the recount's before its redesign too
COMPARE_V3_FNS = {
    "topk_accept": ("topk_select_kernel",),
    "sparse_emit": ("mark_live_words_kernel", "emit_live_words_kernel", "sparse_emit_kernel"),
    "sparse_shard_recount": ("sparse_recount_clear_kernel", "sparse_recount_kernel",
                             "recount_clear_kernel", "tomb_count_kernel"),
    "shard_fold": SHARD_FOLD_FNS,
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
    timers = set()

    def merge_ms(fn):
        _, ms, timer, _ = traced_ms(fn, ENCODE_DEVICE_FNS)
        timers.add(timer)
        return ms

    k_ms = merge_ms(lambda: [es.encode_greedy_sharded_u16(tables, x, unk, mesh) for x in x16])
    one_ms = merge_ms(lambda: [ek.encode_greedy_u16(tables, x, unk) for x in x16])
    part = x16[::SHARD_PLAIN_EVERY]
    part_ms = merge_ms(lambda: [es.encode_greedy_sharded_u16(tables, x, unk, mesh) for x in part])
    check(min(k_ms, one_ms, part_ms) > 0, "no device time for the merge")
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
        f"launches): kernel {k_ms:.4f} ms ({', '.join(sorted(timers))}; one device, same chunks: "
        f"{one_ms:.4f} "
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
        c._links = c._emit = None
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


def listed_entries(st, p: int) -> tuple:
    """The scratch entries that part ``p``'s list names, as a sorted (key,
    count) multiset (numpy)."""
    slots = st.part_list(p)
    keys, cnts = st.rkeys[slots].cpu().numpy(), st.rcnts[slots].cpu().numpy()
    order = np.argsort(keys, kind="stable")
    return keys[order], cnts[order]


def same_lists(a, b, what: str) -> None:
    """Kernel and plain shards' part lists agree: each part's count, and
    the entries each list names as a multiset (unless it dropped claims,
    which it may do in any order); and in the kernel's, every filled
    scratch slot listed once, in its key's part."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    check(torch.equal(a.pcnt, b.pcnt), f"{what}: part counts {a.pcnt.tolist()} != "
          f"{b.pcnt.tolist()}")
    n, lost = a.n_parts, False
    for p in range(n):
        if int(a.pcnt[p]) > dsk.part_lo(p + 1, a.cap, n) - dsk.part_lo(p, a.cap, n):
            lost = True
            continue
        (ka, ca), (kb, cb) = listed_entries(a, p), listed_entries(b, p)
        check(np.array_equal(ka, kb) and np.array_equal(ca, cb),
              f"{what}: part {p}'s listed entries differ")
        slots = a.part_list(p)
        check(bool((dsk.key_part(a.rkeys[slots], n) == p).all()),
              f"{what}: part {p}'s list names a key of another part")
    if not lost:
        listed = torch.sort(torch.cat([a.part_list(p) for p in range(n)])).values
        check(torch.equal(listed, torch.nonzero(a.rkeys != -1).flatten()),
              f"{what}: the lists do not name every filled scratch slot once")


def same_shard(a, b, what: str, buffers: bool = True, stream=("tok",)) -> None:
    """Kernel and plain shard states agree: stream (the attributes named in
    ``stream``), the replica and the scratch table as multisets, the
    scratch table's part lists (``same_lists``, the shards that recount
    every round), ctl, work, rules and (when no side passed dcap) each side
    of the delta buffer as a multiset."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    for k in stream:
        check(torch.equal(getattr(a, k), getattr(b, k)), f"{what}: streams ({k}) differ")
    for t, (ka, ca), (kb, cb) in (("table", a.table(), b.table()),
                                  ("scratch table", scratch_table(a), scratch_table(b))):
        check(np.array_equal(ka, kb) and np.array_equal(ca, cb), f"{what}: {t}s differ")
    if hasattr(a, "plist"):
        same_lists(a, b, what)
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


def shard_plain(k: str):
    """The plain version of the sharded v2 wrapper ``k``, with the
    wrapper's arguments (delta_emit's: the shards of a card, each with words
    through ``delta_emit_plain``; shard_fold's: the replicas of a card, the
    shards, the branch, each replica through ``shard_fold_plain``)."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    if k == "delta_emit":
        def emit(states):
            for st in states:
                if st.n_words:
                    dsk.delta_emit_plain(st)

        return emit
    if k != "shard_fold":
        return getattr(dsk, k + "_plain")

    def fold(reps, shards, rebuild=None):
        for st in reps:
            dsk.shard_fold_plain(st, shards)

    return fold


def shard_round(ks, ps, used0: int, limit: int, what: str, rebuild=None) -> bool:
    """One round through the kernels on ``ks`` and the plain versions on
    ``ps``, compared after each step (``rebuild``: shard_fold's argument,
    None for both entries); returns whether it recounted."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    for a, b in zip(ks, ps):
        tk.topk_accept(a, limit, TRAIN_VOCAB, used0)
        tk.topk_accept_plain(b, limit, TRAIN_VOCAB, used0, 16)
    # every shard of the card in one launch
    launches = dsk.delta_emit.launches
    dsk.delta_emit(ks)
    check(ks[0].device.type != "cuda" or dsk.delta_emit.launches - launches == 1,
          f"{what}: delta_emit launched {dsk.delta_emit.launches - launches} times")
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.delta_emit_plain(b)
        same_shard(a, b, f"{what}, delta_emit shard {i}")
    recount = any(int(a.ctl[dsk.DOVF]) for a in ks)
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.shard_recount(a, ks)
        dsk.shard_recount_plain(b, ps)
        same_shard(a, b, f"{what}, shard_recount shard {i}")
    # every replica of the card in one launch of an entry: the branch picked
    # on the card (both entries) or by the host (the round's entry)
    launches = dsk.shard_fold.launches
    dsk.shard_fold(ks, ks, rebuild)
    check(ks[0].device.type != "cuda"
          or dsk.shard_fold.launches - launches == (2 if rebuild is None else 1),
          f"{what}: shard_fold launched {dsk.shard_fold.launches - launches} entries")
    for b in ps:
        dsk.shard_fold_plain(b, ps)
    for i, (a, b) in enumerate(zip(ks, ps)):
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


# delta_emit's edge checks: shards a launch (one shard without words among
# two or four), and a buffer small enough that the round that hits nearly
# every word passes it partway through some block's entries
EMIT_SHARDS = (1, 2, 4)
EMIT_SMALL_DCAP = 200


def emit_edge_words(base: int, rng):
    """Words for delta_emit's and the relays' edge checks, ids from
    ``base``: the applies' edge words (runs of 1-9 equal ids, chains, words
    of 33-600 tokens, 2,000 random words), a word of every length 1-512,
    and 600 words (a, b) in a row: 3 slots each, so that a warp's step of
    256 positions claims 85 words (more than its 32 lanes, two packs of
    them, and a list of 32 at a time thrice) in a round that accepts (a,
    b)."""
    words = edge_words(base, rng, True)
    words += [[base + int(v) for v in rng.integers(0, 4, n)] for n in range(1, 513)]
    return words + [[base, base + 1]] * 600


def emit_shards(words, n: int, rng, dev):
    """n ShardStates (dcap 1) of ``words`` in order, cut in n - 1 runs of
    words with an empty shard among them (the first of 4, the second of 2),
    or one shard holding them all."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    parts = [list(c) for c in np.array_split(np.arange(len(words)), max(n - 1, 1))]
    if n > 1:
        parts.insert(0 if n == 4 else 1, [])
    rules = np.full((len(words) + 64, 4), -1, np.int32)
    out = []
    for idx in parts:
        if idx:
            t, wid, freq = flat_words([words[i] for i in idx], rng)
        else:
            t, wid, freq = (np.zeros(0, np.int32),) * 3
        out.append(dsk.ShardState(t, wid, freq, rules, 0, 1 << 10, 1, dev))
    return out


def phase_emit_checks(dev) -> dict:
    """delta_emit, one launch for 1, 2 and 4 shards of the card (one of
    them without words), against delta_emit_plain shard by shard on
    ``emit_edge_words`` (ids from 5 and 70000), in each of ``edge_rounds``,
    with buffers that hold the round and with EMIT_SMALL_DCAP entries a side,
    which the round that hits nearly every word passes partway: streams,
    ctl (NAFF, LIVE, DN_OLD and DN_NEW as full counts, DOVF), work and each
    side of the buffer as a multiset; past dcap, the kernel's entries a sub
    multiset of the round's entries."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    t0 = time.perf_counter()
    n_checks, n_ovf, most = 0, 0, 0
    for base in APPLY_BASES:
        words = emit_edge_words(base, np.random.default_rng(base))
        for n in EMIT_SHARDS:
            shards = emit_shards(words, n, np.random.default_rng(base + n), dev)
            for what, cands in edge_rounds(base):
                full = None
                for dcap in (1 << 20, EMIT_SMALL_DCAP):
                    ks = clone_shards(shards, dcap)
                    for st in ks:
                        set_round(st, cands, base + 100)
                    ps = clone_shards(ks)
                    launches = dsk.delta_emit.launches
                    dsk.delta_emit(ks)
                    label = f"delta_emit, {what}, {n} shards, ids from {base}, dcap {dcap}"
                    check(ks[0].device.type != "cuda" or dsk.delta_emit.launches == launches + 1,
                          f"{label}: {dsk.delta_emit.launches - launches} launches")
                    for i, (a, b) in enumerate(zip(ks, ps)):
                        if b.n_words:
                            dsk.delta_emit_plain(b)
                        same_shard(a, b, f"{label}, shard {i}")
                        if not int(a.ctl[dsk.DOVF]):
                            continue
                        n_ovf += 1
                        for side in (0, 1):
                            ka, va = (x.cpu().numpy() for x in a.buffer(side))
                            kf, vf = full[i][side]
                            check(sub_multiset(ka, va, kf, vf),
                                  f"{label}, shard {i}: buffer side {side} is not a part of "
                                  f"the round's entries")
                    if dcap != EMIT_SMALL_DCAP:
                        check(not any(int(a.ctl[dsk.DOVF]) for a in ks), f"{label}: overflow")
                        full = [[tuple(x.cpu().numpy() for x in a.buffer(side)) for side in (0, 1)]
                                for a in ks]
                        most = max([most] + [int(a.ctl[dsk.NAFF]) for a in ks])
                    n_checks += 1
    check(n_ovf > 0, "no emit check passed its buffer")
    log(f"[10] delta_emit (one launch for {EMIT_SHARDS} shards, an empty one among them) == plain "
        f"on {n_checks} edge rounds: words of 1-600 tokens, runs, chains, 3-slot words claimed 85 "
        f"to a warp's 256 positions (up to {most} words a shard a round), ids from {APPLY_BASES}; "
        f"{n_ovf} shards' buffers of {EMIT_SMALL_DCAP} passed partway, the counts past dcap "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"checks": n_checks, "overflows": n_ovf}


SPARSE_EMIT_SPAN = 256  # positions of a warp's step of sparse_emit (csrc/sparse_word.cuh)
SPARSE_EMIT_DEAD = 0.6  # the share of the random words' positions tombstoned


def sparse_emit_groups(base: int, rng) -> list:
    """Groups of tombstoned words (-1 a tombstone) for sparse_emit's edge
    checks (``tomb_lay`` at SPARSE_EMIT_SPAN), ids from ``base``: pairs (a,
    b) and (a, a) whose right token lies 1-300 tombstones past a left one
    at the last slot of a 16-byte group, of a lane's 8 positions, of a
    32-slot chunk and of a warp's 256 positions; runs of one id split by
    tombstone runs; emit_edge_words (runs, chains, words of 1-600
    positions) with SPARSE_EMIT_DEAD of their positions tombstoned, and the
    600 words (a, b) live; words all tombstones."""
    a, b, c = base, base + 1, base + 2
    groups = []
    for k in (3, 7, 31, 127, 255):
        for gap in (1, 4, 8, 29, 32, 300):
            groups.append(([[a] + [-1] * gap + [b]], k))
            groups.append(([[c, a] + [-1] * gap + [a, -1, b]], k - 1))
    for gaps in ([1], [3, 3], [40], [300, 1], [1, 130, 2], [255, 1, 256]):
        for n_live in (2, 3, 4, 5):
            w = [c]
            for i in range(n_live):
                w += [a] + [-1] * (gaps[i] if i < len(gaps) else 0)
            groups.append(([w + [b]], int(rng.integers(0, SPARSE_EMIT_SPAN))))
    words = emit_edge_words(base, rng)
    for w in words[:-600]:
        groups.append([[-1 if v else x for x, v in zip(w, rng.random(len(w)) < SPARSE_EMIT_DEAD)]])
    groups += [words[-600:], [[-1] * 300], [[-1]]]
    return groups


def sparse_emit_shards(groups, base: int, n: int, rng, dev):
    """n SparseShardStates (dcap 1) of ``groups`` in order, cut in n - 1
    runs of groups with an empty shard among them (the first of 4, the
    second of 2), or one shard holding them all."""
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk

    parts = [list(c) for c in np.array_split(np.arange(len(groups)), max(n - 1, 1))]
    if n > 1:
        parts.insert(0 if n == 4 else 1, [])
    out = []
    for idx in parts:
        if idx:
            t, wid, freq = tomb_lay([groups[i] for i in idx], base, rng, SPARSE_EMIT_SPAN)
        else:
            t, wid, freq = (np.zeros(0, np.int32),) * 3
        rules = np.full((int(max(t.max(initial=0), 0)) + 64, 4), -1, np.int32)
        out.append(ssk.SparseShardState(t, wid, freq, rules, 0, 1 << 12, 1, dev))
    return out


def phase_sparse_emit_checks(dev) -> dict:
    """sparse_emit, one launch for 1, 2 and 4 shards of the card (one of
    them without words), against sparse_emit_plain shard by shard on
    ``sparse_emit_groups`` (ids from 5 and 70000), in each of ``edge_rounds``
    and a round of (a, b) and (a, a), with buffers that hold the round and
    with EMIT_SMALL_DCAP entries a side, which the rounds that hit many
    words pass partway: streams, ctl (NAFF, NPOS, DN_OLD and DN_NEW as full
    counts, DOVF), work and each side of the buffer as a multiset; past
    dcap, the kernel's entries a sub multiset of the round's."""
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk

    t0 = time.perf_counter()
    n_checks, n_ovf, most = 0, 0, 0
    for base in APPLY_BASES:
        groups = sparse_emit_groups(base, np.random.default_rng(base))
        rounds = edge_rounds(base) + [("split pairs", [(base, base + 1), (base, base)])]
        for n in EMIT_SHARDS:
            shards = sparse_emit_shards(groups, base, n, np.random.default_rng(base + n), dev)
            for what, cands in rounds:
                full = None
                for dcap in (1 << 20, EMIT_SMALL_DCAP):
                    ks = clone_shards(shards, dcap)
                    for st in ks:
                        set_round(st, cands, base + 100)
                    ps = clone_shards(ks)
                    launches = ssk.sparse_emit.launches
                    ssk.sparse_emit(ks)
                    label = f"sparse_emit, {what}, {n} shards, ids from {base}, dcap {dcap}"
                    check(ks[0].device.type != "cuda" or ssk.sparse_emit.launches == launches + 1,
                          f"{label}: {ssk.sparse_emit.launches - launches} launches")
                    check(all(a.ctl.numel() == ssk.EMIT_DONE + 1 and int(a.ctl[ssk.NPOS_RUN]) == 0
                              and int(a.ctl[ssk.EMIT_DONE]) == 0 for a in ks),
                          f"{label}: the emit's own ctl slots are not 0 after the launch")
                    for i, (a, b) in enumerate(zip(ks, ps)):
                        if b.n_words:
                            ssk.sparse_emit_plain(b)
                        same_shard(a, b, f"{label}, shard {i}", stream=("t",))
                        if not int(a.ctl[ssk.DOVF]):
                            continue
                        n_ovf += 1
                        for side in (0, 1):
                            ka, va = (x.cpu().numpy() for x in a.buffer(side))
                            kf, vf = full[i][side]
                            check(sub_multiset(ka, va, kf, vf),
                                  f"{label}, shard {i}: buffer side {side} is not a part of "
                                  f"the round's entries")
                    if dcap != EMIT_SMALL_DCAP:
                        check(not any(int(a.ctl[ssk.DOVF]) for a in ks), f"{label}: overflow")
                        full = [[tuple(x.cpu().numpy() for x in a.buffer(side)) for side in (0, 1)]
                                for a in ks]
                        most = max([most] + [int(a.ctl[ssk.NPOS]) for a in ks])
                    n_checks += 1
    check(n_ovf > 0, "no sparse_emit check passed its buffer")
    log(f"[11] sparse_emit (one launch for {EMIT_SHARDS} shards, an empty one among them) == "
        f"plain on {n_checks} edge rounds: tombstoned words of 1-600 positions, pairs split by "
        f"1-300 tombstones across 16-byte groups, lanes' 8 positions, 32-slot chunks and warps' "
        f"256 positions, runs split by tombstones, ids from {APPLY_BASES} (up to {most} "
        f"positions a shard a round); {n_ovf} shards' buffers of {EMIT_SMALL_DCAP} passed "
        f"partway ({time.perf_counter() - t0:.1f} s)")
    return {"checks": n_checks, "overflows": n_ovf}


def sub_multiset(ka, va, kf, vf) -> bool:
    """(ka, va) pairs are a sub multiset of (kf, vf) pairs."""
    from collections import Counter

    got, have = Counter(zip(ka.tolist(), va.tolist())), Counter(zip(kf.tolist(), vf.tolist()))
    return all(have[k] >= c for k, c in got.items())


def phase_relay_checks(dev) -> dict:
    """Both relays against their plain versions on crafted streams
    (``emit_edge_words``, ids from 5 and 70000): v2's (``relay``, every
    word kept) and the sharded engine's (``shard_relay``, words with fewer
    than two live tokens dropped), on the fresh stream (its 1-token word
    dropped, every other word kept; its dead slots none) and after a round
    that hits nearly every word (the (a, b) words merged to one token:
    dropped); streams, offsets, weights, word ids, ctl and work equal."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t0 = time.perf_counter()
    out = []
    for base in APPLY_BASES:
        rng = np.random.default_rng(base)
        t, wid, freq = flat_words(emit_edge_words(base, rng), rng)
        rules = np.full((base + 200, 4), -1, np.int32)
        many = dict(edge_rounds(base))["nearly every word hit"]
        st = tk.TrainState(t, wid, freq, rules, 0, 1 << 14, dev)
        sh = dsk.ShardState(t, wid, freq, rules, 0, 1 << 10, 1 << 20, dev)
        for merged in (False, True):
            if merged:
                for x in (st, sh):
                    set_round(x, many, base + 100)
                    tk.merge_listed_plain(x)
            k, p = clone_state(st), clone_state(st)
            tk.relay(k)
            tk.relay_plain(p)
            what = f"relay, ids from {base}, {'after a round' if merged else 'fresh'}"
            check(all(torch.equal(getattr(k, f), getattr(p, f)) for f in ("tok", "pwid", "off", "fw")),
                  f"{what}: the relaid streams differ")
            k, p = clone_shards([sh])[0], clone_shards([sh])[0]
            dsk.shard_relay(k)
            dsk.shard_relay_plain(p)
            for f in ("tok", "pwid", "off", "fw", "wid_dev", "ctl", "work"):
                check(torch.equal(getattr(k, f), getattr(p, f)), f"shard_{what}: {f} differs")
            check(k.n_words == p.n_words, f"shard_{what}: word counts differ")
            out.append((sh.n_words, k.n_words))
    log(f"[10] relay (every word kept) and shard_relay (words kept of words: {out}) == plain on "
        f"crafted streams, fresh and after a round ({time.perf_counter() - t0:.1f} s)")
    return {"kept": out}


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
            # round 0 launches both fold entries, round 1 the branch's alone
            rebuild = None if r == 0 else dcap == MID_DCAP
            rec = shard_round(ks, ps, used0, used0 + TRAIN_SEG, f"dcap {dcap}, round {r}",
                              rebuild)
            branches.setdefault(dcap, []).append("recount" if rec else "delta")
        log(f"[10] dcap {dcap}: two rounds, delta_emit, shard_recount and shard_fold (all "
            f"{SHARDS} replicas in one launch an entry; both entries, then the branch's) == "
            f"plain on every shard ({branches[dcap]}; {[int(a.ctl[dsk.DN_OLD]) for a in ks]} "
            f"old entries)")
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


def gate_checked(eng, what: str) -> dict:
    """Wrap ``eng.segment`` (a sharded v2 kernel engine's): on the round
    graph's route, every segment's recount branch runs, counted on the card,
    must equal its NREC, and the gate's runs the replays issued.  Returns the
    sums it keeps: segments, recount rounds (NREC), forced counts."""
    real = eng.segment
    sums = {"segments": 0, "nrec": 0}

    def segment(used, limit):
        out = real(used, limit)
        if eng.graph:
            check(eng.seg_rec_runs == eng.nrec and eng.gate_runs == eng.replays,
                  f"{what}: the recount branch ran {eng.seg_rec_runs} times for NREC {eng.nrec}, "
                  f"the gate {eng.gate_runs} times in {eng.replays} replays")
        sums["segments"] += 1
        sums["nrec"] += eng.nrec
        return out

    eng.segment = segment
    return sums


def phase_shard_mid(mid_path: Path, dev="cuda:0", ns=(2, 4)) -> dict:
    """The 10 MB prefix at vocab MID_VOCAB with ``ns`` shards on the card: the
    kernel engine on its route (the round graph on one card) and the plain
    sharded loop in lockstep, with tiny delta buffers (recount rounds) and
    small kernel tables (rebuilds): rules, used and done equal at every
    segment end, and every replica's table equal to the plain loop's live
    table (the engine checks that its replicas agree); every segment's
    recount branch runs (counted on the card) equal to its NREC; every relay
    held against its plain version."""
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
        gate = gate_checked(kern, f"{n} shards")
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
        check(kern.graph == (torch.device(dev).type == "cuda"), f"{n} shards: graph {kern.graph}")
        check(not kern.graph or kern.rec_runs == gate["nrec"],
              f"{n} shards: {kern.rec_runs} recount branch runs on the card for {gate['nrec']} "
              f"recount rounds")
        out[n] = {"segments": segs, "rebuilds": kern.rebuilds, "recounts": nrec, "relays": rel.n,
                  "replays": kern.replays, "graph_builds": kern.graph_builds}
        log(f"[10] 10 MB, vocab {MID_VOCAB}, {n} shards, dcap {MID_DCAP}: kernels (graph route "
            f"{kern.graph}: {kern.replays} replays, {kern.graph_builds} graphs built) == plain "
            f"sharded loop at all {segs} segment ends (rules, every replica's live table); "
            f"{kern.rebuilds} rebuilds, {nrec} recount rounds, the recount branch {kern.rec_runs} "
            f"runs on the card == NREC over all {gate['segments']} segments, {rel.n} relays "
            f"checked, plain pcap {plain.pcap}")
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
    engines = []

    class Recorded(dsk.ShardedKernelEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.gate = gate_checked(self, "train.train")
            engines.append(self)

    def sharded(*a, **k):
        calls["sharded"] += 1
        return real_sharded(*a, **k)

    def tiered(*a, **k):
        calls["tiered"] += 1
        return real_tiered(*a, **k)

    model_path = work / "trained30k_sharded.yttm"
    check("YTTM_TRAIN_IMPL" not in os.environ, "YTTM_TRAIN_IMPL is set")
    t0 = time.perf_counter()
    with swapped(tr, run_training_delta_sharded=sharded, run_training_tiered=tiered), swapped(
            dsk, ShardedKernelEngine=Recorded):
        tr.train(str(corpus_path), str(model_path), TRAIN_VOCAB,
                 BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)), device=dev, mesh=card_mesh(dev=dev))
    train_s = time.perf_counter() - t0
    t_phase = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    check(calls == {"sharded": 1, "tiered": 0}, f"auto on a mesh took {calls}")
    for k, n in launches.items():
        check(n > 0, f"the sharded main path did not launch {k}")
    # the round graph's route: one call a batch of rounds; the recount only
    # on the exchanges that recount (NREC's rounds, and the forced counts),
    # the fold one launch a round (an entry for every replica of the card)
    (te,) = engines
    on_card = torch.device(dev).type == "cuda"
    check(te.graph == on_card, f"the main path's route: graph {te.graph}")
    if on_card:
        rec = te.gate["nrec"] + te.count_exchanges
        check(launches["shard_recount"] == rec * SHARDS and te.rec_runs == te.gate["nrec"],
              f"shard_recount launched {launches['shard_recount']} times for {te.gate['nrec']} "
              f"recount rounds (the card counted {te.rec_runs}) and {te.count_exchanges} counts")
        check(launches["shard_fold"] == te.replays + te.count_exchanges
              and launches["topk_accept"] == te.replays * SHARDS,
              f"{launches} in {te.replays} replays and {te.count_exchanges} counts")
    log(f"[10] the main path's route: {te.replays} round graph replays ({te.gate_runs} gate runs "
        f"on the card) in {te.graph_builds} graphs built ({te.graph_build_s:.3f} s on the host), "
        f"{te.gate['nrec']} recount rounds, {te.count_exchanges} counts: shard_recount "
        f"{launches['shard_recount']} launches, shard_fold {launches['shard_fold']}")
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

    tracer = Tracer()
    library = LibrarySample()  # torch.topk's yardstick, in the traced run
    with swapped(dsk, shard_rounds=library.rounds(dsk.shard_rounds)):
        kernel_ms, prof_s, (p_eng, p_used) = traced(lambda: replica(TRAIN_VOCAB),
                                                    SHARD_DEVICE_FNS, tracer)
    check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules),
          "the profiled run's rules differ")
    # the records the tracer kept of the round graph's kernels, against their
    # runs (the gate's and the recount branch's counted on the card)
    rebuilds = p_eng.rec_runs + p_eng.count_exchanges
    want_events = {"round_gate_kernel": p_eng.gate_runs,
                   "fold_delta_kernel": p_eng.gate_runs - p_eng.rec_runs,
                   "rebuild_add_kernel": rebuilds, "pair_count_kernel": rebuilds * SHARDS,
                   "topk_select_kernel": p_eng.replays * SHARDS}
    got_events = tracer.ms({f: (f,) for f in want_events}, counts=True)
    log(f"[10] the tracer's records of the graph's kernels (records / runs): " + ", ".join(
        f"{f} {int(got_events[f])} / {n}" for f, n in want_events.items()))
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
            **{k: timed_plain(k, shard_plain(k)) for k in SHARD_KERNELS}):
        pe = shard_engine(buckets, used0, plain_vocab, dev=dev)
        pe.graph = False  # the per-call route, which the swapped wrappers serve
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
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "library_ms": library.ms(launches[k]) if k == "topk_accept" else None}
        rows.append(row)
        log(f"[10] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms over the "
            f"first {SHARD_PLAIN_IDS} ids (kernel {prefix_ms[k]:.3f} ms) ({card})"
            + library_note(row, library))
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
    "shard_fold": SHARD_FOLD_FNS,
    "shard_part_fold": ("part_prep_kernel", "part_fold_kernel"),
    "shard_gather": ("gather_kernel",),
    "sparse_emit": ("sparse_emit_kernel",),
    "sparse_shard_recount": ("recount_clear_kernel", "tomb_count_kernel"),
    "stream_shard_count": ("clear_kernel", "stream_count_kernel"),
    "apply_compact": ("apply_compact_kernel",),
    "bucket_shard_count": ("clear_kernel", "rows_count_kernel"),
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
# the shard-local wrappers that take every shard of a card (one launch)
CARD_WRAPPERS = ("sparse_emit", "apply_compact", "bucket_apply")
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

    # v1: both buffers (the one each round writes, the other that keeps its input)
    stream = STREAM_BUFFERS if name == "stream" else OTHER_STREAMS[name]
    V, kb = TRAIN_VOCAB, (1 if name == "bucketed" else 16)
    for k in OTHER_KERNELS[name]:
        home, fn = other_wrapper(name, k)
        plain = getattr(home, k + "_plain")
        rec = any(int(a.ctl[dsk.DOVF]) for a in ks)
        if k in ("shard_fold", "shard_gather"):
            # every replica of the card in one launch (of each entry)
            fn(ks, ks)
            for b in ps:
                plain(b, ps)
        elif k in CARD_WRAPPERS:  # every shard of the card in one launch
            fn(ks)
            for b in ps:
                if k != "sparse_emit" or b.n_words:
                    plain(b)
        for i, (a, b) in enumerate(zip(ks, ps)):
            if k in ("shard_fold", "shard_gather") + CARD_WRAPPERS:
                pass
            elif k == "topk_accept":
                fn(a, limit, V, used0, kb)
                plain(b, limit, V, used0, kb)
            elif k in ("sparse_shard_recount", "shard_part_fold"):
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


def part_fold_round(ks, ps, what: str) -> None:
    """The partitioned fold, kernels on the shards ``ks`` and plain versions
    on ``ps``: every replica's shard_part_fold, then every shard_gather,
    compared after each step."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.shard_part_fold(a, ks)
        dsk.shard_part_fold_plain(b, ps)
        same_shard(a, b, f"{what}, shard_part_fold on replica {i}", buffers=False,
                   stream=("t", "wid"))
    dsk.shard_gather(ks, ks)  # every replica of the card in one launch
    for i, (a, b) in enumerate(zip(ks, ps)):
        dsk.shard_gather_plain(b, ps)
        same_shard(a, b, f"{what}, shard_gather on replica {i}", buffers=False, stream=("t", "wid"))


def whole_part_copy(shards) -> list:
    """Each replica's table (keys, counts) with every other part p copied
    whole from replica p: what the gather must leave."""
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk

    n, cap = len(shards), shards[0].cap
    out = []
    for r, st in enumerate(shards):
        keys, cnts = st.keys.clone(), st.cnts.clone()
        for p, o in enumerate(shards):
            if p != r:
                lo, hi = dsk.part_lo(p, cap, n), dsk.part_lo(p + 1, cap, n)
                keys[lo:hi] = o.keys[lo:hi]
                cnts[lo:hi] = o.cnts[lo:hi]
        out.append((keys, cnts))
    return out


def gather_rounds(dev, kernel: bool) -> list:
    """The listed gather over GATHER_ROUNDS rounds on a FOLD_PARTS-shard mesh
    of sharded v1 shard states that persist over the rounds (their replica
    tables and fill lists carry over): each round every shard's scratch
    table and part lists are those of a fresh count of the round's pairs
    (``gather_round_pairs``), then every replica's shard_part_fold and the
    card's shard_gather, the kernels or (``kernel`` False) their plain
    versions; the tables regrow before round 2, as the engine's ``regrow``
    does.  After each gather every replica equals, slot for slot, the tables
    that the folds left with every other part copied whole from its owner
    (``whole_part_copy``); each replica's fill list of the round names the
    slots its own part holds; OVERFLOW is set on every replica in round 4 (a
    full part) and on none before.  Returns each round's replica tables and
    ctl."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import train_kernels as tk

    n, cap, shards, out = FOLD_PARTS, FOLD_CAP, None, []
    how = "kernels" if kernel else "plain"
    for r in range(GATHER_ROUNDS):
        if r == 2:
            cap *= 2
            for st in shards:
                st.resize(cap)
                st.ctl[tk.OVERFLOW] = 0
                st.ctl[rsk.ROVF] = 0
        fresh = [stream_shard_of(*pair_words(q), dev, cap) for q in gather_round_pairs(r)]
        for f in fresh:
            stream_count(f, not kernel)
        if shards is None:
            shards = fresh
        else:
            for st, f in zip(shards, fresh):
                for k in ("rkeys", "rcnts", "plist", "pcnt"):
                    getattr(st, k).copy_(getattr(f, k))
                st.ctl[rsk.ROCC] = f.ctl[rsk.ROCC]
                st.ctl[rsk.ROVF] = f.ctl[rsk.ROVF]
        for st in shards:
            (dsk.shard_part_fold if kernel else dsk.shard_part_fold_plain)(st, shards)
        want = whole_part_copy(shards)
        if kernel:
            dsk.shard_gather(shards, shards)
        else:
            for st in shards:
                dsk.shard_gather_plain(st, shards)
        what = f"the listed gather ({how}), round {r}, tables of {cap} slots"
        for i, st in enumerate(shards):
            check(torch.equal(st.keys, want[i][0]) and torch.equal(st.cnts, want[i][1]),
                  f"{what}: replica {i} != the whole-part copy")
            lo, hi = dsk.part_lo(i, cap, n), dsk.part_lo(i + 1, cap, n)
            filled = torch.nonzero(st.keys[lo:hi] != tk.EMPTY).flatten() + lo
            listed = st.fill_list(st.fill_next() ^ 1, i)  # the gather turned the lists
            check(r == 4 or torch.equal(listed, filled),
                  f"{what}: replica {i}'s fill list != its part's filled slots")
        ovf = [int(st.ctl[tk.OVERFLOW]) for st in shards]
        check(ovf == [int(r == 4)] * n, f"{what}: OVERFLOW {ovf}")
        slots = torch.nonzero(shards[0].keys != tk.EMPTY).flatten()
        check(r != 1 or not torch.equal(slots, out[-1][1]),
              f"{what}: the filled slots did not move")
        out.append(([(st.table(), st.ctl.clone()) for st in shards], slots))
    return [tabs for tabs, _ in out]


def phase_fill_gather_checks(dev) -> dict:
    """The listed gather (``gather_rounds``) through the kernels and through
    the plain versions: each equal to the whole-part copy slot for slot
    every round, OVERFLOW in the full part's round only; kernel and plain
    replicas the same tables (as multisets of entries) and ctl in every
    round but the full part's; the filled slots move between rounds."""
    import torch

    t0 = time.perf_counter()
    got, plain = gather_rounds(dev, True), gather_rounds(dev, False)
    for r, (ka, pa) in enumerate(zip(got, plain)):
        for i, (((kk, kc), kctl), ((pk, pc), pctl)) in enumerate(zip(ka, pa)):
            # a full part holds whichever keys claimed its slots first, and
            # its count stops at no fixed number
            if r == 4:
                continue
            check(np.array_equal(kk, pk) and np.array_equal(kc, pc),
                  f"the listed gather, round {r}: replica {i}'s table, kernels != plain")
            check(torch.equal(kctl.cpu(), pctl.cpu()),
                  f"the listed gather, round {r}: replica {i}'s ctl {kctl.tolist()} != "
                  f"{pctl.tolist()}")
    log(f"[11] the listed gather: {GATHER_ROUNDS} rounds on {FOLD_PARTS} replicas (keys leaving "
        f"and joining, a regrow before round 2, a full part in round 4): every replica == the "
        f"whole-part copy slot for slot, kernels and plain, kernels == plain "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"rounds": GATHER_ROUNDS}


ROW_STAGE = 512  # claims a block of v0's sharded count stages (csrc/part_list.cuh kListStage)
ROW_STAGE_IDS = 3000  # the ids of the rows that overfill it


def phase_part_fold_checks(dev) -> dict:
    """The counts' part lists and the partitioned fold (shard_part_fold,
    shard_gather) against their plain versions on crafted shards of a
    FOLD_PARTS-shard mesh (odd, so that the parts differ in size): v1's edge
    stream cut in three, counted and folded, every replica the whole
    stream's count; each replica's part folded again from scratch tables
    whose unlisted and other-part slots hold keys of that part, unchanged;
    then each of FOLD_CASES (tables of FOLD_CAP slots): OVERFLOW on every
    replica, kernel and plain, and after a list dropped claims the next
    count still empties every scratch slot, those no list names too; last,
    v0's count on rows whose blocks claim more slots than their stage holds
    (those claims listed one by one; 4 blocks), lists and all."""
    import torch

    from youtokentome_tpu_torch.ops import bucketed_kernels as bk
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops import train_kernels as tk

    t0 = time.perf_counter()
    n = FOLD_PARTS
    _, t, wid, freq = stream_edge_streams(5, np.random.default_rng(8))[0]
    uk, uc = td.host_count_table(t, wid, freq)
    live = int((t >= 0).sum())
    cuts = np.searchsorted(wid[:live], np.linspace(0, wid[live - 1] + 1, n + 1)[1:-1])
    ks = [stream_shard_of(np.r_[t[a:b], -1], np.r_[wid[a:b], -1], freq, dev, 1 << 12)
          for a, b in zip(np.r_[0, cuts], np.r_[cuts, live])]
    ps = [clone_state(st) for st in ks]
    for i, (a, b) in enumerate(zip(ks, ps)):
        stream_count(a, False)
        stream_count(b, True)
        same_shard(a, b, f"fold checks: shard {i}'s count", buffers=False, stream=("t", "wid"))
    counted = [clone_state(st) for st in ks]
    part_fold_round(ks, ps, "fold checks, v1's edge stream in 3")
    for i, st in enumerate(ks):
        keys, cnts = st.table()
        check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc)
              and not int(st.ctl[tk.OVERFLOW]), f"fold checks: replica {i} != the host count table")
    for r in range(n):
        clean = [clone_state(st) for st in counted]
        dirty = [clone_state(st) for st in counted]
        poison = pairs_of_part(n, r, 64, r)
        for st in dirty:
            keep = torch.zeros(st.cap, dtype=torch.bool, device=st.device)
            keep[st.part_list(r)] = True
            bad = torch.nonzero(~keep).flatten()
            xy = torch.from_numpy(poison[np.arange(bad.numel()) % len(poison)]).to(st.device)
            st.rkeys[bad] = (xy[:, 0] << 32) | xy[:, 1]
            st.rcnts[bad] = 1000
        for shards in (clean, dirty):
            for st in shards:
                st._links = None
            dsk.shard_part_fold(shards[r], shards)
        check(np.array_equal(dirty[r].table()[0], clean[r].table()[0])
              and np.array_equal(dirty[r].table()[1], clean[r].table()[1])
              and torch.equal(dirty[r].ctl, clean[r].ctl),
              f"fold checks: replica {r}'s fold read a scratch slot no part-{r} list names")
    cases = {}
    for case in FOLD_CASES:
        pairs = fold_case_pairs(case)
        ks = [stream_shard_of(*pair_words(q), dev) for q in pairs]
        ps = [clone_state(st) for st in ks]
        for i, (a, b) in enumerate(zip(ks, ps)):
            stream_count(a, False)
            stream_count(b, True)
            same_shard(a, b, f"fold checks, {case}: shard {i}'s count", buffers=False,
                       stream=("t", "wid"))
        rovf = [int(st.ctl[rsk.ROVF]) for st in ks]
        pcnt0 = int(ks[0].pcnt[0])
        for a, b in zip(ks, ps):
            dsk.shard_part_fold(a, ks)
            dsk.shard_part_fold_plain(b, ps)
        dsk.shard_gather(ks, ks)
        for b in ps:
            dsk.shard_gather_plain(b, ps)
        ovf = [int(st.ctl[tk.OVERFLOW]) for st in ks]
        check(ovf == [1] * n and [int(st.ctl[tk.OVERFLOW]) for st in ps] == [1] * n,
              f"fold checks, {case}: OVERFLOW kernel {ovf}, plain "
              f"{[int(st.ctl[tk.OVERFLOW]) for st in ps]}")
        check((case == "scratch overflow") == bool(rovf[0]) and not any(rovf[1:]),
              f"fold checks, {case}: ROVF {rovf}")
        if case == "list drops claims":
            st = ks[0]
            check(pcnt0 == 30, f"fold checks, {case}: part 0's count {pcnt0}")
            st.ctl[tk.OVERFLOW] = 0
            st.rkeys[st.rkeys == tk.EMPTY] = 7  # slots no list names
            stream_count(st, False)
            fresh = stream_shard_of(*pair_words(pairs[0]), dev)
            stream_count(fresh, True)
            what = f"fold checks, {case}: the next count"
            (ka, ca), (kb, cb) = scratch_table(st), scratch_table(fresh)
            check(np.array_equal(ka, kb) and np.array_equal(ca, cb)
                  and int(st.ctl[rsk.ROCC]) == int(fresh.ctl[rsk.ROCC]),
                  f"{what}: != a fresh count (a slot that no list named was kept)")
            same_lists(st, fresh, what)
        cases[case] = {"rovf": rovf, "pcnt0": pcnt0}
        log(f"[11] fold checks, {case}: kernels == plain, OVERFLOW on all {n} replicas (ROVF "
            f"{rovf}, part 0's list count {pcnt0} of {dsk.part_lo(1, FOLD_CAP, n)} slots)")
    # v0's listed count with more claims a block than its stage holds (v1's
    # past its stage: the edge streams of phase_stream_count_checks)
    rng = np.random.default_rng(9)
    rows = rng.integers(5, 5 + ROW_STAGE_IDS, (4 * 256, 600)).astype(np.int32)
    freq = rng.integers(0, 4, rows.shape[0]).astype(np.int32)  # a quarter of frequency 0
    vocab = 5 + ROW_STAGE_IDS + 16
    k_st = rsk.BucketedShardState([(rows, freq)], np.full((vocab, 4), -1, np.int32), vocab - 16,
                                  1 << 21, dev, n)
    p_st = clone_state(k_st)
    bk.COUNT_BLOCKS = 4
    try:
        rsk.bucket_shard_count(k_st, vocab, vocab)
    finally:
        bk.COUNT_BLOCKS = 0
    rsk.bucket_shard_count_plain(p_st, vocab, vocab)
    what = f"fold checks: v0's count of {rows.shape[0]} rows of {rows.shape[1]} random tokens"
    same_shard(k_st, p_st, what, buffers=False)
    rocc = int(k_st.ctl[rsk.ROCC])
    check(rocc > 4 * ROW_STAGE and not int(k_st.ctl[rsk.ROVF]),
          f"{what}: {rocc} claims over 4 blocks do not pass the stage's {ROW_STAGE} a block")
    log(f"[11] {what}: bucket_shard_count == plain, {rocc} claims over 4 blocks of 256 rows "
        f"(a block's stage holds {ROW_STAGE})")
    phase_fill_gather_checks(dev)
    log(f"[11] fold checks: v1's edge stream in {n} shards folded == the host count table, every "
        f"replica's fold unchanged by poisoned unlisted slots; {len(FOLD_CASES)} overflow cases "
        f"({time.perf_counter() - t0:.1f} s)")
    return cases


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
    phase_part_fold_checks(dev)
    phase_sparse_emit_checks(dev)
    t, wid, freq = ts.flatten_word_buckets(buckets)
    uk, uc = sp._host_table_tomb(np.asarray(t), np.asarray(wid), np.asarray(freq))
    for name in OTHER_TRAINERS:
        eng = other_engine(name, buckets, used0, TRAIN_VOCAB, dev=dev)
        if name == "sparse":
            for i, st in enumerate(eng.shards):
                keys, cnts = st.table()
                check(np.array_equal(keys, uk.astype(np.int64)) and np.array_equal(cnts, uc),
                      f"v3 replica {i}'s first count != the host count table")
            phase_tomb_checks("sparse_shard_recount", eng.shards[0], eng.shards, dev)
        branches = []
        for dcap in ((MID_DCAP, 1 << 22) if name == "sparse" else (0,)):
            ks, ps = clone_shards(eng.shards, dcap), clone_shards(eng.shards, dcap)
            for r in range(3 if name == "stream" else 2):  # v1: odd, as in phase_diff_kernels
                branches.append(other_round(name, ks, ps, used0, used0 + TRAIN_SEG,
                                            f"{name} sharded, dcap {dcap}, round {r}"))
        want = (["recount"] * 2 + ["delta"] * 2 if name == "sparse"
                else ["parts"] * (3 if name == "stream" else 2))
        check(branches == want, f"{name} sharded: the fold took {branches}, not {want}")
        sizes = [st.n_rows if name == "bucketed" else int((st.t >= 0).sum()) for st in eng.shards]
        log(f"[11] {name} sharded ({SHARDS} shards of {sizes} {'rows' if name == 'bucketed' else 'tokens'}, "
            f"tables {eng.shards[0].cap} slots): every kernel == its plain version for {r + 1} "
            f"rounds "
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
            gate = None
            if name == "sparse":
                # the main path's route, the round graph, at SHARDS shards;
                # the per-call route at fewer
                if n != SHARDS:
                    kern.graph = False
                check(kern.graph == (torch.device(dev).type == "cuda" and n == SHARDS),
                      f"v3, {n} shards: graph {kern.graph}")
                gate = gate_checked(kern, f"v3, {n} shards")
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
            route = ""
            if name == "sparse":
                check(kern.rebuilds >= 1 and nrec > 0,
                      f"v3, {n} shards: {kern.rebuilds} rebuilds, {nrec} recount rounds")
                check(not kern.graph or (kern.rec_runs == gate["nrec"] and kern.replays > 0),
                      f"v3, {n} shards: {kern.rec_runs} recount branch runs on the card for "
                      f"{gate['nrec']} recount rounds in {kern.replays} replays")
                route = (f"; the round graph ({kern.replays} replays, {kern.graph_builds} graphs "
                         f"built), the recount branch {kern.rec_runs} runs on the card == NREC "
                         f"over all {gate['segments']} segments, the gate {kern.gate_runs} runs"
                         if kern.graph else "; the per-call route")
            out[(name, n)] = {"segments": segs, "rebuilds": kern.rebuilds, "recounts": nrec}
            log(f"[11] 10 MB, {name} sharded to {vocab}, {n} shards: kernels == plain sharded loop "
                f"at all {segs} segment ends (streams, every replica's live table, rules); "
                f"{kern.rebuilds} rebuilds, {nrec} recount rounds, tables "
                f"{kern.shards[0].cap} slots{route}")
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
        out["bucket_apply"] = (head_rounds * slots_rows * 4 + int(w[bk.W_WRITES]) * 4,
                               head_rounds * slots_rows * OPS_PER_POS)
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

    def plain_of(k):
        if k == "shard_fold":
            return shard_plain(k)
        fn = getattr(other_wrapper(name, k)[0], k + "_plain")
        if k == "shard_gather":  # the wrapper takes the replicas of a card
            return lambda reps, shards: each_state(lambda st: fn(st, shards))(reps)
        # the wrappers that take a card's states
        return each_state(fn) if k in CARD_WRAPPERS else fn

    plain = {k: timed(k, plain_of(k)) for k in OTHER_KERNELS[name]}
    mod = ssk if name == "sparse" else rsk  # where the engine finds its wrappers
    own = {k: f for k, f in plain.items() if k != "shard_fold"}
    with swapped(mod, **own), swapped(dsk, **{k: plain[k] for k in ("shard_fold",) if k in plain}):
        eng = engine(vocab)
        eng.graph = False  # the per-call route, which the swapped wrappers serve
        used = ts.run_to_end(eng, used0, vocab)
    return ms, eng, used


def check_sparse_route(eng, launches: dict, tracer, on_card: bool) -> None:
    """The sharded v3 main path's route: on the card the round graph, the
    recount only on the exchanges that recount (NREC's rounds, counted on the
    card, and the forced counts), the fold one launch a round, the gate's
    runs the replays; the tracer's records of the graph's kernels logged
    against their runs."""
    check(eng.graph == on_card, f"the sharded v3 main path's route: graph {eng.graph}")
    if not on_card:
        return
    rec = eng.gate["nrec"] + eng.count_exchanges
    check(launches["sparse_shard_recount"] == rec * SHARDS and eng.rec_runs == eng.gate["nrec"],
          f"sparse_shard_recount launched {launches['sparse_shard_recount']} times for "
          f"{eng.gate['nrec']} recount rounds (the card counted {eng.rec_runs}) and "
          f"{eng.count_exchanges} counts")
    check(launches["shard_fold"] == eng.replays + eng.count_exchanges
          and launches["topk_accept"] == eng.replays * SHARDS
          and launches["sparse_emit"] == eng.replays and eng.gate_runs == eng.replays,
          f"{launches} in {eng.replays} replays ({eng.gate_runs} gate runs) and "
          f"{eng.count_exchanges} counts")
    rebuilds = eng.rec_runs + eng.count_exchanges
    want = {"round_gate_kernel": eng.gate_runs, "fold_delta_kernel": eng.gate_runs - eng.rec_runs,
            "rebuild_add_kernel": rebuilds, "tomb_count_kernel": rebuilds * SHARDS,
            "topk_select_kernel": eng.replays * SHARDS, "sparse_emit_kernel": eng.replays}
    got = tracer.ms({f: (f,) for f in want}, counts=True)
    log(f"[11] the sharded v3 main path's route: {eng.replays} round graph replays "
        f"({eng.gate_runs} gate runs on the card) in {eng.graph_builds} graphs built "
        f"({eng.graph_build_s:.3f} s on the host), {eng.gate['nrec']} recount rounds, "
        f"{eng.count_exchanges} counts: "
        f"sparse_shard_recount {launches['sparse_shard_recount']} launches, shard_fold "
        f"{launches['shard_fold']}; the tracer's records / runs: "
        + ", ".join(f"{f} {int(got[f])} / {n}" for f, n in want.items()))


def sparse_recount_events(engine, vocab: int, used0: int):
    """The sharded v3 loop to ``vocab`` once more on the per-call route,
    sparse_shard_recount timed by CUDA events at each launch that counts
    (some shard's DOVF set, read by the host), a sleep kernel ahead so that
    the host's enqueue is not timed: the runs that the round graph's recount
    branch makes.  Returns (ms, runs, the engine, used)."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
    from youtokentome_tpu_torch.ops import train_stream as ts

    real = ssk.sparse_shard_recount
    got = {"ms": 0.0, "runs": 0}

    def timed(st, shards, *rest):
        if not bool(torch.stack([s.ctl[dsk.DOVF] for s in shards]).any()):
            return real(st, shards, *rest)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        a.record()
        real(st, shards, *rest)
        b.record()
        b.synchronize()
        got["ms"] += a.elapsed_time(b)
        got["runs"] += 1

    timed.launches = 0
    with swapped(ssk, sparse_shard_recount=timed):
        eng = engine(vocab)
        eng.graph = False
        used = ts.run_to_end(eng, used0, vocab)
    return got["ms"], got["runs"], eng, used


def other_event_prefix(name: str, engine, vocab: int, used0: int) -> dict:
    """Device ms of each wrapper of the sharded trainer ``name`` over a run
    to ``vocab`` on the per-call route, by CUDA events around every call (a
    sleep kernel ahead of each, so that the host's enqueue is not timed)."""
    import torch

    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import recount_sharded_kernels as rsk
    from youtokentome_tpu_torch.ops import sparse_sharded_kernels as ssk
    from youtokentome_tpu_torch.ops import train_stream as ts

    ms = {k: 0.0 for k in OTHER_KERNELS[name]}

    def timed(k, fn):
        def run(*a, **kw):
            ea, eb = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
            ea.record()
            out = fn(*a, **kw)
            eb.record()
            eb.synchronize()
            ms[k] += ea.elapsed_time(eb)
            return out
        run.launches = 0
        return run

    fns = {k: timed(k, other_wrapper(name, k)[1]) for k in OTHER_KERNELS[name]}
    mod = ssk if name == "sparse" else rsk  # where the engine finds its wrappers
    own = {k: f for k, f in fns.items() if k != "shard_fold"}
    with swapped(mod, **own), swapped(dsk, **{k: f for k, f in fns.items() if k == "shard_fold"}):
        eng = engine(vocab)
        eng.graph = False
        ts.run_to_end(eng, used0, vocab)
    return ms


def phase_other_shard_main(corpus_path: Path, work: Path, sample, v2_rules, card: str,
                           select_keys: dict, dev="cuda:0", prepared=None) -> dict:
    """The main paths of row 13 on 4 shards of the card at vocab 30000, each
    run once under torch.profiler, its launches counted: ``train.train``
    with ``YTTM_TRAIN_IMPL=sparse`` and a mesh (the sharded v3 trainer; its
    model's rules equal phase 5's v2 rules, and it encodes and decodes),
    ``run_training_stream_sharded`` and ``run_training_sharded`` (v0 to its
    first V0_MAIN_IDS ids; rules equal phase 5's v2 rules, v0's their first
    V0_MAIN_IDS); the merge loop timed inside each run (from
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
                self.gate = gate_checked(self, f"the {name} sharded main path") if (
                    name == "sparse") else None

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
        vocab = min(TRAIN_VOCAB, used0 + V0_MAIN_IDS) if name == "bucketed" else TRAIN_VOCAB
        # the library yardsticks, in the main run: torch.topk (v3 on the round
        # graph's route), and Tensor.copy_ for the gather (v1, v0)
        library, gather_library = LibrarySample(), LibrarySample()
        samples = ({"shard_rounds": library.rounds(dsk.shard_rounds)} if name == "sparse" else
                   {"topk_accept": library.topk(rsk.topk_accept, SHARDS),
                    "shard_gather": gather_library.gather(rsk.shard_gather)})
        t0 = time.perf_counter()
        with swapped(mod, **{cls_name: Recorded}), swapped(
                dsk if name == "sparse" else rsk, **samples):
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
                    name, lambda: run(buckets, used0, vocab, mesh), tracer)
                check(got == v2_rules[: vocab - used0],
                      f"{name} sharded rules != the first {vocab - used0} of phase 5's v2 rules")
                what = f"parallel.{run.__module__.rsplit('.', 1)[1]}.{run.__name__} to vocab {vocab}"
        end = time.perf_counter()
        train_s = end - t0
        eng = engines[0]
        loop_s = end - marks[0]
        launches = {k: other_wrapper(name, k)[1].launches for k in OTHER_KERNELS[name]}
        for k, n in launches.items():
            check(n > 0, f"the {name} sharded main path did not launch {k}")
        if name != "sparse" and torch.device(dev).type == "cuda":  # one launch a card a round
            calls = sum(e.rounds for e in engines)
            exchanges = calls + sum(e.count_exchanges for e in engines)
            apply = "apply_compact" if name == "stream" else "bucket_apply"
            check(launches[apply] == calls and launches["shard_gather"] == exchanges,
                  f"{apply} launched {launches[apply]} times in {calls} rounds, shard_gather "
                  f"{launches['shard_gather']} times in {exchanges} exchanges")
        for k, v in kernel_ms.items():
            check(v > 0, f"the profiler recorded no device time for {name} sharded {k}")
        head = eng.shards[0]
        used = int(head.ctl[tk.USED])
        check(torch.equal(eng.rules[: used - used0, :3].cpu(), want_rules[: vocab - used0]),
              f"the {name} sharded engine's rules differ")
        merges, rounds = used - used0, int(head.ctl[tk.ROUND])
        w = np.sum([st.work.cpu().numpy() for st in eng.shards], axis=0)
        extra, res_extra = "", {}
        if name == "sparse":
            check_sparse_route(eng, launches, tracer, torch.device(dev).type == "cuda")
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
            route = "the round graph" if e.graph else "per call"
            log(f"[11] sparse sharded merge loop without the profiler ({route}): {loops[0]:.3f} s, "
                f"{loops[1]:.3f} s; its kernels {busy_s:.3f} s on the card under the profiler, "
                f"{busy_s / min(loops):.1%} of the faster loop ({card})")
            # the recount by CUDA events at the launches the graph's recount
            # branch makes (late in the script the tracer drops records)
            rec_ms, rec_runs, r_eng, r_used = sparse_recount_events(engine, TRAIN_VOCAB, used0)
            check(torch.equal(r_eng.rules[: r_used - used0, :3].cpu(), want_rules),
                  "the event-timed sharded v3 run's rules differ")
            check(rec_runs == launches["sparse_shard_recount"] and rec_ms > 0,
                  f"sparse_shard_recount timed at {rec_runs} runs, launched "
                  f"{launches['sparse_shard_recount']} times on the main path")
            log(f"[11] sparse_shard_recount by CUDA events at its {rec_runs} runs (the per-call "
                f"route, timed where some shard's DOVF is set): {rec_ms:.3f} ms; the profiler "
                f"{kernel_ms['sparse_shard_recount']:.3f} ms ({card})")
            kernel_ms["sparse_shard_recount"] = rec_ms
            tomb_state_check("sparse_shard_recount", eng.shards, "the 100 MB sharded v3 run")

        plain_ids = OTHER_PLAIN_IDS[name]
        plain_vocab = used0 + plain_ids
        if name == "sparse":
            # the kernels over the prefix by CUDA events at every launch (the
            # per-call route), which cannot read 0 as the tracer's records did
            prefix_ms = other_event_prefix(name, engine, plain_vocab, used0)
            for k, v in prefix_ms.items():
                check(v > 0, f"sharded v3 {k} over the first {plain_ids} ids: {v} ms")
        else:
            prefix_ms = other_profiled(name, lambda: replica(plain_vocab))[0]
        plain_ms, p_eng, p_used = plain_other(name, engine, plain_vocab, used0)
        check(torch.equal(p_eng.rules[: p_used - used0, :3].cpu(), want_rules[: p_used - used0]),
              f"the {name} sharded plain versions' rules differ")
        for k in OTHER_KERNELS[name]:
            b, o = work_bo[k]
            b_ms, o_ms = b / HBM_BYTES_PER_S * 1e3, o / OPS_PER_S * 1e3
            sample = {"topk_accept": library, "shard_gather": gather_library}.get(k)
            row = {"name": OTHER_ROW_NAMES.get((name, k), k), "trainer": name, "kernel": k,
                   "launches": launches[k], "ms": kernel_ms[k], "plain_ms": plain_ms[k],
                   "plain_ids": plain_ids, "prefix_ms": prefix_ms[k],
                   "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
                   "library_ms": sample.ms(launches[k]) if sample else None}
            rows.append(row)
            log(f"[11] {row['name']}: {launches[k]} launches, {kernel_ms[k]:.3f} ms on the card, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {plain_ms[k]:.1f} ms over the "
                f"first {plain_ids} ids (kernel {prefix_ms[k]:.3f} ms) ({card})"
                + (library_note(row, sample) if sample else ""))
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
            "library_ms": r["library_ms"], "equal": True,
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

# -- phase 12: multi-process training (parallel/distributed.py) --------------

DIST_RANKS = 2
DIST_SHARDS = 2  # shards a rank, all on card 0: 4 in all, as phase 10's mesh
DIST_TIMEOUT = 300  # s that the pair of workers may take for both runs
DIST_KERNELS = ("topk_accept",) + SHARD_KERNELS
DIST_PROBES = 500  # all_gathers of one round's ctl rows, timed alone


def rank_part(blob: bytes, rank: int) -> bytes:
    """Rank 0's or rank 1's part of a corpus: cut after the first
    whitespace byte past the middle, a word boundary (no byte of a UTF-8
    sequence is ASCII whitespace)."""
    cut = re.compile(rb"[ \t\n\v\f\r]").search(blob, len(blob) // 2).end()
    return blob[:cut] if rank == 0 else blob[cut:]


def dist_worker(rank: str, port: str, jobs_path: str, out_path: str) -> int:
    """One rank of phase 12 (``chip_smoke.py --dist-worker``): every job of
    ``jobs_path`` trained by ``train_from_codepoints_distributed`` on this
    rank's part of the corpus, on DIST_SHARDS shards of the job's device,
    each wrapper's launch count set to 0 just before and read just after;
    writes the rules, char2id, stderr, launches and the engine's figures."""
    import contextlib
    import io

    import torch

    from youtokentome_tpu_torch.host import utf8
    from youtokentome_tpu_torch.models.state import BpeConfig, SpecialTokens
    from youtokentome_tpu_torch.ops import delta_sharded_kernels as dsk
    from youtokentome_tpu_torch.ops import train_kernels as tk
    from youtokentome_tpu_torch.parallel import distributed as dist
    from youtokentome_tpu_torch.parallel.mesh import DataMesh

    rank = int(rank)
    spec = json.loads(Path(jobs_path).read_text())
    dist.initialize(f"localhost:{port}", DIST_RANKS, rank)
    # the floors of a round's exchange: the gather of one round's ctl rows
    # with no work between two calls, then with one launch and a read of
    # its result from the card before each (both ranks' contexts on it)
    comm = dist.HostGather()
    rows = torch.zeros(DIST_SHARDS, dsk.CTL_N, dtype=torch.int32)
    one = torch.ones(1, device=spec["dev"])
    out = {}
    for key, read in (("gather_us", False), ("gather_read_us", True)):
        for i in range(50 + DIST_PROBES):
            if i == 50:
                t0 = time.perf_counter()
            if read:
                rows[0, 0] = int((one + i).sum())
            comm.fixed(rows)
        out[key] = (time.perf_counter() - t0) / DIST_PROBES * 1e6
    wrappers = {"topk_accept": tk.topk_accept, **{k: getattr(dsk, k) for k in SHARD_KERNELS}}
    engines = []

    class Recorded(dsk.ProcessShardedEngine):
        """The engine, kept, with its merge loop's seconds (and its
        exchanges' part of them) and recount rounds summed over its
        segments and the collectives of its loop."""

        loop_s = 0.0
        exchange_s = 0.0
        recounts = 0

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.comm_start = (self.comm.calls, self.comm.bytes, self.comm.seconds)
            engines.append(self)

        def segment(self, used, limit):
            t0 = time.perf_counter()
            out = super().segment(used, limit)
            self.loop_s += time.perf_counter() - t0
            self.recounts += self.nrec
            return out

        def regrow(self):
            t0 = time.perf_counter()
            super().regrow()
            self.loop_s += time.perf_counter() - t0

        def _exchange(self, limit, recount=None):
            t0 = time.perf_counter()
            out = super()._exchange(limit, recount)
            self.exchange_s += time.perf_counter() - t0
            return out

    for job in spec["jobs"]:
        cps = utf8.decode_utf8_bytes(rank_part(Path(job["path"]).read_bytes(), rank),
                                     keep_invalid=True)
        err = io.StringIO()
        with env_set(YTTM_TRAIN_PCAP=str(job["pcap"])), swapped(
                dsk, ProcessShardedEngine=Recorded), contextlib.redirect_stderr(err):
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            state = dist.train_from_codepoints_distributed(
                cps, job["vocab"], BpeConfig(1.0, -1, SpecialTokens(0, 1, 2, 3)),
                device=spec["dev"], mesh=DataMesh([spec["dev"]] * DIST_SHARDS))
            train_s = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
        sys.stderr.write(err.getvalue())
        eng = engines.pop()
        calls, nbytes, secs = eng.comm_start
        out[job["name"]] = {
            "rules": state.rules, "char2id": sorted(state.char2id.items()),
            "stderr": err.getvalue(), "launches": launches, "train_s": train_s,
            "loop_s": eng.loop_s, "exchange_s": eng.exchange_s,
            "rounds": int(eng.head.ctl[tk.ROUND]),
            "recounts": eng.recounts, "rebuilds": eng.rebuilds, "relays": eng.relays,
            "cross_checks": eng.cross_checks, "dcap": eng.dcap, "cap": eng.head.cap,
            "words": [st.n_words for st in eng.local], "comm_calls": eng.comm.calls - calls,
            "comm_bytes": eng.comm.bytes - nbytes, "comm_s": eng.comm.seconds - secs,
            "comm_total_bytes": eng.comm.bytes, "comm_total_s": eng.comm.seconds,
        }
    Path(out_path).write_text(json.dumps(out))
    return 0


def phase_dist_main(corpus_path: Path, mid_path: Path, v2_rules, card: str,
                    dev="cuda:0") -> dict:
    """Multi-process training: DIST_RANKS processes (``dist_worker``), each
    with DIST_SHARDS shards on ``dev``, train the 100 MB corpus split at a
    word boundary at vocab 30000 through
    ``parallel.distributed.train_from_codepoints_distributed`` over gloo:
    rules and char2id equal to phase 5's v2 rules on every rank; every
    rank launched every kernel of rows 12a-12b; the engine's cross-rank
    replica check held at every segment end.  Then the 10 MB prefix at
    vocab MID_VOCAB with YTTM_TRAIN_PCAP pinned to the initial pair kinds:
    rank 0 prints the JAX host loop's overflow line, and the rules equal the
    one-process v2 kernel engine's.  The workers are killed on a failure
    or after DIST_TIMEOUT s."""
    import socket

    import torch

    from youtokentome_tpu_torch.models.state import SpecialTokens
    from youtokentome_tpu_torch.ops import train_delta as td
    from youtokentome_tpu_torch.ops.train_stream import flatten_word_buckets
    from youtokentome_tpu_torch.train import rename_tokens

    t_phase = time.perf_counter()
    work = corpus_path.parent
    mid_buckets, mid_al, mid_used0 = training_buckets(mid_path)
    kinds = td.host_count_table(*flatten_word_buckets(mid_buckets))[0].size
    pcap = td._next_pow2(kinds)
    mid_rules = td.run_training_delta(mid_buckets, mid_used0, MID_VOCAB, device=torch.device(dev))
    _, al, _ = training_buckets(corpus_path)
    special = SpecialTokens(0, 1, 2, 3)
    want = {"main": rename_tokens(al.char2id, v2_rules, special, TRAIN_VOCAB),
            "overflow": rename_tokens(mid_al.char2id, mid_rules, special, MID_VOCAB)}
    jobs = {"dev": str(dev), "jobs": [
        {"name": "main", "path": str(corpus_path), "vocab": TRAIN_VOCAB, "pcap": 0},
        {"name": "overflow", "path": str(mid_path), "vocab": MID_VOCAB, "pcap": pcap}]}
    jobs_path = work / "dist_jobs.json"
    jobs_path.write_text(json.dumps(jobs))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [work / f"dist_rank{r}.json" for r in range(DIST_RANKS)]
    logs = [work / f"dist_rank{r}.log" for r in range(DIST_RANKS)]
    for o in outs:
        o.unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(DIST_RANKS):
            with open(logs[r], "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--dist-worker", str(r),
                     str(port), str(jobs_path), str(outs[r])],
                    cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_TIMEOUT
        for r, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"check failed: rank {r} ran past {DIST_TIMEOUT} s") from None
        for r, proc in enumerate(procs):
            check(proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n"
                  + logs[r].read_text(errors="replace")[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    res = [json.loads(o.read_text()) for o in outs]
    for name, (char2id, rules) in want.items():
        for r, got in enumerate(res):
            g = got[name]
            check([tuple(x) for x in g["rules"]] == rules and
                  {int(k): int(v) for k, v in g["char2id"]} == char2id,
                  f"{name}: rank {r}'s rules or char2id != the one-process v2 trainer's")
            check(g["cross_checks"] > 0, f"{name}: rank {r} never checked the replicas across ranks")
        check(all(res[r][name]["stderr"] == "" for r in range(1, DIST_RANKS)),
              f"{name}: a rank other than 0 printed")
    line = "pair-count table overflow: retrying"
    check(line in res[0]["overflow"]["stderr"] and res[0]["overflow"]["rebuilds"] > 0,
          "the pinned-pcap run printed no overflow line on rank 0")
    if torch.device(dev).type == "cuda":
        for r, got in enumerate(res):
            for k in DIST_KERNELS:
                check(got["main"]["launches"][k] > 0, f"rank {r} did not launch {k}")
    for name, vocab in (("main", TRAIN_VOCAB), ("overflow", MID_VOCAB)):
        for r, got in enumerate(res):
            g = got[name]
            log(f"[12] {name}, vocab {vocab}, rank {r} of {DIST_RANKS} ({DIST_SHARDS} shards of "
                f"{g['words']} words on {dev}): train_from_codepoints_distributed {g['train_s']:.2f} s, "
                f"merge loop {g['loop_s']:.3f} s (its exchanges {g['exchange_s']:.3f} s), "
                f"{g['rounds']} rounds "
                f"({g['loop_s'] / max(g['rounds'], 1) * 1e3:.3f} ms a round), {g['recounts']} "
                f"recount rounds, {g['rebuilds']} rebuilds, {g['relays']} relays, dcap {g['dcap']}, "
                f"tables {g['cap']} slots; collectives in the loop: {g['comm_calls']} calls, "
                f"{g['comm_bytes']} B, {g['comm_s']:.3f} s (whole call: {g['comm_total_bytes']} B, "
                f"{g['comm_total_s']:.3f} s); {g['cross_checks']} cross-rank replica checks; "
                f"launches {g['launches']} ({card})")
    floors = ", ".join(f"rank {r} {got['gather_us']:.1f} ({got['gather_read_us']:.1f})"
                       for r, got in enumerate(res))
    log(f"[12] an all_gather of one round's ctl rows, {DIST_PROBES} times alone (after a launch "
        f"and a read of its result from the card): {floors} us a call ({card})")
    log(f"[12] {DIST_RANKS} gloo ranks x {DIST_SHARDS} shards on {dev}: rules == phase 5's v2 "
        f"rules (100 MB, vocab {TRAIN_VOCAB}) and == the one-process v2 kernels' (10 MB, vocab "
        f"{MID_VOCAB}, pcap pinned to {pcap} of {kinds} initial kinds: the overflow line on rank "
        f"0) on every rank; workers {wall_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s")
    return {"main": res[0]["main"], "overflow": res[0]["overflow"], "wall_s": wall_s}


# worker processes for the mid-size lockstep runs and phase 5's plain round
# loop: they time nothing that the record keeps, so they run side by side
# (each on the card), before any timed phase and with none beside them
CHECK_WORKERS = 6


def _check_worker_init() -> None:
    import torch

    torch.set_num_threads(1)


def run_checks(corpus_path: Path, mid_path: Path, beside) -> tuple:
    """Phase 5's v2 plain round loop over the 100 MB corpus and every
    mid-size lockstep run (phases 5, 6, 9, 10 and 11 on the 10 MB prefix),
    in CHECK_WORKERS spawned processes, while this process runs ``beside``
    (check-only phases: they time nothing either); a failed check fails the
    run.  Returns ({"plain_v2": (rules, seconds), ...}, beside's result)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, as_completed

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
        futs = {ex.submit(*job): k for k, job in jobs.items()}
        got = beside()
        log(f"[2] the checks beside the workers: {time.perf_counter() - t0:.1f} s")
        out = {}
        for f in as_completed(futs):
            out[futs[f]] = f.result()
            log(f"[2] check worker job {futs[f]} done at {time.perf_counter() - t0:.1f} s")
    log(f"[2] the check-only runs ({len(jobs)}) in {CHECK_WORKERS} worker processes: "
        f"{time.perf_counter() - t0:.1f} s")
    return out, got


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
    marks = [t_start]

    def mark(what: str) -> None:
        """Logs the seconds since the last mark and since the start."""
        marks.append(time.perf_counter())
        log(f"[t] {what}: {marks[-1] - marks[-2]:.1f} s (at {marks[-1] - t_start:.1f} s)")

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)

    info = phase_device_and_build()
    mark("phase 1, the build")
    corpus = build_corpus()
    corpus_path = work / "corpus_100mb.txt"
    corpus_path.write_text("\n".join(corpus[1]) + "\n")
    log(f"[3] corpus: {len(corpus[1])} lines, {len(corpus[0])}-word list "
        f"({time.perf_counter() - marks[-1]:.1f} s)")
    mid_path = write_prefix(corpus_path, work)
    mark("the corpus")

    def beside() -> dict:
        kchk = phase_kernel_checks()
        phase_encode_edges()
        phase_dropout_kernels(kchk)
        phase_dropout_edges(kchk["tables"])
        phase_stream_edges()
        phase_select_checks(dev)
        phase_apply_checks(dev)
        phase_resplit_checks(dev)
        phase_emit_checks(dev)
        phase_relay_checks(dev)
        # the kernels on the 100 MB corpus's state, against their plain versions
        buckets, _, used0 = training_buckets(corpus_path)
        phase_train_kernels(buckets, used0, dev)
        phase_tiered_kernels(buckets, used0, dev)
        phase_diff_kernels(buckets, used0, dev)
        phase_shard_kernels(buckets, used0)
        phase_other_shard_kernels(buckets, used0)
        return kchk

    checks, kchk = run_checks(corpus_path, mid_path, beside)
    mark("the check workers, and the edge checks beside them")
    main_res = phase_main_path(work, corpus)
    times = phase_times(info["card"], kchk, main_res)
    mark("phases 3-4, greedy encode")
    dropout = phase_dropout_main(main_res, corpus[1], info["card"])
    mark("phase 7, dropout")
    phase_stream_kernels(main_res, corpus[1])
    stream = phase_stream_main(main_res, corpus[1], info["card"])
    mark("phase 8, the stream backend")
    shard_enc = phase_shard_encode(main_res, corpus[1], times, info["card"])
    mark("phase 10, sharded encode")
    sample = corpus[1][:2000]
    del corpus, main_res["buckets"], main_res["ids"], main_res["cli"], main_res["blob"]
    train = phase_train_main(corpus_path, work, sample, checks["plain_v2"])
    mark("phase 5, v2")
    tiered = phase_tiered_main(corpus_path, work, sample, train["plain_rules"])
    mark("phase 6, v5")
    diff = phase_diff_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                           train["select_keys"])
    mark("phase 9, v1 v3 v4 v0")
    shard = phase_shard_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                             train["select_keys"])
    mark("phase 10, sharded v2")
    other = phase_other_shard_main(corpus_path, work, sample, train["plain_rules"], info["card"],
                                   {16: train["select_keys"], 1: diff["select_keys1"]},
                                   prepared=training_buckets(corpus_path))
    mark("phase 11, sharded v3 v1 v0")
    dist = phase_dist_main(corpus_path, mid_path, train["plain_rules"], info["card"])
    mark("phase 12, two processes")

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
            "ms": r["ms"], "plain_ms": r["plain_ms"], **prefix_keys(r), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "equal": True,
        }
        for r in train["rows"]
    ] + [
        {
            "name": r["name"], "route": "cuda", "source": "youtokentome_tpu_torch/csrc/train_tiered.cu",
            "replaces": TIERED_REPLACES[r["name"]], "launches": r["launches"], "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"], **prefix_keys(r), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "equal": True,
        }
        for r in tiered["rows"]
    ] + [
        {
            "name": r["name"], "route": "cuda", "source": source_of, "replaces": replaces_of,
            "launches": r["launches"], "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "equal": True,
            **{k: r[k] for k in ("merge_words_ms",) if k in r},
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
            "library_ms": r["library_ms"], "equal": True,
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
            "library_ms": r["library_ms"], "equal": True,
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
    log(f"[12] {DIST_RANKS} ranks x {DIST_SHARDS} shards on cuda:0 over gloo: merge loop "
        f"{dist['main']['loop_s']:.3f} s ({dist['main']['rounds']} rounds, "
        f"{dist['main']['recounts']} recount rounds), collectives {dist['main']['comm_s']:.3f} s "
        f"of it on rank 0 ({info['card']})")
    log(f"[4] build {info['build_s']:.2f} s, whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(info["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(*sys.argv[2:]))
    sys.exit(main())
