"""Build and load the port's CUDA kernels.

``csrc/encode_greedy.cu``, ``csrc/encode_dropout.cu``,
``csrc/stream_encode.cu``, ``csrc/train_topk.cu``, ``csrc/train_delta.cu``,
``csrc/train_tiered.cu``, ``csrc/train_stream.cu``, ``csrc/train_sparse.cu``,
``csrc/train_block.cu``, ``csrc/train_bucketed.cu``,
``csrc/train_delta_sharded.cu`` and ``csrc/train_sparse_sharded.cu`` have
plain C interfaces.  At first use
each is compiled by ``nvcc`` for ``sm_90a`` into the build directory
(``_build.build_dir()``; rebuilt when the source or a ``csrc/*.cuh``
header is newer) and loaded with ctypes.  A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

from .._build import build_library

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict = {}  # source name -> its loaded library
# one lock a source, so that the libraries build in parallel
_SOURCES = (
    "encode_greedy.cu", "encode_dropout.cu", "stream_encode.cu", "train_topk.cu",
    "train_delta.cu", "train_tiered.cu", "train_stream.cu", "train_sparse.cu", "train_block.cu",
    "train_bucketed.cu", "train_delta_sharded.cu", "train_sparse_sharded.cu",
)
_locks = {name: threading.Lock() for name in _SOURCES}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def _load(source: str, so_name: str, signatures) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (if needed) and load it once, with
    ``signatures`` {function: (restype, argtypes)}."""
    with _locks[source]:
        if source not in _libs:
            so = build_library(
                _CSRC / source, so_name, [_nvcc(), *NVCC_FLAGS], sorted(_CSRC.glob("*.cuh"))
            )
            lib = ctypes.CDLL(str(so))
            for fn, (res, args) in signatures.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _libs[source] = lib
        return _libs[source]


_p, _i, _u, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_long
# in, out, R, L, kx, ky, val, cap, max_probes, rules_z, n_rules
_ENCODE_COMMON = [_p, _p, _i, _i, _p, _p, _p, _i, _i, _p, _i]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the encode kernel's library."""
    return _load("encode_greedy.cu", "libencode_greedy.so", {
        "yttm_encode_greedy_i32": (_i, _ENCODE_COMMON + [_p]),  # stream
        "yttm_encode_greedy_u16": (_i, _ENCODE_COMMON + [_i, _p]),  # unk_id, stream
    })


def load_dropout() -> ctypes.CDLL:
    """Build (if needed) and load the BPE-dropout kernel's library."""
    return _load("encode_dropout.cu", "libencode_dropout.so", {
        # ..., seed_lo, seed_hi, row0, thr, work, stream
        "yttm_encode_dropout": (_i, _ENCODE_COMMON + [_u, _u, _u, _u, _p, _p]),
    })


def load_stream() -> ctypes.CDLL:
    """Build (if needed) and load the flat stream pipeline's kernels."""
    return _load("stream_encode.cu", "libstream_encode.so", {
        "yttm_stream_build_scratch": (_l, [_i]),
        # bytes, n, alpha_cps, alpha_ids, a, space_id, t, wid, m, ctl,
        # scratch, stream
        "yttm_stream_build": (_i, [_p, _i, _p, _p, _i, _i, _p, _p, _i, _p, _p, _p]),
        "yttm_stream_dedup_scratch": (_l, [_i]),
        # t, wid, m, n_tokens, ut, uwid, occ_uid, ustart, ulen, ctl, scratch,
        # stream
        "yttm_stream_dedup": (_i, [_p, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p]),
        "yttm_stream_merge_scratch": (_l, [_i]),
        # ut, m, ustart, ulen, n_unique, occ_uid, n_words, kx, ky, val, cap,
        # max_probes, rules_z, n_rules, out, pack, unk, ctl, scratch, stream
        "yttm_stream_merge": (_i, [_p, _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _p, _i, _p, _i,
                                   _i, _p, _p, _p]),
    })


def load_topk() -> ctypes.CDLL:
    """Build (if needed) and load the trainers' shared top-k."""
    return _load("train_topk.cu", "libtrain_topk.so", {
        # keys, cnts, cap, blk_hi, blk_lo, n_blk, ticket, ctl, cand, rules,
        # limit, vocab, used_ids0, k, n_own, work, stream
        "yttm_topk_accept": (_i, [_p, _p, _i, _p, _p, _i, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p,
                                  _p]),
    })


def load_train() -> ctypes.CDLL:
    """Build (if needed) and load the v2 delta trainer's kernels."""
    return _load("train_delta.cu", "libtrain_delta.so", {
        # tok, pwid, fw, Mw, keys, cnts, cap, ctl, stream
        "yttm_train_pair_count": (_i, [_p, _p, _p, _i, _p, _p, _i, _p, _p]),
        # tok, pwid, Mw, off, fw, keys, cnts, cap, ctl, cand, wmark, stream
        "yttm_train_apply_delta": (_i, [_p, _p, _i, _p, _p, _p, _p, _i, _p, _p, _p, _p]),
        "yttm_train_relay_scratch": (_l, [_i]),
        # tok, pwid, off, Mw, W, lens, new_off, scratch, totals, stream
        "yttm_train_relay_plan": (_i, [_p, _p, _p, _i, _i, _p, _p, _p, _p, _p]),
        # tok, pwid, Mw, off, fw, W, lens, new_off, tok2, pwid2, off2, fw2,
        # Mw2, stream
        "yttm_train_relay_write": (_i, [_p, _p, _i, _p, _p, _i, _p, _p, _p, _p, _p, _p, _i, _p]),
    })


def load_tiered() -> ctypes.CDLL:
    """Build (if needed) and load the tiered trainer's kernels."""
    return _load("train_tiered.cu", "libtrain_tiered.so", {
        # keys, cnts, cap, hkeys, hcnts, hslots, blk_hi, blk_lo, hn_blk,
        # fn_blk, ticket, ctl, cand, rules, limit, vocab, used_ids0, k, stream
        "yttm_tiered_select": (_i, [_p, _p, _i, _p, _p, _i, _p, _p, _i, _i, _p, _p, _p, _p, _i, _i,
                                    _i, _i, _p]),
        # tok, wid, freq, sig, B, NB, rows, hits, ctl, cand, keys, cnts,
        # cap, hkeys, hcnts, hslots, count_mode, kb1, kb2, stream
        "yttm_tiered_apply": (_i, [_p, _p, _p, _p, _i, _i, _p, _p, _p, _p, _p, _p, _i, _p, _p,
                                   _i, _i, _i, _i, _p]),
        # keys, cnts, cap, hkeys, hcnts, hslots, ctl, sel, slots, slot_cap,
        # cand, boundary, stream
        "yttm_tiered_resplit": (_i, [_p, _p, _i, _p, _p, _i, _p, _p, _p, _i, _p, _i, _p]),
        # out, then select's arguments but the stream (keys .. k), tok, wid,
        # freq, sig, B, NB, rows, hits, kb1, kb2, then sel, slots, slot_cap,
        # boundary
        "yttm_tiered_graph": (_i, [_p, _p, _p, _i, _p, _p, _i, _p, _p, _i, _i, _p, _p, _p, _p, _i,
                                   _i, _i, _i, _p, _p, _p, _p, _i, _i, _p, _p, _i, _i, _p, _p, _i,
                                   _i]),
        # graph, n, limit, stream
        "yttm_tiered_graph_launch": (_i, [_p, _i, _i, _p]),
        "yttm_tiered_graph_free": (_i, [_p]),
        "yttm_tiered_apply_grid": (_i, [_i]),  # B
        # tok, B, NB, fills, ghist, order, ctl, sel, stream
        "yttm_tiered_fold_plan": (_i, [_p, _i, _i, _p, _p, _p, _p, _p, _p]),
        # tok, wid, fills, order, B, NB, tok2, wid2, sig2, stream
        "yttm_tiered_fold_write": (_i, [_p, _p, _p, _p, _i, _i, _p, _p, _p, _p]),
    })


def load_stream_train() -> ctypes.CDLL:
    """Build (if needed) and load the v1 stream trainer's kernels."""
    return _load("train_stream.cu", "libtrain_stream.so", {
        # t0, w0, t1, w1, freq, M, keys, cnts, cap, ctl, limit, vocab, max_blocks,
        # stream
        "yttm_stream_recount": (_i, [_p, _p, _p, _p, _p, _i, _p, _p, _i, _p, _i, _i, _i, _p]),
        # t0, w0, t1, w1, freq, M, rkeys, rcnts, cap, ctl, plist, pcnt, n_parts,
        # limit, vocab, max_blocks, stream
        "yttm_stream_shard_count": (_i, [_p, _p, _p, _p, _p, _i, _p, _p, _i, _p, _p, _p, _i, _i,
                                         _i, _i, _p]),
        # rows, n_sh, slots, stream
        "yttm_stream_apply": (_i, [_p, _i, _l, _p]),
    })


def load_sparse() -> ctypes.CDLL:
    """Build (if needed) and load the v3 sparse trainer's kernels."""
    return _load("train_sparse.cu", "libtrain_sparse.so", {
        # t, pw, off, fw, M, keys, cnts, cap, ctl, max_blocks, stream
        "yttm_sparse_count": (_i, [_p, _p, _p, _p, _i, _p, _p, _i, _p, _i, _p]),
        # t, pw, off, fw, W, keys, cnts, cap, ctl, cand, aff, wmark, work,
        # stream
        "yttm_sparse_apply": (_i, [_p, _p, _p, _p, _i, _p, _p, _i, _p, _p, _p, _p, _p, _p]),
    })


def load_block() -> ctypes.CDLL:
    """Build (if needed) and load the v4 block trainer's kernels."""
    return _load("train_block.cu", "libtrain_block.so", {
        # tok, wid, freq, B, NB, keys, cnts, cap, ctl, stream
        "yttm_block_count": (_i, [_p, _p, _p, _i, _i, _p, _p, _i, _p, _p]),
        # tok, wid, freq, B, NL, ext, rows, KB, keys, cnts, cap, ctl, cand,
        # work, stream
        "yttm_block_apply": (_i, [_p, _p, _p, _i, _i, _p, _p, _i, _p, _p, _i, _p, _p, _p, _p]),
    })


def load_bucketed() -> ctypes.CDLL:
    """Build (if needed) and load the v0 bucketed trainer's kernels."""
    return _load("train_bucketed.cu", "libtrain_bucketed.so", {
        # tok, S, bk, nb, rfreq, keys, cnts, cap, ctl, limit, vocab, max_blocks,
        # stream
        "yttm_bucket_count": (_i, [_p, _i, _p, _i, _p, _p, _p, _i, _p, _i, _i, _i, _p]),
        # tok, S, bk, nb, rfreq, rkeys, rcnts, cap, ctl, plist, pcnt, n_parts,
        # limit, vocab, max_blocks, stream
        "yttm_bucket_shard_count": (_i, [_p, _i, _p, _i, _p, _p, _p, _i, _p, _p, _p, _i, _i, _i,
                                         _i, _p]),
        # rows, n_sh, slots, max_blocks, stream
        "yttm_bucket_apply": (_i, [_p, _i, _l, _i, _p]),
    })


def load_sharded() -> ctypes.CDLL:
    """Build (if needed) and load the sharded v2 trainer's kernels."""
    return _load("train_delta_sharded.cu", "libtrain_delta_sharded.so", {
        # shards, n_sh, dcap, stream
        "yttm_shard_delta_emit_card": (_i, [_p, _i, _i, _p]),
        # tok, pwid, fw, Mw, W, rkeys, rcnts, cap, ctl, ctls, n_sh, work, stream
        "yttm_shard_recount": (_i, [_p, _p, _p, _i, _i, _p, _p, _i, _p, _p, _i, _p, _p]),
        # reps, n_rep, cap, ctls, dks, dvs, dcap, n_sh, stream
        "yttm_shard_fold_delta": (_i, [_p, _i, _i, _p, _p, _p, _i, _i, _p]),
        # reps, n_rep, cap, ctls, rkeys, rcnts, n_sh, runs, stream
        "yttm_shard_fold_rebuild": (_i, [_p, _i, _i, _p, _p, _p, _i, _p, _p]),
        # out, shards, n_sh, reps, ctls, dks, dvs, rkeys, rcnts, dcap, topk,
        # emit, limit, vocab, used_ids0, k, n_own, runs
        "yttm_shard_graph": (_i, [_p, _p, _i, _p, _p, _p, _p, _p, _p, _i, _p, _p, _i, _i, _i, _i,
                                  _i, _p]),
        # graph, n, stream
        "yttm_shard_graph_launch": (_i, [_p, _i, _p]),
        "yttm_shard_graph_free": (_i, [_p]),
        # keys, cnts, cap, ctl, ctls, rkeys, rcnts, plists, pcnts, n_sh, self,
        # fill, work, stream
        "yttm_shard_part_fold": (_i, [_p, _p, _i, _p, _p, _p, _p, _p, _p, _i, _i, _p, _p, _p]),
        # reps, n_rep, cap, ctls, tkeys, tcnts, fills, n_sh, stream
        "yttm_shard_gather": (_i, [_p, _i, _i, _p, _p, _p, _p, _i, _p]),
        "yttm_shard_relay_scratch": (_l, [_i]),
        # tok, pwid, off, Mw, W, lens, keep, new_off, new_idx, scratch, totals,
        # stream
        "yttm_shard_relay_plan": (_i, [_p, _p, _p, _i, _i, _p, _p, _p, _p, _p, _p, _p]),
        # tok, pwid, Mw, off, fw, wids, W, lens, new_off, new_idx, tok2, pwid2,
        # off2, fw2, wids2, W2, Mw2, n2, stream
        "yttm_shard_relay_write": (_i, [_p, _p, _i, _p, _p, _p, _i, _p, _p, _p, _p, _p, _p, _p,
                                        _p, _i, _i, _i, _p]),
        # device, peer
        "yttm_shard_enable_peer": (_i, [_i, _i]),
    })


def load_sparse_sharded() -> ctypes.CDLL:
    """Build (if needed) and load the sharded v3 trainer's kernels."""
    return _load("train_sparse_sharded.cu", "libtrain_sparse_sharded.so", {
        "yttm_sparse_shard_ctl_n": (_i, []),
        # shards, n_sh, dcap, stream
        "yttm_sparse_shard_emit_card": (_i, [_p, _i, _i, _p]),
        # t, pw, off, fw, W, end, rkeys, rcnts, cap, ctl, ctls, n_sh, work,
        # max_blocks, stream
        "yttm_sparse_shard_recount": (_i, [_p, _p, _p, _p, _i, _i, _p, _p, _i, _p, _p, _i, _p, _i,
                                           _p]),
        # out, shards, n_sh, reps, ctls, dks, dvs, rkeys, rcnts, dcap, topk,
        # fold_delta, fold_rebuild, emit, limit, vocab, used_ids0, k, n_own,
        # runs
        "yttm_sparse_shard_graph": (_i, [_p, _p, _i, _p, _p, _p, _p, _p, _p, _i, _p, _p, _p, _p,
                                         _i, _i, _i, _i, _i, _p]),
        # graph, n, stream
        "yttm_sparse_shard_graph_launch": (_i, [_p, _i, _p]),
        "yttm_sparse_shard_graph_free": (_i, [_p]),
    })
