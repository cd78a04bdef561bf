"""Build and load the port's CUDA kernels.

``csrc/encode_greedy.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``youtokentome_tpu_torch/build/``
(rebuilt when the source is newer) and loaded with ctypes.  A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

from .._build import build_library

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "encode_greedy.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


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


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            so = build_library(_SRC, "libencode_greedy.so", [_nvcc(), *NVCC_FLAGS])
            lib = ctypes.CDLL(str(so))
            p, i = ctypes.c_void_p, ctypes.c_int
            # in, out, R, L, kx, ky, val, cap, max_probes, rules_z, n_rules
            common = [p, p, i, i, p, p, p, i, i, p, i]
            lib.yttm_encode_greedy_i32.restype = i
            lib.yttm_encode_greedy_i32.argtypes = common + [p]  # stream
            lib.yttm_encode_greedy_u16.restype = i
            lib.yttm_encode_greedy_u16.argtypes = common + [i, p]  # unk_id, stream
            _lib = lib
        return _lib
