"""The JAX package's native host helpers, built once for every test worker.

``youtokentome_tpu/host/fasttok.py`` and ``fastio.py`` compile their
libraries in place on first use, with no temporary file.  Under several
pytest-xdist workers on a fresh tree, one worker can load a library that
another is still writing; the module then caches the failed load and its
native path is gone for the rest of that worker's tests.  The port's tests
that call into those modules run ``ensure_jax_native`` first: under a lock on
a file beside each library it builds a missing or stale library to a
temporary name with the module's own compiler command and renames it into
place, then loads it, clearing a failed load the module cached and retrying
while a worker that does not take the lock may still be writing the file.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time
from pathlib import Path

LOAD_TRIES = 50
LOAD_WAIT_S = 0.2


def _build(mod, source: str) -> None:
    so = Path(mod._SO)
    src = Path(mod._HERE) / source
    with open(f"{so}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++11", str(src), "-o", str(tmp)],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)


def _load(mod) -> None:
    for _ in range(LOAD_TRIES):
        with mod._lock:
            if mod._tried and mod._lib is None:
                mod._tried = False  # a failed load cached: try again
        if mod._load() is not None:
            return
        time.sleep(LOAD_WAIT_S)
    raise RuntimeError(f"{mod.__name__}: the native library did not load")


def ensure_jax_native() -> None:
    """Build (if needed) and load ``youtokentome_tpu.host.fasttok`` and
    ``fastio``'s libraries in this process."""
    from youtokentome_tpu.host import fastio, fasttok

    for mod, source in ((fasttok, "fasttok.cpp"), (fastio, "fastio.cpp")):
        _build(mod, source)
        _load(mod)
