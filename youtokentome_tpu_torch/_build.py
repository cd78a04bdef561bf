"""Build-at-first-use for the port's native libraries.

Every shared library is compiled from one source file of the checkout
into ``youtokentome_tpu_torch/build/`` (listed in ``.gitignore``), and
rebuilt when its source, or a header it names, is newer than the library.  The compiler writes
to a private temporary name that is then renamed into place, so
processes that build at the same time (test workers) never load a
half-written file.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent / "build"


def build_library(
    src: Path, name: str, compile_cmd: Sequence[str], deps: Sequence[Path] = ()
) -> Path:
    """Return ``BUILD_DIR/name``, compiling ``src`` with ``compile_cmd``
    (the compiler and its flags, without source and output) when the
    library is missing or older than its source or one of ``deps`` (the
    headers it includes).  Raises RuntimeError with the compiler's output
    when the build fails."""
    out = BUILD_DIR / name
    newest = max(p.stat().st_mtime for p in (src, *deps))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=name + ".", suffix=".tmp")
    os.close(fd)
    try:
        res = subprocess.run(
            [*compile_cmd, str(src), "-o", tmp], capture_output=True, text=True
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"building {name} from {src.name} failed "
                f"(exit {res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
