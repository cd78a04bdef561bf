"""Build-at-first-use for the port's native libraries.

Every shared library is compiled from one source file of the checkout
into the build directory, and rebuilt when its source, or a header it
names, is newer than the library.  The build directory is
``$YTTM_TORCH_BUILD_DIR`` when that is set (an installed, read-only
package builds there), else ``youtokentome_tpu_torch/build/`` (listed in
``.gitignore``); the host libraries and the CUDA kernels share it.  The compiler writes
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

BUILD_DIR = Path(__file__).resolve().parent / "build"  # the default


def build_dir() -> Path:
    """``$YTTM_TORCH_BUILD_DIR`` when set, else ``BUILD_DIR``."""
    return Path(os.environ.get("YTTM_TORCH_BUILD_DIR") or BUILD_DIR)


def build_library(
    src: Path, name: str, compile_cmd: Sequence[str], deps: Sequence[Path] = ()
) -> Path:
    """Return ``build_dir()/name``, compiling ``src`` with ``compile_cmd``
    (the compiler and its flags, without source and output) when the
    library is missing or older than its source or one of ``deps`` (the
    headers it includes).  Raises RuntimeError with the compiler's output
    when the build fails."""
    root = build_dir()
    out = root / name
    newest = max(p.stat().st_mtime for p in (src, *deps))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    root.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=root, prefix=name + ".", suffix=".tmp")
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
