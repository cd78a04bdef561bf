"""An installed torch port builds its kernels: every header a CUDA source
includes ships as package data, the port has its console script and its
``torch`` extra, and the build directory can be moved.  Read from
``setup.py`` without building anything.  Also: the port's CLI decode
batches its writes into a pipe and flushes per line on a terminal, with
the JAX package's bytes either way."""

import fnmatch
import io
import re
import sys
from distutils.core import run_setup
from pathlib import Path

import pytest
from click.testing import CliRunner

from youtokentome_tpu import cli as jcli
from youtokentome_tpu.models.state import BpeConfig, SpecialTokens
from youtokentome_tpu.oracle import train_from_codepoints
from youtokentome_tpu_torch import _build, cli

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "youtokentome_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def dist():
    argv = sys.argv[:]
    try:
        return run_setup(str(REPO / "setup.py"), stop_after="init")
    finally:
        sys.argv[:] = argv


def test_every_included_header_ships(dist):
    patterns = dist.package_data["youtokentome_tpu_torch"]
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert len(sources) > 10
    includes = set()
    for src in sources:
        assert any(fnmatch.fnmatch(f"csrc/{src.name}", p) for p in patterns), src.name
        includes |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert {"train_common.cuh", "encode_common.cuh", "scan.cuh", "word_apply.cuh"} <= includes
    for name in includes:
        assert (CSRC / name).is_file(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name


def test_console_script_and_torch_extra(dist):
    scripts = dist.entry_points["console_scripts"]
    assert "yttm-torch = youtokentome_tpu_torch.cli:main" in scripts
    assert "yttm-tpu = youtokentome_tpu.cli:main" in scripts
    assert dist.extras_require == {"torch": ["torch"]}
    assert "torch" not in dist.install_requires  # the JAX package's install unchanged
    assert "youtokentome_tpu_torch.parallel" in dist.packages


def test_build_dir_can_be_moved(tmp_path, monkeypatch):
    """``YTTM_TORCH_BUILD_DIR`` moves where every library is built."""
    monkeypatch.setenv("YTTM_TORCH_BUILD_DIR", str(tmp_path / "elsewhere"))
    src = tmp_path / "k.cu"
    src.write_text("source")
    # a stand-in compiler: copies the source to the output
    cmd = [sys.executable, "-c", "import shutil, sys; shutil.copy(sys.argv[1], sys.argv[3])"]
    out = _build.build_library(src, "libk.so", cmd)
    assert out == tmp_path / "elsewhere" / "libk.so" and out.read_text() == "source"
    monkeypatch.delenv("YTTM_TORCH_BUILD_DIR")
    assert _build.build_dir() == _build.BUILD_DIR


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    text = "abc abd bcd " * 40 + "aab bba ccd dda"
    cps = [ord(c) for c in text]
    import numpy as np

    st = train_from_codepoints(np.array(cps, np.uint32), 20, BpeConfig(1.0, 1, SpecialTokens(0, 1, 2, 3)))
    path = tmp_path_factory.mktemp("m") / "m.yttm"
    st.dump(str(path))
    return str(path)


IDS = "5 6 7 \n\n1 8 9 10 \n12 13 14 15 16 17 18 19\n4 5"


def test_decode_into_a_pipe(model):
    """Into a pipe (not a terminal) the port's decode gives the JAX
    package's bytes."""
    args = ["decode", f"--model={model}", "--ignore_ids=1"]
    ours = CliRunner().invoke(cli.main, args, input=IDS)
    theirs = CliRunner().invoke(jcli.main, args, input=IDS)
    assert ours.exit_code == 0 and theirs.exit_code == 0
    assert ours.stdout_bytes == theirs.stdout_bytes and ours.stdout_bytes.count(b"\n") == 5


class _Out(io.BytesIO):
    def __init__(self):
        super().__init__()
        self.flushes = 0

    def flush(self):
        self.flushes += 1


class _Std:
    def __init__(self, buffer, tty):
        self.buffer = buffer
        self._tty = tty

    def isatty(self):
        return self._tty


@pytest.mark.parametrize("tty", [False, True])
def test_decode_flushes_per_line_only_on_a_terminal(model, tty, monkeypatch):
    out = _Out()
    monkeypatch.setattr(sys, "stdin", _Std(io.BytesIO(IDS.encode()), False))
    monkeypatch.setattr(sys, "stdout", _Std(out, tty))
    cli.decode.callback(model, None)
    want = CliRunner().invoke(jcli.main, ["decode", f"--model={model}"], input=IDS).stdout_bytes
    assert out.getvalue() == want
    assert out.flushes == (6 if tty else 1)  # a flush a line, and one at the end
