"""Packaging for youtokentome_tpu.

Mirrors the reference's build story (setup.py:7-19: one native extension
compiled with -O3) for the TPU rebuild: the two native host helpers
(`_fasttok.so`, `_fastio.so` — plain C ABI shared libraries loaded via
ctypes, no Python headers needed) are compiled by ``build_ext`` and
shipped inside the wheel, so installed environments never invoke the
import-time compile-on-demand fallback (host/fasttok.py keeps that
fallback for source checkouts).
"""

import subprocess
from pathlib import Path

from setuptools import Extension, find_packages, setup
from setuptools.command.build_ext import build_ext


HOST_DIR = Path(__file__).parent / "youtokentome_tpu" / "host"
NATIVE_LIBS = ["_fasttok", "_fastio"]  # built from <name minus _>.cpp


class BuildCtypesLibs(build_ext):
    """Compile the ctypes shared libraries with the host toolchain.

    These are not CPython extensions (no Python.h), so we bypass the
    compiler abstraction and call g++ exactly like the import-time
    fallback does (host/fasttok.py / host/fastio.py)."""

    def build_extension(self, ext):
        name = ext.name.rsplit(".", 1)[-1]
        src = HOST_DIR / (name.lstrip("_") + ".cpp")
        out = Path(self.get_ext_fullpath(ext.name))
        out = out.parent / (name + ".so")  # fixed name for the ctypes loader
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++11",
            str(src), "-o", str(out),
        ]
        subprocess.run(cmd, check=True)


setup(
    name="youtokentome_tpu",
    version="0.2.0",
    description="TPU-native unsupervised text tokenizer: fast Byte Pair Encoding on JAX/XLA",
    long_description=(Path(__file__).parent / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(
        include=[
            "youtokentome_tpu", "youtokentome_tpu.*",
            "youtokentome_tpu_torch", "youtokentome_tpu_torch.*",
        ]
    ),
    # the torch port compiles its CUDA kernels and host helpers at first
    # use (youtokentome_tpu_torch/_build.py), so only the sources ship:
    # every .cu file and the .cuh headers they include
    package_data={
        "youtokentome_tpu.host": ["*.cpp", "*.so"],
        "youtokentome_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "youtokentome_tpu_torch.host": ["*.cpp"],
    },
    ext_modules=[
        Extension(f"youtokentome_tpu.host.{n}", sources=[]) for n in NATIVE_LIBS
    ],
    cmdclass={"build_ext": BuildCtypesLibs},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "click>=4.0"],
    # the PyTorch/CUDA port: pip install "youtokentome_tpu[torch]"
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "yttm-tpu = youtokentome_tpu.cli:main",
            "yttm-torch = youtokentome_tpu_torch.cli:main",
        ],
    },
    classifiers=[
        "Programming Language :: Python :: 3",
        "Operating System :: POSIX :: Linux",
        "Topic :: Text Processing :: Linguistic",
    ],
)
