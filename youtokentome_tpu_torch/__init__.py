"""youtokentome_tpu_torch: the BPE tokenizer on PyTorch and CUDA.

A port of ``youtokentome_tpu`` (JAX) to NVIDIA H100 cards.  It trains
with every trainer of the JAX package (the v5 tiered trainer, the v2
delta trainer, v2 sharded over a data mesh, and the differential
trainers v1, v3, v4 and v0), encodes greedily on the native and the flat
stream backends, with BPE-dropout, and shards greedy merges over a data
mesh.  Each device program of the JAX package is a hand-written CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use; on the CPU the
kernels' plain torch versions run.  Rules, the ``.yttm`` model format,
greedy ids and CLI output are identical to the JAX package's.
"""

from .api import BPE, OutputType

__all__ = ["BPE", "OutputType"]
__version__ = "0.1.0"
