"""youtokentome_tpu_torch: the BPE tokenizer on PyTorch and CUDA.

A port of ``youtokentome_tpu`` (JAX) to one NVIDIA H100.  Training runs
the v2 delta trainer's rounds in hand-written CUDA kernels
(``csrc/train_delta.cu``); encoding merges novel words in another
(``csrc/encode_greedy.cu``); both are built with ``nvcc`` at first use.
Rules, the ``.yttm`` model format, ids and CLI output are identical to
the JAX package's.  The v5 tiered trainer, BPE-dropout and the flat
stream backend come in later slices.
"""

from .api import BPE, OutputType

__all__ = ["BPE", "OutputType"]
__version__ = "0.1.0"
