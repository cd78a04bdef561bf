"""youtokentome_tpu_torch: the BPE tokenizer on PyTorch and CUDA.

A port of ``youtokentome_tpu`` (JAX) to one NVIDIA H100.  Encoding
merges novel words in a hand-written CUDA kernel
(``csrc/encode_greedy.cu``), built with ``nvcc`` at first use; the
``.yttm`` model format, ids and CLI output are identical to the JAX
package's.  Training, BPE-dropout and the flat stream backend come in
later slices.
"""

from .api import BPE, OutputType

__all__ = ["BPE", "OutputType"]
__version__ = "0.1.0"
