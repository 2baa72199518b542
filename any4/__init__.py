"""any4: 4-bit LLM quantization and inference in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
facebookresearch/any4 (ICML 2025): learned per-row 16-entry LUT quantization
(any4) plus int4/int8/nf4/fp4/MX4 group formats, a 4-bit lookup GEMV kernel
for decode-shaped workloads on Hopper GPUs, a vectorized on-device
quantization pipeline, an evaluation harness, and a sharded serving path
over device meshes.
"""

__version__ = "0.1.0"

from .ops import packing, quant, formats  # noqa: F401
from .quant import kmeans, anyq  # noqa: F401
