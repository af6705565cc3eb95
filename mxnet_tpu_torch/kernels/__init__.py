"""The port's hand-written CUDA kernels and their plain versions.

- :mod:`.flash_decode` — single-query attention over the paged KV cache
  (``csrc/flash_decode.cu``);
- :mod:`.quantize` — int8 weight-only quantization and the int8 matmul
  behind ``QuantizedDense`` (``csrc/quantized_matmul.cu``);
- :mod:`._build` — builds both with ``nvcc`` at first use.
"""
from . import flash_decode, quantize   # noqa: F401
