"""The port's hand-written CUDA kernels and their plain versions.

- :mod:`.flash_decode` — single-query attention over the paged KV cache
  (``csrc/flash_decode.cu``);
- :mod:`.quantize` — int8 weight-only quantization and the int8 matmul
  behind ``QuantizedDense`` (``csrc/quantized_matmul.cu``);
- :mod:`.flash_attention` — the flash-attention forward of training
  (``csrc/flash_attention.cu``);
- :mod:`.fused_opt` — the fused optimizer sweep of ``ShardedTrainer``
  (``csrc/fused_opt.cu``);
- :mod:`._build` — builds them with ``nvcc`` at first use.
"""
from . import flash_decode, quantize, flash_attention, fused_opt  # noqa: F401
