"""The port's hand-written CUDA kernels and their plain versions.

- :mod:`.flash_decode` — single-query attention over the paged KV cache
  (``csrc/flash_decode.cu``);
- :mod:`.quantize` — int8 weight-only quantization and the int8 matmul
  behind ``QuantizedDense`` (``csrc/quantized_matmul.cu``);
- :mod:`.flash_attention` — the flash-attention forward of training
  (``csrc/flash_attention.cu``);
- :mod:`.fused_opt` — the fused optimizer sweep of ``ShardedTrainer``
  (``csrc/fused_opt.cu``);
- :mod:`.rtc_kernels` — CUDA C kernel bodies compiled at runtime through
  ``rtc.Rtc``;
- :mod:`._build` — builds the ``csrc/`` kernels with ``nvcc`` at first
  use; :mod:`.nvrtc` — the NVRTC and CUDA driver binding behind
  ``rtc.Rtc`` (imported only when a kernel is compiled or launched).
"""
from . import flash_decode, quantize, flash_attention, fused_opt  # noqa: F401
from . import rtc_kernels                                          # noqa: F401
