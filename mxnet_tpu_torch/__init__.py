"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference), with the same
module names and layout, running on an NVIDIA GPU.  It imports ``torch``
and never ``jax`` or ``mxnet_tpu``.  This slice serves greedy generation
of the transformer LM: ``Symbol -> Predictor -> Executor`` and
``serving.GenerationEngine`` over a paged KV cache, with hand-written
CUDA kernels for flash-decode attention and the int8 weight-only matmul
(``csrc/``, built with ``nvcc`` at first use).

``import mxnet_tpu_torch as mx``: ``mx.gpu(0)`` is a CUDA device, and the
entry points (``Predictor``, ``GenerationEngine``,
``models.transformer.generate``) run there unless given ``ctx=mx.cpu()``.
"""
from __future__ import annotations

from .base import MXNetError                      # noqa: F401
from .context import Context, cpu, gpu, tpu     # noqa: F401
from . import ndarray as nd                       # noqa: F401
from . import symbol as sym                       # noqa: F401
from .predictor import Predictor                  # noqa: F401
from . import kernels, models, serving            # noqa: F401
