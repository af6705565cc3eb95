"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference), with the same
module names and layout, running on an NVIDIA GPU.  It imports ``torch``
and never ``jax`` or ``mxnet_tpu``.  Four slices are ported:

- greedy generation of the transformer LM: ``Symbol -> Predictor ->
  Executor`` and ``serving.GenerationEngine`` over a paged KV cache,
  with hand-written CUDA kernels for flash-decode attention and the
  weight-only matmul (int8 or fp8 e4m3 weights);
- the in-process ``serving.ModelServer``: a continuous batcher that
  serves Symbol models and generative LMs side by side, with 429
  backpressure and ``serve`` telemetry (``observability``);
- training of the transformer LM on one GPU through
  ``parallel.ShardedTrainer``, with hand-written CUDA kernels for the
  flash-attention forward and the fused optimizer sweep;
- the imperative surface: ``nd`` (NDArray with views, arithmetic and
  the registered functions), the ``random`` samplers, and
  ``rtc.Rtc``, which compiles CUDA C kernel bodies at runtime with
  NVRTC and launches them on NDArrays.

The kernels (``csrc/``) are built with ``nvcc`` at first use.

``import mxnet_tpu_torch as mx``: ``mx.gpu(0)`` is a CUDA device, and
arrays and the entry points (``Predictor``, ``GenerationEngine``,
``serving.ModelServer``, ``models.transformer.generate``,
``parallel.ShardedTrainer``) run on
:func:`current_context`: ``gpu(0)`` unless a ``ctx`` argument or a
``with mx.cpu():`` scope says otherwise.
"""
from __future__ import annotations

from .base import MXNetError                      # noqa: F401
from .context import Context, cpu, gpu, tpu     # noqa: F401
from .context import current_context             # noqa: F401
from . import ndarray as nd                       # noqa: F401
from . import symbol as sym                       # noqa: F401
from .predictor import Predictor                  # noqa: F401
from . import kernels, models, serving            # noqa: F401
from . import observability, resilience           # noqa: F401
from . import optimizer, random, parallel         # noqa: F401
from . import initializer                         # noqa: F401
from . import initializer as init                 # noqa: F401
from . import rtc                                 # noqa: F401
