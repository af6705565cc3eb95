"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference), with the same
module names and layout, running on an NVIDIA GPU.  It imports ``torch``
and never ``jax`` or ``mxnet_tpu``.  These slices are ported:

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
  NVRTC and launches them on NDArrays;
- image-classification training on one GPU: ``models.resnet``
  (Convolution, BatchNorm, Pooling), every optimizer of the JAX package
  and ``lr_scheduler``, through ``parallel.ShardedTrainer`` (the fused
  sweep has a CUDA body for every elementwise optimizer) and through
  ``mod.Module.fit`` (``io.NDArrayIter``, ``metric``, ``callback``,
  ``kvstore.create("local")``, ``model``'s checkpoints), with the model
  zoo (``alexnet``, ``vgg``, ``googlenet``, ``inception_bn``,
  ``inception_v3``: Concat, LRN), the executor's mirroring
  (``force_mirroring``, ``MXNET_BACKWARD_DO_MIRROR``) and
  ``ShardedTrainer(remat=True)``, Symbol arithmetic and
  ``Symbol.grad``, the ``Monitor``, ``SequentialModule``,
  ``PythonModule`` and ``FeedForward``;
- the image feed: ``recordio`` (files byte for byte the JAX package's),
  ``io.ImageRecordIter`` over the native decode pool (``engine``,
  ``lib/libmxtpu.so`` built from ``src/`` at first use), ``image``,
  ``nd.imdecode``, ``MNISTIter``/``CSVIter``/``ResizeIter``/
  ``PrefetchingIter``, and ``parallel.overlap.DevicePrefetcher`` (pinned
  host buffers copied on a stream of its own), which feeds
  ``ShardedTrainer.prefetch_feed`` and ``Module.fit(prefetch=True)``;
- Python operators (``operator``: ``CustomOp``/``CustomOpProp`` with
  ``register`` and the ``Custom`` op, the legacy ``NumpyOp``/
  ``NDArrayOp``), whose bodies run on host numpy arrays, and the ops of
  Faster R-CNN (``ROIPooling``, ``BlockGrad``, ``SoftmaxActivation``)
  with the rest of the JAX package's op registry but ``MoE``;
- observability: step statistics and MFU at the card's own peak
  (``ShardedTrainer.emit_telemetry_counters``), the pod aggregate, the
  SLO sentry and the live SLO engine, the retrace and lock sanitizers,
  ``profiler`` over ``torch.profiler``, and the ``mxtop``, ``mxtrace``
  and ``benchdiff`` tools (``python -m mxnet_tpu_torch.tools.<name>``).

The kernels (``csrc/``) are built with ``nvcc`` at first use.

``import mxnet_tpu_torch as mx``: ``mx.gpu(0)`` is a CUDA device, and
arrays and the entry points (``Predictor``, ``GenerationEngine``,
``serving.ModelServer``, ``models.transformer.generate``,
``parallel.ShardedTrainer``, ``mod.Module``) run on
:func:`current_context`: ``gpu(0)`` unless a ``ctx`` argument or a
``with mx.cpu():`` scope says otherwise.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError                      # noqa: F401
from .context import Context, cpu, gpu, tpu     # noqa: F401
from .context import cpu_pinned, num_gpus, num_tpus  # noqa: F401
from .context import current_context             # noqa: F401
from .attribute import AttrScope                  # noqa: F401
from . import ndarray as nd                       # noqa: F401
from . import symbol as sym                       # noqa: F401
from . import operator                            # noqa: F401
sym._init_symbol_module()   # the creators of the ops operator registers
from .predictor import Predictor                  # noqa: F401
from . import kernels, models, serving            # noqa: F401
from . import observability, resilience           # noqa: F401
from . import optimizer, random, parallel         # noqa: F401
from . import initializer                         # noqa: F401
from . import initializer as init                 # noqa: F401
from . import rtc                                 # noqa: F401
from . import lr_scheduler, metric, callback      # noqa: F401
from . import io, kvstore, model                  # noqa: F401
from . import kvstore as kv                       # noqa: F401
from . import kvstore_server                       # noqa: F401
# a process launched as a parameter server or scheduler parks here
# (parity: reference __init__.py:35 _init_kvstore_server_module)
kvstore_server._init_kvstore_server_module()
from . import engine, image, recordio             # noqa: F401
from . import module                              # noqa: F401
from . import module as mod                       # noqa: F401
from . import executor, executor_manager, monitor  # noqa: F401
from . import profiler                            # noqa: F401
from .model import FeedForward                    # noqa: F401
from .monitor import Monitor                      # noqa: F401
