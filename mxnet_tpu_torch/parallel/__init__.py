"""parallel: training on a device mesh.

The port of ``mxnet_tpu/parallel``: meshes of one or several devices
(:func:`make_mesh`, :func:`auto_mesh`; data parallelism, over the GPUs
of a process and the processes of a ``torch.distributed`` group), the
sharding policy and arrays placed on a mesh (``sharding``), the
collectives between mesh members (``collectives``), :class:`ShardedTrainer`
(dp, ZeRO-1, FSDP, expert parallelism over an ``ep`` axis, tensor
parallelism over a ``tp`` axis, ``tensor_parallel``, and sequence
parallelism over an ``sp`` axis, ``sequence_parallel``),
:class:`ShardedPredictor`, the microbatched pipeline over a ``pp`` axis
(``pipeline``: :class:`GPipeTrainer`, GPipe and 1F1B), the
flash-attention function of training and ring attention over an sp
group (``ring_attention``), and the bucket planners of the gradient
reduction and the fused optimizer sweep (``overlap``).
"""
from .mesh import (Mesh, make_mesh, auto_mesh, local_device_count,  # noqa: F401
                   LogicalMesh, remesh)
from .sharding import (ShardingRules, ShardedArray, param_pspec,  # noqa: F401
                       batch_pspec, named_pspecs, parse_sharding)
from .overlap import (partition_buckets, bucket_bytes,  # noqa: F401
                      interleave_grad_buckets)
from .ring_attention import (attention_reference, flash_attention,  # noqa: F401
                             sharded_self_attention, sequence_parallel)
from .trainer import ShardedTrainer, ShardedPredictor  # noqa: F401
from .pipeline import (GPipeTrainer, pipeline_apply,  # noqa: F401
                       build_1f1b_tables, schedule_occupancy)

__all__ = ["Mesh", "make_mesh", "auto_mesh", "local_device_count",
           "LogicalMesh", "remesh", "ShardingRules", "ShardedArray",
           "param_pspec", "batch_pspec", "named_pspecs", "parse_sharding",
           "partition_buckets", "bucket_bytes", "interleave_grad_buckets",
           "attention_reference", "flash_attention", "sharded_self_attention",
           "sequence_parallel", "ShardedTrainer", "ShardedPredictor",
           "GPipeTrainer", "pipeline_apply", "build_1f1b_tables",
           "schedule_occupancy"]
