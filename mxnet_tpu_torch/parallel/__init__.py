"""parallel: training on a device mesh.

The port's slice of ``mxnet_tpu/parallel``: a mesh of one GPU
(:func:`make_mesh`), :class:`ShardedTrainer` on it, the flash-attention
function of training (``ring_attention``), and the bucket planner of the
fused optimizer sweep (``overlap``).  Meshes of several GPUs, ring
attention, ZeRO/FSDP and pipelines come with the multi-GPU slice.
"""
from .mesh import Mesh, make_mesh                      # noqa: F401
from .overlap import partition_buckets                 # noqa: F401
from .ring_attention import (attention_reference, flash_attention,  # noqa: F401
                             sharded_self_attention, sequence_parallel)
from .trainer import ShardedTrainer                    # noqa: F401

__all__ = ["Mesh", "make_mesh", "partition_buckets",
           "attention_reference", "flash_attention", "sharded_self_attention",
           "sequence_parallel", "ShardedTrainer"]
