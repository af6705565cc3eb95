"""Module API: the intermediate and high-level training interface.

The port's slice of ``mxnet_tpu/module/``: ``BaseModule`` (``fit``,
``score``, ``predict``) and ``Module`` on one context, with its executor
group.  ``BucketingModule``, ``SequentialModule`` and ``PythonModule``
belong to later slices.
"""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
