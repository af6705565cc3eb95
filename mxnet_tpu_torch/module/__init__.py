"""Module API: the intermediate and high-level training interface.

The port's slice of ``mxnet_tpu/module/``: ``BaseModule`` (``fit``,
``score``, ``predict``), ``Module`` on one context with its executor
group, ``SequentialModule`` and ``PythonModule``/``PythonLossModule``.
``BucketingModule`` belongs to a later slice.
"""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "SequentialModule", "PythonModule",
           "PythonLossModule", "DataParallelExecutorGroup"]
