"""Module API: the intermediate and high-level training interface.

The port of ``mxnet_tpu/module/``: ``BaseModule`` (``fit``, ``score``,
``predict``), ``Module`` on one context with its executor group,
``BucketingModule``, ``SequentialModule`` and
``PythonModule``/``PythonLossModule``.
"""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup"]
