"""Shared plumbing of the port's kernel modules.

A copy of ``env_flag`` from ``mxnet_tpu/kernels/common.py``.  The rest of
that module (``resolve_interpret``, ``pick_block``) decides between a
Pallas kernel, its interpret mode and a jnp fallback on a TPU; the port
has none of those: a wrapper launches its CUDA kernel for a CUDA tensor
and runs its plain PyTorch version for a CPU tensor.
"""
from __future__ import annotations

import os as _os

__all__ = ["env_flag"]


def env_flag(name, default=""):
    """Env knob value, lower-cased; '' when unset."""
    return _os.environ.get(name, default).strip().lower()
