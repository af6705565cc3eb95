"""Bucket planning for the fused optimizer sweep.

Copies of ``partition_buckets`` and ``_nbytes`` from
``mxnet_tpu/parallel/overlap.py`` (framework-free there; ``_nbytes``
here also reads torch tensors).  The rest of that module (the async
device feed, gradient-bucket barriers and their ``MXTPU_BUCKET_MB``
target, the compile cache) belongs to the multi-GPU slice, so the
target is always given here.
"""
from __future__ import annotations

import numpy as _np

__all__ = ["partition_buckets"]


def partition_buckets(sized_items, bucket_nbytes):
    """Greedy size-targeted partition of ``[(key, nbytes), ...]`` into
    ``[[key, ...], ...]`` buckets, preserving input order.

    Every key lands in exactly one bucket; a single item larger than
    the target gets its own bucket.  ``bucket_nbytes`` of 0 means
    bucketing is off: everything lands in one all-covering bucket."""
    items = list(sized_items)
    if not items:
        return []
    if bucket_nbytes <= 0:
        return [[k for k, _ in items]]
    buckets, cur, cur_bytes = [], [], 0
    for key, nbytes in items:
        nbytes = int(nbytes or 0)
        if cur and cur_bytes + nbytes > bucket_nbytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _nbytes(x):
    """Bytes of a tensor or an array (0 when unknown)."""
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.element_size()) * int(x.numel())
    try:
        return int(_np.dtype(x.dtype).itemsize) * int(
            _np.prod(x.shape, dtype=_np.int64)) if x.shape else \
            int(_np.dtype(x.dtype).itemsize)
    except Exception:
        return 0
