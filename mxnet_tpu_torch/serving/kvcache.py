"""Block-paged KV cache for generative serving (PagedAttention-style).

The port of ``mxnet_tpu/serving/kvcache.py``.  Keys and values of every
active sequence live in fixed-size **blocks** inside one pool per layer,
and a per-sequence **block table** names which pool blocks hold its
tokens (vLLM's PagedAttention, SOSP'23).  Two halves:

- **Device pools**: per layer one K and one V tensor shaped
  ``(num_blocks, block_size, num_heads, head_dim)`` on the engine's
  device.  ``CachedMultiHeadAttention`` writes into them in place and
  returns them, and :meth:`PagedKVCache.set_pools` installs what a step
  returned.
- **Host allocator**: a free list of block ids with reserve-at-admission
  semantics.  A sequence's whole budget, ``ceil((prompt_len +
  max_new_tokens) / block_size)`` blocks, is claimed at admission;
  a short free list raises :class:`CacheExhausted` (structured
  backpressure) instead of failing mid-decode.

Block 0 is the **trash block**: never allocated, never read unmasked.
Padded batch rows and padded prompt positions route their writes to it.

Under tensor parallelism the pools split on their head axis over the
``tp`` members of a mesh (:func:`cache_sharding_rules`,
:meth:`PagedKVCache.shard_pools`): member ``j`` holds ``(num_blocks,
block_size, num_heads / tp, head_dim)`` of every pool on its own device,
and ``CachedMultiHeadAttention``'s tensor-parallel form writes and reads
only those.

The sizes come from the JAX package's knobs, with its defaults:
``MXTPU_SERVE_KV_BLOCKS`` pool blocks (256, trash block included),
``MXTPU_SERVE_KV_BLOCK_SIZE`` tokens a block (32) and
``MXTPU_SERVE_MAX_NEW_TOKENS`` new tokens a request (64), each read by
:func:`kv_blocks`, :func:`kv_block_size` and :func:`max_new_tokens`
when no explicit value is given; an unparsable value means the default.
"""
from __future__ import annotations

import os as _os
import threading

import numpy as _np
import torch

from ..analysis.tiling import register_kernel_spec
from ..base import MXNetError

__all__ = ["KVCacheConfig", "PagedKVCache", "CacheExhausted", "TRASH_BLOCK",
           "kv_blocks", "kv_block_size", "max_new_tokens",
           "cache_sharding_rules",
           "DEFAULT_KV_BLOCKS", "DEFAULT_KV_BLOCK_SIZE",
           "DEFAULT_MAX_NEW_TOKENS"]

#: block id reserved as the write target for padded positions/rows;
#: never allocated to a sequence, never read by attention
TRASH_BLOCK = 0
DEFAULT_KV_BLOCKS = 256
DEFAULT_KV_BLOCK_SIZE = 32
DEFAULT_MAX_NEW_TOKENS = 64


def _knob(explicit, env, default):
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get(env, str(default)))
    except ValueError:
        return default


def kv_blocks(explicit=None):
    """Pool size in blocks (``MXTPU_SERVE_KV_BLOCKS``, default 256,
    including the reserved trash block)."""
    return _knob(explicit, "MXTPU_SERVE_KV_BLOCKS", DEFAULT_KV_BLOCKS)


def kv_block_size(explicit=None):
    """Tokens per cache block (``MXTPU_SERVE_KV_BLOCK_SIZE``, default
    32)."""
    return _knob(explicit, "MXTPU_SERVE_KV_BLOCK_SIZE",
                 DEFAULT_KV_BLOCK_SIZE)


def max_new_tokens(explicit=None):
    """Per-request generation cap (``MXTPU_SERVE_MAX_NEW_TOKENS``,
    default 64), also the decode half of the admission block budget."""
    return _knob(explicit, "MXTPU_SERVE_MAX_NEW_TOKENS",
                 DEFAULT_MAX_NEW_TOKENS)

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CacheExhausted(MXNetError):
    """Admission-time block-budget rejection, carrying ``blocks_free``."""

    def __init__(self, blocks_needed, blocks_free, blocks_total):
        self.blocks_needed = int(blocks_needed)
        self.blocks_free = int(blocks_free)
        self.blocks_total = int(blocks_total)
        super(CacheExhausted, self).__init__(
            "kv cache exhausted: need %d blocks, %d free of %d"
            % (self.blocks_needed, self.blocks_free, self.blocks_total))

    def to_dict(self):
        return {"error": "kv_cache_exhausted",
                "blocks_needed": self.blocks_needed,
                "blocks_free": self.blocks_free,
                "blocks_total": self.blocks_total}


class KVCacheConfig(object):
    """Static shape of one model's cache: pool and table geometry.

    ``max_seq_len`` is the per-sequence ceiling (prompt + generated); it
    fixes the block-table width.  ``dtype`` is ``"float32"`` or
    ``"bfloat16"`` (the types the flash-decode kernel reads).
    """

    def __init__(self, num_layers, num_heads, head_dim, max_seq_len,
                 num_blocks=None, block_size=None, dtype="float32"):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.max_seq_len = int(max_seq_len)
        self.block_size = kv_block_size(block_size)
        self.num_blocks = kv_blocks(num_blocks)
        if str(dtype) not in _TORCH_DTYPES:
            raise MXNetError("kv cache dtype must be one of %s, got %r"
                             % (sorted(_TORCH_DTYPES), dtype))
        self.dtype = str(dtype)
        if self.block_size < 1 or self.num_blocks < 2:
            raise MXNetError(
                "kv cache needs block_size >= 1 and num_blocks >= 2 "
                "(block 0 is reserved), got block_size=%d num_blocks=%d"
                % (self.block_size, self.num_blocks))
        self.blocks_per_seq = -(-self.max_seq_len // self.block_size)

    @property
    def pool_shape(self):
        return (self.num_blocks, self.block_size, self.num_heads,
                self.head_dim)

    @property
    def torch_dtype(self):
        return _TORCH_DTYPES[self.dtype]

    def blocks_for(self, n_tokens):
        """Blocks covering ``n_tokens`` cache slots."""
        return max(1, -(-int(n_tokens) // self.block_size))

    def to_dict(self):
        return {"num_layers": self.num_layers,
                "num_heads": self.num_heads, "head_dim": self.head_dim,
                "max_seq_len": self.max_seq_len,
                "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "blocks_per_seq": self.blocks_per_seq,
                "dtype": self.dtype}


def cache_sharding_rules(tp_axis="tp", mesh=None):
    """:class:`~mxnet_tpu_torch.parallel.sharding.ShardingRules` that
    split the cache pools head-wise over ``tp_axis`` (pool dim 2) and
    keep the block tables whole: ordered regexes over array names, the
    first match winning (the JAX package's rules)."""
    from ..parallel.sharding import P, ShardingRules
    return ShardingRules([
        (r".*_(k|v)_cache$",
         lambda shape, m, _a=tp_axis: P(None, None, _a, None)),
        (r".*block_table$", lambda shape, m: P(*([None] * len(shape)))),
    ], mesh=mesh)


class _Sequence(object):
    __slots__ = ("seq_id", "blocks", "table_row")

    def __init__(self, seq_id, blocks, table_row):
        self.seq_id = seq_id
        self.blocks = blocks
        self.table_row = table_row


class PagedKVCache(object):
    """Host-side block allocator + owner of the device pools.

    Thread-safe.  The pools are zero tensors on ``device``, allocated
    here once; steps update them in place.
    """

    def __init__(self, config, device):
        self.config = config
        self._lock = threading.Lock()
        self._free = list(range(config.num_blocks - 1, TRASH_BLOCK, -1))
        self._seqs = {}
        self._high_water = 0
        shape, dt = config.pool_shape, config.torch_dtype
        self.k_pools = [torch.zeros(shape, dtype=dt, device=device)
                        for _ in range(config.num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dt, device=device)
                        for _ in range(config.num_layers)]

    # -- allocation --------------------------------------------------------

    def blocks_total(self):
        return self.config.num_blocks - 1          # trash block excluded

    def blocks_free(self):
        with self._lock:
            return len(self._free)

    def blocks_used(self):
        with self._lock:
            return self.blocks_total() - len(self._free)

    def can_admit(self, n_tokens):
        """Whether a sequence of ``n_tokens`` cache slots fits the free
        list now."""
        with self._lock:
            return self.config.blocks_for(n_tokens) <= len(self._free)

    def allocate(self, seq_id, n_tokens):
        """Reserve the whole ``n_tokens`` block budget for ``seq_id`` and
        return its block-table row (``(blocks_per_seq,)`` int32, unused
        slots pointing at the trash block).  Raises
        :class:`CacheExhausted` without side effects when the free list
        is short."""
        need = self.config.blocks_for(n_tokens)
        if n_tokens > self.config.max_seq_len:
            raise MXNetError(
                "sequence of %d tokens exceeds max_seq_len %d"
                % (n_tokens, self.config.max_seq_len))
        with self._lock:
            if seq_id in self._seqs:
                raise MXNetError("sequence %r already allocated" % (seq_id,))
            if need > len(self._free):
                raise CacheExhausted(need, len(self._free),
                                     self.blocks_total())
            blocks = [self._free.pop() for _ in range(need)]
            row = _np.full((self.config.blocks_per_seq,), TRASH_BLOCK,
                           dtype=_np.int32)
            row[:need] = blocks
            self._seqs[seq_id] = _Sequence(seq_id, blocks, row)
            self._high_water = max(
                self._high_water, self.blocks_total() - len(self._free))
            return row.copy()

    def table_row(self, seq_id):
        """A copy of ``seq_id``'s block-table row."""
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            return seq.table_row.copy()

    def active(self):
        """The allocated sequence ids, sorted."""
        with self._lock:
            return sorted(self._seqs)

    def free(self, seq_id):
        """Return a finished sequence's blocks to the free list (LIFO);
        freeing an unknown id is a bookkeeping bug and raises."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            self._free.extend(reversed(seq.blocks))
            return len(seq.blocks)

    # -- device pools ------------------------------------------------------

    def set_pools(self, k_pools, v_pools):
        """Install the pools a prefill/decode step returned (the same
        tensors, updated in place, in the port)."""
        if len(k_pools) != self.config.num_layers \
                or len(v_pools) != self.config.num_layers:
            raise MXNetError("pool update has %d/%d layers, want %d"
                             % (len(k_pools), len(v_pools),
                                self.config.num_layers))
        self.k_pools = list(k_pools)
        self.v_pools = list(v_pools)

    def shard_pools(self, mesh, tp_axis="tp"):
        """Place the pools on ``mesh`` per :func:`cache_sharding_rules`:
        each pool a :class:`~mxnet_tpu_torch.parallel.sharding.ShardedArray`
        split on its head axis over ``tp_axis`` (whole on every member
        when the mesh has no such axis).  Returns the applied
        PartitionSpec."""
        from ..parallel.sharding import place
        rules = cache_sharding_rules(tp_axis=tp_axis, mesh=mesh)
        spec = rules.match("layer0_k_cache", self.config.pool_shape)
        tp = mesh.shape.get(tp_axis, 1)
        if self.config.num_heads % tp:
            raise MXNetError("shard_pools: %d heads do not divide over %s=%d"
                             % (self.config.num_heads, tp_axis, tp))

        self.k_pools = [place(p, mesh, spec) for p in self.k_pools]
        self.v_pools = [place(p, mesh, spec) for p in self.v_pools]
        return spec

    # -- stats -------------------------------------------------------------

    def occupancy(self):
        """The share of the allocatable blocks in use."""
        with self._lock:
            total = self.blocks_total()
            return (total - len(self._free)) / float(total) if total else 0.0

    def stats(self):
        with self._lock:
            total = self.blocks_total()
            used = total - len(self._free)
            return {"blocks_total": total, "blocks_used": used,
                    "blocks_free": len(self._free),
                    "occupancy": round(used / float(total), 4)
                    if total else 0.0,
                    "seqs_active": len(self._seqs),
                    "blocks_high_water": self._high_water,
                    "block_size": self.config.block_size}


def cache_kernel_spec(config=None, dtype=None):
    """MXL-K spec of the pool layout as the flash-decode kernel reads it
    (``csrc/flash_decode.cu``): a head's row of ``head_dim`` elements and
    a block of ``block_size * num_heads * head_dim`` are read as 16-byte
    pieces, so each must be a multiple of 16 bytes for the pools to stay
    on the kernel's vector route.  The counterpart of the JAX package's
    ``cache_kernel_spec``, which declares the same geometry as a Pallas
    block.  ``dtype`` overrides the config's."""
    cfg = config or KVCacheConfig(num_layers=1, num_heads=8, head_dim=64,
                                  max_seq_len=kv_block_size() * 4)
    dt = str(dtype or cfg.dtype).replace("torch.", "")
    return {
        "name": "paged_kv_cache[%s]" % dt,
        "origin": "mxnet_tpu_torch/serving/kvcache.py",
        "vectors": [
            {"name": "k/v head row", "extent": cfg.head_dim, "dtype": dt},
            {"name": "k/v block",
             "extent": cfg.block_size * cfg.num_heads * cfg.head_dim,
             "dtype": dt}],
    }


register_kernel_spec(
    "paged_kv_cache",
    lambda: [cache_kernel_spec(dtype=dt) for dt in ("float32", "bfloat16")])
