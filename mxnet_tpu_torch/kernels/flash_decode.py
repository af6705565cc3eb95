"""Flash-decode: single-query attention over the paged KV cache.

The port of ``mxnet_tpu/kernels/flash_decode.py``.  One new query per
sequence attends over that sequence's cache blocks, named by its
block-table row (serving/kvcache.py), with positions ``> pos`` masked.

- :func:`decode_attention_reference` is the plain PyTorch version
  (gather the table's blocks, softmax, contract), with the JAX
  signature.  It runs for tensors on the CPU, and it is what the CUDA
  kernel is compared with on the GPU.
- :func:`flash_decode_attention` is the wrapper of the hand-written
  CUDA kernel ``csrc/flash_decode.cu``: each row's cache blocks split
  across thread blocks (:func:`plan_flash_decode`), partial softmax
  states combined in split order by the last block of each (row, head)
  to finish, in one launch.  For CUDA tensors it launches the
  kernel or raises; there is no flag that turns it off.
  ``flash_decode_attention.launches`` counts its launches.
"""
from __future__ import annotations

import math
import threading

import torch

from ..base import MXNetError
from ..observability.metrics import register_kernel_counters

__all__ = ["decode_attention_reference", "flash_decode_attention",
           "plan_flash_decode"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the widest head the kernel takes: every attention model of the JAX
#: package fits (``models/transformer.py`` and ``transformer_moe.py``:
#: dim / num_heads, 256 / 8 = 32 by default, 512 / 8 = 64 as benchmarked)
MAX_HEAD_DIM = 256
#: thread blocks an SM the split aims at when every row is full
CTAS_PER_SM = 4


def decode_attention_reference(q, k_pool, v_pool, table, pos, scale=None):
    """Gather + softmax decode attention.  ``q (B, H, D)``, pools
    ``(NB, BS, H, D)``, ``table (B, MB)`` int, ``pos (B,)`` int (the
    newest token's index).  Returns ``(B, H, D)`` in q's dtype.

    ``pos`` is meant to be >= 0, as the engine's always is.  For a row
    with ``pos < 0`` every slot is masked alike, so this version, the
    CUDA kernel, and the JAX package's reference and Pallas kernel all
    return the plain average of ``v`` over every slot of the row's
    table.  Table entries are clamped into ``[0, NB)``, as the JAX
    reference's gather clamps those past the pool."""
    B, H, D = q.shape
    BS = k_pool.shape[1]
    MB = table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    t = table.long().clamp(0, k_pool.shape[0] - 1)
    kk = k_pool[t].reshape(B, MB * BS, H, D).to(q.dtype)
    vv = v_pool[t].reshape(B, MB * BS, H, D).to(q.dtype)
    s = torch.einsum("bhd,bthd->bht", q, kk) * scale
    t_idx = torch.arange(MB * BS, device=q.device)
    s = torch.where(t_idx[None, None, :] <= pos.long()[:, None, None], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bht,bthd->bhd", p, vv.to(p.dtype))
    return o.to(q.dtype)


def _check_inputs(q, k_pool, v_pool, table, pos):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise MXNetError("flash_decode: q must be (B, H, D) and the pools "
                         "(NB, BS, H, D), got %s and %s"
                         % (tuple(q.shape), tuple(k_pool.shape)))
    B, H, D = q.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) \
            or tuple(k_pool.shape[2:]) != (H, D):
        raise MXNetError("flash_decode: pools %s / %s do not match q %s"
                         % (tuple(k_pool.shape), tuple(v_pool.shape),
                            tuple(q.shape)))
    if table.dim() != 2 or table.shape[0] != B or tuple(pos.shape) != (B,):
        raise MXNetError("flash_decode: table must be (B, MB) and pos (B,) "
                         "for B=%d, got %s and %s"
                         % (B, tuple(table.shape), tuple(pos.shape)))
    if q.dtype not in _DTYPE_CODES or k_pool.dtype not in _DTYPE_CODES \
            or v_pool.dtype != k_pool.dtype:
        raise MXNetError("flash_decode: q and pools must be float32 or "
                         "bfloat16 (pools alike), got %s, %s, %s"
                         % (q.dtype, k_pool.dtype, v_pool.dtype))
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise MXNetError("flash_decode: table and pos must be int32, got "
                         "%s and %s" % (table.dtype, pos.dtype))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise MXNetError("flash_decode: %s is on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise MXNetError("flash_decode: %s must be contiguous" % name)


def plan_flash_decode(B, H, MB, BS, D, sms):
    """The kernel's grid, from the shapes and the card's SM count alone
    (never from ``pos``, which lives on the card).

    Each thread block takes ``blocks_per_split`` of a row's ``MB`` table
    slots (``BS`` tokens each) for one head; a row has ``splits =
    ceil(MB / blocks_per_split)`` of them.  The split is the coarsest
    that gives ``CTAS_PER_SM`` blocks an SM when every row is full, with
    at least one slot a block.  Returns a dict: ``splits``,
    ``blocks_per_split``, ``grid`` (``(splits, H, B)``), ``ctas``, the
    ``workspace`` floats and the ``counters`` it needs (none when
    ``splits`` is 1)."""
    wanted = min(MB, -(-CTAS_PER_SM * sms // (B * H)))
    blocks_per_split = -(-MB // wanted)
    splits = -(-MB // blocks_per_split)
    multi = splits > 1
    return {"splits": splits, "blocks_per_split": blocks_per_split,
            "grid": (splits, H, B), "ctas": splits * H * B,
            "workspace": B * H * splits * (D + 2) if multi else 0,
            "counters": B * H if multi else 0}


_PLANS = {}     # (device index, B, H, MB, BS, D) -> plan_flash_decode's plan
#: (device index, stream) -> [int32 counters, all 0 between calls;
#: float32 workspace].  Streams come from PyTorch's fixed pool of a few
#: dozen a device (or are the default one), so the entries stay few.
_SCRATCH = {}
#: guards the first fill of both: a server binds models on one thread
#: while its dispatch worker launches on another
_CACHE_LOCK = threading.Lock()


def _plan(dev, B, H, MB, BS, D):
    """The plan for these shapes on ``dev``, made once."""
    key = (dev.index, B, H, MB, BS, D)
    with _CACHE_LOCK:
        plan = _PLANS.get(key)
        if plan is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = _PLANS[key] = plan_flash_decode(B, H, MB, BS, D, sms)
    return plan


def _scratch(dev, stream, plan):
    """The counters and the workspace of calls on ``stream``.  The
    counters are cleared once, when made or grown: every launch leaves
    them at zero.  Calls on one stream run in order, so they can share
    both; one entry a stream keeps calls on two streams apart."""
    key = (dev.index, stream)
    with _CACHE_LOCK:
        entry = _SCRATCH.get(key)
        if entry is None:
            entry = _SCRATCH[key] = [
                torch.zeros(64, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.float32, device=dev)]
        if entry[0].numel() < plan["counters"]:
            entry[0] = torch.zeros(plan["counters"], dtype=torch.int32,
                                   device=dev)
        if entry[1].numel() < plan["workspace"]:
            entry[1] = torch.empty(plan["workspace"], dtype=torch.float32,
                                   device=dev)
        return list(entry)


def flash_decode_attention(q, k_pool, v_pool, table, pos, scale=None):
    """Decode attention with :func:`decode_attention_reference`'s
    signature and semantics.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/flash_decode.cu`` once, with the grid of
    :func:`plan_flash_decode` (and raise on inputs it does not take).
    ``table`` and ``pos`` must be int32 on the GPU.  The kernel reads
    the table entries up to slot ``pos // BS`` (every slot of a row with
    ``pos < 0``) and clamps each into the pool, as the plain version
    does."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_pool, v_pool, table, pos,
                                          scale=scale)
    from ._build import check, library
    _check_inputs(q, k_pool, v_pool, table, pos)
    B, H, D = q.shape
    BS = k_pool.shape[1]
    MB = table.shape[1]
    if D > MAX_HEAD_DIM:
        raise MXNetError("flash_decode: head width D=%d is more than the "
                         "kernel's %d (every attention model of the repo "
                         "has D <= 64)" % (D, MAX_HEAD_DIM))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    pl = _plan(dev, B, H, MB, BS, D)
    out = torch.empty_like(q)
    lib = library("flash_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pl["splits"] > 1:
            counters, ws = _scratch(dev, stream, pl)
            ws_ptr, cnt_ptr = ws.data_ptr(), counters.data_ptr()
        else:
            ws_ptr = cnt_ptr = None
        code = lib.mxtt_flash_decode(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), ws_ptr,
            cnt_ptr, B, H, D, BS, MB, k_pool.shape[0], pl["blocks_per_split"],
            float(scale), stream)
    check(lib, code, "flash_decode")
    flash_decode_attention.launches += 1
    return out


#: launches of the CUDA kernel in this process (callers may reset it)
flash_decode_attention.launches = 0
register_kernel_counters("flash_decode", lambda: {
    "launches": flash_decode_attention.launches})
