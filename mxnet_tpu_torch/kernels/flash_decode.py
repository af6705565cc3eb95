"""Flash-decode: single-query attention over the paged KV cache.

The port of ``mxnet_tpu/kernels/flash_decode.py``.  One new query per
sequence attends over that sequence's cache blocks, named by its
block-table row (serving/kvcache.py), with positions ``> pos`` masked.

- :func:`decode_attention_reference` is the plain PyTorch version
  (gather the table's blocks, softmax, contract), with the JAX
  signature.  It runs for tensors on the CPU, and it is what the CUDA
  kernel is compared with on the GPU.
- :func:`flash_decode_attention` is the wrapper of the hand-written
  CUDA kernel ``csrc/flash_decode.cu`` (grid ``(B, H)``, an online
  softmax over the blocks ``j <= pos // block_size``).  For CUDA tensors
  it launches the kernel or raises; there is no flag that turns it off.
  ``flash_decode_attention.launches`` counts its launches.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["decode_attention_reference", "flash_decode_attention"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_reference(q, k_pool, v_pool, table, pos, scale=None):
    """Gather + softmax decode attention.  ``q (B, H, D)``, pools
    ``(NB, BS, H, D)``, ``table (B, MB)`` int, ``pos (B,)`` int (the
    newest token's index).  Returns ``(B, H, D)`` in q's dtype."""
    B, H, D = q.shape
    BS = k_pool.shape[1]
    MB = table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    t = table.long()
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


def flash_decode_attention(q, k_pool, v_pool, table, pos, scale=None):
    """Decode attention with :func:`decode_attention_reference`'s
    signature and semantics.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/flash_decode.cu`` (and raise on inputs it
    does not take).  ``table`` and ``pos`` must be int32 on the GPU, and
    every table entry the kernel reads (slots ``<= pos // BS``) must name
    a pool block: the kernel does not bound-check them (that would cost
    a device-to-host sync per call); the cache's allocator hands out
    only valid ids."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_pool, v_pool, table, pos,
                                          scale=scale)
    from ._build import check, library
    _check_inputs(q, k_pool, v_pool, table, pos)
    B, H, D = q.shape
    BS = k_pool.shape[1]
    MB = table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lib = library("flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.mxtt_flash_decode(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, D, BS, MB, float(scale), stream)
    check(lib, code, "flash_decode")
    flash_decode_attention.launches += 1
    return out


#: launches of the CUDA kernel in this process (callers may reset it)
flash_decode_attention.launches = 0
