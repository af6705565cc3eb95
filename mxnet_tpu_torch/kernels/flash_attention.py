"""Flash-attention forward: softmax attention and its row logsumexp.

The port of ``mxnet_tpu/parallel/ring_attention.py:_flash_kernel`` and
its launcher ``_flash_forward_kernel_call``: for q, k, v ``(B, H, S, D)``
it returns ``o`` in the input dtype and ``lse = m + log(l)`` as ``(B, H,
Sq)`` float32, the statistic the blockwise backward
(``parallel/ring_attention.py``) recomputes the probabilities from.
Masked scores are -1e30, not -inf, and ``l`` is floored at 1e-30, as in
the JAX kernel.

- :func:`flash_attention_forward_reference` is the plain PyTorch version
  (the whole score matrix, float32).  It runs for tensors on the CPU,
  and it is what the CUDA kernel is compared with on the GPU.
- :func:`flash_attention_forward` is the wrapper of the hand-written
  CUDA kernels ``csrc/flash_attention.cu``: for bfloat16 inputs a
  tensor-core kernel (``wgmma`` fed by TMA, 128 q rows a CTA, p issued
  as a bfloat16 hi and lo part so o keeps float32 accuracy), for float32
  inputs an FMA kernel (128 q rows a CTA, 64 at D=128, 64-key tiles by
  ``cp.async`` into a two-stage ring, 8x8 register micro-tiles, one CTA
  a work item; :func:`plan_flash_forward` states its tiles and work
  order).  Both run an
  online softmax, skip causal tiles above the diagonal and mask only
  the tiles on the diagonal or the ragged edge, so any S works.  For
  CUDA tensors it launches a kernel or raises.
  ``flash_attention_forward.launches`` counts its launches and
  ``.launches_by_dtype`` them by input dtype (so by body).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["flash_attention_forward_reference", "flash_attention_forward",
           "plan_flash_forward", "work_item"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

#: the float32 body's tiles (``FmaCfg<D>`` in ``csrc/flash_attention.cu``):
#: q rows a CTA by head dim, and keys a tile
F32_BLOCK_Q = {32: 128, 64: 128, 128: 64}
F32_BLOCK_K = 64


def work_item(t, bh_count, n_qtiles, block_q):
    """``(bh, q0)`` of the float32 body's work item ``t``: items walk the
    q tiles from the last (the longest causal walk) down, every
    batch*head at each, as the kernel does."""
    return t % bh_count, (n_qtiles - 1 - t // bh_count) * block_q


def plan_flash_forward(BH, Sq, Sk, D, causal):
    """The float32 body's tiles and work items, from the shapes.

    Each work item is one batch*head and one tile of ``block_q`` q rows,
    which walks ``k_tiles(q0)`` tiles of ``block_k`` keys (causal: up to
    the diagonal).  The kernel runs one CTA an item, CTA ``t`` taking
    :func:`work_item` ``t``, longest walk first: the card hands each next
    item to the first free slot.  The kernel keeps its own copy of these
    numbers and expressions (``FmaCfg<D>``, ``flash_forward_fma``);
    ``tests/test_torch_flash_f32.py`` reads them out of the source and
    holds them to this function.
    Returns a dict: ``block_q``, ``block_k``, ``n_qtiles``, ``items`` and
    ``k_tiles`` (a function of ``q0``)."""
    bq = F32_BLOCK_Q[D]
    n_qtiles = -(-Sq // bq)
    items = BH * n_qtiles
    all_tiles = -(-Sk // F32_BLOCK_K)

    def k_tiles(q0):
        if causal:
            return min(all_tiles, (q0 + bq - 1) // F32_BLOCK_K + 1)
        return all_tiles

    return {"block_q": bq, "block_k": F32_BLOCK_K, "n_qtiles": n_qtiles,
            "items": items, "k_tiles": k_tiles}


def flash_attention_forward_reference(q, k, v, causal=False, scale=None):
    """Plain softmax attention in float32.  ``q (B, H, Sq, D)``, ``k``
    and ``v (B, H, Sk, D)``.  Returns ``(o, lse)``: ``o`` in q's dtype,
    ``lse (B, H, Sq)`` float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.matmul(p, vf) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise MXNetError("flash_attention: want q (B, H, Sq, D) and k, v "
                         "(B, H, Sk, D), got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError("flash_attention: the CUDA kernel takes head dims "
                         "%s, got %d" % (_HEAD_DIMS, q.shape[3]))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k, v must all be float32 or "
                         "all bfloat16, got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise MXNetError("flash_attention: %s is on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise MXNetError("flash_attention: %s must be contiguous" % name)
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise MXNetError("flash_attention: empty sequence")


def flash_attention_forward(q, k, v, causal=False, scale=None):
    """Attention forward with :func:`flash_attention_forward_reference`'s
    signature and semantics.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/flash_attention.cu`` (and raise on inputs it
    does not take: other dtypes, head dims outside 32/64/128, strided or
    misaligned tensors)."""
    if not q.is_cuda:
        return flash_attention_forward_reference(q, k, v, causal=causal,
                                                 scale=scale)
    from ._build import check, library
    _check_inputs(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.mxtt_flash_attention_forward(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B * H, Sq, Sk, D, int(bool(causal)),
            float(scale), stream)
    check(lib, code, "flash_attention")
    flash_attention_forward.launches += 1
    flash_attention_forward.launches_by_dtype[
        str(q.dtype).replace("torch.", "")] += 1
    return o, lse


#: launches of the CUDA kernels in this process, in all and by input dtype:
#: "bfloat16" is the tensor-core body, "float32" the FMA body (callers may
#: reset them)
flash_attention_forward.launches = 0
flash_attention_forward.launches_by_dtype = {"float32": 0, "bfloat16": 0}
