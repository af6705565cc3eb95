"""Attention for training: the flash-attention function and its dispatch.

The port's slice of ``mxnet_tpu/parallel/ring_attention.py``:

- :func:`attention_reference`: plain softmax attention (scores masked
  with -1e30, not -inf).  ``ops/attention.py`` re-exports it.
- :func:`flash_attention`: a ``torch.autograd.Function``.  Its forward
  is the hand-written CUDA kernel for CUDA tensors and its plain version
  for CPU tensors (``kernels/flash_attention.py``); both return the row
  logsumexp that the backward keeps.  Its backward is
  :func:`_flash_backward_blockwise`, the port of the JAX package's
  blockwise recompute (plain jnp there, PyTorch here): per block of
  keys, the probabilities are rebuilt from the logsumexp, so the live
  memory is O(Sq * block_k), never the (Sq, Sk) score matrix.
- :func:`sharded_self_attention`: the dispatch ``MultiHeadAttention``
  calls.  Without a sequence-parallel context it is
  :func:`flash_attention`; ring attention over a sequence-parallel mesh
  axis belongs to the multi-GPU slice, so an active
  :func:`sequence_parallel` context raises.

Unlike the JAX ``flash_attention``, which takes its reference path when
S is not a multiple of its 128 block, the kernel masks the ragged edge,
so the same function runs for every S.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..base import MXNetError
from ..kernels.flash_attention import flash_attention_forward

__all__ = ["attention_reference", "flash_attention", "sharded_self_attention",
           "sequence_parallel", "current_sequence_parallel"]

_NEG_INF = -1e30


def attention_reference(q, k, v, causal=False, scale=None, q_offset=0,
                        kv_offset=0):
    """Plain softmax attention; q (..., Sq, D), k/v (..., Sk, D).

    ``q_offset``/``kv_offset`` are the global positions of element 0
    (causal masking of sequence chunks)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :] + kv_offset
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(p.dtype)).to(q.dtype)


def _flash_backward_blockwise(q, k, v, o, lse, do, causal, scale,
                              block_k=128):
    """Flash-attention backward: blockwise recompute from the saved
    logsumexp (the port of ``_flash_backward_blockwise``).  With
    p = exp(s * scale - lse):

        dv_j = p^T @ do
        ds   = p * (do @ v^T - rowsum(do * o)) * scale
        dq  += ds @ k_j,   dk_j = ds^T @ q

    The last block may be short, so any Sk works.  Computes in float32
    and returns each gradient in its input's dtype."""
    qf = q.float()
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)                    # (B, H, Sq)
    sq, sk = q.shape[-2], k.shape[-2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for start in range(0, sk, block_k):
        stop = min(start + block_k, sk)
        kb = k[..., start:stop, :].float()
        vb = v[..., start:stop, :].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(start, stop, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lse[..., None])
        dv[..., start:stop, :] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.matmul(ds, kb)
        dk[..., start:stop, :] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward_blockwise(q, k, v, o, lse, do,
                                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused attention; q/k/v (B, H, S, D), differentiable.  The forward
    is the CUDA kernel for CUDA tensors (its plain version on the CPU);
    the backward recomputes blockwise from the saved logsumexp."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


# ----------------------------------------------------------------------
# sequence-parallel context
# ----------------------------------------------------------------------
_SP_STATE = threading.local()


@contextlib.contextmanager
def sequence_parallel(mesh, seq_axis="sp"):
    """While active, ``MultiHeadAttention`` would run ring attention over
    ``seq_axis`` of ``mesh``; in this slice it raises instead (see
    :func:`sharded_self_attention`)."""
    prev = getattr(_SP_STATE, "ctx", None)
    _SP_STATE.ctx = (mesh, seq_axis)
    try:
        yield
    finally:
        _SP_STATE.ctx = prev


def current_sequence_parallel():
    """``(mesh, seq_axis)`` of the active context, or None."""
    return getattr(_SP_STATE, "ctx", None)


def sharded_self_attention(q, k, v, causal=False):
    """Attention dispatch for (B, H, S, D): :func:`flash_attention`
    without a sequence-parallel context.  Ring attention over a mesh axis
    is the multi-GPU slice's, so an active context raises."""
    ctx = current_sequence_parallel()
    if ctx is None or ctx[1] not in ctx[0].axis_names:
        return flash_attention(q, k, v, causal=causal)
    raise MXNetError("ring attention over the %r mesh axis is not ported "
                     "yet: it comes with the multi-GPU training slice"
                     % ctx[1])
