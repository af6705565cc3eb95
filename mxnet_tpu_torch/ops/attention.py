"""Transformer operators of the generation graphs: LayerNorm and
CachedMultiHeadAttention.

The port's slice of ``mxnet_tpu/ops/attention.py``.  Prefill attention is
a plain causal softmax (:func:`attention_reference`, as the JAX package
computes it with its jnp reference); decode attention goes through the
port's flash-decode kernel (``kernels/flash_decode.py``), which on a GPU
tensor always launches the CUDA kernel.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known

_NEG_INF = -1e30


class _LayerNormParam(ParamStruct):
    axis = Field(int, default=-1)
    eps = Field(float, default=1e-5)


@register_op("LayerNorm")
class LayerNorm(OperatorProperty):
    """y = (x - mean) / sqrt(var + eps) * gamma + beta over ``axis``."""
    param_cls = _LayerNormParam

    def list_arguments(self):
        return ["data", "gamma", "beta"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("LayerNorm", in_shapes[:1], ["data"])
        d = (data[self.param.axis],)
        return [data, d, d], [data], []

    def forward(self, inputs, aux, is_train, rng):
        x, gamma, beta = inputs
        ax = self.param.axis
        mu = x.mean(dim=ax, keepdim=True)
        var = x.var(dim=ax, keepdim=True, unbiased=False)
        y = (x - mu) * torch.reciprocal(torch.sqrt(var + self.param.eps))
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        return [y * gamma.reshape(shape) + beta.reshape(shape)], None


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain softmax attention; q (..., Sq, D), k/v (..., Sk, D) — the
    port of ``mxnet_tpu/parallel/ring_attention.py:attention_reference``
    (positions masked with -1e30, not -inf)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(p.dtype)).to(q.dtype)


class _CachedMHAParam(ParamStruct):
    num_heads = Field(int, required=True, lower=1)
    mode = Field(str, default="decode", doc="prefill | decode")


@register_op("CachedMultiHeadAttention")
class CachedMultiHeadAttention(OperatorProperty):
    """MultiHeadAttention over a block-paged KV cache.

    Same projection weights as MultiHeadAttention; keys and values live
    in the pools ``(num_blocks, block_size, H, D)`` of
    :mod:`mxnet_tpu_torch.serving.kvcache`.  ``block_table`` ``(B,
    blocks_per_seq)`` names each row's pool blocks and ``seq_pos``
    ``(B,)`` is the prompt length (prefill) or the new token's position
    (decode).  Both arrive as float32 and are cast before indexing.

    Unlike ``mxnet_tpu``, whose update is functional (``.at[].set``),
    the port writes the new keys and values into the pools IN PLACE
    (``index_put_``), which saves copying every pool on every step.  It
    still returns the pools as outputs 1 and 2, so callers that install
    the returned pools (``GenerationEngine._install``) work unchanged.

    - ``mode="prefill"``: data ``(B, S, E)``; causal self-attention over
      the prompt plus a scatter of all S keys/values.  Padded positions
      (``>= seq_pos``) all write to trash block 0; their duplicate
      indices are harmless because block 0 is never read unmasked.
    - ``mode="decode"``: data ``(B, 1, E)``; scatter the new k/v at
      ``(table[b, pos//bs], pos % bs)``, THEN attend (the new token
      reads its own k/v back from the pool) over the positions
      ``<= seq_pos`` through the flash-decode kernel.
    """
    param_cls = _CachedMHAParam

    def list_arguments(self):
        return ["data", "qkv_weight", "qkv_bias", "out_weight", "out_bias",
                "k_cache", "v_cache", "block_table", "seq_pos"]

    def list_outputs(self):
        return ["output", "k_cache_out", "v_cache_out"]

    def infer_shape(self, in_shapes):
        data, cache = in_shapes[0], in_shapes[5]
        if data is None or cache is None:
            require_known("CachedMultiHeadAttention",
                          [in_shapes[0], in_shapes[5]],
                          ["data", "k_cache"])
        if len(data) != 3:
            raise MXNetError(
                "CachedMultiHeadAttention: data must be (B, S, E)")
        if len(cache) != 4:
            raise MXNetError(
                "CachedMultiHeadAttention: k_cache must be "
                "(num_blocks, block_size, num_heads, head_dim)")
        B, S, E = data
        H = self.param.num_heads
        if E % H:
            raise MXNetError("embed dim %d not divisible by num_heads %d"
                             % (E, H))
        if cache[2] != H or cache[3] != E // H:
            raise MXNetError(
                "cache heads/head_dim %s do not match (H=%d, D=%d)"
                % (cache[2:], H, E // H))
        if self.param.mode == "decode" and S != 1:
            raise MXNetError("decode mode takes one token per row, "
                             "got S=%d" % S)
        if self.param.mode not in ("prefill", "decode"):
            raise MXNetError("mode must be prefill|decode, got %r"
                             % self.param.mode)
        table = in_shapes[7]
        mb = table[1] if table is not None and len(table) == 2 else None
        if mb is None:
            raise MXNetError("block_table must be (B, blocks_per_seq)")
        return ([data, (3 * E, E), (3 * E,), (E, E), (E,),
                 tuple(cache), tuple(cache), (B, mb), (B,)],
                [data, tuple(cache), tuple(cache)], [])

    def forward(self, inputs, aux, is_train, rng):
        x, wqkv, bqkv, wo, bo, kc, vc, table, seq_pos = inputs
        B, S, E = x.shape
        H = self.param.num_heads
        D = E // H
        BS = kc.shape[1]
        table = table.to(torch.int32)
        pos = seq_pos.to(torch.int32)
        qkv = torch.matmul(x, wqkv.t()) + bqkv          # (B, S, 3E)
        q, k, v = qkv.split(E, dim=-1)
        kh = k.reshape(B, S, H, D)
        vh = v.reshape(B, S, H, D)

        if self.param.mode == "prefill":
            def heads(t):
                return t.reshape(B, S, H, D).transpose(1, 2)
            o = attention_reference(heads(q), heads(k), heads(v),
                                    causal=True)
            o = o.transpose(1, 2).reshape(B, S, E)
            j = torch.arange(S, dtype=torch.int64, device=x.device)
            blocks = torch.gather(table.long(), 1,
                                  (j // BS)[None, :].expand(B, S))
            blocks = torch.where(j[None, :] < pos[:, None].long(), blocks,
                                 torch.zeros_like(blocks))
            idx = (blocks.reshape(-1), (j % BS).repeat(B))
            kc.index_put_(idx, kh.reshape(B * S, H, D).to(kc.dtype))
            vc.index_put_(idx, vh.reshape(B * S, H, D).to(vc.dtype))
        else:
            from ..kernels.flash_decode import flash_decode_attention
            p64 = pos.long()
            blk = torch.gather(table.long(), 1, (p64 // BS)[:, None])[:, 0]
            idx = (blk, p64 % BS)
            kc.index_put_(idx, kh[:, 0].to(kc.dtype))
            vc.index_put_(idx, vh[:, 0].to(vc.dtype))
            qh = q.reshape(B, H, D).contiguous()
            o = flash_decode_attention(qh, kc, vc, table.contiguous(),
                                       pos.contiguous(),
                                       scale=1.0 / math.sqrt(D))
            o = o.to(q.dtype).reshape(B, 1, E)
        return [torch.matmul(o, wo.t()) + bo, kc, vc], None
