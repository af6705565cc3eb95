"""Transformer operators: LayerNorm, MultiHeadAttention (training) and
CachedMultiHeadAttention (generation).

The port of ``mxnet_tpu/ops/attention.py``.  ``MultiHeadAttention``
lowers to :func:`parallel.ring_attention.sharded_self_attention`, whose
forward is the port's flash-attention kernel on a GPU tensor.  Prefill
attention of the generation graphs is a plain causal softmax
(:func:`attention_reference`, as the JAX package computes it with its
jnp reference); decode attention goes through the flash-decode kernel
(``kernels/flash_decode.py``), which on a GPU tensor always launches the
CUDA kernel.  ``attention_reference`` lives in
``parallel/ring_attention.py`` and is re-exported here.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from ..parallel.ring_attention import attention_reference  # noqa: F401
from .registry import (OperatorProperty, register_op, require_known,
                       contract_sharding, dedup_axes)


def _tp_heads(op, x, wqkv, bqkv, H):
    """The head-split qkv projection of a tp group: each member computes
    its contiguous columns of ``x @ wqkv.T + bqkv`` (the weight split on
    axis 0, the JAX package's placement), then gathers on its own device
    the q, k and v columns of its ``H / tp`` heads (slices copied between
    the members: activations, not weights).  Returns the group and each
    member's ``(q, k, v)``, ``(B, S, E / tp)`` each."""
    from ..parallel import tensor_parallel as tp
    if tp.is_split(x) or not tp.is_split(wqkv) or wqkv.dim != 0:
        raise tp.unsupported(op.op_name, "the qkv weight must be split on "
                             "axis 0 and the data whole")
    g = wqkv.group
    B, S, E = x.shape
    if H % g.n:
        raise tp.unsupported(op.op_name, "%d heads do not divide over %d "
                             "members" % (H, g.n))
    xs = tp.scatter(g, x)
    width = wqkv.shards[0].shape[0]
    cols = []
    for e in range(g.n):
        c = torch.matmul(xs[e], wqkv.shards[e].t())
        if tp.is_split(bqkv):
            c = c + bqkv.shards[e]
        else:
            lo = e * width
            c = c + tp.scatter(g, bqkv[lo:lo + width])[e]
        cols.append(c)
    h = E // g.n
    out = []
    for j, dev in enumerate(g.devices):
        out.append(tuple(tp.columns(cols, width, base + j * h,
                                    base + (j + 1) * h, dev)
                         for base in (0, E, 2 * E)))
    return g, out


def _tp_out(op, g, o_parts, wo, bo, dropout=None):
    """The out projection after head-split attention: the heads'
    outputs gathered on the first member (``dropout``, a function of the
    whole output, applied there), then the projection split as ``wo``
    is: its rows (each member its output columns, gathered), its
    columns (each member its heads, the partial products summed), or
    whole on the first member."""
    from ..parallel import tensor_parallel as tp
    if tp.is_split(wo) and wo.dim == 1 and dropout is None:
        y = tp.reduce(g, [torch.matmul(o_parts[e], wo.shards[e].t())
                          for e in range(g.n)])
        if tp.is_split(bo):
            raise tp.unsupported(op.op_name, "a split out bias for an out "
                                 "weight split on its input features")
        return y + bo
    o = tp.gather(g, o_parts, -1)
    if dropout is not None:
        o = dropout(o)
    if not tp.is_split(wo):
        if tp.is_split(bo):
            raise tp.unsupported(op.op_name, "a split out bias with a "
                                 "whole out weight")
        return torch.matmul(o, wo.t()) + bo
    if wo.dim == 1:
        os_ = tp.split(g, o, -1)
        y = tp.reduce(g, [torch.matmul(os_[e], wo.shards[e].t())
                          for e in range(g.n)])
        return y + bo
    os_ = tp.scatter(g, o)
    parts = [torch.matmul(os_[e], wo.shards[e].t()) for e in range(g.n)]
    if tp.is_split(bo):
        parts = [q + bo.shards[e] for e, q in enumerate(parts)]
    y = tp.gather(g, parts, -1)
    return y if tp.is_split(bo) else y + bo


def _gathered_attention(qs, ks, vs, causal):
    """Plain attention of each member's q chunk over the whole sequence:
    k and v gathered over the ring onto the member's device (copies that
    carry their gradients back), the causal mask at the chunk's
    offset."""
    from ..parallel.collectives import send
    out = []
    chunk = qs[0].shape[-2]
    for i, q in enumerate(qs):
        k = torch.cat([send(t, q.device) for t in ks], dim=-2)
        v = torch.cat([send(t, q.device) for t in vs], dim=-2)
        out.append(attention_reference(q, k, v, causal=causal,
                                       q_offset=i * chunk))
    return out


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

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data = in_specs[0]
        ax = self.param.axis % len(data) if data else 0
        norm = data[ax] if data else ()
        return {"out": [tuple(data)],
                "in": [None, (norm,), (norm,)]}


class _MHAParam(ParamStruct):
    num_heads = Field(int, required=True, lower=1)
    causal = Field(bool, default=False)
    dropout = Field(float, default=0.0)
    use_flash = Field(bool, default=True)


@register_op("MultiHeadAttention")
class MultiHeadAttention(OperatorProperty):
    """Fused self-attention block: qkv projection + attention + out proj.

    data (B, S, E); qkv_weight (3E, E), out_weight (E, E) in the
    reference's (out_features, in_features) layout.  ``use_flash`` runs
    :func:`flash_attention` (the CUDA kernel on a GPU), else the plain
    :func:`attention_reference`.  Dropout on the attention output draws
    from the generator the trainer passes as ``rng``; the op declares
    ``need_rng`` as in the JAX package, so the trainer passes one even
    at ``dropout=0``.
    """
    param_cls = _MHAParam
    need_rng = True
    mxu = True

    def list_arguments(self):
        return ["data", "qkv_weight", "qkv_bias", "out_weight", "out_bias"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("MultiHeadAttention", in_shapes[:1], ["data"])
        if len(data) != 3:
            raise MXNetError("MultiHeadAttention: data must be (B, S, E)")
        E = data[2]
        if E % self.param.num_heads:
            raise MXNetError("embed dim %d not divisible by num_heads %d"
                             % (E, self.param.num_heads))
        return ([data, (3 * E, E), (3 * E,), (E, E), (E,)],
                [data], [])

    def forward(self, inputs, aux, is_train, rng):
        x, wqkv, bqkv, wo, bo = inputs
        B, S, E = x.shape
        H = self.param.num_heads
        D = E // H
        qkv = torch.matmul(x, wqkv.t()) + bqkv          # (B, S, 3E)
        q, k, v = qkv.split(E, dim=-1)

        def heads(t):  # (B, S, E) -> (B, H, S, D)
            return t.reshape(B, S, H, D).transpose(1, 2)

        if self.param.use_flash:
            from ..parallel.ring_attention import sharded_self_attention
            o = sharded_self_attention(heads(q), heads(k), heads(v),
                                       causal=self.param.causal)
        else:
            o = attention_reference(heads(q), heads(k), heads(v),
                                    causal=self.param.causal)
        o = o.transpose(1, 2).reshape(B, S, E)
        o = self._dropout(o, is_train, rng)
        return [torch.matmul(o, wo.t()) + bo], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """The lockstep walk (``executor.trace_replicas``) hands it every
        member's inputs at once.  Under a sequence-parallel context
        (``parallel.ring_attention.sequence_parallel``) each member holds
        its ``(B/dp, S/sp, E)`` block: it projects its q, k and v, the
        sp members of each dp replica run ring attention over their
        chunks (every hop the flash forward: the CUDA kernel on a card),
        and each member projects its output.  With ``use_flash=False``
        each member gathers k and v over its ring and runs
        :func:`attention_reference` at its chunk's offset, as the JAX
        package's GSPMD all-gathers them.  Without a context: None (each
        member's own forward)."""
        from ..parallel.ring_attention import (current_sequence_parallel,
                                               ring_attention)
        ctx = current_sequence_parallel()
        if ctx is None or ctx.size <= 1:
            return None
        H = self.param.num_heads
        causal = self.param.causal
        qkv = []
        for x, wqkv, bqkv, _wo, _bo in ins:
            B, S, E = x.shape
            t = torch.matmul(x, wqkv.t()) + bqkv
            qkv.append([h.reshape(B, S, H, E // H).transpose(1, 2)
                        for h in t.split(E, dim=-1)])
        o = [None] * len(ins)
        for ring in ctx.rings():
            qs, ks, vs = ([qkv[m][i] for m in ring] for i in range(3))
            if self.param.use_flash:
                got = ring_attention(qs, ks, vs, causal=causal, members=ring)
            else:
                got = _gathered_attention(qs, ks, vs, causal)
            for m, g in zip(ring, got):
                o[m] = g
        outs = []
        for m, (x, _w, _b, wo, bo) in enumerate(ins):
            B, S, E = x.shape
            y = self._dropout(o[m].transpose(1, 2).reshape(B, S, E),
                              is_train, rngs[m])
            outs.append([torch.matmul(y, wo.t()) + bo])
        return outs, None, False

    def _dropout(self, o, is_train, rng):
        if is_train and self.param.dropout > 0.0 and rng is not None:
            keep = 1.0 - self.param.dropout
            mask = torch.rand(o.shape, generator=rng, device=o.device) < keep
            o = torch.where(mask, o / keep, torch.zeros_like(o))
        return o

    def forward_tp(self, inputs, aux, is_train, rng):
        """Head-split attention over a tp group: each member projects its
        heads' q, k and v (:func:`_tp_heads`) and runs the attention of
        its ``num_heads / tp`` heads on its own device (the flash
        forward's launch on a GPU), then :func:`_tp_out`.  Dropout draws
        its mask over the whole output on the first member, as the
        one-device op draws it."""
        x, wqkv, bqkv, wo, bo = inputs
        B, S, E = x.shape
        H = self.param.num_heads
        D = E // H
        g, qkv = _tp_heads(self, x, wqkv, bqkv, H)
        Hm = H // g.n

        def heads(t):
            return t.reshape(B, S, Hm, D).transpose(1, 2)
        o_parts = []
        for q, k, v in qkv:
            if self.param.use_flash:
                from ..parallel.ring_attention import sharded_self_attention
                o = sharded_self_attention(heads(q), heads(k), heads(v),
                                           causal=self.param.causal)
            else:
                o = attention_reference(heads(q), heads(k), heads(v),
                                        causal=self.param.causal)
            o_parts.append(o.transpose(1, 2).reshape(B, S, Hm * D))
        drop = None
        if is_train and self.param.dropout > 0.0 and rng is not None:
            def drop(o):
                return self._dropout(o, is_train, rng)
        return [_tp_out(self, g, o_parts, wo, bo, drop)], None

    def cost_mxu_dims(self, in_shapes, out_shapes):
        B, S, E = in_shapes[0]
        H = self.param.num_heads
        D = E // H
        # qkv proj, out proj, then per-(batch, head): q@k.T and p@v
        return [(B * S, E, 3 * E), (B * S, E, E),
                (S, D, S), (S, S, D)]

    def cost_flops(self, in_shapes, out_shapes):
        B, S, E = in_shapes[0]
        H = self.param.num_heads
        D = E // H
        proj = 2 * B * S * E * (3 * E + E)
        attn = 2 * B * H * (S * D * S + S * S * D)
        return float(proj + attn)

    def cost_reduce_len(self, in_shapes, out_shapes):
        return int(in_shapes[0][1])     # softmax over the key axis

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data, qkv_w = in_specs[0], in_specs[1]
        out_w = in_specs[3]
        required = [None] * len(in_specs)
        reduce = {}
        notes = []
        # input projection: data feature dim contracts against qkv_w dim 1
        d_c = data[2] if len(data) > 2 else ()
        w_c = qkv_w[1] if len(qkv_w) > 1 else ()
        r, n, conflict = contract_sharding(d_c, w_c, 0, 1,
                                           "MultiHeadAttention qkv")
        reduce.update(r)
        notes.extend(n)
        if conflict:
            required[0] = (tuple(data[0]), tuple(data[1]), tuple(w_c))
        # head-parallel attention (qkv_w dim 0 over tp = heads split) must
        # be closed by a row-parallel out projection (out_w dim 1 on the
        # same axis) whose psum merges the per-head partial outputs
        head = tuple(qkv_w[0] if qkv_w else ())
        out_c = tuple(out_w[1] if len(out_w) > 1 else ())
        if head and head == out_c:
            reduce[head] = ("head-parallel attention closed by row-parallel "
                            "out projection: partial sums over %s"
                            % "+".join(head))
        elif head or out_c:
            axes = head or out_c
            notes.append({
                "kind": "attn_unreduced", "arg": 1 if head else 3,
                "axes": axes,
                "message": "attention is head-parallel over %s but the out "
                           "projection does not close it with a matching "
                           "row-parallel reduction: XLA all-gathers the "
                           "per-head activations instead" % "+".join(axes)})
        required[2] = (head,)
        batch = tuple(data[0] if data else ())
        seq = tuple(data[1] if len(data) > 1 else ())
        feat = dedup_axes(out_w[0] if out_w else (), batch + seq)
        if head and head == out_c:
            feat = ()          # row-parallel out proj: output replicated
        required[4] = (feat,)
        out = {"out": [(batch, seq, feat)], "in": required}
        if reduce:
            out["reduce"] = reduce
        if notes:
            out["notes"] = notes
        return out


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
    mxu = True

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

    def forward_tp(self, inputs, aux, is_train, rng):
        """Head-split cached attention over a tp group: the pools arrive
        split on their head axis (``PagedKVCache.shard_pools``), so each
        member projects its heads' q, k and v (:func:`_tp_heads`), writes
        its k and v into its own pools in place and attends over them:
        a prefill's causal softmax, or a decode step's flash-decode
        launch over its ``num_heads / tp`` heads.  Then
        :func:`_tp_out`."""
        from ..parallel import tensor_parallel as tp
        x, wqkv, bqkv, wo, bo, kc, vc, table, seq_pos = inputs
        B, S, E = x.shape
        H = self.param.num_heads
        D = E // H
        if not (tp.is_split(kc) and tp.is_split(vc)) or kc.dim != 2 \
                or vc.dim != 2:
            raise tp.unsupported(self.op_name, "the k and v pools must be "
                                 "split on their head axis")
        g, qkv = _tp_heads(self, x, wqkv, bqkv, H)
        tp.group_of(kc, vc, wqkv)        # raises unless they share one
        Hm = H // g.n
        BS = kc.shards[0].shape[1]
        tables = tp.scatter(g, table.to(torch.int32))
        poss = tp.scatter(g, seq_pos.to(torch.int32))
        o_parts = []
        for j, (q, k, v) in enumerate(qkv):
            kcj, vcj = kc.shards[j], vc.shards[j]
            tbl, pos = tables[j], poss[j]
            kh = k.reshape(B, S, Hm, D)
            vh = v.reshape(B, S, Hm, D)
            if self.param.mode == "prefill":
                def heads(t):
                    return t.reshape(B, S, Hm, D).transpose(1, 2)
                o = attention_reference(heads(q), heads(k), heads(v),
                                        causal=True)
                o = o.transpose(1, 2).reshape(B, S, Hm * D)
                jj = torch.arange(S, dtype=torch.int64, device=q.device)
                blocks = torch.gather(tbl.long(), 1,
                                      (jj // BS)[None, :].expand(B, S))
                blocks = torch.where(jj[None, :] < pos[:, None].long(),
                                     blocks, torch.zeros_like(blocks))
                idx = (blocks.reshape(-1), (jj % BS).repeat(B))
                kcj.index_put_(idx, kh.reshape(B * S, Hm, D).to(kcj.dtype))
                vcj.index_put_(idx, vh.reshape(B * S, Hm, D).to(vcj.dtype))
            else:
                from ..kernels.flash_decode import flash_decode_attention
                p64 = pos.long()
                blk = torch.gather(tbl.long(), 1, (p64 // BS)[:, None])[:, 0]
                idx = (blk, p64 % BS)
                kcj.index_put_(idx, kh[:, 0].to(kcj.dtype))
                vcj.index_put_(idx, vh[:, 0].to(vcj.dtype))
                o = flash_decode_attention(q.reshape(B, Hm, D).contiguous(),
                                           kcj, vcj, tbl.contiguous(),
                                           pos.contiguous(),
                                           scale=1.0 / math.sqrt(D))
                o = o.to(q.dtype).reshape(B, 1, Hm * D)
            o_parts.append(o)
        return [_tp_out(self, g, o_parts, wo, bo), kc, vc], None

    def _ctx_len(self, in_shapes):
        """Cached context slots the table can name (attention width)."""
        cache, table = in_shapes[5], in_shapes[7]
        return int(table[1]) * int(cache[1])

    def cost_mxu_dims(self, in_shapes, out_shapes):
        B, S, E = in_shapes[0]
        H = self.param.num_heads
        D = E // H
        T = self._ctx_len(in_shapes) if self.param.mode == "decode" else S
        # qkv proj, out proj, then per-(batch, head): q@k.T and p@v over
        # the cached context length
        return [(B * S, E, 3 * E), (B * S, E, E),
                (S, D, T), (S, T, D)]

    def cost_flops(self, in_shapes, out_shapes):
        B, S, E = in_shapes[0]
        H = self.param.num_heads
        D = E // H
        T = self._ctx_len(in_shapes) if self.param.mode == "decode" else S
        proj = 2 * B * S * E * (3 * E + E)
        attn = 2 * B * H * (S * D * T + S * T * D)
        return float(proj + attn)

    def cost_reduce_len(self, in_shapes, out_shapes):
        return int(self._ctx_len(in_shapes)
                   if self.param.mode == "decode" else in_shapes[0][1])

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        # head-parallel like MHA: cache pools shard dim 2 (heads) on the
        # same axis as qkv_weight dim 0; tables/positions replicated
        data, qkv_w = in_specs[0], in_specs[1]
        head = tuple(qkv_w[0] if qkv_w else ())
        cache = (tuple(), tuple(), head, tuple())
        batch = tuple(data[0] if data else ())
        seq = tuple(data[1] if len(data) > 1 else ())
        out_w = in_specs[3]
        out_c = tuple(out_w[1] if len(out_w) > 1 else ())
        feat = () if (head and head == out_c) \
            else dedup_axes(out_w[0] if out_w else (), batch + seq)
        out = {"out": [(batch, seq, feat), cache, cache],
               "in": [None, None, (head,), None, (feat,),
                      cache, cache, None, None]}
        if head and head == out_c:
            out["reduce"] = {head: "head-parallel cached attention closed "
                                   "by row-parallel out projection"}
        return out
