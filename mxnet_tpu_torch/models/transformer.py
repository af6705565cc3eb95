"""Decoder-only transformer LM: the training graph and the generation
graphs.

The port of ``mxnet_tpu/models/transformer.py``: :func:`get_symbol` (the
training LM, dense FFN, SoftmaxOutput head) and the prefill and decode
symbols over the paged KV cache, all with the JAX package's weight names
and ``(out, in)`` layouts, so one checkpoint serves both packages and
every graph; :func:`params_from_numpy` and :func:`opt_state_from_numpy`
move such a checkpoint and its optimizer state onto a device, and
:func:`generate` is the one-shot greedy convenience.
"""
from __future__ import annotations

from .. import ndarray as nd
from .. import symbol as sym
from ..context import resolve
from ..model import _host, params_from_numpy as _params_from_numpy

__all__ = ["transformer_block", "get_symbol", "get_prefill_symbol",
           "get_decode_symbol", "params_from_numpy", "opt_state_from_numpy",
           "generate"]


def transformer_block(x, name, num_heads, dim, seq_len, ffn_mult=4,
                      dropout=0.0, causal=True, num_experts=0,
                      moe_top_k=1, moe_capacity_factor=0.0):
    """One decoder layer: pre-LayerNorm causal self-attention and a ReLU
    FFN, each with a residual.  ``num_experts > 0`` swaps the dense FFN
    for a routed ``MoE`` FFN (``ops/moe.py``: top-k gating, optional
    capacity factor), the Switch-Transformer layer; its aux load-balance
    output is dropped, as in the JAX package."""
    ln1 = sym.LayerNorm(data=x, name="%s_ln1" % name)
    att = sym.MultiHeadAttention(data=ln1, num_heads=num_heads,
                                 causal=causal, dropout=dropout,
                                 name="%s_att" % name)
    x = x + att
    ln2 = sym.LayerNorm(data=x, name="%s_ln2" % name)
    if num_experts:
        moe = sym.MoE(data=sym.Reshape(data=ln2, shape=(-1, dim)),
                      num_experts=num_experts,
                      hidden_size=ffn_mult * dim, top_k=moe_top_k,
                      capacity_factor=moe_capacity_factor,
                      name="%s_moe" % name)
        h = moe[0]
    else:
        h = sym.FullyConnected(data=sym.Reshape(data=ln2, shape=(-1, dim)),
                               num_hidden=ffn_mult * dim,
                               name="%s_ffn1" % name)
        h = sym.Activation(data=h, act_type="relu")
        h = sym.FullyConnected(data=h, num_hidden=dim,
                               name="%s_ffn2" % name)
    h = sym.Reshape(data=h, shape=(-1, seq_len, dim),
                    name="%s_ffn_out" % name)
    return x + h


def get_symbol(vocab_size=32000, num_layers=4, num_heads=8, dim=256,
               seq_len=512, ffn_mult=4, dropout=0.0, mirror_blocks=False,
               num_experts=0, moe_top_k=1, moe_capacity_factor=0.0):
    """LM symbol: data (B, S) token ids, softmax_label (B, S) next tokens
    (the graph of ``mxnet_tpu.models.transformer.get_symbol``, node for
    node).  ``mirror_blocks=True`` tags every op inside each decoder
    layer with ``force_mirroring`` and a per-layer ``mirror_stage``, so
    the executor recomputes whole layers in the backward and keeps only
    the layer-boundary activations.  ``num_experts > 0`` builds the MoE
    variant: every layer's FFN becomes a routed ``layer%d_moe`` expert
    block whose ``*_expert_*`` weights split over an ``ep`` mesh axis
    (``parallel.param_pspec`` matches the names)."""
    from ..attribute import mirror_scope
    data = sym.Variable("data")
    pos = sym.Variable("pos_embed_weight", shape=(seq_len, dim))
    tok = sym.Embedding(data=data, input_dim=vocab_size, output_dim=dim,
                        name="tok_embed")
    x = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    for i in range(num_layers):
        with mirror_scope("layer%d" % i, enabled=mirror_blocks):
            x = transformer_block(x, "layer%d" % i, num_heads, dim,
                                  seq_len, ffn_mult=ffn_mult,
                                  dropout=dropout, num_experts=num_experts,
                                  moe_top_k=moe_top_k,
                                  moe_capacity_factor=moe_capacity_factor)
    x = sym.LayerNorm(data=x, name="final_ln")
    logits = sym.FullyConnected(
        data=sym.Reshape(data=x, shape=(-1, dim)),
        num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(data=sym.Variable("softmax_label"),
                        shape=(-1,), name="label_flat")
    return sym.SoftmaxOutput(data=logits, label=label, name="softmax")


def _cached_lm(seq_len, mode, vocab_size, num_layers, num_heads, dim,
               max_seq_len, ffn_mult=4):
    """Shared builder for the prefill/decode symbols (the graph of
    ``mxnet_tpu.models.transformer._cached_lm``, node for node).

    Outputs: ``[logits] + [layer0 k_cache_out, layer0 v_cache_out, …]``.
    """
    data = sym.Variable("data")                 # (B, S) token ids
    pos_ids = sym.Variable("pos_ids")           # (B, S) positions
    seq_pos = sym.Variable("seq_pos")           # (B,) len / current pos
    block_table = sym.Variable("block_table")   # (B, blocks_per_seq)
    tok = sym.Embedding(data=data, input_dim=vocab_size, output_dim=dim,
                        name="tok_embed")
    pos = sym.Embedding(data=pos_ids, input_dim=max_seq_len,
                        output_dim=dim, name="pos_embed")
    x = tok + pos
    cache_outs = []
    for i in range(num_layers):
        name = "layer%d" % i
        ln1 = sym.LayerNorm(data=x, name="%s_ln1" % name)
        att = sym.CachedMultiHeadAttention(
            data=ln1, num_heads=num_heads, mode=mode,
            block_table=block_table, seq_pos=seq_pos,
            name="%s_att" % name)
        x = x + att[0]
        cache_outs.extend([att[1], att[2]])
        ln2 = sym.LayerNorm(data=x, name="%s_ln2" % name)
        h = sym.FullyConnected(data=sym.Reshape(data=ln2, shape=(-1, dim)),
                               num_hidden=ffn_mult * dim,
                               name="%s_ffn1" % name)
        h = sym.Activation(data=h, act_type="relu")
        h = sym.FullyConnected(data=h, num_hidden=dim, name="%s_ffn2" % name)
        h = sym.Reshape(data=h, shape=(-1, seq_len, dim),
                        name="%s_ffn_out" % name)
        x = x + h
    x = sym.LayerNorm(data=x, name="final_ln")
    logits = sym.FullyConnected(
        data=sym.Reshape(data=x, shape=(-1, dim)),
        num_hidden=vocab_size, name="lm_head")
    return sym.Group([logits] + cache_outs)


def get_prefill_symbol(prompt_len, vocab_size=32000, num_layers=4,
                       num_heads=8, dim=256, max_seq_len=512, ffn_mult=4):
    """Prompt-ingestion graph for one prompt-length bucket: data
    ``(B, prompt_len)``, causal attention, and a scatter of every prompt
    position's k/v into the paged cache (padded positions go to the
    trash block).  Logits cover all positions."""
    return _cached_lm(prompt_len, "prefill", vocab_size, num_layers,
                      num_heads, dim, max_seq_len, ffn_mult)


def get_decode_symbol(vocab_size=32000, num_layers=4, num_heads=8,
                      dim=256, max_seq_len=512, ffn_mult=4):
    """Single-token decode graph: data ``(B, 1)``, cache append, then
    single-query attention over the block table (the flash-decode
    kernel on the GPU).  Every decode batch bucket binds this JSON."""
    return _cached_lm(1, "decode", vocab_size, num_layers, num_heads,
                      dim, max_seq_len, ffn_mult)


def params_from_numpy(params, ctx=None):
    """``{name: array}`` -> ``{name: torch.Tensor}`` on ``ctx``'s device
    (``None`` = the current context).  Values may be numpy arrays, NDArrays (of
    either package's ``nd.load``, through ``asnumpy``) or tensors; the
    ``arg:``/``aux:`` prefixes of a saved checkpoint are stripped.  The
    names and ``(out, in)`` layouts are the JAX package's."""
    return _params_from_numpy(params, ctx=ctx)[0]


def opt_state_from_numpy(opt_state, ctx=None):
    """Optimizer state ``{name: array | (array, ...) | None}`` (SGD's
    momentum, Adam's ``(mean, var)``, as the JAX trainer keeps it) ->
    the same structure of tensors on ``ctx``'s device (``None`` = the
    current context)."""
    device = resolve(ctx)
    out = {}
    for name, value in opt_state.items():
        if value is None:
            out[name] = None
        elif isinstance(value, (tuple, list)):
            out[name] = tuple(nd.array(_host(a), ctx=device).data
                              for a in value)
        else:
            out[name] = nd.array(_host(value), ctx=device).data
    return out



def generate(params, prompts, vocab_size=32000, num_layers=4, num_heads=8,
             dim=256, max_seq_len=512, ffn_mult=4, max_new_tokens=16,
             eos_id=None, prompt_buckets=None, decode_buckets=None,
             kv_blocks=None, kv_block_size=None, ctx=None):
    """Greedy generation for a batch of prompts — the one-shot
    convenience over :class:`mxnet_tpu_torch.serving.generate.
    GenerationEngine`.  ``ctx=None`` runs on the current context.  Returns
    ``[generated token list per prompt]``."""
    from ..serving.generate import GenerationEngine
    engine = GenerationEngine(
        params=params, vocab_size=vocab_size, num_layers=num_layers,
        num_heads=num_heads, dim=dim, max_seq_len=max_seq_len,
        ffn_mult=ffn_mult, max_new_tokens=max_new_tokens,
        prompt_buckets=prompt_buckets, decode_buckets=decode_buckets,
        kv_blocks=kv_blocks, kv_block_size=kv_block_size, ctx=ctx)
    return engine.generate(prompts, max_new_tokens=max_new_tokens,
                           eos_id=eos_id)
