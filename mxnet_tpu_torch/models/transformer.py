"""Decoder-only transformer LM: the generation graphs.

The port's slice of ``mxnet_tpu/models/transformer.py``: the prefill and
decode symbols over the paged KV cache, with the JAX package's weight
names and ``(out, in)`` layouts, so one checkpoint serves both packages;
:func:`params_from_numpy` moves such a checkpoint onto a device, and
:func:`generate` is the one-shot greedy convenience.
"""
from __future__ import annotations

from .. import ndarray as nd
from .. import symbol as sym
from ..context import resolve

__all__ = ["get_prefill_symbol", "get_decode_symbol", "params_from_numpy",
           "generate"]


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
    (``None`` = ``gpu(0)``).  Values may be numpy arrays, NDArrays (of
    either package's ``nd.load``, through ``asnumpy``) or tensors; the
    ``arg:``/``aux:`` prefixes of a saved checkpoint are stripped.  The
    names and ``(out, in)`` layouts are the JAX package's."""
    device = resolve(ctx)
    out = {}
    for name, value in params.items():
        if name.startswith(("arg:", "aux:")):
            name = name[4:]
        if hasattr(value, "asnumpy") and not isinstance(value, nd.NDArray):
            value = value.asnumpy()
        out[name] = nd.array(value, ctx=device).data
    return out


def generate(params, prompts, vocab_size=32000, num_layers=4, num_heads=8,
             dim=256, max_seq_len=512, ffn_mult=4, max_new_tokens=16,
             eos_id=None, prompt_buckets=None, decode_buckets=None,
             kv_blocks=None, kv_block_size=None, ctx=None):
    """Greedy generation for a batch of prompts — the one-shot
    convenience over :class:`mxnet_tpu_torch.serving.generate.
    GenerationEngine`.  ``ctx=None`` runs on ``gpu(0)``.  Returns
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
