"""Mixture-of-Experts decoder-only transformer.

The port of ``mxnet_tpu/models/transformer_moe.py``: the
:mod:`transformer` builder with every FFN swapped for a routed ``MoE``
expert block (Switch-style top-k gating, ``ops/moe.py``).  Expert weight
names contain ``expert``, so ``parallel.param_pspec`` splits them over an
``ep`` mesh axis, and the MXL-E lint (``mxlint --model transformer_moe
--mesh dp=1,ep=4 --schedule``) prices the expert all-to-all and checks
divisibility and capacity before a card is touched.
"""
from __future__ import annotations

from .transformer import get_symbol as _dense_get_symbol

__all__ = ["get_symbol"]


def get_symbol(vocab_size=32000, num_layers=4, num_heads=8, dim=256,
               seq_len=512, ffn_mult=4, dropout=0.0, mirror_blocks=False,
               num_experts=8, moe_top_k=1, moe_capacity_factor=1.25):
    """The :mod:`transformer` builder with MoE FFNs on by default."""
    if num_experts < 2:
        raise ValueError("transformer_moe needs num_experts >= 2 "
                         "(got %d); use models.transformer for the "
                         "dense variant" % num_experts)
    return _dense_get_symbol(
        vocab_size=vocab_size, num_layers=num_layers,
        num_heads=num_heads, dim=dim, seq_len=seq_len,
        ffn_mult=ffn_mult, dropout=dropout,
        mirror_blocks=mirror_blocks, num_experts=num_experts,
        moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor)
