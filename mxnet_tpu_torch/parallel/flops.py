"""Model FLOPs of one training step, counted from a graph's shapes.

The port's counterpart of the XLA cost analysis the JAX trainer reads
(``ShardedTrainer.compiled_step_cost_analysis``): the port runs eagerly,
and its hand kernels are extension calls that ``torch.utils.flop_counter``
cannot see, so the count is taken from the bound graph instead.  Every
product counts, a multiply-add as 2:

- ``FullyConnected``: ``2 * batch * num_hidden * inputs``;
- ``Convolution``: ``2 * output elements * (channels / groups) * kernel``;
- ``Deconvolution``: ``2 * input elements * (filters / groups) * kernel``;
- ``dot`` / ``batch_dot``: ``2 * output elements * inner dimension``;
- ``MultiHeadAttention``: the qkv and output projections, and
  attention's q kᵀ and p v over the full S x S scores (``2 * B * S * S *
  E`` each; the causal mask is not discounted, as the model-FLOPs
  convention and the plain masked reference count them);
- ``RNN``: every layer's and direction's gate products, ``2 * T * B *
  gates * H * (inputs + H)``;
- ``MoE``: the gate and both products of every expert over every token
  (``2 * T * K * E + 4 * T * K * E * H``: the dense formulation the op
  computes, not the routed ``top_k`` share).

A training step counts 3 times the forward: the backward computes the
data and the weight gradient of every product, each as many FLOPs as
the forward's.  Elementwise work (activations, normalisations, softmax,
the optimizer update) is not counted.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError

__all__ = ["forward_flops", "step_flops"]


def _prod(shape):
    return int(_np.prod(shape, dtype=_np.int64))


def _fc(p, ins, outs):
    return 2 * ins[0][0] * _prod(ins[1])


def _conv(p, ins, outs):
    return 2 * _prod(outs[0]) * _prod(ins[1][1:])


def _deconv(p, ins, outs):
    return 2 * _prod(ins[0]) * _prod(ins[1][1:])


def _dot(p, ins, outs):
    a = ins[0]
    return 2 * _prod(outs[0]) * (a[0] if p.transpose_a else a[-1])


def _batch_dot(p, ins, outs):
    a = ins[0]
    return 2 * _prod(outs[0]) * (a[1] if p.transpose_a else a[2])


def _mha(p, ins, outs):
    B, S, E = ins[0]
    return 2 * B * S * E * (3 * E + E) + 2 * (2 * B * S * S * E)


_GATES = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}


def _rnn(p, ins, outs):
    T, B, inputs = ins[0]
    H, ndir = p.state_size, 2 if p.bidirectional else 1
    total = 0
    for layer in range(p.num_layers):
        n_in = inputs if layer == 0 else ndir * H
        total += ndir * 2 * T * B * _GATES[p.mode] * H * (n_in + H)
    return total


def _moe(p, ins, outs):
    E = ins[0][-1]
    T = _prod(ins[0]) // E
    K = p.num_experts
    return 2 * T * K * E + 4 * T * K * E * p.hidden_size


_FORWARD = {"MoE": _moe, "FullyConnected": _fc, "Convolution": _conv,
            "Deconvolution": _deconv, "dot": _dot, "batch_dot": _batch_dot,
            "MultiHeadAttention": _mha, "RNN": _rnn}


def forward_flops(symbol, shapes):
    """FLOPs of one forward of ``symbol`` with input shapes ``shapes``
    (``{argument: shape}``), its products only."""
    internals = symbol.get_internals()
    _a, outs, _x = internals.infer_shape(**shapes)
    if outs is None:
        raise MXNetError("forward_flops: cannot infer every shape from %s"
                         % (shapes,))
    shape = {(id(n), i): tuple(s) for (n, i), s in zip(internals._heads,
                                                       outs)}
    total = 0
    for node in symbol._topo():
        if node.is_variable:
            continue
        count = _FORWARD.get(node.op.op_name)
        if count is None:
            continue
        ins = [shape[(id(c), ci)] for c, ci in node.inputs]
        total += count(node.op.param, ins,
                       [shape[(id(node), i)]
                        for i in range(node.num_outputs)])
    return total


def step_flops(symbol, shapes):
    """Model FLOPs of one training step: 3 times :func:`forward_flops`."""
    return 3 * forward_flops(symbol, shapes)
