"""Fused RNN operator (LSTM / GRU / vanilla relu|tanh).

The port of ``mxnet_tpu/ops/rnn.py`` (the reference's
``src/operator/rnn-inl.h``, whose only working implementation is cuDNN's,
``cudnn_rnn-inl.h:22``).  The contract is the JAX package's:

- data (seq_len, batch, input_size), states (layers * directions, batch,
  state_size), the sizes of :func:`rnn_param_size`;
- one flat parameter vector: per layer, directions in order [fwd, bwd],
  each packing ``W_x (G*h, in)``, ``W_h (G*h, h)``, ``b_x (G*h)``,
  ``b_h (G*h)``; gate order LSTM (i, f, g, o), GRU (r, z, n), with the
  GRU's candidate ``tanh(x_n + r * (W_hn h + b_hn))``.

That is PyTorch's own RNN parameterization, so two routes compute it:

- :func:`rnn_reference`, the plain version: per layer and direction one
  product ``x W_x^T + b_x`` over the whole sequence (as the JAX package
  computes it before its ``lax.scan``), then a loop over time;
- :func:`rnn_cudnn`: cuDNN's RNN through ``torch._VF`` (the functions
  ``torch.nn.LSTM``/``GRU`` call) on views of the flat vector, which
  cuDNN compacts into its own buffer on every call.

The op takes cuDNN for ``lstm`` and ``gru`` on CUDA tensors, the modes
whose layout the JAX package's tests prove against ``torch.nn.LSTM`` and
``GRU``, and the plain loop everywhere else.  On an H100 with TF32 off,
cuDNN's ``lstm`` and ``gru`` stay within 1e-5 of a float64 run, while
its ``rnn_tanh`` does not (``chip_smoke.py`` phase 13 reports each
mode's distance; ``PERF.md`` records them).  Dropout between layers
(``p > 0`` in training) draws its masks from the op's generator, as the
port's Dropout does, so it also takes the plain loop; cuDNN's dropout
would draw from its own state.
"""
from __future__ import annotations

import warnings

import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_single_param_size(input_size, hidden, mode):
    """Parity rnn-inl.h:31-51: hidden*(hidden+input+2) * gates."""
    return hidden * (hidden + input_size + 2) * _GATES[mode]


def rnn_param_size(num_layers, input_size, hidden, bidirectional, mode):
    """Parity rnn-inl.h:52-67."""
    size = rnn_single_param_size(input_size, hidden, mode)
    if bidirectional:
        size += (num_layers - 1) * rnn_single_param_size(2 * hidden, hidden,
                                                         mode)
        size *= 2
    else:
        size += (num_layers - 1) * rnn_single_param_size(hidden, hidden, mode)
    return size


class _RNNParam(ParamStruct):
    state_size = Field(int, required=True, lower=1)
    num_layers = Field(int, required=True, lower=1)
    bidirectional = Field(bool, default=False)
    mode = Field(str, required=True,
                 enum=("rnn_relu", "rnn_tanh", "lstm", "gru"))
    p = Field(float, default=0.0, lower=0.0, upper=1.0)
    state_outputs = Field(bool, default=False)


def layer_params(flat, num_layers, input_size, hidden, bidirectional, mode):
    """Views of ``flat``: ``[(w_x, w_h, b_x, b_h)]`` for every layer and
    direction, in the flat layout's order (PyTorch's ``_flat_weights``
    order)."""
    gates = _GATES[mode]
    ndir = 2 if bidirectional else 1
    want = rnn_param_size(num_layers, input_size, hidden, bidirectional, mode)
    if flat.numel() != want:
        raise MXNetError("RNN: %d parameters, the layout needs %d"
                         % (flat.numel(), want))
    out, offset = [], 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * ndir
        for _ in range(ndir):
            parts = []
            for shape in ((gates * hidden, in_size), (gates * hidden, hidden),
                          (gates * hidden,), (gates * hidden,)):
                n = 1
                for d in shape:
                    n *= d
                parts.append(flat[offset:offset + n].view(shape))
                offset += n
            out.append(tuple(parts))
    return out


def _step(mode):
    """``step(carry, xw_t, w_h, b_h) -> carry``; the output is carry[0]."""
    if mode == "lstm":
        def step(carry, xw, w_h, b_h):
            h, c = carry
            i, f, g, o = torch.chunk(xw + h @ w_h.t() + b_h, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(c), c
    elif mode == "gru":
        def step(carry, xw, w_h, b_h):
            h = carry[0]
            x_r, x_z, x_n = torch.chunk(xw, 3, dim=-1)
            h_r, h_z, h_n = torch.chunk(h @ w_h.t() + b_h, 3, dim=-1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            n = torch.tanh(x_n + r * h_n)
            return ((1.0 - z) * n + z * h,)
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, xw, w_h, b_h):
            return (act(xw + carry[0] @ w_h.t() + b_h),)
    return step


def rnn_reference(mode, data, flat, state, state_cell, num_layers,
                  bidirectional, p=0.0, is_train=False, rng=None):
    """The plain version: ``(output, h_n, c_n)`` (``c_n`` None unless
    LSTM), with autograd through every step."""
    hidden = state.shape[-1]
    ndir = 2 if bidirectional else 1
    params = layer_params(flat, num_layers, data.shape[-1], hidden,
                          bidirectional, mode)
    step = _step(mode)
    x = data
    h_n, c_n = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            w_x, w_h, b_x, b_h = params[layer * ndir + d]
            sl = layer * ndir + d
            carry = (state[sl], state_cell[sl]) if mode == "lstm" \
                else (state[sl],)
            xw = torch.matmul(x, w_x.t()) + b_x     # (seq, batch, G*h)
            ys = [None] * x.shape[0]
            steps = range(x.shape[0] - 1, -1, -1) if d == 1 \
                else range(x.shape[0])
            for t in steps:
                carry = step(carry, xw[t], w_h, b_h)
                ys[t] = carry[0]
            outs.append(torch.stack(ys, 0))
            h_n.append(carry[0])
            if mode == "lstm":
                c_n.append(carry[1])
        x = outs[0] if ndir == 1 else torch.cat(outs, -1)
        if is_train and p > 0.0 and layer < num_layers - 1:
            keep = 1.0 - p
            u = torch.rand(x.shape, generator=rng, device=x.device)
            x = torch.where(u < keep, x / keep,
                            torch.zeros((), dtype=x.dtype, device=x.device))
    return (x, torch.stack(h_n, 0),
            torch.stack(c_n, 0) if mode == "lstm" else None)


_VF_FNS = {"lstm": "lstm", "gru": "gru", "rnn_tanh": "rnn_tanh",
           "rnn_relu": "rnn_relu"}
#: the modes the op runs on cuDNN (on CUDA tensors, without dropout)
CUDNN_MODES = ("lstm", "gru")


def rnn_cudnn(mode, data, flat, state, state_cell, num_layers,
              bidirectional):
    """cuDNN's RNN on CUDA tensors: ``(output, h_n, c_n)``; no dropout.
    Any mode; the op calls it for ``CUDNN_MODES`` only."""
    if not data.is_cuda:
        raise MXNetError("rnn_cudnn: CUDA tensors only, got %s" % data.device)
    weights = [w for group in layer_params(flat, num_layers, data.shape[-1],
                                           state.shape[-1], bidirectional,
                                           mode)
               for w in group]
    fn = getattr(torch._VF, _VF_FNS[mode])
    x = data.contiguous()
    # cuDNN keeps what its backward needs only in training mode (dropout
    # is 0 here, so the mode changes nothing else)
    train = torch.is_grad_enabled()
    with warnings.catch_warnings():
        # the views are not cuDNN's packed buffer: it copies them in
        warnings.filterwarnings("ignore", message=".*contiguous chunk")
        if mode == "lstm":
            out, h_n, c_n = fn(x, (state.contiguous(),
                                   state_cell.contiguous()),
                               weights, True, num_layers, 0.0, train,
                               bidirectional, False)
            return out, h_n, c_n
        out, h_n = fn(x, state.contiguous(), weights, True, num_layers, 0.0,
                      train, bidirectional, False)
    return out, h_n, None


@register_op("RNN")
class RNN(OperatorProperty):
    """Fused multi-layer RNN (rnn-inl.h; data [seq, batch, feat])."""
    param_cls = _RNNParam
    need_rng = True

    def list_arguments(self):
        if self.param.mode == "lstm":
            return ["data", "parameters", "state", "state_cell"]
        return ["data", "parameters", "state"]

    def list_outputs(self):
        outs = ["output"]
        if self.param.state_outputs:
            outs.append("state")
            if self.param.mode == "lstm":
                outs.append("state_cell")
        return outs

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("RNN", in_shapes[:1], ["data"])
        if len(data) != 3:
            raise MXNetError("RNN: data must be [seq_len, batch, input_size]")
        p = self.param
        seq_len, batch, input_size = data
        ndir = 2 if p.bidirectional else 1
        psize = rnn_param_size(p.num_layers, input_size, p.state_size,
                               p.bidirectional, p.mode)
        state = (ndir * p.num_layers, batch, p.state_size)
        ins = [data, (psize,), state]
        if p.mode == "lstm":
            ins.append(state)
        outs = [(seq_len, batch, ndir * p.state_size)]
        if p.state_outputs:
            outs.append(state)
            if p.mode == "lstm":
                outs.append(state)
        return ins, outs, []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        data, flat, state = inputs[0], inputs[1], inputs[2]
        cell = inputs[3] if p.mode == "lstm" else None
        dropout = is_train and p.p > 0.0 and p.num_layers > 1
        if data.is_cuda and p.mode in CUDNN_MODES and not dropout:
            out, h_n, c_n = rnn_cudnn(p.mode, data, flat, state, cell,
                                      p.num_layers, p.bidirectional)
        else:
            out, h_n, c_n = rnn_reference(p.mode, data, flat, state, cell,
                                          p.num_layers, p.bidirectional,
                                          p.p, is_train, rng)
        outs = [out]
        if p.state_outputs:
            outs.append(h_n)
            if p.mode == "lstm":
                outs.append(c_n)
        return outs, None
