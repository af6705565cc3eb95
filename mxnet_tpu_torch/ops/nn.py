"""Neural-network operators of the generation graphs.

The port's slice of ``mxnet_tpu/ops/nn.py``: FullyConnected, Activation,
Reshape (with MXNet's ``0``/``-1`` codes), Embedding and the weight-only
QuantizedDense.  Plain matrix products go to ``torch.matmul``, as the
JAX package left them to XLA; QuantizedDense goes through the port's
int8 kernel (``kernels/quantize.py``).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known


# ----------------------------------------------------------------------
# Activation
# ----------------------------------------------------------------------
class _ActivationParam(ParamStruct):
    act_type = Field(str, required=True,
                     enum=("relu", "sigmoid", "tanh", "softrelu"))


@register_op("Activation")
class Activation(OperatorProperty):
    """activation-inl.h."""
    param_cls = _ActivationParam

    _FNS = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softrelu": torch.nn.functional.softplus,
    }

    def forward(self, inputs, aux, is_train, rng):
        return [self._FNS[self.param.act_type](inputs[0])], None


# ----------------------------------------------------------------------
# FullyConnected / QuantizedDense
# ----------------------------------------------------------------------
class _FCParam(ParamStruct):
    num_hidden = Field(int, required=True, lower=1)
    no_bias = Field(bool, default=False)


def _dense_shapes(op, in_shapes, extra_args=()):
    data = in_shapes[0]
    if data is None:
        require_known(op.op_name, in_shapes[:1], ["data"])
    num_in = int(_np.prod(data[1:], dtype=_np.int64))
    nh = op.param.num_hidden
    shapes = [data, (nh, num_in)] + [(nh,)] * len(extra_args)
    if not op.param.no_bias:
        shapes.append((nh,))
    return shapes, [(data[0], nh)], []


@register_op("FullyConnected")
class FullyConnected(OperatorProperty):
    """fully_connected-inl.h:46: y = x_2d · Wᵀ + b, weight (num_hidden, D)."""
    param_cls = _FCParam

    def list_arguments(self):
        return ["data", "weight"] if self.param.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, in_shapes):
        return _dense_shapes(self, in_shapes)

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        y = torch.matmul(x, inputs[1].t())
        if not self.param.no_bias:
            y = y + inputs[2]
        return [y], None


class _QuantizedDenseParam(ParamStruct):
    num_hidden = Field(int, required=True, lower=1)
    no_bias = Field(bool, default=False)
    qdtype = Field(str, default="int8", enum=("int8", "fp8_e4m3"))


@register_op("QuantizedDense")
class QuantizedDense(OperatorProperty):
    """Weight-only quantized FullyConnected: y = x_2d · dequant(Wq)ᵀ + b.

    Produced by ``kernels.quantize.quantize_symbol``; the weight rides
    in int8 with a per-output-channel float32 ``scale`` argument at
    index 2.  Forward is ``kernels.quantize.quantized_matmul``: the CUDA
    kernel for a tensor on the GPU, its plain version on the CPU.
    """
    param_cls = _QuantizedDenseParam

    def list_arguments(self):
        args = ["data", "weight", "scale"]
        if not self.param.no_bias:
            args.append("bias")
        return args

    def infer_shape(self, in_shapes):
        return _dense_shapes(self, in_shapes, extra_args=("scale",))

    def forward(self, inputs, aux, is_train, rng):
        from ..kernels.quantize import quantized_matmul
        if self.param.qdtype != "int8":
            raise MXNetError("QuantizedDense: the port serves int8 weights "
                             "only, got qdtype=%r" % self.param.qdtype)
        x = inputs[0].reshape(inputs[0].shape[0], -1).contiguous()
        y = quantized_matmul(x, inputs[1], inputs[2])
        if not self.param.no_bias:
            y = y + inputs[3]
        return [y], None


# ----------------------------------------------------------------------
# Reshape
# ----------------------------------------------------------------------
class _ReshapeParam(ParamStruct):
    shape = Field(tuple, default=None, doc="0 keeps input dim, -1 infers")
    target_shape = Field(tuple, default=None, doc="legacy exact shape")
    keep_highest = Field(bool, default=False)


@register_op("Reshape")
class Reshape(OperatorProperty):
    param_cls = _ReshapeParam

    def _target(self, in_shape):
        p = self.param
        if p.shape is None and p.target_shape is None:
            raise MXNetError("Reshape needs shape or target_shape")
        size = int(_np.prod(in_shape, dtype=_np.int64))
        if p.shape is not None:
            out = [in_shape[i] if s == 0 else s
                   for i, s in enumerate(p.shape)]
        else:
            out = list(p.target_shape)
            if p.keep_highest:
                out[0] = in_shape[0]
            elif out and out[0] == 0:
                out[0] = -1
        if -1 in out:
            known = int(_np.prod([s for s in out if s != -1], dtype=_np.int64))
            out[out.index(-1)] = size // known
        tgt = tuple(int(s) for s in out)
        if int(_np.prod(tgt, dtype=_np.int64)) != size:
            raise MXNetError("Reshape %s -> %s size mismatch" % (in_shape, tgt))
        return tgt

    def infer_shape(self, in_shapes):
        require_known("Reshape", in_shapes, ["data"])
        return in_shapes, [self._target(in_shapes[0])], []

    def forward(self, inputs, aux, is_train, rng):
        return [inputs[0].reshape(self._target(tuple(inputs[0].shape)))], None


# ----------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------
class _EmbeddingParam(ParamStruct):
    input_dim = Field(int, required=True, lower=1)
    output_dim = Field(int, required=True, lower=1)


@register_op("Embedding")
class Embedding(OperatorProperty):
    """embedding-inl.h: weight rows gathered by integer ids."""
    param_cls = _EmbeddingParam

    def list_arguments(self):
        return ["data", "weight"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("Embedding", in_shapes[:1], ["data"])
        p = self.param
        w = (p.input_dim, p.output_dim)
        return [data, w], [tuple(data) + (p.output_dim,)], []

    def forward(self, inputs, aux, is_train, rng):
        # ids arrive as float32 (the reference's data layout); cast
        # before indexing, as mxnet_tpu casts with astype(int32).
        # F.embedding's backward on a GPU sorts the ids and sums each
        # row's gradients in a fixed order: runs repeat bit for bit
        ids = inputs[0].to(torch.int64)
        return [torch.nn.functional.embedding(ids, inputs[1])], None
