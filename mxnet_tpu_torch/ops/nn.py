"""Neural-network operators of the generation, training and image graphs.

The port's slice of ``mxnet_tpu/ops/nn.py``: FullyConnected, Activation,
Flatten, Reshape (with MXNet's ``0``/``-1`` codes), Embedding, the
weight-only QuantizedDense, and the operators of the image models:
Convolution, BatchNorm (alias CuDNNBatchNorm), Pooling, ElementWiseSum
(alias add_n) and Dropout.  Plain matrix products go to ``torch.matmul``
and convolutions to ``F.conv*d`` (cuDNN on the card), as the JAX package
left both to XLA; QuantizedDense goes through the port's weight-only
kernel (``kernels/quantize.py``), int8 or fp8 e4m3.
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
    in ``qdtype`` (int8 or ``torch.float8_e4m3fn``) with a
    per-output-channel float32 ``scale`` argument at index 2.  Forward
    is ``kernels.quantize.quantized_matmul``: the CUDA kernel for a
    tensor on the GPU, its plain version on the CPU.
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
        from ..kernels.quantize import STORAGE_DTYPES, quantized_matmul
        if inputs[1].dtype != STORAGE_DTYPES[self.param.qdtype]:
            raise MXNetError("QuantizedDense: qdtype=%r wants %s weights, "
                             "got %s" % (self.param.qdtype,
                                         STORAGE_DTYPES[self.param.qdtype],
                                         inputs[1].dtype))
        x = inputs[0].reshape(inputs[0].shape[0], -1).contiguous()
        y = quantized_matmul(x, inputs[1], inputs[2])
        if not self.param.no_bias:
            y = y + inputs[3]
        return [y], None


# ----------------------------------------------------------------------
# Flatten / Reshape
# ----------------------------------------------------------------------
@register_op("Flatten")
class Flatten(OperatorProperty):
    """(B, ...) -> (B, prod(...))."""

    def infer_shape(self, in_shapes):
        require_known("Flatten", in_shapes, ["data"])
        d = in_shapes[0]
        return in_shapes, [(d[0], int(_np.prod(d[1:], dtype=_np.int64)))], []

    def forward(self, inputs, aux, is_train, rng):
        return [inputs[0].reshape(inputs[0].shape[0], -1)], None



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


# ----------------------------------------------------------------------
# Convolution
# ----------------------------------------------------------------------
class _ConvParam(ParamStruct):
    kernel = Field(tuple, required=True)
    stride = Field(tuple, default=None)
    dilate = Field(tuple, default=None)
    pad = Field(tuple, default=None)
    num_filter = Field(int, required=True, lower=1)
    num_group = Field(int, default=1, lower=1)
    no_bias = Field(bool, default=False)
    workspace = Field(int, default=1024, doc="ignored")
    cudnn_tune = Field(str, default=None, doc="ignored")
    cudnn_off = Field(bool, default=False, doc="ignored")

    def spatial(self):
        k = tuple(self.kernel)
        nd = len(k)
        s = tuple(self.stride) if self.stride else (1,) * nd
        d = tuple(self.dilate) if self.dilate else (1,) * nd
        p = tuple(self.pad) if self.pad else (0,) * nd
        return k, s, d, p


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


@register_op("Convolution")
class Convolution(OperatorProperty):
    """convolution-inl.h: one ``F.conv{1,2,3}d`` (cuDNN on the card).
    Layouts NC + spatial, weight (num_filter, C/num_group, *kernel) =
    OIHW, as the reference's, so checkpoints interchange.  The bias is
    added after the convolution, as the JAX package adds it."""
    param_cls = _ConvParam

    def list_arguments(self):
        return ["data", "weight"] if self.param.no_bias \
            else ["data", "weight", "bias"]

    def _out_spatial(self, in_spatial):
        k, s, d, p = self.param.spatial()
        return tuple((ins + 2 * ps - ((ks - 1) * ds + 1)) // ss + 1
                     for ins, ks, ss, ds, ps in zip(in_spatial, k, s, d, p))

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("Convolution", in_shapes[:1], ["data"])
        p = self.param
        k = p.spatial()[0]
        if len(data) != len(k) + 2:
            raise MXNetError("Convolution: data ndim %d vs kernel %s"
                             % (len(data), k))
        shapes = [data, (p.num_filter, data[1] // p.num_group) + k]
        if not p.no_bias:
            shapes.append((p.num_filter,))
        out = (data[0], p.num_filter) + self._out_spatial(data[2:])
        return shapes, [out], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        k, s, d, pad = p.spatial()
        if len(k) not in _CONV:
            raise MXNetError("Convolution supports 1-3 spatial dims")
        y = _CONV[len(k)](inputs[0], inputs[1], None, s, pad, d,
                          p.num_group)
        if not p.no_bias:
            y = y + inputs[2].reshape((1, -1) + (1,) * len(k))
        return [y], None


# ----------------------------------------------------------------------
# Pooling
# ----------------------------------------------------------------------
class _PoolingParam(ParamStruct):
    kernel = Field(tuple, required=True)
    pool_type = Field(str, default="max", enum=("max", "avg", "sum"))
    stride = Field(tuple, default=None)
    pad = Field(tuple, default=None)
    global_pool = Field(bool, default=False)
    pooling_convention = Field(str, default="valid", enum=("valid", "full"))


_MAX_POOL = {2: torch.nn.functional.max_pool2d,
             3: torch.nn.functional.max_pool3d}
_AVG_POOL = {2: torch.nn.functional.avg_pool2d,
             3: torch.nn.functional.avg_pool3d}


@register_op("Pooling")
class Pooling(OperatorProperty):
    """pooling-inl.h, as the JAX package computes it: the input is padded
    explicitly (-inf for max, 0 for sum and avg; the high side by enough
    for the ``full`` convention's ceil, and never less than ``pad``),
    then pooled with no padding.  ``avg`` divides every window by
    ``prod(kernel)``, whatever the padding.  1-D pooling runs as 2-D
    over a unit axis."""
    param_cls = _PoolingParam

    def _conf(self, in_spatial):
        p = self.param
        if p.global_pool:
            k = tuple(in_spatial)
            return k, k, (0,) * len(k)
        k = tuple(p.kernel)
        s = tuple(p.stride) if p.stride else (1,) * len(k)
        pad = tuple(p.pad) if p.pad else (0,) * len(k)
        return k, s, pad

    def _out_spatial(self, in_spatial):
        k, s, pad = self._conf(in_spatial)
        out = []
        for ins, ks, ss, ps in zip(in_spatial, k, s, pad):
            if self.param.pooling_convention == "full":
                o = int(_np.ceil((ins + 2 * ps - ks) / ss)) + 1
            else:
                o = (ins + 2 * ps - ks) // ss + 1
            out.append(max(o, 1))
        return tuple(out)

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("Pooling", in_shapes, ["data"])
        return [data], [tuple(data[:2]) + self._out_spatial(data[2:])], []

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        nd = x.dim() - 2
        if nd not in (1, 2, 3):
            raise MXNetError("Pooling supports 1-3 spatial dims")
        k, s, pad = self._conf(tuple(x.shape[2:]))
        out_sp = self._out_spatial(tuple(x.shape[2:]))
        widths = []             # F.pad's order: the last axis first
        for i in reversed(range(nd)):
            hi = (out_sp[i] - 1) * s[i] + k[i] - x.shape[2 + i] - pad[i]
            widths += [pad[i], max(hi, pad[i])]
        pt = self.param.pool_type
        fill = float("-inf") if pt == "max" else 0.0
        if any(widths):
            x = torch.nn.functional.pad(x, widths, value=fill)
        if nd == 1:
            x, k, s = x.unsqueeze(2), (1,) + k, (1,) + s
        dims = len(k)
        if pt == "max":
            out = _MAX_POOL[dims](x, k, s)
        else:
            div = int(_np.prod(k)) if pt == "avg" else 1
            out = _AVG_POOL[dims](x, k, s, divisor_override=div)
        if nd == 1:
            out = out.squeeze(2)
        return [out], None


# ----------------------------------------------------------------------
# BatchNorm
# ----------------------------------------------------------------------
class _BatchNormParam(ParamStruct):
    eps = Field(float, default=1e-3)
    momentum = Field(float, default=0.9)
    fix_gamma = Field(bool, default=True)
    use_global_stats = Field(bool, default=False)


@register_op("BatchNorm", aliases=("CuDNNBatchNorm",))
class BatchNorm(OperatorProperty):
    """batch_norm-inl.h: normalise over every axis but 1.

    ``fix_gamma`` replaces gamma by ones (its gradient is then zero;
    weight decay still moves it).  In training, without
    ``use_global_stats``, the output uses the batch's mean and biased
    variance, and the aux updates are ``momentum * moving + (1 -
    momentum) * batch`` with the biased variance, as in the JAX package;
    ``F.batch_norm`` is given no running buffers (its own running update
    uses the unbiased variance and the other momentum convention), and
    the updates are computed here, outside autograd (the aux carry no
    gradient).  Otherwise the moving statistics normalise and nothing
    is updated."""
    param_cls = _BatchNormParam

    def list_arguments(self):
        return ["data", "gamma", "beta"]

    def list_auxiliary_states(self):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("BatchNorm", in_shapes[:1], ["data"])
        c = (data[1],)
        return [data, c, c], [data], [c, c]

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        x, gamma, beta = inputs
        moving_mean, moving_var = aux
        if p.fix_gamma:
            gamma = torch.ones_like(gamma)   # no gradient flows to gamma
        if is_train and not p.use_global_stats:
            out = torch.nn.functional.batch_norm(x, None, None, gamma, beta,
                                                 True, 0.0, p.eps)
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                var, mean = torch.var_mean(x.detach(), dim=dims,
                                           correction=0)
                m = p.momentum
                aux_updates = [m * moving_mean + (1 - m) * mean,
                               m * moving_var + (1 - m) * var]
            return [out], aux_updates
        out = torch.nn.functional.batch_norm(
            x, moving_mean.detach(), moving_var.detach(), gamma, beta,
            False, 0.0, p.eps)
        return [out], None


# ----------------------------------------------------------------------
# Dropout / ElementWiseSum
# ----------------------------------------------------------------------
class _DropoutParam(ParamStruct):
    p = Field(float, default=0.5, lower=0.0, upper=1.0)


@register_op("Dropout")
class Dropout(OperatorProperty):
    """dropout-inl.h: inverted dropout in training, the identity
    otherwise.  The keep mask is drawn from the ``torch.Generator`` the
    caller hands over (``rng``), on the data's device."""
    param_cls = _DropoutParam
    need_rng = True

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        p = self.param.p
        if not is_train or p <= 0.0:
            return [x], None
        u = torch.rand(x.shape, generator=rng, device=x.device)
        keep = u < (1.0 - p)
        return [torch.where(keep, x / (1.0 - p),
                            torch.zeros((), dtype=x.dtype,
                                        device=x.device))], None


class _EWSumParam(ParamStruct):
    num_args = Field(int, required=True, lower=1)


@register_op("ElementWiseSum", aliases=("add_n",))
class ElementWiseSum(OperatorProperty):
    """The sum of ``num_args`` same-shape inputs, added left to right."""
    param_cls = _EWSumParam

    def list_arguments(self):
        return ["arg%d" % i for i in range(self.param.num_args)]

    def infer_shape(self, in_shapes):
        known = [s for s in in_shapes if s is not None]
        if not known:
            require_known("ElementWiseSum", in_shapes, self.list_arguments())
        return [known[0] if s is None else s for s in in_shapes], \
            [known[0]], []

    def forward(self, inputs, aux, is_train, rng):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out], None
