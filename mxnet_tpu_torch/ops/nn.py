"""Neural-network operators of the generation, training and image graphs.

The port's slice of ``mxnet_tpu/ops/nn.py``: FullyConnected, Activation,
Flatten, Reshape (with MXNet's ``0``/``-1`` codes), Embedding, the
weight-only QuantizedDense, and the operators of the image models:
Convolution, BatchNorm (alias CuDNNBatchNorm), Pooling, ElementWiseSum
(alias add_n), Dropout, the model zoo's Concat and LRN, and the
recurrent models' SliceChannel, SwapAxis and Cast, and LeakyReLU,
SoftmaxActivation, BlockGrad, Deconvolution (``F.conv_transpose*d``),
UpSampling, Crop and L2Normalization.  Plain
matrix products go to ``torch.matmul`` and convolutions to ``F.conv*d``
(cuDNN on the card), as the JAX package left both to XLA; QuantizedDense
goes through the port's weight-only kernel (``kernels/quantize.py``),
int8 or fp8 e4m3.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from ..ndarray import _torch_dtype
from .registry import (OperatorProperty, register_op, require_known,
                       contract_sharding, dedup_axes, reshape_carry)


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


def _dense_tp(op, x, w, b, product):
    """The tensor-parallel form of a dense layer ``y = product(x2d, w) +
    b`` whose weight ``w`` is split over tp (``parallel/tensor_parallel``):
    split on axis 0 (output features) each member computes its columns
    and the columns are gathered; on axis 1 (input features) each member
    multiplies its slice of ``x`` and the partial products are summed.
    ``product(x, w_part, e)`` is member ``e``'s product."""
    from ..parallel import tensor_parallel as tp
    if tp.is_split(x):
        raise tp.unsupported(op.op_name, "the data input is split")
    if not tp.is_split(w):
        raise tp.unsupported(op.op_name, "the bias is split but the weight "
                             "is whole")
    g = w.group
    x2 = x.reshape(x.shape[0], -1)
    if w.dim == 0:
        xs = tp.scatter(g, x2)
        parts = [product(xs[e], w.shards[e], e) for e in range(g.n)]
        if tp.is_split(b):
            parts = [p + b.shards[e] for e, p in enumerate(parts)]
        y = tp.gather(g, parts, 1)
    else:
        xs = tp.split(g, x2, 1)
        y = tp.reduce(g, [product(xs[e], w.shards[e], e)
                          for e in range(g.n)])
        if tp.is_split(b):
            raise tp.unsupported(op.op_name, "a weight split on its input "
                                 "features with a split bias")
    if b is not None and not tp.is_split(b):
        y = y + b
    return y


@register_op("FullyConnected")
class FullyConnected(OperatorProperty):
    """fully_connected-inl.h:46: y = x_2d · Wᵀ + b, weight (num_hidden, D)."""
    param_cls = _FCParam
    mxu = True

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

    def forward_tp(self, inputs, aux, is_train, rng):
        """Column- or row-parallel over a tp-split weight
        (:func:`_dense_tp`)."""
        b = None if self.param.no_bias else inputs[2]
        return [_dense_tp(self, inputs[0], inputs[1], b,
                          lambda x, w, e: torch.matmul(x, w.t()))], None

    def cost_mxu_dims(self, in_shapes, out_shapes):
        data = in_shapes[0]
        num_in = int(_np.prod(data[1:], dtype=_np.int64))
        return [(int(data[0]), num_in, int(self.param.num_hidden))]

    def cost_flops(self, in_shapes, out_shapes):
        (m, k, n), = self.cost_mxu_dims(in_shapes, out_shapes)
        bias = m * n if not self.param.no_bias else 0
        return float(2 * m * k * n + bias)

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data, weight = in_specs[0], in_specs[1]
        # forward flattens data[1:]: any sharded non-batch dim is part of
        # the contraction against weight dim 1
        c_idx = next((i for i in range(1, len(data)) if data[i]), None)
        d_c = data[c_idx] if c_idx is not None else ()
        w_c = weight[1] if len(weight) > 1 else ()
        reduce, notes, conflict = contract_sharding(
            d_c, w_c, 0, 1, "FullyConnected")
        required = [None] * len(in_specs)
        if conflict:
            req = list(data)
            req[c_idx] = w_c
            required[0] = tuple(req)
        batch = data[0] if data else ()
        cols = dedup_axes(weight[0] if weight else (), batch)
        if not self.param.no_bias and len(required) > 2:
            required[2] = (cols,)
        out = {"out": [(tuple(batch), cols)], "in": required}
        if reduce:
            out["reduce"] = reduce
        if notes:
            out["notes"] = notes
        return out


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
    mxu = True

    def list_arguments(self):
        args = ["data", "weight", "scale"]
        if not self.param.no_bias:
            args.append("bias")
        return args

    def infer_shape(self, in_shapes):
        return _dense_shapes(self, in_shapes, extra_args=("scale",))

    def infer_type(self, in_types):
        from ..kernels.quantize import storage_dtype
        wide = next((t for i, t in enumerate(in_types)
                     if t is not None and i not in (1, 2)), None)
        types = [wide, storage_dtype(self.param.qdtype), torch.float32]
        if not self.param.no_bias:
            types.append(wide)
        return types, [wide], []

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

    def forward_tp(self, inputs, aux, is_train, rng):
        """The weight-only kernel on each member's slice of ``w_q``: its
        rows (output channels) with their slice of ``scale``, or its
        columns with the whole scale, then :func:`_dense_tp`'s gather or
        sum."""
        from ..kernels.quantize import quantized_matmul
        from ..parallel import tensor_parallel as tp
        w, scale = inputs[1], inputs[2]
        if w.dtype != self._storage():
            raise MXNetError("QuantizedDense: qdtype=%r wants %s weights, "
                             "got %s" % (self.param.qdtype, self._storage(),
                                         w.dtype))
        if tp.is_split(w) and w.dim == 0 and not tp.is_split(scale):
            raise tp.unsupported(self.op_name, "rows of the weight split "
                                 "without their scale")
        if tp.is_split(w) and w.dim == 1 and tp.is_split(scale):
            raise tp.unsupported(self.op_name, "a split scale for a weight "
                                 "split on its input features")

        def product(x, w_part, e):
            sc = scale.shards[e] if tp.is_split(scale) \
                else tp.scatter(w.group, scale)[e]
            return quantized_matmul(x.contiguous(), w_part, sc)
        b = None if self.param.no_bias else inputs[3]
        return [_dense_tp(self, inputs[0], w, b, product)], None

    def _storage(self):
        from ..kernels.quantize import STORAGE_DTYPES
        return STORAGE_DTYPES[self.param.qdtype]

    # compute dtype of the MXU contraction (roofline prices peaks at it)
    def cost_compute_dtype(self, in_shapes, out_shapes):
        return "fp8" if self.param.qdtype == "fp8_e4m3" else "int8"

    def cost_mxu_dims(self, in_shapes, out_shapes):
        data = in_shapes[0]
        num_in = int(_np.prod(data[1:], dtype=_np.int64))
        return [(int(data[0]), num_in, int(self.param.num_hidden))]

    def cost_flops(self, in_shapes, out_shapes):
        (m, k, n), = self.cost_mxu_dims(in_shapes, out_shapes)
        extra = m * n                       # scale epilogue
        if not self.param.no_bias:
            extra += m * n
        return float(2 * m * k * n + extra)

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data, weight = in_specs[0], in_specs[1]
        c_idx = next((i for i in range(1, len(data)) if data[i]), None)
        d_c = data[c_idx] if c_idx is not None else ()
        w_c = weight[1] if len(weight) > 1 else ()
        reduce, notes, conflict = contract_sharding(
            d_c, w_c, 0, 1, "QuantizedDense")
        required = [None] * len(in_specs)
        if conflict:
            req = list(data)
            req[c_idx] = w_c
            required[0] = tuple(req)
        batch = data[0] if data else ()
        cols = dedup_axes(weight[0] if weight else (), batch)
        # scale (and bias) are per-output-channel rows: follow cols
        if len(required) > 2:
            required[2] = (cols,)
        if not self.param.no_bias and len(required) > 3:
            required[3] = (cols,)
        out = {"out": [(tuple(batch), cols)], "in": required}
        if reduce:
            out["reduce"] = reduce
        if notes:
            out["notes"] = notes
        return out


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

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        return {"out": [reshape_carry(in_specs[0], in_shapes[0],
                                      out_shapes[0], mesh_shape)]}


class _ReshapeParam(ParamStruct):
    shape = Field(tuple, default=None, doc="0 keeps input dim, -1 infers")
    target_shape = Field(tuple, default=None, doc="legacy exact shape")
    keep_highest = Field(bool, default=False)


@register_op("Reshape")
class Reshape(OperatorProperty):
    param_cls = _ReshapeParam

    def _target(self, in_shape, shape=None):
        """The output shape for ``in_shape`` (``shape``: the ``shape``
        attr rewritten by the sequence-parallel form)."""
        p = self.param
        if p.shape is None and p.target_shape is None:
            raise MXNetError("Reshape needs shape or target_shape")
        size = int(_np.prod(in_shape, dtype=_np.int64))
        if p.shape is not None:
            out = [in_shape[i] if s == 0 else s
                   for i, s in enumerate(shape or p.shape)]
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

    def forward_sp(self, ins, lays, walk):
        """Each member's block reshaped (``sequence_parallel``): a target
        that names the whole sequence (the LM's ``(-1, seq_len, dim)``)
        takes the member's ``S/sp`` there."""
        from ..parallel.sequence_parallel import reshape_target
        out, jo = reshape_target(self, ins[0][0], lays[0], walk)
        return [[x[0].reshape(out)] for x in ins], [jo]

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        return {"out": [reshape_carry(in_specs[0], in_shapes[0],
                                      out_shapes[0], mesh_shape)]}


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
        # before indexing as mxnet_tpu's astype(int32) + jnp.take do: a
        # NaN id is row 0, a negative id counts from the end, and an id
        # outside [-input_dim, input_dim) gives a row of NaN and no
        # gradient (an injected NaN batch or a corrupt token must not
        # index out of bounds).  F.embedding's backward on a GPU sorts
        # the ids and sums each row's gradients in a fixed order: runs
        # repeat bit for bit
        ids, weight = inputs[0], inputs[1]
        if ids.is_floating_point():
            ids = torch.nan_to_num(ids, nan=0.0).clamp(-2.0 ** 31,
                                                       2.0 ** 31)
        ids = ids.to(torch.int64)
        rows = weight.shape[0]
        ids = torch.where(ids < 0, ids + rows, ids)
        valid = (ids >= 0) & (ids < rows)
        out = torch.nn.functional.embedding(torch.where(valid, ids, 0),
                                            weight)
        return [torch.where(valid.unsqueeze(-1), out, float("nan"))], None

    def forward_tp(self, inputs, aux, is_train, rng):
        """Over a tp-split table: split on the vocabulary, each member
        looks up the ids it holds (zeros for the others) and the rows are
        summed, so every row is exact; split on the features, each member
        looks up its columns and they are gathered.  Ids outside the
        vocabulary give NaN rows, as :meth:`forward`."""
        from ..parallel import tensor_parallel as tp
        ids, weight = inputs[0], inputs[1]
        if tp.is_split(ids):
            raise tp.unsupported(self.op_name, "the ids are split")
        if ids.is_floating_point():
            ids = torch.nan_to_num(ids, nan=0.0).clamp(-2.0 ** 31,
                                                       2.0 ** 31)
        ids = ids.to(torch.int64)
        rows = weight.shape[0]
        ids = torch.where(ids < 0, ids + rows, ids)
        valid = (ids >= 0) & (ids < rows)
        ids = torch.where(valid, ids, 0)
        g = weight.group
        idss = tp.scatter(g, ids)
        F = torch.nn.functional
        if weight.dim == 0:
            parts = []
            for e in range(g.n):
                lo, hi = weight.bounds(e)
                local = idss[e] - lo
                mine = (local >= 0) & (local < hi - lo)
                got = F.embedding(torch.where(mine, local, 0),
                                  weight.shards[e])
                parts.append(torch.where(mine.unsqueeze(-1), got,
                                         torch.zeros((), dtype=got.dtype,
                                                     device=got.device)))
            out = tp.reduce(g, parts)
        else:
            out = tp.gather(g, [F.embedding(idss[e], weight.shards[e])
                                for e in range(g.n)], -1)
        return [torch.where(valid.unsqueeze(-1), out, float("nan"))], None

    def cost_bytes_elements(self, in_shapes, out_shapes):
        # gather: ids + the gathered rows in and out, not the full table
        return float(_np.prod(in_shapes[0], dtype=_np.int64)
                     + 2 * _np.prod(out_shapes[0], dtype=_np.int64))

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data, weight = in_specs[0], in_specs[1]
        used = [a for e in data for a in e]
        feat = dedup_axes(weight[1] if len(weight) > 1 else (), used)
        out = {"out": [tuple(data) + (feat,)]}
        vocab = tuple(weight[0] if weight else ())
        if vocab:
            # vocab-sharded table: each shard gathers local hits only and
            # the partial one-hot matmul is psummed across the axis
            out["reduce"] = {vocab: "vocab-sharded Embedding lookup: each "
                                    "shard contributes rows it owns"}
        return out


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
    mxu = True

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

    def forward_tp(self, inputs, aux, is_train, rng):
        """Over a tp-split weight: split on the output channels, each
        member convolves with its filters (and adds its bias) and the
        channels are gathered; split on the input channels, each member
        convolves its channels of the data and the partial outputs are
        summed."""
        from ..parallel import tensor_parallel as tp
        p = self.param
        k, s, d, pad = p.spatial()
        x, w = inputs[0], inputs[1]
        b = None if p.no_bias else inputs[2]
        if tp.is_split(x) or not tp.is_split(w) or w.dim > 1:
            raise tp.unsupported(self.op_name, "only the weight may be "
                                 "split, on its output or input channels")
        if p.num_group != 1:
            raise tp.unsupported(self.op_name, "grouped convolution")
        g, conv = w.group, _CONV[len(k)]
        bshape = (1, -1) + (1,) * len(k)
        if w.dim == 0:
            xs = tp.scatter(g, x)
            parts = [conv(xs[e], w.shards[e], None, s, pad, d)
                     for e in range(g.n)]
            if tp.is_split(b):
                parts = [q + b.shards[e].reshape(bshape)
                         for e, q in enumerate(parts)]
            y = tp.gather(g, parts, 1)
        else:
            if tp.is_split(b):
                raise tp.unsupported(self.op_name, "a split bias for a "
                                     "weight split on its input channels")
            xs = tp.split(g, x, 1)
            y = tp.reduce(g, [conv(xs[e], w.shards[e], None, s, pad, d)
                              for e in range(g.n)])
        if b is not None and not tp.is_split(b):
            y = y + b.reshape(bshape)
        return [y], None

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data, weight = in_specs[0], in_specs[1]
        # input channels (data dim 1 x weight dim 1) are the contraction;
        # spatial dims stay replicated (halo exchange is out of scope)
        d_c = data[1] if len(data) > 1 else ()
        w_c = weight[1] if len(weight) > 1 else ()
        reduce, notes, conflict = contract_sharding(
            d_c, w_c, 0, 1, "Convolution")
        required = [None] * len(in_specs)
        if conflict:
            req = list(data)
            req[1] = w_c
            required[0] = tuple(req)
        batch = data[0] if data else ()
        cols = dedup_axes(weight[0] if weight else (), batch)
        if not self.param.no_bias and len(required) > 2:
            required[2] = (cols,)
        spec = (tuple(batch), cols) + ((),) * (len(out_shapes[0]) - 2)
        out = {"out": [spec], "in": required}
        if reduce:
            out["reduce"] = reduce
        if notes:
            out["notes"] = notes
        return out

    def cost_mxu_dims(self, in_shapes, out_shapes):
        # XLA lowers the conv as an im2col matmul per group:
        # (batch*out_spatial) x (C/g * prod(kernel)) x (filters/g)
        p = self.param
        data, out = in_shapes[0], out_shapes[0]
        k, _, _, _ = p.spatial()
        m = int(data[0] * _np.prod(out[2:], dtype=_np.int64))
        kk = int((data[1] // p.num_group) * _np.prod(k, dtype=_np.int64))
        return [(m, kk, p.num_filter // p.num_group)] * p.num_group

    def cost_flops(self, in_shapes, out_shapes):
        flops = sum(2 * m * k * n for m, k, n in
                    self.cost_mxu_dims(in_shapes, out_shapes))
        if not self.param.no_bias:
            flops += int(_np.prod(out_shapes[0], dtype=_np.int64))
        return float(flops)


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

    def cost_flops(self, in_shapes, out_shapes):
        k, _s, _p = self._conf(in_shapes[0][2:])
        return float(_np.prod(out_shapes[0], dtype=_np.int64)
                     * _np.prod(k, dtype=_np.int64))

    def cost_reduce_len(self, in_shapes, out_shapes):
        if self.param.pool_type == "max":
            return None     # max accumulation is exact in any dtype
        k, _s, _p = self._conf(in_shapes[0][2:])
        return int(_np.prod(k, dtype=_np.int64))


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

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """The lockstep walk's BatchNorm (``executor.build_program``): in
        training, without ``use_global_stats``, the statistics of the
        whole batch over every replica (:class:`_CrossReplicaBatchNorm`),
        as the JAX package's dp-sharded step computes them; every replica
        takes the same moving-statistics update.  Otherwise each replica
        runs :meth:`forward` (None)."""
        p = self.param
        if not (is_train and not p.use_global_stats):
            return None
        n = len(ins)
        xs = [i[0] for i in ins]
        gammas = [torch.ones_like(i[1]).detach() if p.fix_gamma else i[1]
                  for i in ins]
        betas = [i[2] for i in ins]
        got = _CrossReplicaBatchNorm.apply(group, p.eps, *xs, *gammas,
                                           *betas)
        outs, means, vars_ = got[:n], got[n:2 * n], got[2 * n:]
        m = p.momentum
        aux_updates = []
        with torch.no_grad():
            for (moving_mean, moving_var), mean, var in zip(aux, means,
                                                            vars_):
                aux_updates.append([m * moving_mean + (1 - m) * mean,
                                    m * moving_var + (1 - m) * var])
        return [[o] for o in outs], aux_updates, False


def _channel_view(v, x):
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data = in_specs[0]
        chan = data[1] if len(data) > 1 else ()
        return {"out": [tuple(data)],
                "in": [None, (chan,), (chan,)]}


class _CrossReplicaBatchNorm(torch.autograd.Function):
    """BatchNorm over a batch split across replicas: ``apply(group, eps,
    *xs, *gammas, *betas)`` (one each a replica) returns each replica's
    output, then the batch mean and biased variance on every replica's
    device.  Each replica takes its own mean and variance in one pass
    (``torch.var_mean``); the batch's are their combination over the
    replicas: one sum of each replica's count-weighted mean and second
    moment (variance plus squared mean), in float64, two values a
    channel; the statistics then in float32 for a float32 or narrower
    input.  The output is ``(x - mean) * scale + beta`` with the
    per-channel ``scale = gamma / sqrt(var + eps)``.  The backward sums
    ``sum(dy)`` and ``sum(dy * (x - mean))`` over the replicas once and
    gives each replica its share of the gamma and beta gradients (the
    parameters' gradients are summed over the replicas after the
    backward, as every replicated parameter's are)."""

    @staticmethod
    def forward(ctx, group, eps, *tensors):
        from ..parallel.collectives import all_reduce
        n = len(tensors) // 3
        xs, gammas, betas = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        acc = torch.float64 if xs[0].dtype == torch.float64 \
            else torch.float32
        dims = [0] + list(range(2, xs[0].dim()))
        rows = [x.numel() // x.shape[1] for x in xs]
        count = sum(rows) * group.num_processes
        local = [torch.var_mean(x.to(acc), dim=dims, correction=0)
                 for x in xs]
        # one sum over the replicas of each replica's count-weighted mean
        # and second moment, in float64 (the moment's mean square is
        # subtracted below, so its rounding must stay far below var's)
        c = xs[0].shape[1]
        sums = all_reduce(group, [
            torch.cat([m.double() * r, (v.double() + torch.square(
                m.double())) * r]) for (v, m), r in zip(local, rows)])
        means = [s[:c] / count for s in sums]
        vars_ = [(s[c:] / count - torch.square(mu)).clamp_(min=0).to(acc)
                 for s, mu in zip(sums, means)]
        means = [mu.to(acc) for mu in means]
        invstds = [torch.rsqrt(v + eps) for v in vars_]
        outs = []
        for x, mu, inv, g, b in zip(xs, means, invstds, gammas, betas):
            outs.append(torch.addcmul(
                _channel_view(b.to(acc), x), x.to(acc) - _channel_view(mu, x),
                _channel_view(g.to(acc) * inv, x)).to(x.dtype))
        ctx.group, ctx.count = group, count
        ctx.save_for_backward(*xs, *gammas, *means, *invstds)
        stats = [m.to(x.dtype) for m, x in zip(means, xs)] \
            + [v.to(x.dtype) for v, x in zip(vars_, xs)]
        ctx.mark_non_differentiable(*stats)
        return tuple(outs) + tuple(stats)

    @staticmethod
    def backward(ctx, *grads):
        from ..parallel.collectives import all_reduce
        saved = ctx.saved_tensors
        n = len(saved) // 4
        xs, gammas = saved[:n], saved[n:2 * n]
        means, invstds = saved[2 * n:3 * n], saved[3 * n:]
        acc = means[0].dtype
        dims = [0] + list(range(2, xs[0].dim()))
        xmus, dys, local = [], [], []
        for x, mu, dy in zip(xs, means, grads[:n]):
            xmu = x.to(acc) - _channel_view(mu, x)
            dy = dy.to(acc)
            xmus.append(xmu)
            dys.append(dy)
            local.append(torch.cat([dy.sum(dims), (dy * xmu).sum(dims)]))
        total = all_reduce(ctx.group, local)
        c = xs[0].shape[1]
        dxs, dgammas, dbetas = [], [], []
        for x, g, inv, dy, xmu, tot, loc in zip(xs, gammas, invstds, dys,
                                                xmus, total, local):
            sdy, sdyxmu = tot[:c] / ctx.count, tot[c:] / ctx.count
            a = g.to(acc) * inv
            dx = torch.addcmul(
                torch.addcmul(_channel_view(-a * sdy, x), xmu,
                              _channel_view(-a * inv * inv * sdyxmu, x)),
                dy, _channel_view(a, x))
            dxs.append(dx.to(x.dtype))
            dgammas.append((loc[c:] * inv).to(g.dtype))
            dbetas.append(loc[:c].to(g.dtype))
        return (None, None) + tuple(dxs) + tuple(dgammas) + tuple(dbetas)


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


# ----------------------------------------------------------------------
# Concat / LRN (the model zoo's inception blocks and AlexNet)
# ----------------------------------------------------------------------
class _ConcatParam(ParamStruct):
    num_args = Field(int, required=True, lower=1)
    dim = Field(int, default=1)


@register_op("Concat")
class Concat(OperatorProperty):
    """``num_args`` inputs joined along ``dim`` (one ``torch.cat``).
    ``Concat(*symbols)`` fills ``num_args`` from the count of inputs."""
    param_cls = _ConcatParam

    def list_arguments(self):
        return ["arg%d" % i for i in range(self.param.num_args)]

    def infer_shape(self, in_shapes):
        # every input must be known: the concatenated axis cannot be
        # filled backwards
        require_known("Concat", in_shapes, self.list_arguments())
        dim = self.param.dim
        out = list(in_shapes[0])
        out[dim] = sum(s[dim] for s in in_shapes)
        return in_shapes, [tuple(out)], []

    def forward(self, inputs, aux, is_train, rng):
        return [torch.cat(inputs, dim=self.param.dim)], None


class _LRNParam(ParamStruct):
    alpha = Field(float, default=1e-4)
    beta = Field(float, default=0.75)
    knorm = Field(float, default=2.0)
    nsize = Field(int, required=True)


@register_op("LRN")
class LRN(OperatorProperty):
    """lrn-inl.h: cross-channel local response normalization,
    ``x * (knorm + alpha / nsize * sum(x^2 over nsize channels))^-beta``.
    The window over axis 1 is padded ``(nsize // 2, nsize - 1 - nsize //
    2)``, as ``lax.reduce_window`` pads it in the JAX package; the sum is
    a sum pooling (``avg_pool2d`` with ``divisor_override=1``) over the
    channels of ``x^2`` viewed as ``(N, 1, C, rest)``."""
    param_cls = _LRNParam

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        x = inputs[0]
        half = p.nsize // 2
        sq = (x * x).reshape(x.shape[0], 1, x.shape[1], -1)
        sq = torch.nn.functional.pad(sq, (0, 0, half, p.nsize - 1 - half))
        ssum = torch.nn.functional.avg_pool2d(
            sq, (p.nsize, 1), 1, divisor_override=1).reshape(x.shape)
        norm = torch.pow(p.knorm + (p.alpha / p.nsize) * ssum, -p.beta)
        return [(x * norm).to(x.dtype)], None


# ----------------------------------------------------------------------
# SliceChannel / SwapAxis / Cast (the recurrent models' gates and word
# vectors, the bidirectional sort example's time-major swap)
# ----------------------------------------------------------------------
class _SliceChannelParam(ParamStruct):
    num_outputs = Field(int, required=True, lower=1)
    axis = Field(int, default=1)
    squeeze_axis = Field(bool, default=False)


@register_op("SliceChannel")
class SliceChannel(OperatorProperty):
    """slice_channel-inl.h: ``num_outputs`` equal parts along ``axis``
    (views of the input: ``torch.chunk``), each with that axis dropped
    when ``squeeze_axis`` and the parts are one wide."""
    param_cls = _SliceChannelParam

    def list_outputs(self):
        return ["output%d" % i for i in range(self.param.num_outputs)]

    def infer_shape(self, in_shapes):
        require_known("SliceChannel", in_shapes, ["data"])
        p = self.param
        d = list(in_shapes[0])
        if d[p.axis] % p.num_outputs:
            raise MXNetError("SliceChannel: dim %d not divisible by %d"
                             % (d[p.axis], p.num_outputs))
        d[p.axis] //= p.num_outputs
        if p.squeeze_axis and d[p.axis] == 1:
            d.pop(p.axis)
        return in_shapes, [tuple(d)] * p.num_outputs, []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        outs = torch.chunk(inputs[0], p.num_outputs, dim=p.axis)
        if p.squeeze_axis:
            outs = [torch.squeeze(o, p.axis) for o in outs]
        return list(outs), None


class _SwapAxisParam(ParamStruct):
    dim1 = Field(int, default=0)
    dim2 = Field(int, default=0)


@register_op("SwapAxis")
class SwapAxis(OperatorProperty):
    """swapaxis-inl.h: exchange axes ``dim1`` and ``dim2``."""
    param_cls = _SwapAxisParam

    def infer_shape(self, in_shapes):
        require_known("SwapAxis", in_shapes, ["data"])
        s = list(in_shapes[0])
        p = self.param
        s[p.dim1], s[p.dim2] = s[p.dim2], s[p.dim1]
        return in_shapes, [tuple(s)], []

    def forward(self, inputs, aux, is_train, rng):
        return [torch.transpose(inputs[0], self.param.dim1,
                                self.param.dim2)], None


class _CastParam(ParamStruct):
    dtype = Field(str, required=True)


@register_op("Cast")
class Cast(OperatorProperty):
    """cast-inl.h: the input in ``dtype`` (a numpy dtype name; its
    gradient is cast back to the input's dtype by autograd)."""
    param_cls = _CastParam

    def infer_type(self, in_types):
        known = [t for t in in_types if t is not None]
        return ([known[0] if known else None],
                [_torch_dtype(self.param.dtype)], [])

    def forward(self, inputs, aux, is_train, rng):
        return [inputs[0].to(_torch_dtype(self.param.dtype))], None


# ----------------------------------------------------------------------
# LeakyReLU / SoftmaxActivation / BlockGrad
# ----------------------------------------------------------------------
class _LeakyReLUParam(ParamStruct):
    act_type = Field(str, default="leaky",
                     enum=("leaky", "elu", "prelu", "rrelu"))
    slope = Field(float, default=0.25)
    lower_bound = Field(float, default=0.125)
    upper_bound = Field(float, default=0.334)


@register_op("LeakyReLU")
class LeakyReLU(OperatorProperty):
    """leaky_relu-inl.h; prelu carries a learnable per-channel gamma arg;
    rrelu draws its slopes from the op's generator in training (the
    mean slope in inference)."""
    param_cls = _LeakyReLUParam
    need_rng = True

    def list_arguments(self):
        if self.param.act_type == "prelu":
            return ["data", "gamma"]
        return ["data"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("LeakyReLU", in_shapes[:1], ["data"])
        if self.param.act_type == "prelu":
            return [data, (data[1],)], [data], []
        return [data], [data], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        x = inputs[0]
        if p.act_type == "leaky":
            out = torch.where(x > 0, x, p.slope * x)
        elif p.act_type == "elu":
            out = torch.where(x > 0, x, p.slope * (torch.exp(x) - 1.0))
        elif p.act_type == "prelu":
            gamma = inputs[1].reshape((1, -1) + (1,) * (x.dim() - 2))
            out = torch.where(x > 0, x, gamma * x)
        else:
            if is_train and rng is not None:
                slope = torch.empty(x.shape, dtype=x.dtype, device=x.device)
                slope.uniform_(p.lower_bound, p.upper_bound, generator=rng)
            else:
                slope = (p.lower_bound + p.upper_bound) / 2.0
            out = torch.where(x > 0, x, slope * x)
        return [out], None


class _SoftmaxActivationParam(ParamStruct):
    mode = Field(str, default="instance", enum=("instance", "channel"))


@register_op("SoftmaxActivation")
class SoftmaxActivation(OperatorProperty):
    """softmax_activation-inl.h: the softmax over the channels (axis 1)
    at every position, or over all of an instance's values."""
    param_cls = _SoftmaxActivationParam

    def forward(self, inputs, aux, is_train, rng):
        x = inputs[0]
        if self.param.mode == "channel":
            return [torch.softmax(x, dim=1)], None
        flat = x.reshape((x.shape[0], -1))
        return [torch.softmax(flat, dim=-1).reshape(x.shape)], None


@register_op("BlockGrad")
class BlockGrad(OperatorProperty):
    """block_grad-inl.h: the identity forward, no gradient."""

    def forward(self, inputs, aux, is_train, rng):
        return [inputs[0].detach()], None


# ----------------------------------------------------------------------
# Deconvolution / UpSampling / Crop / L2Normalization
# ----------------------------------------------------------------------
class _DeconvParam(_ConvParam):
    adj = Field(tuple, default=None)
    target_shape = Field(tuple, default=None)


_DECONV = {1: torch.nn.functional.conv_transpose1d,
           2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


@register_op("Deconvolution")
class Deconvolution(OperatorProperty):
    """deconvolution-inl.h: the transposed convolution, one
    ``F.conv_transpose{1,2,3}d``; weight (C, num_filter/group, *kernel),
    the reference's layout.  Output extent ``stride * (in - 1) +
    dilated kernel - 2 * pad + adj``; ``target_shape`` is accepted and
    not read, and ``num_group > 1`` raises, as in the JAX package."""
    param_cls = _DeconvParam
    mxu = True

    def list_arguments(self):
        return ["data", "weight"] if self.param.no_bias \
            else ["data", "weight", "bias"]

    def _adj(self, nd):
        return tuple(self.param.adj) if self.param.adj else (0,) * nd

    def _out_spatial(self, in_spatial):
        k, s, d, pad = self.param.spatial()
        return tuple(ss * (ins - 1) + (ks - 1) * ds + 1 - 2 * ps + aj
                     for ins, ks, ss, ds, ps, aj in
                     zip(in_spatial, k, s, d, pad, self._adj(len(k))))

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("Deconvolution", in_shapes[:1], ["data"])
        p = self.param
        k = p.spatial()[0]
        shapes = [data, (data[1], p.num_filter // p.num_group) + k]
        if not p.no_bias:
            shapes.append((p.num_filter,))
        out = (data[0], p.num_filter) + self._out_spatial(data[2:])
        return shapes, [out], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        if p.num_group != 1:
            raise MXNetError("Deconvolution: num_group > 1 not yet supported")
        k, s, d, pad = p.spatial()
        if len(k) not in _DECONV:
            raise MXNetError("Deconvolution supports 1-3 spatial dims")
        y = _DECONV[len(k)](inputs[0], inputs[1], None, s, pad,
                            self._adj(len(k)), 1, d)
        if not p.no_bias:
            y = y + inputs[2].reshape((1, -1) + (1,) * len(k))
        return [y], None

    def cost_mxu_dims(self, in_shapes, out_shapes):
        # transposed conv: one MAC per input element per (filter, tap)
        p = self.param
        data = in_shapes[0]
        k, _, _, _ = p.spatial()
        m = int(data[0] * _np.prod(data[2:], dtype=_np.int64))
        g = p.num_group
        return [(m, data[1] // g,
                 int((p.num_filter // g) * _np.prod(k, dtype=_np.int64)))] * g

    def cost_flops(self, in_shapes, out_shapes):
        flops = sum(2 * m * k * n for m, k, n in
                    self.cost_mxu_dims(in_shapes, out_shapes))
        if not self.param.no_bias:
            flops += int(_np.prod(out_shapes[0], dtype=_np.int64))
        return float(flops)


class _UpSamplingParam(ParamStruct):
    scale = Field(int, required=True, lower=1)
    num_filter = Field(int, default=0)
    sample_type = Field(str, required=True, enum=("nearest", "bilinear"))
    num_args = Field(int, default=1)
    multi_input_mode = Field(str, default="concat", enum=("concat", "sum"))


@register_op("UpSampling")
class UpSampling(OperatorProperty):
    """upsampling-inl.h: nearest repeat, or a bilinear resize with
    half-pixel centres (``jax.image.resize``'s, which
    ``F.interpolate(align_corners=False)`` computes for an integer
    scale) and no weight argument, as in the JAX package; inputs of
    another size are resized to the first's scaled size by nearest
    neighbour, then concatenated or summed."""
    param_cls = _UpSamplingParam

    def list_arguments(self):
        return ["arg%d" % i for i in range(self.param.num_args)]

    def infer_shape(self, in_shapes):
        require_known("UpSampling", in_shapes, self.list_arguments())
        p = self.param
        d = in_shapes[0]
        c = d[1]
        if p.num_args > 1 and p.multi_input_mode == "concat":
            c = sum(s[1] for s in in_shapes)
        return in_shapes, [(d[0], c, d[2] * p.scale, d[3] * p.scale)], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        F = torch.nn.functional
        base_h = inputs[0].shape[2] * p.scale
        base_w = inputs[0].shape[3] * p.scale
        ups = []
        for x in inputs:
            if base_h // x.shape[2] != p.scale:
                ups.append(F.interpolate(x, size=(base_h, base_w),
                                         mode="nearest-exact"))
            elif p.sample_type == "nearest":
                ups.append(torch.repeat_interleave(
                    torch.repeat_interleave(x, p.scale, dim=2), p.scale,
                    dim=3))
            else:
                ups.append(F.interpolate(x, scale_factor=p.scale,
                                         mode="bilinear",
                                         align_corners=False))
        if len(ups) == 1:
            return [ups[0]], None
        if p.multi_input_mode == "concat":
            return [torch.cat(ups, dim=1)], None
        out = ups[0]
        for u in ups[1:]:
            out = out + u
        return [out], None


class _CropParam(ParamStruct):
    num_args = Field(int, required=True, lower=1, upper=2)
    offset = Field(tuple, default=(0, 0), length=2)
    h_w = Field(tuple, default=(0, 0), length=2)
    center_crop = Field(bool, default=False)


@register_op("Crop")
class Crop(OperatorProperty):
    """crop-inl.h: crop data to h_w or to the 2nd input's spatial shape."""
    param_cls = _CropParam

    def list_arguments(self):
        if self.param.num_args == 2:
            return ["data", "crop_like"]
        return ["data"]

    def infer_shape(self, in_shapes):
        require_known("Crop", in_shapes, self.list_arguments())
        d = in_shapes[0]
        oh, ow = in_shapes[1][2:4] if self.param.num_args == 2 \
            else tuple(self.param.h_w)
        return in_shapes, [(d[0], d[1], oh, ow)], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        x = inputs[0]
        oh, ow = inputs[1].shape[2:4] if p.num_args == 2 else p.h_w
        if p.center_crop:
            y0 = (x.shape[2] - oh) // 2
            x0 = (x.shape[3] - ow) // 2
        else:
            y0, x0 = p.offset
        return [x[:, :, y0:y0 + oh, x0:x0 + ow]], None


class _L2NormParam(ParamStruct):
    eps = Field(float, default=1e-10)
    mode = Field(str, default="instance",
                 enum=("instance", "channel", "spatial"))


@register_op("L2Normalization")
class L2Normalization(OperatorProperty):
    """l2_normalization-inl.h: x / sqrt(sum(x^2) + eps) over an instance,
    the channels, or the spatial positions."""
    param_cls = _L2NormParam

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        x = inputs[0]
        if p.mode == "instance":
            axes = tuple(range(1, x.dim()))
        elif p.mode == "channel":
            axes = (1,)
        else:
            axes = tuple(range(2, x.dim()))
        norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                          + p.eps)
        return [x / norm], None
