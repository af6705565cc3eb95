"""Loss heads with the reference's backward: SoftmaxOutput.

The port's slice of ``mxnet_tpu/ops/loss.py``.  The reference's loss
layers define their backward as the gradient of an implicit loss and
ignore the head gradient (softmax_output-inl.h: ``(p - onehot(label)) *
grad_scale``); autograd would differentiate the softmax instead, so the
op pins the reference contract with a ``torch.autograd.Function``, as
the JAX package does with ``custom_vjp``.  The trainer feeds ones as
head gradients; only ``out_grad=True`` multiplies them in.
"""
from __future__ import annotations

import torch

from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known


class _SoftmaxOutputParam(ParamStruct):
    grad_scale = Field(float, default=1.0)
    ignore_label = Field(float, default=-1.0)
    multi_output = Field(bool, default=False)
    use_ignore = Field(bool, default=False)
    preserve_shape = Field(bool, default=False)
    normalization = Field(str, default="null", enum=("null", "batch", "valid"))
    out_grad = Field(bool, default=False)


def _onehot(label, n_class, axis, dtype):
    """One-hot of ``label`` along ``axis`` of the output; a label outside
    ``[0, n_class)`` (the ignore label -1, say) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    lab = label.to(torch.int64).unsqueeze(axis)
    shape = [1] * lab.dim()
    shape[axis] = n_class
    classes = torch.arange(n_class, device=label.device).reshape(shape)
    return (lab == classes).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, op):
        out = torch.softmax(data, dim=op._axis())
        ctx.save_for_backward(out, label)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = ctx.op._grad(out, label)
        if ctx.op.param.out_grad:
            grad = grad * g
        return grad, None, None


@register_op("SoftmaxOutput", aliases=("Softmax",))
class SoftmaxOutput(OperatorProperty):
    """softmax_output-inl.h: fwd = softmax(data); bwd = (p - onehot(label))
    * grad_scale, with ``use_ignore``/``normalization``/``out_grad`` as
    in the reference.  ``multi_output`` takes the softmax over axis 1."""
    param_cls = _SoftmaxOutputParam

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("SoftmaxOutput", in_shapes[:1], ["data"])
        if self.param.multi_output:
            label = (data[0],) + tuple(data[2:])
        else:
            label = (data[0],)
        return [data, label], [data], []

    def forward(self, inputs, aux, is_train, rng):
        return [_SoftmaxOutputFn.apply(inputs[0], inputs[1], self)], None

    def _axis(self):
        return 1 if self.param.multi_output else -1

    def _grad(self, out, label):
        p = self.param
        axis = self._axis()
        grad = out - _onehot(label, out.shape[axis], axis, out.dtype)
        valid = torch.ones_like(label, dtype=out.dtype)
        if p.use_ignore:
            valid = (label != p.ignore_label).to(out.dtype)
            if p.multi_output:
                grad = grad * valid.unsqueeze(1)
            else:
                grad = grad * valid.reshape(
                    tuple(valid.shape) + (1,) * (grad.dim() - valid.dim()))
        if p.normalization == "batch":
            grad = grad / out.shape[0]
        elif p.normalization == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        return grad * p.grad_scale
