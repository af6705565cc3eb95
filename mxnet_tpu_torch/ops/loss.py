"""Loss heads with the reference's backward: SoftmaxOutput, the
regression outputs (linear, logistic, MAE), MakeLoss, SVMOutput and
IdentityAttachKLSparseReg.

The port of ``mxnet_tpu/ops/loss.py``.  The reference's loss
layers define their backward as the gradient of an implicit loss and
ignore the head gradient (softmax_output-inl.h: ``(p - onehot(label)) *
grad_scale``); autograd would differentiate the softmax instead, so the
op pins the reference contract with a ``torch.autograd.Function``, as
the JAX package does with ``custom_vjp``.  The trainer feeds ones as
head gradients; only ``out_grad=True`` multiplies them in (and
IdentityAttachKLSparseReg adds its penalty to them).  Differentiated
again (a ``Symbol.grad`` bound for training and run backward), each
backward is differentiated through the forward it was built from, as
the JAX package differentiates a ``custom_vjp`` backward through its
residuals: SoftmaxOutput's ``p - onehot`` through the softmax, a
regression head's ``out - label`` through ``out = fwd(data)``.
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
    """``out`` (the softmax of ``data``, taken outside by autograd)
    passed through; the backward gives ``data`` the reference's ``p -
    onehot`` and ``out`` nothing.  Under ``create_graph`` the saved
    ``out`` keeps its softmax history, so the second derivative runs
    through the softmax's own backward, and ``data`` itself is never
    saved."""

    @staticmethod
    def forward(ctx, out, data, label, op, denom=None):
        ctx.save_for_backward(out, label)
        ctx.op, ctx.denom = op, denom
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = ctx.op._grad(out, label, ctx.denom)
        if ctx.op.param.out_grad:
            grad = grad * g
        return None, grad, None, None, None


def _softmax_output(op, data, label, denom=None):
    return _SoftmaxOutputFn.apply(torch.softmax(data, dim=op._axis()),
                                  data, label, op, denom)


def _replica_denoms(normalization, counts, rows, group):
    """The normalizer of a loss head's gradient over a batch split across
    replicas: the global batch (``"batch"``) or the global count of valid
    entries (``"valid"``, ``counts`` each replica's, summed over the
    replicas); None for ``"null"``."""
    if normalization == "batch":
        return [float(sum(rows) * group.num_processes)] * len(rows)
    if normalization == "valid":
        from ..parallel.collectives import all_reduce
        return all_reduce(group, counts)
    return None


@register_op("SoftmaxOutput", aliases=("Softmax",))
class SoftmaxOutput(OperatorProperty):
    """softmax_output-inl.h: fwd = softmax(data); bwd = (p - onehot(label))
    * grad_scale, with ``use_ignore``/``normalization``/``out_grad`` as
    in the reference.  ``multi_output`` takes the softmax over axis 1."""
    param_cls = _SoftmaxOutputParam
    #: its backward is its own, whatever the head gradient (a replicated
    #: input's gradient is then taken once, executor.build_program)
    injects_grad = True

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
        return [_softmax_output(self, inputs[0], inputs[1])], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """A batch split across replicas (``executor.build_program``'s
        lockstep walk): ``normalization`` divides by the whole batch's
        size or valid count, summed over the replicas."""
        p = self.param
        if p.normalization == "null":
            return None
        counts = [self._valid(i[1], i[0].dtype).sum() for i in ins] \
            if p.normalization == "valid" else None
        denoms = _replica_denoms(p.normalization, counts,
                                 [i[0].shape[0] for i in ins], group)
        return [[_softmax_output(self, i[0], i[1], d)]
                for i, d in zip(ins, denoms)], None, False

    def _axis(self):
        return 1 if self.param.multi_output else -1

    def _valid(self, label, dtype):
        p = self.param
        if p.use_ignore:
            return (label != p.ignore_label).to(dtype)
        return torch.ones_like(label, dtype=dtype)

    def _grad(self, out, label, denom=None):
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
        if denom is not None:
            grad = grad / (torch.clamp(denom, min=1.0)
                           if isinstance(denom, torch.Tensor) else denom)
        elif p.normalization == "batch":
            grad = grad / out.shape[0]
        elif p.normalization == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        return grad * p.grad_scale

    def cost_reduce_len(self, in_shapes, out_shapes):
        # softmax denominator accumulates over the class axis
        data = in_shapes[0]
        return int(data[1] if len(data) > 1 else data[-1])

    def infer_sharding(self, in_specs, in_shapes, out_shapes, mesh_shape):
        data = in_specs[0]
        # label aligns with data's LEADING dims (batch[, spatial]), not by
        # numpy trailing-broadcast: label (B,) matches data (B, C)
        if self.param.multi_output:
            label = (tuple(data[0]),) + tuple(tuple(e) for e in data[2:])
        else:
            label = tuple(tuple(e) for e in data[:len(in_specs[1])])
        return {"out": [tuple(data)], "in": [None, label]}


# ----------------------------------------------------------------------
# the regression outputs, MakeLoss, SVMOutput, IdentityAttachKLSparseReg
# ----------------------------------------------------------------------
class _LossFn(torch.autograd.Function):
    """``fwd(data)`` forward; the backward ``bwd(saved...)`` ignores the
    head gradient (the reference's loss-layer contract), or adds it
    (``keep_head``: IdentityAttachKLSparseReg); no gradient reaches the
    other inputs.  Under ``create_graph`` the backward rebuilds ``out =
    fwd(data)`` from the saved ``data``, so that a second derivative
    runs through the forward (the saved ``out`` would lead back into
    this backward, which drops its head gradient)."""

    @staticmethod
    def forward(ctx, data, fwd, bwd, keep_head, *extra):
        out = fwd(data)
        ctx.fwd, ctx.bwd, ctx.keep_head = fwd, bwd, keep_head
        ctx.save_for_backward(data, out, *extra)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out, *extra = ctx.saved_tensors
        if torch.is_grad_enabled():     # create_graph: a second order
            out = ctx.fwd(data)
        grad = ctx.bwd(data, out, *extra)
        if ctx.keep_head:
            grad = g + grad
        return (grad, None, None, None) + (None,) * len(extra)


def _make_regression(op_name, fwd_fn, grad_fn):
    class _RegParam(ParamStruct):
        grad_scale = Field(float, default=1.0)

    @register_op(op_name)
    class _Regression(OperatorProperty):
        """regression_output-inl.h family: the backward is
        ``grad_fn(out, label) * grad_scale``, whatever the head
        gradient."""
        param_cls = _RegParam
        injects_grad = True

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shapes):
            data = in_shapes[0]
            if data is None:
                require_known(op_name, in_shapes[:1], ["data"])
            return [data, data], [data], []

        def forward(self, inputs, aux, is_train, rng):
            scale = self.param.grad_scale
            data, label = inputs
            label = label.reshape(data.shape).detach()
            return [_LossFn.apply(
                data, fwd_fn,
                lambda d, out, lab: grad_fn(out, lab) * scale, False,
                label)], None

    _Regression.__name__ = "Op" + op_name
    return _Regression


_make_regression("LinearRegressionOutput",
                 lambda x: x.clone(), lambda out, label: out - label)
_make_regression("LogisticRegressionOutput",
                 torch.sigmoid, lambda out, label: out - label)
_make_regression("MAERegressionOutput", lambda x: x.clone(),
                 lambda out, label: torch.sign(out - label))


class _MakeLossParam(ParamStruct):
    grad_scale = Field(float, default=1.0)
    valid_thresh = Field(float, default=0.0)
    normalization = Field(str, default="null", enum=("null", "batch", "valid"))


@register_op("MakeLoss")
class MakeLoss(OperatorProperty):
    """make_loss-inl.h: fwd = data; bwd = grad_scale (constant), over the
    batch or the count of values above ``valid_thresh`` when
    normalized."""
    param_cls = _MakeLossParam
    injects_grad = True

    def forward(self, inputs, aux, is_train, rng, denom=None):
        p = self.param

        def bwd(data, out):
            grad = torch.full_like(data, p.grad_scale)
            if denom is not None:
                grad = grad / (torch.clamp(denom, min=1.0)
                               if isinstance(denom, torch.Tensor) else denom)
            elif p.normalization == "batch":
                grad = grad / data.shape[0]
            elif p.normalization == "valid":
                valid = (data > p.valid_thresh).to(data.dtype)
                grad = grad / torch.clamp(valid.sum(), min=1.0)
            return grad
        return [_LossFn.apply(inputs[0], torch.clone, bwd, False)], None

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """``normalization`` over the whole batch of every replica, as
        :meth:`SoftmaxOutput.forward_replicas`."""
        p = self.param
        if p.normalization == "null":
            return None
        counts = [(i[0].detach() > p.valid_thresh).to(i[0].dtype).sum()
                  for i in ins] if p.normalization == "valid" else None
        denoms = _replica_denoms(p.normalization, counts,
                                 [i[0].shape[0] for i in ins], group)
        return [self.forward(i, a, is_train, None, denom=d)[0]
                for i, a, d in zip(ins, aux, denoms)], None, False


class _SVMOutputParam(ParamStruct):
    margin = Field(float, default=1.0)
    regularization_coefficient = Field(float, default=1.0)
    use_linear = Field(bool, default=False)


@register_op("SVMOutput")
class SVMOutput(OperatorProperty):
    """svm_output-inl.h: fwd = identity; bwd = the hinge's gradient
    (squared by default, ``use_linear`` for L1)."""
    param_cls = _SVMOutputParam
    injects_grad = True

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("SVMOutput", in_shapes[:1], ["data"])
        return [data, (data[0],)], [data], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param

        def bwd(scores, out, label):
            lab = label.to(torch.int64)
            s_l = torch.gather(scores, 1, lab[:, None])
            viol = scores - s_l + p.margin     # > 0 where violated (k != l)
            onehot = _onehot(label, scores.shape[1], 1, scores.dtype)
            mask = (viol > 0).to(scores.dtype) * (1.0 - onehot)
            gk = mask if p.use_linear else 2.0 * viol * mask
            gl = -torch.sum(gk, dim=1, keepdim=True) * onehot
            return (gk + gl) * p.regularization_coefficient
        return [_LossFn.apply(inputs[0], torch.clone, bwd, False,
                              inputs[1].detach())], None


class _KLSparseParam(ParamStruct):
    sparseness_target = Field(float, default=0.1)
    penalty = Field(float, default=0.001)
    momentum = Field(float, default=0.9)


@register_op("IdentityAttachKLSparseReg")
class IdentityAttachKLSparseReg(OperatorProperty):
    """identity_attach_KL_sparse_reg-inl.h: identity fwd; the backward
    adds the KL sparsity penalty's gradient, from the moving average of
    the mean activation per channel (aux ``moving_avg``, updated in
    training) to the head gradient."""
    param_cls = _KLSparseParam
    injects_grad = True

    def list_auxiliary_states(self):
        return ["moving_avg"]

    def infer_shape(self, in_shapes):
        require_known("IdentityAttachKLSparseReg", in_shapes, ["data"])
        d = in_shapes[0]
        return in_shapes, [d], [(d[1],)]

    def forward(self, inputs, aux, is_train, rng, avg=None):
        p = self.param
        x = inputs[0]
        with torch.no_grad():
            if avg is None:
                avg = torch.mean(x, dim=tuple(i for i in range(x.dim())
                                              if i != 1))
            new_avg = p.momentum * aux[0] + (1 - p.momentum) * avg

        def bwd(data, out, navg):
            a = navg.reshape((1, -1) + (1,) * (data.dim() - 2))
            return p.penalty * (-p.sparseness_target / (a + 1e-8)
                                + (1.0 - p.sparseness_target)
                                / (1.0 - a + 1e-8))
        out = _LossFn.apply(x, torch.clone, bwd, True, new_avg)
        return [out], ([new_avg] if is_train else None)

    def forward_replicas(self, ins, aux, is_train, rngs, group):
        """The mean activation over the whole batch of every replica."""
        from ..parallel.collectives import all_reduce
        dims = tuple(i for i in range(ins[0][0].dim()) if i != 1)
        with torch.no_grad():
            sums = all_reduce(group, [i[0].sum(dims) for i in ins])
        count = sum(i[0].numel() // i[0].shape[1] for i in ins) \
            * group.num_processes
        got = [self.forward(i, a, is_train, None, avg=s / count)
               for i, a, s in zip(ins, aux, sums)]
        return [g[0] for g in got], [g[1] for g in got], False
