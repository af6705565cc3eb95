"""The port's image-model operators against the JAX package, on the CPU.

Convolution, BatchNorm, Pooling, ElementWiseSum and Dropout of
``mxnet_tpu_torch.ops.nn`` run on the same numpy inputs (float32, made
from a seed) as ``mxnet_tpu.ops.nn``'s; gradients are the vector-Jacobian
products of a seeded cotangent, ``jax.vjp`` against
``torch.autograd.grad``.

Tolerances, each relative to the larger of 1 and the reference tensor's
max-abs: forward within 1e-5, gradients within 1e-4 (float32 sums taken
in another order: cuDNN-style convolution and batch-norm reductions
against XLA's).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.registry import create_operator as jcreate
from mxnet_tpu_torch.ops.registry import create_operator as tcreate

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # a window wholly in the padding pools to -inf in both packages
    same = got == want
    assert np.array_equal(np.isfinite(got), np.isfinite(want)) and \
        same[~np.isfinite(want)].all(), what
    got, want = np.where(same, 0.0, got), np.where(same, 0.0, want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, "%s: max err %g > %g x %g" % (
        what, err, tol, scale)


def _run_both(op_name, attrs, inputs, aux=(), is_train=True, seed=0):
    """Forward and the vjp of a seeded cotangent in both packages.
    Returns ((j_outs, j_aux, j_grads), (t_outs, t_aux, t_grads))."""
    jop = jcreate(op_name, **attrs)
    top = tcreate(op_name, **attrs)
    jaux = [jnp.asarray(a) for a in aux]
    taux = [torch.from_numpy(a.copy()) for a in aux]

    def jf(*xs):
        outs, upd = jop.forward(list(xs), jaux, is_train, None)
        return outs, upd

    j_ins = [jnp.asarray(x) for x in inputs]
    (j_outs, j_upd), vjp = jax.vjp(jf, *j_ins)
    rng = np.random.RandomState(seed + 100)
    cot = [rng.randn(*o.shape).astype(np.float32) for o in j_outs]
    zero_upd = None if j_upd is None else [jnp.zeros_like(u) for u in j_upd]
    j_grads = vjp(([jnp.asarray(c) for c in cot], zero_upd))

    t_ins = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    t_outs, t_upd = top.forward(t_ins, taux, is_train, None)
    t_grads = torch.autograd.grad(
        t_outs, t_ins, [torch.from_numpy(c) for c in cot], allow_unused=True)
    t_grads = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
               for g, x in zip(t_grads, inputs)]
    return ((j_outs, j_upd, j_grads),
            ([o.detach().numpy() for o in t_outs],
             None if t_upd is None else [u.numpy() for u in t_upd],
             t_grads))


def _check(j, t, names):
    (jo, ju, jg), (to, tu, tg) = j, t
    for a, b in zip(to, jo):
        _close(a, b, FWD_TOL, "forward")
    assert (ju is None) == (tu is None)
    if ju is not None:
        for a, b in zip(tu, ju):
            _close(a, b, FWD_TOL, "aux update")
    for a, b, n in zip(tg, jg, names):
        _close(a, b, GRAD_TOL, "grad of " + n)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("attrs,data_shape", [
    (dict(kernel=(3, 3), num_filter=8), (2, 4, 9, 9)),
    (dict(kernel=(3, 3), num_filter=8, stride=(2, 2), pad=(1, 1),
          no_bias=True), (2, 4, 9, 10)),
    (dict(kernel=(3, 3), num_filter=6, dilate=(2, 2), pad=(2, 1)),
     (2, 3, 11, 9)),
    (dict(kernel=(3, 3), num_filter=8, num_group=2, pad=(1, 1)),
     (2, 4, 7, 7)),
    (dict(kernel=(7, 7), num_filter=8, stride=(2, 2), pad=(3, 3),
          no_bias=True, workspace=512, cudnn_tune="fastest",
          cudnn_off=True), (2, 3, 17, 17)),
    (dict(kernel=(1, 1), num_filter=16, stride=(2, 2), no_bias=True),
     (2, 8, 8, 8)),
    (dict(kernel=(3,), num_filter=5, pad=(1,)), (2, 3, 12)),
    (dict(kernel=(2, 3, 3), num_filter=4, pad=(0, 1, 1)), (1, 2, 4, 6, 6)),
])
def test_convolution_matches_jax(attrs, data_shape):
    """Forward, shape inference and the gradients of data, weight and
    bias: strides, padding, dilation, groups, no_bias, the cuDNN knobs
    (accepted, ignored), 1-D and 3-D."""
    rng = np.random.RandomState(0)
    top = tcreate("Convolution", **attrs)
    jop = jcreate("Convolution", **attrs)
    t_shapes = top.infer_shape([data_shape] + [None] * (
        len(top.list_arguments()) - 1))
    assert t_shapes == jop.infer_shape([data_shape] + [None] * (
        len(jop.list_arguments()) - 1))
    assert top.list_arguments() == jop.list_arguments()
    inputs = [_f32(rng, *s, scale=0.5) for s in t_shapes[0]]
    j, t = _run_both("Convolution", attrs, inputs)
    assert t[0][0].shape == t_shapes[1][0]
    _check(j, t, top.list_arguments())


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
@pytest.mark.parametrize("data_shape", [(4, 3, 5, 6), (6, 5)])
def test_batchnorm_matches_jax(fix_gamma, mode, data_shape):
    """Output, the moving-statistics updates (train: m * moving + (1 - m)
    * batch, biased variance) and the gradients of data, gamma, beta
    (gamma's exactly zero under fix_gamma) in training, in eval (moving
    statistics, no update) and with use_global_stats in training."""
    rng = np.random.RandomState(1)
    c = data_shape[1]
    attrs = dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
                 use_global_stats=(mode == "global_stats"))
    inputs = [_f32(rng, *data_shape) * 2 + 0.5,
              _f32(rng, c) + 1.0, _f32(rng, c)]
    aux = [_f32(rng, c) * 0.1, np.abs(_f32(rng, c)) + 0.5]
    j, t = _run_both("BatchNorm", attrs, inputs, aux,
                     is_train=(mode != "eval"))
    _check(j, t, ["data", "gamma", "beta"])
    if mode == "train":
        x = inputs[0].astype(np.float64)
        axes = (0,) + tuple(range(2, x.ndim))
        want_var = 0.9 * aux[1] + 0.1 * x.var(axis=axes)
        _close(t[1][1], want_var, FWD_TOL, "biased moving var")
    else:
        assert t[1] is None
    if fix_gamma:
        assert not np.any(t[2][1])


def test_batchnorm_defaults_and_alias():
    """eps 1e-3, momentum 0.9, fix_gamma on; CuDNNBatchNorm is BatchNorm."""
    op = tcreate("CuDNNBatchNorm")
    assert type(op).__name__ == "BatchNorm"
    assert (op.param.eps, op.param.momentum, op.param.fix_gamma,
            op.param.use_global_stats) == (1e-3, 0.9, True, False)
    assert op.list_auxiliary_states() == ["moving_mean", "moving_var"]


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("geometry", [
    dict(kernel=(3, 3), stride=(2, 2)),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(kernel=(2, 3), stride=(2, 1), pad=(1, 0)),
    dict(kernel=(7, 7), global_pool=True),
])
def test_pooling_matches_jax(pool_type, convention, geometry):
    """max, avg (divided by prod(kernel) whatever the padding) and sum,
    under the valid and full (ceil) conventions, with and without
    padding, and global pooling: shapes, outputs and data gradients."""
    rng = np.random.RandomState(2)
    attrs = dict(pool_type=pool_type, pooling_convention=convention,
                 **geometry)
    x = _f32(rng, 2, 3, 8, 9)
    top, jop = tcreate("Pooling", **attrs), jcreate("Pooling", **attrs)
    assert top.infer_shape([x.shape]) == jop.infer_shape([x.shape])
    j, t = _run_both("Pooling", attrs, [x])
    assert t[0][0].shape == top.infer_shape([x.shape])[1][0]
    _check(j, t, ["data"])


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pooling_1d_and_3d_match_jax(pool_type):
    rng = np.random.RandomState(3)
    for kernel, shape in (((3,), (2, 3, 11)), ((2, 2, 2), (1, 2, 5, 6, 7))):
        attrs = dict(kernel=kernel, stride=(2,) * len(kernel),
                     pad=(1,) * len(kernel), pool_type=pool_type,
                     pooling_convention="full")
        j, t = _run_both("Pooling", attrs, [_f32(rng, *shape)])
        _check(j, t, ["data"])


def test_elementwise_sum_matches_jax():
    rng = np.random.RandomState(4)
    xs = [_f32(rng, 3, 4, 5) for _ in range(3)]
    for name in ("ElementWiseSum", "add_n"):
        attrs = dict(num_args=3)
        assert tcreate(name, **attrs).list_arguments() == \
            jcreate(name, **attrs).list_arguments()
        j, t = _run_both(name, attrs, xs)
        _check(j, t, ["arg0", "arg1", "arg2"])


def test_dropout_identity_in_eval_and_masked_in_training():
    """Eval and p=0: the identity.  Training: every element either 0 or
    x / (1 - p), about 1 - p of them kept, and the same mask again from a
    generator with the same seed."""
    op = tcreate("Dropout", p=0.25)
    assert op.need_rng
    x = torch.from_numpy(np.random.RandomState(5).rand(200, 50)
                         .astype(np.float32) + 0.5)
    assert op.forward([x], [], False, None)[0][0] is x
    assert tcreate("Dropout", p=0.0).forward([x], [], True, None)[0][0] is x
    gen = torch.Generator().manual_seed(7)
    y = op.forward([x], [], True, gen)[0][0]
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    y2 = op.forward([x], [], True, torch.Generator().manual_seed(7))[0][0]
    assert torch.equal(y, y2)
