"""The rest of the single-device op registry against the JAX package, on
the CPU.

Every op name the port registers in this slice (51, aliases included)
runs in ``test_op_matches_jax`` on the same seeded float32 inputs in both
packages: the forward and the vector-Jacobian product of a seeded
cotangent (``jax.vjp`` against ``torch.autograd.grad``), within 1e-5
(forward) and 1e-4 (gradients) of the larger of 1 and the JAX tensor's
max-abs.  An output that carries no gradient (``BlockGrad``,
``argmax_channel``) must get zero gradients in the JAX package.  The
samplers and ``LeakyReLU(act_type="rrelu")`` draw from Philox in the
port and threefry in the JAX package: their draws are held to their
bounds and moments instead.  ``test_registry_lacks_only_moe`` pins that
the port's registry now lacks nothing: ``MoE``/``SwitchFFN``, the last
two names, came with expert parallelism (``tests/test_torch_moe.py``).
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as J_REGISTRY
from mxnet_tpu.ops.registry import create_operator as jcreate
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as T_REGISTRY
from mxnet_tpu_torch.ops.registry import create_operator as tcreate

from test_torch_resnet_ops import _close

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _define_host_ops(mx):
    op_mod = mx.operator

    class Square(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] ** 2 + in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2.0 * in_data[0] * out_grad[0])
            self.assign(in_grad[1], req[1], out_grad[0])

    @op_mod.register("tr_square_plus")
    class SquareProp(op_mod.CustomOpProp):
        def list_arguments(self):
            return ["data", "other"]

        def infer_shape(self, in_shape):
            return [in_shape[0], in_shape[0]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Square()

    class Cube(op_mod.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][...] = in_data[0] ** 3

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][...] = 3.0 * in_data[0] ** 2 * out_grad[0]
    return Cube


J_CUBE = _define_host_ops(jmx)
T_CUBE = _define_host_ops(tmx)


def _u(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def _n(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def _ints(n, hi):
    return lambda r: r.randint(0, hi, (n,)).astype(np.float32)


def _const(a):
    return lambda r: np.asarray(a, np.float32)


#: (op name, attrs, input makers, aux makers)
CASES = [
    # ops/tensor.py
    ("abs", {}, [_u(3, 4)], []),
    ("ceil", {}, [_u(3, 4, lo=-3, hi=3)], []),
    ("cos", {}, [_u(3, 4)], []),
    ("exp", {}, [_u(3, 4)], []),
    ("floor", {}, [_u(3, 4, lo=-3, hi=3)], []),
    ("log", {}, [_u(3, 4, lo=0.1, hi=3)], []),
    ("negative", {}, [_n(3, 4)], []),
    ("_Negative", {}, [_n(2, 5)], []),
    ("round", {}, [_const([[0.5, 1.5, 2.5, -0.5], [-1.5, 0.49, 2.51, 3.0]])],
     []),
    ("rsqrt", {}, [_u(3, 4, lo=0.1, hi=3)], []),
    ("sign", {}, [_u(3, 4)], []),
    ("sin", {}, [_u(3, 4)], []),
    ("sqrt", {}, [_u(3, 4, lo=0.1, hi=3)], []),
    ("square", {}, [_n(3, 4)], []),
    ("identity", {}, [_n(3, 4)], []),
    ("_copy", {}, [_n(2, 3, 2)], []),
    ("_CrossDeviceCopy", {}, [_n(3, 4)], []),
    ("dot", {}, [_n(3, 4), _n(4, 5)], []),
    ("dot", dict(transpose_a=True), [_n(4, 3), _n(4, 5)], []),
    ("dot", dict(transpose_b=True), [_n(3, 4), _n(5, 4)], []),
    ("batch_dot", {}, [_n(2, 3, 4), _n(2, 4, 5)], []),
    ("batch_dot", dict(transpose_a=True, transpose_b=True),
     [_n(2, 4, 3), _n(2, 5, 4)], []),
    ("broadcast_axis", dict(axis=(1,), size=(5,)), [_n(3, 1, 4)], []),
    ("broadcast_axis", dict(axis=(0, 2), size=(2, 3)), [_n(1, 4, 1)], []),
    ("broadcast_to", dict(shape=(0, 5, 0)), [_n(3, 1, 4)], []),
    ("broadcast_to", dict(shape=(2, 3, 4)), [_n(1, 3, 1)], []),
    ("norm", {}, [_n(3, 4)], []),
    ("argmax_channel", {}, [_const([[1, 3, 3, 0], [2, 0, 1, 2],
                                    [0, 0, 0, 0]])], []),
    ("flip", dict(axis=1), [_n(2, 3, 4)], []),
    ("flip", dict(axis=0), [_n(3, 2)], []),
    ("slice_axis", dict(axis=1, begin=1, end=3), [_n(2, 5, 3)], []),
    ("slice_axis", dict(axis=0, begin=-2), [_n(4, 3)], []),
    ("slice_axis", dict(axis=2, begin=1, end=0), [_n(2, 3, 4)], []),
    ("slice_axis", dict(axis=1, begin=0, end=-1), [_n(2, 3, 4)], []),
    ("smooth_l1", {}, [_u(3, 5, lo=-3, hi=3)], []),
    ("smooth_l1", dict(scalar=2.0), [_u(3, 5, lo=-1, hi=1)], []),
    ("softmax_cross_entropy", {}, [_n(4, 5), _ints(4, 5)], []),
    ("element_mask", {}, [_n(4, 3, 2), _const([1, 0, 1, 1])], []),
    # ops/nn.py
    ("LeakyReLU", {}, [_n(3, 4)], []),
    ("LeakyReLU", dict(act_type="elu", slope=0.5), [_n(3, 4)], []),
    ("LeakyReLU", dict(act_type="prelu"), [_n(2, 3, 4, 4), _u(3, lo=0,
                                                              hi=0.5)], []),
    ("Deconvolution", dict(kernel=(3, 3), num_filter=4),
     [_n(2, 3, 5, 5), _n(3, 4, 3, 3), _n(4)], []),
    ("Deconvolution", dict(kernel=(4, 4), num_filter=2, stride=(2, 2),
                           pad=(1, 1), no_bias=True),
     [_n(1, 3, 4, 5), _n(3, 2, 4, 4)], []),
    ("Deconvolution", dict(kernel=(3,), num_filter=2, stride=(2,),
                           dilate=(2,)), [_n(2, 3, 6), _n(3, 2, 3), _n(2)],
     []),
    ("UpSampling", dict(scale=2, sample_type="nearest"), [_n(2, 3, 3, 4)],
     []),
    ("UpSampling", dict(scale=2, sample_type="bilinear"), [_n(1, 2, 3, 4)],
     []),
    ("UpSampling", dict(scale=3, sample_type="bilinear"), [_n(1, 2, 4, 3)],
     []),
    ("UpSampling", dict(scale=2, sample_type="nearest", num_args=2),
     [_n(1, 2, 4, 4), _n(1, 3, 2, 2)], []),
    ("UpSampling", dict(scale=2, sample_type="nearest", num_args=2,
                        multi_input_mode="sum"),
     [_n(1, 2, 3, 3), _n(1, 2, 3, 3)], []),
    ("Crop", dict(num_args=1, h_w=(3, 2), offset=(1, 2)), [_n(2, 3, 6, 5)],
     []),
    ("Crop", dict(num_args=2, center_crop=True),
     [_n(2, 3, 7, 6), _n(2, 1, 4, 3)], []),
    ("L2Normalization", {}, [_n(3, 4, 2)], []),
    ("L2Normalization", dict(mode="channel"), [_n(2, 3, 4)], []),
    ("L2Normalization", dict(mode="spatial", eps=1e-3), [_n(2, 3, 2, 2)], []),
    ("BlockGrad", {}, [_n(3, 4)], []),
    ("SoftmaxActivation", {}, [_n(2, 3, 4)], []),
    ("SoftmaxActivation", dict(mode="channel"), [_n(2, 3, 4, 2)], []),
    # ops/loss.py
    ("LinearRegressionOutput", {}, [_n(4, 3), _n(4, 3)], []),
    ("LinearRegressionOutput", dict(grad_scale=0.5), [_n(4, 1), _n(4)], []),
    ("LogisticRegressionOutput", {}, [_n(4, 3), _u(4, 3, lo=0, hi=1)], []),
    ("MAERegressionOutput", {}, [_n(4, 3), _n(4, 3)], []),
    ("MakeLoss", {}, [_n(3, 4)], []),
    ("MakeLoss", dict(grad_scale=2.0, normalization="batch"), [_n(3, 4)], []),
    ("MakeLoss", dict(normalization="valid", valid_thresh=0.1), [_n(3, 4)],
     []),
    ("SVMOutput", {}, [_n(4, 5), _ints(4, 5)], []),
    ("SVMOutput", dict(use_linear=True, margin=0.5,
                       regularization_coefficient=2.0),
     [_n(4, 5), _ints(4, 5)], []),
    ("IdentityAttachKLSparseReg", {}, [_u(4, 3, 2, 2, lo=0.05, hi=0.95)],
     [_u(3, lo=0.1, hi=0.5)]),
    # ops/vision.py
    ("ROIPooling", dict(pooled_size=(2, 2), spatial_scale=0.5),
     [lambda r: np.maximum(r.randn(2, 3, 6, 6), 0).astype(np.float32),
      _const([[0, 0, 0, 9, 9], [1, 2, 1, 11, 7], [0, 4, 4, 5, 5]])], []),
    ("SpatialTransformer", dict(transform_type="affine",
                                sampler_type="bilinear"),
     [_n(2, 3, 5, 6), lambda r: (np.array([0.9, 0.1, 0.05, -0.1, 1.1, 0.0])
                                 + 0.05 * r.randn(2, 6)).astype(np.float32)],
     []),
    ("SpatialTransformer", dict(transform_type="affine",
                                sampler_type="bilinear", target_shape=(4, 3)),
     [_n(1, 2, 6, 5), lambda r: (np.array([1.3, 0.0, 0.2, 0.1, 1.2, -0.3])
                                 + 0.05 * r.randn(1, 6)).astype(np.float32)],
     []),
    ("Correlation", dict(max_displacement=2), [_n(2, 3, 6, 7), _n(2, 3, 6, 7)],
     []),
    ("Correlation", dict(kernel_size=3, max_displacement=2, stride2=2,
                         pad_size=2, is_multiply=False),
     [_n(1, 2, 6, 6), _n(1, 2, 6, 6)], []),
    # operator.py
    ("Custom", dict(op_type="tr_square_plus"), [_n(3, 4), _n(3, 4)], []),
]

#: the names held by value parity above; the samplers and rrelu are held
#: to their bounds and moments, ``_Native``/``_NDArray`` through a bound
#: symbol (their node refers to a live Python op object)
SAMPLERS = ("_sample_uniform", "uniform", "_sample_normal", "normal")
HOST_LEGACY = ("_Native", "_NDArray")
NEW_NAMES = sorted(set(c[0] for c in CASES) | set(SAMPLERS)
                   | set(HOST_LEGACY))


def _case_id(case):
    name, attrs = case[0], case[1]
    return name + ("-" + "-".join("%s=%s" % kv for kv in
                                  sorted(attrs.items())) if attrs else "")


def test_registry_lacks_only_moe():
    jnames = {n for n, _ in J_REGISTRY.items()}
    tnames = {n for n, _ in T_REGISTRY.items()}
    assert tnames == jnames
    assert len(jnames) == 128
    assert len(NEW_NAMES) == 51
    assert set(NEW_NAMES) <= tnames


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_op_matches_jax(case):
    name, attrs, makers, aux_makers = case
    rng = np.random.RandomState(zlib.crc32(_case_id(case).encode()))
    inputs = [m(rng) for m in makers]
    aux = [m(rng) for m in aux_makers]
    jop, top = jcreate(name, **attrs), tcreate(name, **attrs)
    shapes = [x.shape for x in inputs]
    t_shapes = top.infer_shape(list(shapes))
    j_shapes = jop.infer_shape(list(shapes))
    norm = lambda r: [[tuple(map(int, s)) for s in part] for part in r]
    assert norm(t_shapes) == norm(j_shapes)

    jaux = [jnp.asarray(a) for a in aux]
    (j_outs, j_upd), vjp = jax.vjp(
        lambda *xs: jop.forward(list(xs), jaux, True, None),
        *[jnp.asarray(x) for x in inputs])
    cot = [rng.randn(*o.shape).astype(np.float32) for o in j_outs]
    j_grads = vjp(([jnp.asarray(c) for c in cot],
                   None if j_upd is None
                   else [jnp.zeros_like(u) for u in j_upd]))

    t_ins = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    t_outs, t_upd = top.forward(t_ins, [torch.from_numpy(a.copy())
                                        for a in aux], True, None)
    assert len(t_outs) == len(j_outs)
    for t, j, shape in zip(t_outs, j_outs, t_shapes[1]):
        assert tuple(t.shape) == tuple(shape)
        _close(t.detach().numpy(), np.asarray(j), FWD_TOL, name + " forward")
    assert (t_upd is None) == (j_upd is None)
    for t, j in zip(t_upd or [], j_upd or []):
        _close(t.numpy(), np.asarray(j), FWD_TOL, name + " aux update")
    live = [(t, c) for t, c in zip(t_outs, cot) if t.requires_grad]
    if live:
        t_grads = torch.autograd.grad([t for t, _ in live],
                                      t_ins, [torch.from_numpy(c)
                                              for _, c in live],
                                      allow_unused=True)
    else:       # no output carries a gradient
        t_grads = [None] * len(t_ins)
        assert all(not np.asarray(g).any() for g in j_grads), name
    for k, (t, j) in enumerate(zip(t_grads, j_grads)):
        t = np.zeros(inputs[k].shape, np.float32) if t is None else t.numpy()
        _close(t, np.asarray(j), GRAD_TOL, "%s grad of input %d" % (name, k))


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_legacy_ndarray_op_through_a_symbol(kind):
    """``_NDArray`` (an ``NDArrayOp``; ``_Native`` is its alias): x^3
    forward and 3 x^2 backward through a bound symbol, both packages."""
    mx, cube = (jmx, J_CUBE) if kind == "jax" else (tmx, T_CUBE)
    rng = np.random.RandomState(3)
    a = rng.randn(3, 4).astype(np.float32)
    og = rng.randn(3, 4).astype(np.float32)
    registry = J_REGISTRY if kind == "jax" else T_REGISTRY
    assert registry.get("_NDArray") is registry.get("_Native")
    s = cube().get_symbol(data=mx.sym.Variable("x"))
    assert type(s._topo()[-1].op) is registry.get("_NDArray")
    ex = s.simple_bind(mx.cpu(), x=a.shape, grad_req="write")
    ex.arg_dict["x"][:] = a
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([mx.nd.array(og, ctx=mx.cpu())])
    np.testing.assert_allclose(out, a ** 3, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(),
                               3 * a ** 2 * og, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,attrs", [
    ("_sample_uniform", dict(low=-1.0, high=3.0, shape=(200, 50))),
    ("uniform", dict(shape=(100, 100))),
    ("_sample_normal", dict(loc=2.0, scale=0.5, shape=(200, 50))),
    ("normal", dict(shape=(10000,)))])
def test_samplers_bounds_and_moments(name, attrs):
    """10,000 draws of each package (the port's through a bound symbol's
    inference forward, which hands the device's generator): inside the
    bounds, mean and deviation within 5 standard errors."""
    draws = []
    for mx in (jmx, tmx):
        s = getattr(mx.sym, name)(**attrs)
        ex = s.simple_bind(mx.cpu())
        draws.append(ex.forward(is_train=False)[0].asnumpy())
    t_first = draws[1]
    draws.append(tcreate(name, **attrs).forward(
        [], [], True, torch.Generator().manual_seed(5))[0][0].numpy())
    assert not np.array_equal(t_first, draws[2])
    for d in draws:
        assert d.shape == tuple(attrs["shape"])
        n = d.size
        if "uniform" in name:
            lo, hi = attrs.get("low", 0.0), attrs.get("high", 1.0)
            assert d.min() >= lo and d.max() < hi
            mean, std = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
        else:
            mean, std = attrs.get("loc", 0.0), attrs.get("scale", 1.0)
        assert abs(d.mean() - mean) < 5 * std / np.sqrt(n)
        assert abs(d.std() - std) < 5 * std / np.sqrt(2 * n)


def test_rrelu_slopes_within_bounds():
    """rrelu in training: each negative value scaled by its own slope in
    [lower, upper), the positive ones kept; the gradient is that slope.
    In inference, the mean slope, as the JAX package."""
    attrs = dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3)
    x = -np.abs(np.random.RandomState(0).randn(4000)).astype(np.float32) \
        - 0.01
    x[::2] *= -1
    top = tcreate("LeakyReLU", **attrs)
    tx = torch.from_numpy(x).requires_grad_()
    out, = top.forward([tx], [], True, torch.Generator().manual_seed(1))[0]
    g, = torch.autograd.grad(out, tx, torch.ones_like(out))
    slope = (out.detach().numpy() / x)[1::2]
    assert (out.detach().numpy()[::2] == x[::2]).all()
    assert slope.min() >= 0.1 and slope.max() < 0.3
    assert abs(slope.mean() - 0.2) < 5 * 0.2 / np.sqrt(12 * slope.size)
    np.testing.assert_allclose(g.numpy()[1::2], slope, rtol=1e-6)
    jout = jcreate("LeakyReLU", **attrs).forward(
        [jnp.asarray(x)], [], False, None)[0][0]
    tout = top.forward([torch.from_numpy(x)], [], False, None)[0][0]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6)


def test_deconvolution_adj_gives_the_inferred_shape():
    """``adj`` adds rows and columns at the end: the port's output has the
    shape both packages infer, where the JAX package's forward drops
    ``adj`` (7 x 7 against its own inferred 8 x 8); the rest agrees."""
    attrs = dict(kernel=(3, 3), num_filter=2, stride=(2, 2), pad=(1, 1),
                 adj=(1, 1), no_bias=True)
    rng = np.random.RandomState(12)
    x = rng.randn(1, 3, 4, 4).astype(np.float32)
    w = rng.randn(3, 2, 3, 3).astype(np.float32)
    jop, top = jcreate("Deconvolution", **attrs), tcreate("Deconvolution",
                                                         **attrs)
    inferred = top.infer_shape([x.shape, None])[1][0]
    assert inferred == tuple(jop.infer_shape([x.shape, None])[1][0]) \
        == (1, 2, 8, 8)
    t_out = top.forward([torch.from_numpy(x), torch.from_numpy(w)], [],
                        False, None)[0][0].numpy()
    j_out = np.asarray(jop.forward([jnp.asarray(x), jnp.asarray(w)], [],
                                   False, None)[0][0])
    assert t_out.shape == inferred and j_out.shape == (1, 2, 7, 7)
    _close(t_out[:, :, :7, :7], j_out, FWD_TOL, "Deconvolution adj")
