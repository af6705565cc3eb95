"""The port's imperative NDArray surface against the JAX package's, on the
CPU.

Every test runs under ``with tmx.cpu():`` (an autouse fixture): the
port's arrays default to ``gpu(0)``, the JAX package's to the CPU.  The
same numpy inputs, made from a seed, go through ``mxnet_tpu.ndarray``
and ``mxnet_tpu_torch.ndarray``:

- one parametrised case per registered function and per arithmetic,
  comparison and in-place operator, in float32.  Tolerances: exact where
  both packages do the same correctly rounded float32 operations
  (arithmetic, comparisons, rounding, copies, gathers); 2e-6 relative
  for transcendental functions (XLA's and PyTorch's CPU libraries round
  ``exp``/``log``/``sin``/... differently by an ulp or two); 1e-5
  relative where a reduction or a product sums in another order;
- twins of the 15 tests of ``tests/test_ndarray.py``, on the port;
- twins of ``tests/test_random.py`` on distributions only (the two
  packages draw different numbers from the same seed);
- what the port adds: views that alias through writes of every kind,
  in-place writes that keep dtype and broadcast, the default context.
"""
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import ndarray as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def cpu_scope():
    with tmx.cpu():
        yield


_RNG = np.random.RandomState(0)
X = (_RNG.rand(4, 5) * 4 - 2).astype(np.float32)      # mixed signs
Y = (_RNG.rand(4, 5) * 4 - 2).astype(np.float32)
P = (_RNG.rand(4, 5) + 0.5).astype(np.float32)         # positive
Y[0, :2] = X[0, :2]                                    # ties for ==, >=
B3 = _RNG.rand(2, 4, 3).astype(np.float32)
C3 = _RNG.rand(2, 3, 6).astype(np.float32)
M = _RNG.rand(5, 6).astype(np.float32)
V = _RNG.rand(5).astype(np.float32)
IDX = np.array([1, 0, 4, 2], np.float32)
LAB = np.array([3, 0, 4, 1], np.float32)

EXACT, TRANS, SUM = 0.0, 2e-6, 1e-5


def _iop(op):
    def run(nd_, a, b):
        if op == "+":
            a += b
        elif op == "-":
            a -= b
        elif op == "*":
            a *= b
        else:
            a /= b
        return a
    return run


def _iop_scalar(op):
    run = _iop(op)
    return lambda nd_, a, b: run(nd_, a, 1.5)


def _out(fn):
    """Run ``fn`` with ``out=`` a fresh zeros array of the result's
    shape; return what it wrote."""
    def run(nd_, a, b):
        want = fn(nd_, a, b, None)
        out = nd_.zeros(want.shape)
        res = fn(nd_, a, b, out)
        assert res is out
        return out
    return run


# (id, fn(nd, a, b) -> NDArray, a, b, tolerance)
CASES = [
    # arithmetic with arrays and scalars, both sides
    ("add", lambda n, a, b: a + b, X, Y, EXACT),
    ("sub", lambda n, a, b: a - b, X, Y, EXACT),
    ("mul", lambda n, a, b: a * b, X, Y, EXACT),
    ("div", lambda n, a, b: a / b, X, P, EXACT),
    ("pow", lambda n, a, b: a ** 2, X, Y, EXACT),
    ("add_scalar", lambda n, a, b: a + 2, X, Y, EXACT),
    ("radd_scalar", lambda n, a, b: 2 + a, X, Y, EXACT),
    ("rsub_scalar", lambda n, a, b: 2 - a, X, Y, EXACT),
    ("rmul_scalar", lambda n, a, b: 3 * a, X, Y, EXACT),
    ("div_scalar", lambda n, a, b: a / 3, X, Y, EXACT),
    ("rdiv_scalar", lambda n, a, b: 3 / a, P, Y, EXACT),
    ("rpow_scalar", lambda n, a, b: 2.0 ** a, X, Y, TRANS),
    ("pow_array", lambda n, a, b: a ** b, P, Y, TRANS),
    ("neg", lambda n, a, b: -a, X, Y, EXACT),
    # comparisons: 0/1 in the left operand's dtype
    ("eq", lambda n, a, b: a == b, X, Y, EXACT),
    ("ne", lambda n, a, b: a != b, X, Y, EXACT),
    ("gt", lambda n, a, b: a > b, X, Y, EXACT),
    ("ge", lambda n, a, b: a >= b, X, Y, EXACT),
    ("lt", lambda n, a, b: a < b, X, Y, EXACT),
    ("le", lambda n, a, b: a <= b, X, Y, EXACT),
    ("gt_scalar", lambda n, a, b: a > 0.5, X, Y, EXACT),
    ("le_scalar", lambda n, a, b: a <= 0.5, X, Y, EXACT),
    # in place, with arrays and scalars
    ("iadd", _iop("+"), X, Y, EXACT),
    ("isub", _iop("-"), X, Y, EXACT),
    ("imul", _iop("*"), X, Y, EXACT),
    ("idiv", _iop("/"), X, P, EXACT),
    ("iadd_scalar", _iop_scalar("+"), X, Y, EXACT),
    ("isub_scalar", _iop_scalar("-"), X, Y, EXACT),
    ("imul_scalar", _iop_scalar("*"), X, Y, EXACT),
    ("idiv_scalar", _iop_scalar("/"), X, Y, EXACT),
    # the unary table
    ("sqrt", lambda n, a, b: n.sqrt(a), P, Y, EXACT),
    ("rsqrt", lambda n, a, b: n.rsqrt(a), P, Y, EXACT),
    ("exp", lambda n, a, b: n.exp(a), X, Y, TRANS),
    ("log", lambda n, a, b: n.log(a), P, Y, TRANS),
    ("cos", lambda n, a, b: n.cos(a), X, Y, TRANS),
    ("sin", lambda n, a, b: n.sin(a), X, Y, TRANS),
    ("abs", lambda n, a, b: n.abs(a), X, Y, EXACT),
    ("sign", lambda n, a, b: n.sign(a), X, Y, EXACT),
    ("round", lambda n, a, b: n.round(a * 2), X, Y, EXACT),
    ("ceil", lambda n, a, b: n.ceil(a), X, Y, EXACT),
    ("floor", lambda n, a, b: n.floor(a), X, Y, EXACT),
    ("square", lambda n, a, b: n.square(a), X, Y, EXACT),
    ("negative", lambda n, a, b: n.negative(a), X, Y, EXACT),
    ("sqrt_out", _out(lambda n, a, b, o: n.sqrt(a, out=o)), P, Y, EXACT),
    ("negative_out", _out(lambda n, a, b, o: n.negative(a, out=o)),
     X, Y, EXACT),
    # products
    ("dot", lambda n, a, b: n.dot(a, n.transpose(b)), X, Y, SUM),
    ("dot_vec", lambda n, a, b: n.dot(n.array(V), n.array(M)), X, Y, SUM),
    ("dot_3d", lambda n, a, b: n.dot(n.array(B3), n.array(C3[0])), X, Y,
     SUM),
    ("dot_out", _out(lambda n, a, b, o: n.dot(a, n.transpose(b), out=o)),
     X, Y, SUM),
    ("batch_dot", lambda n, a, b: n.batch_dot(n.array(B3), n.array(C3)),
     X, Y, SUM),
    ("batch_dot_out", _out(lambda n, a, b, o: n.batch_dot(
        n.array(B3), n.array(C3), out=o)), X, Y, SUM),
    # elementwise functions of two operands
    ("clip", lambda n, a, b: n.clip(a, -0.5, 1.0), X, Y, EXACT),
    ("clip_out", _out(lambda n, a, b, o: n.clip(a, -0.5, 1.0, out=o)),
     X, Y, EXACT),
    ("fn_add", lambda n, a, b: n.add(a, b), X, Y, EXACT),
    ("fn_add_scalar_lhs", lambda n, a, b: n.add(1.5, a), X, Y, EXACT),
    ("fn_subtract", lambda n, a, b: n.subtract(a, b), X, Y, EXACT),
    ("fn_subtract_scalar_lhs", lambda n, a, b: n.subtract(1.5, a), X, Y,
     EXACT),
    ("fn_multiply", lambda n, a, b: n.multiply(a, b), X, Y, EXACT),
    ("fn_multiply_scalar_lhs", lambda n, a, b: n.multiply(1.5, a), X, Y,
     EXACT),
    ("fn_divide", lambda n, a, b: n.divide(a, b), X, P, EXACT),
    ("fn_divide_scalar_lhs", lambda n, a, b: n.divide(1.5, b), X, P, EXACT),
    ("fn_true_divide", lambda n, a, b: n.true_divide(a, b), X, P, EXACT),
    ("fn_power", lambda n, a, b: n.power(b, a), X, P, TRANS),
    ("fn_power_scalar_lhs", lambda n, a, b: n.power(2.0, a), X, Y, TRANS),
    ("maximum", lambda n, a, b: n.maximum(a, b), X, Y, EXACT),
    ("maximum_scalar", lambda n, a, b: n.maximum(a, 0.25), X, Y, EXACT),
    ("minimum", lambda n, a, b: n.minimum(a, b), X, Y, EXACT),
    ("minimum_scalar_lhs", lambda n, a, b: n.minimum(0.25, a), X, Y, EXACT),
    # reductions
    ("sum", lambda n, a, b: n.sum(a), X, Y, SUM),
    ("sum_axis", lambda n, a, b: n.sum(a, axis=1), X, Y, SUM),
    ("sum_keepdims", lambda n, a, b: n.sum(a, axis=0, keepdims=True), X, Y,
     SUM),
    ("sum_all_keepdims", lambda n, a, b: n.sum(a, keepdims=True), X, Y, SUM),
    ("max", lambda n, a, b: n.max(a), X, Y, EXACT),
    ("max_axis", lambda n, a, b: n.max(a, axis=0), X, Y, EXACT),
    ("min", lambda n, a, b: n.min(a), X, Y, EXACT),
    ("min_axis_keepdims", lambda n, a, b: n.min(a, axis=1, keepdims=True),
     X, Y, EXACT),
    ("argmax", lambda n, a, b: n.argmax(a), X, Y, EXACT),
    ("argmax_axis", lambda n, a, b: n.argmax(a, axis=0), X, Y, EXACT),
    ("argmax_keepdims", lambda n, a, b: n.argmax(a, axis=1, keepdims=True),
     X, Y, EXACT),
    ("argmax_all_keepdims", lambda n, a, b: n.argmax(a, keepdims=True),
     X, Y, EXACT),
    ("argmax_channel", lambda n, a, b: n.argmax_channel(a), X, Y, EXACT),
    ("norm", lambda n, a, b: n.norm(a), X, Y, SUM),
    # layout
    ("transpose", lambda n, a, b: n.transpose(a), X, Y, EXACT),
    ("transpose_axes", lambda n, a, b: n.transpose(n.array(B3), (1, 0, 2)),
     X, Y, EXACT),
    ("T", lambda n, a, b: a.T, X, Y, EXACT),
    ("swapaxes", lambda n, a, b: n.swapaxes(n.array(B3), 0, 2), X, Y, EXACT),
    ("expand_dims", lambda n, a, b: n.expand_dims(a, 1), X, Y, EXACT),
    ("flip", lambda n, a, b: n.flip(a, 1), X, Y, EXACT),
    ("crop", lambda n, a, b: n.crop(a, (1, 2), (3, 5)), X, Y, EXACT),
    ("slice_axis", lambda n, a, b: n.slice_axis(a, 1, 1, 3), X, Y, EXACT),
    ("slice_axis_end0", lambda n, a, b: n.slice_axis(a, 0, 2, 0), X, Y,
     EXACT),
    ("broadcast_to", lambda n, a, b: n.broadcast_to(a[1:2], (3, 5)), X, Y,
     EXACT),
    ("broadcast_axis", lambda n, a, b: n.broadcast_axis(
        n.expand_dims(a, 0), axis=0, size=3), X, Y, EXACT),
    ("concatenate", lambda n, a, b: n.concatenate([a, b]), X, Y, EXACT),
    ("concatenate_axis1", lambda n, a, b: n.concatenate([a, b], axis=1),
     X, Y, EXACT),
    # losses and index functions
    ("smooth_l1", lambda n, a, b: n.smooth_l1(a), X, Y, EXACT),
    ("smooth_l1_scalar", lambda n, a, b: n.smooth_l1(a, scalar=2.0), X, Y,
     EXACT),
    ("softmax_cross_entropy", lambda n, a, b: n.softmax_cross_entropy(
        a, n.array(LAB)), X, Y, SUM),
    ("onehot_encode", lambda n, a, b: n.onehot_encode(n.array(IDX),
                                                      n.zeros((4, 5))),
     X, Y, EXACT),
    ("choose_element_0index", lambda n, a, b: n.choose_element_0index(
        a, n.array(IDX)), X, Y, EXACT),
    ("choose_element_0index_out", _out(
        lambda n, a, b, o: n.choose_element_0index(a, n.array(IDX), out=o)),
     X, Y, EXACT),
    ("fill_element_0index", lambda n, a, b: n.fill_element_0index(
        a, n.array(V[:4]), n.array(IDX)), X, Y, EXACT),
    ("fill_element_0index_out", _out(
        lambda n, a, b, o: n.fill_element_0index(a, n.array(V[:4]),
                                                 n.array(IDX), out=o)),
     X, Y, EXACT),
    ("elementwise_sum", lambda n, a, b: n.elementwise_sum([a, b, a]), X, Y,
     EXACT),
    ("add_n_out", _out(lambda n, a, b, o: n.add_n([a, b], out=o)), X, Y,
     EXACT),
    # creation
    ("zeros", lambda n, a, b: n.zeros((2, 3)), X, Y, EXACT),
    ("ones", lambda n, a, b: n.ones(4), X, Y, EXACT),
    ("full", lambda n, a, b: n.full((2, 2), 3.5), X, Y, EXACT),
    ("arange", lambda n, a, b: n.arange(0, 10, 2), X, Y, EXACT),
    ("arange_stop_only", lambda n, a, b: n.arange(5), X, Y, EXACT),
    ("arange_repeat", lambda n, a, b: n.arange(1, 4, 0.5, repeat=3), X, Y,
     EXACT),
    ("astype", lambda n, a, b: a.astype(np.int32), X, Y, EXACT),
    ("copy", lambda n, a, b: a.copy(), X, Y, EXACT),
]


@pytest.mark.parametrize("fn,x,y,tol", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_matches_jax(fn, x, y, tol):
    want = fn(jnd, jnd.array(x), jnd.array(y))
    got = fn(nd, nd.array(x), nd.array(y))
    assert isinstance(got, nd.NDArray)
    w, g = np.asarray(want.asnumpy()), got.asnumpy()
    assert g.shape == w.shape
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if tol == EXACT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# twins of tests/test_ndarray.py
# ---------------------------------------------------------------------------
def reldiff(a, b):
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + 1e-8
    return diff / norm


def test_creation():
    a = nd.zeros((3, 4))
    assert a.shape == (3, 4)
    assert a.dtype == torch.float32
    assert np.all(a.asnumpy() == 0)
    b = nd.ones((2, 3), dtype=np.float64)
    assert b.asnumpy().dtype == np.float64
    c = nd.full((2, 2), 3.5)
    assert np.all(c.asnumpy() == 3.5)
    d = nd.array([[1, 2], [3, 4]])
    assert d.shape == (2, 2)
    e = nd.arange(0, 10, 2)
    assert np.allclose(e.asnumpy(), np.arange(0, 10, 2))


def test_elementwise():
    rng = np.random.RandomState(0)
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.rand(4, 5).astype(np.float32)
    a, b = nd.array(x), nd.array(y)
    assert reldiff((a + b).asnumpy(), x + y) < 1e-6
    assert reldiff((a - b).asnumpy(), x - y) < 1e-6
    assert reldiff((a * b).asnumpy(), x * y) < 1e-6
    assert reldiff((a / b).asnumpy(), x / y) < 1e-5
    assert reldiff((a + 2).asnumpy(), x + 2) < 1e-6
    assert reldiff((2 - a).asnumpy(), 2 - x) < 1e-6
    assert reldiff((-a).asnumpy(), -x) < 1e-6
    assert reldiff((a ** 2).asnumpy(), x ** 2) < 1e-5


def test_inplace():
    x = np.ones((3, 3), dtype=np.float32)
    a = nd.array(x)
    a += 2
    assert np.all(a.asnumpy() == 3)
    a *= 2
    assert np.all(a.asnumpy() == 6)
    a -= 1
    assert np.all(a.asnumpy() == 5)
    a /= 5
    assert np.all(a.asnumpy() == 1)
    assert np.all(x == 1)          # the numpy source is not aliased


def test_slice_view_aliasing():
    a = nd.zeros((4, 3))
    s = a[1:3]
    s[:] = 7
    out = a.asnumpy()
    assert np.all(out[1:3] == 7)
    assert np.all(out[0] == 0) and np.all(out[3] == 0)
    a[:] = 1
    assert np.all(s.asnumpy() == 1)
    row = a.at(2)
    row[:] = 5
    assert np.all(a.asnumpy()[2] == 5)


def test_setitem():
    a = nd.zeros((4, 3))
    a[1] = 2.0
    assert np.all(a.asnumpy()[1] == 2)
    a[2:4] = nd.ones((2, 3))
    assert np.all(a.asnumpy()[2:4] == 1)


def test_reshape_view():
    a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    b = a.reshape((4, 3))
    assert b.shape == (4, 3)
    b[:] = 0
    assert np.all(a.asnumpy() == 0)
    c = a.reshape((2, -1))
    assert c.shape == (2, 6)


def test_copyto():
    a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = nd.zeros((2, 3))
    a.copyto(b)
    assert np.allclose(b.asnumpy(), a.asnumpy())
    c = a.copyto(tmx.cpu(0))
    assert np.allclose(c.asnumpy(), a.asnumpy())
    d = a.copy()
    d += 1
    assert not np.allclose(d.asnumpy(), a.asnumpy())


def test_registered_functions():
    rng = np.random.RandomState(1)
    x = rng.rand(3, 4).astype(np.float32) + 0.5
    a = nd.array(x)
    assert reldiff(nd.sqrt(a).asnumpy(), np.sqrt(x)) < 1e-5
    assert reldiff(nd.exp(a).asnumpy(), np.exp(x)) < 1e-5
    assert reldiff(nd.log(a).asnumpy(), np.log(x)) < 1e-5
    assert reldiff(nd.square(a).asnumpy(), x ** 2) < 1e-5
    assert reldiff(nd.clip(a, 0.6, 0.9).asnumpy(), np.clip(x, 0.6, 0.9)) < 1e-6
    assert reldiff(nd.sum(a).asnumpy(), x.sum()) < 1e-5
    assert reldiff(nd.norm(a).asnumpy(), np.sqrt((x ** 2).sum())) < 1e-5
    assert reldiff(nd.transpose(a).asnumpy(), x.T) < 1e-6


def test_dot():
    rng = np.random.RandomState(2)
    x = rng.rand(3, 4).astype(np.float32)
    y = rng.rand(4, 5).astype(np.float32)
    assert reldiff(nd.dot(nd.array(x), nd.array(y)).asnumpy(), x.dot(y)) < 1e-4
    bx = rng.rand(2, 3, 4).astype(np.float32)
    by = rng.rand(2, 4, 5).astype(np.float32)
    assert reldiff(nd.batch_dot(nd.array(bx), nd.array(by)).asnumpy(),
                   np.matmul(bx, by)) < 1e-4


def test_onehot_and_choose():
    idx = nd.array(np.array([1, 0, 2], dtype=np.float32))
    out = nd.zeros((3, 3))
    nd.onehot_encode(idx, out)
    expect = np.eye(3, dtype=np.float32)[[1, 0, 2]]
    assert np.allclose(out.asnumpy(), expect)
    mat = nd.array(np.arange(9, dtype=np.float32).reshape(3, 3))
    picked = nd.choose_element_0index(mat, idx)
    assert np.allclose(picked.asnumpy(), [1, 3, 8])


def test_save_load():
    rng = np.random.RandomState(3)
    arrays = [nd.array(rng.rand(3, 4).astype(np.float32)),
              nd.array(rng.rand(5,).astype(np.float32))]
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "test.params")
        nd.save(fname, arrays)
        loaded = nd.load(fname)
        assert len(loaded) == 2
        for a, b in zip(arrays, loaded):
            assert np.allclose(a.asnumpy(), b.asnumpy())
        named = {"w": arrays[0], "b": arrays[1]}
        nd.save(fname, named)
        loaded = nd.load(fname)
        assert set(loaded) == {"w", "b"}
        assert np.allclose(loaded["w"].asnumpy(), arrays[0].asnumpy())


def test_scalar_and_compare():
    a = nd.array(np.array([[2.0]], dtype=np.float32))
    assert a.asscalar() == 2.0
    x = nd.array(np.array([1.0, 2.0, 3.0], dtype=np.float32))
    y = nd.array(np.array([2.0, 2.0, 2.0], dtype=np.float32))
    assert np.allclose((x > y).asnumpy(), [0, 0, 1])
    assert np.allclose((x == y).asnumpy(), [0, 1, 0])


def test_broadcast():
    a = nd.array(np.arange(3, dtype=np.float32).reshape(1, 3))
    b = nd.broadcast_to(a, (4, 3))
    assert b.shape == (4, 3)
    assert np.all(b.asnumpy() == np.broadcast_to(np.arange(3), (4, 3)))
    c = nd.broadcast_axis(a, axis=0, size=5)
    assert c.shape == (5, 3)


def test_context():
    a = nd.zeros((2, 2), ctx=tmx.cpu(0))
    assert a.context == tmx.cpu(0)
    b = a.as_in_context(tmx.cpu(1))
    assert b.context == tmx.cpu(1)
    assert np.allclose(a.asnumpy(), b.asnumpy())
    # gpu() is a CUDA device in the port: without one it raises, never
    # drops to the CPU (the JAX package's gpu() falls back there)
    if torch.cuda.is_available():
        assert nd.zeros((2, 2), ctx=tmx.gpu(0)).data.is_cuda
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.zeros((2, 2), ctx=tmx.gpu(0))


def test_waitall():
    a = nd.ones((10, 10))
    b = a * 2
    nd.waitall()
    assert np.all(b.asnumpy() == 2)


# ---------------------------------------------------------------------------
# twins of tests/test_random.py (distributions, not values)
# ---------------------------------------------------------------------------
def test_random_seed_determinism():
    tmx.random.seed(7)
    a = tmx.random.uniform(0, 1, shape=(100,)).asnumpy()
    tmx.random.seed(7)
    b = tmx.random.uniform(0, 1, shape=(100,)).asnumpy()
    assert np.array_equal(a, b)
    c = tmx.random.uniform(0, 1, shape=(100,)).asnumpy()
    assert not np.allclose(b, c)


def test_random_uniform_range():
    tmx.random.seed(0)
    a = tmx.random.uniform(-2, 3, shape=(10000,)).asnumpy()
    assert a.min() >= -2 and a.max() < 3
    assert abs(a.mean() - 0.5) < 0.1


def test_random_normal_moments():
    tmx.random.seed(0)
    a = tmx.random.normal(1.0, 2.0, shape=(50000,)).asnumpy()
    assert abs(a.mean() - 1.0) < 0.1
    assert abs(a.std() - 2.0) < 0.1
    assert tmx.random.gaussian is tmx.random.normal


def test_random_out_param():
    out = nd.zeros((50,))
    tmx.random.uniform(0, 1, out=out)
    assert out.asnumpy().max() > 0


@pytest.mark.parametrize("sampler", ["uniform", "normal", "randint"])
def test_random_matches_jax_in_distribution(sampler):
    """Same call in both packages: same shape and dtype, and the sample
    means agree within 5 standard errors."""
    args = {"uniform": (-1.0, 3.0), "normal": (0.5, 2.0),
            "randint": (2, 9)}[sampler]
    kw = {"shape": (20000,)}
    got = getattr(tmx.random, sampler)(*args, **kw).asnumpy()
    want = np.asarray(getattr(jmx.random, sampler)(*args, **kw).asnumpy())
    assert got.shape == want.shape and got.dtype == want.dtype
    se = want.std() / np.sqrt(want.size)
    assert abs(got.mean() - want.mean()) < 5 * np.sqrt(2) * se
    if sampler != "normal":
        assert got.min() >= args[0] and got.max() < args[1]


def test_random_randint_range_and_out_view():
    tmx.random.seed(3)
    r = tmx.random.randint(2, 9, shape=(5000,))
    v = r.asnumpy()
    assert r.dtype == torch.int32 and v.min() == 2 and v.max() == 8
    base = nd.zeros((4, 100))
    tmx.random.uniform(5, 6, out=base[1:3])       # out= writes through
    got = base.asnumpy()
    assert np.all(got[[0, 3]] == 0) and np.all(got[1:3] >= 5)


# ---------------------------------------------------------------------------
# what the port adds: aliasing of every write, dtypes, contexts
# ---------------------------------------------------------------------------
def test_every_write_goes_through_views():
    x = nd.zeros((4, 6))
    x[1:3][:] = 2                                  # slice of a slice
    x.reshape((6, 4))[0][:] = 1                    # reshape view, then row
    v = x[3]
    v += 5                                         # in place on a view
    nd.negative(nd.ones((6,)), out=x[2])           # out= into a view
    nd.full((6,), 9.0).copyto(x.at(0))             # copyto into a view
    x[1:2] = np.arange(6)                          # setitem, numpy source
    want = np.zeros((4, 6), np.float32)
    want[1:3] = 2
    want.reshape(6, 4)[0] = 1
    want[3] += 5
    want[2] = -1
    want[0] = 9
    want[1] = np.arange(6)
    np.testing.assert_array_equal(x.asnumpy(), want)


def test_set_data_keeps_dtype_and_broadcasts():
    a = nd.zeros((3, 4), dtype=np.int32)
    a[:] = nd.array(np.full((4,), 2.7, np.float32))
    assert a.dtype == torch.int32 and np.all(a.asnumpy() == 2)
    a /= 2                                         # true division, cast back
    assert a.dtype == torch.int32 and np.all(a.asnumpy() == 1)
    a[1:3] = a[0:2] + 5                            # overlapping source
    assert a.asnumpy()[:, 0].tolist() == [1, 6, 6]


def test_array_semantics():
    f64 = nd.array(np.ones((2, 2)))
    assert f64.dtype == torch.float32               # mx_real_t
    assert nd.array(np.ones(2), dtype=np.float64).dtype == torch.float64
    src = nd.array(np.ones(3, np.float32))
    cp = nd.array(src)
    cp += 1
    assert np.all(src.asnumpy() == 1)               # NDArray sources copy
    ints = nd.array(np.arange(4, dtype=np.int32))
    assert (ints > 1).dtype == torch.int32          # compare keeps dtype
    with pytest.raises(MXNetError, match="ambiguous"):
        bool(ints)
    assert hash(ints) == id(ints)
    assert len(ints) == 4 and ints.size == 4 and ints.ndim == 1
    assert nd.array(np.ones((2, 3))).T.shape == (3, 2)
    with pytest.raises(MXNetError, match="step"):
        ints[::2]
    with pytest.raises(MXNetError, match="size mismatch"):
        ints.reshape((3,))
    ro = nd.NDArray(torch.zeros(2), writable=False)
    with pytest.raises(MXNetError, match="read-only"):
        ro[:] = 1
    with pytest.raises(MXNetError, match="read-only"):
        ro[0:1][:] = 1
    with pytest.raises(MXNetError, match="not a scalar"):
        ints.asscalar()


def test_current_context_scopes_are_per_thread():
    assert tmx.current_context() == tmx.cpu(0)     # the autouse scope
    with tmx.cpu(1):
        assert tmx.current_context() == tmx.cpu(1)
        assert nd.zeros((1,)).context == tmx.cpu(1)
        with tmx.cpu(2):
            assert tmx.current_context() == tmx.cpu(2)
        assert tmx.current_context() == tmx.cpu(1)
    assert tmx.current_context() == tmx.cpu(0)
    seen = {}
    t = threading.Thread(target=lambda: seen.update(
        ctx=tmx.current_context()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen["ctx"] == tmx.gpu(0)


def test_no_scope_means_gpu0():
    """Outside any ``with`` scope (a fresh thread), ``nd.array``,
    ``nd.zeros``, ``nd.load`` and ``random.uniform`` target gpu(0): they
    raise without CUDA and never drop to the CPU."""
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "x.params")
        nd.save(fname, [nd.ones((2,))])
        calls = {"array": lambda: nd.array(np.ones(3)),
                 "zeros": lambda: nd.zeros((2,)),
                 "load": lambda: nd.load(fname),
                 "uniform": lambda: tmx.random.uniform(shape=(2,))}
        results = {}

        def run():
            for name, call in calls.items():
                try:
                    out = call()
                    results[name] = (out[0] if isinstance(out, list)
                                     else out).context
                except MXNetError as err:
                    results[name] = err

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    for name, res in results.items():
        if torch.cuda.is_available():
            assert res == tmx.gpu(0), (name, res)
        else:
            assert isinstance(res, MXNetError), (name, res)
            assert "gpu(0) requested but no CUDA device" in str(res)


def test_context_and_base_names_match_jax():
    """The public names the port's ``context`` and ``base`` lacked:
    ``num_gpus`` (CUDA devices: 0 here), ``num_tpus`` (0), ``cpu_pinned``
    (a host context; its arrays are pinned where CUDA is present), and
    the reference's type names and dtype flags, the JAX package's."""
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase
    assert tmx.num_gpus() == torch.cuda.device_count() == 0
    assert tmx.num_tpus() == 0
    ctx = tmx.cpu_pinned(0)
    assert ctx.device_type == "cpu_pinned" == jmx.cpu_pinned().device_type
    assert ctx.device_typeid == 3 and str(ctx) == "cpu_pinned(0)"
    a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=ctx)
    assert a.context == ctx and a.data.device.type == "cpu"
    np.testing.assert_array_equal(a.asnumpy(), np.arange(6).reshape(2, 3))
    assert nd.zeros((2,), ctx=ctx).context == ctx
    assert tbase.mx_real_t is jbase.mx_real_t is np.float32
    assert tbase.mx_uint is jbase.mx_uint is int
    assert tbase.string_types == jbase.string_types
    assert tbase.numeric_types == jbase.numeric_types
    for dt in (np.float32, np.float64, np.float16, np.uint8, np.int32,
               np.int64, np.bool_, jbase.bfloat16):
        flag = tbase.dtype_np_to_mx(dt)
        assert flag == jbase.dtype_np_to_mx(dt)
        assert tbase.dtype_mx_to_np(flag) == jbase.dtype_mx_to_np(flag)
    for bad in (lambda: tbase.dtype_np_to_mx(np.complex64),
                lambda: tbase.dtype_mx_to_np(99)):
        with pytest.raises(MXNetError):
            bad()
