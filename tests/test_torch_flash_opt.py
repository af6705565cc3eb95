"""The port's training kernels against the JAX package, on the CPU.

``mxnet_tpu_torch.kernels.flash_attention`` and ``.fused_opt`` hold the
hand-written CUDA kernels of the training slice; on CPU tensors their
wrappers run the plain PyTorch versions, which these tests hold against
the JAX package's Pallas kernels in interpret mode (and its jnp
references) on identical float32 inputs made with numpy.  The CUDA
kernels themselves are held against the plain versions on the GPU
(tests/test_torch_cuda.py and chip_smoke.py).  Also here: the
``SoftmaxOutput`` gradient against the JAX op's custom VJP.

Tolerances: flash forward 2e-6 (float32, the same online softmax over
other block boundaries); flash gradients rtol 1e-4, atol 1e-5 (sums of
up to 256 products of values of order 1, ordered differently); the
optimizer sweep against JAX 1e-6 relative (a handful of float32
roundings per element, XLA may contract a multiply-add); port fused
against port leafwise: bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.kernels import fused_opt as jfo
from mxnet_tpu.parallel import ring_attention as jra
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import fused_opt as tfo
from mxnet_tpu_torch.parallel import ring_attention as tra


def _qkv(seed, B=1, H=2, S=256, D=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_matches_pallas_interpret(causal):
    """o and lse of the port's flash forward (plain version on the CPU)
    == the JAX Pallas kernel in interpret mode, two 128-row blocks."""
    q, k, v = _qkv(1)
    jo, jl = jra._flash_forward_kernel_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.25,
        128, 128, True)
    to, tl = tfa.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)), causal=causal, scale=0.25)
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    assert tuple(tl.shape) == (1, 2, 256)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-6,
                               rtol=0)


def _grads_torch(q, k, v, causal):
    tq, tk, tv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tra.flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_custom_vjp(causal):
    """Gradients of the port's flash_attention (blockwise recompute from
    the saved logsumexp) == jax.grad of the JAX flash_attention with its
    Pallas forward in interpret mode (tests/test_ring_attention.py:221)."""
    q, k, v = _qkv(2)

    def loss(q, k, v):
        return jnp.sum(jra.flash_attention(q, k, v, causal=causal,
                                           interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w in zip(_grads_torch(q, k, v, causal), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_sequence_matches_reference(causal):
    """S = 200 (not a multiple of any block): the port runs the same
    function (the JAX flash_attention falls back to its reference there);
    forward and gradients against jnp attention_reference."""
    q, k, v = _qkv(3, S=200)
    got = tra.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    want = jra.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)

    def loss(q, k, v):
        return jnp.sum(jra.attention_reference(q, k, v, causal=causal) ** 2)

    want_g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(_grads_torch(q, k, v, causal), want_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_flash_cpu_wrapper_is_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch; the port's attention_reference is re-exported by
    ops/attention.py for slice 1's imports."""
    from mxnet_tpu_torch.ops import attention as tops
    q, k, v = map(torch.from_numpy, _qkv(4, S=64))
    before = tfa.flash_attention_forward.launches
    o, lse = tfa.flash_attention_forward(q, k, v, causal=True)
    assert tfa.flash_attention_forward.launches == before
    ro, rl = tfa.flash_attention_forward_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert tops.attention_reference is tra.attention_reference
    np.testing.assert_allclose(
        o.numpy(), tra.attention_reference(q, k, v, causal=True).numpy(),
        atol=2e-6, rtol=0)


def test_sequence_parallel_context_raises():
    """An active sp context no longer raises (sequence parallelism is
    ported): on a one-member sp ring it runs the ring, one hop, which is
    the flash forward itself; a mesh across processes still raises,
    naming its item (ring attention over a process group)."""
    from mxnet_tpu_torch.parallel import make_mesh
    import mxnet_tpu_torch as mx
    mesh = make_mesh([mx.cpu()], sp=1)
    q, k, v = map(torch.from_numpy, _qkv(5, S=32))
    tra.reset_ring_counts()
    with tra.sequence_parallel(mesh):
        got = tra.sharded_self_attention(q, k, v, causal=True)
    assert tra.ring_counts()["hops"] == {0: 1}
    assert torch.equal(got, tra.flash_attention(q, k, v, causal=True))
    assert tra.sharded_self_attention(q, k, v).shape == q.shape
    mesh.num_processes = 2
    with tra.sequence_parallel(mesh):
        with pytest.raises(MXNetError, match=r"3 \(k\)"):
            tra.sharded_self_attention(q, k, v, causal=True)


# ----------------------------------------------------------------------
# the fused optimizer sweep
# ----------------------------------------------------------------------
_SHAPES = {"fc1_weight": (16, 8), "fc1_bias": (16,), "fc2_weight": (4, 16),
           "fc2_bias": (4,), "ln_gamma": (7,)}
_OPTS = {
    "sgd": dict(learning_rate=0.05),
    "sgd_momentum": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=0.01),
}


def _leaf_case(name, seed=0):
    """The same params, grads and random non-zero state in both
    packages' layouts, from numpy."""
    kind = "adam" if name == "adam" else "sgd"
    kw = dict(_OPTS[name], rescale_grad=0.5, wd=0.01, clip_gradient=0.8)
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    grads = {n: rng.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    if name == "sgd":
        state = {n: None for n in _SHAPES}
    elif name == "sgd_momentum":
        state = {n: rng.randn(*s).astype(np.float32) * 0.1
                 for n, s in _SHAPES.items()}
    else:
        state = {n: (rng.randn(*s).astype(np.float32) * 0.1,
                     rng.rand(*s).astype(np.float32) * 0.1)
                 for n, s in _SHAPES.items()}
    return kind, kw, params, grads, state


def _torch_state(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(torch.from_numpy(a.copy()) for a in s)
    return torch.from_numpy(s.copy())


def _leaves(s):
    return [] if s is None else list(s) if isinstance(s, tuple) else [s]


def _port_case(name, seed=0):
    kind, kw, params, grads, state = _leaf_case(name, seed)
    opt = topt.create(kind, **kw)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    tg = {n: torch.from_numpy(a) for n, a in grads.items()}
    ts = {n: _torch_state(s) for n, s in state.items()}
    return opt, tp, tg, ts


@pytest.mark.parametrize("name", sorted(_OPTS))
@pytest.mark.parametrize("mode", ["kernel", "1"])
def test_port_fused_bitwise_equals_leafwise(name, mode):
    """Port fused (tiny buckets: several sweeps) == port leafwise
    (``_preprocess_grad`` + ``update_fn`` per leaf), bitwise, for weights
    and state (tests/test_kernels.py:330)."""
    opt, tp, tg, ts = _port_case(name)
    lr, wd, t = 0.05, 0.01, 3
    want_w, want_s = {}, {}
    for n in tp:
        want_w[n], want_s[n] = opt.update_fn(
            tp[n], opt._preprocess_grad(tg[n]), ts[n], lr, wd, t)
    before = tfo.sweep.launches
    got_w, got_s = tfo.fused_apply(opt, tp, tg, ts, lr, wd, t, nbytes=256,
                                   mode=mode, preprocess=True)
    assert tfo.sweep.launches == before       # CPU: the plain version
    assert len(tfo.plan_buckets(tp, nbytes=256)) > 1
    for n in tp:
        assert torch.equal(got_w[n], want_w[n]), n
        assert tuple(got_w[n].shape) == _SHAPES[n]
        a, b = _leaves(want_s[n]), _leaves(got_s[n])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y), n


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_port_sweep_matches_jax_pallas_sweep(name):
    """The port's sweep (kernel mode, plain version on the CPU) against
    JAX ``fused_apply(mode="kernel")``, its Pallas sweep in interpret
    mode, with the gradient preprocessing folded in: float32 rounding
    only (tests/test_kernels.py:351)."""
    kind, kw, params, grads, state = _leaf_case(name, seed=5)
    jopt = jmx.optimizer.create(kind, **kw)
    jstate = {n: (None if s is None else tuple(map(jnp.asarray, s))
                  if isinstance(s, tuple) else jnp.asarray(s))
              for n, s in state.items()}
    jw, js = jfo.fused_apply(
        jopt, {n: jnp.asarray(a) for n, a in params.items()},
        {n: jnp.asarray(a) for n, a in grads.items()}, jstate,
        jnp.float32(0.05), jnp.float32(0.01), jnp.asarray(2.0, jnp.float32),
        mode="kernel", interpret=True, preprocess=jopt._preprocess_grad)
    opt, tp, tg, ts = _port_case(name, seed=5)
    tw, tsn = tfo.fused_apply(opt, tp, tg, ts, 0.05, 0.01, 2, mode="kernel",
                              preprocess=True)
    for n in params:
        np.testing.assert_allclose(tw[n].numpy(), np.asarray(jw[n]),
                                   rtol=1e-6, atol=1e-7)
        a = jax.tree_util.tree_leaves(js[n])
        b = _leaves(tsn[n])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-7)


def test_plan_buckets_match_jax():
    """Same names, same byte sizes: the same bucket plan as the JAX
    package at every target (partition_buckets is a copy)."""
    rng = np.random.RandomState(0)
    shapes = {"a": (300,), "b": (17, 5), "c": (1000,), "d": (3,),
              "e": (64, 64)}
    jp = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    tp = {n: torch.zeros(s) for n, s in shapes.items()}
    for nbytes in (0, 64, 1200, 4096, int(rng.randint(100, 20000))):
        assert tfo.plan_buckets(tp, nbytes=nbytes) == \
            jfo.plan_buckets(jp, nbytes=nbytes)


def test_kernel_mode_without_a_body_raises(monkeypatch):
    """An elementwise optimizer the CUDA sweep can have no body for (here
    a subclass of SGD whose own update takes a tanh, outside the
    generated body's IR) raises in kernel mode, naming the optimizer;
    mode '1' runs it."""
    class Nesterov(topt.SGD):
        def update_fn(self, weight, grad, state, lr, wd, t):
            g = grad + wd * weight
            m = self.momentum * state + torch.tanh(g)
            return weight - lr * (g + self.momentum * m), m

    opt = Nesterov(momentum=0.9)
    _, tp, tg, ts = _port_case("sgd_momentum")
    with pytest.raises(MXNetError, match="Nesterov"):
        tfo.fused_apply(opt, tp, tg, ts, 0.1, 0.0, 1, mode="kernel")
    w, _ = tfo.fused_apply(opt, tp, tg, ts, 0.1, 0.0, 1, mode="1")
    assert set(w) == set(tp)
    monkeypatch.setenv("MXTPU_FUSED_OPT", "bogus")
    with pytest.raises(MXNetError):
        tfo.fused_opt_mode()


def test_sweep_cpu_wrapper_updates_in_place():
    """``sweep`` on CPU tensors runs the plain version and writes the
    weight and state vectors in place, counting no launch."""
    opt = topt.create("sgd", learning_rate=0.1, momentum=0.9,
                      rescale_grad=0.25)
    rng = np.random.RandomState(9)
    w, g, m = [torch.from_numpy(rng.randn(1001).astype(np.float32))
               for _ in range(3)]
    want_w, want_s = tfo.sweep_reference(opt, w.clone(), g, [m.clone()],
                                         0.1, 0.0, 1)
    before = tfo.sweep.launches
    got_w, got_s = tfo.sweep(opt, w, g, [m], 0.1, 0.0, 1)
    assert got_w is w and got_s[0] is m
    assert tfo.sweep.launches == before
    assert torch.equal(w, want_w) and torch.equal(m, want_s[0])


# ----------------------------------------------------------------------
# SoftmaxOutput's gradient
# ----------------------------------------------------------------------
@pytest.mark.parametrize("params", [
    {},
    {"grad_scale": 0.5, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": -1.0, "normalization": "valid"},
    {"out_grad": True},
    {"multi_output": True, "use_ignore": True, "ignore_label": 2.0},
])
def test_softmax_output_grad_matches_jax_vjp(params):
    """Forward and the reference backward ((p - onehot) * grad_scale,
    ignored labels zeroed, normalization, the head gradient multiplied in
    only with out_grad) against the JAX op's custom VJP."""
    from mxnet_tpu.ops.registry import create_operator as jcreate
    from mxnet_tpu_torch.ops.registry import create_operator as tcreate
    rng = np.random.RandomState(7)
    multi = params.get("multi_output", False)
    shape, lshape = ((3, 5, 4), (3, 4)) if multi else ((6, 5), (6,))
    data = rng.randn(*shape).astype(np.float32)
    label = rng.randint(0, 5, lshape).astype(np.float32)
    if params.get("use_ignore"):
        label.flat[::3] = params["ignore_label"]
    head = rng.randn(*shape).astype(np.float32)
    attrs = {k: str(v) for k, v in params.items()}
    jop, top = jcreate("SoftmaxOutput", **attrs), \
        tcreate("SoftmaxOutput", **attrs)

    def f(d):
        return jop.forward([d, jnp.asarray(label)], [], True, None)[0][0]

    jout, vjp = jax.vjp(f, jnp.asarray(data))
    (jgrad,) = vjp(jnp.asarray(head))
    td = torch.from_numpy(data).requires_grad_()
    tout = top.forward([td, torch.from_numpy(label)], [], True, None)[0][0]
    tout.backward(torch.from_numpy(head))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6, rtol=0)
