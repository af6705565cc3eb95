"""The generated sweep body (``mxnet_tpu_torch/kernels/sweep_codegen.py``)
against the JAX package and against the plain ``update_fn``, on the CPU.

A user's optimizer whose ``update_fn`` is its own (one state vector, a
``sign`` and a ``clamp`` in its formula) is defined in both packages with
the same formula.  The port's ``fused_apply(mode="kernel")`` runs the
plain version on CPU tensors; it is held to the JAX ``fused_apply(mode=
"kernel")``, the Pallas sweep in interpret mode, within 1e-6 (sqrt and
sign round alike; XLA may contract a multiply-add).  The traced IR,
evaluated op by op with PyTorch's operators (``sweep_codegen.evaluate``),
must equal the plain ``update_fn`` bitwise, for the user's optimizer and
for every elementwise optimizer of the package; and the generated CUDA
text, compiled by the host C++ compiler under a prelude that maps each
CUDA intrinsic to its IEEE float operation (no contraction), must equal
the plain version bitwise on both of its routes, with and without the
skip flag, for the formulas without ``pow``, ``exp`` or ``log`` (whose
host library may round otherwise than the card's).  PyTorch's CPU
``sqrt`` is not always correctly rounded (its vectorised path); the
card's is, and so is the text's ``__fsqrt_rn``: that reference takes its
square roots in float64, rounded to float32, which is correctly rounded
(double rounding is exact for a square root at 53 over 24 bits).  The
CUDA text itself runs on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 17.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.kernels import fused_opt as jfo

from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_opt as tfo
from mxnet_tpu_torch.kernels import sweep_codegen as cg

_SHAPES = {"fc1_weight": (7, 5), "fc1_bias": (13,), "conv_weight": (3, 4, 2),
           "ln_gamma": (9,)}


def _sign_clip_classes():
    """The same user optimizer in both packages: a momentum of the
    gradient, stepped by sign(m) * sqrt(|m|) clamped to +-bound."""
    class TorchSignClip(topt.Optimizer):
        elementwise = True

        def __init__(self, momentum=0.9, bound=0.05, **kwargs):
            super().__init__(**kwargs)
            self.momentum = momentum
            self.bound = bound

        def create_state_arrays(self, shape, dtype=torch.float32,
                                device=None):
            return torch.zeros(tuple(shape), dtype=dtype, device=device)

        def update_fn(self, weight, grad, state, lr, wd, t):
            m = self.momentum * state + (1.0 - self.momentum) * grad
            step = torch.clamp(torch.sign(m) * torch.sqrt(torch.abs(m)),
                               -self.bound, self.bound)
            return weight - lr * (step + wd * weight), m

    class JaxSignClip(jmx.optimizer.Optimizer):
        elementwise = True

        def __init__(self, momentum=0.9, bound=0.05, **kwargs):
            super().__init__(**kwargs)
            self.momentum = momentum
            self.bound = bound

        def create_state_arrays(self, shape, dtype=np.float32):
            return jnp.zeros(shape, dtype)

        def update_fn(self, weight, grad, state, lr, wd, t):
            m = self.momentum * state + (1.0 - self.momentum) * grad
            step = jnp.clip(jnp.sign(m) * jnp.sqrt(jnp.abs(m)),
                            -self.bound, self.bound)
            return weight - lr * (step + wd * weight), m
    return TorchSignClip, JaxSignClip


TorchSignClip, JaxSignClip = _sign_clip_classes()
_KW = dict(learning_rate=0.05, rescale_grad=0.5, wd=0.01, clip_gradient=0.8)


def _case(seed):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    grads = {n: rng.randn(*s).astype(np.float32) for n, s in _SHAPES.items()}
    state = {n: (rng.randn(*s) * 0.01).astype(np.float32)
             for n, s in _SHAPES.items()}
    return params, grads, state


def test_user_update_fn_kernel_mode_matches_jax_pallas_sweep():
    """fused_apply(mode="kernel") with the user's optimizer: the port (the
    generated body's plain version on the CPU, several buckets) against
    the JAX Pallas sweep in interpret mode, within 1e-6."""
    params, grads, state = _case(3)
    jopt = JaxSignClip(**_KW)
    jw, js = jfo.fused_apply(
        jopt, {n: jnp.asarray(a) for n, a in params.items()},
        {n: jnp.asarray(a) for n, a in grads.items()},
        {n: jnp.asarray(a) for n, a in state.items()},
        jnp.float32(0.05), jnp.float32(0.01), jnp.asarray(2.0, jnp.float32),
        mode="kernel", interpret=True, preprocess=jopt._preprocess_grad)
    opt = TorchSignClip(**_KW)
    assert tfo.sweep_body(opt) == tfo.GENERATED
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    tg = {n: torch.from_numpy(a) for n, a in grads.items()}
    ts = {n: torch.from_numpy(a.copy()) for n, a in state.items()}
    before = tfo.sweep.launches
    tw, tsn = tfo.fused_apply(opt, tp, tg, ts, 0.05, 0.01, 2, nbytes=128,
                              mode="kernel", preprocess=True)
    assert tfo.sweep.launches == before        # CPU: the plain version
    assert len(tfo.plan_buckets(tp, nbytes=128)) > 1
    for n in params:
        np.testing.assert_allclose(tw[n].numpy(), np.asarray(jw[n]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tsn[n].numpy(), np.asarray(js[n]),
                                   rtol=1e-6, atol=1e-6)
        assert not np.array_equal(tw[n].numpy(), params[n])


def _package_optimizers():
    return [("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
            ("adam", {}), ("adamw", {}), ("adagrad", {}), ("rmsprop", {}),
            ("adadelta", {}), ("test", {})]


def _optimizers():
    out = [("sign_clip", TorchSignClip(**_KW))]
    for kind, kw in _package_optimizers():
        for clip in (None, 1e-3):
            opt = topt.create(kind, rescale_grad=0.25, clip_gradient=clip,
                              **kw)
            out.append(("%s%s clip=%s" % (kind, kw.get("momentum", ""),
                                          clip), opt))
    return out


def _vectors(opt, n, seed):
    """w, g and state vectors the formula keeps meaningful (variances
    positive, RMSProp's n >= g^2)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(n).astype(np.float32))
    g = torch.from_numpy((rng.randn(n) * 3).astype(np.float32))
    k = len(tfo._state_leaves(opt.create_state_arrays((1,))))
    states = [torch.from_numpy((np.abs(rng.randn(n)) * 0.1 + 0.01)
                               .astype(np.float32)) for _ in range(k)]
    if type(opt).__name__ == "RMSProp":
        states[0] = states[1] * states[1] + states[0]
    return w, g, states


@pytest.mark.parametrize("name,opt", _optimizers(),
                         ids=[n for n, _o in _optimizers()])
def test_ir_evaluates_bitwise_like_the_plain_update(name, opt):
    """The traced IR, op by op in PyTorch, equals _preprocess_grad then
    update_fn bitwise (weights and every state), at t = 1 and t = 3."""
    prog = cg.program(opt, preprocess=True)
    assert prog.n_state == len(tfo._state_leaves(
        opt.create_state_arrays((1,))))
    w, g, states = _vectors(opt, 1001, 7)
    for t in (1, 3):
        want_w, want_s = tfo.sweep_reference(opt, w, g, states, 0.02, 1e-3,
                                             t)
        got_w, got_s = cg.evaluate(prog, w, g, states, 0.02, 1e-3, t)
        assert torch.equal(got_w, want_w), name
        for a, b in zip(got_s, want_s):
            assert torch.equal(a, b), name


def test_trace_is_cached_per_class_and_hyper_parameters():
    a, b = TorchSignClip(**_KW), TorchSignClip(**_KW)
    assert cg.program(a) is cg.program(b)
    assert cg.program(a, preprocess=False) is not cg.program(a)
    c = TorchSignClip(bound=0.1, **_KW)
    assert cg.program(c) is not cg.program(a)
    # a hyper-parameter is a literal of the source, lr/wd/t arguments
    src = cg.cuda_source(cg.program(c))
    assert float(np.float32(0.1)).hex() + "f" in src
    assert cg.launch_arguments(cg.program(c), 0.05, 0.01, 2) == \
        cg.launch_arguments(cg.program(a), 0.05, 0.01, 2)


def test_norm_in_the_formula_raises_naming_the_op():
    class Normed(TorchSignClip):
        def update_fn(self, weight, grad, state, lr, wd, t):
            return weight - lr * grad / torch.norm(grad), state

    opt = Normed(**_KW)
    with pytest.raises(MXNetError, match="Normed.*torch.norm"):
        tfo.sweep_body(opt)
    tp = {"w": torch.ones(4)}
    with pytest.raises(MXNetError, match="torch.norm"):
        tfo.fused_apply(opt, tp, {"w": torch.ones(4)}, {"w": torch.zeros(4)},
                        0.1, 0.0, 1, mode="kernel")
    w, _ = tfo.fused_apply(opt, tp, {"w": torch.ones(4)},
                           {"w": torch.zeros(4)}, 0.1, 0.0, 1, mode="1")
    assert set(w) == {"w"}


@pytest.mark.parametrize("what,body", [
    ("a tensor of shape \\(4,\\) the update was not given",
     lambda self, w, g, s, lr, wd, t:
     (w - lr * (g + torch.randn(4)), s)),
    ("control flow", lambda self, w, g, s, lr, wd, t:
     (w - lr * g if bool(g.sum() > 0) else w, s)),
    ("torch.sum", lambda self, w, g, s, lr, wd, t: (w - lr * torch.sum(g), s)),
    ("float\\(\\)", lambda self, w, g, s, lr, wd, t:
     (w - float(lr) ** 0.5 * g, s)),
])
def test_ops_outside_the_ir_raise(what, body):
    klass = type("Outside", (TorchSignClip,), {"update_fn": body})
    with pytest.raises(MXNetError, match=what):
        cg.program(klass(**_KW))


def test_cuda_source_lowers_as_pytorch_cuda_computes():
    """The lowering's PyTorch-CUDA rules: a tensor over a Python scalar is
    a multiply by its float32 reciprocal, Python-scalar ** tensor a powf,
    tensor ** 2 a product, the skip flag read first, float32 hex
    literals, and both routes."""
    class Forms(TorchSignClip):
        def update_fn(self, weight, grad, state, lr, wd, t):
            tf = torch.as_tensor(t, dtype=torch.float32)
            m = state / 3.0 + grad ** 2 - 0.5 ** tf
            return weight - lr * torch.maximum(m, weight), m

    prog = cg.program(Forms(**_KW))
    src = cg.cuda_source(prog)
    assert "__fdiv_rn(1.f, (%sf))" % float(np.float32(3.0)).hex() in src
    assert "powf((%sf), u" % float(np.float32(0.5)).hex() in src
    assert "__fmul_rn(v" in src and "fmaxf" in src
    assert src.count("if (ok != nullptr && *ok == 0) return;") == 2
    assert cg.KERNEL_VEC4 in src and cg.KERNEL_SCALAR in src
    assert cg.NVRTC_OPTIONS == ("--fmad=false",)
    w, g, states = _vectors(Forms(**_KW), 64, 2)
    want = tfo.sweep_reference(Forms(**_KW), w, g, states, 0.1, 0.0, 3)
    got = cg.evaluate(prog, w, g, states, 0.1, 0.0, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0],
                                                        want[1][0])


# ----------------------------------------------------------------------
# the CUDA text, compiled by the host compiler
# ----------------------------------------------------------------------
_PRELUDE = r"""
#include <cmath>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
struct float4 { float x, y, z, w; };
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx, blockDim, gridDim;
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline float rsqrtf(float a) { return 1.f / std::sqrt(a); }
static inline float __int_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f; }
using std::isnan;
#include <math.h>
"""


def _host_build(prog, directory):
    """The generated source under the prelude, with a runner that takes
    every (block, thread) of a launch in turn; returns ``(run, n_params)``
    where ``run(vec, blocks, threads, ptrs, n, ok, params)``."""
    n = prog.n_state
    k = len(prog.params())
    src = cg.cuda_source(prog)
    args = ("float* w, const float* g" + "".join(", float* s%d" % i
                                                 for i in range(n))
            + ", long long n, const int* ok"
            + "".join(", float p%d" % i for i in range(k)))
    call = "(w, g" + "".join(", s%d" % i for i in range(n)) + ", n, ok" \
        + "".join(", p%d" % i for i in range(k)) + ")"
    runner = (
        'extern "C" void mxtt_run(int vec, unsigned blocks, unsigned threads,'
        ' %s) {\n  gridDim.x = blocks; blockDim.x = threads;\n'
        '  for (unsigned b = 0; b < blocks; ++b)\n'
        '    for (unsigned t = 0; t < threads; ++t) {\n'
        '      blockIdx.x = b; threadIdx.x = t;\n'
        '      if (vec) %s%s; else %s%s;\n    }\n}\n'
        % (args, cg.KERNEL_VEC4, call, cg.KERNEL_SCALAR, call))
    path = os.path.join(directory, "sweep_%d.cpp" % abs(hash(src)))
    with open(path, "w") as f:
        f.write(_PRELUDE + src + "\n" + runner)
    lib = path[:-4] + ".so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-shared", "-fPIC", "-o", lib,
                    path], check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    fn = dll.mxtt_run
    fn.argtypes = ([ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
                   + [ctypes.c_void_p] * (2 + n)
                   + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_float] * k)
    return fn


_HOST_OPS = {"neg", "abs", "sign", "sqrt", "add", "sub", "mul", "div",
             "clamp", "maximum", "minimum", "where", "lt", "le", "gt", "ge",
             "eq", "ne", "and", "or", "not", "tofloat", "fill", "reciprocal",
             "square", "hostf"}


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no host C++ compiler (g++) to build the text")
@pytest.mark.parametrize("name,opt", [
    (n, o) for n, o in _optimizers()
    if set(cg.program(o).ops()) <= _HOST_OPS],
    ids=[n for n, o in _optimizers()
         if set(cg.program(o).ops()) <= _HOST_OPS])
def test_cuda_text_on_the_host_bitwise_like_the_plain_update(
        name, opt, tmp_path, monkeypatch):
    """The generated CUDA C, built by g++ with every intrinsic its IEEE
    float operation: both routes (vec4 with a 3-element tail, scalar)
    bitwise the plain version; a skip flag of 0 writes nothing, of 1
    everything."""
    prog = cg.program(opt, preprocess=True)
    run = _host_build(prog, str(tmp_path))
    n = 1027
    w, g, states = _vectors(opt, n, 11)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: sqrt(x.to(torch.float64)).to(x.dtype))
    want_w, want_s = tfo.sweep_reference(opt, w, g, states, 0.02, 1e-3, 3)
    monkeypatch.undo()
    params = cg.launch_arguments(prog, 0.02, 1e-3, 3)
    for vec in (1, 0):
        for flag in (None, 1, 0):
            ww, ss = w.clone(), [s.clone() for s in states]
            ok = None if flag is None else torch.tensor([flag],
                                                        dtype=torch.int32)
            run(vec, 3, 64, ww.data_ptr(), g.data_ptr(),
                *[s.data_ptr() for s in ss], n,
                None if ok is None else ok.data_ptr(), *params)
            if flag == 0:
                assert torch.equal(ww, w) and all(
                    torch.equal(a, b) for a, b in zip(ss, states))
                continue
            assert torch.equal(ww, want_w), (name, vec, flag)
            for a, b in zip(ss, want_s):
                assert torch.equal(a, b), (name, vec, flag)
