"""The numerics the port's tensor-core kernels rely on, on the CPU.

``csrc/quantized_matmul.cu`` runs the int8 matmul at prefill on the
tensor cores in bfloat16: float32 x goes in as three bfloat16 pieces
(``kernels.quantize.split_bf16``) whose products with the int8 weight
add up in float32.  ``csrc/flash_attention.cu`` runs the bfloat16 flash
forward with ``p`` issued as a bfloat16 hi and lo part.  Neither kernel
runs here; these tests pin the arithmetic they do, emulated in plain
PyTorch on numpy-made seeded inputs, against the JAX package:
``mxnet_tpu.kernels.quantize.quantized_matmul_reference`` (1e-4, the
GPU gate of the int8 matmul) and the Pallas flash kernel in interpret
mode (one bfloat16 ulp of o, 1e-4 of lse: the GPU gate of the flash
forward).  They also cover how the wrapper picks the int8 body by M,
the generated ``wgmma`` wrappers and the build's hash of shared headers.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import quantize as jqz
from mxnet_tpu.parallel import ring_attention as jra
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import quantize as tqz

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mxnet_tpu_torch", "csrc")


# ----------------------------------------------------------------------
# int8 matmul: the three-piece bfloat16 split of float32 x
# ----------------------------------------------------------------------
def _values(kind, n=20000, seed=0):
    """float32 values whose pieces stay normal: |x| from 2^-100 up to
    2^120 (bfloat16 shares float32's exponent range; below about 2^-110
    the lo piece would be subnormal and lose bits)."""
    rng = np.random.RandomState(seed)
    sign = np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    if kind == "random":
        x = rng.randn(n)
    elif kind == "tiny":
        x = sign * 2.0 ** rng.uniform(-100, -60, n)
    elif kind == "large":
        x = sign * 2.0 ** rng.uniform(60, 120, n)
    elif kind == "negative":
        x = -np.abs(rng.randn(n)) * 37.0
    else:                      # one ulp around powers of two, and zeros
        p = 2.0 ** rng.randint(-30, 30, n)
        x = sign * p * (1 + rng.choice([-2.0 ** -24, 0, 2.0 ** -23], n))
        x[::7] = 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "tiny", "large", "negative",
                                  "edges"])
def test_bf16_split_reproduces_x_bitwise(kind):
    x = _values(kind)
    pieces = tqz.split_bf16(x)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3,) + x.shape
    hi, mid, lo = pieces.float()
    back = (hi + mid) + lo
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))


def _qmm_case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    q, scale = jqz.quantize_array((rng.randn(n, k) * 0.02).astype(np.float32))
    return x, q, scale


def _split_product(x, q, scale):
    """What the wgmma body computes for float32 x: each bfloat16 piece
    times the int8 weight (exact products), summed in float32, then the
    per-channel scale."""
    w = torch.from_numpy(q).float().t()
    hi, mid, lo = tqz.split_bf16(torch.from_numpy(x)).float()
    return ((hi @ w + mid @ w) + lo @ w) * torch.from_numpy(scale)


@pytest.mark.parametrize("m", [17, 33, 240, 960])
@pytest.mark.parametrize("k,n", [(512, 2048), (2048, 512), (512, 8192)])
def test_split_product_matches_jax_reference(m, k, n):
    """The three-piece product stays within 1e-4 of the JAX package's
    float32 reference at chip_smoke.py phase 3's prefill shapes; x as one
    bfloat16 piece would not (its error is over 1e-4)."""
    x, q, scale = _qmm_case(m, k, n, m + k + n)
    want = np.asarray(jqz.quantized_matmul_reference(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale)))
    got = _split_product(x, q, scale).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4
    hi_only = (tqz.split_bf16(torch.from_numpy(x))[0].float()
               @ torch.from_numpy(q).float().t()) * torch.from_numpy(scale)
    assert float(np.abs(hi_only.numpy() - want).max()) > 1e-4


# ----------------------------------------------------------------------
# int8 matmul: the body the wrapper picks by M
# ----------------------------------------------------------------------
_MODEL_KN = [(512, 2048), (2048, 512), (512, 8192)]
#: streaming multiprocessors of an H100 SXM (the wrapper reads the
#: card's count)
_H100_SMS = 132


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 33, 64, 65, 240, 480, 960])
@pytest.mark.parametrize("k,n", _MODEL_KN)
def test_plan_routes_by_m(m, k, n):
    """M <= 16 takes the GEMV, larger M the wgmma GEMM with a 64- or
    240-token tile; every split of K gets at least 128 (GEMV) or 256
    (wgmma) of it."""
    plan = tqz.plan_quantized_matmul(m, n, k, _H100_SMS)
    if m <= tqz.GEMV_MAX_M:
        assert plan["route"] == "gemv" and plan["tn"] == 0
        assert 1 <= plan["splits"] <= k // 128
    else:
        assert plan["route"] == "wgmma"
        assert plan["tn"] == (64 if m <= 64 else 240)
        assert 1 <= plan["splits"] <= max(1, k // 256)


@pytest.mark.parametrize("k,n", _MODEL_KN)
def test_plan_fills_the_card_at_decode(k, n):
    """At the decode batch the GEMV puts at least about 2 CTAs on each of
    the 132 SMs at every (K, N) of the model (32 weight rows a CTA)."""
    plan = tqz.plan_quantized_matmul(8, n, k, _H100_SMS)
    assert -(-n // 32) * plan["splits"] >= 2 * 128


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_plan_follows_the_sm_count(sms):
    """The decode split aims at about two CTAs on each SM of the card it
    is given: N=512 is 16 CTAs unsplit, and K=8192 leaves room for 64
    splits of 128."""
    plan = tqz.plan_quantized_matmul(8, 512, 8192, sms)
    assert 2 * sms <= 16 * plan["splits"] < 2 * sms + 16


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("k,n", _MODEL_KN + [(16384, 4096), (4096, 8192),
                                             (28672, 8192), (4096, 128256),
                                             (65536, 64)])
def test_plan_fits_the_gemv_x_in_shared_memory(m, k, n):
    """The GEMV CTA stages its split of K of x as float32, every 16
    floats padded to 20: MT * kchunk * 5 bytes (MT = M rounded up to a
    power of two, kchunk the split rounded up to 128 as the kernel
    rounds it) never passes the 48 KB the kernel takes, at any K."""
    plan = tqz.plan_quantized_matmul(m, n, k, _H100_SMS)
    assert plan["route"] == "gemv"
    kchunk = -(-(-(-k // plan["splits"])) // 128) * 128
    mt = 1 << (m - 1).bit_length()
    assert mt * kchunk * 5 <= tqz.GEMV_SMEM_BYTES
    assert 1 <= plan["splits"] <= -(-k // 128)


def test_cpu_wrapper_counts_no_route():
    x, q, scale = _qmm_case(20, 64, 48, 3)
    before = dict(tqz.quantized_matmul.launches_by_route)
    got = tqz.quantized_matmul(*map(torch.from_numpy, (x, q, scale)))
    assert torch.equal(got, tqz.quantized_matmul_reference(
        *map(torch.from_numpy, (x, q, scale))))
    assert tqz.quantized_matmul.launches_by_route == before


# ----------------------------------------------------------------------
# flash forward, bfloat16: p as a hi and a lo bfloat16 part
# ----------------------------------------------------------------------
def _flash_emulation(q, k, v, causal, scale, split_p=True, block_k=64):
    """The wgmma kernel's arithmetic in plain PyTorch: float32 scores of
    bfloat16 inputs, an online softmax over 64-key tiles, p issued as
    bf16(p) + bf16(p - bf16(p)) (or as bf16(p) alone), float32 sums, o
    rounded once to bfloat16."""
    sq, sk = q.shape[-2], k.shape[-2]
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kt, vt = k[..., k0:k0 + block_k, :], v[..., k0:k0 + block_k, :]
        s = (q @ kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = torch.where(cols > rows, torch.full_like(s, -1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        c = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * c + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vt
        if split_p:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
        o = o * c[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l[..., None]).to(torch.bfloat16), m + torch.log(l)


def _within_one_ulp(got, want):
    d = (got.float() - want.float()).abs()
    return bool((d <= want.float().abs() * 2.0 ** -7 + 1e-5).all())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_split_p_within_one_bf16_ulp_of_pallas(causal):
    """o of the emulation with p = p_hi + p_lo stays within one bfloat16
    ulp of the JAX Pallas kernel's (interpret mode, float32 arithmetic on
    the same bfloat16-valued inputs), lse within 1e-4; with p as one
    bfloat16 value it does not."""
    rng = np.random.RandomState(11 + causal)
    q, k, v = [torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
               .to(torch.bfloat16).float() for _ in range(3)]
    scale = 0.125
    jo, jl = jra._flash_forward_kernel_call(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal, scale, 128,
        128, True)
    want_o = torch.from_numpy(np.array(jo)).to(torch.bfloat16)
    o, lse = _flash_emulation(q, k, v, causal, scale)
    assert _within_one_ulp(o, want_o)
    assert not _within_one_ulp(
        _flash_emulation(q, k, v, causal, scale, split_p=False)[0], want_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


def test_flash_cpu_wrapper_counts_no_dtype():
    q = torch.randn(1, 1, 8, 32, dtype=torch.bfloat16)
    before = dict(tfa.flash_attention_forward.launches_by_dtype)
    tfa.flash_attention_forward(q, q, q, causal=True)
    assert tfa.flash_attention_forward.launches_by_dtype == before


# ----------------------------------------------------------------------
# the generated wgmma wrappers and the build
# ----------------------------------------------------------------------
def _gen_module():
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", os.path.join(_CSRC, "gen_wgmma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wgmma_header_is_what_the_generator_writes():
    with open(os.path.join(_CSRC, "wgmma.cuh")) as f:
        assert f.read() == _gen_module().render()


@pytest.mark.parametrize("form,n,tb", _gen_module().SHAPES)
def test_wgmma_wrapper_operands(form, n, tb):
    """Each wrapper lists n/2 accumulators, then A (a descriptor or four
    registers), B's descriptor and scale_d, numbered in that order."""
    text = _gen_module().wrapper(form, n, tb)
    nd = n // 2
    n_a = 1 if form == "ss" else 4
    assert text.count('"+f"(d[') == nd
    assert "m64n%dk16" % n in text
    assert "setp.ne.b32 p, %%%d, 0" % (nd + n_a + 1) in text
    assert text.rstrip().endswith("}")
    assert ("p, 1, 1, 0, %d;" % tb if form == "ss"
            else "p, 1, 1, %d;" % tb) in text


def test_build_hash_covers_every_header(tmp_path, monkeypatch):
    for name in os.listdir(_CSRC):
        with open(os.path.join(_CSRC, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    before = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n)[1] for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert all(_build.CUTLASS_INCLUDE not in _build._lib_path(n)[2]
               for n in _build.SOURCES)
    src = tmp_path / _build.SOURCES["fused_opt"]
    src.write_text("#include <cute/tensor.hpp>\n" + src.read_text())
    assert _build.CUTLASS_INCLUDE in _build._lib_path("fused_opt")[2]


def test_build_declares_both_int8_entry_points():
    names = ["mxtt_qmm_gemv", "mxtt_qmm_wgmma", "mxtt_error_string"]
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for n in names})
    _build._declare(lib, "quantized_matmul")
    assert len(lib.mxtt_qmm_gemv.argtypes) == 11
    assert len(lib.mxtt_qmm_wgmma.argtypes) == 13
    assert lib.mxtt_qmm_gemv.restype is lib.mxtt_qmm_wgmma.restype


def test_build_keeps_the_log_beside_a_cached_library(tmp_path, monkeypatch):
    """A library built once is loaded from the cache later with the
    ptxas lines of the build that made it (chip_smoke.py checks spills
    on every run); a library whose log is missing is built again."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n"
                    "echo \"ptxas info    : Used 40 registers\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_declare", lambda lib, name: lib)
    fresh = {n: dict(i) for n, i in _build.build_all().items()}
    assert all(i["seconds"] > 0 and "Used 40 registers" in i["log"]
               for i in fresh.values())
    _build._LIBS.clear()
    cached = _build.build_all()
    assert {n: i["log"] for n, i in cached.items()} \
        == {n: i["log"] for n, i in fresh.items()}
    assert all(i["seconds"] == 0.0 for i in cached.values())
    os.remove(_build._lib_path("fused_opt")[1][:-3] + ".log")
    _build._LIBS.clear()
    assert _build.build_all()["fused_opt"]["seconds"] > 0
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        _build._lib_path(n)[1].rsplit("/", 1)[1][:-3] + ext
        for n in _build.SOURCES for ext in (".so", ".log"))
