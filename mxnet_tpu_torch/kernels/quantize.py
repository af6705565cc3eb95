"""Weight-only quantization: per-channel params + the weight-only matmul.

The port of ``mxnet_tpu/kernels/quantize.py``, int8 and fp8 (e4m3):

- :func:`quantize_array` / :func:`quantize_params` — per-output-channel
  symmetric quantization, bitwise the same as the JAX package's:
  ``w (N, K)`` -> ``(q (N, K), scale (N,) float32)`` with ``scale =
  absmax / 127`` (int8: q is numpy int8) or ``absmax / 448`` (fp8: q
  is a ``torch.float8_e4m3fn`` tensor, the cast of ``w / scale`` that
  the JAX package makes with ``ml_dtypes``, saturating at 448; numpy
  has no fp8 type, so where numpy must hold q it holds its bytes,
  ``q.view(torch.uint8)``).
- :func:`quantizable_weights` / :func:`quantize_symbol` — the graph
  rewrite over the reference JSON layout: matched ``FullyConnected``
  nodes become ``QuantizedDense`` with a ``<weight>_scale`` variable
  spliced in (the same JSON text as the JAX package produces).
- :func:`quantized_matmul` — the wrapper of the hand-written CUDA
  kernels ``csrc/quantized_matmul.cu``; :func:`quantized_matmul_reference`
  is its plain PyTorch version (widen, matmul, scale), which CPU tensors
  take.  On the GPU it picks a body by M (:func:`plan_quantized_matmul`):
  a split-K GEMV on the CUDA cores at decode (M <= 16), a ``wgmma``
  tensor-core GEMM at prefill (float32 x as three bfloat16 pieces); both
  take int8 and e4m3 weights.  ``quantized_matmul.launches`` counts
  kernel calls, ``quantized_matmul.launches_by_route`` them by body and
  ``quantized_matmul.launches_by_qdtype`` by weight type.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

from ..analysis.tiling import register_kernel_spec
from ..base import MXNetError
from ..observability.metrics import register_kernel_counters

__all__ = ["QDTYPES", "STORAGE_DTYPES", "storage_dtype", "quantize_array",
           "dequantize_array",
           "quantize_params", "quantizable_weights", "quantize_symbol",
           "quantized_matmul", "quantized_matmul_reference",
           "plan_quantized_matmul", "pad_depth", "split_bf16"]

#: supported weight dtypes -> symmetric clip range max
QDTYPES = {"int8": 127.0, "fp8_e4m3": 448.0}
#: the torch dtype that stores each
STORAGE_DTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}

#: default rule set: every FullyConnected weight (attention projections
#: live inside the fused attention ops and stay wide)
DEFAULT_RULES = (r".*",)

_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_W_DTYPE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_QDTYPE_OF = {t: name for name, t in STORAGE_DTYPES.items()}


def storage_dtype(qdtype):
    """The torch dtype storing quantized weights of ``qdtype``."""
    if qdtype not in STORAGE_DTYPES:
        raise MXNetError("quantize: unknown qdtype %r (have: %s)"
                         % (qdtype, sorted(QDTYPES)))
    return STORAGE_DTYPES[qdtype]


def _to_numpy(v):
    """Host numpy data of ``v``; an fp8 tensor gives its bytes (uint8),
    since numpy has no fp8 type."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.float8_e4m3fn:
            v = v.view(torch.uint8)
        return v.numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return _np.asarray(v)


def quantize_array(w, qdtype="int8"):
    """Per-output-channel symmetric quantization of a 2-D weight.

    ``w (N, K)`` -> ``(q (N, K), scale (N,) float32)`` with ``dequant =
    float(q) * scale[:, None]``; q is numpy int8 for ``"int8"`` and a CPU
    ``torch.float8_e4m3fn`` tensor for ``"fp8_e4m3"`` (saturating at
    448, as ``ml_dtypes``' cast).  All-zero rows get scale 1.0.
    """
    st = storage_dtype(qdtype)
    if isinstance(w, torch.Tensor):
        w = w.float()                 # a bfloat16 or fp8 weight's values
    w = _np.asarray(_to_numpy(w), dtype=_np.float32)
    if w.ndim != 2:
        raise MXNetError("quantize_array wants a 2-D weight, got shape %s"
                         % (w.shape,))
    qmax = QDTYPES[qdtype]
    absmax = _np.max(_np.abs(w), axis=1)
    scale = _np.where(absmax > 0, absmax / qmax, 1.0).astype(_np.float32)
    scaled = w / scale[:, None]
    if qdtype == "int8":
        q = _np.clip(_np.rint(scaled), -qmax, qmax).astype(_np.int8)
    else:
        q = torch.from_numpy(_np.ascontiguousarray(scaled)).to(st)
    return q, scale


def dequantize_array(q, scale):
    """Inverse of :func:`quantize_array` (float32 numpy)."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().float().numpy()
    return _np.asarray(q, dtype=_np.float32) * \
        _np.asarray(scale, dtype=_np.float32)[:, None]


def _compile_rules(rules):
    return [re.compile(r) for r in (rules or DEFAULT_RULES)]


def quantizable_weights(symbol_json, rules=None):
    """Weight-variable names of ``FullyConnected`` nodes in a symbol
    JSON whose names match ``rules`` (regex fullmatch) — the exact set
    :func:`quantize_symbol` will rewrite."""
    data = json.loads(symbol_json)
    pats = _compile_rules(rules)
    names = []
    for node in data["nodes"]:
        if node["op"] != "FullyConnected" or len(node["inputs"]) < 2:
            continue
        wnode = data["nodes"][node["inputs"][1][0]]
        if wnode["op"] not in ("null", "None"):
            continue                      # computed weight: leave wide
        if any(p.fullmatch(wnode["name"]) for p in pats):
            names.append(wnode["name"])
    return sorted(set(names))


def quantize_symbol(symbol_json, rules=None, qdtype="int8"):
    """Rewrite ``FullyConnected`` -> ``QuantizedDense`` in a symbol JSON.

    Matched FC nodes change op to ``QuantizedDense`` (same attrs plus
    ``qdtype``) and gain a ``<weight>_scale`` variable input spliced
    between weight and bias; node indices are remapped.  Returns
    ``(new_json_str, quantized_weight_names)``.
    """
    storage_dtype(qdtype)
    data = json.loads(symbol_json)
    names = set(quantizable_weights(symbol_json, rules))
    if not names:
        return symbol_json, ()

    new_nodes = []
    remap = {}                            # old index -> new index
    scale_index = {}                      # weight name -> new scale index
    for i, node in enumerate(data["nodes"]):
        node = dict(node)
        node["inputs"] = [[remap[j], cj] + rest
                          for j, cj, *rest in node["inputs"]]
        if node["op"] == "FullyConnected":
            widx = node["inputs"][1][0]
            wname = new_nodes[widx]["name"] if widx < len(new_nodes) else None
            if wname in names:
                if wname not in scale_index:
                    scale_index[wname] = len(new_nodes)
                    new_nodes.append({"op": "null",
                                      "name": wname + "_scale",
                                      "attr": {}, "inputs": []})
                node["op"] = "QuantizedDense"
                node["attr"] = dict(node.get("attr") or {}, qdtype=qdtype)
                node["inputs"] = (node["inputs"][:2]
                                  + [[scale_index[wname], 0]]
                                  + node["inputs"][2:])
        remap[i] = len(new_nodes)
        new_nodes.append(node)

    data["nodes"] = new_nodes
    data["arg_nodes"] = [i for i, n in enumerate(new_nodes)
                         if n["op"] in ("null", "None")]
    data["heads"] = [[remap[i], ci] + rest
                     for i, ci, *rest in data["heads"]]
    return json.dumps(data, indent=2), tuple(sorted(names))


def _dtype_of(v):
    """A value's dtype as a torch dtype or numpy's name, read without a
    copy to the host."""
    if hasattr(v, "data") and isinstance(v.data, torch.Tensor):
        v = v.data                        # an NDArray
    dt = getattr(v, "dtype", None)
    return dt if isinstance(dt, torch.dtype) else str(dt)


def quantize_params(params, names, qdtype="int8"):
    """Quantize the listed weights of a params dict (name -> array).

    Returns a NEW dict where each listed weight is replaced by its
    quantized weight (:func:`quantize_array`'s q) and a ``<name>_scale``
    float32 entry rides next to it; everything else passes through
    untouched.  Idempotent: a weight already in the storage dtype with
    its scale present is skipped (without a copy to the host)."""
    st = storage_dtype(qdtype)
    out = dict(params)
    for name in names:
        if name not in out:
            continue
        if _dtype_of(out[name]) in (st, str(st).replace("torch.", "")) \
                and (name + "_scale") in out:
            continue
        q, scale = quantize_array(out[name], qdtype=qdtype)
        out[name] = q
        out[name + "_scale"] = scale
    return out


# ----------------------------------------------------------------------
# the int8 matmul
# ----------------------------------------------------------------------
def quantized_matmul_reference(x, w_q, scale):
    """Plain version: widen, contract in float32, scale.  ``x (M, K)``,
    ``w_q (N, K)`` int8 or float8_e4m3fn, ``scale (N,)`` -> ``(M, N)`` in
    x's dtype."""
    y = torch.matmul(x.float(), w_q.float().t())
    return (y * scale.float()[None, :]).to(x.dtype)


def split_bf16(x):
    """The plain version of the wgmma body's prologue (``qmm_split``):
    float32 ``x`` as three bfloat16 pieces stacked on a new first axis,
    ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``,
    each rounded to nearest even.  ``hi + mid + lo == x`` exactly for
    every finite ``x`` whose pieces stay normal: three 8-bit significands
    hold its 24 bits.  Each piece times an int8 or e4m3 weight is exact
    in float32, so the three products carry float32 accuracy."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    return torch.stack([hi, mid, (r1 - mid.float()).to(torch.bfloat16)])


def _check_inputs(x, w_q, scale):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[1] \
            or tuple(scale.shape) != (w_q.shape[0],):
        raise MXNetError("quantized_matmul: want x (M, K), w_q (N, K), "
                         "scale (N,), got %s, %s, %s"
                         % (tuple(x.shape), tuple(w_q.shape),
                            tuple(scale.shape)))
    if x.dtype not in _X_DTYPE_CODES or w_q.dtype not in _W_DTYPE_CODES \
            or scale.dtype != torch.float32:
        raise MXNetError("quantized_matmul: want x float32/bfloat16, w_q "
                         "int8/float8_e4m3fn, scale float32, got %s, %s, %s"
                         % (x.dtype, w_q.dtype, scale.dtype))
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise MXNetError("quantized_matmul: %s is on %s, x on %s"
                             % (name, t.device, x.device))
        if not t.is_contiguous():
            raise MXNetError("quantized_matmul: %s must be contiguous"
                             % name)


#: the largest M the decode body (GEMV) takes; larger M goes to wgmma
GEMV_MAX_M = 16
#: the GEMV stages its CTA's range of K of x in shared memory as float32,
#: every 16 floats padded to 20: ``MT * kchunk * 5`` bytes, MT being M
#: rounded up to a power of two.  K is split until that fits in 48 KB,
#: the most a kernel takes without opting in (four such CTAs fit an SM)
GEMV_SMEM_BYTES = 48 * 1024


def plan_quantized_matmul(m, n, k, sms):
    """The body and the split of K for an ``(m, k) @ (n, k).T`` call on a
    GPU of ``sms`` streaming multiprocessors: ``{"route": "gemv" |
    "wgmma", "splits": s, "tn": t}``.

    ``k`` is the padded depth (a multiple of 16).  The GEMV's CTA covers
    32 weight rows and steps through K 128 bytes at a time; when those
    CTAs fill less than half of the SMs, K is split (at least 128 of it a
    split) for about two CTAs an SM, and in any case until the CTA's x
    fits :data:`GEMV_SMEM_BYTES`.  The wgmma CTA covers 64 output
    channels by ``tn`` tokens (64 up to M = 64, else 240, the prompt
    buckets' divisor) and 64 of K a stage; it holds an SM alone, so K is
    split (at least 256 of it a split) only when the tiles fill less than
    a third of the card, for about one CTA an SM.  Split partial sums
    cost a second pass over ``splits * M * N`` floats, which a fuller
    grid does not repay.
    """
    if m <= GEMV_MAX_M:
        base, steps, route, tn = -(-n // 32), -(-k // 128), "gemv", 0
        split = 2 * base < sms
        target = -(-2 * sms // base)
        mt = 1 << (m - 1).bit_length()
        kmax = GEMV_SMEM_BYTES // (5 * mt) // 128 * 128
        least = -(-k // kmax)
    else:
        tn = 64 if m <= 64 else 240
        base = -(-n // 64) * -(-m // tn)
        steps, route = max(1, -(-k // 64) // 4), "wgmma"
        split = 3 * base < sms
        target = -(-sms // base)
        least = 1
    splits = max(1, min(steps, target)) if split else 1
    return {"route": route, "splits": max(splits, least), "tn": tn}


def pad_depth(x, w_q):
    """``x (M, K)`` and ``w_q (N, K)`` with K zero-padded to a multiple
    of 16 (copies; as they are when it is one).  w_q is padded through
    its bytes, so an fp8 weight needs no fp8 support of ``F.pad``: 0x00
    is +0 in int8 and in e4m3."""
    pad = -x.shape[1] % 16
    if not pad:
        return x, w_q
    return (torch.nn.functional.pad(x, (0, pad)),
            torch.nn.functional.pad(w_q.view(torch.uint8),
                                    (0, pad)).view(w_q.dtype))


def quantized_matmul(x, w_q, scale):
    """Weight-only matmul ``x (M, K) @ w_q (N, K).T * scale``, w_q int8 or
    float8_e4m3fn.  CPU tensors take :func:`quantized_matmul_reference`;
    CUDA tensors launch the body :func:`plan_quantized_matmul` picks from
    ``csrc/quantized_matmul.cu`` (and raise on inputs it does not take).
    Both accumulate in float32 and return x's dtype.  A K that is no
    multiple of 16 is zero-padded (a copy of x and of w_q's bytes, 0x00
    being +0 in either type) for the kernels' 16-byte loads."""
    if not x.is_cuda:
        return quantized_matmul_reference(x, w_q, scale)
    from ._build import check, library
    _check_inputs(x, w_q, scale)
    x, w_q = pad_depth(x, w_q)
    (m, k), n = x.shape, w_q.shape[0]
    plan = plan_quantized_matmul(
        m, n, k, torch.cuda.get_device_properties(x.device)
        .multi_processor_count)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # workspaces, held until the launch (no pointer: the body does not
    # use one): split-K partial sums, the wgmma body's bfloat16 pieces of
    # float32 x
    partial = torch.empty((plan["splits"], m, n) if plan["splits"] > 1
                          else (0,), dtype=torch.float32, device=x.device)
    pieces = torch.empty((3, m, k) if plan["route"] == "wgmma"
                         and x.dtype == torch.float32 else (0,),
                         dtype=torch.bfloat16, device=x.device)
    lib = library("quantized_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan["route"] == "gemv":
            code = lib.mxtt_qmm_gemv(
                _X_DTYPE_CODES[x.dtype], _W_DTYPE_CODES[w_q.dtype],
                x.data_ptr(), w_q.data_ptr(),
                scale.data_ptr(), out.data_ptr(), partial.data_ptr(), m, n,
                k, plan["splits"], stream)
        else:
            code = lib.mxtt_qmm_wgmma(
                _X_DTYPE_CODES[x.dtype], _W_DTYPE_CODES[w_q.dtype],
                x.data_ptr(), w_q.data_ptr(),
                scale.data_ptr(), out.data_ptr(), pieces.data_ptr(),
                partial.data_ptr(), m, n, k, plan["tn"], plan["splits"],
                stream)
    check(lib, code, "quantized_matmul (%s)" % plan["route"])
    quantized_matmul.launches += 1
    quantized_matmul.launches_by_route[plan["route"]] += 1
    quantized_matmul.launches_by_qdtype[_QDTYPE_OF[w_q.dtype]] += 1
    by_rows = quantized_matmul.launches_by_rows
    by_rows[n] = by_rows.get(n, 0) + 1
    return out


#: calls that launched a CUDA body in this process, in all, by body, by
#: weight type and by the weight's rows N (a tp member's slice; callers
#: may reset them)
quantized_matmul.launches = 0
quantized_matmul.launches_by_rows = {}
quantized_matmul.launches_by_route = {"gemv": 0, "wgmma": 0}
quantized_matmul.launches_by_qdtype = {"int8": 0, "fp8_e4m3": 0}
register_kernel_counters("quantized_matmul", lambda: {
    "launches": quantized_matmul.launches,
    "by_route": dict(quantized_matmul.launches_by_route),
    "by_qdtype": dict(quantized_matmul.launches_by_qdtype)})


# ----------------------------------------------------------------------
# the launches, declared for the static analyzer (MXL-K)
# ----------------------------------------------------------------------
#: the bodies' launch constants (``csrc/quantized_matmul.cu``): the
#: GEMV's 128 threads over 32 weight rows and 128 bytes of K a step, x
#: padded from 16 to 20 floats; the wgmma CTA's 64 output channels
#: (wgmma m), 64 of K a stage in 2 stages, one consumer warpgroup and a
#: producer warp; the reduction and split kernels' 256 threads
GEMV_THREADS, GEMV_ROWS, GEMV_STEP = 128, 32, 128
TC_BN, TC_BK, TC_STAGES, TC_THREADS = 64, 64, 2, 160
_X_MANGLED = {"float32": "f", "bfloat16": "13__nv_bfloat16"}
_W_MANGLED = {"int8": "WInt8", "fp8_e4m3": "WE4M3"}
#: the shapes the LM's lm_head runs at (``chip_smoke.py`` phases 3 and
#: 4): decode (M=8, the GEMV) and the largest prompt bucket (M=960, wgmma)
MAIN_SHAPES = ((8, 512, 8192), (960, 512, 8192))
#: one tp member's rows of the same products at tp=2 (phase 22)
MEMBER_SHAPES = tuple((m, k, n // 2) for m, k, n in MAIN_SHAPES)


def launch_specs(m, n, k, x_dtype="float32", qdtype="int8", sms=None,
                 compiled=False):
    """The kernels one ``quantized_matmul`` launches for ``(m, k) @ (n,
    k).T`` (``k`` padded to a multiple of 16), from
    :func:`plan_quantized_matmul`'s route and split: the GEMV (M <= 16)
    or the wgmma body (float32 x split first into three bfloat16 pieces
    by ``qmm_split``), and ``qmm_reduce`` when K is split.  ``compiled``:
    the shared memory as the built library reports it (``mxtt_qmm_smem``,
    needs ``nvcc``) in place of this module's copy of the ``.cu``
    constants, which ``chip_smoke.py`` holds to it."""
    if sms is None:
        from ..observability.counters import launch_limits
        sms = launch_limits()["sms"]
    plan = plan_quantized_matmul(m, n, k, sms)
    splits, x, w = plan["splits"], _X_MANGLED[x_dtype], _W_MANGLED[qdtype]
    origin = "mxnet_tpu_torch/csrc/quantized_matmul.cu"
    specs = []

    def smem(default, route, tn=0, pieces=0):
        if not compiled:
            return default
        from ._build import launch_smem
        return launch_smem("quantized_matmul", route, m, k, splits, tn,
                           pieces)

    if plan["route"] == "gemv":
        mt = 1 << (m - 1).bit_length()
        per_split = -(-k // splits)
        kchunk = -(-per_split // GEMV_STEP) * GEMV_STEP
        grid = (-(-n // GEMV_ROWS), -(-k // kchunk), 1)
        specs.append({
            "name": "qmm_gemv<%s, %s, %d>" % (x_dtype, qdtype, mt),
            "origin": origin, "entry": "qmm_gemvI%s.*%s.*Li%dE" % (x, w, mt),
            "grid": grid, "block": (GEMV_THREADS, 1, 1),
            "dynamic_smem": smem(mt * (kchunk // 16 * 20) * 4, 0),
            "static_smem": 0,
            "optin": False, "min_blocks": None,
            "tiles": [{"name": "weight rows", "extent": n,
                       "tile": GEMV_ROWS},
                      {"name": "K of a split", "extent": k, "tile": kchunk}],
            "vectors": [{"name": "weight row", "extent": k,
                         "dtype": "int8"},
                        {"name": "x row", "extent": k, "dtype": x_dtype}]})
        parts = grid[1]
    else:
        tn, pieces = plan["tn"], 3 if x_dtype == "float32" else 1
        if pieces == 3:
            mk = m * k
            specs.append({
                "name": "qmm_split", "origin": origin, "entry": "qmm_split",
                "grid": (min(-(-mk // 256), 4096), 1, 1),
                "block": (256, 1, 1), "dynamic_smem": 0, "static_smem": 0,
                "min_blocks": None})
        k_tiles = -(-k // TC_BK)
        kt_per = -(-k_tiles // splits)
        stage = TC_BN * TC_BK + pieces * tn * TC_BK * 2
        grid = (-(-n // TC_BN), -(-m // tn), -(-k_tiles // kt_per))
        specs.append({
            "name": "qmm_wgmma<%s, %s, %d, %d>" % (x_dtype, qdtype, tn,
                                                  pieces),
            "origin": origin,
            "entry": "qmm_wgmmaI%s.*%s.*Li%dELi%dE" % (x, w, tn, pieces),
            "grid": grid, "block": (TC_THREADS, 1, 1),
            "dynamic_smem": smem(1024 + TC_STAGES * stage
                                 + 8 * 2 * TC_STAGES, 1, tn, pieces),
            "static_smem": 0, "min_blocks": 1,
            "tiles": [{"name": "output channels", "extent": n,
                       "tile": TC_BN},
                      {"name": "tokens", "extent": m, "tile": tn},
                      {"name": "K", "extent": k, "tile": TC_BK}],
            "tma": [{"name": "weight", "box": (TC_BK, TC_BN),
                     "dtype": "int8"},
                    {"name": "x piece", "box": (TC_BK, tn, 1),
                     "dtype": "bfloat16"}],
            "wgmma": [{"name": "y^T tile", "m": 64, "n": tn, "k": 16,
                       "dtype": "bfloat16"}]})
        parts = grid[2]
    if parts > 1:
        specs.append({
            "name": "qmm_reduce<%s>" % x_dtype, "origin": origin,
            "entry": "qmm_reduceI%sE" % x,
            "grid": (min(-(-(m * n) // 256), 4096), 1, 1),
            "block": (256, 1, 1), "dynamic_smem": 0, "static_smem": 0,
            "min_blocks": None})
    return specs


register_kernel_spec("kernels.quantize", lambda: [
    spec for m, k, n in MAIN_SHAPES + MEMBER_SHAPES
    for q in ("int8", "fp8_e4m3")
    for spec in launch_specs(m, n, k, "float32", q)])
