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
    return out


#: calls that launched a CUDA body in this process, in all, by body and
#: by weight type (callers may reset them)
quantized_matmul.launches = 0
quantized_matmul.launches_by_route = {"gemv": 0, "wgmma": 0}
quantized_matmul.launches_by_qdtype = {"int8": 0, "fp8_e4m3": 0}
register_kernel_counters("quantized_matmul", lambda: {
    "launches": quantized_matmul.launches,
    "by_route": dict(quantized_matmul.launches_by_route),
    "by_qdtype": dict(quantized_matmul.launches_by_qdtype)})
