"""Weight-only int8 quantization: per-channel params + the int8 matmul.

The port of ``mxnet_tpu/kernels/quantize.py``, int8 only (fp8 weights
are later work):

- :func:`quantize_array` / :func:`quantize_params` — per-output-channel
  symmetric quantization in numpy, bitwise the same as the JAX
  package's: ``w (N, K)`` -> ``(q (N, K) int8, scale (N,) float32)``
  with ``scale = absmax / 127``.
- :func:`quantizable_weights` / :func:`quantize_symbol` — the graph
  rewrite over the reference JSON layout: matched ``FullyConnected``
  nodes become ``QuantizedDense`` with a ``<weight>_scale`` variable
  spliced in (the same JSON text as the JAX package produces).
- :func:`quantized_matmul` — the wrapper of the hand-written CUDA
  kernel ``csrc/quantized_matmul.cu``; :func:`quantized_matmul_reference`
  is its plain PyTorch version (widen, matmul, scale), which CPU tensors
  take.  ``quantized_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["QDTYPES", "quantize_array", "dequantize_array",
           "quantize_params", "quantizable_weights", "quantize_symbol",
           "quantized_matmul", "quantized_matmul_reference"]

#: supported weight dtypes -> symmetric clip range max
QDTYPES = {"int8": 127.0}

#: default rule set: every FullyConnected weight (attention projections
#: live inside the fused attention ops and stay wide)
DEFAULT_RULES = (r".*",)

_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_qdtype(qdtype):
    if qdtype not in QDTYPES:
        raise MXNetError("quantize: the port supports %s, got %r"
                         % (sorted(QDTYPES), qdtype))


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return _np.asarray(v)


def quantize_array(w, qdtype="int8"):
    """Per-output-channel symmetric quantization of a 2-D weight.

    ``w (N, K)`` -> ``(q (N, K) int8, scale (N,) float32)`` with
    ``dequant = q.astype(f32) * scale[:, None]``.  All-zero rows get
    scale 1.0.
    """
    _check_qdtype(qdtype)
    w = _np.asarray(_to_numpy(w), dtype=_np.float32)
    if w.ndim != 2:
        raise MXNetError("quantize_array wants a 2-D weight, got shape %s"
                         % (w.shape,))
    qmax = QDTYPES[qdtype]
    absmax = _np.max(_np.abs(w), axis=1)
    scale = _np.where(absmax > 0, absmax / qmax, 1.0).astype(_np.float32)
    q = _np.clip(_np.rint(w / scale[:, None]), -qmax, qmax).astype(_np.int8)
    return q, scale


def dequantize_array(q, scale):
    """Inverse of :func:`quantize_array` (float32)."""
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
    _check_qdtype(qdtype)
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


def _is_int8(v):
    return str(getattr(v, "dtype", "")) in ("int8", "torch.int8")


def quantize_params(params, names, qdtype="int8"):
    """Quantize the listed weights of a params dict (name -> array).

    Returns a NEW dict where each listed weight is replaced by its int8
    numpy array and a ``<name>_scale`` float32 entry rides next to it;
    everything else passes through untouched.  Idempotent: a weight
    already int8 with its scale present is skipped (without a copy to
    the host)."""
    _check_qdtype(qdtype)
    out = dict(params)
    for name in names:
        if name not in out:
            continue
        if _is_int8(out[name]) and (name + "_scale") in out:
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
    ``w_q (N, K)`` int8, ``scale (N,)`` -> ``(M, N)`` in x's dtype."""
    y = torch.matmul(x.float(), w_q.float().t())
    return (y * scale.float()[None, :]).to(x.dtype)


def _check_inputs(x, w_q, scale):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[1] \
            or tuple(scale.shape) != (w_q.shape[0],):
        raise MXNetError("quantized_matmul: want x (M, K), w_q (N, K), "
                         "scale (N,), got %s, %s, %s"
                         % (tuple(x.shape), tuple(w_q.shape),
                            tuple(scale.shape)))
    if x.dtype not in _X_DTYPE_CODES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise MXNetError("quantized_matmul: want x float32/bfloat16, w_q "
                         "int8, scale float32, got %s, %s, %s"
                         % (x.dtype, w_q.dtype, scale.dtype))
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise MXNetError("quantized_matmul: %s is on %s, x on %s"
                             % (name, t.device, x.device))
        if not t.is_contiguous():
            raise MXNetError("quantized_matmul: %s must be contiguous"
                             % name)


def quantized_matmul(x, w_q, scale):
    """Weight-only int8 matmul ``x (M, K) @ w_q (N, K).T * scale``.
    CPU tensors take :func:`quantized_matmul_reference`; CUDA tensors
    launch ``csrc/quantized_matmul.cu`` (and raise on inputs it does not
    take).  Both accumulate in float32 and return x's dtype."""
    if not x.is_cuda:
        return quantized_matmul_reference(x, w_q, scale)
    from ._build import check, library
    _check_inputs(x, w_q, scale)
    (m, k), n = x.shape, w_q.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = library("quantized_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mxtt_quantized_matmul(
            _X_DTYPE_CODES[x.dtype], x.data_ptr(), w_q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), m, n, k, stream)
    check(lib, code, "quantized_matmul")
    quantized_matmul.launches += 1
    return out


#: launches of the CUDA kernel in this process (callers may reset it)
quantized_matmul.launches = 0
