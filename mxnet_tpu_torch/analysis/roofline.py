"""Static roofline / precision lint (MXL-R) at the H100's rates:
per-op FLOPs + device-memory bytes, arithmetic intensity vs the card's
ridge point, ``wgmma`` tile padding waste, and precision hazards — from
the graph alone, no card, no compile.

The port of ``mxnet_tpu/analysis/roofline.py``.  FLOP model (the JAX
package's, op for op): each op's forward FLOPs come from its
``cost_flops`` hook (conv/FC/dot: 2 FLOPs per MAC); training triples the
matrix-product work (forward + dgrad + wgrad are each a same-shape
product) and doubles everything else (forward + an elementwise-ish
backward).  ``mxu`` in the rows and hooks is the JAX package's name for
the dot/conv class; on the card it means the products.

Traffic model: each op moves its inputs + outputs through device memory
once per pass, priced at the compute dtype; product ops pay 3 passes in
training, others 2, plus 24 bytes per trained parameter scalar (float32
grad write + optimizer state + master weight round-trip).  The JAX
package calibrates the training traffic against XLA's compiled table for
a TPU (a fusion factor and staging bytes a parameter).  Eager PyTorch
fuses nothing and stages nothing, so the port reports the
**uncalibrated per-op sum**, also as ``op_hbm_bytes_per_step``, the JAX
report's name for it.

Peaks come from ``observability.counters.PEAKS``, the one table that MFU
and ``chip_smoke.py``'s kernel bounds read (``BENCH_PEAK_TFLOPS`` /
``BENCH_PEAK_HBM_GBPS`` override), keyed by the card's name
(``device_kind``; default ``MXTPU_LINT_DEVICE_KIND``, else the current
CUDA device's name, else the H100 SXM's row).  The compute dtype defaults
to float32, the port's trainer default, whose products run on the FMA
pipes (67 TFLOP/s, TF32 off) — MXL-R003 says so.  ``QuantizedDense`` rows
run at the int8 / fp8 tensor-core rate.  The ridge point
peak_flops/peak_bw classifies each op and the whole graph compute- vs
bandwidth-bound, and ``mfu_ceiling = min(1, intensity/ridge)``.

Per-op findings only fire above a significance floor
(``MXTPU_LINT_ROOFLINE_MIN_FLOPS``, default 5e10 training FLOPs) so toy
test graphs and the b2 model-zoo sweep stay clean; real batch sizes
surface the findings.
"""
from __future__ import annotations

import os as _os

import numpy as _np

from ..ops.registry import op_cost
from .core import register_rule
from .memory import _grad_req_of
from .propagation import edge_shapes, fmt_bytes
from .tiling import WGMMA_K_BYTES, itemsize as _itemsize

__all__ = ["roofline_report", "device_peaks", "resolve_compute_dtype",
           "mxu_padding_waste", "static_mfu_ceiling",
           "static_ceiling_summary"]

# training multipliers: an MXU op's backward is two more same-shape
# matmuls (dgrad + wgrad); everything else pays one elementwise-ish
# backward pass
_TRAIN_PASSES_MXU = 3
_TRAIN_PASSES_OTHER = 2
# f32 grad write + optimizer state read/write + master weight round-trip
_PARAM_UPDATE_BYTES = 24
#: the wgmma tile the padding waste is measured against: m64, n in
#: steps of 8, k of 32 bytes
_WGMMA_M = 64
_WGMMA_N = 8


def _env_float(name, default):
    raw = _os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return float(default)


def _min_flops():
    return _env_float("MXTPU_LINT_ROOFLINE_MIN_FLOPS", 5e10)


def resolve_compute_dtype(ctx):
    """The dtype products run at: the explicit ``compute_dtype`` hint,
    else float32 (the port's trainer default, on every target)."""
    cd = getattr(ctx, "compute_dtype", None)
    if not cd:
        return "float32"
    name = str(cd).replace("torch.", "")
    return name if name in ("bfloat16", "fp8", "int8", "float32",
                            "float16") else str(_np.dtype(cd).name)


def resolve_device_kind(ctx):
    """The card whose peaks price the graph: ``device_kind``, else
    ``MXTPU_LINT_DEVICE_KIND``, else the current CUDA device's name,
    else the H100 SXM's row of ``counters.PEAKS``."""
    dk = getattr(ctx, "device_kind", None) or \
        _os.environ.get("MXTPU_LINT_DEVICE_KIND")
    if dk:
        return dk
    from ..observability.counters import DEFAULT_CARD, _device_name
    return _device_name(None) or DEFAULT_CARD


def device_peaks(device_kind, dtype=None):
    """(peak_flops_per_s, peak_hbm_bytes_per_s) of the card named
    ``device_kind`` from ``counters.PEAKS`` at ``dtype`` (float32 when
    None; "int8"/"fp8" for QuantizedDense rows), or (None, None) when the
    card is not in the table.  ``BENCH_PEAK_TFLOPS`` and
    ``BENCH_PEAK_HBM_GBPS`` override, as for MFU."""
    from ..observability.counters import PEAKS, peak_tflops
    tf = peak_tflops(device_kind, dtype or "float32")
    gb = _env_float("BENCH_PEAK_HBM_GBPS", 0.0)
    row = PEAKS.get(device_kind)
    bw = gb * 1e9 if gb else (row["bytes_per_s"] if row else None)
    if not tf or not bw:
        return None, None
    return tf * 1e12, bw


def mxu_padding_waste(dims, compute_dtype="bfloat16"):
    """Fraction of tensor-core work spent on tile padding for ``(m, k,
    n)`` product dims against the ``wgmma`` tile: m pads to 64, n to 8,
    k to 32 bytes of the compute dtype (16 bfloat16, 32 fp8).  0.0 =
    perfectly tiled."""
    kg = max(1, WGMMA_K_BYTES // _itemsize(compute_dtype))
    done = padded = 0
    for m, k, n in dims:
        done += m * k * n
        padded += (-(-m // _WGMMA_M) * _WGMMA_M) * (-(-k // kg) * kg) \
            * (-(-n // _WGMMA_N) * _WGMMA_N)
    if not padded:
        return 0.0
    return 1.0 - float(done) / float(padded)


def _training(ctx):
    for node in ctx.variables():
        if node.name in ctx.data_names or node.name in ctx.label_names:
            continue
        if _grad_req_of(ctx, node.name) != "null":
            return True
    return False


def _op_costs(ctx):
    """Cached per-op cost rows + graph totals."""
    if "roofline_costs" in ctx.cache:
        return ctx.cache["roofline_costs"]
    shapes = edge_shapes(ctx)
    compute_dtype = resolve_compute_dtype(ctx)
    item = _itemsize(compute_dtype)
    training = _training(ctx)
    rows = []
    complete = True
    for node in ctx.op_nodes():
        in_shapes = [shapes.get((id(c), ci)) for c, ci in node.inputs]
        out_shapes = [shapes.get((id(node), i))
                      for i in range(node.op.num_outputs)]
        if any(s is None for s in in_shapes) or \
                any(s is None for s in out_shapes):
            complete = False
            continue
        try:
            cost = op_cost(node.op, in_shapes, out_shapes)
        except Exception:
            complete = False
            continue
        passes = (_TRAIN_PASSES_MXU if cost["mxu"]
                  else _TRAIN_PASSES_OTHER) if training else 1
        flops = cost["flops"] * passes
        byts = cost["bytes_elements"] * item * passes
        reduce_len = cost["reduce_len"] or 0
        if cost["mxu_dims"]:
            reduce_len = max([reduce_len] +
                             [k for _m, k, _n in cost["mxu_dims"]])
        rows.append({
            "node": node.name,
            "op": type(node.op).op_name,
            "flops": flops,
            "bytes": byts,
            "mxu": cost["mxu"],
            "mxu_dims": cost["mxu_dims"],
            "reduce_len": int(reduce_len),
            "compute_dtype": cost.get("compute_dtype"),
        })
    param_bytes = 0
    param_count = 0
    if training:
        for node in ctx.variables():
            if node.name in ctx.data_names or node.name in ctx.label_names:
                continue
            if _grad_req_of(ctx, node.name) == "null":
                continue
            shape = shapes.get((id(node), 0))
            if shape is None:
                continue
            param_count += int(_np.prod(shape, dtype=_np.int64))
    param_bytes = param_count * _PARAM_UPDATE_BYTES
    facts = {"rows": rows, "complete": complete, "training": training,
             "compute_dtype": compute_dtype, "param_bytes": param_bytes,
             "param_count": param_count}
    ctx.cache["roofline_costs"] = facts
    return facts


def roofline_report(ctx):
    """The whole-graph static roofline (cached on the context).

    Keys: ``flops_per_step``, ``hbm_bytes_per_step``, ``intensity``,
    ``device_kind``, ``peak_tflops``, ``peak_hbm_gbps``, ``ridge``,
    ``mfu_ceiling``, ``bound``, ``compute_dtype``, ``mode``,
    ``complete``, ``per_op`` (top rows by FLOPs).  Peak-dependent keys
    are None when the device kind is unknown."""
    if "roofline_report" in ctx.cache:
        return ctx.cache["roofline_report"]
    facts = _op_costs(ctx)
    flops = sum(r["flops"] for r in facts["rows"])
    # every op's traffic + the param-update round-trip (0 in inference)
    byts = sum(r["bytes"] for r in facts["rows"]) + facts["param_bytes"]
    device_kind = resolve_device_kind(ctx)
    base_dtype = facts["compute_dtype"]
    peak_f, peak_b = device_peaks(device_kind, dtype=base_dtype)
    # mixed-precision pricing: rows that declare their own compute
    # dtype (QuantizedDense -> int8/fp8) run at that dtype's peak, so
    # the graph's effective peak is flops-over-time across the mix
    # (time = Σ flops_d / peak_d) — a fully-int8 graph gets the full
    # int8 rate, a mixed graph something in between
    quant_flops = sum(r["flops"] for r in facts["rows"]
                      if r.get("compute_dtype"))
    if peak_f and quant_flops:
        t = 0.0
        for r in facts["rows"]:
            pf = peak_f
            if r.get("compute_dtype"):
                pd, _ = device_peaks(device_kind, dtype=r["compute_dtype"])
                pf = pd or peak_f
            t += r["flops"] / pf
        if t > 0:
            peak_f = flops / t
    report = {
        "flops_per_step": flops,
        "hbm_bytes_per_step": byts,
        "op_hbm_bytes_per_step": byts,
        "param_count": facts["param_count"],
        "intensity": (flops / byts) if byts else None,
        "device_kind": device_kind,
        "peak_tflops": (peak_f / 1e12) if peak_f else None,
        "peak_hbm_gbps": (peak_b / 1e9) if peak_b else None,
        "ridge": None, "mfu_ceiling": None, "bound": None,
        "compute_dtype": facts["compute_dtype"],
        "quantized_flops": quant_flops or 0,
        "mode": "training" if facts["training"] else "inference",
        "complete": facts["complete"],
        "per_op": sorted(facts["rows"], key=lambda r: -r["flops"])[:8],
    }
    if peak_f and peak_b and byts and flops:
        ridge = peak_f / peak_b
        report["ridge"] = ridge
        report["mfu_ceiling"] = min(1.0, report["intensity"] / ridge)
        report["bound"] = ("compute" if report["intensity"] >= ridge
                           else "bandwidth")
    ctx.cache["roofline_report"] = report
    return report


def static_mfu_ceiling(symbol, shapes, device_kind=None,
                       compute_dtype=None, grad_req=None, target="gpu"):
    """The roofline report of ``symbol`` at ``shapes`` with no analysis
    context plumbing."""
    from .core import AnalysisContext
    ctx = AnalysisContext(symbol, shapes=shapes, grad_req=grad_req,
                          target=target)
    ctx.compute_dtype = compute_dtype
    ctx.device_kind = device_kind
    return roofline_report(ctx)


def static_ceiling_summary(symbol, shapes, device_kind=None,
                           compute_dtype=None, grad_req=None,
                           target="gpu", emit=False):
    """The one static-ceiling summary path: flat ``static_*`` keys ready
    to merge into a benchmark payload.  Never raises — analyzer
    failures come back as ``static_mfu_ceiling_error``.  ``emit=True``
    also mirrors the roofline to the telemetry counter stream
    (``counters.emit_static_roofline``) so the measured-vs-ceiling gap
    is trackable."""
    try:
        rep = static_mfu_ceiling(symbol, shapes, device_kind=device_kind,
                                 compute_dtype=compute_dtype,
                                 grad_req=grad_req, target=target)
    except Exception as exc:  # noqa: BLE001 — callers print, not crash
        return {"static_mfu_ceiling_error":
                "%s: %s" % (type(exc).__name__, exc)}
    out = {
        "static_tflops_per_step": round(rep["flops_per_step"] / 1e12, 3),
        "static_hbm_gb_per_step": round(
            rep["hbm_bytes_per_step"] / 1e9, 3),
        "static_mfu_ceiling": (round(rep["mfu_ceiling"], 4)
                               if rep["mfu_ceiling"] is not None
                               else None),
        "static_bound": rep["bound"],
    }
    if emit:
        try:
            from ..observability import counters as _counters
            _counters.emit_static_roofline(
                symbol, shapes, device_kind=device_kind,
                compute_dtype=compute_dtype)
        except Exception:
            pass
    return out


# ----------------------------------------------------------------------
# the MXL-R rules
# ----------------------------------------------------------------------
def _active(ctx):
    return ctx.target == "gpu" and ctx.symbol is not None


@register_rule("MXL-R001", "info",
               doc="matrix product is bandwidth-bound at this batch size")
def _rule_r001(ctx):
    if not _active(ctx):
        return
    rep = roofline_report(ctx)
    if rep["ridge"] is None:
        return
    floor = _min_flops()
    for r in _op_costs(ctx)["rows"]:
        if not r["mxu"] or r["flops"] < floor or not r["bytes"]:
            continue
        intensity = r["flops"] / r["bytes"]
        if intensity < rep["ridge"]:
            ctx.report(r["node"],
                       "%s is bandwidth-bound: arithmetic intensity "
                       "%.0f fl/B < %s ridge %.0f — device memory feeds "
                       "the product slower than it computes at this shape "
                       "(larger batch or fused neighbors would help)"
                       % (r["op"], intensity, rep["device_kind"],
                          rep["ridge"]))


@register_rule("MXL-R002", "warning",
               doc="wgmma tile padding wastes a large fraction of the op")
def _rule_r002(ctx):
    if not _active(ctx):
        return
    threshold = _env_float("MXTPU_LINT_MXU_WASTE_PCT", 25.0) / 100.0
    floor = _min_flops()
    compute_dtype = resolve_compute_dtype(ctx)
    for r in _op_costs(ctx)["rows"]:
        if not r["mxu_dims"] or r["flops"] < floor:
            continue
        waste = mxu_padding_waste(r["mxu_dims"], compute_dtype)
        if waste >= threshold:
            worst = max(r["mxu_dims"],
                        key=lambda d: -mxu_padding_waste([d],
                                                         compute_dtype))
            ctx.report(r["node"],
                       "%s pads %.0f%% of its wgmma tiles away: product "
                       "dims %s vs the (m %d, k %d, n %d) granule — pick "
                       "tile-aligned channel/feature sizes"
                       % (r["op"], 100.0 * waste, worst, _WGMMA_M,
                          WGMMA_K_BYTES // _itemsize(compute_dtype),
                          _WGMMA_N))


@register_rule("MXL-R003", "warning",
               doc="float32 product on the FMA pipes (TF32 off)")
def _rule_r003(ctx):
    if not _active(ctx):
        return
    if _itemsize(resolve_compute_dtype(ctx)) < 4:
        return
    floor = _min_flops()
    mxu = [r for r in _op_costs(ctx)["rows"] if r["mxu"]]
    flops = sum(r["flops"] for r in mxu)
    if not mxu or flops < floor:
        return
    rep = roofline_report(ctx)
    dk = rep["device_kind"]
    f32, _bw = device_peaks(dk, "float32")
    bf16, _bw = device_peaks(dk, "bfloat16")
    ctx.report(None,
               "%d dot/conv op(s) (%.2f TF/step) run at float32: with TF32 "
               "off they run on the FMA pipes at %s TFLOP/s against the "
               "tensor cores' %s in bfloat16 — set compute_dtype=bfloat16 "
               "and keep float32 accumulation"
               % (len(mxu), flops / 1e12,
                  "%g" % (f32 / 1e12) if f32 else "?",
                  "%g" % (bf16 / 1e12) if bf16 else "?"))


@register_rule("MXL-R004", "warning",
               doc="long bf16 accumulation chain (reduction hazard)")
def _rule_r004(ctx):
    if not _active(ctx):
        return
    if _itemsize(resolve_compute_dtype(ctx)) >= 4:
        return
    hazard_n = _env_float("MXTPU_LINT_BF16_REDUCE_N", 4096)
    floor = _min_flops()
    for r in _op_costs(ctx)["rows"]:
        if r["flops"] < floor or r["reduce_len"] < hazard_n:
            continue
        ctx.report(r["node"],
                   "%s accumulates over %d elements at bfloat16 (~8 "
                   "mantissa bits): force f32 accumulation "
                   "(preferred_element_type) or split the reduction"
                   % (r["op"], r["reduce_len"]))


@register_rule("MXL-R005", "info",
               doc="whole-graph static roofline / MFU-ceiling summary")
def _rule_r005(ctx):
    if not _active(ctx):
        return
    rep = roofline_report(ctx)
    if rep["flops_per_step"] < _min_flops() or rep["ridge"] is None:
        return
    ctx.report(None,
               "static roofline (%s, %s, %s): %.2f TF + %s per step -> "
               "intensity %.0f fl/B vs ridge %.0f -> %s-bound, MFU "
               "ceiling %.2f%s"
               % (rep["device_kind"], rep["compute_dtype"], rep["mode"],
                  rep["flops_per_step"] / 1e12,
                  fmt_bytes(rep["hbm_bytes_per_step"]),
                  rep["intensity"], rep["ridge"], rep["bound"],
                  rep["mfu_ceiling"],
                  "" if rep["complete"]
                  else " (partial: some shapes unknown)"))
