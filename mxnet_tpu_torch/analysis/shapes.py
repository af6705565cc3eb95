"""Shape/dtype re-verification passes (rule family MXL-S / MXL-T).

The port of ``mxnet_tpu/analysis/shapes.py``, rule for rule.  The
reference refused to bind a graph whose shapes didn't propagate
(static_graph.cc:59 InferNodeShapes); an eager walk reports the same
mistakes as opaque broadcasting errors deep inside the first forward.
These passes re-run the Symbol's own propagation *before* any walk and
turn failures into positioned issues:

- MXL-S001  shapes still unknown after propagation (can't pre-allocate,
            simple_bind will fail) — info when no hints were given,
            warning once the caller supplied shapes;
- MXL-S002  contradictory shapes (two consumers demand different shapes
            of one edge) — error;
- MXL-T001  implicit float-width promotion (e.g. f32 weights feeding a
            bf16 segment: PyTorch promotes the product to float32, off
            the tensor cores) — warning;
- MXL-T002  type propagation failure — error.
"""
from __future__ import annotations

import re as _re

import torch

from ..base import MXNetError
from ..ndarray import _torch_dtype
from .core import register_rule

_MISMATCH_NODE = _re.compile(r"for input of (\S+):")


def as_dtype(t):
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, ``"float8_e4m3fn"``: names numpy lacks)."""
    if isinstance(t, str):
        named = getattr(torch, t.replace("torch.", ""), None)
        if isinstance(named, torch.dtype):
            return named
    return _torch_dtype(t)


def dtype_name(t):
    """``float32``, ``bfloat16``, ...: the JAX package's names."""
    return str(t).replace("torch.", "")


@register_rule("MXL-S001", "warning",
               "shape unknown after propagation")
def shape_unknown(ctx):
    """Arguments/outputs whose shapes stay unknown after propagation."""
    try:
        arg_shapes, out_shapes, _aux = \
            ctx.symbol.infer_shape_partial(**ctx.shapes)
    except MXNetError:
        return      # contradiction: MXL-S002's finding, not ours
    sev = "warning" if ctx.shapes else "info"
    for name, shape in zip(ctx.symbol.list_arguments(), arg_shapes):
        if shape is None:
            ctx.report(name, "shape of argument %r unknown after "
                       "propagation; pass it to infer_shape/bind or set a "
                       "__shape__ attr" % name, severity=sev)
    for name, shape in zip(ctx.symbol.list_outputs(), out_shapes):
        if shape is None:
            ctx.report(name, "shape of output %r cannot be inferred"
                       % name, severity=sev)


@register_rule("MXL-S002", "error",
               "contradictory shapes on one graph edge")
def shape_contradiction(ctx):
    """Two consumers demanding different shapes of the same value."""
    try:
        ctx.symbol.infer_shape_partial(**ctx.shapes)
    except MXNetError as exc:
        msg = str(exc)
        m = _MISMATCH_NODE.search(msg)
        ctx.report(m.group(1) if m else None, msg)


def _propagate_types(ctx):
    """Per-edge dtype map {(id(node), out_idx): dtype} via each op's
    infer_type — the same walk as Symbol.infer_type but non-throwing
    (failures become MXL-T002 issues) and keeping every edge, which the
    promotion check needs."""
    base = torch.float32
    known = {n: as_dtype(t) for n, t in ctx.type_dict.items()}
    types = {}
    failed = []
    for node in ctx.topo:
        if node.is_variable:
            types[(id(node), 0)] = known.get(node.name, base)
    for node in ctx.topo:
        if node.is_variable:
            continue
        in_types = [types.get((id(c), ci)) for c, ci in node.inputs]
        try:
            full_in, outs, _aux = node.op.infer_type(in_types)
        except Exception as exc:  # noqa: BLE001 — any op failure is a finding
            failed.append((node, exc))
            continue
        for (c, ci), t in zip(node.inputs, full_in):
            if types.get((id(c), ci)) is None and t is not None:
                types[(id(c), ci)] = as_dtype(t)
        for i, t in enumerate(outs):
            types[(id(node), i)] = as_dtype(t) if t is not None else base
    return types, failed


@register_rule("MXL-T001", "warning",
               "implicit float-width promotion at an op input")
def dtype_promotion(ctx):
    """Mixed float widths feeding one op: PyTorch promotes silently."""
    types, _failed = _propagate_types(ctx)
    for node in ctx.op_nodes():
        floats = {}
        for (c, ci), aname in zip(node.inputs,
                                  node.op.list_arguments()):
            t = types.get((id(c), ci))
            if t is not None and t.is_floating_point:
                floats.setdefault(t, []).append("%s(%s)" % (aname, c.name))
        if len(floats) > 1:
            wide = max(floats, key=lambda t: t.itemsize)
            narrow = min(floats, key=lambda t: t.itemsize)
            if wide.itemsize == narrow.itemsize:
                continue    # e.g. f32 vs bf16-sized f16 pairs only
            ctx.report(node, "inputs mix float widths %s: %s — the "
                       "narrow side is implicitly promoted to %s "
                       "(insert an explicit Cast to pick the compute "
                       "dtype)" % (
                           "/".join(sorted(dtype_name(t) for t in floats)),
                           "; ".join("%s: %s" % (dtype_name(t), ", ".join(v))
                                     for t, v in sorted(
                                         floats.items(),
                                         key=lambda kv: dtype_name(kv[0]))),
                           dtype_name(wide)))


@register_rule("MXL-T002", "error", "type propagation failed at an op")
def dtype_failure(ctx):
    """Ops whose infer_type raised — tracing would die there too."""
    _types, failed = _propagate_types(ctx)
    for node, exc in failed:
        ctx.report(node, "infer_type failed: %s" % exc)
