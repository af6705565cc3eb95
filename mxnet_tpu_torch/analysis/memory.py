"""Liveness-based peak device-memory estimation (rule family MXL-M).

The port of ``mxnet_tpu/analysis/memory.py``, with the same components
and byte counts.  The reference planned storage ahead of execution
(GraphStoragePool, graph_executor.cc) and simply failed allocation when
a graph didn't fit.  PyTorch's caching allocator plans nothing ahead: an
out-of-memory error surfaces in the middle of a step, with no per-tensor
attribution.  This pass walks the topo-sorted graph with the same
shape/type/sharding facts the propagation pass derives and prices the
live set *before* any tracing:

- parameters + batch inputs (every bound argument), per-device after
  sharding;
- gradients for every argument trained (``grad_req`` != null) — same
  sharding as the parameter;
- auxiliary states (BatchNorm moving stats);
- activations: in training mode (any non-null grad_req) every op-output
  edge is a residual autograd keeps live for the backward pass, *except*
  the interiors of mirror segments (executor._mirror_segments) which are
  dropped and recomputed; in
  inference mode a forward liveness scan (free each edge after its last
  consumer) gives the true schedule peak.

``peak_hbm_report`` returns the component breakdown; MXL-M001 compares
the peak against the per-device budget (``hbm_bytes`` passed by the
caller, or the ``MXTPU_HBM_GB`` env knob) and fails the lint when the
model cannot fit.  :func:`hbm_capacity_bytes` gives a card's budget: the
device's own ``total_memory`` when a device is named, else the memory
size of its row in ``observability.counters.PEAKS`` (the JAX package's
TPU table is not carried).

The estimate is *analytic*: it counts every op output an eager walk
could keep, where autograd frees some early and saves views of others,
so treat it as an estimate, not as ``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import os as _os

from .core import register_rule
from .propagation import (edge_shapes, edge_types, propagate, _axis_size,
                          _edge_bytes, fmt_bytes)

__all__ = ["peak_hbm_report", "hbm_capacity_bytes"]

def hbm_capacity_bytes(device_kind):
    """Per-device memory in bytes, or None when unknown.
    ``MXTPU_HBM_GB`` overrides (floats accepted, GiB).  ``device_kind``
    may be a CUDA device (a ``torch.device``, an index or ``"cuda:0"``,
    whose ``total_memory`` is read) or a card's name, looked up in
    ``observability.counters.PEAKS``."""
    env = _os.environ.get("MXTPU_HBM_GB")
    if env:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            pass
    if device_kind is None or device_kind == "":
        return None
    import torch
    if isinstance(device_kind, (int, torch.device)) or \
            str(device_kind).startswith("cuda"):
        return int(torch.cuda.get_device_properties(
            torch.device(device_kind) if not isinstance(device_kind, int)
            else device_kind).total_memory)
    from ..observability.counters import PEAKS
    row = PEAKS.get(str(device_kind))
    return int(row["memory_bytes"]) if row else None


def _shard_factor(spec, mesh_shape):
    f = 1
    for entry in spec or ():
        f *= _axis_size(entry, mesh_shape)
    return max(f, 1)


def _grad_req_of(ctx, name):
    """Resolve the requested grad_req for one argument name.

    Mirrors the Executor's handling: a single string applies to every
    argument, a dict maps names (missing -> null), None defaults to
    'write' (the bind default — lint assumes training unless told
    otherwise)."""
    req = ctx.grad_req
    if req is None:
        req = "write"
    if isinstance(req, str):
        return req
    if isinstance(req, dict):
        return req.get(name, "null")
    try:        # list aligned with list_arguments
        args = ctx.symbol.list_arguments()
        return dict(zip(args, req)).get(name, "null")
    except Exception:
        return "null"


def peak_hbm_report(ctx):
    """Per-device peak-HBM breakdown for the bound graph (cached).

    Returns ``{"params_bytes", "grads_bytes", "aux_bytes",
    "activations_bytes", "peak_bytes", "mode", "budget_bytes",
    "complete", "largest"}``.  ``complete`` is False when some shapes
    never resolved (the totals are then a lower bound).  ``largest``
    lists the biggest contributors for the CLI report.
    """
    if "memory" in ctx.cache:
        return ctx.cache["memory"]
    report = {"params_bytes": 0, "grads_bytes": 0, "aux_bytes": 0,
              "activations_bytes": 0, "peak_bytes": 0, "mode": None,
              "budget_bytes": None, "complete": True, "largest": []}
    ctx.cache["memory"] = report
    if ctx.symbol is None:
        report["complete"] = False
        return report
    shapes = edge_shapes(ctx)
    types = edge_types(ctx)
    mesh_shape = dict(ctx.mesh.shape) if ctx.mesh is not None else {}
    specs = propagate(ctx)["specs"] if ctx.mesh is not None else {}

    def device_bytes(key):
        shape = shapes.get(key)
        if shape is None:
            return None
        b = _edge_bytes(shape, types.get(key))
        return b // _shard_factor(specs.get(key), mesh_shape)

    contributors = []
    batchy = set(ctx.data_names) | set(ctx.label_names)
    trained = False
    for node in ctx.variables():
        b = device_bytes((id(node), 0))
        if b is None:
            report["complete"] = False
            continue
        report["params_bytes"] += b
        contributors.append((b, "param", node.name))
        if node.name not in batchy and \
                _grad_req_of(ctx, node.name) != "null":
            trained = True
            report["grads_bytes"] += b
            contributors.append((b, "grad", node.name))

    # auxiliary states (moving stats): shapes via each op's own rule
    for node in ctx.op_nodes():
        aux_names = node.op.list_auxiliary_states()
        if not aux_names:
            continue
        in_shapes = [shapes.get((id(c), ci)) for c, ci in node.inputs]
        try:
            _, _, aux_shapes = node.op.infer_shape(in_shapes)
        except Exception:
            report["complete"] = False
            continue
        for aname, ashape in zip(aux_names, aux_shapes):
            if ashape is None:
                report["complete"] = False
                continue
            b = _edge_bytes(ashape, types.get((id(node), 0)))
            report["aux_bytes"] += b
            contributors.append((b, "aux", "%s_%s" % (node.name, aname)))

    op_nodes = ctx.op_nodes()
    report["mode"] = "training" if trained else "inference"
    if trained:
        # autograd keeps every op output live as a residual, except
        # mirror segment interiors (dropped, recomputed in the backward)
        from ..executor import _mirror_segments
        dropped = set()
        for is_mirror, seg in _mirror_segments(op_nodes):
            if is_mirror and len(seg) > 1:
                for n in seg[:-1]:
                    dropped.add(id(n))
        for node in op_nodes:
            if id(node) in dropped:
                continue
            for i in range(node.num_outputs):
                b = device_bytes((id(node), i))
                if b is None:
                    report["complete"] = False
                    continue
                report["activations_bytes"] += b
                contributors.append((b, "activation", node.name))
        report["peak_bytes"] = (report["params_bytes"] +
                                report["grads_bytes"] +
                                report["aux_bytes"] +
                                report["activations_bytes"])
    else:
        # forward-only: liveness scan over the topo schedule
        last_use = {}
        for pos, node in enumerate(op_nodes):
            for c, ci in node.inputs:
                last_use[(id(c), ci)] = pos
        heads = {(id(n), i) for n, i in ctx.symbol._heads}
        base = report["params_bytes"] + report["aux_bytes"]
        live = dict()       # key -> bytes, op outputs only
        peak_act = 0
        for pos, node in enumerate(op_nodes):
            for i in range(node.num_outputs):
                key = (id(node), i)
                b = device_bytes(key)
                if b is None:
                    report["complete"] = False
                    b = 0
                live[key] = b
            cur = sum(live.values())
            peak_act = max(peak_act, cur)
            for key in [k for k, p in last_use.items()
                        if p == pos and k not in heads]:
                live.pop(key, None)
        report["activations_bytes"] = peak_act
        report["peak_bytes"] = base + peak_act

    budget = ctx.hbm_bytes
    if budget is None:
        budget = hbm_capacity_bytes(None)   # env knob only
    report["budget_bytes"] = budget
    contributors.sort(key=lambda t: -t[0])
    report["largest"] = [{"bytes": b, "kind": k, "name": n}
                         for b, k, n in contributors[:8]]
    return report


@register_rule("MXL-M001", "error",
               "estimated peak HBM exceeds the per-device budget")
def peak_over_budget(ctx):
    """The model cannot fit: fail at bind, not in the middle of a step."""
    # budget check BEFORE pricing the graph: with no budget there is
    # nothing to compare against, and the report walk must not tax
    # every budget-less bind in a test suite
    budget = ctx.hbm_bytes
    if budget is None:
        budget = hbm_capacity_bytes(None)   # env knob only
    if budget is None:
        return
    rep = peak_hbm_report(ctx)
    if not rep["peak_bytes"]:
        return
    if rep["peak_bytes"] > budget:
        top = ", ".join("%s %s=%s" % (t["kind"], t["name"],
                                      fmt_bytes(t["bytes"]))
                        for t in rep["largest"][:3])
        ctx.report(None,
                   "estimated per-device peak HBM %s (params %s + grads %s "
                   "+ aux %s + activations %s, %s mode) exceeds the budget "
                   "%s; largest: %s" % (
                       fmt_bytes(rep["peak_bytes"]),
                       fmt_bytes(rep["params_bytes"]),
                       fmt_bytes(rep["grads_bytes"]),
                       fmt_bytes(rep["aux_bytes"]),
                       fmt_bytes(rep["activations_bytes"]),
                       rep["mode"], fmt_bytes(budget), top))


@register_rule("MXL-M002", "warning",
               "replicated parameter dominates the HBM budget")
def big_replicated_param(ctx):
    """A parameter replicated on every device eats a large budget slice
    the sharding rules could reclaim (threshold: MXTPU_LINT_BIG_PARAM_PCT
    percent of the budget, default 25)."""
    budget = ctx.hbm_bytes
    if budget is None:
        budget = hbm_capacity_bytes(None)   # env knob only
    if budget is None or ctx.mesh is None:
        return
    try:
        pct = float(_os.environ.get("MXTPU_LINT_BIG_PARAM_PCT", "25"))
    except ValueError:
        pct = 25.0
    threshold = budget * pct / 100.0
    shapes = edge_shapes(ctx)
    types = edge_types(ctx)
    seeds = propagate(ctx)["seeds"]
    batchy = set(ctx.data_names) | set(ctx.label_names)
    for node in ctx.variables():
        if node.name in batchy:
            continue
        spec = seeds.get(node.name)
        if spec is None or any(spec):
            continue            # unsharded info missing, or sharded
        shape = shapes.get((id(node), 0))
        if shape is None:
            continue
        b = _edge_bytes(shape, types.get((id(node), 0)))
        if b >= threshold:
            ctx.report(node, "parameter %r (%s, %s) is replicated on every "
                       "device and alone takes %.0f%% of the %s budget — "
                       "add a ShardingRule for it" % (
                           node.name, tuple(shape), fmt_bytes(b),
                           100.0 * b / budget, fmt_bytes(budget)))
