"""SPMD sharding propagation (rule family MXL-P).

The port of ``mxnet_tpu/analysis/propagation.py``: the same transfer
rules (``ops.registry.sharding_transfer``, the ops' ``infer_sharding``),
the same events and byte counts, and the same messages, so a saved graph
prices its collectives alike in both packages.  It is static: a
``parallel.LogicalMesh`` is enough, no device.  The messages name XLA,
the JAX package's partitioner; on the port the same collectives are the
ones ``parallel/collectives.py`` would have to issue.

The scaling-book failure mode this pass catches: you annotate a mesh and
per-name PartitionSpecs, XLA's SPMD partitioner silently *makes it work*
— inserting all-gathers and reshards wherever the annotated layouts
disagree — and the first sign of trouble is an ICI-bound profile three
hours into a run.  The reference had a crude analog (kvstore picked one
reduction layout per key and you found out at runtime); here the graph
is static, so the layout algebra can run at bind/lint time.

The pass seeds every argument with the PartitionSpec the trainer would
bind (``parallel.sharding.named_pspecs`` — explicit ShardingRules first,
then the default megatron-style policy) and pushes specs forward through
every op via its transfer rule (``ops.registry.sharding_transfer``,
registered alongside the lowering metadata).  Diffing each op's
*required* input layout against what actually *arrives* classifies every
implicit collective XLA would insert:

- MXL-P001  error    irreconcilable specs on one dim (different mesh
                     axes): a forced reshard (all-to-all) — almost
                     always an annotation bug;
- MXL-P002  warning  sharded value consumed replicated: an implicit
                     all-gather, with the ICI bytes it moves;
- MXL-P003  info     parameter the tp policy wanted to shard but
                     couldn't (no divisible dim): degraded to
                     replicated (from ``named_pspecs`` notes);
- MXL-P004  info     sharded contraction: XLA inserts the matching
                     psum (expected for row-parallel layers — listed so
                     the cost report is complete).

Byte estimates use the standard ring costs: all-gather of a tensor with
global size B over an axis of k devices moves B·(k-1)/k per device;
psum (reduce-scatter + all-gather) moves 2·B·(k-1)/k.

``comm_report`` aggregates the events into the per-graph communication
table ``tools/mxlint.py --mesh ...`` prints.
"""
from __future__ import annotations

import numpy as _np

from ..ops.registry import sharding_transfer
from .core import register_rule
from .shapes import _propagate_types, as_dtype

__all__ = ["propagate", "comm_report", "fmt_bytes"]


# ----------------------------------------------------------------------
# shared cached graph facts
# ----------------------------------------------------------------------
def edge_shapes(ctx):
    """Per-edge shape map {(id(node), out_idx): tuple} — the same
    fixpoint as ``Symbol._infer_shape_impl`` but non-throwing (a shape
    contradiction is MXL-S002's finding; this pass just skips the node)
    and keeping every interior edge.  Cached on the context."""
    if "edge_shapes" in ctx.cache:
        return ctx.cache["edge_shapes"]
    from ..dparam import parse_tuple
    shapes = {}
    for node in ctx.topo:
        if node.is_variable:
            if node.name in ctx.shapes:
                shapes[(id(node), 0)] = tuple(ctx.shapes[node.name])
            elif "__shape__" in node.attrs:
                try:
                    shapes[(id(node), 0)] = parse_tuple(
                        node.attrs["__shape__"])
                except Exception:
                    pass
    while True:
        progress = False
        for node in ctx.topo:
            if node.is_variable:
                continue
            in_shapes = [shapes.get((id(c), ci)) for c, ci in node.inputs]
            try:
                full_in, outs, _aux = node.op.infer_shape(in_shapes)
            except Exception:   # incomplete/contradictory: not our finding
                continue
            for (c, ci), s in zip(node.inputs, full_in):
                key = (id(c), ci)
                if s is not None and shapes.get(key) is None:
                    shapes[key] = tuple(s)
                    progress = True
            for i, s in enumerate(outs):
                key = (id(node), i)
                if s is not None and shapes.get(key) is None:
                    shapes[key] = tuple(s)
                    progress = True
        if not progress:
            break
    ctx.cache["edge_shapes"] = shapes
    return shapes


def edge_types(ctx):
    """Per-edge dtype map (cached wrapper over the MXL-T walk)."""
    if "edge_types" not in ctx.cache:
        types, _failed = _propagate_types(ctx)
        ctx.cache["edge_types"] = types
    return ctx.cache["edge_types"]


# ----------------------------------------------------------------------
# spec algebra
# ----------------------------------------------------------------------
def _normalize(spec, rank):
    """PartitionSpec / loose tuple -> normalized: ``rank`` entries, each
    a tuple of mesh-axis names (() = replicated on that dim)."""
    if spec is None:
        return ((),) * rank
    out = []
    for entry in tuple(spec)[:rank]:
        if entry is None:
            out.append(())
        elif isinstance(entry, (tuple, list)):
            out.append(tuple(entry))
        else:
            out.append((entry,))
    out.extend([()] * (rank - len(out)))
    return tuple(out)


def _axis_size(axes, mesh_shape):
    k = 1
    for a in axes or ():
        k *= int(mesh_shape.get(a, 1))
    return k


def _edge_bytes(shape, dtype):
    return int(_np.prod(shape, dtype=_np.int64)) * \
        as_dtype(dtype or "float32").itemsize


def fmt_bytes(n):
    """Human byte count for reports (1024-based, one decimal)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return ("%.1f%s" % (n, unit)) if unit != "B" \
                else ("%d%s" % (int(n), unit))
        n /= 1024.0


# ----------------------------------------------------------------------
# the propagation pass proper
# ----------------------------------------------------------------------
def propagate(ctx):
    """Run forward sharding propagation once per context (cached).

    Returns ``{"specs", "events", "seed_notes", "seeds", "ok"}``:
    per-edge normalized specs, the implicit-collective event list, the
    seeding-degradation notes, the per-argument seed specs, and whether
    every node could be processed (unknown shapes make it partial).
    """
    if "propagation" in ctx.cache:
        return ctx.cache["propagation"]
    result = {"specs": {}, "events": [], "seed_notes": [], "seeds": {},
              "ok": False}
    ctx.cache["propagation"] = result
    if ctx.mesh is None or ctx.symbol is None:
        return result
    from ..parallel.sharding import named_pspecs
    mesh_shape = dict(ctx.mesh.shape)
    shapes = edge_shapes(ctx)
    types = edge_types(ctx)
    specs = result["specs"]
    events = result["events"]

    named_shapes = {n.name: shapes.get((id(n), 0))
                    for n in ctx.variables()}
    notes = []
    by_name = named_pspecs(named_shapes, ctx.mesh,
                           rules=ctx.sharding_rules,
                           data_names=ctx.data_names,
                           label_names=ctx.label_names, notes=notes)
    result["seed_notes"] = notes
    for node in ctx.variables():
        shape = named_shapes.get(node.name)
        if shape is None:
            continue
        spec = _normalize(by_name.get(node.name), len(shape))
        specs[(id(node), 0)] = spec
        result["seeds"][node.name] = spec

    complete = True
    for node in ctx.topo:
        if node.is_variable:
            continue
        in_keys = [(id(c), ci) for c, ci in node.inputs]
        in_shapes = [shapes.get(k) for k in in_keys]
        out_shapes = [shapes.get((id(node), i))
                      for i in range(node.num_outputs)]
        if any(s is None for s in in_shapes) or \
                any(s is None for s in out_shapes):
            complete = False
            for i, s in enumerate(out_shapes):
                if s is not None:
                    specs[(id(node), i)] = ((),) * len(s)
            continue
        in_specs = [specs.get(k) or ((),) * len(s)
                    for k, s in zip(in_keys, in_shapes)]
        try:
            xfer = sharding_transfer(node.op, in_specs, in_shapes,
                                     out_shapes, mesh_shape) or {}
        except Exception:   # a broken rule must not kill the whole pass
            complete = False
            xfer = {}
        arg_names = node.op.list_arguments()

        for idx, req in enumerate(xfer.get("in") or ()):
            if req is None or idx >= len(in_specs):
                continue
            actual = in_specs[idx]
            req = _normalize(req, len(in_shapes[idx]))
            gbytes = _edge_bytes(in_shapes[idx], types.get(in_keys[idx]))
            aname = arg_names[idx] if idx < len(arg_names) else "in%d" % idx
            src = node.inputs[idx][0].name
            for d in range(len(actual)):
                act_d, req_d = actual[d], req[d]
                if act_d == req_d or not act_d:
                    continue        # match, or free reslice of replicated
                k = _axis_size(act_d, mesh_shape)
                if not req_d:
                    events.append({
                        "kind": "gather", "node": node, "arg": idx,
                        "axes": act_d,
                        "bytes": gbytes * (k - 1) // k,
                        "message":
                            "input %r (%s) arrives sharded over %s on dim "
                            "%d but %s consumes it replicated: XLA inserts "
                            "an implicit all-gather moving ~%s per device "
                            "over ICI" % (
                                aname, src, "+".join(act_d), d,
                                node.op.op_name,
                                fmt_bytes(gbytes * (k - 1) // k))})
                else:
                    events.append({
                        "kind": "reshard", "node": node, "arg": idx,
                        "axes": tuple(act_d) + tuple(req_d),
                        "bytes": gbytes * (k - 1) // k,
                        "message":
                            "input %r (%s) arrives sharded over %s on dim "
                            "%d but %s requires %s there: XLA inserts a "
                            "forced reshard (all-to-all) moving ~%s per "
                            "device over ICI — almost always a sharding-"
                            "rule conflict" % (
                                aname, src, "+".join(act_d), d,
                                node.op.op_name, "+".join(req_d),
                                fmt_bytes(gbytes * (k - 1) // k))})

        for axes, reason in (xfer.get("reduce") or {}).items():
            axes = tuple(axes)
            k = _axis_size(axes, mesh_shape)
            gbytes = _edge_bytes(out_shapes[0],
                                 types.get((id(node), 0)))
            events.append({
                "kind": "reduce", "node": node, "arg": None, "axes": axes,
                "bytes": 2 * gbytes * (k - 1) // k,
                "message": "%s: XLA inserts a psum over %s moving ~%s per "
                           "device" % (reason, "+".join(axes),
                                       fmt_bytes(2 * gbytes * (k - 1) // k))})

        for note in xfer.get("notes") or ():
            idx = note.get("arg", 0)
            axes = tuple(note.get("axes") or ())
            k = _axis_size(axes, mesh_shape)
            gbytes = _edge_bytes(in_shapes[idx], types.get(in_keys[idx])) \
                if idx < len(in_shapes) else 0
            events.append({
                "kind": note.get("kind", "note"), "node": node, "arg": idx,
                "axes": axes, "bytes": gbytes * (k - 1) // k,
                "message": "%s (~%s per device over ICI)"
                           % (note.get("message", ""),
                              fmt_bytes(gbytes * (k - 1) // k))})

        for i, ospec in enumerate(xfer.get("out") or ()):
            if i < len(out_shapes) and out_shapes[i] is not None:
                specs[(id(node), i)] = _normalize(ospec, len(out_shapes[i]))
        for i, s in enumerate(out_shapes):
            if (id(node), i) not in specs and s is not None:
                specs[(id(node), i)] = ((),) * len(s)

    result["ok"] = complete
    return result


def comm_report(ctx):
    """Aggregate the propagation events into the per-graph communication
    cost table: total ICI bytes per device and a per-kind breakdown.
    Serializable (node objects become names) for the CLI's json mode."""
    prop = propagate(ctx)
    by_kind = {}
    total = 0
    rows = []
    for ev in prop["events"]:
        entry = by_kind.setdefault(ev["kind"], {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += ev["bytes"]
        total += ev["bytes"]
        rows.append({"kind": ev["kind"],
                     "node": getattr(ev["node"], "name", ev["node"]),
                     "axes": list(ev["axes"]), "bytes": ev["bytes"],
                     "message": ev["message"]})
    return {"total_bytes": total, "by_kind": by_kind, "events": rows,
            "complete": prop["ok"],
            "degraded": [{"name": n, "message": m}
                         for n, m in prop["seed_notes"]]}


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------
@register_rule("MXL-P001", "error",
               "sharding conflict forces an implicit reshard")
def sharding_conflict(ctx):
    """Two different mesh axes claim one dim at an op input."""
    if ctx.mesh is None:
        return
    for ev in propagate(ctx)["events"]:
        if ev["kind"] == "reshard":
            ctx.report(ev["node"], ev["message"])


@register_rule("MXL-P002", "warning",
               "sharded value consumed replicated: implicit all-gather")
def implicit_gather(ctx):
    """A sharded tensor flows into an op that needs it whole."""
    if ctx.mesh is None:
        return
    for ev in propagate(ctx)["events"]:
        if ev["kind"] == "gather":
            ctx.report(ev["node"], ev["message"])


@register_rule("MXL-P003", "info",
               "parameter degraded to replicated (no divisible dim)")
def sharding_degraded(ctx):
    """The default tp policy wanted to shard but no dim divides."""
    if ctx.mesh is None:
        return
    for name, msg in propagate(ctx)["seed_notes"]:
        ctx.report(name, msg)


@register_rule("MXL-P004", "info",
               "sharded contraction: XLA inserts the matching psum")
def sharded_contraction(ctx):
    """Expected collectives (row-parallel matmuls, vocab-sharded
    embeddings) — reported at info so the cost table is complete."""
    if ctx.mesh is None:
        return
    for ev in propagate(ctx)["events"]:
        if ev["kind"] == "reduce":
            ctx.report(ev["node"], ev["message"])
