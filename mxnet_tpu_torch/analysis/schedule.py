"""Static pipeline/MoE schedule lint (rule family MXL-E).

The port of ``mxnet_tpu/analysis/schedule.py``, with the JAX package's
rule ids, severities, nodes and messages.  Pipeline parallelism is an
explicit microbatch schedule (``parallel/pipeline.py``: GPipe and 1F1B)
and MoE dispatch an explicit all-to-all (``ops/moe.py``); both are cheap
to get WRONG in ways that only show up as an idle card: a stage 3x the
others, a bubble fraction that eats the speedup, an activation stash
that overflows stage 0's memory, experts that don't divide over the
``ep`` axis.

This pass prices and validates the schedule before a card is touched:

- stage partitions come from the ``ctx_group`` annotations MXL-C002
  already parses, or, when the mesh carries a ``pp`` axis, from a
  contiguous flops-balanced split of the topo order (how
  ``GPipeTrainer.from_block_symbol`` stacks blocks);
- each stage is priced by the port's MXL-R rows (the same ``_op_costs``,
  the same training multipliers) at the card's peaks in
  ``observability.counters.PEAKS``, at the compute dtype;
- stage-to-stage transfers and the expert all-to-all are priced at the
  card's interconnect rate, ``PEAKS``' ``link_bytes_per_s`` (NVLink on
  the SXM card, PCIe on the PCIe card);
- a slot-synchronous simulator walks both the GPipe and 1F1B microbatch
  schedules.  Slot-synchronous is deliberate: the runtime advances in
  lock step, so a slot costs the MAX over members.  The 1F1B kind table
  is the SAME table the runtime walks
  (``parallel.pipeline.build_1f1b_tables``).

Peak device memory includes the 1F1B activation stash: stage ``s`` holds
``min(K - s, M)`` in-flight microbatch activations (GPipe holds all
``M``).

Rules (docs/graph_lint.md):

- MXL-E001  stage compute imbalance (names the stage + dominant ops)
- MXL-E002  bubble fraction above bound (+ the min microbatch count
            that would fix it)
- MXL-E003  cross-stage back-edge: deadlock under 1F1B
- MXL-E004  per-stage activation-stash memory overflow
- MXL-E005  stage-boundary transfer cannot hide under adjacent compute
- MXL-E006  expert count not divisible by the expert-parallel axis
- MXL-E007  capacity factor under 1: guaranteed token drops
- MXL-E008  expert all-to-all priced per rank (replayed through the
            MXL-D collective trace when ``world_size`` is set)

Knobs, with the JAX package's names and meaning: ``MXTPU_LINT_SCHEDULE``
(family kill-switch, default on), ``MXTPU_LINT_MICROBATCHES`` (default
8) and ``MXTPU_LINT_ICI_GBPS`` (overrides the interconnect rate, GB/s;
the JAX package's default is its TPU's 90).  The bounds are the JAX
package's defaults: :data:`STAGE_IMBALANCE` (E001), :data:`BUBBLE_MAX`
(E002), :data:`MOE_CAPACITY_MIN` (E007) and :data:`MIN_FLOPS` (the
pricing rules' significance floor).  The family runs on the ``"gpu"``
target, as MXL-R does.
"""
from __future__ import annotations

import os as _os

from .core import register_rule
from .memory import _grad_req_of, _shard_factor, hbm_capacity_bytes
from .propagation import (_edge_bytes, edge_shapes, edge_types, fmt_bytes,
                          propagate)
from .roofline import (_env_float, _op_costs, device_peaks,
                       resolve_compute_dtype, resolve_device_kind)

__all__ = ["stage_partition", "schedule_report", "simulate_schedule",
           "gpipe_kind_rows"]


def _enabled():
    return _os.environ.get("MXTPU_LINT_SCHEDULE", "1").lower() not in \
        ("0", "false", "no", "off")


#: E001: the heaviest stage's time over the lightest's
STAGE_IMBALANCE = 1.5
#: E002: the 1F1B bubble fraction
BUBBLE_MAX = 0.4
#: E007: the capacity factor under which tokens drop even when balanced
MOE_CAPACITY_MIN = 1.0
#: the training FLOPs under which the pricing rules stay quiet
MIN_FLOPS = 5e10


def _microbatches(ctx):
    m = getattr(ctx, "schedule_microbatches", None)
    if not m:
        m = _env_float("MXTPU_LINT_MICROBATCHES", 8)
    return max(int(m), 1)


def _link(ctx):
    """``(bytes_per_s, name)`` of the card's interconnect:
    ``MXTPU_LINT_ICI_GBPS`` when set, else the ``PEAKS`` row of the card
    that prices the graph (``(None, name)`` for a card not in it)."""
    from ..observability.counters import PEAKS
    row = PEAKS.get(resolve_device_kind(ctx)) or {}
    name = row.get("link", "interconnect")
    gb = _env_float("MXTPU_LINT_ICI_GBPS", 0.0)
    if gb:
        return gb * 1e9, name
    return row.get("link_bytes_per_s"), name


# ----------------------------------------------------------------------
# stage partition
# ----------------------------------------------------------------------
def stage_partition(ctx):
    """Resolve the pipeline-stage partition of the graph, or None.

    Two sources, ``ctx_group`` first (explicit placement wins):

    - >= 2 distinct ``ctx_group`` attrs on op nodes: stages in order of
      first topo appearance; un-grouped nodes inherit the max stage of
      their op inputs (default 0) — the reference's placement semantics;
    - a ``pp`` axis of size >= 2 on the mesh: contiguous
      flops-balanced split of the topo-ordered op nodes into ``pp``
      chunks — the shape ``GPipeTrainer`` produces from a block stack.

    Returns ``{"mode", "k", "groups", "stage_of", "stages"}`` with
    ``stage_of`` keyed by op-node NAME.
    """
    if ctx.symbol is None:
        return None
    ops = ctx.op_nodes()
    if not ops:
        return None

    order = []
    first = {}
    for n in ops:
        g = n.attrs.get("ctx_group")
        if g and g not in first:
            first[g] = len(order)
            order.append(g)
    if len(order) >= 2:
        stage_of = {}
        for n in ops:
            g = n.attrs.get("ctx_group")
            if g:
                stage_of[n.name] = first[g]
            else:
                s = 0
                for c, _ci in n.inputs:
                    if not c.is_variable and c.name in stage_of:
                        s = max(s, stage_of[c.name])
                stage_of[n.name] = s
        k = len(order)
        stages = [[] for _ in range(k)]
        for n in ops:
            stages[stage_of[n.name]].append(n.name)
        return {"mode": "ctx_group", "k": k, "groups": order,
                "stage_of": stage_of, "stages": stages}

    mesh_shape = dict(ctx.mesh.shape) if ctx.mesh is not None else {}
    k = int(mesh_shape.get("pp", 1))
    if k < 2 or len(ops) < k:
        return None
    rows = {r["node"]: r for r in _op_costs(ctx)["rows"]}
    flops = [float(rows.get(n.name, {}).get("flops", 0.0)) for n in ops]
    total = sum(flops) or float(len(ops))
    if not sum(flops):            # no priced ops: balance by node count
        flops = [1.0] * len(ops)
    stage_of = {}
    stages = [[] for _ in range(k)]
    acc, s = 0.0, 0
    for i, n in enumerate(ops):
        stage_of[n.name] = s
        stages[s].append(n.name)
        acc += flops[i]
        remaining = len(ops) - 1 - i
        if s < k - 1 and (acc >= (s + 1) * total / k
                          or remaining <= (k - 1 - s)):
            s += 1
    return {"mode": "pp", "k": k,
            "groups": ["pp%d" % i for i in range(k)],
            "stage_of": stage_of, "stages": stages}


# ----------------------------------------------------------------------
# slot-synchronous schedule simulator
# ----------------------------------------------------------------------
def gpipe_kind_rows(k, m):
    """GPipe kind table, one row per slot over ``k`` stages: 0 idle,
    1 forward, 2 backward.  Forward wave ``m + k - 1`` slots (stage s
    busy for slots ``[s, s+m)``), backward wave mirrored, last stage
    first."""
    span = m + k - 1
    rows = []
    for t in range(span):
        rows.append([1 if s <= t < s + m else 0 for s in range(k)])
    for tt in range(span):
        rows.append([2 if (k - 1 - s) <= tt < (k - 1 - s) + m else 0
                     for s in range(k)])
    return rows


def _1f1b_kind_rows(k, m):
    from ..parallel.pipeline import build_1f1b_tables
    kind, _mb = build_1f1b_tables(k, m)
    return [[int(kind[t][s]) for s in range(k)]
            for t in range(len(kind))]


def simulate_schedule(kind_rows, t_fwd, t_bwd, xfer=0.0):
    """Walk a kind table with per-stage slot costs.

    Lock-step semantics: every slot ends with the schedule's ppermute
    pair, so the slot costs ``max(active member times, boundary
    transfer)`` and idle members wait.  Returns per-stage busy time,
    total wall time, and the bubble fraction
    ``1 - busy / (k * total)``."""
    k = len(t_fwd)
    total = 0.0
    busy = [0.0] * k
    for row in kind_rows:
        slot = 0.0
        for s in range(k):
            kd = row[s]
            w = t_fwd[s] if kd == 1 else (t_bwd[s] if kd >= 2 else 0.0)
            busy[s] += w
            if w > slot:
                slot = w
        if xfer > slot:
            slot = xfer
        total += slot
    denom = k * total
    return {"slots": len(kind_rows), "total_time": total,
            "busy": list(busy),
            "bubble_fraction":
                (1.0 - sum(busy) / denom) if denom else 0.0}


def _min_microbatches_for(k, t_fwd, t_bwd, xfer, bound, start):
    """Smallest 1F1B microbatch count whose bubble meets ``bound``
    (None when even 512 doesn't)."""
    m = max(int(start), 1)
    while m <= 512:
        sim = simulate_schedule(_1f1b_kind_rows(k, m), t_fwd, t_bwd,
                                xfer)
        if sim["bubble_fraction"] <= bound:
            return m
        m = m + 1 if m < 16 else m * 2
    return None


# ----------------------------------------------------------------------
# the schedule report
# ----------------------------------------------------------------------
def _moe_nodes(ctx):
    return [n for n in ctx.op_nodes()
            if type(n.op).op_name == "MoE"]


def schedule_report(ctx):
    """The whole-graph static schedule report (cached on the context).

    None when the graph has neither a stage partition nor MoE nodes.
    Keys: ``partition``, ``microbatches``, ``stages`` (roofline-priced),
    ``boundaries`` (link-priced cross-stage transfers), ``back_edges``,
    ``schedules`` (``gpipe``/``1f1b`` simulator results), ``stage_hbm``
    (params + grads + activation stash per stage, vs ``budget_bytes``),
    ``moe`` (per-node routing stats incl. static ``expert_balance`` =
    capacity over balanced load, clipped to 1), ``complete``.
    """
    if "schedule_report" in ctx.cache:
        return ctx.cache["schedule_report"]
    part = stage_partition(ctx)
    moe = _moe_report(ctx)
    if part is None and not moe:
        ctx.cache["schedule_report"] = None
        return None

    m = _microbatches(ctx)
    facts = _op_costs(ctx)
    report = {"partition": None, "microbatches": m, "stages": [],
              "boundaries": [], "back_edges": [], "schedules": {},
              "stage_hbm": [], "budget_bytes": None, "moe": moe,
              "complete": facts["complete"]}
    ctx.cache["schedule_report"] = report
    if part is None:
        return report
    report["partition"] = {"mode": part["mode"], "k": part["k"],
                           "groups": list(part["groups"])}
    k = part["k"]
    rows = {r["node"]: r for r in facts["rows"]}
    training = facts["training"]
    peak_f, peak_b = device_peaks(resolve_device_kind(ctx),
                                  resolve_compute_dtype(ctx))

    # -- per-stage roofline pricing ------------------------------------
    t_fwd, t_bwd = [], []
    for idx, names in enumerate(part["stages"]):
        fl = sum(rows[n]["flops"] for n in names if n in rows)
        by = sum(rows[n]["bytes"] for n in names if n in rows)
        if peak_f and peak_b:
            t = max(fl / peak_f, by / peak_b)
        else:                     # no spec peaks: flops as time proxy
            t = fl
        # training triples MXU work (fwd + dgrad + wgrad); the forward
        # share of a stage slot is one pass of three
        f = (t / 3.0) if training else t
        b = (t - f) if training else 0.0
        dominant = sorted((rows[n] for n in names if n in rows),
                          key=lambda r: -r["flops"])[:2]
        report["stages"].append({
            "index": idx, "group": part["groups"][idx],
            "ops": len(names), "flops": fl, "bytes": by, "time_s": t,
            "t_fwd_s": f, "t_bwd_s": b,
            "dominant": [{"node": r["node"], "op": r["op"],
                          "flops": r["flops"]} for r in dominant]})
        t_fwd.append(f)
        t_bwd.append(b)

    # -- cross-stage edges: boundary transfers + back-edges ------------
    shapes = edge_shapes(ctx)
    types = edge_types(ctx)
    mesh_shape = dict(ctx.mesh.shape) if ctx.mesh is not None else {}
    specs = propagate(ctx)["specs"] if ctx.mesh is not None else {}
    stage_of = part["stage_of"]
    ici, _name = _link(ctx)
    bounds = {}
    for n in ctx.op_nodes():
        q = stage_of.get(n.name)
        for c, ci in n.inputs:
            if c.is_variable:
                continue
            p = stage_of.get(c.name)
            if p is None or q is None or p == q:
                continue
            if q < p:
                report["back_edges"].append(
                    {"src_node": c.name, "dst_node": n.name,
                     "src_stage": p, "dst_stage": q})
                continue
            shape = shapes.get((id(c), ci))
            if shape is None:
                report["complete"] = False
                continue
            b = _edge_bytes(shape, types.get((id(c), ci)))
            b //= _shard_factor(specs.get((id(c), ci)), mesh_shape)
            entry = bounds.setdefault((p, q), {"src": p, "dst": q,
                                               "bytes": 0, "edges": []})
            entry["bytes"] += b
            entry["edges"].append(c.name)
    for key in sorted(bounds):
        e = bounds[key]
        e["time_s"] = (e["bytes"] / ici) if ici else 0.0
        report["boundaries"].append(e)
    xfer = max([e["time_s"] for e in report["boundaries"]] + [0.0])
    # the simulator walks one microbatch per slot: per-mb times
    xfer_mb = xfer / m

    # -- walk both schedules -------------------------------------------
    f_mb = [t / m for t in t_fwd]
    b_mb = [t / m for t in t_bwd]
    report["schedules"]["gpipe"] = simulate_schedule(
        gpipe_kind_rows(k, m), f_mb, b_mb, xfer_mb)
    report["schedules"]["1f1b"] = simulate_schedule(
        _1f1b_kind_rows(k, m), f_mb, b_mb, xfer_mb)

    # -- per-stage peak HBM with the activation stash ------------------
    budget = ctx.hbm_bytes or hbm_capacity_bytes(resolve_device_kind(ctx))
    report["budget_bytes"] = budget
    # parameters charged to the stage of their first consumer
    stage_params = [0] * k
    for v in ctx.variables():
        if v.name in ctx.data_names or v.name in ctx.label_names:
            continue
        shape = shapes.get((id(v), 0))
        if shape is None:
            continue
        consumer = None
        for n in ctx.op_nodes():
            if any(c is v for c, _ci in n.inputs):
                consumer = stage_of.get(n.name)
                break
        if consumer is None:
            continue
        b = _edge_bytes(shape, types.get((id(v), 0)))
        b //= _shard_factor(specs.get((id(v), 0)), mesh_shape)
        mult = 2 if (training and _grad_req_of(ctx, v.name) != "null") \
            else 1                # grad buffer mirrors the param
        stage_params[consumer] += b * mult
    stage_act = [0] * k
    for n in ctx.op_nodes():
        s = stage_of.get(n.name)
        if s is None:
            continue
        shape = shapes.get((id(n), 0))
        if shape is None:
            report["complete"] = False
            continue
        b = _edge_bytes(shape, types.get((id(n), 0)))
        b //= _shard_factor(specs.get((id(n), 0)), mesh_shape)
        stage_act[s] += b
    for s in range(k):
        act_mb = stage_act[s] // m
        stash_1f1b = min(k - s, m)
        report["stage_hbm"].append({
            "index": s, "param_bytes": stage_params[s],
            "act_per_microbatch": act_mb,
            "stash_1f1b": stash_1f1b, "stash_gpipe": m,
            "peak_1f1b": stage_params[s] + act_mb * stash_1f1b,
            "peak_gpipe": stage_params[s] + act_mb * m})
    return report


def _moe_report(ctx):
    """Per-MoE-node routing stats (list, possibly empty)."""
    from ..ops.moe import moe_capacity
    shapes = edge_shapes(ctx)
    out = []
    for n in _moe_nodes(ctx):
        p = n.op.param
        c, ci = n.inputs[0]
        data = shapes.get((id(c), ci))
        tokens = None
        if data is not None and len(data) >= 2:
            tokens = 1
            for d in data[:-1]:
                tokens *= int(d)
        topk = min(int(p.top_k), int(p.num_experts))
        cap = moe_capacity(tokens, p.num_experts, topk,
                           p.capacity_factor) if tokens else 0
        balance = None
        if tokens and cap:
            balanced = tokens * topk / float(p.num_experts)
            balance = min(1.0, cap / balanced) if balanced else None
        out.append({"node": n.name, "num_experts": int(p.num_experts),
                    "top_k": topk,
                    "capacity_factor": float(p.capacity_factor),
                    "tokens": tokens, "capacity": cap,
                    "expert_balance": balance})
    return out


# ----------------------------------------------------------------------
# the MXL-E rules
# ----------------------------------------------------------------------
def _active(ctx):
    return _enabled() and ctx.target == "gpu" and ctx.symbol is not None


def _pipeline_report(ctx):
    if not _active(ctx):
        return None
    rep = schedule_report(ctx)
    if rep is None or rep["partition"] is None:
        return None
    return rep


@register_rule("MXL-E001", "error",
               doc="pipeline stage compute imbalance")
def _rule_e001(ctx):
    rep = _pipeline_report(ctx)
    if rep is None:
        return
    stages = rep["stages"]
    times = [s["time_s"] for s in stages]
    if sum(s["flops"] for s in stages) < MIN_FLOPS:
        return
    bound = STAGE_IMBALANCE
    t_max = max(times)
    t_min = min(t for t in times if t > 0) if any(times) else 0.0
    if not t_min or not t_max:
        return
    if t_max / t_min <= bound:
        return
    worst = stages[times.index(t_max)]
    dom = ", ".join("%s (%s, %.2f TF)" % (d["node"], d["op"],
                                          d["flops"] / 1e12)
                    for d in worst["dominant"]) or "no priced ops"
    ctx.report(None,
               "stage %d (%s) is %.1fx the lightest stage "
               "(%.1f vs %.1f ms per step): every other stage idles "
               "while it runs — dominant ops: %s; rebalance the "
               "%s split (bound %.2fx)"
               % (worst["index"], worst["group"], t_max / t_min,
                  t_max * 1e3, t_min * 1e3, dom,
                  rep["partition"]["mode"], bound))


@register_rule("MXL-E002", "warning",
               doc="pipeline bubble fraction above bound")
def _rule_e002(ctx):
    rep = _pipeline_report(ctx)
    if rep is None:
        return
    if sum(s["flops"] for s in rep["stages"]) < MIN_FLOPS:
        return
    bound = BUBBLE_MAX
    sim = rep["schedules"]["1f1b"]
    if sim["bubble_fraction"] <= bound:
        return
    k = rep["partition"]["k"]
    m = rep["microbatches"]
    xfer = max([e["time_s"] for e in rep["boundaries"]] + [0.0]) / m
    fix = _min_microbatches_for(
        k, [s["t_fwd_s"] / m for s in rep["stages"]],
        [s["t_bwd_s"] / m for s in rep["stages"]], xfer, bound, m + 1)
    ctx.report(None,
               "1F1B bubble fraction %.2f at %d stages x %d "
               "microbatches exceeds %.2f (GPipe: %.2f): devices idle "
               "%d%% of the step — %s (microbatches "
               "MXTPU_LINT_MICROBATCHES)"
               % (sim["bubble_fraction"], k, m, bound,
                  rep["schedules"]["gpipe"]["bubble_fraction"],
                  int(100 * sim["bubble_fraction"]),
                  ("%d microbatches would reach the bound" % fix)
                  if fix else
                  "no microbatch count up to 512 reaches the bound "
                  "(rebalance stages first)"))


@register_rule("MXL-E003", "error",
               doc="cross-stage back-edge: deadlock under 1F1B")
def _rule_e003(ctx):
    rep = _pipeline_report(ctx)
    if rep is None:
        return
    for e in rep["back_edges"]:
        ctx.report(e["dst_node"],
                   "%r (stage %d) consumes %r from LATER stage %d: "
                   "the backward-flowing activation inverts the "
                   "pipeline order — under 1F1B stage %d waits on a "
                   "microbatch stage %d has not produced, a deadlock; "
                   "move the consumer to stage >= %d or cut the edge"
                   % (e["dst_node"], e["dst_stage"], e["src_node"],
                      e["src_stage"], e["dst_stage"], e["src_stage"],
                      e["src_stage"]))


@register_rule("MXL-E004", "error",
               doc="per-stage activation-stash HBM overflow")
def _rule_e004(ctx):
    rep = _pipeline_report(ctx)
    if rep is None or not rep["budget_bytes"]:
        return
    budget = rep["budget_bytes"]
    for h in rep["stage_hbm"]:
        if h["peak_1f1b"] <= budget:
            continue
        ctx.report(None,
                   "stage %d peaks at %s under 1F1B (params+grads %s + "
                   "%d stashed microbatch activations x %s) vs the %s "
                   "per-device budget: the activation stash alone "
                   "overflows HBM — more stages, fewer microbatches in "
                   "flight, or remat the stage"
                   % (h["index"], fmt_bytes(h["peak_1f1b"]),
                      fmt_bytes(h["param_bytes"]), h["stash_1f1b"],
                      fmt_bytes(h["act_per_microbatch"]),
                      fmt_bytes(budget)))


@register_rule("MXL-E005", "warning",
               doc="stage-boundary transfer cannot hide under compute")
def _rule_e005(ctx):
    rep = _pipeline_report(ctx)
    if rep is None:
        return
    stages = rep["stages"]
    if sum(s["flops"] for s in stages) < MIN_FLOPS:
        return
    m = rep["microbatches"]
    ici, link = _link(ctx)
    for e in rep["boundaries"]:
        t = e["time_s"] / m
        adjacent = min(stages[e["src"]]["t_fwd_s"],
                       stages[e["dst"]]["t_fwd_s"]) / m
        if not adjacent or t <= adjacent:
            continue
        ctx.report(None,
                   "stage %d->%d boundary moves %s per microbatch "
                   "(%.2f ms at %s GB/s %s) but the lighter adjacent "
                   "stage computes for only %.2f ms: the transfer "
                   "cannot hide under compute and stretches every "
                   "slot — shrink the boundary tensor (project down "
                   "before the cut) or move the cut"
                   % (e["src"], e["dst"], fmt_bytes(e["bytes"] // m),
                      t * 1e3, "%g" % (ici / 1e9), link,
                      adjacent * 1e3))


def _moe_active(ctx):
    if not _active(ctx):
        return None
    rep = schedule_report(ctx)
    if rep is None or not rep["moe"]:
        return None
    return rep


@register_rule("MXL-E006", "error",
               doc="expert count not divisible by the ep axis")
def _rule_e006(ctx):
    rep = _moe_active(ctx)
    if rep is None:
        return
    mesh_shape = dict(ctx.mesh.shape) if ctx.mesh is not None else {}
    ep = int(mesh_shape.get("ep", 1))
    if ep <= 1:
        return
    for s in rep["moe"]:
        if s["num_experts"] % ep == 0:
            continue
        ctx.report(s["node"],
                   "%d experts do not divide over the ep=%d mesh axis: "
                   "expert-parallel sharding degrades to replicated "
                   "(every rank holds every expert) and the all-to-all "
                   "dispatch is unbalanced by construction — pick a "
                   "multiple of %d experts"
                   % (s["num_experts"], ep, ep))


@register_rule("MXL-E007", "warning",
               doc="capacity factor risks dropping tokens")
def _rule_e007(ctx):
    rep = _moe_active(ctx)
    if rep is None:
        return
    bound = MOE_CAPACITY_MIN
    for s in rep["moe"]:
        cf = s["capacity_factor"]
        if not cf or cf >= bound:
            continue
        ctx.report(s["node"],
                   "capacity_factor %.2f < %.2f: each expert accepts "
                   "%s tokens but a PERFECTLY balanced router sends "
                   "%.0f — tokens are dropped even in the best case "
                   "(only their residual path survives, Switch "
                   "Transformer sec 2.2); raise the factor or accept "
                   "the quality loss deliberately"
                   % (cf, bound,
                      s["capacity"] if s["capacity"] else "?",
                      (s["tokens"] or 0) * s["top_k"]
                      / float(s["num_experts"])))


@register_rule("MXL-E008", "info",
               doc="expert all-to-all priced per rank")
def _rule_e008(ctx):
    rep = _moe_active(ctx)
    if rep is None or ctx.mesh is None:
        return
    mesh_shape = dict(ctx.mesh.shape)
    if int(mesh_shape.get("ep", 1)) <= 1:
        return
    moe_names = {s["node"] for s in rep["moe"]}
    by_node = {}
    for ev in propagate(ctx)["events"]:
        name = getattr(ev["node"], "name", None)
        if ev["kind"] == "alltoall" and name in moe_names:
            e = by_node.setdefault(name, {"bytes": 0, "count": 0})
            e["bytes"] += ev["bytes"]
            e["count"] += 1
    ici, link = _link(ctx)
    replay = ""
    if ctx.world_size and ctx.world_size > 1:
        try:
            from .distributed import collective_trace
            trace = collective_trace(ctx)
            n = sum(1 for t in trace
                    if t.get("kind") == "alltoall"
                    and t.get("name") in moe_names)
            replay = ("; replayed through the MXL-D collective trace "
                      "(%d all-to-all entr%s per rank, order-checked "
                      "across %d ranks)"
                      % (n, "y" if n == 1 else "ies", ctx.world_size))
        except Exception:
            pass
    for name in sorted(by_node):
        e = by_node[name]
        ctx.report(name,
                   "expert all-to-all moves ~%s per rank over %s "
                   "(dispatch + combine, %.2f ms at %g GB/s); an "
                   "imbalanced router turns this into the rank "
                   "divergence MXL-D was built to catch%s"
                   % (fmt_bytes(e["bytes"]), link,
                      (e["bytes"] / ici) * 1e3 if ici else 0.0,
                      (ici or 0.0) / 1e9, replay))
