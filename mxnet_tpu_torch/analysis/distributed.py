"""Graph-level distributed-correctness lint (MXL-D001..D003).

The port of ``mxnet_tpu/analysis/distributed.py``, rule for rule: the
per-rank trace of the collectives a bound graph issues, diffed across
ranks, from graph attributes alone.  The source-level half of the
family (MXL-D004..D006) is ``divergence.py``.

The whole point of binding the symbolic graph to ONE XLA computation
(executor.py) is that every rank runs the identical SPMD program —
collectives pair up across the pod by program position, nothing else.
The moment two ranks issue different collective sequences (different
order, different shapes/axes, or a collective one rank skips) the pod
deadlocks: XLA/ICI rendezvous have no timeouts by default and no way
to re-match out-of-order participants.

This pass simulates the collective trace each rank would issue and
diffs the traces, chip-free:

- the implicit collectives come from the MXL-P sharding propagation
  (``propagation.propagate`` events: psum/allgather/reshard with axes
  and per-device bytes — already in topo order);
- explicit collectives are declared with the ``__collective__`` node
  attr (``"barrier"``, ``"allreduce:dp"``) — the graph-side mirror of
  the runtime seams kvstore marks with ``@collective_seam``;
- rank-conditional execution is declared with the ``__rank_cond__``
  node attr, a small conjunctive grammar (``coordinator``,
  ``noncoordinator``, ``rank==N``, ``rank!=N``, ``rank<N``,
  ``rank<=N``, ``rank>N``, ``rank>=N``, ``rank%K==J``; several
  AND-ed with ``;``), inherited by every downstream node — a consumer
  of a coordinator-only tensor only runs on the coordinator.

Rules (all gated on ``ctx.world_size > 1`` — set ``world_size=`` on
:func:`analyze`/``Symbol.validate``, pass ``--distributed
--world-size N`` to mxlint, or export ``MXTPU_LINT_DISTRIBUTED=1``):

- **MXL-D001** (error) — positional order/kind mismatch between two
  ranks' traces;
- **MXL-D002** (error) — collectives pair up by position but disagree
  on signature (axes / payload bytes / shape);
- **MXL-D003** (error) — a collective issued on a strict subset of
  ranks: the static form of the deadlock a rank-conditional barrier
  produces at runtime.  Unparseable ``__rank_cond__`` specs are also
  reported here (warning severity) and treated as always-true so one
  typo doesn't hide real findings.
"""
from __future__ import annotations

from .core import register_rule
from .propagation import propagate, edge_shapes, edge_types, fmt_bytes

__all__ = ["RANK_COND_ATTR", "COLLECTIVE_ATTR", "parse_rank_cond",
           "node_rank_conds", "collective_trace"]

RANK_COND_ATTR = "__rank_cond__"
COLLECTIVE_ATTR = "__collective__"

# kinds the propagation events carry -> the collective each lowers to
_KIND_NAMES = {"reduce": "allreduce", "gather": "allgather",
               "reshard": "alltoall", "alltoall": "alltoall"}


# ----------------------------------------------------------------------
# __rank_cond__ grammar
# ----------------------------------------------------------------------
def _parse_one(term):
    """One predicate -> callable(rank) -> bool.  Raises ValueError."""
    t = term.strip().replace(" ", "")
    if not t:
        raise ValueError("empty rank condition")
    if t == "coordinator":
        return lambda r: r == 0
    if t == "noncoordinator":
        return lambda r: r != 0
    if t.startswith("rank%"):
        rest = t[len("rank%"):]
        if "==" not in rest:
            raise ValueError("modulo condition needs '==': %r" % term)
        k_s, j_s = rest.split("==", 1)
        k, j = int(k_s), int(j_s)
        if k <= 0:
            raise ValueError("modulo base must be positive: %r" % term)
        return lambda r, k=k, j=j: r % k == j
    for op, fn in (("==", lambda r, n: r == n),
                   ("!=", lambda r, n: r != n),
                   ("<=", lambda r, n: r <= n),
                   (">=", lambda r, n: r >= n),
                   ("<", lambda r, n: r < n),
                   (">", lambda r, n: r > n)):
        if t.startswith("rank" + op):
            n = int(t[len("rank" + op):])
            return lambda r, fn=fn, n=n: fn(r, n)
    raise ValueError("cannot parse rank condition %r" % term)


def parse_rank_cond(spec):
    """``__rank_cond__`` string -> list of predicates (AND-ed).

    Grammar: ``coordinator`` | ``noncoordinator`` | ``rank==N`` |
    ``rank!=N`` | ``rank<N`` | ``rank<=N`` | ``rank>N`` | ``rank>=N``
    | ``rank%K==J``; several terms AND-ed with ``;``.  Raises
    ValueError on any unparseable term.
    """
    return [_parse_one(t) for t in str(spec).split(";") if t.strip()]


def node_rank_conds(ctx):
    """``id(node) -> {cond_spec: origin_node_name}`` with inheritance:
    a node conditioned on ``rank==0`` conditions everything downstream
    of it (its outputs only exist on rank 0).  Bad specs collect into
    ``ctx.cache['rank_cond_errors']`` as ``(node, spec, error)``.
    """
    if "rank_conds" in ctx.cache:
        return ctx.cache["rank_conds"]
    conds = {}
    errors = ctx.cache.setdefault("rank_cond_errors", [])
    for node in ctx.topo:          # already topological: inputs first
        eff = {}
        for inp, _idx in (node.inputs or ()):
            eff.update(conds.get(id(inp), {}))
        own = (node.attrs or {}).get(RANK_COND_ATTR)
        if own:
            try:
                parse_rank_cond(own)
            except ValueError as exc:
                errors.append((node, own, str(exc)))
            else:
                for term in str(own).split(";"):
                    if term.strip():
                        eff.setdefault(term.strip(), node.name)
        conds[id(node)] = eff
    ctx.cache["rank_conds"] = conds
    return conds


def _present_ranks(cond_map, world):
    """Ranks (of ``range(world)``) satisfying every condition."""
    preds = []
    for spec in cond_map:
        try:
            preds.extend(parse_rank_cond(spec))
        except ValueError:
            continue               # reported separately; treat as true
    return frozenset(r for r in range(world)
                     if all(p(r) for p in preds))


# ----------------------------------------------------------------------
# the trace
# ----------------------------------------------------------------------
def collective_trace(ctx):
    """Ordered collectives the bound program will issue, as dicts
    ``{"node", "name", "kind", "sig", "conds", "detail"}``.

    Merges the MXL-P propagation events (implicit collectives XLA
    inserts for the sharding solution) with explicit ``__collective__``
    nodes, in topo-position order; ``sig`` is the cross-rank match
    signature (kind + axes + payload), ``conds`` the inherited
    ``__rank_cond__`` map.
    """
    if "collective_trace" in ctx.cache:
        return ctx.cache["collective_trace"]
    conds = node_rank_conds(ctx)
    order = {id(n): i for i, n in enumerate(ctx.topo)}
    shapes = edge_shapes(ctx)
    types = edge_types(ctx)
    entries = []                   # (topo_idx, sub_order, entry)

    for sub, ev in enumerate(propagate(ctx)["events"]):
        if ev["kind"] not in _KIND_NAMES:
            continue               # degradation notes, not collectives
        node = ev["node"]
        kind = _KIND_NAMES[ev["kind"]]
        axes = tuple(ev.get("axes") or ())
        entry = {
            "node": node, "name": getattr(node, "name", str(node)),
            "kind": kind, "sig": (kind, axes, ev.get("bytes") or 0),
            "conds": conds.get(id(node), {}),
            "detail": "%s over %s (~%s per device)"
                      % (kind, "+".join(axes) or "?",
                         fmt_bytes(ev.get("bytes") or 0)),
        }
        entries.append((order.get(id(node), len(order)), sub, entry))

    for node in ctx.topo:
        spec = (node.attrs or {}).get(COLLECTIVE_ATTR)
        if not spec:
            continue
        kind, _, axes_s = str(spec).partition(":")
        kind = kind.strip() or "barrier"
        axes = tuple(a.strip() for a in axes_s.split(",") if a.strip())
        shape = shapes.get((id(node), 0))
        dtype = types.get((id(node), 0))
        entry = {
            "node": node, "name": node.name, "kind": kind,
            "sig": (kind, axes, shape, str(dtype) if dtype else None),
            "conds": conds.get(id(node), {}),
            "detail": "%s%s at node %s"
                      % (kind, " over " + "+".join(axes) if axes else "",
                         node.name),
        }
        entries.append((order.get(id(node), len(order)), -1, entry))

    entries.sort(key=lambda t: (t[0], t[1]))
    trace = [e for _i, _s, e in entries]
    ctx.cache["collective_trace"] = trace
    return trace


# ----------------------------------------------------------------------
# the per-rank simulation shared by D001..D003
# ----------------------------------------------------------------------
def _ctx_group(node):
    g = (getattr(node, "attrs", None) or {}).get("ctx_group")
    return " [ctx_group=%s]" % g if g else ""


def _simulate(ctx):
    """Diff the per-rank traces; returns findings ``(rule, node,
    message)`` cached in ``ctx.cache['distributed']``."""
    if "distributed" in ctx.cache:
        return ctx.cache["distributed"]
    findings = []
    ctx.cache["distributed"] = findings
    world = ctx.world_size or 0
    if world <= 1 or ctx.symbol is None:
        return findings

    trace = collective_trace(ctx)
    for node, spec, err in ctx.cache.get("rank_cond_errors", ()):
        findings.append((
            "MXL-D003", node, "warning",
            "unparseable %s=%r (%s): treating the node as running on "
            "every rank, which may hide a real divergence"
            % (RANK_COND_ATTR, spec, err)))
    if not trace:
        return findings

    present = [_present_ranks(ev["conds"], world) for ev in trace]
    full = frozenset(range(world))
    if all(p == full for p in present):
        return findings

    lengths = {r: sum(1 for p in present if r in p) for r in full}
    if len(set(lengths.values())) > 1:
        # some rank issues fewer collectives: every partially-present
        # event is a rendezvous a subset of the pod never joins
        seen = set()
        for ev, p in zip(trace, present):
            if p == full or ev["name"] in seen:
                continue
            seen.add(ev["name"])
            origin = ", ".join(sorted(
                "%s (from node %s)" % (c, o)
                for c, o in ev["conds"].items())) or "none"
            if p:
                who = "only rank%s %s of %d" % (
                    "" if len(p) == 1 else "s",
                    ",".join(str(r) for r in sorted(p)), world)
            else:
                who = "NO rank at world size %d" % world
            findings.append((
                "MXL-D003", ev["node"], None,
                "collective %s%s is issued on %s (%s: %s): the "
                "remaining ranks never join the rendezvous and the "
                "pod deadlocks — hoist the collective out of the "
                "rank-conditional region or run it on every rank"
                % (ev["detail"], _ctx_group(ev["node"]), who,
                   RANK_COND_ATTR, origin)))
        return findings

    # equal counts: pair traces positionally against rank 0 and diff
    per_rank = {r: [ev for ev, p in zip(trace, present) if r in p]
                for r in full}
    ref = per_rank[0]
    seen = set()                   # one finding per program position
    for r in sorted(full - {0}):
        for pos, (a, b) in enumerate(zip(ref, per_rank[r])):
            if a is b or pos in seen:
                continue
            seen.add(pos)
            if a["kind"] != b["kind"]:
                findings.append((
                    "MXL-D001", a["node"], None,
                    "collective order diverges across ranks: at "
                    "position %d rank 0 issues %s%s while rank %d "
                    "issues %s%s — XLA pairs collectives by program "
                    "position, so the pod deadlocks (or silently "
                    "mixes payloads)"
                    % (pos, a["detail"], _ctx_group(a["node"]), r,
                       b["detail"], _ctx_group(b["node"]))))
                break
            findings.append((
                "MXL-D002", a["node"], None,
                "collective signature diverges across ranks: at "
                "position %d rank 0 issues %s but rank %d issues %s "
                "— mismatched axes/payload in one rendezvous is "
                "undefined behavior on ICI"
                % (pos, a["detail"], r, b["detail"])))
            break
    return findings


def _report(ctx, rule):
    for rid, node, severity, message in _simulate(ctx):
        if rid == rule:
            ctx.report(node, message, severity=severity)


@register_rule("MXL-D001", "error",
               "collective order mismatch across ranks")
def collective_order_mismatch(ctx):
    """Two ranks issue different collective sequences: deadlock."""
    _report(ctx, "MXL-D001")


@register_rule("MXL-D002", "error",
               "collective signature mismatch across ranks")
def collective_signature_mismatch(ctx):
    """Collectives pair by position but disagree on axes/payload."""
    _report(ctx, "MXL-D002")


@register_rule("MXL-D003", "error",
               "collective under rank-conditional control flow")
def collective_rank_conditional(ctx):
    """A collective a strict subset of ranks issues: static deadlock."""
    _report(ctx, "MXL-D003")
