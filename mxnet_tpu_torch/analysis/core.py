"""Core types for the static graph analyzer.

The port of ``mxnet_tpu/analysis/core.py``.  The reference front-loaded
graph mistakes at bind time: GraphExecutor ran full shape/type inference
(static_graph.cc:59 InferNodeShapes) and refused to bind an inconsistent
graph.  The port's executor walks the graph eagerly (executor.py), so a
bad graph would otherwise die deep inside the first forward or, worse,
run silently wrong.  This package restores the bind-time safety net as
an extensible pass framework:

- :class:`GraphIssue` — one finding (rule id, severity, node, message);
- :func:`register_rule` — decorator adding a pass to ``RULE_REGISTRY``;
- :class:`AnalysisContext` — everything a pass may inspect: the symbol,
  its topo order, optional shape/type hints, bind-time arguments
  (args/args_grad/grad_req/aux), device/mesh/sharding info, and the raw
  JSON graph when linting a saved file (the only place dead nodes can
  still exist: an in-memory Symbol only ever sees nodes reachable from
  its heads);
- :func:`run_rules` — execute passes and collect issues, most severe
  first.

Per-node suppression rides on node attrs (the same channel as
``ctx_group``/``lr_mult``): ``__lint_ignore__="MXL-G003,MXL-L003"`` or
``"all"`` mutes matching rules for that node.  Graph-level issues
(``node is None``) cannot be attr-suppressed; select rules instead.
"""
from __future__ import annotations

import fnmatch
from collections import OrderedDict

__all__ = ["GraphIssue", "AnalysisContext", "Rule", "RULE_REGISTRY",
           "register_rule", "run_rules", "format_issues",
           "SEVERITIES", "SEVERITY_RANK"]

SEVERITIES = ("info", "warning", "error")
SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITIES)}

SUPPRESS_ATTR = "__lint_ignore__"


class GraphIssue(object):
    """One analyzer finding.

    ``node`` is the node *name* (issues outlive the graph object: the CLI
    serializes them) or None for graph-level findings.  ``anchor`` is an
    optional stable source location, ``file:qualname`` (never a raw line
    number, so ``mxlint --baseline`` records survive unrelated edits);
    ``line`` is the volatile line number kept OUT of the identity-ish
    fields — display/CI-annotation data only.
    """

    __slots__ = ("rule_id", "severity", "node", "message", "anchor",
                 "line")

    def __init__(self, rule_id, severity, node, message, anchor=None,
                 line=None):
        if severity not in SEVERITY_RANK:
            raise ValueError("bad severity %r (valid: %s)"
                             % (severity, SEVERITIES))
        self.rule_id = rule_id
        self.severity = severity
        self.node = node
        self.message = message
        self.anchor = anchor
        self.line = line

    def as_dict(self):
        out = {"rule_id": self.rule_id, "severity": self.severity,
               "node": self.node, "message": self.message}
        if self.anchor is not None:
            out["anchor"] = self.anchor
        if self.line is not None:
            out["line"] = self.line
        return out

    def __repr__(self):
        where = ("@%s" % (self.anchor or self.node)) if \
            (self.anchor or self.node) else "@graph"
        return "[%s] %s %s: %s" % (self.rule_id, self.severity, where,
                                   self.message)

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, GraphIssue) and \
            (self.rule_id, self.severity, self.node, self.message,
             self.anchor) == \
            (other.rule_id, other.severity, other.node, other.message,
             other.anchor)

    def __hash__(self):
        return hash((self.rule_id, self.severity, self.node, self.message,
                     self.anchor))


class Rule(object):
    """A registered pass: ``fn(ctx)`` yields/returns GraphIssues."""

    __slots__ = ("rule_id", "severity", "doc", "fn")

    def __init__(self, rule_id, severity, doc, fn):
        self.rule_id = rule_id
        self.severity = severity
        self.doc = doc
        self.fn = fn


RULE_REGISTRY = OrderedDict()   # rule_id -> Rule


def register_rule(rule_id, severity="warning", doc=None):
    """Decorator: register ``fn(ctx)`` under ``rule_id``.

    ``severity`` is the rule's default; a pass may override per issue via
    ``ctx.report(..., severity=...)``.
    """
    if severity not in SEVERITY_RANK:
        raise ValueError("bad severity %r" % severity)

    def _wrap(fn):
        if rule_id in RULE_REGISTRY:
            raise ValueError("rule %s already registered" % rule_id)
        RULE_REGISTRY[rule_id] = Rule(rule_id, severity,
                                      doc or (fn.__doc__ or "").strip(), fn)
        return fn
    return _wrap


class AnalysisContext(object):
    """Everything a lint pass may inspect.

    Built once per :func:`analyze` call; passes must treat it read-only
    except through :meth:`report`.
    """

    def __init__(self, symbol, shapes=None, type_dict=None, args=None,
                 args_grad=None, grad_req=None, aux_states=None,
                 group2ctx=None, mesh=None, sharding_rules=None,
                 target="gpu", json_graph=None, kvstore=None,
                 hbm_bytes=None, data_names=None, label_names=None,
                 compute_dtype=None, device_kind=None, world_size=None,
                 source_paths=None):
        self.symbol = symbol
        self.shapes = dict(shapes or {})        # arg name -> shape tuple
        self.type_dict = dict(type_dict or {})  # arg name -> dtype
        self.args = args                        # bind args (dict|list|None)
        self.args_grad = args_grad
        self.grad_req = grad_req
        self.aux_states = aux_states
        self.group2ctx = group2ctx
        self.mesh = mesh
        self.sharding_rules = sharding_rules
        self.target = target
        self.json_graph = json_graph            # raw dict of a saved symbol
        self.kvstore = kvstore                  # kvstore type str (MXL-C001)
        self.hbm_bytes = hbm_bytes              # per-device budget (MXL-M001)
        # roofline context (MXL-R): the dtype matmuls run at (None ->
        # float32, the trainer's default) and the card whose peaks set
        # the ridge
        self.compute_dtype = compute_dtype
        self.device_kind = device_kind
        # which variables are batch tensors (batch_pspec) vs parameters
        # (param_pspec) when seeding the SPMD propagation — mirrors the
        # ShardedTrainer's data/label split
        self.data_names = tuple(data_names) if data_names else ("data",)
        self.label_names = (tuple(label_names) if label_names
                            else ("softmax_label",))
        # distributed-lint context (MXL-D): the pod size the per-rank
        # collective-trace simulation runs at (None/<=1 disables
        # MXL-D001..003), and the .py files the rank-divergence
        # dataflow pass (MXL-D004..006) scans.  MXTPU_LINT_DISTRIBUTED
        # turns the family on for whole runs (bind-time included);
        # MXTPU_LINT_WORLD_SIZE sets the simulated pod size (default 4).
        if world_size is None:
            import os as _os
            if _os.environ.get("MXTPU_LINT_DISTRIBUTED", "").lower() in \
                    ("1", "true", "yes", "on"):
                try:
                    world_size = int(
                        _os.environ.get("MXTPU_LINT_WORLD_SIZE") or 4)
                except ValueError:
                    world_size = 4
        self.world_size = world_size
        self.source_paths = list(source_paths) if source_paths else []
        self.topo = symbol._topo() if symbol is not None else []
        self.cache = {}                         # cross-pass memo (propagation)
        self._rule = None                       # set by run_rules
        self._issues = []

    # -- reporting ---------------------------------------------------------
    def report(self, node, message, severity=None, rule_id=None,
               anchor=None, line=None):
        """Record one issue against ``node`` (a _Node, a name, or None).

        ``anchor``/``line`` attach a stable ``file:qualname`` source
        location (plus the volatile line, for display/CI annotations) —
        used by the source-level MXL-D passes."""
        rule = RULE_REGISTRY.get(rule_id or self._rule)
        rid = rule.rule_id if rule else (rule_id or self._rule)
        sev = severity or (rule.severity if rule else "warning")
        name = getattr(node, "name", node)
        if node is not None and self._suppressed(node, rid):
            return None
        issue = GraphIssue(rid, sev, name, message, anchor=anchor,
                           line=line)
        self._issues.append(issue)
        return issue

    def _suppressed(self, node, rule_id):
        attrs = getattr(node, "attrs", None)
        if attrs is None:       # reported by name: look the node up
            node = self._node_by_name(node)
            attrs = getattr(node, "attrs", None)
        if not attrs:
            return False
        spec = attrs.get(SUPPRESS_ATTR, "")
        if not spec:
            return False
        ids = {s.strip() for s in str(spec).split(",") if s.strip()}
        return "all" in ids or rule_id in ids

    def _node_by_name(self, name):
        for n in self.topo:
            if n.name == name:
                return n
        return None

    # -- graph helpers shared by passes ------------------------------------
    def op_nodes(self):
        return [n for n in self.topo if not n.is_variable]

    def variables(self):
        return [n for n in self.topo if n.is_variable]


def _matches(rule_id, patterns):
    """True when any pattern matches: exact ids and fnmatch wildcards
    (``MXL-P*``) both work."""
    return any(fnmatch.fnmatchcase(rule_id, p) for p in patterns)


def run_rules(ctx, select=None, skip=None):
    """Run registered passes over ``ctx``; returns issues, errors first.

    ``select``/``skip`` are iterables of rule ids — or fnmatch-style
    wildcards like ``MXL-P*`` — filtering which passes run (select wins
    over skip when both name a rule).
    """
    select = list(select) if select is not None else None
    skip = list(skip or ())
    for rule_id, rule in RULE_REGISTRY.items():
        if select is not None and not _matches(rule_id, select):
            continue
        if select is None and _matches(rule_id, skip):
            continue
        ctx._rule = rule_id
        try:
            out = rule.fn(ctx)
            if out:              # generators / explicit lists both work
                for issue in out:
                    if isinstance(issue, GraphIssue):
                        ctx._issues.append(issue)
        finally:
            ctx._rule = None
    issues = ctx._issues
    issues.sort(key=lambda i: (-SEVERITY_RANK[i.severity], i.rule_id,
                               i.anchor or "", i.node or "", i.line or 0))
    return issues


def format_issues(issues):
    """Human-readable one-line-per-issue block (the CLI's text mode)."""
    if not issues:
        return "no issues"
    return "\n".join(str(i) for i in issues)
