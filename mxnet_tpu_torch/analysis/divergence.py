"""Rank-divergence dataflow lint over the framework's own source
(rule family MXL-D004..D006).

The port of ``mxnet_tpu/analysis/divergence.py``.  Every distributed
bug that reached review in the JAX package was a *rank-divergence* bug
— a pid-dependent checkpoint scratch path, a per-rank
barrier-implementation probe that could split the pod, a device-0-only
grad-norm sentinel — and none of the graph-level MXL families can see
them, because they live in the Python runtime around the graph (trainer
loops, kvstore, resilience/, observability), not in the graph itself.
This pass is a lightweight intraprocedural taint analysis over that
Python source:

- **Sources** (values that may differ across ranks): ``os.getpid``,
  wall/monotonic clocks, unseeded ``random``/``np.random``, hostname,
  ``uuid1/uuid4``, per-process temp paths, ``jax.process_index()`` /
  names and attributes called ``rank``, per-process device views
  (``.addressable_data(...)``), and anything assigned on an exception
  edge (whether an exception fires is rank-local).  The torch
  counterparts sit beside them: ``torch.distributed.get_rank()`` /
  ``dist.get_rank(group)``, ``torch.cuda.current_device()`` (this
  process's card), and environment reads of ``RANK`` / ``LOCAL_RANK``
  (torchrun's) and ``MXTPU_WORKER_RANK`` (``tools/launch.py``'s), through
  ``os.environ[...]``, ``os.environ.get`` or ``os.getenv``.
- **Sinks**: coordinated checkpoint paths (``ocp_save`` & friends, and
  the port's ``host_save``/``host_restore`` — MXL-D004, error),
  collective call conditions / loop trip counts / early exits ahead of a
  collective (MXL-D005, error), and exception edges that can exit
  between paired collectives or swallow a failing collective on one
  rank (MXL-D006, warning).  The collectives are the JAX names plus
  ``torch.distributed``'s (``broadcast``, ``reduce_scatter_tensor``,
  ``all_gather_into_tensor``, ``all_to_all_single``, ``new_group``,
  ``monitored_barrier``; the point-to-point ``send``/``recv``/
  ``isend``/``irecv`` and ``gather``/``scatter``/``reduce`` only on a
  ``dist``/``torch.distributed`` receiver, where the bare names would
  catch sockets and ``functools.reduce``) and the port's own
  ``parallel/collectives`` entry points.

Two markers make intent explicit:

- ``@collective_seam`` (``mxnet_tpu_torch.base.collective_seam``)
  declares a function a cluster-wide rendezvous/agreement protocol:
  calls to it are collective sinks, its *return value* is certified
  rank-uniform (the protocol's whole point — e.g. a verdict rank 0
  publishes through the coordination KV), and the intentional
  rank-asymmetry inside its body is exempt from MXL-D005.
- ``# mxl: rank-divergent-ok`` (optionally ``(MXL-D005,...)``) on the
  finding line, the line above it, or the enclosing ``def`` line
  suppresses matching findings — the comment IS the review record for
  why the divergence is safe.

Findings carry a stable ``file:qualname`` anchor (plus the volatile
line for CI annotations) so ``mxlint --baseline`` records survive
unrelated edits.  The analysis never imports or executes the scanned
files — pure ``ast``, so fixtures snapshotting old bugs are safe to
keep in-tree.  The JAX vocabulary is kept whole, so a file lints the
same through both packages unless it uses a torch name.

Deliberately NOT tainted: ``jax.process_count()`` and
``torch.distributed.get_world_size()`` (uniform), filesystem predicates
and listings (shared-filesystem reads are how ``latest_step``
legitimately agrees), and coordination-KV reads
(``blocking_key_value_get`` is how verdicts are *shared*, not where
they diverge).
"""
from __future__ import annotations

import ast
import os
import re

from .core import register_rule

__all__ = ["collective_seam", "analyze_source_paths", "iter_py_files",
           "SUPPRESS_RE"]

# re-exported so `from mxnet_tpu_torch.analysis.divergence import
# collective_seam` works; the canonical home is base.py (a leaf module
# the annotated subsystems can import without cycles)
from ..base import collective_seam  # noqa: E402,F401


# ----------------------------------------------------------------------
# vocabulary
# ----------------------------------------------------------------------
# terminal call names whose result differs across ranks
_SOURCE_CALLS = {
    "getpid": "os.getpid()",
    "getppid": "os.getppid()",
    "gethostname": "the hostname",
    "mkdtemp": "a per-process temp path",
    "mkstemp": "a per-process temp path",
    "mktemp": "a per-process temp path",
    "NamedTemporaryFile": "a per-process temp file",
    "TemporaryDirectory": "a per-process temp path",
    "uuid1": "uuid1()",
    "uuid4": "uuid4()",
    "process_index": "jax.process_index()",
    "addressable_data": "a per-process device shard "
                        "(.addressable_data: this rank's local view, "
                        "not the global value)",
    "get_rank": "torch.distributed.get_rank()",
    "current_device": "torch.cuda.current_device() (this process's card)",
}
# environment variables whose value is the rank: torchrun's, and the one
# ``tools/launch.py`` sets for each worker
_RANK_ENV = {"RANK", "LOCAL_RANK", "MXTPU_WORKER_RANK"}
# clock calls: unqualified names that are only divergent when they hang
# off a time-ish module (`time.time`, `_time.monotonic`, ...)
_CLOCK_CALLS = {"time", "monotonic", "perf_counter", "time_ns", "clock"}
# names/attributes whose *value* is the rank
_RANK_NAMES = {"rank", "process_index", "worker_rank", "local_rank"}

# collective sinks: every rank must reach these together.  Terminal call
# name matching (`client.wait_at_barrier` -> `wait_at_barrier`).
_COLLECTIVE_CALLS = {
    "global_barrier", "wait_at_barrier", "sync_global_devices",
    "barrier", "_barrier", "psum", "pmean", "pmax", "pmin",
    "all_gather", "all_reduce", "allreduce", "_allreduce",
    "_allreduce_dist", "_collective_sum", "_kv_allreduce",
    "ppermute", "all_to_all", "pbroadcast",
    # torch.distributed, and parallel/collectives' entry points
    "broadcast", "reduce_scatter_tensor", "all_gather_into_tensor",
    "all_to_all_single", "new_group", "monitored_barrier",
    "reduce_scatter", "all_reduce_autograd", "all_to_all_autograd",
}
# torch.distributed names that are collectives only on a dist receiver
# (``dist.recv``, ``torch.distributed.reduce``): bare, they are socket
# calls and functools.reduce
_DIST_COLLECTIVE_CALLS = {"send", "recv", "isend", "irecv", "gather",
                          "scatter", "reduce", "all_gather_object",
                          "broadcast_object_list", "gather_object",
                          "scatter_object_list"}
_DIST_RECEIVERS = {"dist", "distributed", "_dist"}
# coordinated-path sinks: multi-host protocols that hand every rank the
# SAME path/target (orbax coordinated saves strand shards otherwise)
_COORDINATED_CALLS = {
    "ocp_save": "the coordinated multi-host checkpoint save",
    "ocp_restore": "the coordinated multi-host checkpoint restore",
    "save_checkpoint_versioned": "the versioned checkpoint protocol",
    "auto_resume": "the coordinated checkpoint resume",
    "CheckpointManager": "the checkpoint manager's shared directory",
    "save_checkpoint": "the classic checkpoint writer",
    "load_checkpoint": "the classic checkpoint reader",
    "host_save": "the coordinated host-format checkpoint save",
    "host_restore": "the coordinated host-format checkpoint restore",
}

SUPPRESS_RE = re.compile(
    r"#\s*mxl:\s*rank-divergent-ok(?:\s*\(([^)]*)\))?")

_SEAM_DECORATOR = "collective_seam"


def iter_py_files(paths):
    """Expand files/directories into a sorted list of .py files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


# ----------------------------------------------------------------------
# AST helpers
# ----------------------------------------------------------------------
def _dotted(node):
    """Best-effort dotted name of an expression (``a.b.c``), else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:
        return ".".join(reversed(parts))
    return None


def _call_name(call):
    """Terminal name of a call's callee (``client.wait_at_barrier`` ->
    ``wait_at_barrier``)."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _dist_collective(call):
    """``dist.recv(...)``-style call: a torch.distributed collective whose
    bare name is ambiguous; its name, else None."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _DIST_COLLECTIVE_CALLS:
        recv = _dotted(fn.value) or ""
        if recv.rsplit(".", 1)[-1] in _DIST_RECEIVERS:
            return fn.attr
    return None


def _rank_env_read(node):
    """``os.environ["RANK"]`` / ``os.environ.get("LOCAL_RANK")`` /
    ``os.getenv("RANK")``: the variable's name, else None."""
    key = None
    if isinstance(node, ast.Subscript) and \
            (_dotted(node.value) or "").endswith("environ"):
        key = node.slice
    elif isinstance(node, ast.Call) and node.args:
        dotted = _dotted(node.func) or ""
        if dotted.endswith("environ.get") or dotted.endswith("getenv"):
            key = node.args[0]
    if isinstance(key, ast.Constant) and key.value in _RANK_ENV:
        return key.value
    return None


def _decorator_names(fn):
    return {d for d in
            (_call_name(dec) if isinstance(dec, ast.Call)
             else (dec.attr if isinstance(dec, ast.Attribute)
                   else (dec.id if isinstance(dec, ast.Name) else None))
             for dec in fn.decorator_list)
            if d}


def _suppressions(source):
    """line -> set of rule ids (or {'all'}) from rank-divergent-ok
    marker comments."""
    out = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in (m.group(1) or "").split(",")
               if s.strip()}
        out[i] = ids or {"all"}
    return out


_TAINT_NODES = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.NamedExpr,
                ast.For, ast.withitem, ast.ExceptHandler, ast.Return)


def _walk_list(node):
    """The nodes of ``ast.walk(node)`` that bind a name or return, in walk
    order, kept on the node: the taint fixpoint and the divergent-returner
    rounds walk each function many times, and a tree is parsed anew for
    every analysis, so the list never goes stale."""
    got = getattr(node, "_mxl_walk", None)
    if got is None:
        got = [n for n in ast.walk(node) if isinstance(n, _TAINT_NODES)]
        node._mxl_walk = got
    return got


class _GlobalInfo(object):
    """Cross-file facts the per-function pass consumes."""

    def __init__(self):
        self.seams = set(_COLLECTIVE_CALLS)   # seam fns are sinks too
        self.seam_defs = set()                # names defined @collective_seam
        self.divergent_fns = {}               # fn name -> taint reason


# ----------------------------------------------------------------------
# the per-function taint + findings engine
# ----------------------------------------------------------------------
class _FunctionPass(object):
    """Intraprocedural, flow-insensitive taint over one function (nested
    defs walked inline: the closure style here invokes them in place)."""

    def __init__(self, fn_node, qualname, ginfo, is_seam):
        self.fn = fn_node
        self.qualname = qualname
        self.ginfo = ginfo
        self.is_seam = is_seam
        self.tainted = {}          # name -> human reason
        self.findings = []         # (rule, line, message)
        self.collectives = []      # (line, call name)
        self.exits = []            # (line, kind, taint reason|None)
        self.return_taint = None   # reason when a return value is tainted

    # -- taint of an expression -------------------------------------------
    def taint(self, node):
        """Reason string when ``node`` may differ across ranks, else
        None."""
        if node is None:
            return None
        if isinstance(node, ast.Name):
            if node.id in self.tainted:
                return self.tainted[node.id]
            if node.id in _RANK_NAMES:
                return "the rank (%r)" % node.id
            return None
        if isinstance(node, ast.Attribute):
            if node.attr in _RANK_NAMES:
                return "the rank (.%s)" % node.attr
            return self.taint(node.value)
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                r = self.taint(v)
                if r:
                    return r
            return None
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) or self.taint(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.Compare):
            r = self.taint(node.left)
            if r:
                return r
            for c in node.comparators:
                r = self.taint(c)
                if r:
                    return r
            return None
        if isinstance(node, ast.IfExp):
            return (self.taint(node.test) or self.taint(node.body)
                    or self.taint(node.orelse))
        if isinstance(node, ast.Subscript):
            env = _rank_env_read(node)
            if env:
                return "the rank (environment %s)" % env
            return self.taint(node.value) or self.taint(node.slice)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                r = self.taint(e)
                if r:
                    return r
            return None
        if isinstance(node, ast.Dict):
            for e in list(node.keys) + list(node.values):
                r = self.taint(e)
                if r:
                    return r
            return None
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                r = self.taint(v)
                if r:
                    return r
            return None
        if isinstance(node, ast.FormattedValue):
            return self.taint(node.value)
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        return None

    def _call_taint(self, call):
        name = _call_name(call)
        dotted = _dotted(call.func) or (name or "")
        segs = dotted.split(".")
        if name in _SOURCE_CALLS:
            return _SOURCE_CALLS[name]
        env = _rank_env_read(call)
        if env:
            return "the rank (environment %s)" % env
        if name in _CLOCK_CALLS and len(segs) > 1 and \
                "time" in segs[-2].lower():
            return "the local clock (%s)" % dotted
        if name in ("now", "utcnow") and any(
                "datetime" in s.lower() for s in segs[:-1]):
            return "the local clock (%s)" % dotted
        if any(s in ("random",) for s in segs[:-1]) or name == "random":
            # unseeded RNG state diverges; explicitly-seeded constructors
            # (RandomState(7), default_rng(seed)) are rank-uniform
            if name in ("RandomState", "default_rng", "Generator",
                        "PRNGKey", "seed") and (call.args or
                                                call.keywords):
                pass
            else:
                return "unseeded random state (%s)" % dotted
        if name in self.ginfo.seam_defs:
            return None     # seam contract: return is rank-uniform
        if name in self.ginfo.divergent_fns:
            return "%s() (returns %s)" % (
                name, self.ginfo.divergent_fns[name])
        # unknown call: propagates taint from its operands (str(rank),
        # os.path.join(root, piddir), "%s" % rank, tainted.method())
        if isinstance(call.func, ast.Attribute):
            r = self.taint(call.func.value)
            if r:
                return r
        for a in call.args:
            r = self.taint(a)
            if r:
                return r
        for k in call.keywords:
            r = self.taint(k.value)
            if r:
                return r
        return None

    # -- phase 1: fixpoint taint collection --------------------------------
    def collect_taint(self):
        args = self.fn.args if hasattr(self.fn, "args") else None
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                if a.arg in _RANK_NAMES:
                    self.tainted[a.arg] = "the rank parameter %r" % a.arg
        for _ in range(8):
            changed = False
            for node in _walk_list(self.fn):
                targets, value, reason = (), None, None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.NamedExpr):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    targets, value = [node.target], node.iter
                elif isinstance(node, ast.withitem) and \
                        node.optional_vars is not None:
                    targets, value = [node.optional_vars], \
                        node.context_expr
                elif isinstance(node, ast.ExceptHandler):
                    # whether an exception fired is rank-local: the
                    # bound name and everything assigned in the handler
                    # body is divergent
                    reason = ("an exception edge (whether the exception "
                              "fires is rank-local)")
                    names = set()
                    if node.name:
                        names.add(node.name)
                    for sub in ast.walk(node):
                        if isinstance(sub, (ast.Assign, ast.AugAssign)):
                            tg = sub.targets if isinstance(
                                sub, ast.Assign) else [sub.target]
                            for t in tg:
                                names.update(self._target_names(t))
                    for n in names:
                        if n not in self.tainted:
                            self.tainted[n] = reason
                            changed = True
                    continue
                else:
                    continue
                reason = self.taint(value)
                if not reason:
                    continue
                for t in targets:
                    for n in self._target_names(t):
                        if n not in self.tainted:
                            self.tainted[n] = reason
                            changed = True
            if not changed:
                break
        # a function returning a tainted expression spreads divergence
        # to its callers (``_is_coordinator`` returning
        # ``jax.process_index() == 0``)
        for node in _walk_list(self.fn):
            if isinstance(node, ast.Return) and node.value is not None:
                r = self.taint(node.value)
                if r:
                    self.return_taint = r
                    break

    @staticmethod
    def _target_names(t):
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out = []
            for e in t.elts:
                out.extend(_FunctionPass._target_names(e))
            return out
        if isinstance(t, ast.Starred):
            return _FunctionPass._target_names(t.value)
        if isinstance(t, ast.Subscript):
            # _STATE["flag"] = ...  taints the container name
            return _FunctionPass._target_names(t.value)
        return []

    # -- phase 2: findings over the statement tree -------------------------
    def run(self):
        self.collect_taint()
        body = self.fn.body if hasattr(self.fn, "body") else []
        self._visit_stmts(body, conds=[], swallow=None)
        self._pair_exits()
        return self.findings

    def _visit_stmts(self, stmts, conds, swallow):
        for stmt in stmts:
            self._visit_stmt(stmt, conds, swallow)

    def _visit_stmt(self, stmt, conds, swallow):
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, conds, swallow)
            reason = self.taint(stmt.test)
            inner = conds + ([(stmt.test, reason)] if reason else [])
            self._visit_stmts(stmt.body, inner, swallow)
            self._visit_stmts(stmt.orelse, inner, swallow)
        elif isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, conds, swallow)
            reason = self.taint(stmt.test)
            inner = conds + ([(stmt.test, reason)] if reason else [])
            self._visit_stmts(stmt.body, inner, swallow)
            self._visit_stmts(stmt.orelse, inner, swallow)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, conds, swallow)
            reason = self.taint(stmt.iter)
            if reason:
                reason = ("a loop over a rank-divergent iterable "
                          "(trip count tainted by %s)" % reason)
            inner = conds + ([(stmt.iter, reason)] if reason else [])
            self._visit_stmts(stmt.body, inner, swallow)
            self._visit_stmts(stmt.orelse, inner, swallow)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr, conds, swallow)
            self._visit_stmts(stmt.body, conds, swallow)
        elif isinstance(stmt, ast.Try):
            swallows = self._swallowing_handler(stmt)
            inner_swallow = (stmt, swallows) if swallows else swallow
            self._visit_stmts(stmt.body, conds, inner_swallow)
            self._visit_stmts(stmt.orelse, conds, inner_swallow)
            for h in stmt.handlers:
                self._visit_stmts(h.body, conds, swallow)
            self._visit_stmts(stmt.finalbody, conds, swallow)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs analyzed inline: the closures here
            # (kvstore.barrier's _sync, heartbeat's _beat) run in place
            self._visit_stmts(stmt.body, conds, swallow)
        elif isinstance(stmt, ast.Return):
            self._scan_expr(stmt.value, conds, swallow)
            reason = next((r for _e, r in conds if r), None)
            self.exits.append((stmt.lineno, "return", reason))
        elif isinstance(stmt, ast.Raise):
            self._scan_expr(stmt.exc, conds, swallow)
            reason = next((r for _e, r in conds if r), None)
            self.exits.append((stmt.lineno, "raise", reason))
        elif isinstance(stmt, ast.ClassDef):
            pass    # handled by the file walker
        else:
            self._scan_expr(stmt, conds, swallow)

    @staticmethod
    def _swallowing_handler(try_stmt):
        """True when some handler continues past the exception (no
        re-raise anywhere in its body)."""
        for h in try_stmt.handlers:
            if not any(isinstance(n, ast.Raise) for n in ast.walk(h)):
                return True
        return False

    def _scan_expr(self, node, conds, swallow):
        """Find sink calls inside one statement/expression subtree
        (compound statements dispatch their bodies separately)."""
        if node is None:
            return
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _call_name(sub)
            if name in self.ginfo.seams:
                self._collective_hit(sub, name, conds, swallow)
            elif _dist_collective(sub):
                self._collective_hit(sub, name, conds, swallow)
            if name in _COORDINATED_CALLS:
                self._coordinated_hit(sub, name)

    def _collective_hit(self, call, name, conds, swallow):
        line = call.lineno
        self.collectives.append((line, name))
        tainted = [(e, r) for e, r in conds if r]
        if tainted and not self.is_seam:
            _expr, reason = tainted[0]
            self.findings.append((
                "MXL-D005", line,
                "collective %s() is gated on rank-divergent control "
                "flow (condition tainted by %s): ranks that take the "
                "other path never join it and the pod deadlocks"
                % (name, reason)))
        if swallow is not None:
            try_stmt, _ = swallow
            self.findings.append((
                "MXL-D006", line,
                "collective %s() runs inside a try whose handler "
                "swallows the exception: a rank where it raises "
                "continues past the rendezvous while its peers are "
                "still waiting in it (unbalanced collective on an "
                "exception edge)" % name))

    def _coordinated_hit(self, call, name):
        for arg in list(call.args) + [k.value for k in call.keywords]:
            reason = self.taint(arg)
            if reason:
                self.findings.append((
                    "MXL-D004", call.lineno,
                    "rank-divergent value (tainted by %s) flows into "
                    "%s() — %s needs the IDENTICAL argument on every "
                    "rank, or shards land in per-rank locations the "
                    "commit protocol never sees"
                    % (reason, name, _COORDINATED_CALLS[name])))
                return

    def _pair_exits(self):
        """Rank-divergent early exits vs. the function's collectives:
        an exit BEFORE any collective means some ranks never join it
        (D005); an exit BETWEEN two collectives leaves the pair
        unbalanced (D006)."""
        if not self.collectives:
            return
        lines = sorted(l for l, _ in self.collectives)
        by_line = dict(self.collectives)
        for line, kind, reason in self.exits:
            if reason is None or line in by_line:
                # an exit on a collective's own line (`return psum(x)`)
                # already reported through the call-site check
                continue
            later = [l for l in lines if l > line]
            earlier = [l for l in lines if l < line]
            if not later:
                continue
            nxt = by_line[later[0]]
            if earlier and not self.is_seam:
                self.findings.append((
                    "MXL-D006", line,
                    "rank-divergent %s (condition tainted by %s) exits "
                    "between paired collectives (%s() behind it, %s() "
                    "ahead): ranks taking it complete the first "
                    "rendezvous but never the second"
                    % (kind, reason, by_line[earlier[-1]], nxt)))
            elif not self.is_seam:
                self.findings.append((
                    "MXL-D005", line,
                    "rank-divergent early %s (condition tainted by %s) "
                    "ahead of collective %s(): ranks taking it never "
                    "join the rendezvous — decide skip-verdicts "
                    "globally (accumulate every shard / publish rank "
                    "0's verdict), not from rank-local state"
                    % (kind, reason, nxt)))


# ----------------------------------------------------------------------
# file + file-set drivers
# ----------------------------------------------------------------------
def _iter_functions(tree):
    """Yield (qualname, node, decorators) for every top-level function
    and method; module-level statements come back as ('<module>',
    pseudo-fn) when any exist."""
    out = []

    def _walk(nodes, prefix):
        for n in nodes:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + n.name, n, _decorator_names(n)))
            elif isinstance(n, ast.ClassDef):
                _walk(n.body, prefix + n.name + ".")

    _walk(tree.body, "")
    loose = [n for n in tree.body
             if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef, ast.Import,
                                   ast.ImportFrom))]
    if loose:
        pseudo = ast.Module(body=loose, type_ignores=[])
        out.append(("<module>", pseudo, set()))
    return out


def _parse(path):
    try:
        with open(path, "r") as f:
            source = f.read()
        return source, ast.parse(source, filename=path)
    except (OSError, SyntaxError) as exc:
        return None, exc


def analyze_source_paths(paths, root=None):
    """Run the MXL-D004..006 pass over ``paths`` (.py files and/or
    directories).  Returns finding dicts ``{"rule", "line", "anchor",
    "message"}`` with ``anchor = relpath:qualname`` (stable across
    unrelated edits; the line is display-only).

    Two phases: the first scans every file for ``@collective_seam``
    definitions and for functions returning rank-divergent values
    (iterated so single-hop indirection like ``_is_coordinator`` is
    seen everywhere); the second runs the taint/findings engine with
    the whole-set vocabulary.
    """
    root = root or os.getcwd()
    files = iter_py_files(paths)
    parsed = []         # (relpath, source, tree)
    findings = []
    for path in files:
        source, tree = _parse(path)
        rel = os.path.relpath(path, root)
        if source is None:
            findings.append({
                "rule": "MXL-D004", "line": 0,
                "anchor": "%s:<file>" % rel,
                "severity": "warning",
                "message": "cannot parse %s for the distributed lint: "
                           "%s" % (rel, tree)})
            continue
        parsed.append((rel, source, tree))

    ginfo = _GlobalInfo()
    for _rel, _src, tree in parsed:
        for qual, fn, decs in _iter_functions(tree):
            if _SEAM_DECORATOR in decs:
                name = qual.rsplit(".", 1)[-1]
                ginfo.seam_defs.add(name)
                ginfo.seams.add(name)
    # divergent-returner fixpoint (2 rounds covers one indirection hop).
    # Matching is by bare name, so require CONSENSUS: a name counts only
    # when EVERY definition of it in the scan set returns divergent —
    # one `def get()` returning time.monotonic() must not taint every
    # dict/env `.get()` call in the tree.  Collective/seam names are
    # excluded outright: a collective's result is coordinated by
    # construction (psum returns the same sum on every rank).
    for _ in range(2):
        reasons, disqualified = {}, set()
        for _rel, _src, tree in parsed:
            for qual, fn, decs in _iter_functions(tree):
                name = qual.rsplit(".", 1)[-1]
                if qual == "<module>" or name in ginfo.seams or \
                        (name.startswith("__") and name.endswith("__")):
                    continue
                fp = _FunctionPass(fn, qual, ginfo,
                                   is_seam=name in ginfo.seam_defs)
                fp.collect_taint()
                if fp.return_taint:
                    reasons.setdefault(name, fp.return_taint)
                else:
                    disqualified.add(name)
        ginfo.divergent_fns = {k: v for k, v in reasons.items()
                               if k not in disqualified}

    for rel, source, tree in parsed:
        suppress = _suppressions(source)
        fn_lines = {}       # def line -> suppression set, for whole-fn
        for qual, fn, decs in _iter_functions(tree):
            name = qual.rsplit(".", 1)[-1]
            fp = _FunctionPass(fn, qual, ginfo,
                               is_seam=name in ginfo.seam_defs)
            def_line = getattr(fn, "lineno", 0)
            fn_sup = suppress.get(def_line, set()) | \
                suppress.get(def_line - 1, set())
            for rule, line, message in fp.run():
                ids = (suppress.get(line, set())
                       | suppress.get(line - 1, set()) | fn_sup)
                if "all" in ids or rule in ids:
                    continue
                findings.append({
                    "rule": rule, "line": line,
                    "anchor": "%s:%s" % (rel, qual),
                    "message": "%s [in %s]" % (message, qual)})
        del fn_lines
    findings.sort(key=lambda f: (f["anchor"], f["line"], f["rule"]))
    return findings


# ----------------------------------------------------------------------
# rule registration
# ----------------------------------------------------------------------
def _source_findings(ctx):
    if "divergence" not in ctx.cache:
        ctx.cache["divergence"] = analyze_source_paths(ctx.source_paths)
    return ctx.cache["divergence"]


@register_rule("MXL-D004", "error",
               "rank-divergent value flows into a coordinated path")
def divergent_coordinated_path(ctx):
    """pid/clock/rank-tainted argument handed to a multi-host
    checkpoint protocol that needs the same value on every rank."""
    if not ctx.source_paths:
        return
    for f in _source_findings(ctx):
        if f["rule"] == "MXL-D004":
            ctx.report(None, f["message"],
                       severity=f.get("severity"),
                       anchor=f["anchor"], line=f["line"])


@register_rule("MXL-D005", "error",
               "collective gated on rank-divergent control flow")
def divergent_collective_condition(ctx):
    """A collective whose call condition, loop trip count, or
    reachability differs across ranks: a static deadlock."""
    if not ctx.source_paths:
        return
    for f in _source_findings(ctx):
        if f["rule"] == "MXL-D005":
            ctx.report(None, f["message"],
                       anchor=f["anchor"], line=f["line"])


@register_rule("MXL-D006", "warning",
               "unbalanced collective on an exception edge")
def unbalanced_collective_exception(ctx):
    """An exception path that can exit between paired collectives, or
    swallow a failing collective on one rank only."""
    if not ctx.source_paths:
        return
    for f in _source_findings(ctx):
        if f["rule"] == "MXL-D006":
            ctx.report(None, f["message"],
                       anchor=f["anchor"], line=f["line"])
