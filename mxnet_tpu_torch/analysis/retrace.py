"""MXL-X: retrace-stability lint — statically prove the
zero-steady-state-lowerings contract.

The port of ``mxnet_tpu/analysis/retrace.py``.  Serving, generation,
hot-swap and elastic re-mesh must perform ZERO steady-state lowerings.
The runtime enforces it with registry counters inside a handful of
drills; this pass enforces it at lint time, over the source, so a
retrace hazard introduced anywhere ships as a CI finding instead of a
burned chip window.

In the port a "lowering" is one of three things: a program build
(``executor.build_program``, which ``executor._lookup_program`` caches
and counts through ``overlap.note_lowering``), an NVRTC compile
(``kernels/nvrtc.compile_cubin``, which ``rtc.Rtc`` and
``kernels/sweep_codegen`` call, each behind its own cache), or a build
of the CUDA extension (``kernels/_build.build_all``).  The JAX vocabulary
(``jax.jit``, ``pallas_call``, ``.lower``) is kept whole beside it, so a
file lints the same through both packages unless it uses a torch name.

Same pure-AST driver shape as the MXL-D divergence and MXL-Q
concurrency passes: parse, never import.  Rules:

- **MXL-X001** — python ``if``/``while`` (or a host materialization
  like ``float()``/``.item()``) on a tensor-derived value inside a
  traced scope.  Every distinct runtime value forces a fresh trace —
  the per-value retrace that turns a steady-state server into a
  compile loop.  Traced scopes are inferred from same-file
  ``jax.jit``/``pjit``/``pallas_call``/``jax.checkpoint``/``jax.vjp``
  sites and jit decorators, and from ``torch.compile``/
  ``torch.jit.trace``/``torch.jit.script``/
  ``torch.cuda.make_graphed_callables`` sites; mark indirect ones with
  ``base.traced_scope`` (the port marks every optimizer's ``update_fn``,
  which ``sweep_codegen`` traces into a generated sweep body and which
  raises there, at run time, on a Python branch over a tensor).
  ``static_argnames`` params are exempt (they are host values by
  contract).
- **MXL-X002** — unstable cache-key ingredient: ``id(...)`` in a key
  (identity is recycled after gc and never survives a rebuild),
  unsorted ``dict``/``set`` iteration (``.items()``/``.keys()``/
  ``.values()``/``set(...)`` outside ``sorted(...)``) flowing into a
  key, or an environment read inside a traced function body (the value
  bakes at trace time — a later flip silently no-ops OR retraces).
  Audits ``cache_key`` call sites (``overlap.cache_key``,
  ``sweep_codegen.cache_key``), ``*key`` assignments and subscripts of
  ``*cache*``/``*registry*`` stores and of the port's build caches
  (``_PLANS``, ``_PROGRAMS``, ``_BUILT``, ``Rtc._compiled``).
- **MXL-X003** — a construction on a per-request or per-step path (or
  inside a loop) without going through the program registry:
  ``jax.jit``/AOT ``.lower``, and in the port ``build_program``,
  ``compile_cubin``, ``Rtc(...)``, ``sweep_codegen.program``,
  ``build_all``, ``torch.compile``, ``torch.cuda.CUDAGraph`` and
  ``torch.jit.trace``/``script``.  Builders (``_build*``/``__init__``/
  warmup/compile/lower) and memoized once-only constructions
  (``if x is None:`` / ``if key not in cache:`` guards) are exempt, as
  is any function that itself calls the registry API
  (``_lookup_program``/``compile_cache_get``/``note_lowering``).
- **MXL-X004** — bare python scalar passed positionally to a jitted
  entry point (a ``_jit*`` attribute or a name bound from ``jax.jit`` or
  ``torch.compile``).  Weak-type flapping — a python float one call, an
  array the next — changes the abstract signature and retraces.  The
  port has no ``torch.compile`` and no ``_jit*`` entry point: its
  programs are graph walks that take a python float as it comes, so the
  rule finds nothing in its source; it stays for code that compiles.
- **MXL-X005** — dynamic size (``len(...)``/``.shape``) indexing an
  AOT program table (``_prefill``/``_decode``/``predictors``) without
  bucket routing.  Serving must pick the program with
  ``buckets.bucket_for``/``prefill_bucket``; a novel size otherwise
  builds a fresh program per request.
- **MXL-X006** — donated buffer read after donation:
  ``jit(..., donate_argnums=...)`` invalidates the donated argument;
  reading it afterwards (instead of the returned replacement) is
  undefined behavior that surfaces as corrupt results or a retrace.
  PyTorch has no donation (a tensor stays valid until freed), so the
  rule finds nothing in torch code; it stays for parity.

Suppress intentional violations with ``# mxl: retrace-ok (MXL-X00n)``
on the finding line, the line above, or the enclosing ``def``.  The
runtime witness for this family is ``observability.retrace``
(``MXTPU_RETRACE_SENTRY=1``), which counts and *attributes* every
post-warmup program build.
"""
from __future__ import annotations

import ast
import os
import re

from .core import register_rule
from .divergence import iter_py_files, _parse, _dotted, _call_name

__all__ = ["traced_scope", "analyze_retrace_paths", "SUPPRESS_RE"]

# canonical home is base.py (leaf module); re-exported for symmetry
# with divergence.collective_seam / concurrency.thread_entry
from ..base import traced_scope  # noqa: E402,F401


# ----------------------------------------------------------------------
# vocabulary
# ----------------------------------------------------------------------
SUPPRESS_RE = re.compile(
    r"#\s*mxl:\s*retrace-ok(?:\s*\(([^)]*)\))?")

_TRACED_DECORATOR = "traced_scope"

#: call names whose function argument becomes a traced scope
_JIT_WRAPPERS = {"jit", "pjit"}
_TRACE_WRAPPERS = _JIT_WRAPPERS | {"pallas_call", "checkpoint", "remat",
                                   "vjp", "vmap", "value_and_grad",
                                   "grad"}
#: torch's, by (receiver's last segment, call): each returns a compiled
#: callable, so a name bound from one is a jitted entry too (X004)
_TORCH_TRACE_WRAPPERS = {("torch", "compile"), ("jit", "trace"),
                         ("jit", "script"), ("cuda", "make_graphed_callables")}
#: the port's lowerings, by terminal call name (X003): a program build,
#: an NVRTC compile, an Rtc (its own compile cache), the CUDA extension
_TORCH_CONSTRUCTIONS = {"build_program", "compile_cubin", "Rtc",
                        "build_all", "CUDAGraph"}
#: ``sweep_codegen.program(...)``: the receiver's last segment
_CODEGEN_RECEIVERS = {"sweep_codegen", "codegen", "cg"}

#: builtins that materialize a tracer on the host (concretization)
_HOST_COERCIONS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "numpy"}
_HOST_ARRAY_FNS = {"asarray", "array"}       # under an np/numpy prefix

#: attribute reads that yield STATIC facts about a tracer (shape-land)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "sharding",
                 "aval", "weak_type"}

#: calls whose result is a host/static value even on tainted input
_TAINT_SANITIZERS = {"len", "isinstance", "type", "range", "hash",
                     "getattr", "hasattr", "id", "str", "repr",
                     "format", "callable"}

#: cache-key contexts audited by X002
_KEYISH_RE = re.compile(r"(^|_)(g?key|cache_key|ckey|fused_key)$", re.I)
_CACHEISH_RE = re.compile(
    r"cache|registry|(^|_)(plans|programs|built|compiled)$", re.I)
_ITER_ORDER_CALLS = {"keys", "values", "items"}
_SET_FACTORIES = {"set", "frozenset"}

#: X003 function-name vocabulary
_PER_STEP_RE = re.compile(
    r"forward|predict|generate|decode|prefill|submit|dispatch|sample|"
    r"request|handle|complete|step|run", re.I)
_BUILDER_RE = re.compile(
    r"build|init|warmup|compile|lower|aot|probe|setup|register|create|"
    r"make|load|swap|symbol", re.I)
_REGISTRY_API = {"_lookup_program", "compile_cache_get",
                 "compile_cache_put", "note_lowering", "note_hit"}

#: X005 program tables + bucket routing
_PROGRAM_TABLE_RE = re.compile(
    r"(_prefill|_decode|predictor|_program|program_table)s?$", re.I)
_BUCKET_CALL_RE = re.compile(r"bucket", re.I)


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
def _suppressions(source):
    """line -> set of rule ids (or {'all'}) from retrace-ok marker
    comments."""
    out = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in (m.group(1) or "").split(",")
               if s.strip()}
        out[i] = ids or {"all"}
    return out


def _functions(tree):
    """Yield (qualname, node) for every function at ANY nesting depth
    (traced bodies are almost always nested defs: ``trace`` inside
    ``_build_program``, ``step`` inside ``_build_fused_step``)."""
    out = []

    def _walk(nodes, prefix):
        for n in nodes:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + n.name
                out.append((q, n))
                _walk(n.body, q + ".")
            elif isinstance(n, ast.ClassDef):
                _walk(n.body, prefix + n.name + ".")
    _walk(tree.body, "")
    return out


def _decorators(fn):
    out = set()
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            name = _call_name(dec)
        elif isinstance(dec, ast.Attribute):
            name = dec.attr
        elif isinstance(dec, ast.Name):
            name = dec.id
        else:
            name = None
        if name:
            out.add(name)
    return out


def _torch_wrapper(func):
    """``torch.compile`` / ``torch.jit.trace`` / ...: True when the callee
    expression ``func`` is one of torch's trace wrappers."""
    if not isinstance(func, ast.Attribute):
        return False
    recv = (_dotted(func.value) or "").rsplit(".", 1)[-1]
    return (recv, func.attr) in _TORCH_TRACE_WRAPPERS


def _is_trace_wrapper(call):
    return _call_name(call) in _TRACE_WRAPPERS or _torch_wrapper(call.func)


def _torch_decorated(fn):
    """``@torch.compile`` / ``@torch.jit.script`` (bare or called)."""
    return any(_torch_wrapper(dec.func if isinstance(dec, ast.Call)
                              else dec) for dec in fn.decorator_list)


def _is_jit_call(call):
    """A call that returns a compiled entry point: ``jax.jit``/``pjit``
    or one of torch's trace wrappers."""
    return _call_name(call) in _JIT_WRAPPERS or _torch_wrapper(call.func)


def _is_torch_construction(call):
    """The port's lowerings and torch's compiles (X003)."""
    name = _call_name(call)
    if name in _TORCH_CONSTRUCTIONS or _torch_wrapper(call.func):
        return True
    if name == "program" and isinstance(call.func, ast.Attribute):
        recv = (_dotted(call.func.value) or "").rsplit(".", 1)[-1]
        return recv in _CODEGEN_RECEIVERS
    return False


def _static_argnames(call):
    """Literal ``static_argnames=`` entries of a jit call site."""
    for kw in call.keywords:
        if kw.arg != "static_argnames":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return {v.value}
        if isinstance(v, (ast.Tuple, ast.List)):
            return {e.value for e in v.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return set()


def _donate_argnums(call):
    """Literal ``donate_argnums=`` tuple of a jit call site, or None."""
    for kw in call.keywords:
        if kw.arg != "donate_argnums":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            return (v.value,)
        if isinstance(v, (ast.Tuple, ast.List)):
            return tuple(e.value for e in v.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, int))
    return None


def _shallow_stmts(body):
    """Walk statements/expressions of one scope body without
    descending into nested function/class scopes."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _traced_defs(tree):
    """{def node -> static argname set} for every function the file
    hands to a trace wrapper (``jax.jit(trace, ...)``,
    ``jax.checkpoint(seg_fn)``, ``pl.pallas_call(kernel, ...)``).

    Resolution is lexical, innermost scope first — ``jax.jit(step)``
    inside ``_build`` marks the nested ``step`` def, NOT an unrelated
    host-side method that happens to share the name elsewhere in the
    file."""
    traced = {}

    def _scan(body, frames):
        stmts = list(_shallow_stmts(body))
        local = {n.name: n for n in stmts
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))}
        frames = frames + [local]
        for node in stmts:
            if isinstance(node, ast.Call):
                wrapper = _call_name(node)
                if not _is_trace_wrapper(node):
                    continue
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        for frame in reversed(frames):
                            if arg.id in frame:
                                static = (_static_argnames(node)
                                          if wrapper in _JIT_WRAPPERS
                                          else set())
                                traced.setdefault(
                                    frame[arg.id], set()).update(static)
                                break
                        break       # only the first fn-valued argument
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                _scan(node.body, frames)

    _scan(tree.body, [])
    return traced


def _is_aot_lower(call):
    """``something.lower(args...)`` with at least one argument — the
    AOT entry.  ``str.lower()`` takes no arguments, so the arity test
    alone separates the two meanings."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "lower"
            and bool(call.args or call.keywords))


# ----------------------------------------------------------------------
# taint: tensor-derived values inside a traced scope (X001)
# ----------------------------------------------------------------------
def _compare_is_identity(node):
    """True for comparisons that stay host-static on tracers:
    ``is``/``is not``/``in``/``not in``."""
    return all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops)


def _tainted(node, tainted):
    """Does ``node`` (an expression) carry a tensor-derived value?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Constant):
        return False
    if isinstance(node, ast.Lambda):
        return False
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return _tainted(node.value, tainted)
    if isinstance(node, ast.Compare):
        if _compare_is_identity(node):
            return False
        return any(_tainted(c, tainted)
                   for c in [node.left] + node.comparators)
    if isinstance(node, ast.Call):
        name = _call_name(node)
        if name in _TAINT_SANITIZERS:
            return False
        parts = list(node.args) + [kw.value for kw in node.keywords]
        if isinstance(node.func, ast.Attribute):
            parts.append(node.func.value)
        return any(_tainted(p, tainted) for p in parts)
    if isinstance(node, ast.BoolOp):
        return any(_tainted(v, tainted) for v in node.values)
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.IfExp, ast.Tuple,
                         ast.List, ast.Set, ast.Subscript, ast.Starred,
                         ast.Slice, ast.JoinedStr, ast.FormattedValue,
                         ast.Dict, ast.GeneratorExp, ast.ListComp,
                         ast.SetComp, ast.DictComp)):
        return any(_tainted(c, tainted) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))
    return False


def _target_names(target):
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for e in target.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _collect_taint(fn, static):
    """Fixpoint taint set for one traced function: params (minus the
    static argnames) seed it; assignments propagate it."""
    args = fn.args
    params = [a.arg for a in
              list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)]
    if args.vararg:
        params.append(args.vararg.arg)
    if args.kwarg:
        params.append(args.kwarg.arg)
    tainted = {p for p in params
               if p not in static and p not in ("self", "cls")}
    for _ in range(6):
        grew = False
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.For):
                targets, value = [node.target], node.iter
            else:
                continue
            if value is None or not _tainted(value, tainted):
                continue
            for t in targets:
                for name in _target_names(t):
                    if name not in tainted:
                        tainted.add(name)
                        grew = True
        if not grew:
            break
    return tainted


def _traced_scope_findings(fn, qual, static):
    """X001 + X002(env-read) over one traced function body."""
    out = []
    tainted = _collect_taint(fn, static)
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While)) and \
                _tainted(node.test, tainted):
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append((
                "MXL-X001", node.lineno, qual,
                "python `%s` on a tensor-derived value inside a traced "
                "scope — every distinct runtime value forces a fresh "
                "trace (per-value retrace); use lax.cond/jnp.where or "
                "hoist the decision before tracing" % kind))
        elif isinstance(node, ast.Call):
            name = _call_name(node)
            dotted = _dotted(node.func) or ""
            if isinstance(node.func, ast.Name) and \
                    name in _HOST_COERCIONS and \
                    any(_tainted(a, tainted) for a in node.args):
                out.append((
                    "MXL-X001", node.lineno, qual,
                    "%s() materializes a tensor-derived value on the "
                    "host inside a traced scope — concretization "
                    "either fails to trace or bakes one value per "
                    "compile; keep the math in jnp" % name))
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_METHODS and \
                    _tainted(node.func.value, tainted):
                out.append((
                    "MXL-X001", node.lineno, qual,
                    ".%s() materializes a tensor-derived value on the "
                    "host inside a traced scope — concretization "
                    "forces a per-value retrace" % node.func.attr))
            elif name in _HOST_ARRAY_FNS and \
                    dotted.split(".")[0] in ("np", "numpy") and \
                    any(_tainted(a, tainted) for a in node.args):
                out.append((
                    "MXL-X001", node.lineno, qual,
                    "numpy.%s on a tensor-derived value inside a "
                    "traced scope pulls the tracer to the host; use "
                    "jnp instead" % name))
            if _is_env_read(node):
                out.append((
                    "MXL-X002", node.lineno, qual,
                    "environment read inside a traced function body — "
                    "the value is baked at trace time, so a later flip "
                    "either silently no-ops or forces a retrace; read "
                    "the env before tracing and close over the result "
                    "(and key any cache on it)"))
        elif isinstance(node, ast.Subscript) and \
                (_dotted(node.value) or "").endswith("environ"):
            out.append((
                "MXL-X002", node.lineno, qual,
                "os.environ[...] inside a traced function body — the "
                "value is baked at trace time; hoist the read out of "
                "the traced scope"))
    return out


def _is_env_read(call):
    dotted = _dotted(call.func) or ""
    return (dotted.endswith("environ.get") or dotted.endswith("getenv")
            or dotted.endswith("environ.setdefault"))


# ----------------------------------------------------------------------
# cache-key hygiene (X002)
# ----------------------------------------------------------------------
def _unstable_key_parts(expr):
    """Yield (lineno, message) for unstable ingredients inside one
    cache-key expression: ``id(...)`` anywhere, and dict/set iteration
    order not laundered through ``sorted(...)``."""
    def _walk(node, under_sorted):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name == "id" and isinstance(node.func, ast.Name):
                yield (node.lineno,
                       "id() in a cache key — object identity is "
                       "recycled after gc and never matches across "
                       "rebuilds, so a logically identical object "
                       "misses (needless retrace) or a recycled id "
                       "falsely hits (stale program); key on a value "
                       "fingerprint (overlap.optimizer_fingerprint / "
                       "overlap.cache_key) instead")
            elif not under_sorted and name in _ITER_ORDER_CALLS and \
                    isinstance(node.func, ast.Attribute):
                yield (node.lineno,
                       ".%s() iteration order flows into a cache key "
                       "unsorted — wrap it in sorted(...) or the same "
                       "mapping can produce two different keys" % name)
            elif not under_sorted and name in _SET_FACTORIES and \
                    isinstance(node.func, ast.Name):
                yield (node.lineno,
                       "set iteration order flows into a cache key — "
                       "wrap it in sorted(...)")
            child_sorted = under_sorted or name == "sorted"
            for c in ast.iter_child_nodes(node):
                yield from _walk(c, child_sorted)
        else:
            for c in ast.iter_child_nodes(node):
                yield from _walk(c, under_sorted)
    yield from _walk(expr, False)


def _expr_has_cacheish(expr):
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and \
                _CACHEISH_RE.search(node.attr):
            return True
        if isinstance(node, ast.Name) and _CACHEISH_RE.search(node.id):
            return True
    return False


def _mentions(expr, name):
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(expr))


def _key_feeds_cache(fn, keyname):
    """Does the ``keyname`` local flow into a persistent
    ``*cache*``/``*registry*`` store?  Distinguishes a compile-cache
    key (``self._fused_cache[0] != key`` / ``cache[key] = ...``) from
    the benign per-invocation edge maps (``shapes[(id(node), 0)]``)
    that key live graph nodes by identity for one call's duration."""
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Subscript):
            base = _dotted(node.value) or ""
            if _CACHEISH_RE.search(base.rsplit(".", 1)[-1]) and \
                    _mentions(node.slice, keyname):
                return True
        elif isinstance(node, ast.Compare):
            sides = [node.left] + node.comparators
            if any(_mentions(s, keyname) for s in sides) and \
                    any(_expr_has_cacheish(s) for s in sides):
                return True
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            owner = dotted.rsplit(".", 1)[0] if "." in dotted else ""
            if _CACHEISH_RE.search(owner) and \
                    any(_mentions(a, keyname) for a in node.args):
                return True
        elif isinstance(node, ast.Assign):
            stores = any(_expr_has_cacheish(t) for t in node.targets)
            if stores and _mentions(node.value, keyname):
                return True
    return False


def _key_hygiene_findings(fn, qual):
    """X002 over one function: audit ``*key =`` assignments whose key
    feeds a cache/registry store, ``cache_key(...)`` call arguments,
    and ``*cache*``/``*registry*`` subscript indexes."""
    out = []
    for node in _shallow_walk(fn):
        exprs = []
        if isinstance(node, ast.Assign):
            names = [n for t in node.targets for n in _target_names(t)]
            if any(_KEYISH_RE.search(n) and _key_feeds_cache(fn, n)
                   for n in names):
                exprs.append(node.value)
        elif isinstance(node, ast.Call) and \
                _call_name(node) == "cache_key":
            exprs.extend(node.args)
        elif isinstance(node, ast.Subscript):
            base = _dotted(node.value) or ""
            if _CACHEISH_RE.search(base.rsplit(".", 1)[-1]):
                exprs.append(node.slice)
        for e in exprs:
            for line, msg in _unstable_key_parts(e):
                out.append(("MXL-X002", line, qual, msg))
    return out


def _shallow_walk(fn):
    """Walk a function body WITHOUT descending into nested defs (each
    nested def gets its own _functions entry, so descending here would
    double-report).  The list is kept on ``fn``: every rule walks each
    function, and a tree is parsed anew for every analysis."""
    got = getattr(fn, "_mxl_shallow", None)
    if got is not None:
        return got
    got = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        got.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    fn._mxl_shallow = got
    return got


# ----------------------------------------------------------------------
# per-request jit construction (X003)
# ----------------------------------------------------------------------
def _memo_guarded(test):
    """``if x is None:`` / ``if k not in cache:`` — the once-only
    construction idiom; a jit under such a guard is a lazy memo, not a
    per-call retrace."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in node.ops):
            return True
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, ast.Not):
            return True
    return False


def _construction_sites(fn):
    """Yield (call, in_loop, guarded, cached_target) for every
    jit/pjit/AOT-lower construction in ``fn`` (nested defs excluded)."""
    def _visit(nodes, in_loop, guarded):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            loop_now = in_loop or isinstance(node, (ast.For, ast.While))
            guard_now = guarded or (isinstance(node, ast.If)
                                    and _memo_guarded(node.test))
            cached = False
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    base = _dotted(t.value if isinstance(t, ast.Subscript)
                                   else t) or ""
                    if _CACHEISH_RE.search(base):
                        cached = True
            for sub in ast.walk(node) if not isinstance(
                    node, (ast.If, ast.For, ast.While, ast.Try,
                           ast.With)) else ():
                if isinstance(sub, ast.Call):
                    name = _call_name(sub)
                    if (name in _JIT_WRAPPERS and
                            isinstance(sub.func, (ast.Name,
                                                  ast.Attribute))) or \
                            _is_aot_lower(sub) or \
                            _is_torch_construction(sub):
                        yield sub, loop_now, guard_now, cached
            if isinstance(node, ast.If):
                yield from _visit(node.body, loop_now, guard_now)
                yield from _visit(node.orelse, loop_now, guard_now)
            elif isinstance(node, (ast.For, ast.While)):
                yield from _visit(node.body, True, guarded)
                yield from _visit(node.orelse, True, guarded)
            elif isinstance(node, ast.Try):
                for blk in (node.body, node.orelse, node.finalbody):
                    yield from _visit(blk, loop_now, guard_now)
                for h in node.handlers:
                    yield from _visit(h.body, loop_now, guard_now)
            elif isinstance(node, ast.With):
                yield from _visit(node.body, loop_now, guard_now)
    yield from _visit(fn.body, False, False)


def _per_step_jit_findings(fn, qual):
    name = fn.name
    if _BUILDER_RE.search(name):
        return []
    called = {_call_name(n) for n in _shallow_walk(fn)
              if isinstance(n, ast.Call)}
    if called & _REGISTRY_API:
        return []           # registry-aware: this IS the cached path
    per_step = bool(_PER_STEP_RE.search(name))
    out = []
    for call, in_loop, guarded, cached in _construction_sites(fn):
        if guarded or cached:
            continue
        if not (per_step or in_loop):
            continue
        made = "jit" if not _is_torch_construction(call) else \
            "%s()" % (_dotted(call.func) or _call_name(call))
        what = ("%s constructed inside a loop" % made
                if in_loop and not per_step else
                "%s/lower constructed on a per-request/per-step path"
                % made if made == "jit" else
                "%s constructed on a per-request/per-step path" % made)
        out.append((
            "MXL-X003", call.lineno, qual,
            "%s — this bypasses the program registry and lowers fresh "
            "on every call; build once (a _build*/__init__ path or an "
            "`is None` memo) or route through "
            "executor._lookup_program / overlap.compile_cache_get so "
            "steady state stays at zero lowerings" % what))
    return out


# ----------------------------------------------------------------------
# weak-type scalar leaks (X004)
# ----------------------------------------------------------------------
def _jitted_local_names(tree):
    """Names bound from ``jax.jit(...)`` anywhere in the file
    (``jit_step = jax.jit(step)``) — the entry points X004 audits in
    addition to ``*._jit*`` attributes."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _is_jit_call(node.value):
            for t in node.targets:
                out.update(_target_names(t))
    return out


def _weak_type_findings(fn, qual, jitted_names):
    out = []
    for node in _shallow_walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_jit_entry = False
        if isinstance(f, ast.Attribute) and f.attr.startswith("_jit"):
            is_jit_entry = True
        elif isinstance(f, ast.Name) and f.id in jitted_names:
            is_jit_entry = True
        if not is_jit_entry:
            continue
        for arg in node.args:
            bare = (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, (int, float))
                    and not isinstance(arg.value, bool))
            coerced = (isinstance(arg, ast.Call)
                       and isinstance(arg.func, ast.Name)
                       and arg.func.id in ("float", "int"))
            if bare or coerced:
                out.append((
                    "MXL-X004", node.lineno, qual,
                    "bare python scalar passed positionally to a "
                    "jitted entry point — weak-type flapping (python "
                    "float one call, array the next) changes the "
                    "abstract signature and retraces; wrap with "
                    "jnp.asarray(v, dtype) (the jnp.float32(lr) "
                    "idiom) or mark the argument static"))
    return out


# ----------------------------------------------------------------------
# unbucketed AOT table indexes (X005)
# ----------------------------------------------------------------------
def _routes_through_bucket(expr, bucketed):
    if isinstance(expr, ast.Name):
        return expr.id in bucketed
    if isinstance(expr, ast.Call):
        name = _call_name(expr) or ""
        return bool(_BUCKET_CALL_RE.search(name))
    if isinstance(expr, ast.BoolOp):
        return all(_routes_through_bucket(v, bucketed)
                   for v in expr.values)
    if isinstance(expr, ast.IfExp):
        return _routes_through_bucket(expr.body, bucketed) and \
            _routes_through_bucket(expr.orelse, bucketed)
    return False


def _dynamic_size(expr):
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and _call_name(node) == "len":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "shape":
            return True
    return False


def _bucket_findings(fn, qual):
    # names that went THROUGH bucket routing, and names that carry a
    # raw dynamic size
    bucketed = {a.arg for a in fn.args.args if a.arg == "bucket"}
    dynamic = set()
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Assign):
            names = [n for t in node.targets for n in _target_names(t)]
            if _routes_through_bucket(node.value, bucketed):
                bucketed.update(names)
            elif _dynamic_size(node.value):
                dynamic.update(names)
        elif isinstance(node, ast.For):
            base = _dotted(node.iter if not isinstance(node.iter,
                                                       ast.Call)
                           else node.iter.func) or ""
            if _PROGRAM_TABLE_RE.search(base.rsplit(".", 2)[-2]
                                        if base.count(".") >= 1
                                        and isinstance(node.iter,
                                                       ast.Call)
                                        else base.rsplit(".", 1)[-1]):
                bucketed.update(_target_names(node.target))
    out = []
    for node in _shallow_walk(fn):
        if not isinstance(node, ast.Subscript):
            continue
        base = _dotted(node.value) or ""
        if not _PROGRAM_TABLE_RE.search(base.rsplit(".", 1)[-1]):
            continue
        idx = node.slice
        if _routes_through_bucket(idx, bucketed):
            continue
        raw = _dynamic_size(idx) or any(
            isinstance(n, ast.Name) and n.id in dynamic
            for n in ast.walk(idx))
        if raw:
            out.append((
                "MXL-X005", node.lineno, qual,
                "dynamic size indexes an AOT program table without "
                "bucket routing — every novel size lowers a fresh "
                "program; pick the bucket with buckets.bucket_for / "
                "prefill_bucket first"))
    return out


# ----------------------------------------------------------------------
# donated-buffer reuse (X006)
# ----------------------------------------------------------------------
def _donation_findings(fn, qual):
    donated_fns = {}        # local name -> donate_argnums tuple
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _call_name(node.value) in _JIT_WRAPPERS:
            nums = _donate_argnums(node.value)
            if nums:
                for t in node.targets:
                    for name in _target_names(t):
                        donated_fns[name] = nums
    if not donated_fns:
        return []
    donations = []          # (var, call_lineno)
    assigns = []            # (var, lineno)
    reads = []              # (var, lineno)
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for name in _target_names(t):
                    assigns.append((name, node.lineno))
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in donated_fns:
            for i in donated_fns[node.func.id]:
                if i < len(node.args) and \
                        isinstance(node.args[i], ast.Name):
                    donations.append((node.args[i].id, node.lineno))
        elif isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load):
            reads.append((node.id, node.lineno))
    out = []
    for var, dline in donations:
        for rvar, rline in reads:
            if rvar != var or rline <= dline:
                continue
            refreshed = any(a == var and dline <= aline <= rline
                            for a, aline in assigns)
            if not refreshed:
                out.append((
                    "MXL-X006", rline, qual,
                    "donated buffer %r read after donation — "
                    "jit(donate_argnums) invalidates the argument "
                    "buffer; use the returned replacement (rebind the "
                    "name from the call result)" % var))
                break
    return out


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------
def _enclosing_def_lines(tree):
    """line -> the def/class lines enclosing it (each def's own line and
    its first decorator's: a marker above the first decorator covers the
    def too), in one walk of the tree."""
    out = {}
    stack = [(tree, ())]
    while stack:
        node, encl = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            head = min([node.lineno]
                       + [d.lineno for d in node.decorator_list])
            encl = encl + (node.lineno, head)
        ln = getattr(node, "lineno", None)
        if ln is not None and encl:
            out.setdefault(ln, set()).update(encl)
        stack.extend((c, encl) for c in ast.iter_child_nodes(node))
    return out


def analyze_retrace_paths(paths, root=None):
    """Run MXL-X001..X006 over .py files/dirs.  Returns a list of
    finding dicts: {rule, line, anchor, message[, severity]}."""
    root = root or os.getcwd()
    findings = []
    for path in iter_py_files(paths):
        source, tree = _parse(path)
        rel = os.path.relpath(path, root)
        if source is None:
            findings.append({
                "rule": "MXL-X001", "line": 0,
                "anchor": "%s:<file>" % rel, "severity": "warning",
                "message": "cannot parse %s for the retrace lint: %s"
                           % (rel, tree)})
            continue
        traced = _traced_defs(tree)
        jitted_names = _jitted_local_names(tree)
        raw = []
        seen = set()
        for qual, fn in _functions(tree):
            decs = _decorators(fn)
            if fn in traced or _TRACED_DECORATOR in decs or \
                    decs & _JIT_WRAPPERS or _torch_decorated(fn):
                static = traced.get(fn, set())
                raw.extend(_traced_scope_findings(fn, qual, static))
            raw.extend(_key_hygiene_findings(fn, qual))
            raw.extend(_per_step_jit_findings(fn, qual))
            raw.extend(_weak_type_findings(fn, qual, jitted_names))
            raw.extend(_bucket_findings(fn, qual))
            raw.extend(_donation_findings(fn, qual))

        suppress = _suppressions(source)
        # def/class lines participate in suppression
        anchor_lines = _enclosing_def_lines(tree) if raw else {}
        for rule, line, qualname, message in raw:
            if (rule, line, message) in seen:
                continue        # traced nesting can re-visit a stmt
            seen.add((rule, line, message))
            ids = suppress.get(line, set()) | \
                suppress.get(line - 1, set())
            for defline in anchor_lines.get(line, ()):
                ids |= suppress.get(defline, set()) | \
                    suppress.get(defline - 1, set())
            if "all" in ids or rule in ids:
                continue
            findings.append({
                "rule": rule, "line": line,
                "anchor": "%s:%s" % (rel, qualname),
                "message": "%s [in %s]" % (message, qualname)})
    findings.sort(key=lambda f: (f["anchor"], f["line"], f["rule"]))
    return findings


# ----------------------------------------------------------------------
# rule registration
# ----------------------------------------------------------------------
def _source_findings(ctx):
    if "retrace" not in ctx.cache:
        ctx.cache["retrace"] = analyze_retrace_paths(ctx.source_paths)
    return ctx.cache["retrace"]


def _relay(ctx, rule):
    if not ctx.source_paths:
        return
    for f in _source_findings(ctx):
        if f["rule"] == rule:
            ctx.report(None, f["message"],
                       severity=f.get("severity"),
                       anchor=f["anchor"], line=f["line"])


@register_rule("MXL-X001", "error",
               "python control flow on a tensor-derived value inside "
               "a traced scope (per-value retrace)")
def traced_control_flow(ctx):
    """`if`/`while`/host materialization on a tracer inside a traced
    function — each distinct value forces a fresh trace."""
    _relay(ctx, "MXL-X001")


@register_rule("MXL-X002", "error",
               "unstable cache-key ingredient (id(), unsorted "
               "iteration, env read inside a trace)")
def unstable_cache_key(ctx):
    """id()/dict-order/set-order in a compile-cache key, or an
    environment read baked into a traced body."""
    _relay(ctx, "MXL-X002")


@register_rule("MXL-X003", "error",
               "jit/lower constructed on a per-request or per-step "
               "path, bypassing the program registry")
def per_step_jit(ctx):
    """Fresh jax.jit/.lower on a hot path — steady state must perform
    zero lowerings; build once or route through the registry."""
    _relay(ctx, "MXL-X003")


@register_rule("MXL-X004", "warning",
               "bare python scalar passed to a jitted entry point "
               "(weak-type retrace hazard)")
def weak_type_leak(ctx):
    """Python scalar crossing the trace boundary positionally — the
    weak-type abstract signature flaps between call styles."""
    _relay(ctx, "MXL-X004")


@register_rule("MXL-X005", "error",
               "dynamic shape fed to an AOT program table without "
               "bucket routing")
def unbucketed_shape(ctx):
    """len()/shape-derived index into _prefill/_decode/predictors —
    serving must route through the planner's buckets."""
    _relay(ctx, "MXL-X005")


@register_rule("MXL-X006", "error",
               "donated buffer reused after donation")
def donated_reuse(ctx):
    """A buffer passed at a donate_argnums position read again after
    the call instead of its returned replacement."""
    _relay(ctx, "MXL-X006")
