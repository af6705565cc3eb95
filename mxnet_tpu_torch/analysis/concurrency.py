"""Static concurrency lint over the framework's own source
(rule family MXL-Q001..Q006).

The port of ``mxnet_tpu/analysis/concurrency.py``.  The runtime is
threaded in earnest — the batcher scheduler, the AsyncLauncher FIFOs,
DevicePrefetcher producers, the kvstore's async-push worker, the fleet
router and its heartbeat daemon, the telemetry flusher, the watchdog —
and the two worst flakes the JAX package shipped were genuine data races
(the torch host-callback race, the ``PrefetchingIter`` shutdown races)
found by luck, not tooling.  This pass family is the thread-safety
sibling of the MXL-D rank-divergence lint: pure ``ast`` over the Python
source, never importing the scanned files, intraprocedural with a
per-class closure over ``self.method()`` calls.

Rules:

- **MXL-Q001** (error) — shared-attribute race: an attribute (or module
  global) written on a thread-entry path (``threading.Thread(target=
  ...)``, ``launcher.submit(...)``, ``@thread_entry``) and read/written
  on another thread's path with no common lock held at both sites.
- **MXL-Q002** (error) — lock-order cycle: the acquired-while-held
  graph, built package-wide from ``with self._lock:`` nesting (plus one
  hop through same-class method calls), contains a cycle — a potential
  deadlock.  ``Condition(lock)`` aliases are resolved so cv/lock pairs
  are one node.
- **MXL-Q003** (warning) — blocking call under lock: ``queue.get``,
  ``future.result``, ``join``, socket/HTTP, ``subprocess``,
  ``block_until_ready`` / device sync, ``sleep`` executed while a lock
  is held.  (``cond.wait()`` on the *held* condition is a release, not
  a block — that's Q006's subject.)  On the card these are blocking
  too, each a device sync: ``torch.cuda.synchronize``,
  ``Event.synchronize``, ``Stream.synchronize`` (any ``.synchronize()``),
  a ``torch.distributed`` ``Work.wait()`` (the work of an
  ``async_op=True`` collective or ``isend``/``irecv``, or a receiver
  named ``work``/``handle``/``req``), and a tensor's ``.item()``,
  ``.tolist()`` or ``.cpu()``.
- **MXL-Q004** (warning) — unjoined/unregistered thread leak: a thread
  started outside the ``io.py`` producer registry
  (``_register_producer``) with no ``join`` path in its class/module.
- **MXL-Q005** (error) — callback-context violation: a host-callback
  body mutating state also touched by the step path without a common
  lock.  Host-callback bodies are functions handed to ``pure_callback``
  / ``io_callback`` / ``host_callback`` / ``id_tap``, ``forward`` /
  ``backward`` of an op class declaring ``host_callback = True``, and in
  torch: the ``backward`` of a ``torch.autograd.Function`` whose
  ``forward`` runs a host op (a ``.forward(...)`` call on another object
  or a ``.cpu()``/``.numpy()``/``.tolist()``/``.item()`` of a tensor —
  ``operator._HostOpFn``, the counterpart of ``pure_callback``), the
  ``backward`` of a ``CustomOp`` subclass (which ``_HostOpFn`` calls),
  and the callables handed to tensor and module hooks
  (``register_hook``, ``register_forward_hook``,
  ``register_full_backward_hook`` and their kin).  PyTorch's autograd
  engine runs the backward of CUDA tensors on a worker thread of its
  own, one for each device, so on the card these bodies run off the
  caller's thread.
- **MXL-Q006** (warning) — ``Condition.wait()`` without an enclosing
  ``while``-predicate re-check loop (``wait_for`` is exempt: it loops
  internally).

Two markers make intent explicit:

- ``@thread_entry`` (``mxnet_tpu_torch.base.thread_entry``) declares a
  function a thread entry point the AST pass cannot infer (dynamic
  registries, dispatch tables).
- ``# mxl: thread-shared-ok`` (optionally ``(MXL-Q001,...)``) on the
  finding line, the line above it, or the enclosing ``def`` / ``class``
  line suppresses matching findings — the comment IS the review record
  for why the sharing is safe (e.g. a GIL-atomic append-only buffer).

Findings carry a stable ``file:qualname`` anchor (plus the volatile
line for CI annotations) so ``mxlint --baseline`` records survive
unrelated edits.  The runtime witness for Q002 is
``observability/locktrace.py`` (``MXTPU_LOCKCHECK=1``), which records
per-thread acquisition stacks live and raises
``ResilienceError(kind="lock_order")`` on a real inversion.
"""
from __future__ import annotations

import ast
import os
import re

from .core import register_rule
from .divergence import (iter_py_files, _parse, _dotted, _call_name,
                         _decorator_names)

__all__ = ["thread_entry", "analyze_concurrency_paths", "SUPPRESS_RE"]

# canonical home is base.py (leaf module); re-exported for symmetry
# with divergence.collective_seam
from ..base import thread_entry  # noqa: E402,F401


# ----------------------------------------------------------------------
# vocabulary
# ----------------------------------------------------------------------
SUPPRESS_RE = re.compile(
    r"#\s*mxl:\s*thread-shared-ok(?:\s*\(([^)]*)\))?")

_ENTRY_DECORATOR = "thread_entry"

_THREAD_FACTORIES = {"Thread", "Timer"}
# call names whose callable arguments run on another thread
_SUBMIT_CALLS = {"submit", "apply_async", "map_async", "call_soon_threadsafe"}
# call names whose callable arguments run on the host-callback thread
_CALLBACK_HOSTS = {"pure_callback", "io_callback", "host_callback",
                   "id_tap", "call_tf",
                   # torch hooks: autograd runs the backward ones on its
                   # device thread
                   "register_hook", "register_forward_hook",
                   "register_forward_pre_hook", "register_backward_hook",
                   "register_full_backward_hook",
                   "register_full_backward_pre_hook",
                   "register_post_accumulate_grad_hook",
                   "register_module_forward_hook",
                   "register_module_full_backward_hook"}
# a torch.autograd.Function's forward runs a host op when it calls one of
# these on a tensor, or delegates to another object's .forward(...)
_HOST_OP_METHODS = {"cpu", "numpy", "tolist", "item"}
# constructors of synchronization primitives (type map for attrs)
_LOCK_FACTORIES = {"Lock", "RLock", "Semaphore", "BoundedSemaphore"}
_CONDITION_FACTORIES = {"Condition"}
_EVENT_FACTORIES = {"Event", "Barrier"}
_SYNC_FACTORIES = (_LOCK_FACTORIES | _CONDITION_FACTORIES
                   | _EVENT_FACTORIES)

# names that look like a lock when no factory assignment is visible
_LOCKISH_NAME = re.compile(r"lock|mutex|guard|cond|(^|_)sem$|(^|_)cv$",
                           re.IGNORECASE)
_CONDISH_NAME = re.compile(r"cond|(^|_)cv$", re.IGNORECASE)

# container-mutating method names: `self.buf.append(x)` is a write to
# `self.buf` for race purposes
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "add",
             "update", "insert", "remove", "discard", "clear", "pop",
             "popitem", "popleft", "setdefault", "sort", "reverse"}

# unambiguous blocking calls (terminal name -> description)
_BLOCKING_CALLS = {
    "sleep": "time.sleep",
    "result": "Future.result",
    "wait_all": "launcher drain",
    "blocking_key_value_get": "coordination-KV blocking get",
    "getresponse": "an HTTP round-trip",
    "urlopen": "an HTTP round-trip",
    "check_call": "a subprocess round-trip",
    "check_output": "a subprocess round-trip",
    "communicate": "a subprocess round-trip",
    "serve_forever": "the HTTP serve loop",
    "block_until_ready": "a device sync",
    "accept": "a socket accept",
    "recv": "a socket recv",
    "recv_into": "a socket recv",
    "connect": "a socket connect",
    # torch: every one a device sync on the card
    "synchronize": "a device sync (synchronize)",
    "item": "a device sync (.item())",
    "tolist": "a device sync (.tolist())",
    "cpu": "a device sync (.cpu())",
}
_WORKISH_NAME = re.compile(r"(^|_)(work|works|handle|handles|req|reqs)$",
                           re.IGNORECASE)
_QUEUEISH_NAME = re.compile(r"queue|_q$|fifo|inbox|mailbox", re.IGNORECASE)

# thread-registry calls (io.py producer registry): a thread handed to
# one of these has a managed shutdown path
_REGISTRY_CALLS = {"_register_producer", "register_producer",
                   "_register_prefetcher"}


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
def _suppressions(source):
    """line -> set of rule ids (or {'all'}) from thread-shared-ok
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


def _self_attr(node):
    """`self.X` -> 'X' (drilling through subscripts), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _base_name(node):
    """Innermost Name of an attribute/subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_sync_factory(value):
    """Terminal callee name of `value` if it constructs a sync
    primitive (Lock/RLock/Condition/Event/...), else None."""
    if isinstance(value, ast.Call):
        name = _call_name(value)
        if name in _SYNC_FACTORIES:
            return name
    return None


def _callable_refs(node, method_names):
    """Names of same-class methods / module functions referenced by a
    callable argument: `self.X`, bare `fn`, `lambda: self.X(...)`,
    `functools.partial(self.X, ...)`."""
    out = set()
    if isinstance(node, ast.Attribute):
        attr = _self_attr(node)
        if attr:
            out.add(("method", attr))
        return out
    if isinstance(node, ast.Name):
        out.add(("function", node.id))
        return out
    if isinstance(node, ast.Lambda):
        for sub in ast.walk(node.body):
            attr = _self_attr(sub) if isinstance(sub, ast.Attribute) \
                else None
            if attr and attr in method_names:
                out.add(("method", attr))
            elif (isinstance(sub, ast.Name)
                  and isinstance(getattr(sub, "ctx", None), ast.Load)):
                out.add(("maybe_function", sub.id))
        return out
    if isinstance(node, ast.Call) and _call_name(node) == "partial":
        for arg in node.args[:1]:
            out |= _callable_refs(arg, method_names)
        return out
    return out


def _is_dist_work(recv):
    """The receiver of a ``.wait()`` is a ``torch.distributed`` work: an
    ``async_op=True`` collective or ``isend``/``irecv`` called in place,
    or a name like ``work``/``handle``/``req``."""
    if isinstance(recv, ast.Call):
        return _call_name(recv) in ("isend", "irecv") or any(
            k.arg == "async_op" and isinstance(k.value, ast.Constant)
            and k.value.value is True for k in recv.keywords)
    label = _self_attr(recv) or (recv.id if isinstance(recv, ast.Name)
                                 else None)
    return bool(label and _WORKISH_NAME.search(label))


def _runs_host_op(fn):
    """A ``forward`` that runs a host op: a ``.forward(...)`` call on
    another object (not ``super()``/``self``) or a tensor's host
    materialization."""
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call) or \
                not isinstance(sub.func, ast.Attribute):
            continue
        attr, recv = sub.func.attr, sub.func.value
        if attr in _HOST_OP_METHODS:
            return True
        if attr in ("forward", "host_forward") and not (
                isinstance(recv, ast.Call) and _call_name(recv) == "super") \
                and not (isinstance(recv, ast.Name) and recv.id == "self"):
            return True
    return False


def _base_names(cls):
    return {b.attr if isinstance(b, ast.Attribute) else
            (b.id if isinstance(b, ast.Name) else None)
            for b in cls.bases}


def _blocking_reason(call, held, lock_norm):
    """Description if `call` blocks, given the currently-held lock set
    and a normalizer for the receiver expression.  `cond.wait()` on a
    HELD condition releases it (not a block here; Q006 owns it)."""
    name = _call_name(call)
    if name is None:
        return None
    func = call.func
    recv = func.value if isinstance(func, ast.Attribute) else None
    if name in ("wait",):
        norm = lock_norm(recv) if recv is not None else None
        if norm is not None and norm in held:
            return None          # releasing wait on the held condition
        if norm is not None:
            return "a condition/event wait"
        if _is_dist_work(recv):
            return "a torch.distributed Work.wait() (a device sync)"
        return None              # unknown receiver: too ambiguous
    if name in _BLOCKING_CALLS:
        return _BLOCKING_CALLS[name]
    if name == "join":
        # thread.join() / thread.join(timeout) — not str.join(seq) or
        # os.path.join(a, b): those take non-numeric positionals.
        if call.keywords and all(k.arg in ("timeout",)
                                 for k in call.keywords) \
                and not call.args:
            return "a thread join"
        if not call.args and not call.keywords:
            return "a thread join"
        if len(call.args) == 1 and not call.keywords:
            a = call.args[0]
            if isinstance(a, ast.Constant) and isinstance(
                    a.value, (int, float)):
                return "a thread join"
        return None
    if name == "run":
        dotted = _dotted(func) or ""
        if "subprocess" in dotted:
            return "a subprocess round-trip"
        return None
    if name in ("get", "put"):
        base = _base_name(func.value) if isinstance(
            func, ast.Attribute) else None
        attr = _self_attr(func.value) if isinstance(
            func, ast.Attribute) else None
        label = attr or base or ""
        if _QUEUEISH_NAME.search(label):
            # queue.put(block=False) / get_nowait-style are fine
            for k in call.keywords:
                if k.arg == "block" and isinstance(k.value, ast.Constant) \
                        and k.value.value is False:
                    return None
            return "a queue %s" % name
        return None
    return None


# ----------------------------------------------------------------------
# per-scope scan
# ----------------------------------------------------------------------
class _Access(object):
    __slots__ = ("name", "kind", "locks", "line", "method")

    def __init__(self, name, kind, locks, line, method):
        self.name = name        # attr name or module-global name
        self.kind = kind        # 'read' | 'write'
        self.locks = locks      # frozenset of normalized lock ids
        self.line = line
        self.method = method


class _ThreadSite(object):
    __slots__ = ("line", "method", "target", "assigned", "registered")

    def __init__(self, line, method, target):
        self.line = line
        self.method = method
        self.target = target     # ('method'|'function'|None, name)
        self.assigned = None     # local var / 'self.X' the Thread lands in
        self.registered = False


class _ScopeScan(object):
    """Scan one class (methods keyed by name) or one module's top-level
    functions.  `is_class` switches between `self.X` attribute tracking
    and module-global tracking."""

    def __init__(self, name, funcs, is_class, module):
        self.name = name              # class name or '<module>'
        self.funcs = funcs            # {fn_name: ast.FunctionDef}
        self.is_class = is_class
        self.module = module          # owning _ModuleScan
        self.lock_attrs = {}          # attr -> factory name
        self.alias = {}               # attr -> canonical lock attr
        self.entries = set()          # thread-entry fn names
        self.callbacks = set()        # callback-entry fn names
        self.calls = {}               # fn -> set(fn called)
        self.accesses = {}            # shared name -> [_Access]
        self.blocking = []            # (fn, line, what, locks)
        self.acq_edges = []           # (held, acquired, fn, line)
        self.top_acquires = {}        # fn -> set(locks at depth 0)
        self.method_call_sites = []   # (fn, callee, heldset)
        self.waits = []               # (fn, line, norm, while_depth)
        self.thread_sites = []        # [_ThreadSite]
        self.join_targets = set()     # names with .join() called on them
        self.registered_names = set() # names handed to _register_producer
        self.registry_funcs = set()   # fns that call the producer registry

    # -- lock identity ------------------------------------------------
    def lock_prefix(self):
        return "%s.%s" % (self.module.stub, self.name) if self.is_class \
            else self.module.stub

    def canon(self, attr):
        seen = set()
        while attr in self.alias and attr not in seen:
            seen.add(attr)
            attr = self.alias[attr]
        return attr

    def norm_lock(self, expr, fn_locals=None):
        """Normalize an expression to a lock id, else None."""
        if expr is None:
            return None
        attr = _self_attr(expr) if self.is_class else None
        if attr is not None:
            if attr in self.lock_attrs or attr in self.alias \
                    or _LOCKISH_NAME.search(attr):
                return "%s.%s" % (self.lock_prefix(), self.canon(attr))
            return None
        if isinstance(expr, ast.Name):
            nm = expr.id
            if fn_locals is not None and nm in fn_locals:
                return "%s.<local>.%s" % (self.lock_prefix(), nm)
            owner = self.module
            if nm in owner.lock_globals or _LOCKISH_NAME.search(nm):
                return "%s.%s" % (owner.stub, owner.canon_global(nm))
            return None
        if isinstance(expr, ast.Attribute):
            dotted = _dotted(expr)
            if dotted and _LOCKISH_NAME.search(dotted.rsplit(".", 1)[-1]):
                return "%s.%s" % (self.lock_prefix(), dotted)
            return None
        return None

    def is_sync_attr(self, attr):
        return attr in self.lock_attrs or attr in self.alias

    def cond_attr(self, attr):
        fac = self.lock_attrs.get(self.canon_raw(attr))
        if fac in _CONDITION_FACTORIES:
            return True
        return bool(_CONDISH_NAME.search(attr))

    def canon_raw(self, attr):
        return attr  # factory recorded under the original attr name

    # -- collection ---------------------------------------------------
    def collect_sync_decls(self):
        """Find lock/condition attrs & aliases from every method (init
        mostly) or module body."""
        for fname, fn in self.funcs.items():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                fac = _is_sync_factory(node.value)
                for tgt in node.targets:
                    attr = _self_attr(tgt) if self.is_class else None
                    if attr is None:
                        continue
                    if fac:
                        self.lock_attrs[attr] = fac
                        if fac in _CONDITION_FACTORIES \
                                and node.value.args:
                            src = _self_attr(node.value.args[0])
                            if src:
                                self.alias[attr] = src
                                self.lock_attrs.setdefault(src, "Lock")

    def add_access(self, name, kind, locks, line, fn):
        self.accesses.setdefault(name, []).append(
            _Access(name, kind, frozenset(locks), line, fn))

    def scan_all(self):
        self.collect_sync_decls()
        for fname, fn in self.funcs.items():
            _FnScan(self, fname, fn).run()
        # resolve 'maybe_function' entries now that funcs are known
        # (handled at record time); resolve thread-site registration
        for ts in self.thread_sites:
            if ts.assigned and ts.assigned in self.registered_names:
                ts.registered = True
            if ts.assigned and ts.assigned in self.join_targets:
                ts.registered = True
            # a registry call in the creating function covers loop-built
            # thread lists (`for t in ...: _register_producer(t)`)
            if ts.method in self.registry_funcs:
                ts.registered = True

    def effective_locks(self):
        """Extra locks an internal helper provably runs under: the
        intersection of the held sets at every same-scope call site
        (helpers only — entries/callbacks/public methods are called
        from outside with nothing held).  Two fixpoint rounds cover
        helper->helper chains."""
        internal = {m for m in self.funcs
                    if m.startswith("_") and not m.startswith("__")
                    and m not in self.entries
                    and m not in self.callbacks}
        sites = {}
        for caller, callee, held in self.method_call_sites:
            sites.setdefault(callee, []).append((caller, held))
        extra = {m: frozenset() for m in self.funcs}
        for _ in range(3):
            for m in internal:
                ss = sites.get(m)
                if not ss:
                    continue
                sets = [held | extra.get(caller, frozenset())
                        for caller, held in ss]
                extra[m] = frozenset.intersection(*sets)
        return extra

    # -- closure / contexts -------------------------------------------
    def _closure(self, roots):
        out = set(roots)
        frontier = list(roots)
        while frontier:
            m = frontier.pop()
            for callee in self.calls.get(m, ()):  # same-scope calls
                if callee not in out and callee in self.funcs:
                    out.add(callee)
                    frontier.append(callee)
        return out

    def contexts(self):
        """fn -> set of root tags ('main', 'thread:<e>', 'callback:<c>')."""
        called = set()
        for c in self.calls.values():
            called |= c
        ctx = {}
        for e in self.entries:
            if e not in self.funcs:
                continue
            for m in self._closure({e}):
                ctx.setdefault(m, set()).add("thread:%s" % e)
        for c in self.callbacks:
            if c not in self.funcs:
                continue
            for m in self._closure({c}):
                ctx.setdefault(m, set()).add("callback:%s" % c)
        main_roots = set()
        for m in self.funcs:
            if m in ("__init__", "__del__"):
                continue
            if m in self.entries or m in self.callbacks:
                continue
            if m.startswith("_") and not m.startswith("__") \
                    and m in called:
                continue           # internal helper: context = callers'
            main_roots.add(m)
        for m in self._closure(main_roots):
            ctx.setdefault(m, set()).add("main")
        return ctx


class _FnScan(object):
    """Flow-sensitive-enough walk of one function: tracks the set of
    held locks through `with` nesting and block-scoped acquire()/
    release(), records shared accesses / blocking calls / lock-order
    edges / thread+callback entries."""

    def __init__(self, scope, fname, fn):
        self.scope = scope
        self.fname = fname
        self.fn = fn
        self.locals = set()
        self.global_decls = set()
        self.nested = {}          # name -> (node, def_held)
        self.nested_call_held = {}  # name -> [heldsets at call sites]
        self._thread_calls_seen = set()   # id(Call) already recorded
        self.name_alias = {}      # local var -> 'self.X' it came from
        for arg in ast.walk(fn.args):
            if isinstance(arg, ast.arg):
                self.locals.add(arg.arg)

    # -- entry --------------------------------------------------------
    def run(self):
        sc = self.scope
        decs = _decorator_names(self.fn)
        if _ENTRY_DECORATOR in decs:
            sc.entries.add(self.fname)
        self._stmts(self.fn.body, frozenset(), 0)
        # nested defs: body runs under the locks held at EVERY call
        # site (intersection); if never called locally, the def site's.
        # (walking a nested body can register deeper nested defs, so
        # drain as a worklist)
        done = set()
        while True:
            pending = [n for n in self.nested if n not in done]
            if not pending:
                break
            for name in pending:
                done.add(name)
                node, def_held = self.nested[name]
                helds = self.nested_call_held.get(name)
                if helds:
                    held = frozenset.intersection(
                        *[frozenset(h) for h in helds])
                else:
                    held = def_held
                self._stmts(node.body, frozenset(held), 0)

    # -- statements ---------------------------------------------------
    def _stmts(self, body, held, while_depth):
        held = set(held)
        for stmt in body:
            self._stmt(stmt, held, while_depth)

    def _stmt(self, stmt, held, while_depth):
        sc = self.scope
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in stmt.items:
                lock = sc.norm_lock(item.context_expr, self.locals)
                self._expr(item.context_expr, frozenset(held),
                           while_depth)
                if lock is not None:
                    self._record_acquire(lock, inner, stmt.lineno)
                    inner.add(lock)
                if item.optional_vars is not None:
                    self._targets(item.optional_vars, frozenset(held),
                                  stmt.lineno)
            self._stmts(stmt.body, frozenset(inner), while_depth)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.locals.add(stmt.name)
            self.nested[stmt.name] = (stmt, frozenset(held))
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.Global):
            self.global_decls.update(stmt.names)
            return
        if isinstance(stmt, ast.Assign):
            self._maybe_thread_assign(stmt, held)
            self._record_aliases(stmt)
            self._expr(stmt.value, frozenset(held), while_depth)
            for tgt in stmt.targets:
                self._targets(tgt, frozenset(held), stmt.lineno)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, frozenset(held), while_depth)
            self._targets(stmt.target, frozenset(held), stmt.lineno)
            # aug-assign also reads
            self._load_of_target(stmt.target, frozenset(held),
                                 stmt.lineno)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, frozenset(held), while_depth)
                self._targets(stmt.target, frozenset(held), stmt.lineno)
            return
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self._targets(tgt, frozenset(held), stmt.lineno)
            return
        if isinstance(stmt, ast.Expr):
            call = stmt.value
            if isinstance(call, ast.Call):
                name = _call_name(call)
                recv = call.func.value if isinstance(
                    call.func, ast.Attribute) else None
                if name == "acquire":
                    lock = sc.norm_lock(recv, self.locals)
                    if lock is not None:
                        self._record_acquire(lock, held, stmt.lineno)
                        held.add(lock)      # rest of this block
                        return
                if name == "release":
                    lock = sc.norm_lock(recv, self.locals)
                    if lock is not None:
                        held.discard(lock)
                        return
            self._expr(stmt.value, frozenset(held), while_depth)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, frozenset(held), while_depth)
            self._stmts(stmt.body, frozenset(held), while_depth)
            self._stmts(stmt.orelse, frozenset(held), while_depth)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, frozenset(held), while_depth + 1)
            self._stmts(stmt.body, frozenset(held), while_depth + 1)
            self._stmts(stmt.orelse, frozenset(held), while_depth)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, frozenset(held), while_depth)
            self._targets(stmt.target, frozenset(held), stmt.lineno,
                          loop_target=True)
            self._stmts(stmt.body, frozenset(held), while_depth)
            self._stmts(stmt.orelse, frozenset(held), while_depth)
            # `for t in self.threads: t.join()` — record join target
            self._loop_join_probe(stmt)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, frozenset(held), while_depth)
            for h in stmt.handlers:
                self._stmts(h.body, frozenset(held), while_depth)
            self._stmts(stmt.orelse, frozenset(held), while_depth)
            self._stmts(stmt.finalbody, frozenset(held), while_depth)
            return
        if isinstance(stmt, (ast.Return, ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                self._expr(child, frozenset(held), while_depth)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, frozenset(held), while_depth)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held, while_depth)

    def _record_acquire(self, lock, held, line):
        sc = self.scope
        for h in held:
            if h != lock:
                sc.acq_edges.append((h, lock, self.fname, line))
        if not held:
            sc.top_acquires.setdefault(self.fname, set()).add(lock)

    def _loop_join_probe(self, stmt):
        """for t in <anything>: t.join() — the loop var's join makes
        the iterated collection a join target."""
        if not isinstance(stmt.target, ast.Name):
            return
        var = stmt.target.id
        joins = False
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) and _call_name(sub) == "join":
                f = sub.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == var:
                    joins = True
        if not joins:
            return
        attr = _self_attr(stmt.iter)
        if attr:
            self.scope.join_targets.add("self.%s" % attr)
        else:
            base = _base_name(stmt.iter)
            if base:
                self.scope.join_targets.add(base)

    # -- assignment targets -------------------------------------------
    def _targets(self, tgt, held, line, loop_target=False):
        sc = self.scope
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._targets(el, held, line, loop_target)
            return
        if isinstance(tgt, ast.Starred):
            self._targets(tgt.value, held, line, loop_target)
            return
        if isinstance(tgt, ast.Name):
            if tgt.id in self.global_decls:
                self._global_access(tgt.id, "write", held, line)
            else:
                self.locals.add(tgt.id)
            return
        if isinstance(tgt, ast.Attribute):
            attr = _self_attr(tgt)
            if attr and sc.is_class and not sc.is_sync_attr(attr):
                sc.add_access(attr, "write", held, line, self.fname)
            return
        if isinstance(tgt, ast.Subscript):
            attr = _self_attr(tgt)
            if attr and sc.is_class and not sc.is_sync_attr(attr):
                sc.add_access(attr, "write", held, line, self.fname)
                return
            base = _base_name(tgt)
            if base and not sc.is_class:
                self._global_access(base, "write", held, line)
            elif base and base not in self.locals:
                self._global_access(base, "write", held, line)
            self._expr(tgt.value, held, 0)

    def _load_of_target(self, tgt, held, line):
        attr = _self_attr(tgt)
        if attr and self.scope.is_class \
                and not self.scope.is_sync_attr(attr):
            self.scope.add_access(attr, "read", held, line, self.fname)

    def _global_access(self, name, kind, held, line):
        mod = self.scope.module
        if name in mod.globals_ and name not in self.locals:
            mod.global_accesses.setdefault(name, []).append(
                _Access(name, kind, frozenset(held), line,
                        "%s.%s" % (self.scope.name, self.fname)
                        if self.scope.is_class else self.fname))

    # -- thread creation ----------------------------------------------
    def _maybe_thread_assign(self, stmt, held):
        """self._t = Thread(...) / t = Thread(...): remember where the
        thread object lands for the Q004 join/registry check."""
        val = stmt.value
        if not (isinstance(val, ast.Call)
                and _call_name(val) in _THREAD_FACTORIES):
            return
        ts = self._thread_site(val)
        for tgt in stmt.targets:
            attr = _self_attr(tgt)
            if attr:
                ts.assigned = "self.%s" % attr
            elif isinstance(tgt, ast.Name):
                ts.assigned = tgt.id

    def _record_aliases(self, stmt):
        """`t = self._thread` (also in tuple unpacking, e.g. the
        `t, self._thread = self._thread, None` handoff) makes `t.join()`
        count as a join of `self._thread` for Q004."""
        pairs = []
        for tgt in stmt.targets:
            if isinstance(tgt, (ast.Tuple, ast.List)) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)) \
                    and len(tgt.elts) == len(stmt.value.elts):
                pairs.extend(zip(tgt.elts, stmt.value.elts))
            else:
                pairs.append((tgt, stmt.value))
        for t, v in pairs:
            if isinstance(t, ast.Name):
                attr = _self_attr(v)
                if attr:
                    self.name_alias[t.id] = "self.%s" % attr
                elif t.id in self.name_alias:
                    del self.name_alias[t.id]

    def _thread_site(self, call):
        sc = self.scope
        if id(call) in self._thread_calls_seen:
            for ts in sc.thread_sites:
                if ts.line == call.lineno and ts.method == self.fname:
                    return ts
        self._thread_calls_seen.add(id(call))
        target = (None, None)
        tgt_expr = None
        for k in call.keywords:
            if k.arg == "target":
                tgt_expr = k.value
        if tgt_expr is None and len(call.args) >= 2:
            tgt_expr = call.args[1]
        if tgt_expr is not None:
            for kind, name in _callable_refs(tgt_expr, sc.funcs):
                if kind == "method" and name in sc.funcs:
                    sc.entries.add(name)
                    target = ("method", name)
                elif kind in ("function", "maybe_function"):
                    mod = sc.module
                    if name in mod.module_funcs:
                        mod.module_scope.entries.add(name)
                        target = ("function", name)
        ts = _ThreadSite(call.lineno, self.fname, target)
        sc.thread_sites.append(ts)
        return ts

    # -- expressions --------------------------------------------------
    def _expr(self, node, held, while_depth):
        if node is None or not isinstance(node, ast.AST):
            return
        sc = self.scope
        if isinstance(node, ast.Call):
            self._call(node, held, while_depth)
            return
        if isinstance(node, ast.Lambda):
            # inline body with current held (conservative)
            self._expr(node.body, held, while_depth)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, ast.Attribute):
            attr = _self_attr(node)
            if attr and sc.is_class and isinstance(node.ctx, ast.Load) \
                    and attr not in sc.funcs \
                    and not sc.is_sync_attr(attr):
                sc.add_access(attr, "read", held, node.lineno,
                              self.fname)
            self._expr(node.value, held, while_depth)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                self._global_read(node, held)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, held, while_depth)

    def _global_read(self, node, held):
        mod = self.scope.module
        nm = node.id
        if nm in mod.globals_ and nm not in self.locals \
                and nm not in mod.module_funcs \
                and nm not in mod.lock_globals:
            mod.global_accesses.setdefault(nm, []).append(
                _Access(nm, "read", frozenset(held), node.lineno,
                        "%s.%s" % (self.scope.name, self.fname)
                        if self.scope.is_class else self.fname))

    def _call(self, call, held, while_depth):
        sc = self.scope
        name = _call_name(call)
        func = call.func
        recv = func.value if isinstance(func, ast.Attribute) else None

        # nested-def call sites: remember the held set
        if isinstance(func, ast.Name) and func.id in self.nested:
            self.nested_call_held.setdefault(func.id, []).append(
                frozenset(held))

        # same-scope method calls feed the closure + lock one-hop
        if recv is not None:
            attr = _self_attr(func)
            if attr and attr in sc.funcs:
                sc.calls.setdefault(self.fname, set()).add(attr)
                sc.method_call_sites.append(
                    (self.fname, attr, frozenset(held)))
        elif isinstance(func, ast.Name) and not sc.is_class \
                and func.id in sc.funcs:
            sc.calls.setdefault(self.fname, set()).add(func.id)
            sc.method_call_sites.append(
                (self.fname, func.id, frozenset(held)))

        # thread / submit / callback entry extraction
        if name in _THREAD_FACTORIES:
            self._thread_site(call)
        elif name in _SUBMIT_CALLS:
            for arg in list(call.args) + [k.value for k in
                                          call.keywords]:
                for kind, ref in _callable_refs(arg, sc.funcs):
                    if kind == "method" and ref in sc.funcs:
                        sc.entries.add(ref)
                    elif kind == "function" \
                            and ref in sc.module.module_funcs:
                        sc.module.module_scope.entries.add(ref)
        elif name in _CALLBACK_HOSTS:
            for arg in list(call.args) + [k.value for k in
                                          call.keywords]:
                for kind, ref in _callable_refs(arg, sc.funcs):
                    if kind == "method" and ref in sc.funcs:
                        sc.callbacks.add(ref)
                    elif kind in ("function", "maybe_function") \
                            and ref in sc.module.module_funcs:
                        sc.module.module_scope.callbacks.add(ref)
        elif name in _REGISTRY_CALLS:
            sc.registry_funcs.add(self.fname)
            for arg in call.args:
                attr = _self_attr(arg)
                if attr:
                    sc.registered_names.add("self.%s" % attr)
                elif isinstance(arg, ast.Name):
                    sc.registered_names.add(arg.id)

        # join targets for Q004
        if name == "join" and recv is not None:
            attr = _self_attr(recv)
            if attr:
                sc.join_targets.add("self.%s" % attr)
            elif isinstance(recv, ast.Name):
                sc.join_targets.add(recv.id)
                alias = self.name_alias.get(recv.id)
                if alias:
                    sc.join_targets.add(alias)

        # Q006: condition wait without a while re-check
        if name == "wait" and recv is not None:
            attr = _self_attr(recv)
            norm = sc.norm_lock(recv, self.locals)
            is_cond = False
            if attr is not None:
                fac = sc.lock_attrs.get(attr) or sc.lock_attrs.get(
                    sc.canon(attr))
                is_cond = (fac in _CONDITION_FACTORIES
                           or (fac is None
                               and _CONDISH_NAME.search(attr)))
            elif isinstance(recv, ast.Name):
                is_cond = bool(_CONDISH_NAME.search(recv.id))
            if is_cond:
                sc.waits.append((self.fname, call.lineno,
                                 norm or "?", while_depth))

        # Q003: blocking under lock
        if held:
            reason = _blocking_reason(
                call, held, lambda e: sc.norm_lock(e, self.locals))
            if reason is not None:
                sc.blocking.append((self.fname, call.lineno, reason,
                                    frozenset(held)))

        # Q001 write via mutator calls: self.buf.append(x)
        if name in _MUTATORS and recv is not None:
            attr = _self_attr(recv)
            if attr and sc.is_class and not sc.is_sync_attr(attr):
                sc.add_access(attr, "write", held, call.lineno,
                              self.fname)
            elif not attr:
                base = _base_name(recv)
                if base and base not in self.locals:
                    self._global_access(base, "write", held,
                                        call.lineno)

        self._expr(func.value if isinstance(func, ast.Attribute)
                   else None, held, while_depth)
        for arg in call.args:
            self._expr(arg, held, while_depth)
        for k in call.keywords:
            self._expr(k.value, held, while_depth)


# ----------------------------------------------------------------------
# module scan
# ----------------------------------------------------------------------
class _ModuleScan(object):
    def __init__(self, rel, tree):
        self.rel = rel
        self.stub = os.path.splitext(os.path.basename(rel))[0]
        self.tree = tree
        self.globals_ = set()         # module-level mutable names
        self.lock_globals = {}        # name -> factory
        self.global_alias = {}
        self.module_funcs = {}        # name -> node
        self.classes = []             # [_ScopeScan]
        self.global_accesses = {}     # name -> [_Access]
        self.module_scope = None

    def canon_global(self, name):
        seen = set()
        while name in self.global_alias and name not in seen:
            seen.add(name)
            name = self.global_alias[name]
        return name

    def scan(self):
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                fac = _is_sync_factory(node.value)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if fac:
                            self.lock_globals[tgt.id] = fac
                            if fac in _CONDITION_FACTORIES \
                                    and node.value.args \
                                    and isinstance(node.value.args[0],
                                                   ast.Name):
                                self.global_alias[tgt.id] = \
                                    node.value.args[0].id
                        else:
                            self.globals_.add(tgt.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
        self.module_scope = _ScopeScan("<module>", self.module_funcs,
                                       False, self)
        scopes = [self.module_scope]
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                methods = {}
                callback_class = False
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods[item.name] = item
                    elif isinstance(item, ast.Assign):
                        for tgt in item.targets:
                            if isinstance(tgt, ast.Name) \
                                    and tgt.id == "host_callback" \
                                    and isinstance(item.value,
                                                   ast.Constant) \
                                    and item.value.value is True:
                                callback_class = True
                sc = _ScopeScan(node.name, methods, True, self)
                sc.class_line = node.lineno
                if callback_class:
                    for m in ("forward", "backward"):
                        if m in methods:
                            sc.callbacks.add(m)
                bases = _base_names(node)
                if "backward" in methods and (
                        "CustomOp" in bases or (
                            "Function" in bases and "forward" in methods
                            and _runs_host_op(methods["forward"]))):
                    sc.callbacks.add("backward")
                self.classes.append(sc)
                scopes.append(sc)
        for sc in scopes:
            sc.scan_all()
        return scopes


# ----------------------------------------------------------------------
# findings
# ----------------------------------------------------------------------
_SEVERITY = {
    "MXL-Q001": "error", "MXL-Q002": "error", "MXL-Q003": "warning",
    "MXL-Q004": "warning", "MXL-Q005": "error", "MXL-Q006": "warning",
}


def _tag_label(tag):
    if tag == "main":
        return "the main/API path"
    kind, _, root = tag.partition(":")
    return "the %s path through %s()" % (
        "thread" if kind == "thread" else "host-callback", root)


def _scope_findings(sc, rel):
    """Q001/Q003/Q004/Q005/Q006 findings for one scope; yields
    (rule, line, qualname, message)."""
    ctx = sc.contexts()
    extra = sc.effective_locks()
    qual = (lambda m: "%s.%s" % (sc.name, m)) if sc.is_class \
        else (lambda m: m)

    def locks_of(a):
        return a.locks | extra.get(a.method, frozenset())

    # Q001 / Q005: shared state without a common lock
    reported = set()
    for attr, accs in sorted(sc.accesses.items()):
        if attr in reported:
            continue
        accs = [a for a in accs
                if a.method not in ("__init__", "__del__")]
        writes = [a for a in accs if a.kind == "write"]
        if not writes:
            continue
        hit = None
        for w in writes:
            for b in accs:
                if locks_of(w) & locks_of(b):
                    continue
                tw = ctx.get(w.method, set())
                tb = ctx.get(b.method, set())
                pairs = {(x, y) for x in tw for y in tb if x != y}
                if not pairs:
                    continue
                hit = (w, b, sorted(pairs)[0])
                break
            if hit:
                break
        if not hit:
            continue
        w, b, (tx, ty) = hit
        rule = "MXL-Q005" if (tx.startswith("callback")
                              or ty.startswith("callback")) \
            else "MXL-Q001"
        owner = "%s.%s" % (sc.name, attr) if sc.is_class else attr
        yield (rule, w.line, qual(w.method),
               "shared %s `%s` is written in %s() on %s (line %d) and "
               "%s in %s() on %s (line %d) with no common lock held"
               % ("attribute" if sc.is_class else "module global",
                  owner, w.method, _tag_label(tx), w.line,
                  b.kind, b.method, _tag_label(ty), b.line))
        reported.add(attr)

    # Q003: blocking call under lock (a helper's inherited locks from
    # effective_locks would be speculative for *blocking* — only flag
    # locks visibly held at the site)
    seen = set()
    for fname, line, what, locks in sc.blocking:
        key = (fname, line)
        if key in seen:
            continue
        seen.add(key)
        yield ("MXL-Q003", line, qual(fname),
               "%s while holding %s: the lock is pinned for the "
               "duration and every other thread needing it stalls"
               % (what, ", ".join(sorted(locks))))

    # Q004: unjoined/unregistered thread
    for ts in sc.thread_sites:
        if ts.registered:
            continue
        tlabel = ts.target[1] or "<dynamic>"
        yield ("MXL-Q004", ts.line, qual(ts.method),
               "thread targeting %s() is started without the io.py "
               "producer registry (_register_producer) and without a "
               "join path in this %s — it can outlive shutdown"
               % (tlabel, "class" if sc.is_class else "module"))

    # Q006: condition wait without while-predicate re-check
    for fname, line, norm, while_depth in sc.waits:
        if while_depth > 0:
            continue
        yield ("MXL-Q006", line, qual(fname),
               "Condition.wait() on %s outside a while-predicate "
               "re-check loop: spurious wakeups and stolen notifies "
               "break the invariant (use `while not pred: cv.wait()` "
               "or cv.wait_for(pred))" % norm)


def _module_global_findings(mod):
    """Q001/Q005 over module globals (accesses recorded from every
    scope in the file, contexts from the module function graph)."""
    sc = mod.module_scope
    ctx = sc.contexts()
    # fold in class-method accessors: context tags from their own class
    cls_ctx = {}
    for cls in mod.classes:
        cctx = cls.contexts()
        for m, tags in cctx.items():
            cls_ctx["%s.%s" % (cls.name, m)] = tags
    for name, accs in sorted(mod.global_accesses.items()):
        accs = [a for a in accs
                if not a.method.endswith(".__init__")]
        writes = [a for a in accs if a.kind == "write"]
        if not writes:
            continue
        hit = None
        for w in writes:
            for b in accs:
                if w.locks & b.locks:
                    continue
                tw = ctx.get(w.method) or cls_ctx.get(w.method) \
                    or {"main"}
                tb = ctx.get(b.method) or cls_ctx.get(b.method) \
                    or {"main"}
                pairs = {(x, y) for x in tw for y in tb if x != y}
                if not pairs:
                    continue
                hit = (w, b, sorted(pairs)[0])
                break
            if hit:
                break
        if not hit:
            continue
        w, b, (tx, ty) = hit
        rule = "MXL-Q005" if (tx.startswith("callback")
                              or ty.startswith("callback")) \
            else "MXL-Q001"
        yield (rule, w.line, w.method,
               "shared module global `%s` is written in %s() on %s "
               "(line %d) and %s in %s() on %s (line %d) with no "
               "common lock held"
               % (name, w.method, _tag_label(tx), w.line,
                  b.kind, b.method, _tag_label(ty), b.line))


def _lock_cycles(edges):
    """edges: {(A, B): (rel, qual, line)}.  Return cycles as lists of
    nodes (each cycle reported once, rotation-normalized)."""
    graph = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles, seen = [], set()

    def dfs(node, path, on_path):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                nodes = cyc[:-1]
                pivot = min(range(len(nodes)),
                            key=lambda i: nodes[i])
                norm = tuple(nodes[pivot:] + nodes[:pivot])
                if norm not in seen:
                    seen.add(norm)
                    cycles.append(list(norm) + [norm[0]])
            elif nxt in graph and nxt not in visited_from_here:
                visited_from_here.add(nxt)
                path.append(nxt)
                on_path.add(nxt)
                dfs(nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

    for start in sorted(graph):
        visited_from_here = set()
        dfs(start, [start], {start})
    return cycles


def _enclosing_def_lines(tree):
    """line -> the def/class lines enclosing it, in one walk of the
    tree."""
    out = {}
    stack = [(tree, ())]
    while stack:
        node, encl = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            encl = encl + (node.lineno,)
        ln = getattr(node, "lineno", None)
        if ln is not None and encl:
            out.setdefault(ln, set()).update(encl)
        stack.extend((c, encl) for c in ast.iter_child_nodes(node))
    return out


def analyze_concurrency_paths(paths, root=None):
    """Run MXL-Q001..Q006 over .py files/dirs.  Returns a list of
    finding dicts: {rule, line, anchor, message[, severity]}."""
    root = root or os.getcwd()
    findings = []
    parsed = []
    for path in iter_py_files(paths):
        source, tree = _parse(path)
        rel = os.path.relpath(path, root)
        if source is None:
            findings.append({
                "rule": "MXL-Q001", "line": 0,
                "anchor": "%s:<file>" % rel, "severity": "warning",
                "message": "cannot parse %s for the concurrency lint: "
                           "%s" % (rel, tree)})
            continue
        parsed.append((rel, source, tree))

    lock_edges = {}        # (A, B) -> (rel, qual, line)
    per_file = []          # (rel, suppress, raw findings)
    for rel, source, tree in parsed:
        mod = _ModuleScan(rel, tree)
        scopes = mod.scan()
        raw = []
        for sc in scopes:
            # one-hop lock edges through same-scope calls
            for caller, callee, held in sc.method_call_sites:
                if not held:
                    continue
                for lock in sc.top_acquires.get(callee, ()):
                    for h in held:
                        if h != lock:
                            sc.acq_edges.append(
                                (h, lock, caller, 0))
            for (a, b, fname, line) in sc.acq_edges:
                qual = "%s.%s" % (sc.name, fname) if sc.is_class \
                    else fname
                lock_edges.setdefault((a, b), (rel, qual, line))
            raw.extend(_scope_findings(sc, rel))
        raw.extend(_module_global_findings(mod))
        per_file.append((rel, source, tree, raw))

    # Q002 cycles (package-wide graph)
    cycle_findings = {}    # rel -> [(rule, line, qual, message)]
    for cyc in _lock_cycles(lock_edges):
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            sites.append((a, b) + lock_edges[(a, b)])
        rel0, qual0, line0 = sites[0][2], sites[0][3], sites[0][4]
        order = " -> ".join(cyc)
        detail = "; ".join("%s before %s at %s:%s" % (a, b, r, q)
                           for a, b, r, q, _l in sites)
        cycle_findings.setdefault(rel0, []).append(
            ("MXL-Q002", line0, qual0,
             "lock-order cycle %s: %s — threads taking these locks in "
             "opposing orders can deadlock" % (order, detail)))

    for rel, source, tree, raw in per_file:
        raw = raw + cycle_findings.get(rel, [])
        suppress = _suppressions(source)
        # def/class lines participate in suppression
        anchor_lines = _enclosing_def_lines(tree) if raw else {}
        for rule, line, qualname, message in raw:
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
    if "concurrency" not in ctx.cache:
        ctx.cache["concurrency"] = \
            analyze_concurrency_paths(ctx.source_paths)
    return ctx.cache["concurrency"]


def _relay(ctx, rule):
    if not ctx.source_paths:
        return
    for f in _source_findings(ctx):
        if f["rule"] == rule:
            ctx.report(None, f["message"],
                       severity=f.get("severity"),
                       anchor=f["anchor"], line=f["line"])


@register_rule("MXL-Q001", "error",
               "shared attribute raced across threads without a "
               "common lock")
def thread_shared_race(ctx):
    """An attribute/global written on a thread-entry path and touched
    on another thread's path with no common lock held."""
    _relay(ctx, "MXL-Q001")


@register_rule("MXL-Q002", "error",
               "lock-order cycle (potential deadlock)")
def lock_order_cycle(ctx):
    """The package-wide acquired-while-held graph has a cycle."""
    _relay(ctx, "MXL-Q002")


@register_rule("MXL-Q003", "warning",
               "blocking call while holding a lock")
def blocking_under_lock(ctx):
    """queue/future/join/socket/subprocess/device-sync call executed
    with a lock held."""
    _relay(ctx, "MXL-Q003")


@register_rule("MXL-Q004", "warning",
               "thread started without registry or join path")
def unjoined_thread(ctx):
    """Thread outside the io.py producer registry with no join."""
    _relay(ctx, "MXL-Q004")


@register_rule("MXL-Q005", "error",
               "host-callback mutates step-path state unsynchronized")
def callback_context_violation(ctx):
    """A host-callback body writes state the step path also touches
    with no common lock — the torch bridge's host-callback race."""
    _relay(ctx, "MXL-Q005")


@register_rule("MXL-Q006", "warning",
               "condition wait without predicate re-check loop")
def wait_without_recheck(ctx):
    """Condition.wait() not wrapped in a while-predicate loop."""
    _relay(ctx, "MXL-Q006")
