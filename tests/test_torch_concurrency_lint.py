"""The port's concurrency lint (``mxnet_tpu_torch/analysis/
concurrency.py``, MXL-Q001..Q006) against the JAX package's, and the
repairs of what it found in the port.

Every snippet that ``tests/test_concurrency_lint.py`` lints and every
file under ``tests/fixtures/concurrency/`` goes through both analyzers
with equal ``(rule, severity, anchor, line)`` lists; so does the whole
``mxnet_tpu/`` tree, but for :data:`TORCH_ONLY`.  Each torch entry of the
vocabulary (the device syncs under a lock, ``Work.wait()``, the
autograd-thread callbacks) has a firing twin and a clean one.  The
port's own findings were repaired or carry a reasoned mark; the repairs'
regression tests force the racing interleaving with ``threading.Event``s
and fail on the code before the repair.
"""
import os
import threading
import types

import numpy as np
import pytest

from mxnet_tpu.analysis import concurrency as jcon
from mxnet_tpu_torch.analysis import concurrency as tcon

from test_torch_divergence_lint import (ROOT, both, fixture_files, lint,
                                        reference_snippets, rows,
                                        rules_of)
from mxnet_tpu import analysis as jan
from mxnet_tpu_torch import analysis as tan

REFERENCE = os.path.join(ROOT, "tests", "test_concurrency_lint.py")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "concurrency")

#: (anchor, rule) of the findings over ``mxnet_tpu/`` that only the torch
#: vocabulary makes (none: the JAX tree holds no device sync under a
#: lock, no hook and no autograd Function)
TORCH_ONLY = set()

SNIPPETS = reference_snippets(REFERENCE, {"_lint"})


def test_the_reference_snippets_were_found():
    assert len(SNIPPETS) == 32


@pytest.mark.parametrize("case,fname,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_reference_snippet_parity(tmp_path, case, fname, code):
    j, t = both(tmp_path, fname, code, jcon.analyze_concurrency_paths,
                tcon.analyze_concurrency_paths)
    assert t == j


@pytest.mark.parametrize("path", fixture_files(FIXTURES),
                         ids=os.path.basename)
def test_fixture_parity(path):
    j = rows(jcon.analyze_concurrency_paths([path], root=ROOT),
             jan.RULE_REGISTRY)
    t = rows(tcon.analyze_concurrency_paths([path], root=ROOT),
             tan.RULE_REGISTRY)
    assert j and t == j


def test_jax_tree_parity():
    pkg = [os.path.join(ROOT, "mxnet_tpu")]
    j = rows(jcon.analyze_concurrency_paths(pkg, root=ROOT),
             jan.RULE_REGISTRY)
    t = rows(tcon.analyze_concurrency_paths(pkg, root=ROOT),
             tan.RULE_REGISTRY)
    extra = [r for r in t if (r[2], r[0]) in TORCH_ONLY]
    assert sorted({(r[2], r[0]) for r in extra}) == sorted(TORCH_ONLY)
    assert [r for r in t if r not in extra] == j


def test_port_self_lint_clean():
    fs = tcon.analyze_concurrency_paths(
        [os.path.join(ROOT, "mxnet_tpu_torch")], root=ROOT)
    assert fs == [], [(f["rule"], f["anchor"], f["line"]) for f in fs]


# ----------------------------------------------------------------------
# the torch vocabulary: a firing twin and a clean twin each
# ----------------------------------------------------------------------
_LOCKED = ("import threading\nimport torch\n"
           "import torch.distributed as dist\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def f(self, t, ev, stream):\n"
           "        with self._lock:\n"
           "            {inside}\n"
           "        {outside}\n")

#: (name, statement that blocks) for Q003: under the lock it fires, after
#: the ``with`` it does not
BLOCKING = [
    ("torch_cuda_synchronize", "torch.cuda.synchronize()"),
    ("event_synchronize", "ev.synchronize()"),
    ("stream_synchronize", "stream.synchronize()"),
    ("work_wait_async_op", "dist.all_reduce(t, async_op=True).wait()"),
    ("work_wait_isend", "dist.isend(t, 1).wait()"),
    ("work_wait_named", "work.wait()"),
    ("tensor_item", "n = t.item()"),
    ("tensor_tolist", "xs = t.tolist()"),
    ("tensor_cpu", "h = t.cpu()"),
]


@pytest.mark.parametrize("name,stmt", BLOCKING, ids=[b[0] for b in BLOCKING])
def test_device_sync_under_lock_twins(tmp_path, name, stmt):
    fire = _LOCKED.format(inside=stmt, outside="pass")
    got = lint(tmp_path, fire, tcon.analyze_concurrency_paths)
    assert rules_of(got) == ["MXL-Q003"], got
    assert "sync" in got[0]["message"]
    clean = _LOCKED.format(inside="pass", outside=stmt)
    assert lint(tmp_path, clean, tcon.analyze_concurrency_paths,
                "clean.py") == []
    # the JAX vocabulary alone does not see it
    assert jcon.analyze_concurrency_paths([str(tmp_path / "snippet.py")],
                                          root=str(tmp_path)) == []


def test_other_waits_stay_unflagged(tmp_path):
    # a receiver that names no work, no event and no condition is too
    # ambiguous: the JAX rule's reading is kept
    code = _LOCKED.format(inside="fut.wait()", outside="pass")
    assert lint(tmp_path, code, tcon.analyze_concurrency_paths) == []


_FN_FIRE = ("import torch\n"
            "STATS = {}\n"
            "class HostFn(torch.autograd.Function):\n"
            "    @staticmethod\n"
            "    def forward(ctx, run, x):\n"
            "        ctx.run = run\n"
            "        return run.forward(x)\n"
            "    @staticmethod\n"
            "    def backward(ctx, g):\n"
            "        STATS['calls'] = STATS.get('calls', 0) + 1\n"
            "        return None, g\n"
            "def report():\n"
            "    return dict(STATS)\n")

#: (name, firing snippet, clean twin) for Q005
CALLBACKS = [
    ("autograd_function_host_op", _FN_FIRE,
     _FN_FIRE.replace("import torch\n", "import threading, torch\n"
                      "LOCK = threading.Lock()\n")
     .replace("        STATS['calls'] =",
              "        with LOCK:\n            STATS['calls'] =")
     .replace("    return dict(STATS)", "    with LOCK:\n"
              "        return dict(STATS)")),
    ("autograd_function_item", _FN_FIRE.replace(
        "return run.forward(x)", "return x * x.sum().item()"),
     # a forward with no host op: its backward is not a host callback
     _FN_FIRE.replace("return run.forward(x)", "return x * 2")),
    ("custom_op_backward",
     "class Op(CustomOp):\n"
     "    def backward(self, req, out_grad, in_data, out_data, in_grad,"
     " aux):\n"
     "        self._n = self._n + 1\n"
     "    def calls(self):\n"
     "        return self._n\n",
     "import threading\n"
     "class Op(CustomOp):\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "    def backward(self, req, out_grad, in_data, out_data, in_grad,"
     " aux):\n"
     "        with self._lock:\n"
     "            self._n = self._n + 1\n"
     "    def calls(self):\n"
     "        with self._lock:\n"
     "            return self._n\n"),
]
for _hook in ("register_hook", "register_post_accumulate_grad_hook",
              "register_forward_hook", "register_forward_pre_hook",
              "register_full_backward_hook",
              "register_full_backward_pre_hook", "register_backward_hook",
              "register_module_forward_hook",
              "register_module_full_backward_hook"):
    CALLBACKS.append((
        _hook,
        "class M:\n"
        "    def attach(self, t):\n"
        "        self._h = t.%s(self._on_grad)\n"
        "    def _on_grad(self, *a):\n"
        "        self._norm = a[-1]\n"
        "    def norm(self):\n"
        "        return self._norm\n" % _hook,
        "import threading\n"
        "class M:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def attach(self, t):\n"
        "        self._h = t.%s(self._on_grad)\n"
        "    def _on_grad(self, *a):\n"
        "        with self._lock:\n"
        "            self._norm = a[-1]\n"
        "    def norm(self):\n"
        "        with self._lock:\n"
        "            return self._norm\n" % _hook))


@pytest.mark.parametrize("name,fire,clean", CALLBACKS,
                         ids=[c[0] for c in CALLBACKS])
def test_callback_context_twins(tmp_path, name, fire, clean):
    got = lint(tmp_path, fire, tcon.analyze_concurrency_paths)
    assert rules_of(got) == ["MXL-Q005"], got
    assert "host-callback" in got[0]["message"]
    assert lint(tmp_path, clean, tcon.analyze_concurrency_paths,
                "clean.py") == []
    assert jcon.analyze_concurrency_paths([str(tmp_path / "snippet.py")],
                                          root=str(tmp_path)) == []


# ----------------------------------------------------------------------
# regression tests of the repairs
# ----------------------------------------------------------------------
def test_set_updater_during_push_async(monkeypatch):
    """A ``push_async`` bucket in flight when ``set_updater`` runs is
    applied by the updater it was pushed under (the worker used to read
    ``self._updater`` when it got to the bucket)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as kvmod
    monkeypatch.setenv("MXTPU_BUCKET_MB", "0")
    kv = kvmod.KVStore("dist_sync")
    gate = threading.Event()
    applied = []

    def gated(merged):
        # the sum over the workers without a process group: the identity,
        # held until the test lets it go, so the bucket stays in flight
        assert gate.wait(10)
        return merged

    def updater(name):
        def run(k, g, w):
            applied.append(name)
            w._set_data(w.data - g.data)
        return run
    with mx.cpu():
        # one process: init stores the value as it is
        kv.init(0, mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()))
        monkeypatch.setattr(kvmod.KVStore, "_dist",
                            property(lambda s: True))
        monkeypatch.setattr(kv, "_allreduce", gated)
        kv.set_updater(updater("a"))
        kv.push_async(0, mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()))
        kv.set_updater(updater("b"))
        gate.set()
        kv.wait_all()
        kv.push_async(0, mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()))
        kv.wait_all()
        out = mx.nd.zeros((4,), ctx=mx.cpu())
        kv.pull(0, out=out)
    assert applied == ["a", "b"]
    assert torch.equal(out.data, torch.full((4,), -1.0))
    kv._async.close()


def test_set_updater_flushes_the_pending_bucket(monkeypatch):
    """Gradients pushed (and not yet flushed) before a ``set_updater``
    keep the updater they were pushed under."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as kvmod
    monkeypatch.setenv("MXTPU_BUCKET_MB", "1024")
    kv = kvmod.KVStore("local")
    applied = []
    with mx.cpu():
        kv.init(0, mx.nd.array(np.zeros(4, np.float32), ctx=mx.cpu()))
        kv.set_updater(lambda k, g, w: applied.append("a"))
        kv.push_async(0, mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu()))
        kv.set_updater(lambda k, g, w: applied.append("b"))
        kv.wait_all()
    assert applied == ["a"]


def _signal_recorder(monkeypatch, module):
    handlers = {}
    monkeypatch.setattr(module.signal, "signal",
                        lambda sig, fn: handlers.setdefault(sig, fn))
    return handlers


def _fire_later(handlers, sig, after):
    def run():
        assert after.wait(10)
        handlers[sig](sig, None)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_mxkv_serve_joins_its_stopper(monkeypatch):
    """``mxkv serve`` returns only after ``stop()`` (run off the signal
    frame) has joined the server's threads: it used to return as soon as
    the socket closed, leaving the stopper to the interpreter's exit."""
    from mxnet_tpu_torch.resilience import netkv
    from mxnet_tpu_torch.tools import mxkv
    handlers = _signal_recorder(monkeypatch, mxkv)
    serving = threading.Event()
    stop_done = threading.Event()

    class FakeServer(object):
        url = "tcp://fake"

        def __init__(self, **kw):
            self._closed = threading.Event()

        def serve_forever(self):
            serving.set()
            assert self._closed.wait(10)

        def stop(self):
            self._closed.set()       # what closing the socket does
            threading.Event().wait(0.3)   # joining the handlers
            stop_done.set()

    monkeypatch.setattr(netkv, "TcpKVServer", FakeServer)
    _fire_later(handlers, mxkv.signal.SIGTERM, serving)
    args = types.SimpleNamespace(host="127.0.0.1", port=0, max_value=1)
    assert mxkv.cmd_serve(args) == 0
    assert stop_done.is_set()


class _FakeHTTPD(object):
    """``ThreadingHTTPServer`` whose ``shutdown`` takes a while after
    ``serve_forever`` returns, as the real one can."""

    serving = None
    done = None

    def __init__(self, *a, **kw):
        self._stop = threading.Event()

    def serve_forever(self):
        type(self).serving.set()
        assert self._stop.wait(10)

    def shutdown(self):
        self._stop.set()
        threading.Event().wait(0.3)
        type(self).done.set()

    def server_close(self):
        pass


def _fake_httpd(monkeypatch):
    import http.server
    fake = type("Fake", (_FakeHTTPD,), {"serving": threading.Event(),
                                        "done": threading.Event()})
    monkeypatch.setattr(http.server, "ThreadingHTTPServer", fake)
    return fake


def test_mxserve_joins_its_stopper(monkeypatch):
    from mxnet_tpu_torch.tools import mxserve
    from mxnet_tpu_torch.observability import sloengine
    handlers = _signal_recorder(monkeypatch, mxserve)
    fake = _fake_httpd(monkeypatch)
    closed = []
    monkeypatch.setattr(mxserve, "build_server", lambda args: types.
                        SimpleNamespace(close=lambda: closed.append(1)))
    monkeypatch.setattr(mxserve, "make_handler", lambda srv: None)
    monkeypatch.setattr(sloengine, "maybe_start", lambda **kw: None)
    _fire_later(handlers, mxserve.signal.SIGTERM, fake.serving)
    assert mxserve.main(["--port", "0"]) == 0
    assert fake.done.is_set() and closed == [1]


def test_mxfleet_joins_its_stopper(monkeypatch):
    from mxnet_tpu_torch.serving import fleet
    from mxnet_tpu_torch.tools import mxfleet
    from mxnet_tpu_torch.observability import sloengine
    handlers = _signal_recorder(monkeypatch, mxfleet)
    fake = _fake_httpd(monkeypatch)
    closed = []
    router = types.SimpleNamespace(
        stats=lambda: {"replicas": [], "router_id": "r", "role": "leader"},
        generation=0, close=lambda: closed.append(1))
    monkeypatch.setattr(fleet, "launch_fleet", lambda *a, **kw: router)
    monkeypatch.setattr(mxfleet, "make_front_handler", lambda r: None)
    monkeypatch.setattr(sloengine, "maybe_start", lambda **kw: None)
    _fire_later(handlers, mxfleet.signal.SIGINT, fake.serving)
    assert mxfleet.main(["serve", "--spec", "unused.json", "--port",
                         "0"]) == 0
    assert fake.done.is_set() and closed == [1]
