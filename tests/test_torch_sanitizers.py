"""The port's retrace sentry and lock-order sanitizer against the JAX
package's, on the CPU.

Twins of ``tests/test_retrace_lint.py``'s runtime-sentry tests and of
``tests/test_concurrency_lint.py``'s ``locktrace`` tests.  The retrace
scenarios run in both packages and must attribute the same cache-key
ingredient: a novel graph after the warmup boundary is
``graph_fingerprint``, a flip of ``MXNET_COMPUTE_DTYPE`` is
``compute_dtype``, a lowering that bypasses the program registry is
``outside_program_registry``; a ``ModelServer`` warmed by ``add_model``
serves with zero retraces after warmup.  The lock sanitizer is installed
by a fixture that restores ``threading.Lock``/``RLock`` afterwards (with
``MXTPU_LOCKCHECK=1`` the JAX package's sanitizer is already there, and
the port's chains over it); the port's server, batcher and generation
engine run a few requests under it with no ``lock_order`` error.
"""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.observability import locktrace as jlocktrace
from mxnet_tpu.observability import retrace as jretrace
from mxnet_tpu.parallel import overlap as joverlap
from mxnet_tpu.serving import ModelServer as JServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.observability import locktrace, retrace
from mxnet_tpu_torch.parallel import overlap as toverlap
from mxnet_tpu_torch.resilience import ResilienceError
from mxnet_tpu_torch.serving import ModelServer as TServer

PKGS = {"jax": (jmx, jretrace, joverlap, JServer),
        "port": (tmx, retrace, toverlap, TServer)}


# ----------------------------------------------------------------------
# the retrace sentry
# ----------------------------------------------------------------------
@pytest.fixture
def sentry():
    """Both packages' sentries installed and reset; restored after."""
    was = {k: p[1].installed() for k, p in PKGS.items()}
    for _mx, rt, _o, _s in PKGS.values():
        rt.install()
        rt.reset()
    yield
    for k, (_mx, rt, _o, _s) in PKGS.items():
        rt.reset()
        if not was[k]:
            rt.uninstall()


def _net(pkg, hidden):
    # odd hidden sizes keep each test's graph unique in the process's
    # program registries
    sym = pkg.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = sym.Activation(net, act_type="relu")
    return sym.FullyConnected(net, num_hidden=3, name="fc2")


def _bind(pkg, net):
    return net.simple_bind(pkg.cpu(0), data=(2, 7))


def test_sentry_install_uninstall_restores():
    from mxnet_tpu_torch import executor
    was = retrace.installed()
    if was:
        retrace.uninstall()
    orig_note, orig_lookup = toverlap.note_lowering, executor._lookup_program
    retrace.install()
    assert toverlap.note_lowering is not orig_note
    assert executor._lookup_program is not orig_lookup
    retrace.install()                                # idempotent
    retrace.uninstall()
    assert toverlap.note_lowering is orig_note
    assert executor._lookup_program is orig_lookup
    if was:
        retrace.install()


def test_sentry_maybe_install_env_gated():
    was = retrace.installed()
    if was:
        retrace.uninstall()
    try:
        assert retrace.maybe_install({}) is False
        assert not retrace.installed()
        assert retrace.maybe_install({"MXTPU_RETRACE_SENTRY": "1"})
        assert retrace.installed()
    finally:
        retrace.uninstall()
        if was:
            retrace.install()


def test_sentry_warmup_lowerings_not_counted(sentry):
    for name, (pkg, rt, _o, _s) in PKGS.items():
        rt.warmup_begin()
        _bind(pkg, _net(pkg, 61))
        st = rt.stats()
        assert st["lowerings_seen"] >= 1, name
        assert st["retraces_after_warmup"] == 0 and not st["armed"]


def test_sentry_steady_state_is_quiet(sentry):
    for pkg, rt, _o, _s in PKGS.values():
        rt.warmup_begin()
        net = _net(pkg, 67)
        _bind(pkg, net)
        rt.warmup_boundary()
        assert rt.armed()
        _bind(pkg, net)            # the same graph: a registry hit
        st = rt.stats()
        assert st["retraces_after_warmup"] == 0 and st["attributions"] == []


def _scenario(name, hidden, flip, monkeypatch):
    """Warm one graph, arm, then either bind a novel graph or flip the
    compute dtype and rebind; returns the first attribution."""
    pkg, rt, _o, _s = PKGS[name]
    monkeypatch.delenv("MXNET_COMPUTE_DTYPE", raising=False)
    rt.warmup_begin()
    net = _net(pkg, hidden)
    _bind(pkg, net)
    rt.warmup_boundary()
    if flip:
        monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
        _bind(pkg, net)
        monkeypatch.delenv("MXNET_COMPUTE_DTYPE")
    else:
        _bind(pkg, _net(pkg, hidden + 2))
    st = rt.stats()
    assert st["retraces_after_warmup"] >= 1
    return st["attributions"][0]


@pytest.mark.parametrize("flip,ingredient", [
    (False, "graph_fingerprint"), (True, "compute_dtype")])
def test_sentry_attributes_the_same_ingredient(sentry, monkeypatch, flip,
                                               ingredient):
    """Twins of ``test_sentry_bucket_bypass_names_graph_fingerprint`` and
    ``test_sentry_env_flip_names_compute_dtype``: the same scenario
    blames the same ingredient in both packages, with the port's site
    and detail."""
    got = {name: _scenario(name, 71 if not flip else 79, flip, monkeypatch)
           for name in PKGS}
    # the JAX key's ctx_key also carries the compute dtype, so a flip
    # there diverges in both; the port's key has the dtype once
    assert got["port"]["divergent"] == [ingredient]
    assert ingredient in got["jax"]["divergent"]
    detail = got["port"]["detail"][ingredient]
    assert detail["incoming"] != detail["closest_seen"]
    assert got["port"]["site"]


def test_sentry_unregistered_lowering_attributed(sentry):
    """Twin of the JAX test of the same name."""
    for name, (_pkg, rt, ov, _s) in PKGS.items():
        rt.warmup_boundary()
        ov.note_lowering()
        st = rt.stats()
        assert st["retraces_after_warmup"] == 1
        att = st["attributions"][0]
        assert att["divergent"] == ["outside_program_registry"], name
        assert "test_torch_sanitizers" in att["site"]


def test_sentry_warmup_begin_disarms_and_never_arms_uninstalled(sentry):
    retrace.warmup_boundary()
    assert retrace.armed()
    retrace.warmup_begin()
    assert not retrace.armed()
    toverlap.note_lowering()
    assert retrace.stats()["retraces_after_warmup"] == 0
    retrace.uninstall()
    try:
        retrace.warmup_boundary()
        assert not retrace.armed()
    finally:
        retrace.install()


def _mlp(pkg, hidden):
    net = pkg.models.get_mlp(num_classes=3, hidden=(hidden,))
    arg_shapes, _, _ = net.infer_shape(data=(2, 10))
    rng = np.random.RandomState(0)
    params = {"arg:" + n: (0.3 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    return net, params


@pytest.mark.parametrize("flip,ingredient", [
    (False, "graph_fingerprint"), (True, "compute_dtype")])
def test_server_warmup_boundary_and_attribution(sentry, monkeypatch, flip,
                                                ingredient):
    """A ``ModelServer`` with the sentry installed: ``add_model`` warms
    its buckets and arms the sentry; requests then lower nothing; a
    novel graph bound after the boundary, or the same graph under a
    flipped ``MXNET_COMPUTE_DTYPE``, is attributed -- the same
    ingredient on the JAX server."""
    monkeypatch.delenv("MXNET_COMPUTE_DTYPE", raising=False)
    got = {}
    hidden = 83 if flip else 89
    for name, (pkg, rt, _o, Server) in PKGS.items():
        net, params = _mlp(pkg, hidden)
        srv = Server(max_delay_ms=2)
        try:
            srv.add_model("m", net.tojson(), params, {"data": (10,)},
                          buckets=(1, 4), ctx=pkg.cpu())
            assert rt.armed()
            rng = np.random.RandomState(1)
            for n in (1, 3, 4, 2):
                out = srv.predict("m", rng.rand(n, 10).astype(np.float32))
                assert np.asarray(out[0]).shape == (n, 3)
            st = rt.stats()
            assert st["retraces_after_warmup"] == 0, (name, st)
            assert st["lowerings_seen"] >= 1
            if flip:           # the served graph, the dtype flipped
                monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
                net.simple_bind(pkg.cpu(0), data=(2, 10))
                monkeypatch.delenv("MXNET_COMPUTE_DTYPE")
            else:
                _bind(pkg, _net(pkg, hidden + 2))
            st = rt.stats()
            assert st["retraces_after_warmup"] >= 1
            got[name] = st["attributions"][-1]["divergent"]
        finally:
            srv.close()
    # the JAX ctx_key carries the compute dtype too
    assert got["port"] == [ingredient] and ingredient in got["jax"]


def test_generation_engine_warmup_marks_the_sentry(sentry):
    """``GenerationEngine.warmup`` (through ``add_generative_model``)
    disarms for its compile phase and arms after it: generating then
    lowers nothing."""
    from mxnet_tpu_torch.models import transformer as tf
    dims = dict(vocab_size=32, num_layers=1, num_heads=2, dim=16)
    sym = tf.get_decode_symbol(max_seq_len=64, **dims)
    E, H = dims["dim"], dims["num_heads"]
    caches = {"layer0_att_%s_cache" % c: (2, 16, H, E // H) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1),
                                   seq_pos=(1,), block_table=(1, 1),
                                   **caches)
    rng = np.random.RandomState(0)
    params = {n: (0.02 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "pos_ids", "seq_pos", "block_table")
              and n not in caches}
    for n in params:
        if n.endswith("_gamma"):
            params[n] = np.ones_like(params[n])
    srv = TServer(max_delay_ms=2)
    try:
        srv.add_generative_model("lm", params, max_seq_len=64,
                                 ctx=tmx.cpu(), max_new_tokens=4,
                                 prompt_buckets=(8,), decode_buckets=(1, 2),
                                 kv_blocks=16, kv_block_size=16, **dims)
        assert retrace.armed()
        res = srv.generate_sync("lm", [1, 2, 3], max_new_tokens=4)
        assert len(res["tokens"]) == 4
        st = retrace.stats()
        assert st["retraces_after_warmup"] == 0 and st["lowerings_seen"] > 0
    finally:
        srv.close()


# ----------------------------------------------------------------------
# the lock sanitizer
# ----------------------------------------------------------------------
@pytest.fixture
def traced():
    """The port's sanitizer installed over whatever factories are there;
    the factories restored after."""
    lock, rlock = threading.Lock, threading.RLock
    was = locktrace.installed()
    locktrace.install()
    locktrace.reset_order_graph()
    yield
    locktrace.reset_order_graph()
    if not was:
        locktrace.uninstall()
    assert threading.Lock is lock and threading.RLock is rlock


def test_locktrace_live_inversion(traced):
    a = threading.Lock()
    b = threading.Lock()     # distinct creation lines: distinct nodes
    with a:
        with b:
            pass
    with pytest.raises(ResilienceError) as exc:
        with b:
            with a:
                pass
    assert exc.value.kind == "lock_order"
    assert "inversion" in str(exc.value)
    assert a.acquire(blocking=False)
    a.release()


def test_locktrace_consistent_order_ok(traced):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert len(locktrace.order_edges()) == 1


def test_locktrace_rlock_reentrancy_no_edge(traced):
    r = threading.RLock()
    with r:
        with r:
            pass
    assert locktrace.order_edges() == []


def test_locktrace_condition_wait_releases(traced):
    cv = threading.Condition(threading.Lock())
    other = threading.Lock()
    ready = []

    def notifier():
        with other:
            pass
        with cv:
            ready.append(1)
            cv.notify()

    t = threading.Thread(target=notifier)
    with cv:
        t.start()
        while not ready:
            cv.wait(timeout=5.0)
    t.join(timeout=10)
    with cv:
        with other:
            pass


def test_locktrace_cross_thread_edges(traced):
    a = threading.Lock()
    b = threading.Lock()
    caught = []

    def fwd():
        with a:
            with b:
                pass

    def rev():
        try:
            with b:
                with a:
                    pass
        except ResilienceError as exc:
            caught.append(exc)

    for fn in (fwd, rev):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=10)
    assert len(caught) == 1 and caught[0].kind == "lock_order"


def test_locktrace_uninstall_restores():
    """Twin of the JAX test: install puts the traced factories in place,
    uninstall restores the ones found (the interpreter's, or the JAX
    sanitizer's when that is installed first)."""
    lock, rlock = threading.Lock, threading.RLock
    was = locktrace.installed()
    locktrace.install()
    assert threading.Lock is locktrace.TracedLock
    if not was:
        locktrace.uninstall()
        assert threading.Lock is lock is locktrace._ORIG_LOCK
        assert threading.RLock is rlock
        assert not locktrace.installed()
        locktrace.uninstall()                       # a no-op now
        assert threading.Lock is lock


def test_locktrace_chains_over_the_jax_sanitizer():
    """With the JAX sanitizer installed first (as ``MXTPU_LOCKCHECK=1``
    makes the conftest do), the port's chains over it: its locks wrap
    the JAX package's traced locks, an inversion raises the port's
    ``ResilienceError``, and uninstall hands the JAX factories back."""
    lock, rlock = threading.Lock, threading.RLock
    j_was, t_was = jlocktrace.installed(), locktrace.installed()
    if t_was:
        locktrace.uninstall()
    jlocktrace.install()
    jl = threading.Lock
    try:
        locktrace.install()
        locktrace.reset_order_graph()
        a = threading.Lock()
        b = threading.Lock()     # distinct creation lines: distinct nodes
        assert isinstance(a._lock, jlocktrace.TracedLock)
        r = threading.RLock()
        assert isinstance(r._lock, jlocktrace.TracedRLock)
        with a:
            with b:
                pass
        with pytest.raises(ResilienceError) as exc:
            with b:
                with a:
                    pass
        assert exc.value.kind == "lock_order"
        cv = threading.Condition(threading.RLock())
        with cv:
            cv.wait(timeout=0.01)
        locktrace.uninstall()
        assert threading.Lock is jl
    finally:
        locktrace.reset_order_graph()
        locktrace.uninstall()
        if not j_was:
            jlocktrace.uninstall()
        if t_was:
            locktrace.install()
    if not j_was and not t_was:
        assert threading.Lock is lock and threading.RLock is rlock


def test_server_and_batcher_under_the_sanitizer(traced):
    """The port's server, its batcher's threads and a generation engine
    serve requests with every lock they make traced: no lock-order
    error, no failed request."""
    net, params = _mlp(tmx, 97)
    srv = TServer(max_delay_ms=2)
    try:
        srv.add_model("m", net.tojson(), params, {"data": (10,)},
                      buckets=(1, 4), ctx=tmx.cpu())
        rng = np.random.RandomState(2)
        futs = [srv.submit("m", rng.rand(n, 10).astype(np.float32))
                for n in (1, 4, 2, 3, 1, 4, 4, 2)]
        outs = [f.result(timeout=60) for f in futs]
        assert [o[0].shape[0] for o in outs] == [1, 4, 2, 3, 1, 4, 4, 2]
        errors = []

        def client(i):
            try:
                srv.predict("m", rng.rand(1 + i % 4, 10).astype(np.float32))
            except Exception as exc:        # collected below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert errors == []
        assert srv.stats()["failed"] == 0
    finally:
        srv.close()
    assert isinstance(threading.Lock(), locktrace.TracedLock)
