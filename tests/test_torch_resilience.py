"""The port's resilience slice against the JAX package, on the CPU.

Twins of ``tests/test_resilience.py``: the host sentinel, the watchdog
and the flight recorder, the trainer's sentinel counters and step
watchdog, its checkpoint methods (host format), FeedForward's and
Module's sentinels, the kvstore barrier's watchdog, the warm elastic
resume and the walk back past a damaged checkpoint; and the jax-free
import of the slice's modules.  The trainers run on one device in both
packages (a one-device JAX mesh), from the same numpy weights and
batches; ``tests/test_torch_sentinel.py`` holds the in-step sentinel's
runs against the JAX trainer.

Tolerances: parameters after a run within 1e-5 of the JAX package's,
relative to the larger of 1 and the reference's max-abs (each step's
gradients sum in another order); the sentinel's counters equal exactly;
a skipped step leaves every parameter, state and aux bit for bit; a
resumed run is bit for bit the uninterrupted one within the port.
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.resilience import faultinject as jfaultinject

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_opt as tfo
from mxnet_tpu_torch.resilience import (CheckpointManager, ResilienceError,
                                        Sentinel, Watchdog, elastic,
                                        faultinject, run_with_timeout)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Each test starts and ends with no armed fault specs."""
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    monkeypatch.delenv("MXTPU_SENTINEL", raising=False)
    monkeypatch.delenv("MXTPU_STEP_TIMEOUT_S", raising=False)
    faultinject.reset()
    jfaultinject.reset()
    yield
    faultinject.reset()
    jfaultinject.reset()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", spec)
    faultinject.reset()
    jfaultinject.reset()


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: max |diff| %g > %g" % (what, err,
                                                           tol * scale)


# ----------------------------------------------------------------------
# the host sentinel (tests/test_resilience.py:314-357)
# ----------------------------------------------------------------------
def _sentinel_run(mod):
    s = mod.Sentinel()
    scale0 = s.loss_scale.scale
    verdicts = [s.check(1, loss=0.9), s.check(2, loss=float("nan")),
                s.loss_scale.scale == scale0 / 2,
                s.check(3, grad_norm=float("inf")), s.check(4, loss=0.8),
                s.last_good_step, [rec[0] for rec in s.skipped]]
    spike = mod.Sentinel(spike_factor=100.0, warmup_steps=3)
    verdicts += [spike.check(k, loss=1.0) for k in range(1, 6)]
    verdicts += [spike.check(6, loss=1e6), spike.check(7, loss=1.1)]
    return verdicts


def test_sentinel_verdicts_match_jax():
    from mxnet_tpu.resilience import sentinel as jsentinel
    from mxnet_tpu_torch.resilience import sentinel as tsentinel
    got = _sentinel_run(tsentinel)
    assert got == _sentinel_run(jsentinel)
    assert got[:7] == ["ok", "skip-nonfinite", True, "skip-nonfinite", "ok",
                       4, [2, 3]]
    assert got[-2:] == ["skip-spike", "ok"]


def test_sentinel_escalates_after_max_consecutive_skips():
    s = Sentinel(max_consecutive_skips=3)
    s.check(1, loss=1.0)
    s.check(2, loss=float("nan"))
    s.check(3, loss=float("nan"))
    with pytest.raises(ResilienceError) as exc:
        s.check(4, loss=float("nan"))
    assert exc.value.kind == "numeric"


def test_dynamic_loss_scale_growth_and_clamp():
    from mxnet_tpu_torch.resilience.sentinel import DynamicLossScale
    ls = DynamicLossScale(init=4.0, growth_interval=2, min_scale=1.0,
                          max_scale=8.0)
    ls.good()
    ls.good()
    assert ls.scale == 8.0
    ls.good()
    ls.good()
    assert ls.scale == 8.0
    for _ in range(5):
        ls.bad()
    assert ls.scale == 1.0


def test_sentinel_grad_norm_module_structure():
    """NDArrays, tensors and numpy arrays, None entries, several devices'
    copies: the JAX package's norm; a NaN on any copy is NaN."""
    g = [[tmx.nd.array(np.array([3.0, 4.0], np.float32), ctx=tmx.cpu())],
         [None], [torch.tensor([1.0]), np.array([2.0], np.float32)]]
    jg = [[jmx.nd.array(np.array([3.0, 4.0], np.float32))], [None],
          [np.array([1.0], np.float32), np.array([2.0], np.float32)]]
    from mxnet_tpu.resilience import Sentinel as JSentinel
    assert abs(Sentinel.grad_norm(g) - JSentinel.grad_norm(jg)) < 1e-12
    assert abs(Sentinel.grad_norm(g) - np.sqrt(30.0)) < 1e-6
    bad = [[tmx.nd.array(np.array([1.0], np.float32), ctx=tmx.cpu()),
            torch.tensor([float("nan")])]]
    assert np.isnan(Sentinel.grad_norm(bad))


# ----------------------------------------------------------------------
# the watchdog (tests/test_resilience.py:212-250)
# ----------------------------------------------------------------------
def test_run_with_timeout_passthrough_and_timeout(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    tobs.refresh()
    try:
        assert run_with_timeout(lambda: 41 + 1, 5.0, phase="quick") == 42
        assert run_with_timeout(lambda: 7, None, phase="off") == 7
        with pytest.raises(ZeroDivisionError):
            run_with_timeout(lambda: 1 / 0, 5.0, phase="err")
        t0 = time.monotonic()
        with pytest.raises(ResilienceError) as exc:
            run_with_timeout(lambda: time.sleep(3), 0.3, phase="stuck",
                             step=12)
        assert time.monotonic() - t0 < 2.5
    finally:
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        tobs.refresh()
    err = exc.value
    assert err.kind == "timeout" and err.phase == "stuck" \
        and err.step == 12 and err.timeout_s == 0.3 and err.rank == 0
    assert "phase=stuck" in str(err) and "step=12" in str(err)
    dumps = glob.glob(str(tmp_path / "flight-rank*.json"))
    assert dumps, "the watchdog dumps the flight recorder"
    with open(sorted(dumps)[-1]) as f:
        doc = json.load(f)
    assert doc["reason"] == "watchdog_timeout" and doc["phase"] == "stuck"


def test_watchdog_monitor_fires_on_stall():
    fired = []
    wd = Watchdog(timeout_s=0.3, phase="loop", on_timeout=fired.append,
                  poll_s=0.05)
    with wd:
        wd.feed(step=1)
        time.sleep(0.1)
        wd.feed(step=2)
        assert not wd.fired
        time.sleep(0.8)
    assert wd.fired and len(fired) == 1
    err = fired[0]
    assert err.kind == "stall" and err.step == 2 and err.phase == "loop"


def test_watchdog_disabled_without_timeout():
    wd = Watchdog(timeout_s=None, on_timeout=lambda e: None)
    with wd:
        assert wd._thread is None


def test_exit_for_restart_subprocess_exits_3(tmp_path):
    """The watchdog's exit path, with JAX blocked: exit code 3, the abort
    line, and a flight dump beside it."""
    code = (
        "import sys, time\n"
        "sys.modules['jax'] = None\n"
        "from mxnet_tpu_torch.resilience import run_with_timeout\n"
        "run_with_timeout(lambda: time.sleep(60), 0.2, phase='step',\n"
        "                 step=4, on_timeout='exit')\n")
    env = dict(os.environ, MXTPU_TELEMETRY_DIR=str(tmp_path),
               PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 3, proc.stderr
    assert "RESILIENCE ABORT" in proc.stderr
    assert "phase=step" in proc.stderr and "step=4" in proc.stderr
    reasons = set()
    for path in glob.glob(str(tmp_path / "flight-rank*.json")):
        with open(path) as f:
            reasons.add(json.load(f)["reason"])
    assert {"watchdog_timeout", "exit_restart"} <= reasons


def test_flight_recorder_is_the_jax_packages():
    """The ring, the ledger and the dump's fields are the JAX package's;
    record_step notes the step into the ring."""
    from mxnet_tpu.observability import flight as jflight
    from mxnet_tpu_torch.observability import flight as tflight
    docs = []
    for mod in (tflight, jflight):
        rec = mod.FlightRecorder(depth=4)
        for k in range(6):
            rec.note("step", k, {"dur_ms": float(k)})
        rec.collective_begin("allreduce", 7, participants=[0, 1], bytes=64)
        rec.collective_begin("barrier", 8)
        rec.collective_end("barrier", 8)
        docs.append(rec.snapshot(reason="test"))
    t, j = docs
    assert sorted(t) == sorted(j)
    assert [e["step"] for e in t["events"]] == [2, 3, 4, 5]
    assert [(e["op"], e["seq"]) for e in t["pending_collectives"]] == \
        [("allreduce", 7)]
    tflight.reset()
    tobs.record_step(11, 0.25)
    ring = list(tflight.get()._ring)
    assert ring[-1][1:] == ("step", 11, {"dur_ms": 250.0})


# ----------------------------------------------------------------------
# the trainer's in-step sentinel (tests/test_resilience.py:396-452)
# ----------------------------------------------------------------------
def _mlp(mx, bn=False):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    if bn:
        h = mx.sym.BatchNorm(h, name="bn1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


_LM = dict(vocab_size=32, num_layers=2, num_heads=2, dim=16, seq_len=8)


def _symbol(mx, model):
    if model == "lm":
        return mx.models.transformer.get_symbol(**_LM)
    return _mlp(mx, bn=model == "mlp_bn")


def _shapes(model):
    if model == "lm":
        return {"data": (2, 8)}, {"softmax_label": (2, 8)}
    return {"data": (16, 8)}, {"softmax_label": (16,)}


def _batch(model, seed=0, corrupt=False):
    rng = np.random.RandomState(seed)
    if model == "lm":
        x = rng.randint(0, _LM["vocab_size"], (2, 8)).astype(np.float32)
        if corrupt:
            x[1, 3] = _LM["vocab_size"]     # outside the vocabulary
        y = rng.randint(0, _LM["vocab_size"], (2, 8)).astype(np.float32)
    else:
        x = rng.randn(16, 8).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.float32)
    return {"data": x, "softmax_label": y}


def _opt(mx, kind, lr=0.1):
    if kind == "adam":
        # epsilon 1e-3, not 1e-8: the LM's key bias has a gradient that is
        # zero in exact arithmetic (the softmax cancels it), and Adam at
        # 1e-8 turns the rounding left there (about 1e-9, in either
        # package) into steps of the size of lr
        return mx.optimizer.create("adam", learning_rate=0.01,
                                   epsilon=1e-3, rescale_grad=1.0 / 16)
    return mx.optimizer.create("sgd", learning_rate=lr, momentum=0.9,
                               rescale_grad=1.0 / 16)


def _jax_trainer(model, kind, **kw):
    """A JAX trainer on a one-device mesh and its initial state, placed
    (the step donates it) and as numpy (``init``, for the port)."""
    mesh = jparallel.make_mesh(jax.devices()[:1], dp=1)
    tr = jparallel.ShardedTrainer(_symbol(jmx, model), _opt(jmx, kind),
                                  mesh, **kw)
    jmx.random.seed(3)
    data, label = _shapes(model)
    state = tr.init_params(data, label_shapes=label)
    return tr, state, tuple(_numpy(x) for x in state)


def _numpy(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, (tuple, list)):
            out[k] = tuple(np.asarray(jax.device_get(x)).copy() for x in v)
        else:
            out[k] = np.asarray(jax.device_get(v)).copy()
    return out


def _torch(tree):
    return {k: tuple(torch.from_numpy(x.copy()) for x in v)
            if isinstance(v, tuple) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _port_trainer(model, kind, init, **kw):
    """A port trainer from the JAX trainer's initial state (numpy)."""
    tr = tmx.parallel.ShardedTrainer(_symbol(tmx, model), _opt(tmx, kind),
                                     ctx=tmx.cpu(), **kw)
    p, o, a = (_torch(x) for x in init)
    return tr, p, o, a


def _run(tr, state, batches, flat=None):
    """``batches`` steps; returns the state after each step (numpy) and
    the outputs of the last."""
    p, o, a = state
    trail = []
    for b in batches:
        p, o, a, outs = tr.step(p, o, a, tr.shard_batch(b))
        trail.append((_numpy(p), _numpy(o), _numpy(a)))
    return (p, o, a), trail, outs


def _equal_tree(x, y):
    for k in x:
        for u, v in zip(x[k] if isinstance(x[k], tuple) else (x[k],),
                        y[k] if isinstance(y[k], tuple) else (y[k],)):
            if not np.array_equal(u, v):
                return False
    return True


def test_trainer_sentinel_off_is_the_plain_step():
    """Sentinel on with no fault: bit for bit the sentinel-off trainer."""
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr_a, pa, oa, aa = _port_trainer("mlp", "sgd", init)
    tr_b, pb, ob, ab = _port_trainer("mlp", "sgd", init,
                                     sentinel=True)
    for s in range(3):
        b = _batch("mlp", s)
        pa, oa, aa, _ = tr_a.step(pa, oa, aa, tr_a.shard_batch(b))
        pb, ob, ab, _ = tr_b.step(pb, ob, ab, tr_b.shard_batch(b))
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    assert tr_a.sentinel_stats() is None
    assert tr_b.sentinel_stats() == {"scale": 32768.0, "good_steps": 3,
                                     "skipped": 0, "last_good": 3}


def test_trainer_sentinel_learns():
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr, p, o, a = _port_trainer("mlp", "sgd", init, sentinel=True)
    b = _batch("mlp")
    placed = tr.shard_batch(b)
    for _ in range(30):
        p, o, a, outs = tr.step(p, o, a, placed)
    assert tr.sentinel_stats()["skipped"] == 0
    pred = outs[0].numpy().argmax(axis=1)
    assert (pred == b["softmax_label"]).mean() > 0.9


def test_loss_scale_grows_after_the_growth_interval():
    """loss_scale_growth good steps double the scale, as in the JAX
    trainer."""
    jtr, (jp, jo, ja), init = _jax_trainer(
        "mlp", "sgd", sentinel=True, loss_scale_init=4.0,
        loss_scale_growth=2)
    tr, p, o, a = _port_trainer("mlp", "sgd", init, sentinel=True,
                                loss_scale_init=4.0, loss_scale_growth=2)
    for s in range(5):
        b = _batch("mlp", s)
        jp, jo, ja, _ = jtr.step(jp, jo, ja, jtr.shard_batch(b))
        p, o, a, _ = tr.step(p, o, a, tr.shard_batch(b))
        assert tr.sentinel_stats() == jtr.sentinel_stats()
    assert tr.sentinel_stats()["scale"] == 16.0


@pytest.mark.parametrize("clip,skipped", [(1.0, False), (None, True)])
def test_gate_checks_the_preprocessed_gradients(clip, skipped):
    """A +inf gradient: with clip_gradient the JAX package's clip makes it
    finite, so the step is NOT skipped (a check of the raw gradients
    would skip it); without, it is.  fused_apply(gate=True) against the
    JAX trainer's gate (preprocess, all finite, fused_apply, where)."""
    import jax.numpy as jnp
    from mxnet_tpu.kernels import fused_opt as jfo
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads["b"][2] = np.inf
    mom = {n: rng.randn(*s).astype(np.float32) * 0.1
           for n, s in shapes.items()}
    kw = dict(learning_rate=0.1, momentum=0.9, clip_gradient=clip)
    jopt = jmx.optimizer.create("sgd", **kw)
    gs = {n: jopt._preprocess_grad(jnp.asarray(g)) for n, g in grads.items()}
    finite = bool(all(jnp.all(jnp.isfinite(g)) for g in gs.values()))
    jw, js = jfo.fused_apply(jopt, {n: jnp.asarray(a) for n, a in
                                    params.items()}, gs,
                             {n: jnp.asarray(a) for n, a in mom.items()},
                             jnp.float32(0.1), jnp.float32(0.0),
                             jnp.asarray(1.0, jnp.float32), mode="1")
    assert finite is not skipped
    topt = tmx.optimizer.create("sgd", **kw)
    for mode in ("kernel", "1"):
        tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
        tm = {n: torch.from_numpy(a.copy()) for n, a in mom.items()}
        tw, ts, ok = tfo.fused_apply(
            topt, tp, {n: torch.from_numpy(a) for n, a in grads.items()},
            tm, 0.1, 0.0, 1, nbytes=32, mode=mode, preprocess=True,
            gate=True)
        assert bool(ok) is (not skipped)
        for n in params:
            if skipped:
                assert np.array_equal(tw[n].numpy(), params[n])
                assert np.array_equal(ts[n].numpy(), mom[n])
            else:
                _close(tw[n].numpy(), np.asarray(jw[n]), 1e-6, n)
                _close(ts[n].numpy(), np.asarray(js[n]), 1e-6, n)


def test_sentinel_on_a_mesh_of_several_devices_raises():
    mesh = tmx.parallel.make_mesh([tmx.cpu(0), tmx.cpu(1)], dp=2)
    with pytest.raises(MXNetError, match="sentinel on a mesh"):
        tmx.parallel.ShardedTrainer(_mlp(tmx), _opt(tmx, "sgd"), mesh,
                                    sentinel=True)


# ----------------------------------------------------------------------
# the step watchdog on the trainer (tests/test_resilience.py:453-476)
# ----------------------------------------------------------------------
def test_trainer_watchdog_catches_injected_hang(monkeypatch, tmp_path):
    """An injected hang inside step 2 becomes a ResilienceError within
    the timeout; the flight dump names (train_step, 2) as pending."""
    from mxnet_tpu_torch.observability import flight as tflight
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr, p, o, a = _port_trainer("mlp", "sgd", init,
                                step_timeout_s=1.0)
    b = tr.shard_batch(_batch("mlp"))
    p, o, a, _ = tr.step(p, o, a, b)
    _arm(monkeypatch, "step=2:kind=hang:seconds=3")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    tobs.refresh()
    t0 = time.monotonic()
    try:
        with pytest.raises(ResilienceError) as exc:
            tr.step(p, o, a, b)
        assert time.monotonic() - t0 < 2.9
        pending = [(e["op"], e["seq"]) for e in
                   tflight.pending_collectives()]
    finally:
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        tobs.refresh()
        tflight.reset()
    err = exc.value
    assert err.kind == "timeout" and err.phase == "train_step" \
        and err.step == 2 and err.rank == 0
    assert ("train_step", 2) in pending
    docs = []
    for path in glob.glob(str(tmp_path / "flight-rank*.json")):
        with open(path) as f:
            docs.append(json.load(f))
    assert any(("train_step", 2) in [(e["op"], e["seq"]) for e in
                                     d["pending_collectives"]] for d in docs)
    time.sleep(2.5)         # let the abandoned step finish before the next


def test_trainer_slow_step_under_timeout_succeeds(monkeypatch):
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    monkeypatch.setenv("MXTPU_STEP_TIMEOUT_S", "30")
    tr, p, o, a = _port_trainer("mlp", "sgd", init)
    b = tr.shard_batch(_batch("mlp"))
    p, o, a, _ = tr.step(p, o, a, b)
    _arm(monkeypatch, "step=2:kind=slow:seconds=0.2")
    p, o, a, _ = tr.step(p, o, a, b)
    assert tr.num_update == 2


def test_watchdog_thread_runs_the_step_as_the_caller():
    """Under the watchdog the step runs on another thread, whose grad mode
    is not the caller's: called under ``torch.no_grad()``, the watched
    and the unwatched step give the same parameters."""
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    runs = []
    for timeout in (None, 5.0):
        tr, p, o, a = _port_trainer("mlp", "sgd", init,
                                    step_timeout_s=timeout)
        with torch.no_grad():
            p, o, a, _ = tr.step(p, o, a, tr.shard_batch(_batch("mlp")))
        runs.append(p)
    for n in runs[0]:
        assert torch.equal(runs[0][n], runs[1][n]), n


# ----------------------------------------------------------------------
# checkpoints (tests/test_resilience.py:477, 1232, 1282)
# ----------------------------------------------------------------------
def test_trainer_versioned_checkpoint_auto_resume(tmp_path):
    ckdir = str(tmp_path / "ckpts")
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr, p, o, a = _port_trainer("mlp", "sgd", init)
    b = tr.shard_batch(_batch("mlp"))
    for _ in range(2):
        p, o, a, _ = tr.step(p, o, a, b)
    tr.save_checkpoint_versioned(ckdir, p, o, a, keep=3)
    p, o, a, _ = tr.step(p, o, a, b)
    tr.save_checkpoint_versioned(ckdir, p, o, a, keep=3)
    assert tr.latest_step(ckdir) == 3
    tr2, _, _, _ = _port_trainer("mlp", "sgd", init)
    data, label = _shapes("mlp")
    p2, o2, a2, step = tr2.auto_resume(ckdir, data, label_shapes=label)
    assert step == 3 and tr2.num_update == 3
    for n in p:
        assert torch.equal(p[n], p2[n]) and torch.equal(o[n], o2[n]), n
        assert p2[n].device == tr2.device
    tr3, _, _, _ = _port_trainer("mlp", "sgd", init)
    assert tr3.auto_resume(str(tmp_path / "fresh"), data,
                           label_shapes=label) is None


def test_resume_is_the_uninterrupted_run_and_the_jax_packages(tmp_path):
    """Adam: save at step 3, auto_resume in a new trainer, 3 more steps:
    bit for bit 6 uninterrupted steps (Adam's t continues), and within
    1e-5 of the JAX package's save / resume / 3 steps."""
    batches = [_batch("mlp", s) for s in range(6)]
    jtr, (jp, jo, ja), init = _jax_trainer("mlp", "adam")
    data, label = _shapes("mlp")
    # the JAX package: 3 steps, save, resume in a new trainer, 3 steps
    p, o, a = jp, jo, ja
    for b in batches[:3]:
        p, o, a, _ = jtr.step(p, o, a, jtr.shard_batch(b))
    jtr.save_checkpoint_versioned(str(tmp_path / "jax"), p, o, a)
    jtr2, _, _ = _jax_trainer("mlp", "adam")
    p, o, a, step = jtr2.auto_resume(str(tmp_path / "jax"), data,
                                     label_shapes=label)
    assert step == 3
    for b in batches[3:]:
        p, o, a, _ = jtr2.step(p, o, a, jtr2.shard_batch(b))
    jwant = _numpy(p)
    # the port, uninterrupted
    tr, tp, to, ta = _port_trainer("mlp", "adam", init)
    (tp, to, ta), _t, _o = _run(tr, (tp, to, ta), batches)
    # the port, interrupted
    tr1, sp, so, sa = _port_trainer("mlp", "adam", init)
    (sp, so, sa), _t, _o = _run(tr1, (sp, so, sa), batches[:3])
    tr1.save_checkpoint_versioned(str(tmp_path / "port"), sp, so, sa)
    tr2, _, _, _ = _port_trainer("mlp", "adam", init)
    rp, ro, ra, step = tr2.auto_resume(str(tmp_path / "port"), data,
                                       label_shapes=label)
    assert step == 3 and tr2.num_update == 3
    assert all(x.device == tr2.device for v in ro.values() for x in v)
    (rp, ro, ra), _t, _o = _run(tr2, (rp, ro, ra), batches[3:])
    assert tr2.num_update == 6
    for n in tp:
        assert torch.equal(tp[n], rp[n]), n
        for x, y in zip(to[n], ro[n]):
            assert torch.equal(x, y), n
        _close(rp[n].numpy(), jwant[n], 1e-5, n)


def test_checkpoint_round_trip_on_a_dp_mesh(tmp_path):
    """On a dp mesh of two contexts the restored state is placed as
    init_params places it: replicated parameters, ZeRO-1 momentum split
    on axis 0, and the resumed step equal to the uninterrupted one."""
    data, label = _shapes("mlp")
    mesh = tmx.parallel.make_mesh([tmx.cpu(0), tmx.cpu(1)], dp=2)
    runs = []
    for resume in (False, True):
        tr = tmx.parallel.ShardedTrainer(_mlp(tmx), _opt(tmx, "sgd"), mesh,
                                         zero1=True)
        tmx.random.seed(2)
        p, o, a = tr.init_params(data, label_shapes=label)
        b = tr.shard_batch(_batch("mlp"))
        p, o, a, _ = tr.step(p, o, a, b)
        if resume:
            tr.save_checkpoint_versioned(str(tmp_path), p, o, a)
            tr = tmx.parallel.ShardedTrainer(_mlp(tmx), _opt(tmx, "sgd"),
                                             mesh, zero1=True)
            p, o, a, step = tr.auto_resume(str(tmp_path), data,
                                           label_shapes=label)
            assert step == 1
            assert all(v.sharding.spec == o0.sharding.spec
                       for v, o0 in zip(o.values(), runs[0][1].values()))
        p, o, a, _ = tr.step(p, o, a, b)
        runs.append((p, o))
    for n in runs[0][0]:
        assert np.array_equal(np.asarray(runs[0][0][n]),
                              np.asarray(runs[1][0][n])), n


def test_save_and_load_checkpoint(tmp_path):
    _jtr, _js, init = _jax_trainer("mlp_bn", "adam")
    tr, p, o, a = _port_trainer("mlp_bn", "adam", init)
    for s in range(2):
        p, o, a, _ = tr.step(p, o, a, tr.shard_batch(_batch("mlp_bn", s)))
    path = str(tmp_path / "ck")
    tr.save_checkpoint(path, p, o, a)
    tr2, _, _, _ = _port_trainer("mlp_bn", "adam", init)
    data, label = _shapes("mlp_bn")
    p2, o2, a2 = tr2.load_checkpoint(path, data, label_shapes=label)
    assert tr2.num_update == 2
    for n in a:
        assert torch.equal(a[n], a2[n]), n
    for n in p:
        assert torch.equal(p[n], p2[n]), n
    abstract = tr2.abstract_state(data, label_shapes=label)
    assert set(abstract[0]) == set(p) and set(abstract[2]) == set(a)
    assert all(len(v) == 2 for v in abstract[1].values())


def _warm_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_WARM_REMESH", "1")
    monkeypatch.setenv("MXTPU_HANDOFF_DIR", str(tmp_path / "handoff"))
    for var in ("MXTPU_NUM_HOSTS", "MXTPU_HOST_INDEX",
                "MXTPU_HOTSTATE_BUDDIES", "MXTPU_ELASTIC_GENERATION"):
        monkeypatch.delenv(var, raising=False)


def test_trainer_warm_elastic_resume_and_checkpoint_fallback(
        tmp_path, monkeypatch):
    """elastic_resume: the warm rung places the handoff tree on the
    trainer's device and reads no checkpoint; a corrupt payload degrades
    to the checkpoint rung, with the reason in the resume record."""
    _warm_env(tmp_path, monkeypatch)
    ckdir = str(tmp_path / "ckpts")
    data, label = _shapes("mlp")
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr, p, o, a = _port_trainer("mlp", "sgd", init)
    b = tr.shard_batch(_batch("mlp"))
    for _ in range(2):
        p, o, a, _ = tr.step(p, o, a, b)
    tr.save_checkpoint_versioned(ckdir, p, o, a)
    tr.hotstate_snapshot(p, o, a)
    events = []
    monkeypatch.setattr(elastic, "emit_transition",
                        lambda event, **f: events.append((event, f)))
    tr2, _, _, _ = _port_trainer("mlp", "sgd", init)
    p2, _o, _a, step = tr2.elastic_resume(ckdir, data, label_shapes=label,
                                          source="warm")
    assert step == 2 and tr2.num_update == 2
    for n in p:
        assert torch.equal(p[n], p2[n]), n
    (event, fields), = [e for e in events if e[0] == "resume"]
    assert fields["path"] == "warm" and fields["fallback_reason"] is None
    assert fields["n_payloads"] == 1
    events.clear()
    _arm(monkeypatch, "kind=corrupt")
    tr3, _, _, _ = _port_trainer("mlp", "sgd", init)
    got = tr3.elastic_resume(ckdir, data, label_shapes=label, source="auto")
    assert got is not None and got[3] == 2
    for n in p:
        assert torch.equal(p[n], got[0][n]), n
    (event, fields), = [e for e in events if e[0] == "resume"]
    assert fields["path"] == "cold"
    assert fields["fallback_reason"] == "crc_mismatch"


def test_auto_resume_walks_back_past_corrupt_latest(tmp_path):
    """A committed checkpoint damaged after the fact: auto_resume takes
    the previous one; every kept version bad is a structured
    restore_corrupt."""
    _jtr, _js, init = _jax_trainer("mlp", "sgd")
    tr, p, o, a = _port_trainer("mlp", "sgd", init)
    b = tr.shard_batch(_batch("mlp"))
    ckdir = str(tmp_path / "run")
    saved = []
    for _ in range(2):
        p, o, a, _ = tr.step(p, o, a, b)
        tr.save_checkpoint_versioned(ckdir, p, o, a, keep=0)
        saved.append({n: v.clone() for n, v in p.items()})
    mgr = CheckpointManager(ckdir, keep=0)
    with open(os.path.join(mgr.step_path(2), "host_ckpt.json"), "w") as f:
        f.write('{"step": 2, "keys"')
    data, label = _shapes("mlp")
    tr2, _, _, _ = _port_trainer("mlp", "sgd", init)
    p2, _o, _a, step = tr2.auto_resume(ckdir, data, label_shapes=label)
    assert step == 1
    for n in p2:
        assert torch.equal(p2[n], saved[0][n]), n
    with open(os.path.join(mgr.step_path(1), "host_ckpt.json"), "w") as f:
        f.write("not json")
    with pytest.raises(ResilienceError) as ei:
        tr2.auto_resume(ckdir, data, label_shapes=label)
    assert ei.value.kind == "restore_corrupt"
    assert ei.value.phase == "ckpt_restore"


# ----------------------------------------------------------------------
# the host loops (tests/test_resilience.py:507-545) and the kvstore
# ----------------------------------------------------------------------
def _ff_data():
    rng = np.random.RandomState(0)
    X = rng.randn(60, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    w = np.random.RandomState(5)
    init = {"fc1_weight": w.uniform(-0.1, 0.1, (8, 6)).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": w.uniform(-0.1, 0.1, (2, 8)).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}
    return X, y, init


def _ff_net(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _ff_fit(mx, ctx, epochs):
    X, y, init = _ff_data()
    model = mx.FeedForward(_ff_net(mx), ctx=ctx, num_epoch=epochs,
                           optimizer="sgd", learning_rate=0.3,
                           arg_params={k: mx.nd.array(v, ctx=ctx)
                                       for k, v in init.items()})
    model.fit(mx.io.NDArrayIter(X, y, batch_size=20))
    return model, X, y


def test_feedforward_sentinel_survives_injected_nan(monkeypatch):
    """MXTPU_SENTINEL=1 and a NaN at step 2: the update is skipped, the
    parameters stay finite and within 1e-5 of the JAX package's run."""
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    _arm(monkeypatch, "step=2:kind=nan")
    jmodel, X, y = _ff_fit(jmx, jmx.context.cpu(), 8)
    _arm(monkeypatch, "step=2:kind=nan")
    tmodel, _, _ = _ff_fit(tmx, tmx.cpu(), 8)
    for name, arr in tmodel.arg_params.items():
        got = arr.asnumpy()
        assert np.isfinite(got).all(), name
        _close(got, jmodel.arg_params[name].asnumpy(), 1e-5, name)
    acc = tmodel.score(tmx.io.NDArrayIter(X, y, batch_size=20))
    assert acc == jmodel.score(jmx.io.NDArrayIter(X, y, batch_size=20))


def test_feedforward_without_sentinel_is_poisoned(monkeypatch):
    _arm(monkeypatch, "step=2:kind=nan")
    model, _, _ = _ff_fit(tmx, tmx.cpu(), 1)
    assert any(not np.isfinite(a.asnumpy()).all()
               for a in model.arg_params.values())


@pytest.mark.parametrize("route", ["fused", "kvstore"])
def test_module_fit_sentinel_skips_a_nan_batch(monkeypatch, route):
    """Module.fit with MXTPU_SENTINEL=1 over three batches, the second
    NaN: that step is skipped, the parameters stay finite, and they are
    within 1e-5 of the JAX package's Module.fit over the two clean
    batches alone (plain SGD: a skipped step is one not taken).  The JAX
    package's own Module.fit cannot run its sentinel (its epoch loop
    names ``Sentinel``, which only ``fit`` imports: a NameError), and
    there its fused step would update before the check; the port turns
    the whole-step fusion off while the sentinel watches, on the fused
    route (no store object) and with a KVStore object alike."""
    X, y, init = _ff_data()
    Xn = X.copy()
    Xn[20:40] = np.nan
    clean = np.concatenate([X[:20], X[40:]])
    yc = np.concatenate([y[:20], y[40:]])
    jmod = jmx.mod.Module(_ff_net(jmx), context=jmx.context.cpu())
    jmod.fit(jmx.io.NDArrayIter(clean, yc, batch_size=20), num_epoch=1,
             optimizer_params=(("learning_rate", 0.1),),
             arg_params={k: jmx.nd.array(v) for k, v in init.items()})
    jwant = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    mod = tmx.mod.Module(_ff_net(tmx), context=tmx.cpu())
    kv = tmx.kvstore.create("local") if route == "kvstore" else None
    mod.fit(tmx.io.NDArrayIter(Xn, y, batch_size=20), num_epoch=1,
            kvstore=kv, optimizer_params=(("learning_rate", 0.1),),
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in init.items()})
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for name, want in jwant.items():
        assert np.isfinite(got[name]).all(), name
        _close(got[name], want, 1e-5, name)
    assert not np.array_equal(got["fc1_weight"], init["fc1_weight"])


def test_kvstore_barrier_watchdog_single_process(monkeypatch):
    """With one process the barrier is a no-op even when armed."""
    monkeypatch.setenv("MXTPU_STEP_TIMEOUT_S", "1.0")
    kv = tmx.kvstore.KVStore("dist_sync")
    kv.barrier()


def test_new_modules_import_without_jax():
    """Every module of the slice imports with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mxnet_tpu_torch\n"
        "from mxnet_tpu_torch.resilience import sentinel, watchdog\n"
        "from mxnet_tpu_torch.observability import flight\n"
        "from mxnet_tpu_torch.kernels import sweep_codegen, fused_opt\n"
        "from mxnet_tpu_torch.parallel import trainer\n"
        "assert not any(m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
