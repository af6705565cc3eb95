"""Step watchdog: bound the time any phase of the training loop may take.

The port of ``mxnet_tpu/resilience/watchdog.py``.  One change: the
rank comes from ``torch.distributed`` (through the event log's
:func:`~mxnet_tpu_torch.observability.events.rank`), not from
``jax.process_index()``.

A hung collective leaves every other worker blocked with no exception,
no timeout and no log line.  The watchdog converts "stuck" into a
structured :class:`~mxnet_tpu_torch.resilience.ResilienceError`
carrying rank/step/phase, so the job exits with the restart signal
(:data:`~mxnet_tpu_torch.resilience.EXIT_RESTART`) in bounded time, and
dumps the flight recorder (:mod:`mxnet_tpu_torch.observability.flight`)
while its pending ledger still names the (op, seq) that never completed.

Two shapes, because a stuck native call cannot be interrupted
in-thread:

- :func:`run_with_timeout` -- run one call in a watched worker thread;
  the caller raises (or exits 3) on timeout and abandons the wedged
  thread.  This is what ``ShardedTrainer.step`` and the kvstore
  collectives use when ``MXTPU_STEP_TIMEOUT_S`` is set.  PyTorch keeps
  the current device, stream and grad mode per thread: a caller whose
  ``fn`` launches CUDA work enters them in ``fn``.
- :class:`Watchdog` -- an armed monitor thread fed a heartbeat by the
  training loop (``feed()`` once per step); if the loop stalls longer
  than the timeout, the monitor fires ``on_timeout`` (default:
  structured stderr + ``os._exit(3)``, the only action that can
  escape a hang in the main thread).
"""
from __future__ import annotations

import threading
import time as _time

from . import ResilienceError, exit_for_restart, step_timeout_s


def _rank():
    try:
        from ..observability.events import rank
        return rank()
    except Exception:
        return 0


def _emit_fault(fault, phase, step, timeout_s):
    try:
        from .. import observability as obs
        obs.emit("fault", step=step, fault=fault, phase=phase,
                 timeout_s=timeout_s)
    except Exception:
        pass
    # a watchdog firing usually means a wedged collective: dump the
    # always-on flight recorder NOW, while the pending ledger still
    # names the (op, seq) that never completed (works with telemetry
    # off: that is the point of the ring)
    try:
        from ..observability import flight as _flight
        _flight.dump(reason=fault, extra={"phase": phase, "step": step,
                                          "timeout_s": timeout_s})
    except Exception:
        pass


def run_with_timeout(fn, timeout_s, phase, step=None, rank=None,
                     on_timeout="raise"):
    """Run ``fn()`` in a watched daemon thread; bound its duration.

    On timeout, the worker thread is abandoned (it may be wedged in a
    native collective and cannot be killed) and the caller either
    raises a :class:`ResilienceError` (``on_timeout="raise"``) or logs
    it and exits with the restart code (``on_timeout="exit"``).
    Exceptions from ``fn`` propagate unchanged.
    """
    if timeout_s is None:
        return fn()
    box = {}

    def _target():
        try:
            box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - forwarded to caller
            box["exc"] = exc

    worker = threading.Thread(target=_target, daemon=True,
                              name="mxtpu-watchdog-%s" % phase)
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        err = ResilienceError(
            "watchdog: %r exceeded %.1fs" % (phase, timeout_s),
            phase=phase, rank=rank if rank is not None else _rank(),
            step=step, kind="timeout", timeout_s=timeout_s)
        _emit_fault("watchdog_timeout", phase, step, timeout_s)
        if on_timeout == "exit":
            exit_for_restart(err)
        raise err
    if "exc" in box:
        raise box["exc"]
    return box.get("result")


class Watchdog(object):
    """Heartbeat-fed monitor for a long-running loop.

    >>> wd = Watchdog(timeout_s=300, phase="train")
    >>> wd.start()
    >>> for batch in data:
    ...     wd.feed(step=n)        # re-arms the timer
    ...     step(batch)
    >>> wd.stop()

    If ``feed`` stops arriving for ``timeout_s`` seconds the monitor
    thread fires ``on_timeout(err)`` exactly once.  The default action
    logs the structured error and ``os._exit(EXIT_RESTART)``: raising
    from the monitor thread could never reach a main thread that is
    blocked inside a collective.
    """

    def __init__(self, timeout_s=None, phase="train", rank=None,
                 on_timeout=None, poll_s=None):
        self.timeout_s = timeout_s if timeout_s is not None \
            else step_timeout_s()
        self.phase = phase
        self.rank = rank if rank is not None else _rank()
        self.on_timeout = on_timeout or exit_for_restart
        self.poll_s = poll_s if poll_s is not None \
            else max(0.05, min(1.0, (self.timeout_s or 1.0) / 10.0))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_beat = None
        self._step = None
        self._thread = None
        self.fired = False

    def start(self):
        """Arm the monitor (no-op without a timeout configured)."""
        if self.timeout_s is None or self._thread is not None:
            return self
        self._stop.clear()
        self.feed()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-watchdog-monitor")
        self._thread.start()
        return self

    def feed(self, step=None):
        """Heartbeat: the loop made progress; restart the countdown."""
        with self._lock:
            self._last_beat = _time.monotonic()
            if step is not None:
                self._step = step

    def stop(self):
        """Disarm and join the monitor."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                last, step = self._last_beat, self._step
            if last is None:
                continue
            elapsed = _time.monotonic() - last
            if elapsed > self.timeout_s:
                self.fired = True
                err = ResilienceError(
                    "watchdog: no progress in %r for %.1fs"
                    % (self.phase, elapsed),
                    phase=self.phase, rank=self.rank, step=step,
                    kind="stall", timeout_s=self.timeout_s)
                _emit_fault("watchdog_stall", self.phase, step,
                            self.timeout_s)
                try:
                    self.on_timeout(err)
                finally:
                    return
