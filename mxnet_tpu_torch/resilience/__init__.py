"""resilience: the port's fault surface for training jobs and serving
fleets.

The port of ``mxnet_tpu/resilience``:

- :mod:`.sentinel`: NaN/Inf/loss-spike detection with skip-step, dynamic
  loss-scale backoff and a last-good-step record, for the host loops
  (``Module.fit``, ``FeedForward``); the in-step gate on the device is
  ``parallel.ShardedTrainer(sentinel=True)``;
- :mod:`.watchdog`: step and collective timeouts that turn a stuck
  dispatch into a structured :class:`ResilienceError` carrying
  rank/step/phase, and dump the flight recorder;
- :mod:`.faultinject`: the deterministic fault injector
  (``MXTPU_FAULT_SPEC``) and its seams;
- :mod:`.retry`: exponential-backoff retry for rendezvous paths;
- :mod:`.netkv`: the coordination KV (``MXTPU_KV_URL``: file- or
  TCP-backed) behind one ``CoordKV`` surface, the ``ResilientKV`` fault
  discipline and the expiring leader ``Lease`` fleet routers elect
  through -- byte-compatible with the JAX package's, on disk and on the
  wire;
- :mod:`.elastic`: the generation ledger, the fence and the re-mesh
  decision protocol over an injected coordination client;
- :mod:`.hotstate`: redundant host-memory hot state for warm re-mesh
  (payload files byte-compatible with the JAX package's);
- :mod:`.ckptmgr`: atomic, versioned checkpoints (host payloads), and
  ``latest_classic_epoch`` for the ``prefix-NNNN.params`` files.

Exit-code contract: ``3`` means "restart me" (:data:`EXIT_RESTART`).
"""
from __future__ import annotations

import os as _os
import sys as _sys

from ..base import MXNetError

#: Process exit code meaning "state is consistent, restart the job".
EXIT_RESTART = 3


class ResilienceError(MXNetError):
    """A failure the runtime converted into a restartable condition.

    Carries structured context (phase/rank/step/kind); uncaught, the
    contract is to exit with :data:`EXIT_RESTART`.
    """

    exit_code = EXIT_RESTART

    def __init__(self, message, phase=None, rank=None, step=None,
                 kind="timeout", timeout_s=None):
        self.phase = phase
        self.rank = rank
        self.step = step
        self.kind = kind
        self.timeout_s = timeout_s
        super().__init__("%s [%s]" % (message, self.context()))

    def context(self):
        """``key=value`` context string (grep-stable)."""
        parts = ["kind=%s" % self.kind]
        for key in ("phase", "rank", "step", "timeout_s"):
            val = getattr(self, key)
            if val is not None:
                parts.append("%s=%s" % (key, val))
        return " ".join(parts)


def exit_for_restart(err):
    """Log ``err`` with full context and exit with :data:`EXIT_RESTART`.

    ``os._exit`` on purpose: the failed thread may be wedged in native
    code that normal interpreter teardown would join forever.  The
    telemetry buffer is drained and the flight recorder dumped first,
    since ``os._exit`` skips atexit.
    """
    print("RESILIENCE ABORT: %s" % err, file=_sys.stderr, flush=True)
    try:
        from .. import observability as _obs
        _obs.emit("fault", step=getattr(err, "step", None),
                  fault="exit_restart", phase=getattr(err, "phase", None),
                  error_kind=getattr(err, "kind", None), error=str(err))
        _obs.flush()
    except Exception:       # last words must never block the exit
        pass
    # the flight-recorder ring and pending-collective ledger, persisted
    # before the hard exit
    try:
        from ..observability import flight as _flight
        _flight.dump(reason="exit_restart",
                     extra={"phase": getattr(err, "phase", None),
                            "step": getattr(err, "step", None),
                            "error": str(err)})
    except Exception:
        pass
    _os._exit(getattr(err, "exit_code", EXIT_RESTART))


def install_excepthook():
    """Make an uncaught :class:`ResilienceError` exit with code 3."""
    prev = _sys.excepthook

    def _hook(exc_type, exc, tb):
        if isinstance(exc, ResilienceError):
            prev(exc_type, exc, tb)
            exit_for_restart(exc)
        prev(exc_type, exc, tb)

    _sys.excepthook = _hook


# env knobs, read at call time so tests can monkeypatch the environment
def step_timeout_s(default=None):
    """``MXTPU_STEP_TIMEOUT_S``: step/collective timeout (float seconds);
    None/unset disables."""
    raw = _os.environ.get("MXTPU_STEP_TIMEOUT_S")
    if not raw:
        return default
    return float(raw)


def retry_max(default=3):
    """``MXTPU_RETRY_MAX``: attempts for retryable rendezvous paths."""
    raw = _os.environ.get("MXTPU_RETRY_MAX")
    return int(raw) if raw else default


def ckpt_keep(default=3):
    """``MXTPU_CKPT_KEEP``: checkpoints retained by CheckpointManager."""
    raw = _os.environ.get("MXTPU_CKPT_KEEP")
    return int(raw) if raw else default


def sentinel_enabled(default=False):
    """``MXTPU_SENTINEL``: enable NaN/Inf/spike sentinels by default."""
    raw = _os.environ.get("MXTPU_SENTINEL")
    if raw is None:
        return default
    return raw.lower() not in ("", "0", "false", "off")


from . import faultinject                                   # noqa: E402
from .faultinject import (FaultSpec, FaultInjector,         # noqa: E402
                          InjectedFault, injector, maybe_fault,
                          parse_fault_spec, poison_nan)
from . import netkv                                         # noqa: E402
from .netkv import (CoordKV, FileKV, TcpKV, TcpKVServer,    # noqa: E402
                    ResilientKV, Lease, KVUnreachable, KeyExists,
                    KeyAbsent, connect_kv)
from .watchdog import Watchdog, run_with_timeout           # noqa: E402
from .retry import RetryPolicy, retry_call                  # noqa: E402
from .sentinel import Sentinel                              # noqa: E402
from .ckptmgr import CheckpointManager, latest_classic_epoch  # noqa: E402
from . import elastic                                       # noqa: E402
from . import hotstate                                      # noqa: E402
from .hotstate import HotStateUnavailable                   # noqa: E402

__all__ = [
    "faultinject", "FaultSpec", "FaultInjector", "InjectedFault",
    "maybe_fault", "parse_fault_spec", "injector", "poison_nan",
    "elastic", "hotstate", "HotStateUnavailable",
    "netkv", "CoordKV", "FileKV", "TcpKV", "TcpKVServer",
    "ResilientKV", "Lease", "KVUnreachable", "KeyExists", "KeyAbsent",
    "connect_kv",
    "EXIT_RESTART", "ResilienceError", "exit_for_restart",
    "install_excepthook", "step_timeout_s", "retry_max", "ckpt_keep",
    "sentinel_enabled", "Watchdog", "run_with_timeout", "Sentinel",
    "RetryPolicy", "retry_call", "CheckpointManager", "latest_classic_epoch",
]
