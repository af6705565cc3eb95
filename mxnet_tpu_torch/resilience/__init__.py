"""resilience: the port's fault surface for serving fleets.

The port's copy of ``mxnet_tpu/resilience``'s host-side pieces:

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
- :mod:`.ckptmgr`: atomic, versioned checkpoints (host payloads).

Exit-code contract: ``3`` means "restart me" (:data:`EXIT_RESTART`).
The watchdog and the sentinel belong to the multi-GPU training slice
(``ROADMAP.md``).
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
    telemetry buffer is drained first, since ``os._exit`` skips atexit.
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


from . import faultinject                                   # noqa: E402
from .faultinject import (FaultSpec, InjectedFault,         # noqa: E402
                          maybe_fault, parse_fault_spec)
from . import netkv                                         # noqa: E402
from .netkv import (CoordKV, FileKV, TcpKV, TcpKVServer,    # noqa: E402
                    ResilientKV, Lease, KVUnreachable, KeyExists,
                    KeyAbsent, connect_kv)
from .retry import RetryPolicy, retry_call                  # noqa: E402
from .ckptmgr import CheckpointManager                      # noqa: E402
from . import elastic                                       # noqa: E402
from . import hotstate                                      # noqa: E402
from .hotstate import HotStateUnavailable                   # noqa: E402

__all__ = [
    "faultinject", "FaultSpec", "InjectedFault", "maybe_fault",
    "parse_fault_spec",
    "elastic", "hotstate", "HotStateUnavailable",
    "netkv", "CoordKV", "FileKV", "TcpKV", "TcpKVServer",
    "ResilientKV", "Lease", "KVUnreachable", "KeyExists", "KeyAbsent",
    "connect_kv",
    "EXIT_RESTART", "ResilienceError", "exit_for_restart",
    "install_excepthook", "step_timeout_s", "retry_max", "ckpt_keep",
    "RetryPolicy", "retry_call", "CheckpointManager",
]
