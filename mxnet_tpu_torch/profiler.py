"""Profiler: per-step timing + a device trace through ``torch.profiler``.

The port of ``mxnet_tpu/profiler.py``, with the reference-flavoured API::

    mx.profiler.profiler_set_config(filename='profile_dir')
    mx.profiler.profiler_set_state('run')   # start a trace
    ... training ...
    mx.profiler.profiler_set_state('stop')  # write the trace

``'run'`` starts a ``torch.profiler.profile`` with the CPU activity and,
when a CUDA device is present, the CUDA activity (CUPTI); ``'stop'``
writes one Chrome trace (``trace-<pid>-<n>.json``, viewable at
``chrome://tracing`` or https://ui.perfetto.dev) into the configured
directory and returns its path.  ``mode='cpu'`` traces the host alone.
When the card is asked for, the first ``'run'`` of a process traces
:data:`PROBE_KERNELS` small kernels first (up to three tries); if CUPTI
records no device activity, ``'run'`` raises rather than record a
host-only trace under the name of a device trace.

CUPTI leaves the first kernels of a session without timestamps once the
process has run a CUDA profiler session and then much CUDA work (on an
H100 under PyTorch 2.11, the first 11-22 kernel records of about half
the sessions, with start and end 0); kineto then drops them as outside
the session's window.  So the probe launches many more kernels
than that, and every CUDA session starts with :data:`LEAD_IN` tiny
kernels of its own (``mx.profiler.lead_in`` in the trace), which take
those records so that the caller's first kernels keep theirs.  Each
session also waits :data:`FLUSH_S` after a synchronize before it stops.

:class:`annotate` names a region in the trace
(``torch.profiler.record_function``, plus an NVTX range on a CUDA
process, as :mod:`.observability.spans` pushes); the built-in wiring
passes names from the shared phase registry (:data:`PHASES`).
:class:`StepTimer` gives quick throughput numbers without a trace.
"""
from __future__ import annotations

import os
import time

from .base import MXNetError
from .observability.phases import PHASES

__all__ = ["profiler_set_config", "profiler_set_state", "StepTimer",
           "annotate", "PHASES", "running"]

_config = {"filename": "mxtpu_profile", "mode": "symbolic"}
#: seconds a session waits, after a synchronize, for CUPTI's records
FLUSH_S = 0.1
_PROBE_TRIES = 3
#: kernels of one probe session: far more than CUPTI leaves without
#: timestamps at the start of a session
PROBE_KERNELS = 256
#: tiny kernels that open every CUDA session, ahead of the caller's
LEAD_IN = 64
_state = {"state": "stop", "prof": None, "cuda": False, "n": 0,
          "cupti": None, "probe": []}


def profiler_set_config(mode="symbolic", filename="mxtpu_profile"):
    """Parity: MXSetProfilerConfig.  ``filename`` is the directory the
    traces go to; ``mode='cpu'`` leaves the CUDA activity out."""
    _config["mode"] = mode
    _config["filename"] = filename


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = _config["mode"] != "cpu" and torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts, cuda


def profiler_set_state(state="stop"):
    """``'run'`` starts a trace; ``'stop'`` ends it and writes it into
    the configured directory (returns the file's path; None when no
    trace was running).  Parity: MXSetProfilerState."""
    import torch
    if state == "run":
        if _state["state"] != "run":
            acts, cuda = _activities()
            if cuda and not _cupti_traces(torch, acts):
                raise MXNetError(
                    "profiler: the CUDA activity was asked for and CUPTI "
                    "recorded no device event; no host-only trace is "
                    "taken in its place (profiler_set_config(mode='cpu') "
                    "traces the host alone)")
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            if cuda:
                with torch.profiler.record_function("mx.profiler.lead_in"):
                    x = torch.zeros(1, device="cuda")
                    for _ in range(LEAD_IN):
                        x.add_(1)
                    torch.cuda.synchronize()
            _state.update(state="run", prof=prof, cuda=cuda)
        return None
    if state != "stop":
        raise MXNetError("profiler state must be 'run' or 'stop'")
    if _state["state"] != "run":
        return None
    prof, cuda = _state["prof"], _state["cuda"]
    if cuda:
        torch.cuda.synchronize()
        time.sleep(FLUSH_S)
    prof.__exit__(None, None, None)
    _state.update(state="stop", prof=None)
    directory = _config["filename"]
    os.makedirs(directory, exist_ok=True)
    _state["n"] += 1
    path = os.path.join(directory, "trace-%d-%d.json"
                        % (os.getpid(), _state["n"]))
    prof.export_chrome_trace(path)
    return path


def probe_session(torch, acts):
    """One probe session: :data:`PROBE_KERNELS` small kernels traced,
    :data:`FLUSH_S` after a synchronize; the device events recorded."""
    with torch.profiler.profile(activities=acts) as probe:
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(PROBE_KERNELS - 1):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(FLUSH_S)
    return sum(1 for ev in probe.events()
               if str(getattr(ev, "device_type", "")).endswith("CUDA"))


def _cupti_traces(torch, acts):
    """Does a probe session hold an event that ran on the card, in one
    of :data:`_PROBE_TRIES` tries?  A yes is kept for the process; each
    try's count of device events is kept in ``_state["probe"]``."""
    for _ in range(0 if _state["cupti"] else _PROBE_TRIES):
        _state["probe"].append(probe_session(torch, acts))
        if _state["probe"][-1]:
            _state["cupti"] = True
            break
    return bool(_state["cupti"])


def running():
    """Is a trace being recorded?"""
    return _state["state"] == "run"


class annotate:
    """Context manager naming a region in the trace: a
    ``torch.profiler.record_function`` range, and an NVTX range on a
    CUDA process."""

    def __init__(self, name):
        self.name = name
        self._ctx = None
        self._nvtx = False

    def __enter__(self):
        import torch
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._nvtx = torch.cuda.is_available() and \
            torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        import torch
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return self._ctx.__exit__(*exc)


class StepTimer(object):
    """Cheap step timing: wall clock per step + derived throughput."""

    def __init__(self, batch_size=None):
        self.batch_size = batch_size
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise MXNetError("StepTimer.stop before start")
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self, skip_first=1):
        ts = self.times[skip_first:] or self.times
        if not ts:
            return {}
        mean = sum(ts) / len(ts)
        out = {"steps": len(ts), "mean_s": mean,
               "min_s": min(ts), "max_s": max(ts)}
        from .observability.counters import percentile
        out["p50_s"] = percentile(ts, 50)
        out["p95_s"] = percentile(ts, 95)
        if self.batch_size:
            out["samples_per_sec"] = self.batch_size / mean
        return out
