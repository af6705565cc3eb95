"""NaN/Inf/loss-spike sentinel: turn numeric faults into skipped steps.

The port's copy of ``mxnet_tpu/resilience/sentinel.py``.  One change:
:meth:`Sentinel.grad_norm` takes the port's NDArrays or torch tensors and
sums their squares in float64 on their own device (one host read a
device), where the JAX package copies every gradient to numpy.

A single NaN gradient, applied, destroys every parameter in one update.
The sentinel makes the same event cost one skipped step: detect the
non-finite (or wildly spiking) loss/grad-norm *before* the update lands,
skip the step, back off the loss scale, and record the last good step so
operators know how much history is trustworthy.

This module is the host-side sentinel used by the classic
Module/FeedForward loops (the fused path has an in-step counterpart:
``ShardedTrainer(sentinel=True)`` gates the update on the device, where a
host check would force a device sync every step).  Enable with
``MXTPU_SENTINEL=1`` or by passing an instance.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from . import sentinel_enabled

#: verdicts returned by :meth:`Sentinel.check`
OK = "ok"
SKIP_NONFINITE = "skip-nonfinite"
SKIP_SPIKE = "skip-spike"


class DynamicLossScale(object):
    """Standard dynamic loss scaling: halve on a bad step, double after
    ``growth_interval`` consecutive good ones, clamped to
    [min_scale, max_scale]."""

    def __init__(self, init=2.0 ** 15, growth_interval=200,
                 min_scale=1.0, max_scale=2.0 ** 24):
        self.scale = float(init)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.good_steps = 0

    def good(self):
        self.good_steps += 1
        if self.good_steps >= self.growth_interval:
            self.scale = min(self.scale * 2.0, self.max_scale)
            self.good_steps = 0

    def bad(self):
        self.scale = max(self.scale * 0.5, self.min_scale)
        self.good_steps = 0


class Sentinel(object):
    """Per-step numeric health check with skip-step semantics.

    Call :meth:`check` once per step with whatever signals are cheap
    to produce (loss and/or global grad-norm).  A non-finite signal,
    or one exceeding ``spike_factor``× the exponential moving average,
    returns a skip verdict; the caller must then NOT apply the update.
    The sentinel tracks ``last_good_step``, a bounded ``skipped``
    record, and a :class:`DynamicLossScale` whose ``scale`` the caller
    applies when training in reduced precision.
    """

    def __init__(self, spike_factor=1e3, ema_decay=0.9, warmup_steps=5,
                 max_consecutive_skips=20, loss_scale=None, logger=None):
        self.spike_factor = float(spike_factor)
        self.ema_decay = float(ema_decay)
        self.warmup_steps = int(warmup_steps)
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.loss_scale = loss_scale or DynamicLossScale()
        self.logger = logger or logging
        self._ema = None
        self._seen = 0
        self.last_good_step = None
        self.skipped = []            # [(step, verdict, value), ...]
        self.consecutive_skips = 0

    @classmethod
    def from_env(cls, **kwargs):
        """A Sentinel when ``MXTPU_SENTINEL`` enables one, else None."""
        return cls(**kwargs) if sentinel_enabled() else None

    # ------------------------------------------------------------------
    def check(self, step, loss=None, grad_norm=None):
        """Return a verdict for this step; updates internal state.

        ``loss``/``grad_norm`` may be python floats, numpy scalars, or
        0-d arrays; either may be None (checked only if given).
        """
        values = [v for v in (loss, grad_norm) if v is not None]
        verdict, signal = OK, None
        for v in values:
            v = float(_np.asarray(v))
            signal = v if signal is None else max(signal, v)
            if not _np.isfinite(v):
                verdict = SKIP_NONFINITE
                break
        if verdict is OK and signal is not None and self._ema is not None \
                and self._seen >= self.warmup_steps \
                and abs(signal) > self.spike_factor * max(abs(self._ema),
                                                          1e-12):
            verdict = SKIP_SPIKE
        if verdict is OK:
            if signal is not None:
                self._ema = signal if self._ema is None else (
                    self.ema_decay * self._ema
                    + (1.0 - self.ema_decay) * signal)
                self._seen += 1
            self.last_good_step = step
            self.consecutive_skips = 0
            self.loss_scale.good()
            return OK
        self.skipped.append((step, verdict, signal))
        del self.skipped[:-100]                  # bounded record
        self.consecutive_skips += 1
        self.loss_scale.bad()
        self.logger.warning(
            "sentinel: step %s %s (signal=%r); update skipped, loss scale "
            "-> %g, last good step %s", step, verdict, signal,
            self.loss_scale.scale, self.last_good_step)
        self._emit_fault(step, verdict, signal)
        if self.consecutive_skips >= self.max_consecutive_skips:
            from . import ResilienceError
            self._emit_fault(step, verdict, signal,
                             fault="sentinel_escalate")
            try:
                from ..observability import flight as _flight
                _flight.dump(reason="sentinel_escalate",
                             extra={"step": step, "verdict": verdict,
                                    "consecutive":
                                        self.consecutive_skips})
            except Exception:
                pass
            raise ResilienceError(
                "sentinel: %d consecutive skipped steps — numerics are "
                "not recovering" % self.consecutive_skips,
                phase="sentinel", step=step, kind="numeric")
        return verdict

    def _emit_fault(self, step, verdict, signal, fault="sentinel_skip"):
        try:
            from .. import observability as obs
            obs.emit("fault", step=step, fault=fault, verdict=verdict,
                     signal=None if signal is None else float(signal),
                     loss_scale=self.loss_scale.scale,
                     consecutive=self.consecutive_skips,
                     last_good_step=self.last_good_step, phase="sentinel")
        except Exception:
            pass

    # ------------------------------------------------------------------
    @staticmethod
    def grad_norm(grad_arrays):
        """Global L2 norm over a Module-style grads structure: a list
        (per param) of lists (per device) of NDArrays, tensors or numpy
        arrays, any of which may be None.  EVERY device's copy is
        accumulated -- a non-finite gradient on any one device must trip
        the sentinel before the cross-device aggregation folds it into
        the update.  The squares are summed in float64 on each array's
        device; the host reads one sum a device."""
        sums = {}
        for per_param in grad_arrays:
            devs = per_param if isinstance(per_param, (list, tuple)) \
                else [per_param]
            for g in devs:
                if g is None:
                    continue
                t = getattr(g, "data", g) if hasattr(g, "asnumpy") else g
                if not isinstance(t, torch.Tensor):
                    t = torch.as_tensor(_np.asarray(t))
                sq = torch.sum(t.detach().to(torch.float64) ** 2)
                key = str(sq.device)
                sums[key] = sq if key not in sums else sums[key] + sq
        total = sum(float(s) for s in sums.values())
        if not _np.isfinite(total):
            return float("nan")
        return float(_np.sqrt(total))
