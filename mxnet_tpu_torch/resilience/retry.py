"""Exponential-backoff retry for the retryable distributed paths.

The port's copy of ``mxnet_tpu/resilience/retry.py``.  Only
rendezvous/init-time operations are retryable: a worker dialing the
coordinator before it is up, a rank reading rank-0's published verdict
from the coordination KV.
Steady-state collectives are NOT retried — re-entering a collective a
peer already left deadlocks the pod; those paths get the watchdog
(bounded abort + restart) instead.
"""
from __future__ import annotations

import logging
import time as _time

from . import retry_max

#: substrings marking a transient rendezvous failure worth retrying
_TRANSIENT_MARKERS = ("deadline", "unavailable", "connection refused",
                      "connection reset", "timed out", "timeout",
                      "temporarily", "try again", "not yet")


def transient(exc):
    """Heuristic: does this exception look like a transient
    rendezvous failure (vs. a deterministic misconfiguration)?"""
    text = str(exc).lower()
    return any(marker in text for marker in _TRANSIENT_MARKERS)


class RetryPolicy(object):
    """max_tries attempts with exponential backoff.

    ``predicate(exc) -> bool`` decides retryability (default:
    :func:`transient`); a non-retryable exception propagates
    immediately.  Deterministic (no jitter) so tests replay exactly;
    rendezvous retries are per-worker and need no decorrelation.
    """

    def __init__(self, max_tries=None, base_delay_s=0.5, max_delay_s=30.0,
                 multiplier=2.0, retryable=(Exception,), predicate=None):
        self.max_tries = max_tries if max_tries is not None else retry_max()
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.multiplier = multiplier
        self.retryable = retryable
        self.predicate = predicate if predicate is not None else transient

    def delays(self):
        delay = self.base_delay_s
        for _ in range(max(0, self.max_tries - 1)):
            yield min(delay, self.max_delay_s)
            delay *= self.multiplier


def retry_call(fn, policy=None, phase="retry", logger=None, sleep=None):
    """Call ``fn()`` under ``policy``; return its result.

    Retries only exceptions that are both an instance of
    ``policy.retryable`` and accepted by ``policy.predicate``.  The
    last failure propagates unchanged once attempts are exhausted.
    ``sleep`` is injectable for tests (default ``time.sleep``).
    """
    policy = policy or RetryPolicy()
    logger = logger or logging
    sleep = sleep or _time.sleep
    delays = list(policy.delays()) + [None]      # None = no more tries
    last_exc = None
    for attempt, delay in enumerate(delays, 1):
        try:
            return fn()
        except policy.retryable as exc:  # noqa: PERF203
            last_exc = exc
            if delay is None or not policy.predicate(exc):
                raise
            logger.warning(
                "%s: attempt %d/%d failed (%r); retrying in %.1fs",
                phase, attempt, policy.max_tries, exc, delay)
            from .. import observability as obs
            obs.emit("fault", fault="retry", phase=phase,
                     attempt=attempt, max_tries=policy.max_tries,
                     delay_s=delay, error=repr(exc))
            sleep(delay)
    raise last_exc  # pragma: no cover - loop always returns or raises
