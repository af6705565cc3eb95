"""Monitor: regex-filtered per-output statistics during training.

The port of ``mxnet_tpu/monitor.py`` (the reference's
``python/mxnet/monitor.py``).  ``install`` sets the executor's monitor
callback (``Executor.set_monitor_callback``): each ``Executor.forward``
then reports every op output, from the graph walk that runs, to the
callback; ``toc`` adds the bound arguments that match the pattern.  A
statistic is computed on the host (the default copies the tensor to
numpy), so a monitored step is slower: remove the monitor for timing
runs.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray

__all__ = ["Monitor"]


def _abs_mean(arr):
    """Default statistic: mean absolute value of the tensor."""
    a = arr.asnumpy()
    return abs(a).sum() / a.size


class Monitor(object):
    """Collects ``(step, tensor_name, stat)`` records for every monitored
    op output (and, at ``toc``, every matching bound argument) on batches
    where ``step % interval == 0``.

    API contract matches the reference Monitor: construct with
    ``(interval, stat_func, pattern, sort)``, ``install`` on executors
    (Module.install_monitor does this), call ``tic()`` before the batch
    and ``toc()``/``toc_print()`` after it.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 alarm_nonfinite=False):
        self.interval = interval
        self.stat_func = stat_func or _abs_mean
        self._pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.exes = []
        self.queue = []
        # nonfinite sentinel mode (docs/resilience.md): record which
        # monitored tensor first went NaN/Inf — the localization tool
        # the global grad-norm sentinel can't be
        self.alarm_nonfinite = bool(alarm_nonfinite)
        self.nonfinite_records = []       # [(step, name, stat), ...]
        # bound method, captured once: executors hold this as their
        # monitor callback
        self.stat_helper = self._record

    # -- callback fired per monitored op output -----------------------
    def _record(self, name, array):
        if self.activated and self._pattern.match(name):
            stat = self.stat_func(array)
            if self.alarm_nonfinite:
                import numpy as _np
                vals = stat if isinstance(stat, (list, tuple)) else (stat,)
                if not all(_np.isfinite(_np.asarray(v).astype(_np.float64))
                           .all() for v in vals):
                    self.nonfinite_records.append((self.step, name, stat))
                    del self.nonfinite_records[:-100]    # bounded
                    logging.warning(
                        "Monitor: NON-FINITE stat at step %d tensor %r: %r",
                        self.step, name, stat)
            self.queue.append((self.step, name, stat))

    def _sync_args(self):
        for exe in self.exes:
            for array in exe.arg_arrays:
                if isinstance(array, NDArray):
                    array.wait_to_read()

    # -- public API ---------------------------------------------------
    def install(self, exe):
        """Attach to an executor's monitor hook."""
        if not self.exes:
            logging.warning(
                "Monitor installed: every op output of a forward is copied "
                "to the host for its statistic; expect a slowdown while "
                "installed, and remove the monitor for timing runs")
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Arm collection if this step is on the interval."""
        if self.step % self.interval == 0:
            self._sync_args()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Disarm and drain: returns [(step, name, stat_string), ...].

        Bound arguments (weights etc.) matching the pattern are stat'd
        here too, so a pattern like ``.*weight`` reports parameter
        magnitudes alongside activation stats.
        """
        if not self.activated:
            return []
        self._sync_args()
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                if self._pattern.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda rec: rec[1])
        drained = [
            (step, name,
             "\t".join(str(v) for v in
                       (stat if isinstance(stat, (list, tuple))
                        else (stat,))) + "\t")
            for step, name, stat in self.queue]
        self.queue = []
        return drained

    def toc_print(self):
        """Drain and log each record."""
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)
