"""Training callbacks.

The port's slice of ``mxnet_tpu/callback.py``: ``do_checkpoint``,
``module_checkpoint``, ``log_train_metric``, ``Speedometer``,
``ProgressBar`` and the ``BatchEndParam`` namedtuple shared with
``Module.fit``.  ``do_checkpoint`` saves synchronously (the JAX
package's ``run_async`` goes through its dependency engine, which the
port does not have).
"""
from __future__ import annotations

import logging
import math
import sys
import time
from collections import namedtuple

__all__ = ["BatchEndParam", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "module_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def do_checkpoint(prefix, period=1):
    """Epoch-end callback to checkpoint the model (parity: callback.py
    do_checkpoint -> model.save_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback checkpointing a Module (parity: callback.py)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the eval metric every ``period`` batches
    (parity: callback.py log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer(object):
    """Log samples/sec every ``frequent`` batches (parity: callback.py
    Speedometer; THE throughput readout in every reference example).

    Speed is computed over the ACTUAL number of batches seen since the
    last report, not ``frequent`` — after a resume or a mid-epoch
    re-init the first window is short and assuming ``frequent`` would
    overstate throughput.  ``auto_reset=False`` keeps the running
    metric across reports (reference behavior is reset-per-window).
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self._tic_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                batches = count - self._tic_count
                elapsed = time.time() - self.tic
                if batches <= 0 or elapsed <= 0:
                    self.tic = time.time()
                    self._tic_count = count
                    return
                speed = batches * self.batch_size / elapsed
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    for name, value in name_value:
                        logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                                     param.epoch, count, speed, name, value)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
                self._tic_count = count
        else:
            self.init = True
            self.tic = time.time()
            self._tic_count = count


class ProgressBar(object):
    """Text progress bar (parity: callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write("[%s] %s%s\r" % (prog_bar, percents, "%"))
