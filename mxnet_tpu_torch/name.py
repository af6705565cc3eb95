"""Automatic symbol naming (parity: python/mxnet/name.py).

A copy of ``mxnet_tpu/name.py``.

NameManager hands out ``fullyconnected0``-style unique names; Prefix variant
prepends a fixed prefix (used by model zoo builders).
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        self._old_manager = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        return NameManager._current.value


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
