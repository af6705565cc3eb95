"""Attribute scoping for symbols (parity: python/mxnet/attribute.py).

A copy of ``AttrScope`` from ``mxnet_tpu/attribute.py``:
``with AttrScope(ctx_group='stage1'):`` attaches attrs to every symbol
created inside.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """Merge scope attrs into user-supplied ``attr`` dict (user wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
