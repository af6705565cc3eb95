"""Attribute scoping for symbols (parity: python/mxnet/attribute.py).

A copy of ``AttrScope`` and ``mirror_scope`` from
``mxnet_tpu/attribute.py``: ``with AttrScope(ctx_group='stage1'):``
attaches attrs to every symbol created inside.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "mirror_scope"]


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


def mirror_scope(stage_name, enabled=True):
    """Attr scope tagging every op created inside it for activation
    recompute: ``force_mirroring`` and ``mirror_stage=stage_name`` (ops
    sharing a stage form one recomputed segment).  ``enabled=False``
    returns a no-op context, so model builders can expose a
    ``mirror_blocks`` flag without branching (``executor.build_program``
    turns the tags into recomputed segments)."""
    if not enabled:
        import contextlib
        return contextlib.nullcontext()
    return AttrScope(force_mirroring="true", mirror_stage=stage_name)
