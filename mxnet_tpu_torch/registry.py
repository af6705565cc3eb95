"""Generic named registries.

A copy of ``mxnet_tpu/registry.py``.  Replacement for ``dmlc::Registry``
(SURVEY §2.11): operator, iterator, optimizer, initializer, and metric
registries all hang off this.
Registries become plain Python decorators instead of static C++ singletons.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["Registry"]


class Registry:
    """A case-tolerant name -> entry registry with a decorator interface."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries = {}

    def register(self, name=None, entry=None):
        """Use as ``@reg.register`` / ``@reg.register('Name')`` / direct call."""
        if entry is not None:
            return self._do_register(name, entry)
        if name is not None and not isinstance(name, str):
            return self._do_register(getattr(name, "__name__"), name)

        def _wrap(obj):
            return self._do_register(name or getattr(obj, "__name__"), obj)
        return _wrap

    def _do_register(self, name, entry):
        key = name.lower()
        self._entries[key] = (name, entry)
        return entry

    def alias(self, name, alias_name):
        self._entries[alias_name.lower()] = (alias_name, self.get(name))
        return self

    def get(self, name):
        key = str(name).lower()
        if key not in self._entries:
            raise MXNetError(
                "unknown %s: %r (registered: %s)"
                % (self.kind, name, sorted(n for n, _ in self._entries.values())))
        return self._entries[key][1]

    def find(self, name):
        entry = self._entries.get(str(name).lower())
        return entry[1] if entry else None

    def __contains__(self, name):
        return str(name).lower() in self._entries

    def list_names(self):
        return sorted(n for n, _ in self._entries.values())

    def items(self):
        return [(n, e) for n, e in self._entries.values()]
