"""resilience: the port's fault-injection seams.

Only :mod:`.faultinject` is ported so far; checkpoint resilience, the
elastic re-mesh, the hot-state handoff and the network KV belong to
later slices (``ROADMAP.md``).
"""
from . import faultinject                                   # noqa: F401
from .faultinject import InjectedFault, maybe_fault         # noqa: F401

__all__ = ["faultinject", "InjectedFault", "maybe_fault"]
