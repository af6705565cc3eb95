"""Device mesh of one device.

The port's slice of ``mxnet_tpu/parallel/mesh.py``.  The JAX package
names a set of TPU devices as a ``jax.sharding.Mesh``; the port's
training slice runs on one GPU, so :func:`make_mesh` builds a mesh of
exactly one device, whose every axis has size 1.  Meshes of several
GPUs (NCCL collectives, ``torch.distributed``) come with the multi-GPU
slice and raise here.
"""
from __future__ import annotations

import math
from collections import OrderedDict

from ..base import MXNetError
from ..context import resolve

__all__ = ["Mesh", "make_mesh", "AXIS_ORDER"]

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


class Mesh:
    """Named axes over a list of ``torch.device``s (here: one)."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, sizes))

    @property
    def size(self):
        return int(math.prod(self.shape.values())) if self.shape else 1

    @property
    def device(self):
        """The mesh's one device."""
        return self.devices[0]

    def __repr__(self):
        return "Mesh(%s on %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.devices)


def make_mesh(devices=None, **axis_sizes):
    """A mesh with named axes, e.g. ``make_mesh(dp=1)``.

    ``devices``: a list of contexts or ``torch.device``s (``None`` =
    ``[gpu(0)]``).  The axis sizes must multiply to the device count (an
    axis given as -1 is inferred), and the count must be 1: a mesh of
    several GPUs belongs to the multi-GPU slice."""
    if devices is None:
        devices = [None]
    devices = [resolve(d) for d in devices]
    if len(devices) != 1:
        raise MXNetError("make_mesh: %d devices given; meshes of several "
                         "GPUs come with the multi-GPU training slice, "
                         "this one takes exactly one" % len(devices))
    names = [a for a in AXIS_ORDER if a in axis_sizes]
    names += [a for a in axis_sizes if a not in AXIS_ORDER]
    sizes = [1 if axis_sizes[a] == -1 else int(axis_sizes[a])
             for a in names]
    if math.prod(sizes) != 1:
        raise MXNetError("make_mesh: axes %s multiply to %d but 1 device "
                         "is present" % (dict(zip(names, sizes)),
                                         math.prod(sizes)))
    return Mesh(devices, names, sizes)
