"""Device meshes.

The port of ``mxnet_tpu/parallel/mesh.py``.  The JAX package names a set
of TPU devices as a ``jax.sharding.Mesh``; the port names a list of
contexts (one mesh member each) as a :class:`Mesh` with the same named
axes (:data:`AXIS_ORDER`), the members in row-major order of the axes
(:meth:`Mesh.coords`).  ``dp`` may span several GPUs of one process (the
collectives of ``parallel/collectives.py`` between them) and the
processes of a ``torch.distributed`` group (one context each, started by
a ``dist_*`` kvstore from ``tools/launch.py``'s env).  ``ep`` (expert
parallelism: ``ShardedTrainer`` over an MoE graph), ``pp`` (pipeline
parallelism: ``parallel.pipeline.GPipeTrainer``), ``tp`` (tensor
parallelism: ``ShardedTrainer``, ``ShardedPredictor`` and the
generation engine over split weights, ``parallel/tensor_parallel.py``)
and ``sp`` (sequence parallelism: ``ShardedTrainer(seq_axis=...)`` and
``ShardedPredictor(seq_axis=...)``, ring attention over each sp group,
``parallel/sequence_parallel.py``) span the cards of one process;
across processes they raise (ROADMAP.md queue 1 item 3 (k)).
:meth:`Mesh.axis_members` and :meth:`Mesh.axis_group` give the
sub-groups along one axis: the tp group of a member (the members that
differ from it only in their tp index), its sp ring and its dp group.

Unlike a JAX mesh, a mesh here may name one context twice, or two
contexts of one device (``[gpu(0), gpu(0)]``, ``[cpu(0), cpu(1)]``):
those members share the device, and their collectives are plain adds
and copies there.  That changes no result; it is how a data-, expert- or
pipeline-parallel step runs on one card, and how the CPU tests run one.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch

from ..base import MXNetError
from ..context import Context, current_context, resolve

__all__ = ["Mesh", "make_mesh", "auto_mesh", "local_device_count",
           "LogicalMesh", "remesh", "AXIS_ORDER"]

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


def _as_context(d):
    if isinstance(d, Context):
        return d
    if isinstance(d, torch.device) or isinstance(d, str):
        return Context.from_device(torch.device(d))
    return Context(d)


def local_device_count():
    """CUDA devices of this process (0 on a machine without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class Mesh:
    """Named axes over a list of contexts, one replica each.

    ``contexts`` are the local replicas' contexts, ``devices`` their
    ``torch.device``s (one per replica; they may repeat).  In a process
    group of several processes, ``shape`` counts every process's
    replicas (``dp`` = local replicas x processes), as a JAX mesh spans
    every process's devices."""

    def __init__(self, contexts, axis_names, sizes, num_processes=1):
        self.contexts = [_as_context(c) for c in contexts]
        self.devices = [resolve(c) for c in self.contexts]
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, sizes))
        self.num_processes = int(num_processes)
        self._group = None

    @property
    def size(self):
        return int(math.prod(self.shape.values())) if self.shape else 1

    @property
    def device(self):
        """The first replica's device."""
        return self.devices[0]

    def coords(self, i):
        """Member ``i``'s index along each axis: ``{axis: index}`` (the
        members are the axes' row-major order)."""
        out = {}
        for a in reversed(self.axis_names):
            size = self.shape[a]
            out[a] = i % size
            i //= size
        return out

    def members(self, **fixed):
        """The indices of the local members whose coordinates equal
        ``fixed`` (e.g. ``members(dp=0)``: the first dp replica's ep
        group), in member order."""
        return [i for i in range(len(self.devices))
                if all(self.coords(i).get(a, 0) == v
                       for a, v in fixed.items())]

    def axis_members(self, i, axis):
        """The members that share every coordinate of member ``i`` but
        ``axis`` (its tp group for ``"tp"``, its dp group for ``"dp"``),
        in the axis's order; ``[i]`` when the mesh lacks the axis."""
        fixed = {a: v for a, v in self.coords(i).items() if a != axis}
        return self.members(**fixed)

    def axis_group(self, i, axis):
        """:meth:`group_of` over :meth:`axis_members`."""
        return self.group_of(self.axis_members(i, axis))

    def group_of(self, members):
        """A :class:`~.collectives.ReplicaGroup` over the devices of
        ``members`` (local member indices)."""
        from .collectives import ReplicaGroup
        return ReplicaGroup([self.devices[i] for i in members])

    def replica_group(self):
        """The :class:`~.collectives.ReplicaGroup` of this mesh's
        replicas (made once)."""
        if self._group is None:
            from .collectives import ReplicaGroup
            self._group = ReplicaGroup(self.devices, self.num_processes)
        return self._group

    def __repr__(self):
        return "Mesh(%s on %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.contexts)


def _check_axes(names, sizes, world):
    for a, s in zip(names, sizes):
        if s <= 1 or a == "dp":
            continue
        if a not in ("ep", "pp", "sp", "tp"):
            raise MXNetError("make_mesh: unknown mesh axis %r (the axes "
                             "are %s)" % (a, ", ".join(AXIS_ORDER)))
        if world > 1:
            raise MXNetError(
                "make_mesh: axis %s=%d across the %d processes of a "
                "torch.distributed group is not ported yet (ROADMAP.md "
                "queue 1 item 3 (k)); run ep, pp, sp and tp on the cards "
                "of one process" % (a, s, world))


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _default_devices():
    """``[cpu(0)]`` inside a ``with cpu():`` scope, else every CUDA
    device of this process (raising without one, as ``gpu(0)`` does)."""
    if current_context().device_type == "cpu":
        return [Context("cpu", 0)]
    n = local_device_count()
    if n == 0:
        resolve(Context("gpu", 0))
    return [Context("gpu", i) for i in range(n)]


def make_mesh(devices=None, **axis_sizes):
    """A mesh with named axes, e.g. ``make_mesh([gpu(0), gpu(1)], dp=2)``.

    ``devices``: a list of contexts (or ``torch.device``s, device
    strings); None means every CUDA device of this process (``cpu(0)``
    inside a ``with cpu():`` scope).  Axis sizes
    multiply to the device count of every process together; one axis
    given as -1 is inferred.  In a ``torch.distributed`` group of
    several processes each process gives its own devices (one each)."""
    if devices is None:
        devices = _default_devices()
    contexts = [_as_context(d) for d in devices]
    world = _world()
    if world > 1 and len(contexts) != 1:
        raise MXNetError(
            "make_mesh: %d local devices in a process group of %d "
            "processes: several cards per process within a dist group "
            "are not ported yet (ROADMAP.md queue 1 item 3 (g)); launch one "
            "process per card" % (len(contexts), world))
    n = len(contexts) * world
    names = [a for a in AXIS_ORDER if a in axis_sizes]
    names += [a for a in axis_sizes if a not in AXIS_ORDER]
    sizes = [int(axis_sizes[a]) for a in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError("cannot infer axis: %d devices not divisible "
                             "by %d" % (n, known))
        sizes[sizes.index(-1)] = n // known
        known = n
    if known != n:
        raise ValueError("mesh axes %s multiply to %d but %d devices "
                         "present" % (dict(zip(names, sizes)), known, n))
    _check_axes(names, sizes, world)
    return Mesh(contexts, names, sizes, num_processes=world)


def auto_mesh(n_devices=None, tp=1, sp=1, pp=1, ep=1, devices=None):
    """Data-parallel-first mesh: every device not claimed by tp/sp/pp/ep
    goes to dp (the reference's default: pure data parallelism over all
    contexts).  ``devices`` (a list of contexts) defaults to the current
    context's kind: every CUDA device, or ``cpu(0)`` inside a ``with
    cpu():`` scope."""
    if devices is None:
        devices = _default_devices()
    if n_devices is None:
        n_devices = len(devices)
    denom = tp * sp * pp * ep
    if n_devices % denom:
        raise ValueError("%d devices not divisible by tp*sp*pp*ep=%d"
                         % (n_devices, denom))
    kwargs = {"dp": n_devices // denom}
    for name, size in (("pp", pp), ("ep", ep), ("sp", sp), ("tp", tp)):
        if size > 1:
            kwargs[name] = size
    return make_mesh(list(devices)[:n_devices], **kwargs)


class LogicalMesh(object):
    """A device-less mesh: named axes and sizes only, for planning and
    the static checks (``make_mesh`` wants real devices)."""

    devices = None

    def __init__(self, **axis_sizes):
        names = [a for a in AXIS_ORDER if a in axis_sizes]
        names += [a for a in axis_sizes if a not in AXIS_ORDER]
        for a in names:
            if int(axis_sizes[a]) < 1:
                raise ValueError("axis %r must have size >= 1, got %r"
                                 % (a, axis_sizes[a]))
        self.axis_names = tuple(names)
        self.shape = OrderedDict((a, int(axis_sizes[a])) for a in names)

    @property
    def size(self):
        return int(math.prod(self.shape.values())) if self.shape else 1

    def __repr__(self):
        return "LogicalMesh(%s)" % ", ".join(
            "%s=%d" % kv for kv in self.shape.items())


def remesh(mesh, devices=None, total=None):
    """``mesh``'s named layout over a new device population: the model
    axes keep their sizes and dp absorbs the change.  A :class:`Mesh`
    gives a Mesh over ``devices`` (default: its own contexts); a
    :class:`LogicalMesh` a LogicalMesh for ``total`` devices.  Raises
    ``ValueError`` when the other axes do not divide the new count, or
    when there is no dp axis to absorb a changed one."""
    sizes = OrderedDict(mesh.shape)
    fixed = math.prod(int(s) for a, s in sizes.items() if a != "dp")
    if isinstance(mesh, LogicalMesh):
        if total is None:
            raise ValueError("remesh(LogicalMesh) needs total=<devices>")
        n = int(total)
    else:
        if devices is None:
            devices = mesh.contexts
        n = len(devices) * _world()
    if n % fixed:
        raise ValueError("cannot re-mesh %s onto %d devices: non-dp axes "
                         "need multiples of %d" % (dict(sizes), n, fixed))
    if "dp" not in sizes and n != fixed:
        raise ValueError("cannot re-mesh %s onto %d devices: no dp axis "
                         "to absorb the change" % (dict(sizes), n))
    new_sizes = OrderedDict(sizes)
    if "dp" in sizes:
        new_sizes["dp"] = n // fixed
    if isinstance(mesh, LogicalMesh):
        return LogicalMesh(**new_sizes)
    return make_mesh(devices, **new_sizes)
