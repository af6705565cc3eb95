"""Sharding rules, and arrays placed on a mesh.

The framework-free policy of ``mxnet_tpu/parallel/sharding.py``, copied
(the JAX module imports ``jax.sharding``): :func:`parse_sharding`,
:func:`param_pspec`, :func:`batch_pspec`, :func:`named_pspecs` and
:class:`ShardingRules`, over the port's own :class:`PartitionSpec`.

:class:`ShardedArray` is the port's counterpart of a ``jax.Array`` placed
with a ``NamedSharding``: one tensor for each replica of a
:class:`~.mesh.Mesh` (its shard; a whole copy where the spec is
replicated) and the spec.  It answers what the JAX package's tests ask of
a ``jax.Array``: ``sharding.spec``, ``sharding.is_fully_replicated``,
``addressable_shards[i].data`` and the global ``shape``;
``numpy.asarray`` assembles the global value.  A dimension sharded over
a mesh axis (``dp`` for a batch, ``ep`` for an expert stack, ``pp`` for
a pipeline's layer stack) is split evenly along it: member ``i`` holds
part ``mesh.coords(i)[axis]``.
"""
from __future__ import annotations

import re

import numpy as _np
import torch

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardedArray",
           "ShardingRules", "param_pspec", "batch_pspec", "named_pspecs",
           "parse_sharding", "place"]


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None: not sharded), as
    ``jax.sharding.PartitionSpec``; compares equal to another spec with
    the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class NamedSharding:
    """A mesh and a spec (the answer to ``array.sharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def is_fully_replicated(self):
        return all(e is None or self.mesh.shape.get(e, 1) == 1
                   for e in self.spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class _Shard:
    __slots__ = ("device", "index", "data")

    def __init__(self, device, index, data):
        self.device = device
        self.index = index
        self.data = data


def _split_dims(spec, mesh):
    """``[(dim, axis)]``: the dimensions sharded over a mesh axis of size
    above 1 (a batch over dp and sp has two)."""
    return [(dim, e) for dim, e in enumerate(spec)
            if isinstance(e, str) and mesh.shape.get(e, 1) > 1]


def _local_parts(mesh, axis):
    """How many parts of an axis one process holds: dp's replicas are
    split over the processes of a group, the other axes are local."""
    return mesh.shape[axis] // (mesh.num_processes if axis == "dp" else 1)


class ShardedArray:
    """One tensor per local member of ``mesh`` and its spec.

    ``shards[r]`` lives on ``mesh.devices[r]``; where ``spec`` shards a
    dimension over an axis it holds member r's part of that dimension
    (its index along the axis; over dp, replica r of process p is part
    ``p * local + r``), else the whole array.

    ``seq``: a value of a sequence-parallel walk (``(pre, post)``,
    ``parallel/sequence_parallel.py``): flattened, each dp part of it is
    ``(pre, S, post)`` and member r holds the ``(pre, S/sp, post)``
    block of its sp index.  Its global value interleaves the blocks (an
    LM head ``(B*S, V)`` comes out in ``(B, S)`` row order, as the JAX
    package's), rather than concatenating them on one dimension."""

    def __init__(self, shards, mesh, spec, shape, seq=None):
        self.shards = list(shards)
        self.sharding = NamedSharding(mesh, spec)
        self.shape = tuple(int(d) for d in shape)
        self.seq = seq

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def addressable_shards(self):
        mesh = self.sharding.mesh
        return [_Shard(mesh.devices[r], r, t)
                for r, t in enumerate(self.shards)]

    def global_tensor(self, device=None):
        """The global value on ``device`` (default: the first replica's):
        the local shards concatenated along every split dimension (one
        process's part only, in a process group of several)."""
        device = device or self.shards[0].device
        mesh = self.sharding.mesh
        if self.seq is not None:
            return self._interleaved(device)
        split = _split_dims(self.sharding.spec, mesh)

        def assemble(rest, fixed):
            if not rest:
                idx = mesh.members(**fixed)[0]
                return self.shards[idx].to(device)
            (dim, axis), tail = rest[0], rest[1:]
            return torch.cat([assemble(tail, dict(fixed, **{axis: c}))
                              for c in range(_local_parts(mesh, axis))],
                             dim=dim)
        return assemble(split, {})

    def _interleaved(self, device):
        mesh = self.sharding.mesh
        pre, post = self.seq
        n_dp = _local_parts(mesh, "dp") if "dp" in mesh.shape else 1
        parts = []
        for i in range(n_dp):
            ring = mesh.members(dp=i)
            parts.append(torch.cat(
                [self.shards[r].to(device).reshape(pre, -1, post)
                 for r in ring], dim=1))
        whole = torch.cat(parts, dim=0)
        return whole.reshape(-1, *self.shape[1:]) if self.shape else whole

    def asnumpy(self):
        return self.global_tensor().detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.asnumpy()
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return "ShardedArray(shape=%s, dtype=%s, %r)" % (
            self.shape, self.dtype, self.sharding.spec)


def place(value, mesh, spec, part_of_process=False):
    """A tensor, numpy array or NDArray placed on ``mesh`` with ``spec``:
    split along every dimension the spec shards (over dp, over sp, ...),
    copied to every replica otherwise.  ``part_of_process``: ``value`` is
    this process's part of the global array (its dp rows), as a process
    of a group passes it."""
    from .. import ndarray as nd
    if isinstance(value, nd.NDArray):
        value = value.data
    elif not isinstance(value, torch.Tensor):
        arr = _np.asarray(value)
        if arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        arr = _np.ascontiguousarray(arr)
        value = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    split = _split_dims(spec, mesh)
    shape = list(value.shape)
    if not split:
        shards = [value.to(d) for d in mesh.devices]
        if len(set(s.data_ptr() for s in shards)) < len(shards):
            shards = [shards[0]] + [s.clone() for s in shards[1:]]
        return ShardedArray(shards, mesh, spec, shape)
    parts = {}
    for dim, axis in split:
        if axis == "dp" and mesh.num_processes > 1:
            if not part_of_process:
                import torch.distributed as dist
                rows = value.shape[dim] // mesh.num_processes
                value = value.narrow(dim, dist.get_rank() * rows, rows)
            shape[dim] = value.shape[dim] * mesh.num_processes
        n = _local_parts(mesh, axis)
        if value.shape[dim] % n:
            raise ValueError("place: dimension %d of %s does not divide "
                             "over %d %s members" % (dim, tuple(value.shape),
                                                     n, axis))
        parts[axis] = (dim, value.shape[dim] // n)
    shards = []
    for i, d in enumerate(mesh.devices):
        t, coords = value, mesh.coords(i)
        for axis, (dim, size) in parts.items():
            t = t.narrow(dim, coords[axis] * size, size)
        shards.append(t.to(d).contiguous())
    return ShardedArray(shards, mesh, spec, shape)


# ----------------------------------------------------------------------
# the policy (copied from mxnet_tpu/parallel/sharding.py)
# ----------------------------------------------------------------------
#: the compact sharding-rule grammar shared by the autotuner and the
#: CLIs: ``dpN`` / ``fsdpN`` / ``tpN`` / ``ppN`` / ``epN`` concatenated
#: in that order ("dp2tp2", "dp2pp4", "fsdp8ep4", ...)
_SHARDING_RE = re.compile(
    r"^(?:(fsdp|dp)(\d+))?(?:tp(\d+))?(?:pp(\d+))?(?:ep(\d+))?$")


def parse_sharding(rule):
    """``"dp1" | "fsdp8" | "dp2tp2" | "dp2pp4" | "ep4" | "dp2pp2ep2"``
    -> ``{"dp": n, "tp": m, "pp": k, "ep": e, "fsdp": bool}``."""
    m = _SHARDING_RE.match(str(rule or "dp1").strip())
    if not m or not any(m.group(i) for i in (1, 3, 4, 5)):
        raise ValueError("bad sharding rule %r (want dpN / fsdpN / tpN "
                         "/ ppN / epN concatenated, e.g. dp2pp4)"
                         % (rule,))
    kind, dp, tp, pp, ep = (m.group(i) for i in range(1, 6))
    return {"dp": int(dp) if dp else 1,
            "tp": int(tp) if tp else 1,
            "pp": int(pp) if pp else 1,
            "ep": int(ep) if ep else 1,
            "fsdp": kind == "fsdp"}


def _divisible(dim, mesh, axis):
    return axis in mesh.shape and dim % mesh.shape[axis] == 0 and \
        mesh.shape[axis] > 1


# normalization parameters (and their moving stats) are elementwise
# against an unsharded feature dim: the default policy keeps them
# replicated
_NORM_PARAM_SUFFIXES = ("_gamma", "_beta", "_moving_mean", "_moving_var")


def param_pspec(name, shape, mesh, rules=None, notes=None):
    """PartitionSpec for one parameter: an explicit rule first, then
    MoE expert stacks over ``ep``, normalization parameters replicated,
    and the widest dimension divisible by ``tp`` (axis 0, else axis 1);
    replicated otherwise.  ``notes`` (a list) collects the message for a
    parameter the tp policy wanted to shard but could not."""
    if rules is not None:
        spec = rules.match(name, shape)
        if spec is not None:
            return spec
    if "ep" in mesh.shape and mesh.shape["ep"] > 1 and shape \
            and "expert" in name and shape[0] % mesh.shape["ep"] == 0:
        return P("ep", *([None] * (len(shape) - 1)))
    if name.endswith(_NORM_PARAM_SUFFIXES):
        return P(*([None] * len(shape)))
    if "tp" in mesh.shape and mesh.shape["tp"] > 1 and shape:
        if _divisible(shape[0], mesh, "tp") and len(shape) >= 2:
            return P("tp", *([None] * (len(shape) - 1)))
        if len(shape) >= 2 and _divisible(shape[1], mesh, "tp"):
            return P(None, "tp", *([None] * (len(shape) - 2)))
        if len(shape) == 1 and _divisible(shape[0], mesh, "tp"):
            return P("tp")
        if notes is not None and any(d > 1 for d in shape):
            notes.append(
                "shape %s has no dim divisible by mesh axis 'tp' (size %d): "
                "replicated on every tp device instead of sharded"
                % (tuple(shape), mesh.shape["tp"]))
    return P(*([None] * len(shape)))


def batch_pspec(shape, mesh, seq_axis=None):
    """PartitionSpec for a batch tensor: axis 0 over dp, the sequence
    axis over sp."""
    spec = [None] * len(shape)
    if "dp" in mesh.shape and mesh.shape["dp"] > 1:
        spec[0] = "dp"
    if seq_axis is not None and "sp" in mesh.shape and mesh.shape["sp"] > 1 \
            and len(shape) > seq_axis:
        spec[seq_axis] = "sp"
    return P(*spec)


def named_pspecs(named_shapes, mesh, rules=None, data_names=("data",),
                 label_names=("softmax_label",), seq_axis=None, notes=None):
    """Per-name PartitionSpec map for a whole argument set: names in
    ``data_names``/``label_names`` get :func:`batch_pspec`, the rest
    :func:`param_pspec`.  ``notes`` (a list) collects ``(name,
    message)`` degradation records."""
    out = {}
    batchy = set(data_names or ()) | set(label_names or ())
    for name, shape in named_shapes.items():
        if shape is None:
            out[name] = None
        elif name in batchy:
            out[name] = batch_pspec(
                shape, mesh,
                seq_axis if name in (data_names or ()) else None)
        else:
            local = [] if notes is not None else None
            out[name] = param_pspec(name, shape, mesh, rules, notes=local)
            if local:
                notes.extend((name, msg) for msg in local)
    return out


class ShardingRules(object):
    """Ordered (regex, fn(shape, mesh) -> PartitionSpec|None) rule list."""

    def __init__(self, rules=(), mesh=None):
        self._rules = [(re.compile(pat), fn) for pat, fn in rules]
        self._mesh = mesh

    def add(self, pattern, fn):
        self._rules.append((re.compile(pattern), fn))
        return self

    def match(self, name, shape):
        for prog, fn in self._rules:
            if prog.match(name):
                return fn(shape, self._mesh)
        return None

    def pspec(self, name, shape, mesh=None, notes=None):
        """An explicit rule's spec, else the default parameter policy for
        ``mesh`` (or the rule set's own); fully replicated with no mesh."""
        spec = self.match(name, shape)
        if spec is not None:
            return spec
        mesh = mesh if mesh is not None else self._mesh
        if mesh is None:
            return P(*([None] * len(shape or ())))
        return param_pspec(name, shape, mesh, rules=None, notes=notes)

    def validate(self, mesh, named_shapes):
        """``(name, spec, problem, fatal)`` for each defect of a rule
        against ``mesh``: an axis the mesh lacks (fatal), a dimension
        the axis size does not divide, a spec longer than the rank
        (fatal)."""
        out = []
        for name, shape in sorted(named_shapes.items()):
            spec = self.match(name, shape)
            if spec is None:
                continue
            entries = list(spec)
            for dim, entry in enumerate(entries):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                for axis in axes:
                    if axis not in mesh.shape:
                        out.append((name, spec,
                                    "axis %r is not in mesh axes %s"
                                    % (axis, sorted(mesh.shape)), True))
                    elif dim < len(shape) and mesh.shape[axis] > 0 and \
                            shape[dim] % mesh.shape[axis] != 0:
                        out.append((name, spec,
                                    "dim %d of shape %s is not divisible "
                                    "by mesh axis %r (size %d)"
                                    % (dim, tuple(shape), axis,
                                       mesh.shape[axis]), False))
            if len(entries) > len(shape):
                out.append((name, spec,
                            "spec has %d entries but the parameter is "
                            "rank %d" % (len(entries), len(shape)), True))
        return out
