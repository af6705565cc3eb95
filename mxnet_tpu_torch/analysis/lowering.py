"""Lowering lint passes (rule family MXL-L).

The port of ``mxnet_tpu/analysis/lowering.py``.  The JAX package stages
the graph as one traced XLA computation; the port walks it eagerly in
PyTorch, but the same three hazards remain: an op with no
implementation for the target, and the host bridge (``operator.py``'s
``Custom``/``_Native`` nodes, which copy their inputs to numpy and back)
where the executor recomputes or cannot overlap.  These passes read the
op registry's metadata (``OperatorProperty.host_callback`` /
``unsupported_platforms``), the executor's own mirror-segment partition,
and the parallel layer's sharding rules:

- MXL-L001  op with no PyTorch implementation for the target platform
            (abstract ``forward`` or an explicit ``unsupported_platforms``
            entry) — error;
- MXL-L002  host-bridge op inside a mirrored segment: the segment is
            recomputed in the backward, so the host op runs twice (side
            effects double) and the recompute stalls on two host round
            trips — error;
- MXL-L003  host-bridge op anywhere in the graph: every call stalls the
            stream on a device->host->device copy (the reference's
            Custom ops broke bulk segments the same way,
            graph_executor.cc:860-875) — info;
- MXL-L004  sharding rule produces a PartitionSpec referencing mesh axes
            the bound mesh doesn't have (error) or partitioning a
            non-divisible dimension (warning), against the port's
            ``parallel.Mesh`` or ``parallel.LogicalMesh``.
"""
from __future__ import annotations

from .core import register_rule


def _op_kind(node):
    return type(node.op).op_name or type(node.op).__name__


@register_rule("MXL-L001", "error",
               "op has no PyTorch implementation for the target")
def no_lowering(ctx):
    """Ops that cannot run on the target platform at all."""
    from ..ops.registry import OperatorProperty
    for node in ctx.op_nodes():
        cls = type(node.op)
        if cls.forward is OperatorProperty.forward:
            ctx.report(node, "op %s has no PyTorch implementation "
                       "(abstract forward): the walk will raise "
                       "NotImplementedError" % _op_kind(node))
        elif ctx.target in getattr(node.op, "unsupported_platforms", ()):
            ctx.report(node, "op %s declares no implementation for "
                       "platform %r" % (_op_kind(node), ctx.target))


def _mirrored_nodes(ctx):
    """Nodes the executor would place inside recomputed segments, via
    the executor's OWN partitioner (no second mirror-rule copy to
    drift)."""
    from ..executor import _mirror_segments
    out = []
    for is_mirror, nodes in _mirror_segments(ctx.op_nodes()):
        if is_mirror:
            out.extend(nodes)
    return out


@register_rule("MXL-L002", "error",
               "host callback inside a mirrored segment")
def callback_in_mirror(ctx):
    """A host op in a recomputed segment runs again in the backward:
    side effects double, and every recompute stalls on a host round
    trip."""
    for node in _mirrored_nodes(ctx):
        if getattr(node.op, "host_callback", False):
            ctx.report(node, "op %s runs on the host but is inside a "
                       "mirrored (recomputed) segment: it runs again in "
                       "the backward — drop force_mirroring/"
                       "MXNET_BACKWARD_DO_MIRROR for this node"
                       % _op_kind(node))


@register_rule("MXL-L003", "info", "host-callback op breaks fusion")
def host_callback_present(ctx):
    """Host ops stall the stream on device->host->device copies every
    step."""
    for node in ctx.op_nodes():
        if getattr(node.op, "host_callback", False):
            ctx.report(node, "op %s executes through the host bridge: each "
                       "call copies its inputs to the host and its "
                       "outputs back" % _op_kind(node))


@register_rule("MXL-L004", "error",
               "sharding spec references axes missing from the mesh")
def sharding_axes(ctx):
    """Explicit ShardingRules evaluated against the bound mesh."""
    if ctx.mesh is None or ctx.sharding_rules is None:
        return
    try:
        arg_shapes, _outs, _aux = \
            ctx.symbol.infer_shape_partial(**ctx.shapes)
    except Exception:   # noqa: BLE001 — shape issues are MXL-S002's job
        return
    named = {n: s for n, s in zip(ctx.symbol.list_arguments(), arg_shapes)
             if s is not None}
    for name, spec, problem, fatal in ctx.sharding_rules.validate(
            ctx.mesh, named):
        ctx.report(name, "sharding rule for %r yields %s: %s"
                   % (name, spec, problem),
                   severity="error" if fatal else "warning")
