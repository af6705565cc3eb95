"""Collective-placement audit (rule family MXL-C).

The port of ``mxnet_tpu/analysis/collectives.py``, rule for rule (the
messages keep the JAX package's words, so a saved graph lints the same
in both packages).  The reference split gradient reduction between two
machines: device-side trees (comm.h) for ``device``/``local`` kvstores
and ps-lite RPC for ``dist_*``.  Under a mesh every reduction is a
collective over mesh axes, so the *scope* of each collective is
statically visible — and three classic deployment mistakes become
lintable:

- MXL-C001  kvstore scope vs mesh scope: an unknown kvstore type
            (error), a device-scope kvstore under a mesh larger than one
            process can hold (error — its reduction would silently
            cover only local devices), or ``dist_async`` (warning — jax
            collectives are synchronous; it runs with dist_sync
            semantics, the documented divergence);
- MXL-C002  a collective crossing a pipeline-stage boundary: a
            reduce/gather lands on a node whose inputs live in a
            different ``ctx_group`` stage — the transfer serializes the
            pipeline (only audited when the graph actually uses >= 2
            groups);
- MXL-C003  a tp-sharded matmul without its matching reduction: the
            propagation pass marked a one-sided sharded contraction
            (``matmul_gather``) or a head-parallel attention whose out
            projection doesn't close the psum (``attn_unreduced``) —
            XLA falls back to all-gathering activations, usually 2x the
            ICI traffic of the intended row-parallel psum.
"""
from __future__ import annotations

from .core import register_rule
from .propagation import propagate

_SCOPED_KINDS = ("reduce", "gather", "reshard")


def _local_device_count(mesh):
    """Devices one process holds: a bound ``parallel.Mesh`` knows its
    replicas and process count; for the device-less ``LogicalMesh`` it
    is this process's CUDA device count, and 1 on a machine without
    CUDA (the CPU is one device: ``parallel.mesh`` puts its replicas
    on it side by side)."""
    from ..parallel.mesh import Mesh, local_device_count
    if isinstance(mesh, Mesh):
        return max(1, mesh.size // max(1, int(mesh.num_processes)))
    return local_device_count() or 1


@register_rule("MXL-C001", "error",
               "kvstore scope does not match the mesh scope")
def kvstore_scope(ctx):
    """Gradient-reduction scope vs where the gradients actually live."""
    kv = ctx.kvstore
    if kv is None:
        return
    from ..kvstore import _VALID_TYPES
    base = str(kv).lower()
    if base not in _VALID_TYPES:
        ctx.report(None, "unknown kvstore type %r (valid: %s)"
                   % (kv, ", ".join(_VALID_TYPES)))
        return
    if ctx.mesh is not None and not base.startswith("dist"):
        local = _local_device_count(ctx.mesh)
        mesh_size = getattr(ctx.mesh, "size", None)
        if local and mesh_size and mesh_size > local:
            ctx.report(None,
                       "kvstore %r reduces across this process's devices "
                       "only, but the mesh spans %d devices (> %d local): "
                       "gradients would silently cover one process — use a "
                       "dist_sync kvstore" % (kv, mesh_size, local))
    if base.startswith("dist_async"):
        ctx.report(None, "kvstore %r: jax collectives are synchronous, so "
                   "async runs with dist_sync semantics (documented "
                   "divergence) — updates are NOT applied eagerly per "
                   "worker" % kv, severity="warning")


@register_rule("MXL-C002", "error",
               "collective crosses a pipeline-stage boundary")
def collective_across_stage(ctx):
    """A psum/all-gather whose operand lives in another ctx_group stage
    serializes the pipeline: the collective cannot start until the
    upstream stage finishes its transfer."""
    if ctx.mesh is None:
        return
    groups = {n.attrs.get("ctx_group") for n in ctx.op_nodes()
              if n.attrs.get("ctx_group")}
    if len(groups) < 2:
        return
    for ev in propagate(ctx)["events"]:
        if ev["kind"] not in _SCOPED_KINDS:
            continue
        node = ev["node"]
        here = node.attrs.get("ctx_group")
        for c, _ci in node.inputs:
            there = c.attrs.get("ctx_group")
            if there and there != here:
                ctx.report(node,
                           "%s over %s at %r sits on stage %r but consumes "
                           "%r from stage %r: the collective crosses a "
                           "pipeline boundary and serializes both stages — "
                           "keep reductions inside one stage" % (
                               ev["kind"], "+".join(ev["axes"]), node.name,
                               here or "<default>", c.name, there))
                break


@register_rule("MXL-C003", "warning",
               "tp-sharded matmul without its matching reduction")
def unmatched_reduction(ctx):
    """One-sided sharded contractions: the layout implies a psum the
    graph never sets up, so XLA gathers activations instead."""
    if ctx.mesh is None:
        return
    for ev in propagate(ctx)["events"]:
        if ev["kind"] in ("matmul_gather", "attn_unreduced"):
            ctx.report(ev["node"], ev["message"])
