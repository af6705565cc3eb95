"""Bind-contract passes (rule family MXL-B).

The port of ``mxnet_tpu/analysis/bind.py``, rule for rule.  The port's
``bind`` takes no ``group2ctx`` yet (ROADMAP.md queue 1 item 3 (j)), so
MXL-B005 fires only for a map passed to :func:`analyze` directly, as the
JAX package reports it.

Statically mirror ``Executor.__init__``'s argument/gradient handling and
reject the inputs it would mishandle *silently*:

- MXL-B001  ``grad_req="write"`` on a grad buffer shared by several
            arguments — each backward overwrites the previous argument's
            gradient; shared buffers need ``"add"`` — error;
- MXL-B002  args_grad provided for some-but-not-all non-null grad_req
            arguments — the executor silently downgrades the missing
            ones to ``"null"`` and they simply never train — warning;
- MXL-B003  auxiliary-state name collisions (aux_dict zip drops all but
            one) — error;
- MXL-B004  grad_req value outside null/write/add — error;
- MXL-B005  ``ctx_group`` attr referencing a group absent from a
            non-empty ``group2ctx`` map (the node lands on the default
            device without a word) — warning.

These run only when bind context is present on the AnalysisContext; a
pure ``Symbol.validate()`` with no bind arguments skips them.
"""
from __future__ import annotations

from .core import register_rule

_VALID_REQ = ("null", "write", "add")


def _req_map(ctx, arg_names):
    """Normalize grad_req exactly as Executor.__init__ does; None when no
    grad_req was supplied."""
    gr = ctx.grad_req
    if gr is None:
        return None
    if isinstance(gr, str):
        return {n: gr for n in arg_names}
    if isinstance(gr, (list, tuple)):
        return dict(zip(arg_names, gr))
    return {n: gr.get(n, "null") for n in arg_names}


def _grad_buffers(ctx, arg_names):
    """name -> grad buffer (or None), aligned like _as_list."""
    ag = ctx.args_grad
    if ag is None:
        return None
    if isinstance(ag, dict):
        return {n: ag.get(n) for n in arg_names}
    ag = list(ag)
    return dict(zip(arg_names, ag + [None] * (len(arg_names) - len(ag))))


def _storage_key(buf):
    """Identity key detecting aliased buffers: the NDArray object or its
    underlying storage when exposed."""
    data = getattr(buf, "_storage", None)
    return id(data) if data is not None else id(buf)


@register_rule("MXL-B001", "error",
               "grad_req=write on a shared grad buffer")
def aliased_grad_write(ctx):
    """Two write-req arguments writing one buffer: last writer wins."""
    arg_names = ctx.symbol.list_arguments()
    reqs = _req_map(ctx, arg_names)
    bufs = _grad_buffers(ctx, arg_names)
    if not bufs:
        return
    by_buf = {}
    for n in arg_names:
        buf = bufs.get(n)
        if buf is None:
            continue
        req = (reqs or {}).get(n, "write")
        if req == "write":
            by_buf.setdefault(_storage_key(buf), []).append(n)
    for names in by_buf.values():
        if len(names) > 1:
            for n in names:
                ctx.report(n, "grad_req='write' but args_grad[%r] is "
                           "shared with %s — each backward overwrites "
                           "the others' gradient; use grad_req='add' "
                           "for shared buffers"
                           % (n, [m for m in names if m != n]))


@register_rule("MXL-B002", "warning",
               "partially-provided args_grad silently downgraded")
def missing_grad_entries(ctx):
    """Some non-null-req args have grad buffers, others don't: the
    executor downgrades the missing ones to null and they never train."""
    arg_names = ctx.symbol.list_arguments()
    reqs = _req_map(ctx, arg_names)
    bufs = _grad_buffers(ctx, arg_names)
    if not bufs or not any(b is not None for b in bufs.values()):
        return      # forward-only bind: intentional
    for n in arg_names:
        req = (reqs or {}).get(n, "write")
        if req != "null" and bufs.get(n) is None:
            ctx.report(n, "grad_req=%r for %r but args_grad has no "
                       "buffer for it: bind silently downgrades it to "
                       "'null' and the parameter never updates" % (req, n))


@register_rule("MXL-B003", "error", "auxiliary state name collision")
def aux_collision(ctx):
    """Duplicate aux names: aux_dict keeps only the last one."""
    seen = {}
    for node in ctx.op_nodes():
        for aux in node.op.list_auxiliary_states():
            full = "%s_%s" % (node.name, aux)
            if full in seen:
                ctx.report(node, "auxiliary state %r collides with the "
                           "one from node %r: aux_dict keeps only one "
                           "buffer" % (full, seen[full]))
            else:
                seen[full] = node.name


@register_rule("MXL-B004", "error", "invalid grad_req value")
def bad_grad_req(ctx):
    """grad_req outside null/write/add (bind raises, but late)."""
    arg_names = ctx.symbol.list_arguments()
    reqs = _req_map(ctx, arg_names)
    if reqs is None:
        return
    for n in arg_names:
        req = reqs.get(n, "null")
        if req not in _VALID_REQ:
            ctx.report(n, "grad_req %r for %r is not one of %s"
                       % (req, n, list(_VALID_REQ)))


@register_rule("MXL-B005", "warning",
               "ctx_group not present in group2ctx")
def unmapped_ctx_group(ctx):
    """A node pinned to a device group the bind call doesn't map: it
    silently lands on the default device."""
    if not ctx.group2ctx:   # no grouping requested: attrs are inert
        return
    for node in ctx.topo:
        group = node.attrs.get("ctx_group")
        if group and group not in ctx.group2ctx:
            ctx.report(node, "ctx_group %r on node %r is not in "
                       "group2ctx %s: the node falls back to the "
                       "default device"
                       % (group, node.name, sorted(ctx.group2ctx)))
