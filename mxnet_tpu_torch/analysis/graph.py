"""Dead/unused-subgraph passes (rule family MXL-G).

The port of ``mxnet_tpu/analysis/graph.py``, rule for rule.

An in-memory Symbol only ever holds nodes reachable from its heads, so
true dead nodes can only survive in a *saved* graph (the JSON nodes list
keeps everything the writer serialized) — the CLI lints those through
``ctx.json_graph``.  At bind time the silent-footgun variant is user
inputs the executor quietly ignores: ``_as_list`` drops dict keys that
aren't graph arguments without a word.

- MXL-G001  node in a saved graph unreachable from every head — warning;
- MXL-G002  declared-but-never-consumed arguments: saved-graph arg_nodes
            feeding nothing, and bind-time args/args_grad/aux dict keys
            the graph doesn't declare — warning;
- MXL-G003  output is a bare alias of an input variable (reads back the
            fed value; usually a head wired to the wrong symbol) —
            warning;
- MXL-G004  duplicate node names (arg_dict/aux_dict/JSON round-trips all
            key on names and silently collapse duplicates) — error.
"""
from __future__ import annotations

from .core import register_rule


def _json_reachable(graph):
    """Set of node indices reachable from the saved graph's heads."""
    nodes = graph.get("nodes", [])
    stack = [h[0] for h in graph.get("heads", [])]
    seen = set()
    while stack:
        i = stack.pop()
        if i in seen or not 0 <= i < len(nodes):
            continue
        seen.add(i)
        stack.extend(inp[0] for inp in nodes[i].get("inputs", []))
    return seen


@register_rule("MXL-G001", "warning", "node unreachable from any head")
def dead_node(ctx):
    """Saved-graph nodes no head depends on: dead weight that still
    costs load time and confuses checkpoint surgery."""
    if not ctx.json_graph:
        return
    nodes = ctx.json_graph.get("nodes", [])
    reachable = _json_reachable(ctx.json_graph)
    for i, spec in enumerate(nodes):
        # variables ("null" op) are MXL-G002's finding, not dead compute
        if i not in reachable and spec.get("op") not in ("null", "None"):
            ctx.report(spec.get("name"),
                       "node %r (op %s) is unreachable from every head"
                       % (spec.get("name"), spec.get("op")))


@register_rule("MXL-G002", "warning", "declared input never consumed")
def unused_inputs(ctx):
    """Arguments that exist but feed nothing."""
    # saved graph: arg_nodes consumed by no reachable node and not heads
    if ctx.json_graph:
        nodes = ctx.json_graph.get("nodes", [])
        reachable = _json_reachable(ctx.json_graph)
        consumed = set()
        for i in reachable:
            for inp in nodes[i].get("inputs", []):
                consumed.add(inp[0])
        head_idx = {h[0] for h in ctx.json_graph.get("heads", [])}
        for i in ctx.json_graph.get("arg_nodes", []):
            if i not in consumed and i not in head_idx \
                    and 0 <= i < len(nodes):
                ctx.report(nodes[i].get("name"),
                           "argument %r is declared but never consumed"
                           % nodes[i].get("name"))
    # bind time: dict entries the executor would silently drop
    declared = set(ctx.symbol.list_arguments()) if ctx.symbol else set()
    aux = set(ctx.symbol.list_auxiliary_states()) if ctx.symbol else set()
    for what, obj, names in (("args", ctx.args, declared),
                             ("args_grad", ctx.args_grad, declared),
                             ("aux_states", ctx.aux_states, aux)):
        if isinstance(obj, dict):
            for key in sorted(set(obj) - names):
                ctx.report(None, "%s entry %r matches no graph %s and "
                           "is silently ignored by bind"
                           % (what, key,
                              "auxiliary state" if what == "aux_states"
                              else "argument"))


@register_rule("MXL-G003", "warning", "output aliases an input variable")
def output_alias(ctx):
    """Heads wired straight to a variable: forward just reads back what
    was fed in (and its gradient is the head grad verbatim)."""
    seen = set()
    for pos, (node, idx) in enumerate(ctx.symbol._heads):
        if node.is_variable:
            ctx.report(node, "output %d is a bare alias of input "
                       "variable %r" % (pos, node.name))
        if (id(node), idx) in seen:
            ctx.report(node, "output %d duplicates an earlier head of "
                       "%r: both outputs alias one value" % (pos, node.name))
        seen.add((id(node), idx))


@register_rule("MXL-G004", "error", "duplicate node names")
def duplicate_names(ctx):
    """Two distinct nodes sharing a name: arg/aux dicts and the JSON
    nodes list key on names and will silently collapse them."""
    by_name = {}
    for n in ctx.topo:
        by_name.setdefault(n.name, []).append(n)
    for name, nodes in by_name.items():
        if len(nodes) > 1:
            kinds = ["variable" if n.is_variable else n.op.op_name
                     for n in nodes]
            ctx.report(nodes[0], "%d nodes share the name %r (%s): "
                       "name-keyed binding/serialization collapses them"
                       % (len(nodes), name, ", ".join(kinds)))
