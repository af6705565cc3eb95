"""Static analysis over Symbol graphs: lint passes + bind-time validation.

The port of ``mxnet_tpu/analysis/`` but ``autotune``: its graph half,
everything :func:`analyze` runs over a Symbol, and its source half, the
lints over Python files.  Entry points:

- :func:`analyze` — run the registered passes over an in-memory Symbol
  (with optional shape/type hints and bind/mesh context) and return
  :class:`GraphIssue` findings;
- :func:`analyze_json` — same over a *saved* symbol JSON, which
  additionally exposes dead nodes/unused arg_nodes the in-memory graph
  cannot represent;
- ``Symbol.validate()`` (symbol.py) and the ``validate=`` knob on
  ``Executor``/``bind``/``simple_bind`` (executor.py) wrap these;
- :func:`analyze_source_paths`, :func:`analyze_concurrency_paths` and
  :func:`analyze_retrace_paths` — the source families over ``.py`` files
  and directories (finding dicts with ``file:qualname`` anchors);
- ``python -m mxnet_tpu_torch.tools.mxlint`` is the standalone CLI for
  saved graphs, the bundled model zoo and Python sources.

Rule catalog (``--list-rules``).  The families S, T, G, B, L, P, M, C,
D and E keep the JAX package's ids, severities, node names and report
dicts, so a saved graph lints the same in both packages (E prices its
stages and transfers at the card's rates, as R does); so do the source
families D004-D006, Q and X, whose findings over the same file are the
same unless it uses a torch name the port's vocabulary adds.  K and R
are about the hardware: the JAX package checks Mosaic's tile rules and
prices a TPU; the port checks Hopper launches and prices the H100.

========  ========  ==================================================
rule      severity  finding
========  ========  ==================================================
MXL-S001  warning   shapes unknown after propagation
MXL-S002  error     contradictory shapes on one edge
MXL-T001  warning   implicit float-width promotion at an op input
MXL-T002  error     type propagation failure
MXL-G001  warning   node unreachable from any head (saved graphs)
MXL-G002  warning   declared input never consumed / ignored bind entry
MXL-G003  warning   output aliases an input variable
MXL-G004  error     duplicate node names
MXL-B001  error     grad_req=write on a shared grad buffer
MXL-B002  warning   partial args_grad silently downgraded to null
MXL-B003  error     auxiliary-state name collision
MXL-B004  error     invalid grad_req value
MXL-B005  warning   ctx_group absent from group2ctx
MXL-L001  error     op has no PyTorch implementation for the target
MXL-L002  error     host-bridge op inside a mirrored segment
MXL-L003  info      host-bridge op (host round trip every call)
MXL-L004  error     sharding spec references axes missing from mesh
MXL-P001  error     sharding conflict forces an implicit reshard
MXL-P002  warning   sharded value consumed replicated (all-gather)
MXL-P003  info      parameter degraded to replicated (not divisible)
MXL-P004  info      sharded contraction: the matching psum
MXL-M001  error     estimated peak device memory exceeds the budget
MXL-M002  warning   replicated parameter dominates the memory budget
MXL-C001  error     kvstore scope does not match the mesh scope
MXL-C002  error     collective crosses a pipeline-stage boundary
MXL-C003  warning   tp-sharded matmul missing its matching reduction
MXL-D001  error     collective order mismatch across ranks
MXL-D002  error     collective signature mismatch across ranks
MXL-D003  error     collective under rank-conditional control flow
MXL-D004  error     rank-divergent value flows into a coordinated path
MXL-D005  error     collective gated on rank-divergent control flow
MXL-D006  warning   unbalanced collective on an exception edge
MXL-Q001  error     shared attribute raced across threads w/o lock
MXL-Q002  error     lock-order cycle (potential deadlock)
MXL-Q003  warning   blocking call while holding a lock
MXL-Q004  warning   thread started without registry or join path
MXL-Q005  error     host-callback mutates step-path state unsynced
MXL-Q006  warning   condition wait without predicate re-check loop
MXL-X001  error     python control flow on a tensor in a traced scope
MXL-X002  error     unstable cache-key ingredient (id/order/env read)
MXL-X003  error     program build / compile on a per-request/step path
MXL-X004  warning   bare python scalar crosses the trace boundary
MXL-X005  error     unbucketed dynamic shape fed to a program table
MXL-X006  error     donated buffer reused after donation
MXL-K001  error     block over the card's shared memory (or an SM's
                    under its __launch_bounds__ promise)
MXL-K002  error     TMA box / 16-byte vector load / wgmma tile off grain
MXL-K003  warning   grid tail (a dimension not divisible by its tile)
MXL-K004  error     threads, grid or registers over the card
MXL-R001  info      matrix product bandwidth-bound at this batch size
MXL-R002  warning   wgmma tile padding wastes a large op fraction
MXL-R003  warning   float32 product on the FMA pipes (TF32 off)
MXL-R004  warning   long bf16 accumulation chain (reduction hazard)
MXL-R005  info      whole-graph static roofline / MFU-ceiling summary
MXL-E001  error     pipeline stage compute imbalance
MXL-E002  warning   pipeline bubble fraction above bound
MXL-E003  error     cross-stage back-edge: deadlock under 1F1B
MXL-E004  error     per-stage activation-stash memory overflow
MXL-E005  warning   stage-boundary transfer cannot hide under compute
MXL-E006  error     expert count not divisible by the ep axis
MXL-E007  warning   capacity factor risks dropping tokens
MXL-E008  info      expert all-to-all priced per rank
========  ========  ==================================================

The MXL-P/M/C families only activate with SPMD context: pass ``mesh``
(the port's ``parallel.Mesh`` or the device-less ``parallel.LogicalMesh``)
to enable propagation, plus ``hbm_bytes``/``MXTPU_HBM_GB`` for the
memory budget and ``kvstore`` for the scope audit.  ``select``/``skip``
accept fnmatch wildcards (``MXL-P*``).

The MXL-K family (tiling.py) validates every kernel launch registered
with ``register_kernel_spec`` against the card's limits (the device's
properties on the card, the H100's data sheet off it); MXL-R
(roofline.py) prices the graph's FLOPs and device-memory traffic at
``compute_dtype`` (default float32) against the card's peaks in
``observability.counters.PEAKS``.  Both run on the ``"gpu"`` target
only, the target a bind on the card passes; per-op R findings gate on a
significance floor (``MXTPU_LINT_ROOFLINE_MIN_FLOPS``, default 5e10) so
toy graphs stay clean.

The MXL-D001..D003 family simulates the per-rank collective trace (gated
on ``world_size > 1`` — or ``MXTPU_LINT_DISTRIBUTED=1`` +
``MXTPU_LINT_WORLD_SIZE``) over the ``__rank_cond__``/``__collective__``
node attrs.  MXL-E (schedule.py) prices the pipeline stages of a
``ctx_group`` or ``pp`` partition and the MoE expert all-to-all on the
``"gpu"`` target (:func:`schedule_report`, :func:`stage_partition`).

The source families read Python files, never importing them, and run
when ``source_paths`` is given (the CLI's ``.py`` targets):

- D004-D006 (divergence.py, :func:`analyze_source_paths`): the
  rank-divergence dataflow pass — ``torch.distributed.get_rank()``,
  ``torch.cuda.current_device()`` and the rank's environment variables
  beside the JAX sources, ``torch.distributed``'s collectives and the
  port's checkpoint writers beside the JAX sinks.  Mark rendezvous
  functions with ``base.collective_seam``; suppress intentional
  divergence with ``# mxl: rank-divergent-ok (MXL-D00x)``.
- Q (concurrency.py, :func:`analyze_concurrency_paths`): races, lock
  order, blocking under a lock (device syncs included), thread leaks,
  host-callback contexts (autograd's device threads included), wait
  loops.  Mark dynamic thread entries with ``base.thread_entry``;
  suppress intentional sharing with ``# mxl: thread-shared-ok
  (MXL-Q00x)``.  The runtime witness for Q002 is
  ``observability.locktrace`` (``MXTPU_LOCKCHECK=1``).
- X (retrace.py, :func:`analyze_retrace_paths`): the
  zero-steady-state-lowerings contract over program builds, NVRTC
  compiles and the CUDA extension's build.  Mark what is traced once and
  replayed with ``base.traced_scope``; suppress intentional hazards with
  ``# mxl: retrace-ok (MXL-X00x)``.  The runtime witness is
  ``observability.retrace`` (``MXTPU_RETRACE_SENTRY=1``).

Suppress per node with the ``__lint_ignore__`` attr (comma-separated
rule ids, or ``all``).
"""
from __future__ import annotations

import json as _json

from .core import (GraphIssue, AnalysisContext, Rule, RULE_REGISTRY,
                   register_rule, run_rules, format_issues,
                   SEVERITIES, SEVERITY_RANK)

# importing the pass modules registers their rules
from . import shapes as _shapes      # noqa: F401
from . import graph as _graph        # noqa: F401
from . import bind as _bind          # noqa: F401
from . import lowering as _lowering  # noqa: F401
from . import propagation as _propagation  # noqa: F401
from . import memory as _memory      # noqa: F401
from . import collectives as _collectives  # noqa: F401
from . import tiling as _tiling      # noqa: F401
from . import roofline as _roofline  # noqa: F401
from . import distributed as _distributed  # noqa: F401
from . import schedule as _schedule  # noqa: F401
from . import divergence as _divergence    # noqa: F401
from . import concurrency as _concurrency  # noqa: F401
from . import retrace as _retrace          # noqa: F401
from .propagation import comm_report
from .memory import peak_hbm_report, hbm_capacity_bytes
from .tiling import (register_kernel_spec, unregister_kernel_spec,
                     KERNEL_SPECS, spec_findings, kernel_spec_issues,
                     block_findings)
from .roofline import (roofline_report, static_ceiling_summary,
                       static_mfu_ceiling, device_peaks,
                       resolve_compute_dtype, mxu_padding_waste)
from .distributed import collective_trace
from .schedule import schedule_report, stage_partition
from .divergence import analyze_source_paths, collective_seam
from .concurrency import analyze_concurrency_paths, thread_entry
from .retrace import analyze_retrace_paths, traced_scope

__all__ = ["GraphIssue", "AnalysisContext", "Rule", "RULE_REGISTRY",
           "register_rule", "run_rules", "format_issues", "SEVERITIES",
           "SEVERITY_RANK", "analyze", "analyze_json", "max_severity",
           "GraphLintWarning", "comm_report", "peak_hbm_report",
           "hbm_capacity_bytes", "register_kernel_spec",
           "unregister_kernel_spec", "KERNEL_SPECS", "spec_findings",
           "kernel_spec_issues", "block_findings", "roofline_report",
           "static_mfu_ceiling", "static_ceiling_summary", "device_peaks",
           "resolve_compute_dtype", "mxu_padding_waste",
           "collective_trace", "schedule_report", "stage_partition",
           "analyze_source_paths", "collective_seam",
           "analyze_concurrency_paths", "thread_entry",
           "analyze_retrace_paths", "traced_scope"]

class GraphLintWarning(UserWarning):
    """Category for bind-time lint findings emitted in 'warn' mode."""


def analyze(symbol, shapes=None, type_dict=None, args=None, args_grad=None,
            grad_req=None, aux_states=None, group2ctx=None, mesh=None,
            sharding_rules=None, target="gpu", json_graph=None,
            kvstore=None, hbm_bytes=None, data_names=None,
            label_names=None, compute_dtype=None, device_kind=None,
            world_size=None, source_paths=None,
            select=None, skip=None, _ctx_out=None):
    """Run the lint passes over ``symbol``; returns issues, errors first.

    Parameters mirror what the call surfaces know: ``Symbol.validate``
    passes shape/type/mesh hints, the Executor bind hook adds
    args/args_grad/grad_req/aux_states/group2ctx, and the CLI adds the
    raw ``json_graph`` dict of a saved symbol plus the SPMD context
    (``mesh``/``kvstore``/``hbm_bytes``; ``data_names``/``label_names``
    steer the sharding seeds).  ``select``/``skip`` restrict which rule
    ids run (fnmatch wildcards like ``MXL-P*`` work).  ``_ctx_out``, when
    a list, receives the AnalysisContext so callers (the CLI's cost
    report) can reuse the cached propagation/memory facts.
    ``source_paths`` (.py files and directories) runs the source families
    D004-D006, Q and X over them (``symbol`` may then be None).
    """
    ctx = AnalysisContext(symbol, shapes=shapes, type_dict=type_dict,
                          args=args, args_grad=args_grad, grad_req=grad_req,
                          aux_states=aux_states, group2ctx=group2ctx,
                          mesh=mesh, sharding_rules=sharding_rules,
                          target=target, json_graph=json_graph,
                          kvstore=kvstore, hbm_bytes=hbm_bytes,
                          data_names=data_names, label_names=label_names,
                          compute_dtype=compute_dtype,
                          device_kind=device_kind, world_size=world_size,
                          source_paths=source_paths)
    if _ctx_out is not None:
        _ctx_out.append(ctx)
    return run_rules(ctx, select=select, skip=skip)


def analyze_json(json_src, **kwargs):
    """Lint a saved symbol JSON (string or parsed dict).

    Builds the Symbol through the normal loader, then analyzes with the
    raw node list attached so dead-node/unused-arg detection sees what
    the loader silently drops.  Nodes naming ops absent from the registry
    become MXL-L001 errors (the loader would just raise); the graph-only
    passes still run so one lint reports everything it can.
    """
    from ..symbol import load_json
    from ..ops.registry import OP_REGISTRY
    if isinstance(json_src, bytes):
        json_src = json_src.decode("utf-8")
    if isinstance(json_src, str):
        graph = _json.loads(json_src)
    else:
        graph = json_src
        json_src = _json.dumps(json_src)
    registered = dict(OP_REGISTRY.items())
    unknown = [spec for spec in graph.get("nodes", [])
               if spec.get("op") not in ("null", "None")
               and spec.get("op") not in registered]
    if unknown:
        issues = [GraphIssue("MXL-L001", "error", spec.get("name"),
                             "op %r of node %r is not in the operator "
                             "registry: the graph cannot load, let alone "
                             "lower" % (spec.get("op"), spec.get("name")))
                  for spec in unknown]
        kwargs.pop("select", None)
        kwargs.pop("skip", None)
        issues += analyze(None, json_graph=graph,
                          select={"MXL-G001", "MXL-G002"}, **kwargs)
        issues.sort(key=lambda i: (-SEVERITY_RANK[i.severity], i.rule_id,
                                   i.node or ""))
        return issues
    return analyze(load_json(json_src), json_graph=graph, **kwargs)


def max_severity(issues):
    """Highest severity present in ``issues`` (None when empty)."""
    best = None
    for i in issues:
        if best is None or SEVERITY_RANK[i.severity] > SEVERITY_RANK[best]:
            best = i.severity
    return best
