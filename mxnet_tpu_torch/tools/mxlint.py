#!/usr/bin/env python
"""mxlint: standalone static lint for Symbol graphs, on the port.

The port of the JAX package's ``tools/mxlint.py`` in graph mode: it runs
``mxnet_tpu_torch/analysis/`` outside any training process — over saved
symbol JSON files (the only place dead nodes can still exist: the
in-memory loader silently drops them) and over the bundled model zoo, so
CI can gate every change on a clean lint sweep:

  python -m mxnet_tpu_torch.tools.mxlint model-symbol.json \\
      --shapes "data=(8,3,224,224)"
  python -m mxnet_tpu_torch.tools.mxlint --model resnet --model mlp
  python -m mxnet_tpu_torch.tools.mxlint --all-models --fail-on=error

With a mesh the SPMD passes activate — sharding propagation (MXL-P),
peak-memory estimation (MXL-M), collective audit (MXL-C) — and each
graph gets a communication/memory cost report:

  python -m mxnet_tpu_torch.tools.mxlint --model transformer --mesh dp=2,tp=2

The hardware families run card-free on the default ``--target gpu``:
MXL-K checks every registered kernel launch against the card's limits,
MXL-R prices the graph at the card's peaks (``--device-kind``, a name of
``observability.counters.PEAKS``) and prints a static MFU ceiling:

  python -m mxnet_tpu_torch.tools.mxlint --model resnet \\
      --shapes "data=(64,3,224,224)" --roofline

``--schedule`` prints the static pipeline/MoE schedule report (MXL-E):
each stage priced at the card's peaks, the GPipe and 1F1B bubble
fractions over ``--microbatches``, the activation stash, and the expert
routing; stage boundaries and the all-to-all at the card's interconnect
rate:

  python -m mxnet_tpu_torch.tools.mxlint --model transformer_moe \
      --mesh dp=1,ep=4 --schedule

The distributed family (MXL-D) diffs the per-rank collective trace of
each graph (D001..D003) and runs the rank-divergence dataflow pass over
Python source (D004..D006).  ``--distributed`` turns both on
(``--world-size`` sets the simulated pod size, default 4); ``.py`` files
and directories among the positional targets are source-linted:

  python -m mxnet_tpu_torch.tools.mxlint --all-models --distributed
  python -m mxnet_tpu_torch.tools.mxlint --distributed mxnet_tpu_torch

``--concurrency`` runs the thread-safety family (MXL-Q) over the same
source targets: shared-attribute races, lock-order cycles, blocking
under a lock (device syncs included), thread leaks, host-callback
violations, missing wait re-check loops.  ``--retrace`` runs the
retrace-stability family (MXL-X): the zero-steady-state-lowerings
contract over program builds, NVRTC compiles and the CUDA extension's
build.  The families compose; the port lints clean under all three:

  python -m mxnet_tpu_torch.tools.mxlint --distributed --concurrency \
      --retrace mxnet_tpu_torch --fail-on=warning

``--diff [REV]`` lints only what a change touches — changed symbol
JSONs, the zoo models whose builders changed, and the changed .py files
of the port (the rank-divergence pass; plus MXL-Q with ``--concurrency``
and MXL-X with ``--retrace``):

  python -m mxnet_tpu_torch.tools.mxlint --diff origin/main \
      --concurrency --retrace --fail-on=error

Exit codes: 0 = nothing at/above --fail-on severity, 1 = findings at or
above it, 2 = usage/load failure.  --fail-on=never always exits 0 (report
only).  --select/--skip accept fnmatch wildcards ("MXL-P*") and
comma-separated lists.  --format=github emits workflow-command
annotations for CI logs (source findings carry ``file=`` and ``line=``).
--baseline FILE suppresses previously recorded findings (keyed on stable
file:qualname anchors where available, so records survive unrelated
edits; write it with --update-baseline) so a sweep fails only on NEW
findings.
"""
import argparse
import ast
import json
import os
import re
import sys

# the zoo sweep: get_symbol kwargs keep the big nets at lint-friendly sizes
# (analysis is metadata-only — no walk, no compute — so the cost is
# a python graph walk either way; small configs keep CI latency flat).
# The JAX package's sweep.
MODEL_SWEEP = [
    ("mlp", {}, {"data": (32, 784)}),
    ("lenet", {}, {"data": (32, 1, 28, 28)}),
    ("alexnet", {}, {"data": (2, 3, 224, 224)}),
    ("vgg", {"num_layers": 16}, {"data": (2, 3, 224, 224)}),
    ("googlenet", {}, {"data": (2, 3, 224, 224)}),
    ("inception_bn", {}, {"data": (2, 3, 224, 224)}),
    ("inception_v3", {}, {"data": (2, 3, 299, 299)}),
    ("resnet", {"num_layers": 18}, {"data": (2, 3, 224, 224)}),
    ("transformer",
     {"vocab_size": 512, "num_layers": 2, "num_heads": 4, "dim": 64,
      "seq_len": 64},
     {"data": (2, 64), "softmax_label": (2, 64)}),
    ("transformer_moe",
     {"vocab_size": 512, "num_layers": 2, "num_heads": 4, "dim": 64,
      "seq_len": 64, "num_experts": 4},
     {"data": (2, 64), "softmax_label": (2, 64)}),
]


def parse_shapes(specs):
    """--shapes "data=(8,3,224,224),label=(8,)" -> {name: tuple}."""
    out = {}
    for spec in specs or ():
        # split on commas that END a parenthesized tuple, not inside one
        depth, start = 0, 0
        parts = []
        for i, ch in enumerate(spec):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append(spec[start:i])
                start = i + 1
        parts.append(spec[start:])
        for part in parts:
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError("bad --shapes entry %r (want name=(d,...))"
                                 % part)
            name, val = part.split("=", 1)
            shape = ast.literal_eval(val.strip())
            if isinstance(shape, int):
                shape = (shape,)
            try:
                shape = tuple(int(d) for d in shape)
            except (TypeError, ValueError):
                raise ValueError(
                    "bad --shapes entry %r: %r is not a flat tuple of ints"
                    % (part, val.strip()))
            out[name.strip()] = shape
    return out


def parse_mesh(spec):
    """--mesh "dp=2,tp=4" -> parallel.LogicalMesh (device-less: lints a
    pod-sized layout from a dev box)."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("bad --mesh entry %r (want axis=size)" % part)
        name, val = part.split("=", 1)
        try:
            axes[name.strip()] = int(val)
        except ValueError:
            raise ValueError("bad --mesh size %r for axis %r"
                             % (val, name.strip()))
    if not axes:
        raise ValueError("--mesh given but no axes parsed from %r" % spec)
    from ..parallel import LogicalMesh
    return LogicalMesh(**axes)


def _parse_pspec(val):
    """"(tp,None)" / "tp" / "-" -> PartitionSpec (None = no constraint)."""
    from ..parallel.sharding import PartitionSpec as P
    val = val.strip()
    if val in ("-", "None", ""):
        return P()
    if val.startswith("(") and val.endswith(")"):
        val = val[1:-1]
    entries = []
    for e in val.split(","):
        e = e.strip()
        if not e:
            continue
        entries.append(None if e in ("None", "-") else e)
    return P(*entries)


def parse_sharding(spec):
    """--sharding "pattern=(axes);pattern=axes" -> ShardingRules.

    Entries are ';'-separated ``regex=(axis,axis,...)`` pairs (the
    rightmost '=' splits, so regexes may contain '='); axis ``None`` or
    ``-`` means replicated on that dim.  Names the rules don't match
    fall back to the default tp policy."""
    if not spec:
        return None
    from ..parallel.sharding import ShardingRules
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("bad --sharding entry %r "
                             "(want regex=(axis,...))" % part)
        pat, val = part.rsplit("=", 1)
        pspec = _parse_pspec(val)
        rules.append((pat.strip(), lambda s, m, _p=pspec: _p))
    return ShardingRules(rules)


def lint_file(path, shapes, target, select, skip, **spmd):
    """Lint one saved symbol JSON; returns (label, issues, ctx|None)."""
    from ..analysis import analyze_json
    with open(path) as f:
        src = f.read()
    ctx_out = []
    issues = analyze_json(src, shapes=shapes, target=target,
                          select=select, skip=skip, _ctx_out=ctx_out,
                          **spmd)
    return path, issues, (ctx_out[0] if ctx_out else None)


def build_model(name, kwargs):
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.models.%s" % name)
    if not hasattr(mod, "get_symbol"):
        raise ValueError("model %r has no get_symbol function" % name)
    return mod.get_symbol(**kwargs)


def schedule_report_lines(ctx):
    """The static pipeline/MoE schedule section (text mode)."""
    from ..analysis import schedule_report
    from ..analysis.propagation import fmt_bytes
    rep = schedule_report(ctx)
    if rep is None:
        return ["-- schedule: no pipeline partition or MoE nodes"]
    lines = []
    if rep["partition"] is not None:
        lines.append("-- schedule (%s, %d stages x %d microbatches):"
                     % (rep["partition"]["mode"], rep["partition"]["k"],
                        rep["microbatches"]))
        for s in rep["stages"]:
            lines.append("   stage %d (%-8s) %3d ops  %8.2f GF  "
                         "fwd %.3f ms  bwd %.3f ms"
                         % (s["index"], s["group"], s["ops"],
                            s["flops"] / 1e9, s["t_fwd_s"] * 1e3,
                            s["t_bwd_s"] * 1e3))
        for e in rep["boundaries"]:
            lines.append("   boundary %d->%d  %9s  %.3f ms"
                         % (e["src"], e["dst"], fmt_bytes(e["bytes"]),
                            e["time_s"] * 1e3))
        for name, sim in sorted(rep["schedules"].items()):
            lines.append("   %-6s bubble %.3f  (%d slots, %.3f ms/step)"
                         % (name, sim["bubble_fraction"], sim["slots"],
                            sim["total_time"] * 1e3))
        for h in rep["stage_hbm"]:
            lines.append("   stage %d HBM: params+grads %s + stash "
                         "%dx%s = %s (1f1b)"
                         % (h["index"], fmt_bytes(h["param_bytes"]),
                            h["stash_1f1b"],
                            fmt_bytes(h["act_per_microbatch"]),
                            fmt_bytes(h["peak_1f1b"])))
    for s in rep["moe"]:
        lines.append("-- moe %s: %d experts top-%d cf=%.2f  "
                     "capacity %s/expert  balance %s"
                     % (s["node"], s["num_experts"], s["top_k"],
                        s["capacity_factor"],
                        s["capacity"] if s["capacity"] else "inf",
                        ("%.2f" % s["expert_balance"])
                        if s["expert_balance"] is not None else "-"))
    return lines


def lint_model(name, kwargs, shapes, target, select, skip, **spmd):
    from ..analysis import analyze
    sym = build_model(name, kwargs)
    ctx_out = []
    issues = analyze(sym, shapes=shapes, target=target, select=select,
                     skip=skip, _ctx_out=ctx_out, **spmd)
    return "model:%s" % name, issues, (ctx_out[0] if ctx_out else None)


def lint_sources(paths, select, skip, world_size=None, families=None):
    """Run the source-reading pass families over .py files and
    directories; returns the same (label, issues, ctx) triple shape.
    ``families`` picks the default rule set when no --select is given:
    MXL-D* (rank divergence), MXL-Q* (concurrency), MXL-X* (retrace
    stability), or any combination."""
    from ..analysis import analyze
    issues = analyze(None, source_paths=list(paths),
                     world_size=world_size,
                     select=(select or families or ["MXL-D*"]),
                     skip=skip)
    return "sources", issues, None


def git_changed_paths(rev, cwd=None):
    """Paths changed vs ``rev`` (committed + staged + worktree)."""
    import subprocess
    out = subprocess.run(
        ["git", "diff", "--name-only", rev, "--"],
        capture_output=True, text=True, cwd=cwd)
    if out.returncode != 0:
        raise ValueError("git diff %s failed: %s"
                         % (rev, out.stderr.strip()))
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


def diff_targets(changed, sweep=None):
    """Map changed paths -> lint targets (pure; unit-tested).

    Returns ``{"files", "models", "sources"}``: changed symbol JSONs
    lint directly, a changed ``models/<name>.py`` of the port re-lints
    that zoo entry (when it has a sweep row), and every changed .py file
    of the port goes through the source passes.  Existence filtering
    (deleted files show up in diffs) is the caller's job.
    """
    sweep = MODEL_SWEEP if sweep is None else sweep
    names = {row[0] for row in sweep}
    files, models, sources = [], [], []
    for p in changed:
        q = p.replace("\\", "/")
        if q.endswith(".json"):
            files.append(p)
        elif q.endswith(".py") and "mxnet_tpu_torch" in q.split("/"):
            parts = q.split("/")
            if "models" in parts:
                stem = parts[-1][:-len(".py")]
                if stem in names and stem not in models:
                    models.append(stem)
            sources.append(p)
    return {"files": files, "models": models, "sources": sources}


def cost_report_lines(ctx):
    """The per-graph communication + memory cost report (text mode)."""
    from ..analysis import comm_report, peak_hbm_report
    from ..analysis.propagation import fmt_bytes
    lines = []
    comm = comm_report(ctx)
    lines.append("-- communication (per device, per step):")
    if comm["events"]:
        for kind in sorted(comm["by_kind"]):
            entry = comm["by_kind"][kind]
            lines.append("   %-15s %3d event(s)  %s"
                         % (kind, entry["count"],
                            fmt_bytes(entry["bytes"])))
        lines.append("   %-15s %s between devices%s"
                     % ("total", fmt_bytes(comm["total_bytes"]),
                        "" if comm["complete"]
                        else "  (partial: some shapes unknown)"))
    else:
        lines.append("   no implicit collectives")
    mem = peak_hbm_report(ctx)
    lines.append("-- peak device-memory estimate (per device, %s mode):"
                 % (mem["mode"] or "unknown"))
    lines.append("   params %s + grads %s + aux %s + activations %s"
                 % (fmt_bytes(mem["params_bytes"]),
                    fmt_bytes(mem["grads_bytes"]),
                    fmt_bytes(mem["aux_bytes"]),
                    fmt_bytes(mem["activations_bytes"])))
    budget = mem["budget_bytes"]
    lines.append("   peak %s%s%s"
                 % (fmt_bytes(mem["peak_bytes"]),
                    (" of %s budget (%.0f%%)"
                     % (fmt_bytes(budget),
                        100.0 * mem["peak_bytes"] / budget))
                    if budget else "",
                    "" if mem["complete"]
                    else "  (partial: some shapes unknown)"))
    return lines


def cost_report_dict(ctx):
    from ..analysis import comm_report, peak_hbm_report
    return {"communication": comm_report(ctx),
            "memory": peak_hbm_report(ctx)}


def roofline_report_lines(ctx):
    """The static roofline / MFU-ceiling section (text mode)."""
    from ..analysis import roofline_report
    from ..analysis.propagation import fmt_bytes
    rep = roofline_report(ctx)
    lines = ["-- static roofline (%s mode, %s @ %s):"
             % (rep["mode"], rep["compute_dtype"], rep["device_kind"])]
    lines.append("   %.3f TF/step, %s/step device memory -> %.1f fl/B "
                 "(ridge %.1f)%s"
                 % (rep["flops_per_step"] / 1e12,
                    fmt_bytes(rep["hbm_bytes_per_step"]),
                    rep["intensity"] or 0.0, rep["ridge"] or 0.0,
                    "" if rep["complete"]
                    else "  (partial: some shapes unknown)"))
    if rep["mfu_ceiling"] is not None:
        lines.append("   %s-bound: static MFU ceiling %.3f"
                     % (rep["bound"], rep["mfu_ceiling"]))
    for row in rep["per_op"]:
        lines.append("   %-28s %8.2f GF  %9s  %s"
                     % (row["node"], row["flops"] / 1e9,
                        fmt_bytes(row["bytes"]),
                        "mma" if row["mxu"] else "vec"))
    return lines


_LINE_RE = re.compile(r"\(line \d+\)")


def _baseline_key(label, rule_id, where, message):
    """``where`` is the stable location: the file:qualname anchor when
    the finding has one, else the node name — never a line number, so
    baselines survive unrelated edits (the source findings' messages
    name the lines of their two sites, ``(line N)``: left out of the
    key too)."""
    return "%s|%s|%s|%s" % (label, rule_id, where or "",
                            _LINE_RE.sub("(line)", message))


def load_baseline(path):
    """Baseline file -> set of finding keys (empty when absent).

    Older records have no ``anchor`` field; ``anchor or node`` keeps
    them loading (and matching node-located findings) unchanged."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        doc = json.load(f)
    return {_baseline_key(e["target"], e["rule_id"],
                          e.get("anchor") or e.get("node"),
                          e["message"])
            for e in doc.get("findings", [])}


def write_baseline(path, targets):
    """Record every current finding so later runs fail only on NEW ones."""
    doc = {"version": 1,
           "findings": [{"target": label, "rule_id": i.rule_id,
                         "severity": i.severity, "node": i.node,
                         "anchor": i.anchor, "message": i.message}
                        for label, issues, _ in targets
                        for i in issues]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(doc["findings"])


def _gh_escape(text):
    return (str(text).replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


_GH_LEVEL = {"error": "error", "warning": "warning", "info": "notice"}


def gh_annotation(label, issue):
    """One GitHub Actions workflow-command line per finding.

    Findings with a ``file:qualname`` anchor also carry ``file=`` and
    ``line=`` params so the annotation lands on the source line in the
    PR view (the line is display-only; identity stays on the anchor)."""
    where = issue.anchor or issue.node or "graph"
    params = ""
    if issue.anchor and ":" in issue.anchor:
        fpath = issue.anchor.rsplit(":", 1)[0]
        params = "file=%s," % _gh_escape(fpath)
        if issue.line:
            params += "line=%d," % issue.line
    return "::%s %stitle=%s [%s] %s::%s" % (
        _GH_LEVEL.get(issue.severity, "notice"), params, issue.rule_id,
        _gh_escape(label), _gh_escape(where), _gh_escape(issue.message))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="*",
                    help="saved symbol JSON files; .py files and "
                         "directories go through the source passes "
                         "(MXL-D004..006 by default)")
    ap.add_argument("--model", action="append", default=[],
                    help="lint a bundled mxnet_tpu_torch/models/<name> "
                         "network (repeatable)")
    ap.add_argument("--all-models", action="store_true",
                    help="lint every bundled network (the CI sweep)")
    ap.add_argument("--shapes", action="append", default=[],
                    metavar="name=(d,...)",
                    help="input shape hints, e.g. data=(8,3,224,224)")
    ap.add_argument("--mesh", default=None, metavar="dp=2,tp=4",
                    help="logical device mesh: activates the SPMD passes "
                         "(MXL-P/M/C) and the per-graph cost report; no "
                         "physical devices needed")
    ap.add_argument("--sharding", default=None,
                    metavar="regex=(axis,...);...",
                    help="explicit ShardingRules overriding the default tp "
                         "policy, e.g. \".*embed.*_weight=(tp,None)\"")
    ap.add_argument("--kvstore", default=None,
                    help="kvstore type the trainer would use (enables the "
                         "MXL-C001 scope audit)")
    ap.add_argument("--grad-req", default="write",
                    help="gradient request the trainer would bind "
                         "(write/add/null; default write = training-mode "
                         "memory estimate)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget in GiB for MXL-M001 "
                         "(default: the MXTPU_HBM_GB env var, else no "
                         "budget check)")
    ap.add_argument("--compute-dtype", default=None,
                    help="dtype products run at for the MXL-R roofline "
                         "(default: float32, the trainer's)")
    ap.add_argument("--device-kind", default=None,
                    help="card whose peaks set the roofline ridge, a name "
                         "of observability.counters.PEAKS (default "
                         "MXTPU_LINT_DEVICE_KIND, else the current CUDA "
                         "device's name, else the H100 SXM)")
    ap.add_argument("--roofline", action="store_true",
                    help="print the static roofline / MFU-ceiling report "
                         "per graph (implied by --mesh)")
    ap.add_argument("--schedule", action="store_true",
                    help="print the static pipeline/MoE schedule report "
                         "(MXL-E): per-stage roofline pricing, GPipe + "
                         "1F1B bubble fractions, activation-stash memory, "
                         "expert routing stats")
    ap.add_argument("--microbatches", type=int, default=None, metavar="M",
                    help="microbatch count the schedule simulator walks "
                         "(default MXTPU_LINT_MICROBATCHES, else 8)")
    ap.add_argument("--distributed", action="store_true",
                    help="enable the MXL-D distributed family: per-rank "
                         "collective-trace diff on graphs (D001..003) "
                         "and the rank-divergence source pass "
                         "(D004..006) on .py targets")
    ap.add_argument("--concurrency", action="store_true",
                    help="enable the MXL-Q concurrency family over .py "
                         "source targets: shared-state races, lock-order "
                         "cycles, blocking under lock, thread leaks, "
                         "callback-context violations, wait-loop hygiene")
    ap.add_argument("--retrace", action="store_true",
                    help="enable the MXL-X retrace-stability family over "
                         ".py source targets: traced control flow on "
                         "tensors, unstable cache-key ingredients, "
                         "per-step program builds and compiles, weak-type "
                         "scalar leaks, unbucketed program tables, "
                         "donated-buffer reuse")
    ap.add_argument("--world-size", type=int, default=None,
                    metavar="N",
                    help="simulated pod size for the trace diff "
                         "(implies --distributed; default 4 when "
                         "--distributed is set)")
    ap.add_argument("--diff", nargs="?", const="HEAD", default=None,
                    metavar="REV",
                    help="lint only targets reachable from paths changed "
                         "vs REV (default HEAD): changed symbol JSONs, "
                         "models whose builders changed, and changed .py "
                         "files of the port (fast pre-merge mode)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress findings recorded in FILE; fail only "
                         "on new ones (create it with --update-baseline)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write all current findings to --baseline FILE "
                         "and exit 0")
    ap.add_argument("--fail-on", default="error",
                    choices=("error", "warning", "info", "never"),
                    help="exit 1 when findings at/above this severity "
                         "exist (default: error)")
    ap.add_argument("--select", action="append", default=[],
                    help="run only these rule ids (repeatable; fnmatch "
                         "wildcards like 'MXL-P*' work)")
    ap.add_argument("--skip", action="append", default=[],
                    help="skip these rule ids (repeatable; wildcards work)")
    ap.add_argument("--target", default="gpu",
                    help="target platform (default: gpu; cpu silences "
                         "the hardware families K and R)")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "github"), dest="fmt",
                    help="github = workflow-command annotations for CI")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from ..analysis import RULE_REGISTRY, SEVERITY_RANK, format_issues

    if args.list_rules:
        for rule in RULE_REGISTRY.values():
            print("%-9s %-8s %s" % (rule.rule_id, rule.severity, rule.doc))
        return 0

    if args.microbatches is not None:
        if args.microbatches < 1:
            ap.error("--microbatches must be >= 1")
        os.environ["MXTPU_LINT_MICROBATCHES"] = str(args.microbatches)

    if args.world_size is not None:
        args.distributed = True
    world_size = (args.world_size or 4) if args.distributed else None

    if args.diff is not None:
        try:
            changed = git_changed_paths(args.diff)
        except (ValueError, OSError) as exc:
            print("mxlint: %s" % exc, file=sys.stderr)
            return 2
        picked = diff_targets(changed)
        args.files += [p for p in picked["files"] + picked["sources"]
                       if os.path.exists(p)]
        args.model += [m for m in picked["models"]
                       if m not in args.model]
        if not args.files and not args.model and not args.all_models:
            print("mxlint: --diff %s: no lintable changes" % args.diff)
            return 0

    if not args.files and not args.model and not args.all_models:
        ap.error("nothing to lint: pass JSON files / .py sources, "
                 "--model, --all-models, or --diff")

    json_files = [p for p in args.files if p.endswith(".json")]
    source_paths = [p for p in args.files if not p.endswith(".json")]
    bad = [p for p in source_paths
           if not (os.path.isdir(p) or p.endswith(".py"))]
    if bad:
        print("mxlint: not a symbol JSON, .py file, or directory: %s"
              % ", ".join(bad), file=sys.stderr)
        return 2

    try:
        shapes = parse_shapes(args.shapes)
        mesh = parse_mesh(args.mesh)
        sharding_rules = parse_sharding(args.sharding)
    except (ValueError, SyntaxError) as exc:
        print("mxlint: %s" % exc, file=sys.stderr)
        return 2

    spmd = {}
    if mesh is not None:
        spmd["mesh"] = mesh
    if sharding_rules is not None:
        spmd["sharding_rules"] = sharding_rules
    if args.kvstore:
        spmd["kvstore"] = args.kvstore
    if args.grad_req:
        spmd["grad_req"] = args.grad_req
    if args.hbm_gb is not None:
        spmd["hbm_bytes"] = int(args.hbm_gb * (1 << 30))
    if args.compute_dtype:
        spmd["compute_dtype"] = args.compute_dtype
    if args.device_kind:
        spmd["device_kind"] = args.device_kind
    if world_size is not None:
        spmd["world_size"] = world_size
    if args.update_baseline and not args.baseline:
        ap.error("--update-baseline needs --baseline FILE")

    # each --select/--skip may itself be comma-separated
    select = {p.strip() for s in args.select for p in s.split(",")
              if p.strip()} or None
    skip = {p.strip() for s in args.skip for p in s.split(",")
            if p.strip()} or None

    targets = []    # (label, issues, ctx|None)
    try:
        for path in json_files:
            targets.append(lint_file(path, shapes, args.target, select,
                                     skip, **spmd))
        sweep = list(MODEL_SWEEP) if args.all_models else []
        for name in args.model:
            row = next((r for r in MODEL_SWEEP if r[0] == name),
                       (name, {}, {}))
            if row not in sweep:
                sweep.append(row)
        for name, kwargs, default_shapes in sweep:
            targets.append(lint_model(name, kwargs,
                                      shapes or default_shapes,
                                      args.target, select, skip, **spmd))
        if source_paths:
            families = []
            if args.distributed or not (args.concurrency or args.retrace):
                families.append("MXL-D*")
            if args.concurrency:
                families.append("MXL-Q*")
            if args.retrace:
                families.append("MXL-X*")
            targets.append(lint_sources(source_paths, select, skip,
                                        world_size=world_size,
                                        families=families))
    except (IOError, OSError, ValueError, ImportError) as exc:
        print("mxlint: %s" % exc, file=sys.stderr)
        return 2

    if args.update_baseline:
        n = write_baseline(args.baseline, targets)
        print("mxlint: recorded %d finding(s) to %s" % (n, args.baseline))
        return 0
    known = load_baseline(args.baseline) if args.baseline else set()
    if known or args.baseline:
        filtered = []
        suppressed = 0
        for label, issues, ctx in targets:
            new = [i for i in issues
                   if _baseline_key(label, i.rule_id,
                                    i.anchor or i.node, i.message)
                   not in known]
            suppressed += len(issues) - len(new)
            filtered.append((label, new, ctx))
        targets = filtered
        if suppressed and args.fmt == "text":
            print("mxlint: %d baselined finding(s) suppressed (%s)"
                  % (suppressed, args.baseline))

    roofline = args.roofline or mesh is not None
    worst = None
    if args.fmt == "json":
        doc = []
        for label, issues, ctx in targets:
            entry = {"target": label,
                     "issues": [i.as_dict() for i in issues]}
            if mesh is not None and ctx is not None and \
                    ctx.symbol is not None:
                entry["cost"] = cost_report_dict(ctx)
            if roofline and ctx is not None and ctx.symbol is not None \
                    and ctx.target == "gpu":
                from ..analysis import roofline_report
                entry["roofline"] = roofline_report(ctx)
            if args.schedule and ctx is not None and \
                    ctx.symbol is not None and ctx.target == "gpu":
                from ..analysis import schedule_report
                entry["schedule"] = schedule_report(ctx)
            doc.append(entry)
        print(json.dumps(doc, indent=2))
    for label, issues, ctx in targets:
        if args.fmt == "text":
            verdict = ("clean" if not issues
                       else "%d issue(s)" % len(issues))
            print("== %s: %s" % (label, verdict))
            if issues:
                print(format_issues(issues))
            if mesh is not None and ctx is not None and \
                    ctx.symbol is not None:
                for line in cost_report_lines(ctx):
                    print(line)
            if roofline and ctx is not None and ctx.symbol is not None \
                    and ctx.target == "gpu":
                for line in roofline_report_lines(ctx):
                    print(line)
            if args.schedule and ctx is not None and \
                    ctx.symbol is not None and ctx.target == "gpu":
                for line in schedule_report_lines(ctx):
                    print(line)
        elif args.fmt == "github":
            for i in issues:
                print(gh_annotation(label, i))
        for i in issues:
            if worst is None or \
                    SEVERITY_RANK[i.severity] > SEVERITY_RANK[worst]:
                worst = i.severity
    if args.fail_on != "never" and worst is not None and \
            SEVERITY_RANK[worst] >= SEVERITY_RANK[args.fail_on]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
