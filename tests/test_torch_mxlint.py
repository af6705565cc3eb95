"""``python -m mxnet_tpu_torch.tools.mxlint``: twins of the graph-mode
cases of ``tests/test_tools.py``, run in process through ``main(argv)``
(two subprocesses check the module entry point), the ``--format json``
output held to the JAX CLI's (``tools/mxlint.py``) on the same saved
graphs for the rules that are not about the hardware, and the source
modes (``--distributed``/``--concurrency``/``--retrace`` on ``.py``
targets, with ``--baseline``, ``--diff`` and ``--format=github``) against
the port and the fixtures (``--schedule`` runs:
``tests/test_torch_schedule.py``).
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.tools import mxlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_mxlint_twin", os.path.join(ROOT, "tools", "mxlint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lint(capsys, *argv):
    rc = mxlint.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _save_mlp(mx, path):
    mx.models.get_mlp().save(str(path))
    return str(path)


def test_mxlint_list_rules(capsys):
    rc, out, _ = _lint(capsys, "--list-rules")
    assert rc == 0
    for rid in ("MXL-S002", "MXL-L001", "MXL-K004", "MXL-R003", "MXL-D003",
                "MXL-D006", "MXL-Q001", "MXL-Q006", "MXL-X001", "MXL-X006"):
        assert rid in out


def test_mxlint_clean_json_exits_zero(capsys, tmp_path):
    path = _save_mlp(tmx, tmp_path / "mlp.json")
    rc, out, _ = _lint(capsys, path, "--shapes", "data=(8,784)",
                       "--fail-on=warning")
    assert rc == 0, out
    assert "clean" in out


def test_mxlint_shape_conflict_exits_one(capsys, tmp_path):
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data=data, num_hidden=5, name="fc")
    (fc + data).save(str(tmp_path / "bad.json"))
    rc, out, _ = _lint(capsys, str(tmp_path / "bad.json"), "--shapes",
                       "data=(8,784)")
    assert rc == 1 and "MXL-S002" in out
    rc, out, _ = _lint(capsys, str(tmp_path / "bad.json"), "--shapes",
                       "data=(8,784)", "--fail-on=never")
    assert rc == 0 and "MXL-S002" in out


def _dead_graph(path):
    graph = json.loads(jmx.models.get_mlp().tojson())
    n = len(graph["nodes"])
    graph["nodes"].append({"op": "null", "name": "orphan_var",
                           "attr": {}, "inputs": []})
    graph["nodes"].append({"op": "Flatten", "name": "orphan_op",
                           "attr": {}, "inputs": [[n, 0]]})
    graph["arg_nodes"].append(n)
    path.write_text(json.dumps(graph))
    return str(path)


def test_mxlint_dead_node_in_saved_graph(capsys, tmp_path):
    path = _dead_graph(tmp_path / "dead.json")
    rc, out, _ = _lint(capsys, path, "--fail-on=warning", "--format", "json")
    assert rc == 1
    ids = {i["rule_id"] for t in json.loads(out) for i in t["issues"]}
    assert {"MXL-G001", "MXL-G002"} <= ids


def test_mxlint_model_sweep_single(capsys):
    rc, out, _ = _lint(capsys, "--model", "mlp", "--fail-on=warning")
    assert rc == 0, out


def test_mxlint_usage_errors_exit_two(capsys, tmp_path):
    rc, _, _ = _lint(capsys, "--model", "no_such_model")
    assert rc == 2
    rc, _, _ = _lint(capsys, str(tmp_path / "missing.json"))
    assert rc == 2
    rc, _, err = _lint(capsys, "--model", "mlp", "--mesh", "dp=banana")
    assert rc == 2
    rc, _, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp")
    assert rc == 2
    rc, _, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=2,tp=2",
                     "--sharding", "no-equals-sign-here")
    assert rc == 2


def test_mxlint_mesh_cost_report(capsys):
    rc, out, _ = _lint(capsys, "--model", "transformer", "--mesh",
                       "dp=2,tp=2", "--fail-on=error")
    assert rc == 0, out
    assert "MXL-C003" in out and "MXL-P004" in out
    assert "communication (per device" in out
    assert "peak device-memory estimate" in out and "training mode" in out
    assert "static roofline" in out         # implied by --mesh


def test_mxlint_mesh_json_cost(capsys):
    rc, out, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=2,tp=2",
                       "--format", "json", "--fail-on=error")
    assert rc == 0
    cost = json.loads(out)[0]["cost"]
    assert cost["memory"]["peak_bytes"] > 0
    assert cost["memory"]["mode"] == "training"
    assert cost["communication"]["total_bytes"] >= 0


def test_mxlint_hbm_budget_gates(capsys):
    rc, out, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=2,tp=2",
                       "--hbm-gb", "0.000001")
    assert rc == 1 and "MXL-M001" in out
    rc, _, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=2,tp=2",
                     "--hbm-gb", "16")
    assert rc == 0


def test_mxlint_wildcard_select_and_skip(capsys):
    rc, out, _ = _lint(capsys, "--model", "transformer", "--mesh",
                       "dp=2,tp=2", "--select", "MXL-P*",
                       "--fail-on=warning")
    assert rc == 0 and "MXL-P004" in out and "MXL-C003" not in out
    rc, out, _ = _lint(capsys, "--model", "transformer", "--mesh",
                       "dp=2,tp=2", "--skip", "MXL-C*", "--fail-on=warning")
    assert "MXL-C003" not in out and "MXL-P004" in out


def test_mxlint_github_annotations(capsys):
    rc, out, _ = _lint(capsys, "--model", "transformer", "--mesh",
                       "dp=2,tp=2", "--format", "github")
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("::")]
    assert any(ln.startswith("::warning title=MXL-C003") for ln in lines)
    assert any("model:transformer" in ln for ln in lines)


def test_mxlint_sharding_flag(capsys):
    rc, out, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=2,tp=2",
                       "--sharding", r".*_weight=(None,tp);.*_bias=-",
                       "--fail-on=error")
    assert rc == 0 and "MXL-C003" in out


def test_mxlint_kvstore_audit(capsys):
    rc, out, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=64,tp=4",
                       "--kvstore", "device")
    assert rc == 1 and "MXL-C001" in out
    rc, _, _ = _lint(capsys, "--model", "mlp", "--mesh", "dp=64,tp=4",
                     "--kvstore", "dist_sync")
    assert rc == 0


def test_parse_shapes_edge_cases():
    assert mxlint.parse_shapes([" data = ( 8 , 784 ) "]) == \
        {"data": (8, 784)}
    assert mxlint.parse_shapes(["a=(2,3),b=(4,),c=5,"]) == \
        {"a": (2, 3), "b": (4,), "c": (5,)}
    with pytest.raises(ValueError, match="flat tuple"):
        mxlint.parse_shapes(["data=((2,3),4)"])


def test_mxlint_kernel_roofline_sweep(capsys):
    """The card-free K and R families over ResNet at a training batch:
    the registered kernel launches lint clean against the H100, and the
    roofline prices the graph at its float32 rate."""
    rc, out, _ = _lint(capsys, "--model", "resnet", "--select",
                       "MXL-K*,MXL-R*", "--shapes", "data=(256,3,224,224)",
                       "--roofline",
                       "--device-kind", "NVIDIA H100 80GB HBM3")
    assert rc == 0, out
    assert "static roofline" in out and "MFU ceiling" in out
    assert "MXL-R005" in out and "MXL-R003" in out
    assert "MXL-K" not in out
    rc, out, _ = _lint(capsys, "--model", "resnet", "--select", "MXL-R*",
                       "--shapes", "data=(256,3,224,224)", "--target", "cpu")
    assert rc == 0 and "MXL-R" not in out


def test_mxlint_baseline_suppression(capsys, tmp_path):
    base = str(tmp_path / "lint_baseline.json")
    args = ("--model", "resnet", "--select", "MXL-R*",
            "--shapes", "data=(256,3,224,224)", "--fail-on=info")
    assert _lint(capsys, *args)[0] == 1
    rc, out, _ = _lint(capsys, *args, "--baseline", base,
                       "--update-baseline")
    assert rc == 0 and "recorded" in out
    rc, out, _ = _lint(capsys, *args, "--baseline", base)
    assert rc == 0 and "suppressed" in out and "clean" in out
    rc, _, _ = _lint(capsys, "--model", "resnet", "--select", "MXL-R*",
                     "--shapes", "data=(512,3,224,224)", "--fail-on=info",
                     "--baseline", base)
    assert rc == 1


def test_mxlint_distributed_model_graph(capsys):
    rc, _, _ = _lint(capsys, "--model", "mlp", "--distributed",
                     "--world-size", "4", "--fail-on=error")
    assert rc == 0


FIXTURES = os.path.join(ROOT, "tests", "fixtures")


@pytest.mark.parametrize("argv,rc", [
    (["--concurrency", "mxnet_tpu_torch"], 0),
    (["--retrace", "mxnet_tpu_torch"], 0),
    (["--distributed", "mxnet_tpu_torch"], 0),
    (["--distributed", "fixtures/divergence"], 1),
    (["--concurrency", "fixtures/concurrency"], 1),
    (["--retrace", "fixtures/retrace"], 1),
])
def test_source_lints_run(capsys, argv, rc):
    """The source modes on the port exit 0 at ``--fail-on=warning``; on
    the regression fixtures, 1."""
    target = os.path.join(ROOT, argv[1]) if argv[1] == "mxnet_tpu_torch" \
        else os.path.join(ROOT, "tests", argv[1])
    got, out, err = _lint(capsys, argv[0], target, "--fail-on=warning")
    assert got == rc, out + err
    assert ("clean" in out) == (rc == 0)


def test_source_lints_match_the_jax_cli(capsys):
    """The three families over every fixture: the whole JSON document
    equal to the JAX CLI's."""
    argv = ["--distributed", "--concurrency", "--retrace", FIXTURES,
            "--format", "json", "--fail-on=never"]
    (rc_j, doc_j), (rc_t, doc_t) = _json_both(capsys, *argv)
    assert rc_j == rc_t == 0
    assert doc_t == doc_j
    rules = {i["rule_id"][:5] for i in doc_t[0]["issues"]}
    assert rules == {"MXL-D", "MXL-Q", "MXL-X"}


def test_lint_sources_families(tmp_path):
    """``lint_sources``: the families pick the default rule set;
    ``--select`` narrows within it (the JAX CLI's plumbing)."""
    p = tmp_path / "racy.py"
    p.write_text("import threading\n"
                 "class C:\n"
                 "    def start(self):\n"
                 "        threading.Thread(target=self._work).start()\n"
                 "    def _work(self):\n"
                 "        self._x = 1\n"
                 "    def read(self):\n"
                 "        return self._x\n")
    _l, issues, _c = mxlint.lint_sources([str(p)], None, [],
                                         families=["MXL-Q*"])
    assert {i.rule_id for i in issues} == {"MXL-Q001", "MXL-Q004"}
    _l, issues, _c = mxlint.lint_sources([str(p)], None, [],
                                         families=["MXL-D*", "MXL-X*"])
    assert issues == []
    _l, issues, _c = mxlint.lint_sources([str(p)], ["MXL-Q004"], [])
    assert {i.rule_id for i in issues} == {"MXL-Q004"}


_RACY = ("import threading\n"
         "class C:\n"
         "    def start(self):\n"
         "        self._t = threading.Thread(target=self._work)\n"
         "        self._t.start()\n"
         "    def _work(self):\n"
         "        self._x = 1\n"
         "    def read(self):\n"
         "        return self._x\n"
         "    def close(self):\n"
         "        self._t.join()\n")


def test_source_baseline_keys_on_the_anchor(capsys, tmp_path, monkeypatch):
    """A baselined source finding stays suppressed when its line moves
    (the record is keyed on ``file:qualname``); a new finding fails."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "racy.py").write_text(_RACY)
    base = str(tmp_path / "baseline.json")
    args = ("--concurrency", "racy.py", "--fail-on=warning")
    assert _lint(capsys, *args)[0] == 1
    rc, out, _ = _lint(capsys, *args, "--baseline", base,
                       "--update-baseline")
    assert rc == 0 and "recorded 1 finding" in out
    doc = json.load(open(base))
    assert doc["findings"][0]["anchor"] == "racy.py:C._work"
    (tmp_path / "racy.py").write_text("# moved\n\n\n" + _RACY)
    rc, out, _ = _lint(capsys, *args, "--baseline", base)
    assert rc == 0 and "suppressed" in out and "clean" in out
    (tmp_path / "racy.py").write_text(_RACY + (
        "    def start2(self):\n"
        "        threading.Thread(target=self._work).start()\n"))
    rc, out, _ = _lint(capsys, *args, "--baseline", base)
    assert rc == 1 and "MXL-Q004" in out


def test_source_github_annotations(capsys):
    rc, out, _ = _lint(capsys, "--distributed",
                       os.path.join(FIXTURES, "divergence"),
                       "--format=github")
    assert rc == 1
    lines = out.splitlines()
    assert len(lines) == 6
    d004 = [ln for ln in lines if "MXL-D004" in ln]
    assert len(d004) == 1
    assert d004[0].startswith(
        "::error file=tests/fixtures/divergence/pid_scratch_path.py,line=")
    assert all(ln.startswith(("::error file=", "::warning file="))
               for ln in lines)


def test_source_diff_lints_the_changed_sources(tmp_path):
    """``--diff`` lints the changed .py files of the port (module entry
    point, in a subprocess): a race added to one is found."""
    repo = tmp_path / "repo"
    pkg = repo / "mxnet_tpu_torch"
    pkg.mkdir(parents=True)
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t",
               PYTHONPATH=ROOT)
    (pkg / "worker.py").write_text("X = 1\n")
    (pkg / "other.py").write_text(_RACY)
    for cmd in (["git", "init", "-q"], ["git", "add", "-A"],
                ["git", "commit", "-q", "-m", "x"]):
        subprocess.run(cmd, cwd=str(repo), env=env, check=True)
    (pkg / "worker.py").write_text(_RACY.replace("class C", "class W"))
    p = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint",
                        "--diff", "HEAD", "--concurrency",
                        "--fail-on=error"],
                       cwd=str(repo), env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "mxnet_tpu_torch/worker.py:W._work" in p.stdout
    assert "other.py" not in p.stdout


def test_mxlint_diff_targets_mapping():
    picked = mxlint.diff_targets([
        "graphs/saved.json", "mxnet_tpu_torch/models/resnet.py",
        "mxnet_tpu_torch/kvstore.py", "mxnet_tpu/models/resnet.py",
        "mxnet_tpu_torch/models/nosuchmodel.py", "docs/graph_lint.md"])
    assert picked["files"] == ["graphs/saved.json"]
    assert picked["models"] == ["resnet"]
    assert "mxnet_tpu_torch/kvstore.py" in picked["sources"]
    assert "mxnet_tpu/models/resnet.py" not in picked["sources"]


def test_mxlint_diff_no_changes_exits_zero(tmp_path):
    """--diff in a repo with an empty diff: nothing to lint (the module
    entry point, in a subprocess)."""
    repo = tmp_path / "repo"
    repo.mkdir()
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t",
               PYTHONPATH=ROOT)
    for cmd in (["git", "init", "-q"],
                ["git", "commit", "-q", "--allow-empty", "-m", "x"]):
        subprocess.run(cmd, cwd=str(repo), env=env, check=True)
    p = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint",
                        "--diff", "HEAD", "--fail-on=error"],
                       cwd=str(repo), env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "no lintable changes" in p.stdout


def test_mxlint_all_models_module_entry_point():
    """The zoo sweep exits 0 with no error finding (on the card this is
    ``chip_smoke.py`` phase 19 (e))."""
    p = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.mxlint",
                        "--all-models", "--roofline", "--fail-on=error"],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.count("== model:") == len(mxlint.MODEL_SWEEP)


# ----------------------------------------------------------------------
# --format json against the JAX CLI on the same saved graphs
# ----------------------------------------------------------------------
def _json_both(capsys, *argv):
    jcli = _jax_cli()
    rc_j = jcli.main(list(argv))
    doc_j = json.loads(capsys.readouterr().out)
    rc_t = mxlint.main(list(argv))
    doc_t = json.loads(capsys.readouterr().out)
    return (rc_j, doc_j), (rc_t, doc_t)


def _saved_graphs(tmp_path):
    out = {}
    out["dead"] = _dead_graph(tmp_path / "dead.json")
    data = jmx.sym.Variable("data")
    fc = jmx.sym.FullyConnected(data=data, num_hidden=5, name="fc")
    (fc + data).save(str(tmp_path / "conflict.json"))
    out["conflict"] = str(tmp_path / "conflict.json")
    a = jmx.sym.Variable("x")
    f1 = jmx.sym.FullyConnected(data=a, num_hidden=2, name="same")
    jmx.sym.FullyConnected(data=f1, num_hidden=2, name="same").save(
        str(tmp_path / "dup.json"))
    out["dup"] = str(tmp_path / "dup.json")
    out["mlp"] = _save_mlp(jmx, tmp_path / "mlp.json")
    from mxnet_tpu.models.transformer import get_symbol
    get_symbol(vocab_size=512, num_layers=2, num_heads=4, dim=64,
               seq_len=64).save(str(tmp_path / "tf.json"))
    out["transformer"] = str(tmp_path / "tf.json")
    return out


@pytest.mark.parametrize("which,extra", [
    ("dead", ()),
    ("conflict", ("--shapes", "data=(8,784)")),
    ("dup", ()),
    ("mlp", ("--shapes", "data=(8,784)", "--mesh", "dp=2,tp=2")),
    ("mlp", ("--shapes", "data=(8,784)", "--mesh", "dp=64,tp=4",
             "--kvstore", "dist_async", "--hbm-gb", "0.000001")),
    ("transformer", ("--shapes", "data=(2,64),softmax_label=(2,64)",
                     "--mesh", "dp=2,tp=2")),
    ("transformer", ("--shapes", "data=(2,64),softmax_label=(2,64)",
                     "--mesh", "dp=2,tp=2", "--sharding",
                     r".*_weight=(None,tp);.*_bias=-")),
])
def test_json_output_matches_the_jax_cli(capsys, tmp_path, which, extra):
    """The whole JSON document (findings with their messages, and the
    cost reports) is equal on the ``cpu`` target, where the hardware
    families are silent in both packages.  (MXL-C001's device-scope
    message names this process's device count, which differs: the JAX
    tests run 8 host devices; its parity is in test_torch_analysis.)"""
    path = _saved_graphs(tmp_path)[which]
    (rc_j, doc_j), (rc_t, doc_t) = _json_both(
        capsys, path, "--format", "json", "--target", "cpu",
        "--fail-on=never", *extra)
    assert rc_j == rc_t == 0
    for d in (doc_j, doc_t):
        for entry in d:
            entry.pop("roofline", None)     # priced at each device's peaks
    assert doc_t == doc_j
