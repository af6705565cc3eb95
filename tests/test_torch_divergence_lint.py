"""The port's rank-divergence lint (``mxnet_tpu_torch/analysis/
divergence.py``, MXL-D004..D006) against the JAX package's.

Every snippet that ``tests/test_distributed_lint.py`` lints, and every
file under ``tests/fixtures/divergence/``, goes through both analyzers:
the two ``(rule, severity, anchor, line)`` lists must be equal.  The
snippets are read out of the reference test file with ``ast`` (the
string literals handed to its lint helper, with the ``str.replace``
edits it makes), so a snippet added there is a case here.  Both
analyzers over the whole ``mxnet_tpu/`` tree must agree too, but for the
findings only the torch vocabulary makes (:data:`TORCH_ONLY`).  Each
torch entry of the vocabulary has a firing twin and a clean one, and the
port lints itself clean.

The snippet extraction (:func:`reference_snippets`) and the comparison
helpers are shared with ``test_torch_concurrency_lint.py`` and
``test_torch_retrace_lint.py``.
"""
import ast
import os
import subprocess
import sys

import pytest

from mxnet_tpu import analysis as jan
from mxnet_tpu.analysis import divergence as jdiv
from mxnet_tpu_torch import analysis as tan
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.analysis import divergence as tdiv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "test_distributed_lint.py")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "divergence")

#: (anchor, rule) of the findings over ``mxnet_tpu/`` that only the torch
#: vocabulary makes (the JAX tree uses no torch name: none)
TORCH_ONLY = set()


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------
def _value(node, env):
    """The string an expression of the reference tests evaluates to: a
    literal, a name bound to one, ``+`` of them, ``s.replace(a, b)``;
    None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _value(node.left, env), _value(node.right, env)
        return a + b if a is not None and b is not None else None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "replace" and len(node.args) == 2:
        parts = [_value(n, env) for n in [node.func.value] + node.args]
        if None not in parts:
            return parts[0].replace(parts[1], parts[2])
    return None


def reference_snippets(path, helpers):
    """``(case id, file name, source)`` for every snippet the reference
    test file at ``path`` lints: the code argument of each call to one of
    ``helpers`` (``_lint(tmp_path, code, name=...)``) and each
    ``p.write_text(code)``, in each test function, in source order."""
    tree = ast.parse(open(path).read(), filename=path)
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.startswith("test_"):
            continue
        events = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                events.append((node.lineno, 0, node))
            elif isinstance(node, ast.Call):
                events.append((node.lineno, 1, node))
        env, paths, n = {}, {}, 0
        for _line, _kind, node in sorted(events, key=lambda e: e[:2]):
            if isinstance(node, ast.Assign):
                name = node.targets[0].id
                val = _value(node.value, env)
                if val is not None:
                    env[name] = val
                elif isinstance(node.value, ast.BinOp) and \
                        isinstance(node.value.op, ast.Div):
                    fname = _value(node.value.right, env)
                    if fname:
                        paths[name] = fname
                continue
            func = node.func
            code, fname = None, "snippet.py"
            if isinstance(func, ast.Name) and func.id in helpers and \
                    len(node.args) >= 2:
                code = _value(node.args[1], env)
                if len(node.args) >= 3:
                    fname = _value(node.args[2], env) or fname
                for k in node.keywords:
                    if k.arg == "name":
                        fname = _value(k.value, env) or fname
            elif isinstance(func, ast.Attribute) and \
                    func.attr == "write_text" and node.args and \
                    isinstance(func.value, ast.Name):
                code = _value(node.args[0], env)
                fname = paths.get(func.value.id, fname)
            if code is not None:
                out.append(("%s[%d]" % (fn.name, n), fname, code))
                n += 1
    return out


def rows(findings, registry):
    """``(rule, severity, anchor, line)`` of finding dicts; a finding
    without its own severity has its rule's."""
    return [(f["rule"], f.get("severity") or registry[f["rule"]].severity,
             f["anchor"], f["line"]) for f in findings]


def both(tmp_path, fname, code, jax_fn, port_fn):
    """The snippet ``code`` written as ``fname`` and linted by the JAX
    analyzer and the port's; their two row lists."""
    p = tmp_path / fname
    p.write_text(code)
    root = str(tmp_path)
    return (rows(jax_fn([str(p)], root=root), jan.RULE_REGISTRY),
            rows(port_fn([str(p)], root=root), tan.RULE_REGISTRY))


def lint(tmp_path, code, port_fn, name="snippet.py"):
    """The port's findings over one snippet."""
    p = tmp_path / name
    p.write_text(code)
    return port_fn([str(p)], root=str(tmp_path))


def rules_of(findings):
    return sorted({f["rule"] for f in findings})


def fixture_files(directory):
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.endswith(".py"))


# ----------------------------------------------------------------------
# parity with the JAX analyzer
# ----------------------------------------------------------------------
SNIPPETS = reference_snippets(REFERENCE, {"_lint_snippet"})


def test_the_reference_snippets_were_found():
    # the reference file lints 15 snippets; fewer means the extraction
    # lost some
    assert len(SNIPPETS) == 15


@pytest.mark.parametrize("case,fname,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_reference_snippet_parity(tmp_path, case, fname, code):
    j, t = both(tmp_path, fname, code, jdiv.analyze_source_paths,
                tdiv.analyze_source_paths)
    assert t == j


@pytest.mark.parametrize("path", fixture_files(FIXTURES),
                         ids=os.path.basename)
def test_fixture_parity(path):
    j = rows(jdiv.analyze_source_paths([path], root=ROOT),
             jan.RULE_REGISTRY)
    t = rows(tdiv.analyze_source_paths([path], root=ROOT),
             tan.RULE_REGISTRY)
    assert j and t == j


@pytest.fixture(scope="module")
def jax_tree():
    pkg = [os.path.join(ROOT, "mxnet_tpu")]
    return (rows(jdiv.analyze_source_paths(pkg, root=ROOT),
                 jan.RULE_REGISTRY),
            rows(tdiv.analyze_source_paths(pkg, root=ROOT),
                 tan.RULE_REGISTRY))


def test_jax_tree_parity(jax_tree):
    j, t = jax_tree
    extra = [r for r in t if (r[2], r[0]) in TORCH_ONLY]
    assert sorted({(r[2], r[0]) for r in extra}) == sorted(TORCH_ONLY)
    assert [r for r in t if r not in extra] == j


def test_port_self_lint_clean():
    """The port's twin of the reference's ``test_framework_self_lint_
    clean``: no MXL-D004..D006 finding over ``mxnet_tpu_torch/`` (the
    seams marked, the intentional divergence annotated)."""
    fs = tdiv.analyze_source_paths([os.path.join(ROOT, "mxnet_tpu_torch")],
                                   root=ROOT)
    assert fs == [], ["%s %s:%s" % (f["rule"], f["anchor"], f["line"])
                      for f in fs]


# ----------------------------------------------------------------------
# the torch vocabulary: a firing twin and a clean twin each
# ----------------------------------------------------------------------
_HEAD = ("import os\n"
         "import torch\n"
         "import torch.distributed as dist\n"
         "from mxnet_tpu_torch.base import collective_seam\n")

#: (name, firing snippet, its rules, clean twin)
TWINS = [
    ("get_rank",
     "def f(t):\n    if dist.get_rank() == 0:\n        dist.barrier()\n",
     ["MXL-D005"],
     "def f(t):\n    if dist.get_world_size() > 1:\n"
     "        dist.barrier()\n"),
    ("get_rank_group",
     "def f(t, g):\n    r = dist.get_rank(g)\n    if r:\n        return\n"
     "    dist.all_reduce(t)\n",
     ["MXL-D005"],
     "@collective_seam\ndef decide(g):\n    return dist.get_rank(g) == 0\n"
     "def f(t, g):\n    if decide(g):\n        return\n"
     "    dist.all_reduce(t)\n"),
    ("current_device",
     "def f(t):\n    if torch.cuda.current_device() == 0:\n"
     "        dist.all_reduce(t)\n",
     ["MXL-D005"],
     "def f(t):\n    if torch.cuda.device_count() > 1:\n"
     "        dist.all_reduce(t)\n"),
    ("environ_RANK",
     "def f(t):\n    if os.environ['RANK'] == '0':\n"
     "        dist.broadcast(t, 0)\n",
     ["MXL-D005"],
     "def f(t):\n    if os.environ['WORLD_SIZE'] != '1':\n"
     "        dist.broadcast(t, 0)\n"),
    ("environ_get_LOCAL_RANK",
     "def f(t):\n    lr = int(os.environ.get('LOCAL_RANK', '0'))\n"
     "    for _ in range(lr):\n        dist.all_reduce(t)\n",
     ["MXL-D005"],
     "def f(t):\n    n = int(os.environ.get('MXTPU_NUM_WORKERS', '1'))\n"
     "    for _ in range(n):\n        dist.all_reduce(t)\n"),
    ("getenv_MXTPU_WORKER_RANK",
     "def save(tree, step):\n"
     "    host_save('/ckpt/%s' % os.getenv('MXTPU_WORKER_RANK'), tree, "
     "step)\n",
     ["MXL-D004"],
     "def save(tree, step):\n"
     "    host_save('/ckpt/%s' % os.getenv('MXTPU_RUN_ID'), tree, step)\n"),
    ("host_save",
     "def save(tree, step):\n"
     "    host_save('/ckpt/%d' % os.getpid(), tree, step)\n",
     ["MXL-D004"],
     "def save(path, tree, step):\n    host_save(path, tree, step)\n"),
    ("host_restore",
     "import tempfile\ndef load(tree):\n"
     "    return host_restore(tempfile.mkdtemp(), tree)\n",
     ["MXL-D004"],
     "def load(path, tree):\n    return host_restore(path, tree)\n"),
    ("reduce_scatter_tensor",
     "def f(o, t):\n    if dist.get_rank() == 0:\n"
     "        dist.reduce_scatter_tensor(o, t)\n",
     ["MXL-D005"],
     "def f(o, t):\n    dist.reduce_scatter_tensor(o, t)\n"),
    ("all_gather_into_tensor",
     "def f(o, t):\n    if dist.get_rank() == 0:\n"
     "        dist.all_gather_into_tensor(o, t)\n",
     ["MXL-D005"],
     "def f(o, t):\n    dist.all_gather_into_tensor(o, t)\n"),
    ("all_to_all_single",
     "def f(o, t):\n    try:\n        dist.all_to_all_single(o, t)\n"
     "    except RuntimeError:\n        pass\n",
     ["MXL-D006"],
     "def f(o, t):\n    try:\n        dist.all_to_all_single(o, t)\n"
     "    except RuntimeError:\n        raise\n"),
    ("new_group",
     "def f(ranks):\n    if dist.get_rank() in ranks:\n"
     "        return dist.new_group(ranks)\n",
     ["MXL-D005"],
     "def f(ranks):\n    return dist.new_group(ranks)\n"),
    ("monitored_barrier",
     "def f():\n    if torch.cuda.current_device():\n"
     "        dist.monitored_barrier()\n",
     ["MXL-D005"],
     "def f():\n    dist.monitored_barrier()\n"),
    ("parallel_collectives",
     "from mxnet_tpu_torch.parallel import collectives as C\n"
     "def f(group, xs, rank):\n    C.all_reduce(group, xs)\n"
     "    if rank:\n        return None\n"
     "    C.reduce_scatter(group, xs)\n"
     "    return C.all_to_all_autograd(group, xs, 0, 0)\n",
     ["MXL-D006"],
     "from mxnet_tpu_torch.parallel import collectives as C\n"
     "def f(group, xs):\n    C.all_reduce(group, xs)\n"
     "    C.reduce_scatter(group, xs)\n"
     "    return C.all_reduce_autograd(group, xs)\n"),
    ("dist_send",
     "def f(t):\n    if dist.get_rank() == 0:\n        dist.send(t, 1)\n",
     ["MXL-D005"],
     # a socket's send is no collective
     "def f(sock, b):\n    if dist.get_rank() == 0:\n"
     "        sock.send(b)\n"),
    ("dist_irecv",
     "def f(t, rank):\n    if rank == 1:\n"
     "        torch.distributed.irecv(t, 0).wait()\n",
     ["MXL-D005"],
     "def f(t, rank):\n    if rank == 1:\n        t.recv()\n"),
    ("dist_reduce",
     "def f(t):\n    if dist.get_rank():\n        dist.reduce(t, 0)\n",
     ["MXL-D005"],
     "import functools\ndef f(xs):\n    if dist.get_rank():\n"
     "        return functools.reduce(max, xs)\n"),
]


@pytest.mark.parametrize("name,fire,rules,clean", TWINS,
                         ids=[t[0] for t in TWINS])
def test_torch_vocabulary_twins(tmp_path, name, fire, rules, clean):
    got = lint(tmp_path, _HEAD + fire, tdiv.analyze_source_paths)
    assert rules_of(got) == rules, got
    assert lint(tmp_path, _HEAD + clean, tdiv.analyze_source_paths,
                "clean.py") == []
    # the JAX vocabulary alone does not see it: the torch entry fires
    assert jdiv.analyze_source_paths([str(tmp_path / "snippet.py")],
                                     root=str(tmp_path)) == []


def test_world_size_is_not_a_source(tmp_path):
    fs = lint(tmp_path, _HEAD + (
        "def f(t):\n    n = dist.get_world_size()\n    if n > 1:\n"
        "        return None\n    dist.all_reduce(t)\n"),
        tdiv.analyze_source_paths)
    assert fs == []


def test_kvstore_world_size_is_uniform():
    """``kvstore.global_barrier`` asks the world size alone (``_world_
    size``): the rank half of ``_dist_world`` made its early return look
    rank-divergent to the pass."""
    path = os.path.join(ROOT, "mxnet_tpu_torch", "kvstore.py")
    assert tdiv.analyze_source_paths([path], root=ROOT) == []
    import mxnet_tpu_torch.kvstore as kv
    assert kv._world_size() == 1 and kv._dist_world() == (1, 0)


# ----------------------------------------------------------------------
# markers and imports
# ----------------------------------------------------------------------
@pytest.mark.parametrize("marker", ["collective_seam", "thread_entry",
                                    "traced_scope"])
def test_markers_are_runtime_noops(marker):
    mark = getattr(tbase, marker)

    def f(x):
        return x + 1
    assert mark(f) is f
    assert mark(protocol="kv", static_argnames=("n",))(f) is f
    assert getattr(tan, marker) is mark


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "from mxnet_tpu_torch.analysis import divergence, concurrency,"
            " retrace\n"
            "import mxnet_tpu_torch.tools.mxlint\n"
            "assert not any(k == 'mxnet_tpu' or k.startswith('mxnet_tpu.')"
            " for k in sys.modules)\n"
            "print(len(divergence.analyze_source_paths(["
            "'tests/fixtures/divergence'])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == 6
