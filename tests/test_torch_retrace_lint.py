"""The port's retrace-stability lint (``mxnet_tpu_torch/analysis/
retrace.py``, MXL-X001..X006) against the JAX package's.

Every snippet that ``tests/test_retrace_lint.py`` lints and the fixture
under ``tests/fixtures/retrace/`` go through both analyzers with equal
``(rule, severity, anchor, line)`` lists; so does the whole
``mxnet_tpu/`` tree, but for :data:`TORCH_ONLY`.  Each torch entry of the
vocabulary — torch's trace wrappers as traced scopes, the port's build
caches as cache keys, its program builds and compiles as constructions,
a ``torch.compile``d name as a jitted entry — has a firing twin and a
clean one, and the port lints itself clean (its elementwise optimizers'
``update_fn`` marked ``traced_scope``).
"""
import os

import pytest

from mxnet_tpu.analysis import retrace as jret
from mxnet_tpu_torch.analysis import retrace as tret

from test_torch_divergence_lint import (ROOT, both, fixture_files, lint,
                                        reference_snippets, rows,
                                        rules_of)
from mxnet_tpu import analysis as jan
from mxnet_tpu_torch import analysis as tan

REFERENCE = os.path.join(ROOT, "tests", "test_retrace_lint.py")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "retrace")

#: (anchor, rule) of the findings over ``mxnet_tpu/`` that only the torch
#: vocabulary makes (none: the JAX tree calls no torch compile and keeps
#: no build cache under the port's names)
TORCH_ONLY = set()

SNIPPETS = reference_snippets(REFERENCE, {"_lint"})


def test_the_reference_snippets_were_found():
    assert len(SNIPPETS) == 31


@pytest.mark.parametrize("case,fname,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_reference_snippet_parity(tmp_path, case, fname, code):
    j, t = both(tmp_path, fname, code, jret.analyze_retrace_paths,
                tret.analyze_retrace_paths)
    assert t == j


@pytest.mark.parametrize("path", fixture_files(FIXTURES),
                         ids=os.path.basename)
def test_fixture_parity(path):
    j = rows(jret.analyze_retrace_paths([path], root=ROOT),
             jan.RULE_REGISTRY)
    t = rows(tret.analyze_retrace_paths([path], root=ROOT),
             tan.RULE_REGISTRY)
    assert j and t == j


def test_jax_tree_parity():
    pkg = [os.path.join(ROOT, "mxnet_tpu")]
    j = rows(jret.analyze_retrace_paths(pkg, root=ROOT), jan.RULE_REGISTRY)
    t = rows(tret.analyze_retrace_paths(pkg, root=ROOT), tan.RULE_REGISTRY)
    extra = [r for r in t if (r[2], r[0]) in TORCH_ONLY]
    assert sorted({(r[2], r[0]) for r in extra}) == sorted(TORCH_ONLY)
    assert [r for r in t if r not in extra] == j


@pytest.fixture(scope="module")
def port_findings():
    return tret.analyze_retrace_paths(
        [os.path.join(ROOT, "mxnet_tpu_torch")], root=ROOT)


def test_port_self_lint_clean(port_findings):
    fs = port_findings
    assert fs == [], [(f["rule"], f["anchor"], f["line"]) for f in fs]


def test_update_fns_are_traced_scopes(tmp_path):
    """The optimizers' formulas are what the generated sweep bakes: a
    Python branch on a tensor's value added to one is a finding."""
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "optimizer.py")).read()
    bad = src.replace("        g = grad + wd * weight\n        if state is "
                      "None:", "        g = grad + wd * weight\n        if "
                      "g.sum() > 0:\n            g = -g\n        if state is "
                      "None:", 1)
    assert bad != src
    got = lint(tmp_path, bad, tret.analyze_retrace_paths, "optimizer.py")
    assert [(f["rule"], f["anchor"]) for f in got] == [
        ("MXL-X001", "optimizer.py:SGD.update_fn")]


# ----------------------------------------------------------------------
# the torch vocabulary: a firing twin and a clean twin each
# ----------------------------------------------------------------------
_HEAD = ("import torch\n"
         "from mxnet_tpu_torch.base import traced_scope\n"
         "from mxnet_tpu_torch.kernels import nvrtc, sweep_codegen, _build\n"
         "from mxnet_tpu_torch.executor import build_program\n"
         "from mxnet_tpu_torch.rtc import Rtc\n")

_BRANCH = ("def f(x):\n    if x.sum() > 0:\n        return x\n"
           "    return -x\n")
_STATIC = ("def f(x):\n    if x.shape[0] > 0:\n        return x\n"
           "    return -x\n")

#: (name, firing snippet, its rules, clean twin, the JAX analyzer sees
#: it too)
TWINS = [
    ("torch_compile_scope", _BRANCH + "g = torch.compile(f)\n",
     ["MXL-X001"], _STATIC + "g = torch.compile(f)\n", False),
    ("jit_trace_scope", _BRANCH + "g = torch.jit.trace(f, (x0,))\n",
     ["MXL-X001"], _STATIC + "g = torch.jit.trace(f, (x0,))\n", False),
    ("jit_script_scope", _BRANCH + "g = torch.jit.script(f)\n",
     ["MXL-X001"], _STATIC + "g = torch.jit.script(f)\n", False),
    ("make_graphed_callables_scope",
     _BRANCH + "g = torch.cuda.make_graphed_callables(f, (x0,))\n",
     ["MXL-X001"],
     _STATIC + "g = torch.cuda.make_graphed_callables(f, (x0,))\n", False),
    ("torch_compile_decorator", "@torch.compile\n" + _BRANCH, ["MXL-X001"],
     "@torch.compile\n" + _STATIC, False),
    ("plans_key",
     "_PLANS = {}\ndef plan(q):\n    key = (id(q), q.shape)\n"
     "    if key not in _PLANS:\n        _PLANS[key] = make(q)\n"
     "    return _PLANS[key]\n", ["MXL-X002"],
     "_PLANS = {}\ndef plan(q):\n    key = (q.device.index, q.shape)\n"
     "    if key not in _PLANS:\n        _PLANS[key] = make(q)\n"
     "    return _PLANS[key]\n", False),
    ("rtc_compiled_key",
     "class K:\n    def compile(self, shapes, opts):\n"
     "        k = self._compiled.get(tuple(opts.items()))\n"
     "        self._compiled[tuple(opts.items())] = k\n", ["MXL-X002"],
     "class K:\n    def compile(self, shapes, opts):\n"
     "        k = self._compiled.get(tuple(sorted(opts.items())))\n"
     "        self._compiled[tuple(sorted(opts.items()))] = k\n", False),
    ("programs_key",
     "_PROGRAMS = {}\ndef program(opt):\n    return _PROGRAMS[id(opt)]\n",
     ["MXL-X002"],
     "_PROGRAMS = {}\ndef program(opt):\n"
     "    return _PROGRAMS[type(opt).__name__]\n", False),
    ("built_key",
     "_BUILT = {}\ndef built(src, flags):\n"
     "    return _BUILT[(src, frozenset(flags))]\n", ["MXL-X002"],
     "_BUILT = {}\ndef built(src, flags):\n"
     "    return _BUILT[(src, tuple(sorted(flags)))]\n", False),
    ("sweep_codegen_cache_key",
     "def k(opt):\n    return sweep_codegen.cache_key(tuple(vars(opt)"
     ".items()))\n", ["MXL-X002"],
     "def k(opt):\n    return sweep_codegen.cache_key(tuple(sorted(vars("
     "opt).items())))\n", True),
    ("torch_compiled_entry_scalar",
     "def f(x, lr):\n    return x * lr\nstep = torch.compile(f)\n"
     "def drive(x):\n    return step(x, 0.5)\n", ["MXL-X004"],
     "def f(x, lr):\n    return x * lr\nstep = torch.compile(f)\n"
     "def drive(x):\n    return step(x, torch.tensor(0.5))\n", False),
]
#: X003: each construction on a step path fires; in a builder it does not
CONSTRUCTIONS = [
    ("build_program", "build_program(sym)"),
    ("compile_cubin", "nvrtc.compile_cubin(src)"),
    ("Rtc", "Rtc(src, pallas=True)"),
    ("build_all", "_build.build_all()"),
    ("CUDAGraph", "torch.cuda.CUDAGraph()"),
    ("torch_compile", "torch.compile(fn)"),
    ("jit_trace", "torch.jit.trace(fn, (x,))"),
    ("sweep_codegen_program", "sweep_codegen.program(opt)"),
]
for _name, _expr in CONSTRUCTIONS:
    TWINS.append((
        "construct_" + _name,
        "class S:\n    def step(self, sym, src, fn, opt, x):\n"
        "        k = %s\n        return k\n" % _expr, ["MXL-X003"],
        "class S:\n    def _build(self, sym, src, fn, opt, x):\n"
        "        return %s\n"
        "    def step(self, sym, src, fn, opt, x):\n"
        "        if self._k is None:\n"
        "            self._k = %s\n        return self._k\n" % (_expr, _expr),
        False))


@pytest.mark.parametrize("name,fire,rules,clean,jax_too", TWINS,
                         ids=[t[0] for t in TWINS])
def test_torch_vocabulary_twins(tmp_path, name, fire, rules, clean,
                                jax_too):
    got = lint(tmp_path, _HEAD + fire, tret.analyze_retrace_paths)
    assert rules_of(got) == rules, got
    assert lint(tmp_path, _HEAD + clean, tret.analyze_retrace_paths,
                "clean.py") == []
    seen = jret.analyze_retrace_paths([str(tmp_path / "snippet.py")],
                                      root=str(tmp_path))
    assert bool(seen) == jax_too, seen


def test_re_compile_is_no_construction(tmp_path):
    fs = lint(tmp_path, "import re\nclass S:\n    def step(self, pat):\n"
              "        return re.compile(pat)\n", tret.analyze_retrace_paths)
    assert fs == []


def test_x004_and_x006_find_nothing_in_the_port(port_findings):
    """The port compiles nothing with ``torch.compile`` and donates no
    buffer: the two JAX rules stay for parity and find nothing."""
    assert not [f for f in port_findings
                if f["rule"] in ("MXL-X004", "MXL-X006")]
    src = "".join(open(os.path.join(dp, f)).read()
                  for dp, _d, fns in os.walk(
                      os.path.join(ROOT, "mxnet_tpu_torch"))
                  for f in fns if f.endswith(".py"))
    assert "torch.compile(" not in src.replace("``torch.compile(", "")
