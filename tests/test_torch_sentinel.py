"""The trainer's in-step sentinel against the JAX package, on the CPU.

``ShardedTrainer(sentinel=True)`` on a small MLP (also with a BatchNorm,
whose moving statistics the gate keeps) and on a 2-layer LM, with
SGD-momentum and Adam, 5 steps from the same numpy weights and batches
in both packages, step 3 poisoned, in each fused mode of the port
(leafwise, the plain sweep, the kernel mode's plain version on the CPU):
the parameters and aux within 1e-5 of the JAX package's (relative to the
larger of 1 and its max-abs), ``sentinel_stats()`` equal exactly, and a
skipped step 3 bit for bit unchanged.  The LM's token ids turn into id 0
under the ``kind=nan`` fault in both packages (a finite step neither
skips); its skipped step comes from a token outside the vocabulary,
which both packages embed as a row of NaN.  Helpers are
``tests/test_torch_resilience.py``'s.
"""
import os

import pytest
import torch

from mxnet_tpu.resilience import faultinject as jfaultinject

from test_torch_resilience import (_arm, _batch, _clean_faults,  # noqa: F401
                                   _close, _equal_tree, _jax_trainer,
                                   _numpy, _port_trainer)


_JAX_RUNS = {}


def _jax_sentinel_run(model, kind, poison):
    """The JAX trainer's 5 sentinel steps of a case (run once a case: its
    result does not depend on the port's mode): the initial state, the
    counters after each step, the final parameters and aux (numpy)."""
    key = (model, kind, poison)
    if key not in _JAX_RUNS:
        batches = _sentinel_batches(model, poison)
        old = os.environ.get("MXTPU_FAULT_SPEC")
        if poison == "nan":
            os.environ["MXTPU_FAULT_SPEC"] = "step=3:kind=nan"
        jfaultinject.reset()
        try:
            jtr, (p, o, a), init = _jax_trainer(model, kind, sentinel=True)
            stats = []
            for b in batches:
                p, o, a, _ = jtr.step(p, o, a, jtr.shard_batch(b))
                stats.append(jtr.sentinel_stats())
        finally:
            if old is None:
                os.environ.pop("MXTPU_FAULT_SPEC", None)
            else:
                os.environ["MXTPU_FAULT_SPEC"] = old
            jfaultinject.reset()
        _JAX_RUNS[key] = (init, stats, _numpy(p), _numpy(a))
    return _JAX_RUNS[key]


def _sentinel_batches(model, poison):
    batches = [_batch(model, s) for s in range(5)]
    if poison == "token":
        batches[2] = _batch(model, 2, corrupt=True)
    return batches


_SENTINEL_CASES = [("mlp", "sgd", "nan"), ("mlp", "adam", "nan"),
                   ("mlp_bn", "sgd", "nan"), ("lm", "sgd", "nan"),
                   ("lm", "sgd", "token"), ("lm", "adam", "token")]


@pytest.mark.parametrize("mode", ["", "1", "kernel"])
@pytest.mark.parametrize("model,kind,poison", _SENTINEL_CASES)
def test_trainer_sentinel_matches_jax(monkeypatch, mode, model, kind,
                                      poison):
    """ShardedTrainer(sentinel=True), 5 steps, step 3 poisoned (the
    ``batch`` seam's kind=nan, or for the LM a token outside the
    vocabulary) in both packages: the parameters within 1e-5 of the JAX
    package's, sentinel_stats equal exactly, and a skipped step 3 bit
    for bit unchanged (parameters, optimizer state, aux)."""
    init, jstats, jparams, jaux = _jax_sentinel_run(model, kind, poison)
    monkeypatch.setenv("MXTPU_FUSED_OPT", mode)
    if poison == "nan":
        _arm(monkeypatch, "step=3:kind=nan")
    ttr, tp, to, ta = _port_trainer(model, kind, init, sentinel=True)
    tstats, trail = [], []
    for b in _sentinel_batches(model, poison):
        tp, to, ta, _outs = ttr.step(tp, to, ta, ttr.shard_batch(b))
        trail.append((_numpy(tp), _numpy(to), _numpy(ta)))
        tstats.append(ttr.sentinel_stats())
    assert tstats == jstats
    skipped = [s["skipped"] for s in tstats]
    if model == "lm" and poison == "nan":
        assert skipped == [0] * 5       # NaN ids are id 0 in both packages
    else:
        assert skipped == [0, 0, 1, 1, 1]
        assert tstats[2]["scale"] == tstats[1]["scale"] / 2
        assert tstats[-1]["last_good"] == 5
        for before, after in zip(trail[1], trail[2]):
            assert _equal_tree(before, after)
    for name, want in jparams.items():
        _close(trail[-1][0][name], want, 1e-5, name)
    for name, want in jaux.items():
        _close(trail[-1][2][name], want, 1e-5, name)
    assert all(torch.isfinite(v).all() for v in tp.values())
