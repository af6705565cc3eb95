"""The unrolled recurrent language models of the port against the JAX
package, on the CPU.

``models.lstm``, ``models.gru`` and ``models.rnn`` of
``mxnet_tpu_torch``: the same JSON as ``mxnet_tpu.models``' (so the
same names, parameter for parameter), each package loading the other's;
then at hidden 8, embed 8, vocab 20, seq 5, 2 layers and batch 3, one
training forward and the gradient of every parameter and initial state
from the same seeded numpy weights and tokens, ones as head gradients
(``executor.build_program`` against the JAX package's
``_build_program``), in float32.  ``LSTMInferenceModel`` of
``example/rnn-torch/rnn_model.py`` steps the one-step symbol token by
token and must give the unrolled graph's distributions (the twin of
``tests/test_examples.py::test_lstm_inference_model_matches_unrolled``).

Tolerances: softmax outputs within 1e-5, each gradient within 1e-4 of
the larger of 1 and its max-abs (sums in another order), the stepped
inference within 1e-5 of the unrolled graph.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.executor import _build_program as j_build_program

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.executor import build_program as t_build_program

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, S, V, H, E, B = 2, 5, 20, 8, 8, 3

#: (module, unroll function, init-state names per layer)
MODELS = [("lstm", "lstm_unroll", ("init_c", "init_h")),
          ("gru", "gru_unroll", ("init_h",)),
          ("rnn", "rnn_unroll", ("init_h",))]


def _symbols(module, fn, *args, **kwargs):
    out = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            out.append(getattr(getattr(mx.models, module), fn)(*args,
                                                                **kwargs))
    return tuple(out)


def _state_names(states):
    return ["l%d_%s" % (i, s) for s in states for i in range(L)]


@pytest.mark.parametrize("module,fn,states", MODELS)
@pytest.mark.parametrize("seq_len,dropout", [(S, 0.0), (3, 0.5)])
def test_unrolled_symbols_match_jax(module, fn, states, seq_len, dropout):
    js, ts = _symbols(module, fn, L, seq_len, V, num_hidden=H, num_embed=E,
                      num_label=V, dropout=dropout)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    shapes = dict(data=(B, seq_len), softmax_label=(B, seq_len),
                  **{n: (B, H) for n in _state_names(states)})
    got = ts.infer_shape(**shapes)
    assert got == tuple([list(map(tuple, x)) for x in js.infer_shape(
        **shapes)])
    assert got[1] == [(B * seq_len, V)]
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert json.loads(jmx.sym.load_json(ts.tojson()).tojson()) \
        == json.loads(ts.tojson())
    jshapes = getattr(jmx.models, module).init_state_shapes(L, B, H)
    assert getattr(tmx.models, module).init_state_shapes(L, B, H) == jshapes


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_lstm_inference_symbol_matches_jax(dropout):
    js, ts = _symbols("lstm", "lstm_inference_symbol", L, V, H, E, V,
                      dropout=dropout)
    assert ts.tojson() == js.tojson()
    assert ts.list_outputs() == js.list_outputs()


def _seeded(ts, states, seed):
    rng = np.random.RandomState(seed)
    shapes = dict(data=(B, S), softmax_label=(B, S),
                  **{n: (B, H) for n in _state_names(states)})
    arg_shapes, _, _ = ts.infer_shape(**shapes)
    params, data = {}, {}
    for name, shape in zip(ts.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            data[name] = rng.randint(0, V, shape).astype(np.float32)
        elif name in shapes:
            data[name] = (rng.randn(*shape) * 0.5).astype(np.float32)
        else:
            params[name] = rng.uniform(-0.4, 0.4, shape).astype(np.float32)
    return params, data


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: max err %g > %g x %g" % (what, err, tol,
                                                            scale)


@pytest.mark.parametrize("module,fn,states", MODELS)
def test_unrolled_forward_and_gradients_match_jax(module, fn, states):
    js, ts = _symbols(module, fn, L, S, V, num_hidden=H, num_embed=E,
                      num_label=V)
    params, data = _seeded(ts, states, seed=len(module))
    init = {n: data[n] for n in _state_names(states)}
    feed = {k: v for k, v in data.items() if k not in init}
    wrt = dict(params, **init)
    jtrace = j_build_program(js, {}).trace
    ttrace = t_build_program(ts).trace

    def jf(p):
        args = dict({k: jnp.asarray(v) for k, v in feed.items()}, **p)
        return jtrace(args, {}, jax.random.PRNGKey(0), True)

    (jo, _ja), vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in wrt.items()})
    jg = vjp(([jnp.ones_like(o) for o in jo], {}))[0]

    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in wrt.items()}
    args = dict({k: torch.from_numpy(v) for k, v in feed.items()}, **leaves)
    to, _ta = ttrace(args, {}, None, True)
    names = list(leaves)
    tg = torch.autograd.grad(to, [leaves[n] for n in names],
                             [torch.ones_like(o) for o in to])
    assert to[0].shape == (B * S, V)
    _close(to[0].detach().numpy(), jo[0], 1e-5, module + " softmax")
    for n, g in zip(names, tg):
        _close(g.numpy(), jg[n], 1e-4, "%s grad %s" % (module, n))


def _example(path, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lstm_inference_model_matches_unrolled():
    """``LSTMInferenceModel`` (the one-step symbol bound once, its states
    carried from each output into the next step's inputs) gives the
    unrolled graph's per-position distributions, on the CPU."""
    rnn_model = _example("example/rnn-torch/rnn_model.py", "t_rnn_model")
    Vi, Hi, Ei, Li, Si = 30, 12, 8, 2, 5
    rng = np.random.RandomState(1)
    with tmx.cpu():
        unrolled = tmx.models.lstm.lstm_unroll(Li, Si, Vi, num_hidden=Hi,
                                               num_embed=Ei, num_label=Vi)
        shapes = {"data": (1, Si), "softmax_label": (1, Si)}
        shapes.update({"l%d_init_c" % i: (1, Hi) for i in range(Li)})
        shapes.update({"l%d_init_h" % i: (1, Hi) for i in range(Li)})
        exe = unrolled.simple_bind(tmx.cpu(), grad_req="null", **shapes)
        weights = {}
        for name, arr in exe.arg_dict.items():
            if name in ("data", "softmax_label") or name.endswith(
                    ("_init_c", "_init_h")):
                continue
            w = rng.uniform(-0.2, 0.2, arr.shape).astype(np.float32)
            arr[:] = w
            weights[name] = tmx.nd.array(w)
        toks = rng.randint(0, Vi, size=Si).astype(np.float32)
        exe.arg_dict["data"][:] = toks[None, :]
        want = exe.forward()[0].asnumpy()
        model = rnn_model.LSTMInferenceModel(Li, Vi, Hi, Ei, Vi,
                                             arg_params=weights)
        for t in range(Si):
            got = model.forward(np.array([toks[t]], np.float32),
                                new_seq=(t == 0))[0]
            np.testing.assert_allclose(got, want[t], rtol=0, atol=1e-5)
        # a new sequence starts from zero states again
        first = model.forward(np.array([toks[0]], np.float32),
                              new_seq=True)[0]
        np.testing.assert_allclose(first, want[0], rtol=0, atol=1e-5)
        assert len(rnn_model.sample(model, Vi, length=6)) == 6
