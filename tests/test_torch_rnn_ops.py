"""The recurrent path's operators of the port against the JAX package, on
the CPU: SliceChannel, SwapAxis, Cast, transpose, the reductions
sum/max/min (and their ``*_axis`` aliases), the fused RNN op in every
mode, and SequenceLast/SequenceMask/SequenceReverse.

Each op runs on the same seeded numpy inputs (float32) in both
packages, with the vector-Jacobian product of a seeded cotangent
(``jax.vjp`` against ``torch.autograd.grad``; helpers of
``test_torch_resnet_ops.py``).  Tolerances, relative to the larger of 1
and the reference tensor's max-abs: forward 1e-5, gradients 1e-4 (the
op tests' own).  The RNN's plain loop (what the CPU runs) is also held
to ``torch.nn.LSTM``/``GRU``/``RNN`` fed the same flat parameters: the
layout the card's cuDNN route relies on.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import create_operator as jcreate
from mxnet_tpu.ops.rnn import rnn_param_size as j_param_size
from mxnet_tpu.ops.rnn import rnn_single_param_size as j_single_size
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.registry import create_operator as tcreate
from mxnet_tpu_torch.ops.rnn import (layer_params, rnn_param_size,
                                     rnn_reference, rnn_single_param_size)

from test_torch_resnet_ops import _check, _close, _run_both


def _both_shapes(op_name, attrs, shapes):
    t = tcreate(op_name, **attrs).infer_shape(list(shapes))
    j = jcreate(op_name, **attrs).infer_shape(list(shapes))
    norm = lambda r: tuple([tuple(map(int, s)) for s in part] for part in r)
    assert norm(t) == norm(j), (t, j)
    return t


# ----------------------------------------------------------------------
# SliceChannel / SwapAxis / Cast
# ----------------------------------------------------------------------
@pytest.mark.parametrize("attrs,shape", [
    (dict(num_outputs=4), (3, 8, 5)),
    (dict(num_outputs=2, axis=0), (6, 3)),
    (dict(num_outputs=5, axis=1, squeeze_axis=True), (4, 5, 3)),
    (dict(num_outputs=6, axis=2, squeeze_axis=True), (2, 4, 6)),
    (dict(num_outputs=3, axis=-1), (2, 9)),
])
def test_slice_channel_matches_jax(attrs, shape):
    rng = np.random.RandomState(len(shape) + attrs["num_outputs"])
    x = rng.randn(*shape).astype(np.float32)
    j, t = _run_both("SliceChannel", attrs, [x])
    assert len(t[0]) == attrs["num_outputs"]
    _check(j, t, ["data"])
    _both_shapes("SliceChannel", attrs, [shape])


def test_slice_channel_refuses_uneven():
    with pytest.raises(tmx.MXNetError, match="not divisible"):
        tcreate("SliceChannel", num_outputs=3).infer_shape([(2, 4)])


@pytest.mark.parametrize("dim1,dim2,shape", [(0, 1, (3, 4, 5)),
                                             (1, 2, (2, 3, 4)),
                                             (0, 3, (2, 3, 4, 5)),
                                             (1, 1, (3, 4))])
def test_swap_axis_matches_jax(dim1, dim2, shape):
    rng = np.random.RandomState(dim1 * 7 + dim2)
    x = rng.randn(*shape).astype(np.float32)
    attrs = dict(dim1=dim1, dim2=dim2)
    j, t = _run_both("SwapAxis", attrs, [x])
    _check(j, t, ["data"])
    _both_shapes("SwapAxis", attrs, [shape])


@pytest.mark.parametrize("dtype", ["float64", "float16", "int32"])
def test_cast_matches_jax(dtype):
    """The cast values bit for bit; for the float targets, the vjp of a
    seeded cotangent in the target dtype (cast back to float32)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5) * 10).astype(np.float32)
    jop = jcreate("Cast", dtype=dtype)
    top = tcreate("Cast", dtype=dtype)
    jout, jvjp = jax.vjp(lambda a: jop.forward([a], [], True, None)[0][0],
                         jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = top.forward([tx], [], True, None)[0][0]
    assert str(tout.dtype) == "torch." + dtype
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    if dtype == "int32":
        assert not tout.requires_grad
        return
    cot = rng.randn(4, 5).astype(dtype)
    jg, = jvjp(jnp.asarray(cot))
    tg, = torch.autograd.grad(tout, tx, torch.from_numpy(cot))
    assert tg.dtype == torch.float32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ----------------------------------------------------------------------
# transpose and the reductions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("axes,shape", [(None, (3, 4)), (None, (2, 3, 4)),
                                        ((1, 0, 2), (2, 3, 4)),
                                        ((2, 0, 1), (2, 3, 4))])
def test_transpose_matches_jax(axes, shape):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    attrs = {} if axes is None else dict(axes=axes)
    j, t = _run_both("transpose", attrs, [x])
    _check(j, t, ["data"])
    _both_shapes("transpose", attrs, [shape])


REDUCTIONS = [("sum", {}), ("sum_axis", dict(axis=1)),
              ("sum", dict(axis=(0, 2), keepdims=True)),
              ("sum", dict(axis=-1)), ("max", {}),
              ("max_axis", dict(axis=0)), ("max", dict(axis=2, keepdims=True)),
              ("min", {}), ("min_axis", dict(axis=1)),
              ("min", dict(axis=(1, 2))), ("sum", dict(keepdims=True))]


@pytest.mark.parametrize("name,attrs", REDUCTIONS)
def test_reduction_matches_jax(name, attrs):
    """Forward, shape (the (1,) of a full reduction) and the vjp; the
    max/min inputs carry ties, whose gradient both packages split
    evenly."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 4, 5).astype(np.float32)
    if name.startswith(("max", "min")):
        x = np.round(x)     # ties
    j, t = _run_both(name, attrs, [x])
    _check(j, t, ["data"])
    shapes = _both_shapes(name, attrs, [(3, 4, 5)])
    assert tuple(t[0][0].shape) == shapes[1][0]


# ----------------------------------------------------------------------
# the fused RNN op
# ----------------------------------------------------------------------
def _rnn_inputs(mode, layers, bidir, seq=5, batch=3, in_size=4, hidden=6,
                seed=0):
    rng = np.random.RandomState(seed)
    ndir = 2 if bidir else 1
    n = rnn_param_size(layers, in_size, hidden, bidir, mode)
    ins = [rng.randn(seq, batch, in_size).astype(np.float32),
           (rng.randn(n) * 0.3).astype(np.float32),
           rng.randn(ndir * layers, batch, hidden).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(ndir * layers, batch, hidden).astype(np.float32))
    return ins


RNN_CASES = [(m, l, b, so) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
             for l in (1, 2) for b in (False, True) for so in (False, True)
             if not (so is False and (l, b) == (2, True))]


@pytest.mark.parametrize("mode,layers,bidir,state_outputs", RNN_CASES)
def test_rnn_op_matches_jax(mode, layers, bidir, state_outputs):
    """Outputs (and final states) and the gradients of data, flat
    parameters, initial state (and cell): every mode, 1 and 2 layers,
    both directions, with and without ``state_outputs``."""
    ins = _rnn_inputs(mode, layers, bidir, seed=layers * 3 + bidir)
    attrs = dict(state_size=6, num_layers=layers, mode=mode,
                 bidirectional=bidir, state_outputs=state_outputs)
    j, t = _run_both("RNN", attrs, ins)
    names = tcreate("RNN", **attrs).list_arguments()
    assert len(t[0]) == len(tcreate("RNN", **attrs).list_outputs())
    _check(j, t, names)
    shapes = _both_shapes("RNN", attrs, [ins[0].shape] + [None] * (
        len(names) - 1))
    assert [tuple(s) for s in shapes[0]] == [x.shape for x in ins]


def test_rnn_param_size_matches_jax():
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for layers in (1, 2, 3):
            for bidir in (False, True):
                for in_size, hidden in ((4, 6), (200, 200), (16, 48)):
                    assert rnn_param_size(layers, in_size, hidden, bidir,
                                          mode) == j_param_size(
                        layers, in_size, hidden, bidir, mode)
                assert rnn_single_param_size(7, 5, mode) == \
                    j_single_size(7, 5, mode)
    # the bi-LSTM sort example's parameter vector
    assert rnn_param_size(1, 16, 48, True, "lstm") == \
        2 * 4 * 48 * (48 + 16 + 2)


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 2, True), ("gru", 2, False), ("rnn_tanh", 1, True),
    ("rnn_relu", 2, False)])
def test_rnn_reference_matches_torch_nn(mode, layers, bidir):
    """The flat layout is ``torch.nn.LSTM``/``GRU``/``RNN``'s own weight
    order: the plain loop on a module's weights gives the module's
    outputs, final states and (through the views) its weight
    gradients."""
    torch.manual_seed(0)
    seq, batch, in_size, hidden = 6, 3, 5, 4
    cls = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU}.get(mode)
    if cls is None:
        net = torch.nn.RNN(in_size, hidden, layers, bidirectional=bidir,
                           nonlinearity=mode[4:])
    else:
        net = cls(in_size, hidden, layers, bidirectional=bidir)
    flat = torch.cat([w.detach().reshape(-1) for w in net._flat_weights])
    flat.requires_grad_(True)
    ndir = 2 if bidir else 1
    x = torch.randn(seq, batch, in_size)
    h0 = torch.randn(ndir * layers, batch, hidden)
    c0 = torch.randn(ndir * layers, batch, hidden)
    got = rnn_reference(mode, x, flat, h0, c0, layers, bidir)
    want = net(x, (h0, c0) if mode == "lstm" else h0)
    want = (want[0],) + (tuple(want[1]) if mode == "lstm" else (want[1],))
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w.detach().numpy(), 1e-5)
    cot = torch.randn(seq, batch, ndir * hidden)
    (got[0] * cot).sum().backward()
    (want[0] * cot).sum().backward()
    views = layer_params(flat.grad, layers, in_size, hidden, bidir, mode)
    for mine, w in zip([v for grp in views for v in grp], net._flat_weights):
        _close(mine.numpy(), w.grad.numpy(), 1e-4)


def test_rnn_dropout_between_layers():
    """``p`` drops between layers in training only, from the op's
    generator: the same seed gives the same output; inference ignores
    it."""
    ins = [torch.from_numpy(a) for a in _rnn_inputs("lstm", 2, False)]
    op = tcreate("RNN", state_size=6, num_layers=2, mode="lstm", p=0.5)
    plain = tcreate("RNN", state_size=6, num_layers=2, mode="lstm")
    run = lambda o, train, seed: o.forward(
        ins, [], train, torch.Generator().manual_seed(seed))[0][0]
    assert torch.equal(run(op, True, 1), run(op, True, 1))
    assert not torch.equal(run(op, True, 1), run(plain, True, 1))
    assert torch.equal(run(op, False, 1), run(plain, False, 1))


def test_rnn_refuses_wrong_parameter_count():
    ins = [torch.from_numpy(a) for a in _rnn_inputs("gru", 1, False)]
    ins[1] = ins[1][:-1]
    with pytest.raises(tmx.MXNetError, match="parameters"):
        tcreate("RNN", state_size=6, num_layers=1, mode="gru").forward(
            ins, [], False, None)


# ----------------------------------------------------------------------
# the sequence ops
# ----------------------------------------------------------------------
SEQ_OPS = [("SequenceLast", {}), ("SequenceMask", {}),
           ("SequenceMask", dict(value=-2.5)), ("SequenceReverse", {})]


@pytest.mark.parametrize("name,extra", SEQ_OPS)
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("shape", [(6, 4), (6, 4, 3), (5, 3, 2, 2)])
def test_sequence_op_matches_jax(name, extra, use_len, shape):
    """Forward and vjp with and without ``sequence_length`` (lengths 0
    to seq_len, whose gradient is zero in both)."""
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    attrs = dict(extra, use_sequence_length=use_len)
    ins = [x]
    if use_len:
        lengths = np.array([shape[0], 0, 3, 1, 2][:shape[1]], np.float32)
        ins.append(lengths)
    j, t = _run_both(name, attrs, ins)
    _check(j, t, tcreate(name, **attrs).list_arguments())
    _both_shapes(name, attrs, [shape] + [None] * use_len)
