"""The port's trainer telemetry against the JAX package's, on the CPU.

``ShardedTrainer.compiled_step_cost_analysis()["flops"]`` is the model
FLOPs of one training step, counted from the bound graph's shapes
(``parallel/flops.py``).  It is held two ways, on a small LM (2 layers,
dim 32, 2 heads, vocab 64, seq 16, batch 2) and on a small ResNet
(ResNet-18's CIFAR stem and units at (3, 16, 16), 10 classes, batch 2):

- **exactly** against a hand count written out below, product by
  product (a multiply-add is 2, a step is 3 forwards);
- against XLA's cost analysis of the JAX trainer's whole step
  (``mxnet_tpu``'s ``compiled_step_cost_analysis()["flops"]``, its plain
  path on the CPU) on the same graph, within a band.  Measured on this
  CPU: XLA / port = 1.0782 for the LM and 0.7975 for the ResNet.  For
  the LM XLA counts more because it also counts elementwise work: the
  softmax over the vocabulary and over the attention scores, the
  LayerNorms, the mask, the bias adds, the optimizer update.  For the
  ResNet it counts less: its convolution count skips the window taps
  that fall on the zero padding (most of a 3x3 window at 4x4 and 2x2,
  where stages 3 and 4 run; XLA's forward alone counts 422.8 M against
  the port's 559.6 M), while BatchNorm, ReLU and the update add back a
  little.  Bands: LM [1.0, 1.2], ResNet [0.7, 0.9].

``emit_telemetry_counters`` emits the JAX trainer's field names but
``hbm_bytes_per_step`` (the port has no count of bytes before the static
roofline, ``ROADMAP.md`` queue 1 item 4 (g)), with ``BENCH_PEAK_TFLOPS``
set on both sides; with the in-step sentinel on, both emit the same
``sentinel`` counter.
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as jmx
from mxnet_tpu.observability import counters as jcounters
from mxnet_tpu.observability import events as jevents
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.observability import aggregate as tagg
from mxnet_tpu_torch.observability import counters as tcounters
from mxnet_tpu_torch.observability import events as tevents
from mxnet_tpu_torch.parallel import ShardedTrainer as TTrainer
from mxnet_tpu_torch.parallel.flops import forward_flops, step_flops

LM = dict(vocab_size=64, num_layers=2, num_heads=2, dim=32, seq_len=16)
LM_B = 2
RESNET = dict(num_classes=10, num_layers=18, image_shape=(3, 16, 16))
RESNET_B = 2
#: XLA's count over the port's: (low, high) by model (module docstring)
BANDS = {"lm": (1.0, 1.2), "resnet": (0.7, 0.9)}


def lm_hand_count(B, S, V, L, E, ffn=4):
    """The LM's step, written out: per layer the qkv projection (E to
    3E), q k^T and p v over the full S x S scores (2 B S S E each), the
    output projection and the two FFN products; then the head."""
    tokens = B * S
    per_layer = (2 * tokens * E * 3 * E + 2 * B * S * S * E
                 + 2 * B * S * S * E + 2 * tokens * E * E
                 + 2 * tokens * E * ffn * E + 2 * tokens * ffn * E * E)
    return 3 * (L * per_layer + 2 * tokens * E * V)


def resnet18_hand_count(B, H, classes):
    """ResNet-18's CIFAR-stem step at H x H, convolution by convolution:
    a convolution is 2 * output elements * (input channels * taps)."""
    def conv(c_in, c_out, hw, taps):
        return 2 * B * c_out * hw * hw * c_in * taps
    fwd = conv(3, 64, H, 9)                               # conv0
    c_in, hw = 64, H
    for c_out, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        hw //= stride
        fwd += conv(c_in, c_out, hw, 9)                   # unit1 conv1
        fwd += conv(c_out, c_out, hw, 9)                  # unit1 conv2
        fwd += conv(c_in, c_out, hw, 1)                   # unit1 shortcut
        fwd += 2 * conv(c_out, c_out, hw, 9)              # unit2
        c_in = c_out
    fwd += 2 * B * 512 * classes                          # fc1
    return 3 * fwd


def _lm_batch():
    rng = np.random.RandomState(0)
    S, V = LM["seq_len"], LM["vocab_size"]
    return {"data": rng.randint(0, V, (LM_B, S)).astype(np.float32),
            "softmax_label": rng.randint(0, V, (LM_B, S)).astype(np.float32)}


def _resnet_batch():
    rng = np.random.RandomState(0)
    return {"data": rng.rand(RESNET_B, *RESNET["image_shape"])
            .astype(np.float32),
            "softmax_label": rng.randint(0, 10, (RESNET_B,))
            .astype(np.float32)}


def _jax_step(sym, batch, **kw):
    opt = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    tr = JTrainer(sym, opt, jmake_mesh(jax.devices()[:1], dp=1), **kw)
    p, s, a = tr.init_params(
        {"data": batch["data"].shape},
        label_shapes={"softmax_label": batch["softmax_label"].shape})
    assert tr.compiled_step_cost_analysis() is None
    b = tr.shard_batch(batch)
    for _ in range(3):
        p, s, a, _o = tr.step(p, s, a, b)
    return tr


def _port_step(sym, batch, **kw):
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    tr = TTrainer(sym, opt, ctx=tmx.cpu(), **kw)
    tmx.random.seed(0)
    p, s, a = tr.init_params(
        {"data": batch["data"].shape},
        label_shapes={"softmax_label": batch["softmax_label"].shape})
    assert tr.compiled_step_cost_analysis() is None
    b = tr.shard_batch(batch)
    for _ in range(3):
        p, s, a, _o = tr.step(p, s, a, b)
    return tr


@pytest.fixture(scope="module")
def trainers():
    """One JAX and one port trainer a model, each after 3 steps."""
    out = {}
    for name, get, dims, batch in (
            ("lm", "transformer", LM, _lm_batch()),
            ("resnet", "resnet", RESNET, _resnet_batch())):
        out[name] = (
            _jax_step(getattr(jmx.models, get).get_symbol(**dims), batch),
            _port_step(getattr(tmx.models, get).get_symbol(**dims), batch))
    return out


@pytest.mark.parametrize("model", ["lm", "resnet"])
def test_step_flops_exact_against_the_hand_count(trainers, model):
    want = lm_hand_count(LM_B, LM["seq_len"], LM["vocab_size"],
                         LM["num_layers"], LM["dim"]) if model == "lm" \
        else resnet18_hand_count(RESNET_B, 16, 10)
    _j, port = trainers[model]
    assert port.compiled_step_cost_analysis() == {"flops": float(want)}
    if model == "lm":
        assert want == 5505024
    else:
        assert want == 1678897152


@pytest.mark.parametrize("model", ["lm", "resnet"])
def test_step_flops_within_the_band_of_xla(trainers, model):
    jtr, port = trainers[model]
    xla = float(jtr.compiled_step_cost_analysis()["flops"])
    ratio = xla / port.compiled_step_cost_analysis()["flops"]
    lo, hi = BANDS[model]
    assert lo <= ratio <= hi, (model, xla, ratio)


def test_flops_of_every_product_op():
    """``forward_flops`` on one graph of each counted op, against the
    formula of the module docstring (Deconvolution, dot, batch_dot,
    the fused RNN; the LM and the ResNet cover the rest)."""
    sym = tmx.sym
    x = sym.Variable("data")
    net = sym.Deconvolution(x, num_filter=4, kernel=(3, 3), stride=(2, 2),
                            no_bias=True, name="de")
    assert forward_flops(net, {"data": (2, 3, 5, 5)}) == \
        2 * (2 * 3 * 5 * 5) * (4 * 9)
    a, b = sym.Variable("a"), sym.Variable("b")
    assert forward_flops(sym.dot(a, b, transpose_b=True),
                         {"a": (6, 7), "b": (5, 7)}) == 2 * 6 * 5 * 7
    assert forward_flops(sym.dot(a, b, transpose_a=True),
                         {"a": (7, 6), "b": (7, 5)}) == 2 * 6 * 5 * 7
    assert forward_flops(sym.batch_dot(a, b), {"a": (3, 4, 5),
                                               "b": (3, 5, 6)}) \
        == 2 * 3 * 4 * 6 * 5
    rnn = sym.RNN(x, sym.Variable("p"), sym.Variable("s"),
                  sym.Variable("c"), state_size=8, num_layers=2,
                  bidirectional=True, mode="lstm", name="rnn")
    T, B, I, H = 5, 3, 4, 8
    want = 2 * 2 * T * B * 4 * H * (I + H) \
        + 2 * 2 * T * B * 4 * H * (2 * H + H)
    assert forward_flops(rnn, {"data": (T, B, I)}) == want
    assert step_flops(rnn, {"data": (T, B, I)}) == 3 * want


@pytest.mark.parametrize("sentinel", [False, True])
def test_emit_telemetry_counters_fields(monkeypatch, tmp_path, sentinel):
    """The same field names as the JAX trainer's ``trainer_cost``
    counter but ``hbm_bytes_per_step``; the port's MFU at the overridden
    peak; the ``sentinel`` counter, equal in both packages, when the
    in-step sentinel is on."""
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "0.001")
    emitted = {}
    for name, ev, co, make in (("jax", jevents, jcounters, _jax_step),
                               ("port", tevents, tcounters, _port_step)):
        monkeypatch.setenv("MXTPU_TELEMETRY", "1")
        monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path / name))
        ev.refresh()
        co.reset()
        pkg = jmx if name == "jax" else tmx
        tr = make(pkg.models.transformer.get_symbol(**LM), _lm_batch(),
                  sentinel=sentinel)
        fields = tr.emit_telemetry_counters(step_time_s=0.01)
        ev.flush()
        recs = tagg.read_events(str(tmp_path / name))
        emitted[name] = (fields, recs)
        monkeypatch.delenv("MXTPU_TELEMETRY")
        ev.refresh()
        co.reset()
    jf, jrecs = emitted["jax"]
    tf, trecs = emitted["port"]
    assert set(tf) == set(jf) - {"hbm_bytes_per_step"}
    assert tf["flops_per_step"] == 5505024.0
    assert tf["mfu"] == round(5505024.0 / 0.01 / 1e9, 4)
    assert tf["step_time_s"] == jf["step_time_s"] == 0.01
    assert tf["step_sketch"]["n"] == jf["step_sketch"]["n"] == 3

    def counters(recs):
        return {r["name"]: {k: v for k, v in r.items()
                            if k not in ("wall_ms", "run_id", "mono_ms",
                                         "hbm_bytes_per_step")}
                for r in recs if r["kind"] == "counter"}
    jc, tc = counters(jrecs), counters(trecs)
    assert sorted(tc) == sorted(jc) == (["sentinel", "trainer_cost"]
                                        if sentinel else ["trainer_cost"])
    assert set(tc["trainer_cost"]) == set(jc["trainer_cost"])
    if sentinel:
        assert tc["sentinel"] == jc["sentinel"]
        assert tc["sentinel"]["skipped"] == 0
        assert tc["sentinel"]["good_steps"] == 3


def test_emit_telemetry_counters_off_and_before_a_step(monkeypatch,
                                                       tmp_path):
    """Telemetry off: ``{}``, nothing emitted; an unknown card's peak
    (the CPU) emits the FLOPs without an MFU."""
    tr = TTrainer(tmx.models.transformer.get_symbol(**LM),
                  tmx.optimizer.create("sgd", learning_rate=0.1),
                  ctx=tmx.cpu())
    assert tr.emit_telemetry_counters(step_time_s=0.01) == {}
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path))
    tevents.refresh()
    try:
        assert tcounters.emit_trainer_counters(tr, 0.01) == {}
        tr2 = _port_step(tmx.models.transformer.get_symbol(**LM),
                         _lm_batch())
        tcounters.reset()
        got = tcounters.emit_trainer_counters(tr2, 0.01)
        assert got == {"flops_per_step": 5505024.0, "step_time_s": 0.01}
    finally:
        monkeypatch.delenv("MXTPU_TELEMETRY")
        monkeypatch.delenv("MXTPU_TELEMETRY_DIR")
        tevents.refresh()
