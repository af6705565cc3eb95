"""The microbatched pipeline (``parallel/pipeline.py``) in the port against
the JAX package, on the CPU.

The twins of ``tests/test_pipeline.py``: ``GPipeTrainer`` in the three
configurations of ``test_pipeline_matches_sequential`` and 1F1B at M=4
and 8, each against the JAX package's ``GPipeTrainer`` on the same
parameters and batches (the loss of each of 3 steps and the parameters
after them within 1e-5), and against its own unpipelined references:
``gpipe`` within 1e-5 of ``sequential_loss``, ``1f1b`` bit for bit
``sequential_loss_microbatched`` (the JAX package's own gate).  Then the
guards, ``from_block_symbol``, a checkpoint round trip, and
``build_1f1b_tables`` and ``schedule_occupancy`` equal to the JAX
package's for k in 2..8 and m in 1..16.  The JAX side runs on the fake
CPU devices of ``tests/conftest.py``; the port's stages are contexts
``cpu(0)`` ... of the one CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import pipeline as jpipe

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import pipeline as tpipe

D, V = 12, 8
CPUS = [tmx.cpu(i) for i in range(8)]


def _j_embed(ep, batch):
    return jnp.take(ep["table"], batch["tokens"].astype(jnp.int32), axis=0)


def _j_block(lp, h):
    return h + jnp.tanh(h @ lp["w"] + lp["b"])


def _j_head_loss(hp, h, batch):
    logp = jax.nn.log_softmax(h @ hp["w"])
    labels = batch["labels"].astype(jnp.int32)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def _t_embed(ep, batch):
    return ep["table"][batch["tokens"].long()]


def _t_block(lp, h):
    return h + torch.tanh(h @ lp["w"] + lp["b"])


def _t_head_loss(hp, h, batch):
    logp = torch.log_softmax(h @ hp["w"], dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()


def _params(rs, n_layers):
    return {
        "embed": {"table": rs.randn(V, D).astype(np.float32) * 0.1},
        "layers": {"w": rs.randn(n_layers, D, D).astype(np.float32) * 0.1,
                   "b": np.zeros((n_layers, D), np.float32)},
        "head": {"w": rs.randn(D, V).astype(np.float32) * 0.1},
    }


def _batch(rs, n):
    return {"tokens": rs.randint(0, V, (n,)).astype(np.int32),
            "labels": rs.randint(0, V, (n,)).astype(np.int32)}


def _pair(cfg, layers, micro, schedule, lr=0.1):
    rs = np.random.RandomState(0)
    params = _params(rs, layers)
    n = int(np.prod(list(cfg.values())))
    jtr = jpipe.GPipeTrainer(
        _j_embed, _j_block, _j_head_loss, params,
        jmake_mesh(jax.devices()[:n], **cfg),
        jopt.create("sgd", learning_rate=lr, momentum=0.9),
        num_microbatches=micro, schedule=schedule)
    ttr = tpipe.GPipeTrainer(
        _t_embed, _t_block, _t_head_loss, params,
        tpar.make_mesh(CPUS[:n], **cfg),
        tmx.optimizer.create("sgd", learning_rate=lr, momentum=0.9),
        num_microbatches=micro, schedule=schedule)
    return jtr, ttr, _batch(rs, micro * cfg.get("dp", 1) * 4)


def _params_close(jtr, ttr, tol=1e-5):
    jp = jax.tree_util.tree_map(np.asarray, jtr.params)
    tp = ttr.params
    for part in ("embed", "layers", "head"):
        for k in jp[part]:
            np.testing.assert_allclose(tp[part][k], jp[part][k], rtol=0,
                                       atol=tol, err_msg="%s/%s"
                                       % (part, k))


@pytest.mark.parametrize("cfg,layers,micro", [
    ({"pp": 4}, 4, 4),
    ({"pp": 2, "dp": 2}, 4, 2),
    ({"pp": 2}, 6, 5),      # layers > pp, microbatches != pp
])
def test_pipeline_matches_sequential(cfg, layers, micro):
    jtr, ttr, batch = _pair(cfg, layers, micro, "gpipe")
    ref = ttr.sequential_loss(batch)
    assert abs(ref - jtr.sequential_loss(batch)) < 1e-5
    losses = []
    for _ in range(3):
        j, t = jtr.step(batch), ttr.step(batch)
        assert abs(t - j) < 1e-5, (t, j)
        losses.append(t)
    assert abs(losses[0] - ref) < 1e-5, (losses[0], ref)
    _params_close(jtr, ttr)
    # training descends, and the pipelined loss still equals sequential
    for _ in range(6):
        last = ttr.step(batch)
    assert last < losses[0]
    ref_now = ttr.sequential_loss(batch)
    assert abs(ttr.step(batch) - ref_now) < 1e-4


@pytest.mark.parametrize("micro", [4, 8])
def test_1f1b_matches_microbatched_sequential(micro):
    """1F1B on four stages: the loss is bit for bit the unpipelined
    microbatched reference, and loss and parameters follow the JAX
    package's 1F1B trainer."""
    jtr, ttr, batch = _pair({"pp": 4}, 4, micro, "1f1b")
    ref = ttr.sequential_loss_microbatched(batch)
    got = ttr.step(batch)
    assert got == ref, (got, ref)
    assert abs(got - jtr.step(batch)) < 1e-5
    for _ in range(2):
        assert abs(ttr.step(batch) - jtr.step(batch)) < 1e-5
    _params_close(jtr, ttr)
    for _ in range(5):
        last = ttr.step(batch)
    assert last < got
    ref_now = ttr.sequential_loss_microbatched(batch)
    assert ttr.step(batch) == ref_now


def test_1f1b_with_dp_matches_jax():
    jtr, ttr, batch = _pair({"pp": 2, "dp": 2}, 4, 2, "1f1b")
    for _ in range(3):
        assert abs(ttr.step(batch) - jtr.step(batch)) < 1e-5
    _params_close(jtr, ttr)


def test_pipeline_apply_runs_the_forward_wave():
    rs = np.random.RandomState(4)
    p = _params(rs, 4)
    stage = [[torch.tensor(p["layers"]["b"][s * 2:(s + 1) * 2]),
              torch.tensor(p["layers"]["w"][s * 2:(s + 1) * 2])]
             for s in range(2)]
    mbs = [torch.tensor(rs.randn(3, D).astype(np.float32))
           for _ in range(4)]
    with torch.no_grad():
        outs, _ins, _o = tpipe.pipeline_apply(
            _t_block, stage, mbs, [torch.device("cpu")] * 2,
            rebuild=lambda leaves: {"b": leaves[0], "w": leaves[1]})
    for x, y in zip(mbs, outs):
        want = x
        for i in range(4):
            want = _t_block({"w": torch.tensor(p["layers"]["w"][i]),
                             "b": torch.tensor(p["layers"]["b"][i])}, want)
        assert torch.equal(y, want)


def test_pipeline_validations():
    rs = np.random.RandomState(2)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    with pytest.raises(ValueError, match="pp"):
        tpipe.GPipeTrainer(_t_embed, _t_block, _t_head_loss,
                           _params(rs, 4), tpar.make_mesh(CPUS[:2], dp=2),
                           opt)
    mesh = tpar.make_mesh(CPUS[:4], pp=4)
    with pytest.raises(ValueError, match="divide"):
        tpipe.GPipeTrainer(_t_embed, _t_block, _t_head_loss,
                           _params(rs, 3), mesh, opt)
    with pytest.raises(ValueError, match="pp >= 2"):
        tpipe.GPipeTrainer(_t_embed, _t_block, _t_head_loss,
                           _params(rs, 2), tpar.make_mesh(CPUS[:1], pp=1),
                           opt, schedule="1f1b")
    with pytest.raises(ValueError, match="schedule"):
        tpipe.GPipeTrainer(_t_embed, _t_block, _t_head_loss,
                           _params(rs, 4), mesh, opt, schedule="zb")


def test_pipeline_batch_divisibility_validated():
    rs = np.random.RandomState(3)
    tr = tpipe.GPipeTrainer(_t_embed, _t_block, _t_head_loss,
                            _params(rs, 4), tpar.make_mesh(CPUS[:4], pp=4),
                            tmx.optimizer.create("sgd", learning_rate=0.1),
                            num_microbatches=3)
    with pytest.raises(ValueError, match="num_microbatches"):
        tr.step(_batch(rs, 8))


def _cell(mx):
    x = mx.sym.Variable("data")
    return x + mx.sym.Activation(
        mx.sym.FullyConnected(x, num_hidden=D, name="fc"),
        act_type="tanh", name="act")


def test_pipeline_from_block_symbol():
    """A residual cell written in mx.sym runs pipelined, matches its own
    sequential evaluation, and its traced block equals the JAX package's
    on the same parameters."""
    rs = np.random.RandomState(5)
    kw = dict(embed_fn=_t_embed, head_loss_fn=_t_head_loss,
              embed_params={"table": rs.randn(V, D).astype(np.float32)
                            * 0.1},
              head_params={"w": rs.randn(D, V).astype(np.float32) * 0.1},
              input_shape=(D,), num_microbatches=4)
    tr = tpipe.GPipeTrainer.from_block_symbol(
        _cell(tmx), n_layers=4, mesh=tpar.make_mesh(CPUS[:4], pp=4),
        optimizer=tmx.optimizer.create("sgd", learning_rate=0.1,
                                       momentum=0.9), **kw)
    assert tr.params["layers"]["fc_weight"].shape == (4, D, D)
    batch = _batch(rs, 16)
    ref = tr.sequential_loss(batch)
    got = tr.step(batch)
    assert abs(got - ref) < 1e-5, (got, ref)
    for _ in range(8):
        last = tr.step(batch)
    assert last < got
    # the traced block against the JAX package's on the same layer
    lp = {k: v[0] for k, v in tr.params["layers"].items()}
    h = rs.randn(6, D).astype(np.float32)
    jtr = jpipe.GPipeTrainer.from_block_symbol(
        _cell(jmx), n_layers=2, mesh=jmake_mesh(jax.devices()[:2], pp=2),
        optimizer=jopt.create("sgd", learning_rate=0.1),
        embed_fn=_j_embed, head_loss_fn=_j_head_loss, embed_params={},
        head_params={}, input_shape=(D,))
    want = np.asarray(jtr._block_fn({k: jnp.asarray(v)
                                     for k, v in lp.items()},
                                    jnp.asarray(h)))
    with torch.no_grad():
        got = tr._block_fn({k: torch.tensor(v) for k, v in lp.items()},
                           torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_block_symbol_rejects_aux_and_rng():
    kw = dict(n_layers=2, mesh=tpar.make_mesh(CPUS[:2], pp=2),
              optimizer=tmx.optimizer.create("sgd", learning_rate=0.1),
              embed_fn=_t_embed, head_loss_fn=_t_head_loss,
              embed_params={}, head_params={}, input_shape=(D,))
    x = tmx.sym.Variable("data")
    with pytest.raises(ValueError, match="aux-free"):
        tpipe.GPipeTrainer.from_block_symbol(
            tmx.sym.BatchNorm(x, name="bn"), **kw)
    with pytest.raises(ValueError, match="rng-free"):
        tpipe.GPipeTrainer.from_block_symbol(
            tmx.sym.Dropout(x, p=0.5, name="dr"), **kw)
    with pytest.raises(ValueError, match="same"):
        tpipe.GPipeTrainer.from_block_symbol(
            tmx.sym.FullyConnected(x, num_hidden=D // 2, name="fc2"), **kw)
    # the LM's transformer block: its attention declares need_rng but
    # draws nothing at dropout 0, so it stacks; at dropout 0.1 it draws
    from mxnet_tpu_torch.models.transformer import transformer_block
    kw.update(input_shape=(4, D))
    tr = tpipe.GPipeTrainer.from_block_symbol(
        transformer_block(x, "blk", 2, D, 4), **kw)
    assert tr.params["layers"]["blk_att_qkv_weight"].shape == (2, 3 * D, D)
    with pytest.raises(ValueError, match="rng-free"):
        tpipe.GPipeTrainer.from_block_symbol(
            transformer_block(x, "blk", 2, D, 4, dropout=0.1), **kw)


def test_pipeline_block_symbol_guards():
    """Underdetermined shapes and parameter-free blocks fail with named
    errors, and construction leaves the global mx.random stream
    intact."""
    kw = dict(n_layers=2, mesh=tpar.make_mesh(CPUS[:2], pp=2),
              optimizer=tmx.optimizer.create("sgd", learning_rate=0.1),
              embed_fn=_t_embed, head_loss_fn=_t_head_loss,
              embed_params={}, head_params={}, input_shape=(D,))
    x = tmx.sym.Variable("data")
    with pytest.raises(ValueError, match="no parameters"):
        tpipe.GPipeTrainer.from_block_symbol(
            x + tmx.sym.Activation(x, act_type="tanh", name="a"), **kw)
    with pytest.raises(ValueError, match="underdetermined"):
        tpipe.GPipeTrainer.from_block_symbol(
            tmx.sym.dot(x, tmx.sym.Variable("w")), **kw)
    with tmx.cpu():
        tmx.random.seed(123)
        want = tmx.random.uniform(shape=(4,)).asnumpy()
        tmx.random.seed(123)
        tpipe.GPipeTrainer.from_block_symbol(_cell(tmx), **kw)
        got = tmx.random.uniform(shape=(4,)).asnumpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_checkpoint_resume(tmp_path, schedule):
    """Save mid-training, restore into a FRESH trainer, and the next step
    matches a never-stopped twin (momentum state and update counter
    both resume)."""
    def make(seed=7):
        rs = np.random.RandomState(seed)
        return tpipe.GPipeTrainer(
            _t_embed, _t_block, _t_head_loss, _params(rs, 4),
            tpar.make_mesh(CPUS[:4], pp=4),
            tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            num_microbatches=4, schedule=schedule)

    batch = _batch(np.random.RandomState(9), 16)
    tr = make()
    for _ in range(3):
        tr.step(batch)
    tr.save_checkpoint(tmp_path / "ck")
    ref_next = tr.step(batch)
    fresh = make(seed=99)
    fresh.load_checkpoint(tmp_path / "ck")
    assert fresh.num_update == 3
    assert fresh.step(batch) == ref_next


def test_1f1b_tables_and_occupancy_match_jax():
    for k in range(2, 9):
        for m in range(1, 17):
            jk, jm = jpipe.build_1f1b_tables(k, m)
            tk, tm = tpipe.build_1f1b_tables(k, m)
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_array_equal(tm, jm)
            for sched in ("1f1b", "gpipe"):
                assert tpipe.schedule_occupancy(k, m, sched) == \
                    jpipe.schedule_occupancy(k, m, sched)
    with pytest.raises(ValueError):
        tpipe.build_1f1b_tables(0, 4)


def test_schedule_record_is_emitted(monkeypatch):
    """The first step emits one "schedule" record (the one
    ``observability.aggregate`` rolls up), as the JAX trainer does."""
    from mxnet_tpu_torch.observability import events
    got = []
    monkeypatch.setenv("MXTPU_TELEMETRY", "1")
    monkeypatch.setattr(events, "emit",
                        lambda kind, step=None, **f: got.append((kind, f)))
    _jtr, ttr, batch = _pair({"pp": 2}, 2, 4, "1f1b")
    ttr.step(batch)
    ttr.step(batch)
    assert [f for k, f in got if k == "schedule"] == [{
        "schedule": "1f1b", "stages": 2, "microbatches": 4,
        "bubble_fraction": round(
            ttr.schedule_occupancy()["bubble_fraction"], 4)}]
