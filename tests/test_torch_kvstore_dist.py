"""The port's dist kvstores against the JAX package's, and two worker
processes joined over gloo, on the CPU.

The twins of ``tests/test_kvstore.py``'s type, single-process dist and
invalid-type tests, then two workers started with ``tools/launch.py``'s
env (``build_env``: ``MXTPU_COORDINATOR`` on a port the OS hands out,
never the JAX drills' 9899-9901) running ``kvstore.create("dist_sync")``:
push/pull sums over both, ``barrier``, bucketed ``push_async``, the
optimizer on the store, the heartbeat, ``ShardedTrainer`` on a dp mesh
spanning the two processes (BatchNorm's statistics summed across them),
and ``Module.fit(kvstore="dist_sync")`` with each worker on half of each
batch against one worker at the whole batch; a ``Module`` bound on two
contexts before the store starts the group raises in ``init_optimizer``.

Tolerances: sums and barrier exact; two workers' parameters equal each
other bit for bit; against one process at the global batch within 2e-6
of each tensor's max-abs (float32 sums in other orders).
"""
import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import launch  # noqa: E402

SHAPE = (4, 4)
TOL = 2e-6


def test_get_type_and_ranks():
    for mx in (jmx, tmx):
        kv = mx.kv.create("local_allreduce_cpu")
        assert (kv.type, kv.rank, kv.num_workers) == \
            ("local_allreduce_cpu", 0, 1)
        dkv = mx.kv.create("dist_async")
        assert (dkv.type, dkv.rank, dkv.num_workers) == ("dist_async", 0, 1)


def test_dist_sync_single_process():
    """No launch env: a dist store of one worker, in both packages."""
    outs = {}
    for mx in (jmx, tmx):
        with mx.cpu():
            kv = mx.kv.create("dist_sync")
            assert kv.num_workers == 1 and kv.rank == 0
            kv.init(9, mx.nd.ones(SHAPE))
            kv.push(9, mx.nd.ones(SHAPE) * 3)
            out = mx.nd.zeros(SHAPE)
            kv.pull(9, out=out)
            kv.barrier()
            assert kv.dead_nodes() == []
            outs[mx] = out.asnumpy()
    np.testing.assert_array_equal(outs[tmx], outs[jmx])
    np.testing.assert_array_equal(outs[tmx], np.full(SHAPE, 3.0))


def test_invalid_type():
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError):
            mx.kv.create("nosuchstore")


def test_partial_launch_env_raises_as_the_jax_package(monkeypatch):
    """MXTPU_COORDINATOR without the worker count and rank: the JAX
    package's error, word for word."""
    monkeypatch.setenv("MXTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("MXTPU_NUM_WORKERS", raising=False)
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    msgs = []
    for mod in (jmx.kvstore, tmx.kvstore):
        with pytest.raises(Exception) as err:
            mod._maybe_init_distributed()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "MXTPU_NUM_WORKERS is missing" in msgs[1]


def test_backend_follows_the_device_and_never_hides_cuda_in_gloo(
        monkeypatch):
    """gloo without CUDA; gloo for CPU and NCCL for CUDA tensors with
    it; CUDA without NCCL raises rather than sending through gloo."""
    import torch
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.kvstore._backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert tmx.kvstore._backend() == "cpu:gloo,cuda:nccl"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(tmx.base.MXNetError, match="no NCCL"):
        tmx.kvstore._backend()


def test_server_role_parks():
    """A process launched as a parameter server parks at import and
    exits 0, before any code after the import runs."""
    env = dict(os.environ, DMLC_ROLE="server", PYTHONPATH=ROOT)
    env.pop("MXTPU_COORDINATOR", None)
    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch; print('trained')"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "trained" not in out.stdout


WORKER = r'''
import json, sys
import numpy as np
import mxnet_tpu_torch as mx

out_dir = sys.argv[1]
# a Module bound on two contexts before a dist store starts the group
sharded = mx.mod.Module(mx.models.get_mlp(num_classes=2, hidden=(8,)),
                        context=[mx.cpu(0), mx.cpu(1)])
sharded.bind([("data", (4, 6))], [("softmax_label", (4,))])
kv = mx.kv.create("dist_sync")
rank, n = kv.rank, kv.num_workers
res = {"rank": rank, "workers": n, "sharded": sharded._exec_group.sharded}
# its in-step sum would miss the other worker: the optimizer refuses it
with mx.cpu():
    sharded.init_params()
    try:
        sharded.init_optimizer(kvstore=kv)
    except mx.base.MXNetError as e:
        res["sharded_raise"] = str(e)
with mx.cpu():
    kv.init(3, mx.nd.ones((2, 3)) * (rank + 7))
    got = mx.nd.zeros((2, 3))
    kv.pull(3, out=got)
    res["init"] = got.asnumpy().tolist()          # rank 0's value
    kv.push(3, [mx.nd.ones((2, 3)) * (rank + 1)] * 2)
    kv.pull(3, out=got)
    res["sum"] = got.asnumpy().tolist()
    kv.barrier()
    # bucketed push_async: many keys, a tiny bucket target
    for k in range(10, 16):
        kv.init(k, mx.nd.zeros((5,)))
    for k in range(10, 16):
        kv.push_async(k, mx.nd.ones((5,)) * (k + rank))
    kv.wait_all()
    outs = [mx.nd.zeros((5,)) for _ in range(10, 16)]
    for k, o in zip(range(10, 16), outs):
        kv.pull(k, out=o)
    res["async"] = [o.asnumpy().tolist() for o in outs]
    # the optimizer on the store: every worker keeps the same weight
    kv2 = mx.kv.create("dist_sync")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    kv2.init(0, mx.nd.ones((3,)))
    for step in range(3):
        kv2.push(0, mx.nd.array(np.arange(3) * (rank + 1.0) + step))
    w = mx.nd.zeros((3,))
    kv2.pull(0, out=w)
    res["opt"] = w.asnumpy().tolist()
    res["dead"] = kv.dead_nodes()

    # ShardedTrainer on a dp mesh across the two processes (BatchNorm)
    data = mx.sym.Variable("data")
    bn = mx.sym.BatchNorm(data, name="bn")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(bn, num_hidden=3,
                                                     name="fc"),
                               name="softmax")
    mesh = mx.parallel.make_mesh([mx.cpu()], dp=-1)
    res["mesh"] = dict(mesh.shape)
    tr = mx.parallel.ShardedTrainer(net, mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8),
        mesh)
    mx.random.seed(rank)          # rank 0's weights are broadcast
    p, s, a = tr.init_params({"data": (8, 5)},
                             label_shapes={"softmax_label": (8,)})
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5).astype(np.float32) * 2 + 1
    y = rng.randint(0, 3, 8).astype(np.float32)
    half = slice(4 * rank, 4 * rank + 4)
    b = tr.shard_batch({"data": x[half], "softmax_label": y[half]})
    for _ in range(3):
        p, s, a, o = tr.step(p, s, a, b)
    np.savez(out_dir + "/trainer%d.npz" % rank,
             **{k: np.asarray(v) for k, v in list(p.items())
                + list(a.items())})

    # Module.fit: each worker half of every batch of 2 x 4
    X = rng.randn(32, 6).astype(np.float32)
    Y = (X.sum(1) > 0).astype(np.float32)
    mine = X.reshape(4, 2, 4, 6)[:, rank].reshape(-1, 6)
    mine_y = Y.reshape(4, 2, 4)[:, rank].reshape(-1)
    init = np.load(out_dir + "/init.npz")
    mod = mx.mod.Module(mx.models.get_mlp(num_classes=2, hidden=(8,)),
                        context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(mine, mine_y, batch_size=4),
            kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
            arg_params={k: mx.nd.array(init[k]) for k in init.files},
            num_epoch=2)
    np.savez(out_dir + "/module%d.npz" % rank,
             **{k: v.asnumpy() for k, v in mod.get_params()[0].items()})
with open(out_dir + "/res%d.json" % rank, "w") as f:
    json.dump(res, f)
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mlp_init():
    net = tmx.models.get_mlp(num_classes=2, hidden=(8,))
    rng = np.random.RandomState(9)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(data=(8, 6))[0]))
    return {n: rng.uniform(-0.2, 0.2, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def test_two_workers_over_gloo(tmp_path):
    """Two dist_sync workers launched with ``tools/launch.py``'s env."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    init = _mlp_init()
    np.savez(tmp_path / "init.npz", **init)
    args = argparse.Namespace(coordinator="127.0.0.1", port=_free_port(),
                              num_workers=2)
    procs = []
    for rank in range(2):
        env = launch.build_env(rank, args)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env["MXTPU_BUCKET_MB"] = "0.00003"      # a bucket of 1-2 keys
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    res = [json.load(open(tmp_path / ("res%d.json" % r))) for r in range(2)]
    for r, got in enumerate(res):
        assert (got["rank"], got["workers"]) == (r, 2)
        assert got["init"] == [[7.0] * 3] * 2
        assert got["sum"] == [[6.0] * 3] * 2        # (1+1) + (2+2)
        assert got["async"] == [[2.0 * k + 1] * 5 for k in range(10, 16)]
        assert got["dead"] == []
        assert got["mesh"] == {"dp": 2}
        assert got["sharded"]
        assert "2 contexts in a process group of 2 processes" \
            in got["sharded_raise"]
    assert res[0]["opt"] == res[1]["opt"]

    # the optimizer on the store, in one process: the summed gradient
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    with tmx.cpu():
        kv.init(0, tmx.nd.ones((3,)))
        for step in range(3):
            kv.push(0, tmx.nd.array(np.arange(3) * 3.0 + 2 * step))
        w = tmx.nd.zeros((3,))
        kv.pull(0, out=w)
    np.testing.assert_allclose(res[0]["opt"], w.asnumpy(), rtol=1e-6)

    # the trainer: both processes equal, and equal one process at the
    # global batch (rank 0's initial weights)
    t = [dict(np.load(tmp_path / ("trainer%d.npz" % r))) for r in range(2)]
    for k in t[0]:
        np.testing.assert_array_equal(t[0][k], t[1][k])
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        bn = tmx.sym.BatchNorm(data, name="bn")
        net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            bn, num_hidden=3, name="fc"), name="softmax")
        tr = tmx.parallel.ShardedTrainer(net, tmx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 8),
            ctx=tmx.cpu())
        tmx.random.seed(0)
        p, s, a = tr.init_params({"data": (8, 5)},
                                 label_shapes={"softmax_label": (8,)})
        rng = np.random.RandomState(0)
        x = rng.randn(8, 5).astype(np.float32) * 2 + 1
        y = rng.randint(0, 3, 8).astype(np.float32)
        b = tr.shard_batch({"data": x, "softmax_label": y})
        for _ in range(3):
            p, s, a, o = tr.step(p, s, a, b)
    for k, v in list(p.items()) + list(a.items()):
        scale = max(1.0, float(np.abs(v.numpy()).max()))
        assert np.abs(t[0][k] - v.numpy()).max() <= TOL * scale, k

    # Module.fit: two workers at 4 == one worker at 8
    m = [dict(np.load(tmp_path / ("module%d.npz" % r))) for r in range(2)]
    for k in m[0]:
        np.testing.assert_array_equal(m[0][k], m[1][k])
    rng = np.random.RandomState(0)
    rng.randn(8, 5), rng.randint(0, 3, 8)
    X = rng.randn(32, 6).astype(np.float32)
    Y = (X.sum(1) > 0).astype(np.float32)
    with tmx.cpu():
        mod = tmx.mod.Module(tmx.models.get_mlp(num_classes=2, hidden=(8,)),
                             context=tmx.cpu())
        mod.fit(tmx.io.NDArrayIter(X, Y, batch_size=8), kvstore=None,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
                arg_params={k: tmx.nd.array(v) for k, v in init.items()},
                num_epoch=2)
        one = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in one:
        scale = max(1.0, float(np.abs(one[k]).max()))
        assert np.abs(m[0][k] - one[k]).max() <= TOL * scale, k
