"""Sequence parallelism in the port against the JAX package, on the CPU.

The twins of ``tests/test_ring_attention.py``'s ring and sp tests: the
JAX side runs on the 8 fake CPU devices ``tests/conftest.py`` sets up
(``shard_map`` over an sp axis, GSPMD for the trainer), the port's on
contexts ``cpu(0)`` ... ``cpu(7)`` that share the one CPU
(``parallel/sequence_parallel.py``: every member walks its ``(B/dp,
S/sp)`` block; ``ring_attention.ring_attention``: each hop the flash
forward's plain version here).  Inputs come from a numpy seed as float32
arrays; the port's trainers start from the JAX package's initial
weights.

Tolerances: the ring and ``blockwise_combine`` 1e-4 / 1e-5 (rtol / atol)
and their gradients 1e-3 / 1e-4, as ``tests/test_ring_attention.py``;
the dp x sp LM step and the sp predictor 1e-3 / 1e-4 against the JAX
sp step (the JAX test's own bound against one device) and 2e-6 of the
largest weight against the port's one-device step; the mirrored sp step
bit for bit the unmirrored one.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import ring_attention as jra
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ring_attention as tra
from mxnet_tpu_torch.parallel.sequence_parallel import SeqWalk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [tmx.cpu(i) for i in range(8)]


def _qkv(seed, B=2, H=2, S=32, D=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


def _chunks(x, n):
    return list(torch.from_numpy(x).chunk(n, dim=-2))


def _jax_ring(q, k, v, n_sp, causal):
    mesh = Mesh(np.array(jax.devices()[:n_sp]), ("sp",))
    spec = JP(None, None, "sp", None)
    return shard_map(
        lambda a, b, c: jra.ring_attention(a, b, c, axis_name="sp",
                                           causal=causal),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)(q, k, v)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _close(got, want, tol, what=""):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, (what, k,
                                                    np.abs(g - w).max())


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_jax_ring(causal):
    """``test_ring_attention.py:77-94``: sp=4, B=2, H=2, S=32, D=8; the
    port's ring over the members' chunks against the JAX ring under
    ``shard_map`` and against plain attention; each member runs one hop
    a chunk it may see (causal: its own and the earlier ones)."""
    q, k, v = _qkv(0)
    want = np.asarray(jax.jit(lambda a, b, c: _jax_ring(a, b, c, 4, causal))(
        q, k, v))
    tra.reset_ring_counts()
    got = tra.ring_attention(_chunks(q, 4), _chunks(k, 4), _chunks(v, 4),
                             causal=causal)
    got = torch.cat(got, dim=-2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    full = tra.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=1e-5)
    ref = tra.ring_attention_reference(_chunks(q, 4), _chunks(k, 4),
                                       _chunks(v, 4), causal=causal)
    np.testing.assert_allclose(torch.cat(ref, dim=-2).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    counts = tra.ring_counts()
    want_hops = {i: (i + 1 if causal else 4) for i in range(4)}
    assert counts["hops"] == want_hops
    assert sum(counts["skipped"].values()) == (6 if causal else 0)
    # one chunk of k and v a rotation, three rotations, all on one device
    chunk = q[..., :8, :].nbytes
    assert counts["bytes_sent"] == {i: 3 * 2 * chunk for i in range(4)}
    assert counts["bytes_peer"] == {}


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_combine_matches_jax(causal):
    """``blockwise_combine`` over four key blocks against the JAX one,
    with the query at a chunk's offset when causal."""
    q, k, v = _qkv(1)
    qc = q[..., 16:24, :]
    blocks = [(k[..., i:i + 8, :], v[..., i:i + 8, :])
              for i in range(0, 32, 8)]
    want = np.asarray(jra.blockwise_combine(qc, blocks, causal=causal,
                                            q_offset=16))
    got = tra.blockwise_combine(
        torch.from_numpy(qc),
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in blocks],
        causal=causal, q_offset=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_sp,causal,shape", [
    (2, False, (1, 1, 16, 4)), (4, True, (2, 2, 32, 8)),
    (4, False, (2, 2, 32, 8))])
def test_ring_gradients_match_the_jax_ring(n_sp, causal, shape):
    """``test_ring_attention.py:97-119``: the q, k and v gradients of
    ``sum(ring ** 2)``, the port's ring backward (the blockwise recompute
    of every hop, dk and dv handed back to their chunk's owner) against
    the JAX ring's under ``shard_map``."""
    q, k, v = _qkv(2, *shape)

    def loss(a, b, c):
        return jnp.sum(_jax_ring(a, b, c, n_sp, causal) ** 2)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    chunks = [list(t.chunk(n_sp, dim=-2)) for t in leaves]
    out = tra.ring_attention(*chunks, causal=causal)
    torch.stack([(o ** 2).sum() for o in out]).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-4)


def test_sharded_self_attention_under_a_context_matches_jax():
    """``sharded_self_attention`` of whole tensors under
    ``sequence_parallel`` on a dp=2 x sp=2 mesh (the batch split over
    dp, the ring over sp) against the JAX dispatch under its context."""
    q, k, v = _qkv(3, B=4, S=16)
    jmesh = jpar.make_mesh(jax.devices()[:4], dp=2, sp=2)
    with jra.sequence_parallel(jmesh):
        want = np.asarray(jax.jit(
            lambda a, b, c: jra.sharded_self_attention(a, b, c, causal=True))(
                q, k, v))
    mesh = tpar.make_mesh(CPUS[:4], dp=2, sp=2)
    with tra.sequence_parallel(mesh) as ctx:
        assert ctx.batch_axis == "dp" and ctx.rings() == [[0, 1], [2, 3]]
        got = tra.sharded_self_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    assert tra.current_sequence_parallel() is None
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def test_make_mesh_and_auto_mesh_with_sp_match_jax():
    """sp meshes' shapes and member order (sp inside dp, ``AXIS_ORDER``)
    against the JAX package's, the sp rings and dp groups, and the batch
    specs (the JAX ``batch_pspec``/``named_pspecs``: labels split over
    dp only there; the port's trainer splits them as the data)."""
    for kw in (dict(dp=2, sp=4), dict(dp=4, sp=2), dict(sp=8),
               dict(dp=-1, sp=2), dict(sp=2, dp=4)):
        mesh = tpar.make_mesh(CPUS, **kw)
        jmesh = jpar.make_mesh(jax.devices(), **kw)
        assert dict(mesh.shape) == dict(jmesh.shape), kw
        assert tuple(mesh.axis_names) == tuple(jmesh.axis_names), kw
    for kw in (dict(sp=2), dict(sp=4), dict(sp=2, tp=2)):
        assert dict(tpar.auto_mesh(devices=CPUS, **kw).shape) == \
            dict(jpar.auto_mesh(**kw).shape), kw
    mesh = tpar.make_mesh(CPUS, dp=2, sp=4)
    jmesh = jpar.make_mesh(jax.devices(), dp=2, sp=4)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for i in range(8):
        c = mesh.coords(i)
        assert ids[c["dp"], c["sp"]] == i
    assert mesh.axis_members(5, "sp") == [4, 5, 6, 7]
    assert mesh.axis_members(5, "dp") == [1, 5]
    for shape in ((8, 16), (8,), (8, 16, 4)):
        assert tuple(tpar.batch_pspec(shape, mesh, seq_axis=1)) == \
            tuple(jpar.batch_pspec(shape, jmesh, seq_axis=1)), shape
    shapes = {"data": (8, 16), "softmax_label": (8, 16), "w": (4, 4)}
    assert {k: tuple(v) for k, v in tpar.named_pspecs(
        shapes, mesh, seq_axis=1).items()} == \
        {k: tuple(v) for k, v in jpar.named_pspecs(
            shapes, jmesh, seq_axis=1).items()}


def test_sharded_array_places_and_assembles_over_dp_and_sp():
    """A (B, S) batch placed over dp=2 x sp=4: member (d, s) holds rows
    d and columns s of the blocks, and the array assembles back."""
    mesh = tpar.make_mesh(CPUS, dp=2, sp=4)
    x = np.arange(4 * 16, dtype=np.float32).reshape(4, 16)
    arr = tpar.sharding.place(x, mesh, tpar.batch_pspec(x.shape, mesh, 1))
    for i, s in enumerate(arr.shards):
        c = mesh.coords(i)
        np.testing.assert_array_equal(
            s.numpy(), x[2 * c["dp"]:2 * c["dp"] + 2,
                         4 * c["sp"]:4 * c["sp"] + 4])
    np.testing.assert_array_equal(np.asarray(arr), x)


# ----------------------------------------------------------------------
# the trainer and the predictor
# ----------------------------------------------------------------------
V, S, B = 20, 16, 4


def _lm_batch():
    r = np.random.RandomState(0)
    return {"data": r.randint(0, V, (B, S)).astype(np.float32),
            "softmax_label": r.randint(0, V, (B, S)).astype(np.float32)}


def _lm_sym(mx, **kw):
    return mx.models.transformer.get_symbol(vocab_size=V, num_layers=1,
                                            num_heads=2, dim=8, seq_len=S,
                                            **kw)


def _run(mx, par, sym, mesh, steps=1, start=None, seq_axis=1, **kw):
    """``steps`` SGD steps; returns the initial weights, the weights
    after, the last outputs and the trainer."""
    mx.random.seed(42)
    opt = mx.optimizer.create("sgd", learning_rate=0.1)
    tr = par.ShardedTrainer(sym, opt, mesh, seq_axis=seq_axis, **kw)
    p, s, a = tr.init_params(
        {"data": (B, S)}, label_shapes={"softmax_label": (B, S)},
        initializer=mx.init.Xavier(rnd_type="gaussian"))
    init = _np(p)
    if start is not None:
        p = tr.place_params(start)
    b = tr.shard_batch(_lm_batch())
    for _ in range(steps):
        p, s, a, out = tr.step(p, s, a, b)
    return init, _np(p), np.asarray(out[0]), tr


def test_lm_trainer_dp2_sp2_matches_jax():
    """``test_ring_attention.py:187-218``: the LM (1 layer, 2 heads, dim
    8, V=20, S=16, B=4) at dp=2 x sp=2 against the JAX sp step from the
    same weights: outputs in the global ``(B*S, V)`` row order and the
    weights after a step; and against the port at one device."""
    init, jp, jo, _ = _run(jmx, jpar, _lm_sym(jmx), jpar.make_mesh(
        jax.devices()[:4], dp=2, sp=2))
    _i, one, one_o, _ = _run(tmx, tpar, _lm_sym(tmx), tpar.make_mesh(
        CPUS[:1], dp=1), start=init, seq_axis=None)
    for kw in (dict(dp=2, sp=2), dict(dp=1, sp=4), dict(dp=2, sp=4)):
        n = int(np.prod(list(kw.values())))
        tra.reset_ring_counts()
        _i, got, out, tr = _run(tmx, tpar, _lm_sym(tmx), tpar.make_mesh(
            CPUS[:n], **kw), start=init)
        assert out.shape == (B * S, V)
        np.testing.assert_allclose(out, jo, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(out, one_o, rtol=1e-5, atol=1e-6)
        _close(got, jp, 1e-4, "LM %s against JAX sp" % kw)
        _close(got, one, 2e-6, "LM %s against one device" % kw)
        # forward and backward hops: the forward's and, again, the
        # backward's per chunk a member may see
        hops = tra.ring_counts()["hops"]
        assert set(hops) == set(range(n))
        assert tr.compiled_step_cost_analysis()["members"] == n


def test_sharded_predictor_with_seq_axis_matches_jax():
    """``ShardedPredictor(seq_axis=1)`` at dp=2 x sp=2 against the JAX
    one at the same mesh and against the port's one-device predictor,
    the label slot fed as zeros."""
    rng = np.random.RandomState(5)
    tsym = _lm_sym(tmx)
    shapes, _, _ = tsym.infer_shape(data=(B, S), softmax_label=(B, S))
    params = {n: (rng.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(tsym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    batch = {"data": _lm_batch()["data"],
             "softmax_label": np.zeros((B, S), np.float32)}
    want = jpar.ShardedPredictor(
        _lm_sym(jmx), jpar.make_mesh(jax.devices()[:4], dp=2, sp=2), params,
        seq_axis=1).predict(batch)[0]
    got = tpar.ShardedPredictor(tsym, tpar.make_mesh(CPUS[:4], dp=2, sp=2),
                                params, seq_axis=1).predict(batch)[0]
    one = tpar.ShardedPredictor(tsym, tpar.make_mesh(CPUS[:1], dp=1),
                                params).predict(batch)[0]
    assert got.shape == (B * S, V)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)


def test_use_flash_false_under_sp_matches_jax():
    """``MultiHeadAttention(use_flash=False)`` under sp gathers k and v
    over the ring and runs plain attention at the member's offset (the
    JAX package's GSPMD all-gathers them): the step against the JAX sp
    step and the port's one-device step."""
    def sym(mx):
        d = mx.sym.Variable("data")
        x = mx.sym.Embedding(d, input_dim=V, output_dim=8, name="emb")
        x = mx.sym.MultiHeadAttention(x, num_heads=2, causal=True,
                                      use_flash=False, name="att")
        x = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, 8)),
                                  num_hidden=V, name="head")
        lab = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(x, lab, name="softmax")
    init, jp, jo, _ = _run(jmx, jpar, sym(jmx), jpar.make_mesh(
        jax.devices()[:4], dp=2, sp=2), steps=2)
    _i, one, _o, _ = _run(tmx, tpar, sym(tmx), tpar.make_mesh(
        CPUS[:1], dp=1), steps=2, start=init, seq_axis=None)
    tra.reset_ring_counts()
    _i, got, out, _ = _run(tmx, tpar, sym(tmx), tpar.make_mesh(
        CPUS[:4], dp=2, sp=2), steps=2, start=init)
    assert tra.ring_counts()["hops"] == {}
    np.testing.assert_allclose(out, jo, rtol=1e-3, atol=1e-4)
    _close(got, jp, 1e-4, "use_flash=False against JAX sp")
    _close(got, one, 2e-6, "use_flash=False against one device")


def test_pos_table_sp_form_and_its_gradient():
    """``broadcast_add(tok, expand_dims(pos, 0))`` over sp=4: member j
    reads rows ``[j*S/4, (j+1)*S/4)`` of the replicated table, the
    result is the whole op's blocks bit for bit, and the table's
    gradient summed over the members is the whole op's."""
    from mxnet_tpu_torch.ops.registry import create_operator
    mesh = tpar.make_mesh(CPUS[:4], dp=1, sp=4)
    walk = SeqWalk(mesh, S, {"data": 1})
    rng = np.random.RandomState(6)
    tok = torch.from_numpy(rng.randn(2, S, 8).astype(np.float32))
    table = torch.from_numpy(rng.randn(S, 8).astype(np.float32))
    add = create_operator("broadcast_add")
    expand = create_operator("expand_dims", axis=0)

    def unsqueeze(t):
        return expand.forward([t], [], True, None)[0][0]
    whole_t = table.clone().requires_grad_(True)
    whole = add.forward([tok, unsqueeze(whole_t)], [], True, None)[0][0]
    (whole ** 2).sum().backward()
    # expand_dims of a block split over sp moves its sequence dimension
    blocks, lays = expand.forward_sp([[c] for c in tok.chunk(4, dim=1)],
                                     [1], walk)
    assert lays == [2] and tuple(blocks[0][0].shape) == (1, 2, S // 4, 8)
    leaves = [table.clone().requires_grad_(True) for _ in range(4)]
    outs, out_lays = add.forward_sp(
        [[c, unsqueeze(t)] for c, t in zip(tok.chunk(4, dim=1), leaves)],
        [1, None], walk)
    assert out_lays == [1]
    torch.testing.assert_close(torch.cat([o[0] for o in outs], dim=1),
                               whole.detach(), rtol=0, atol=0)
    torch.stack([(o[0] ** 2).sum() for o in outs]).sum().backward()
    for j, t in enumerate(leaves):
        lo, hi = j * S // 4, (j + 1) * S // 4
        assert torch.count_nonzero(t.grad[:lo]) == 0
        assert torch.count_nonzero(t.grad[hi:]) == 0
    torch.testing.assert_close(sum(t.grad for t in leaves), whole_t.grad,
                               rtol=1e-6, atol=1e-6)


def test_op_without_an_sp_form_raises_naming_it():
    """An op that would mix the sequence (``transpose`` moving it, a
    ``Reshape`` merging it with the features, ``sum`` over it) raises
    ``MXNetError`` naming the op; nothing gathers the sequence."""
    def graph(mx, kind):
        d = mx.sym.Variable("data")
        x = mx.sym.Embedding(d, input_dim=V, output_dim=8, name="emb")
        if kind == "transpose":
            x = mx.sym.transpose(x, axes=(0, 2, 1))
        elif kind == "reshape":
            x = mx.sym.Reshape(x, shape=(B, -1))
        else:
            x = mx.sym.broadcast_add(x, mx.sym.sum(x, axis=1,
                                                   keepdims=True))
        x = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, 8)),
                                  num_hidden=V, name="head")
        lab = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(x, lab, name="softmax")
    mesh = tpar.make_mesh(CPUS[:2], dp=1, sp=2)
    for kind, match in (("transpose", "transpose.*no sequence-parallel "
                         "form"),
                        ("reshape", "Reshape: sequence parallelism: .*"
                         "mixes the sequence"),
                        ("sum", "sum.*no sequence-parallel form")):
        tr = tpar.ShardedTrainer(graph(tmx, kind),
                                 tmx.optimizer.create("sgd"), mesh,
                                 seq_axis=1)
        p, s, a = tr.init_params({"data": (B, S)},
                                 label_shapes={"softmax_label": (B, S)})
        b = tr.shard_batch(_lm_batch())
        with pytest.raises(MXNetError, match=match):
            tr.step(p, s, a, b)


def test_what_sp_does_not_carry_raises_naming_its_item():
    """zero1, fsdp, tp and ep together with sp, and an sp axis without
    ``seq_axis``, raise naming item 3 (c2); sp across the processes of a
    group raises naming 3 (k) (``make_mesh``'s check)."""
    sym = _lm_sym(tmx)
    opt = tmx.optimizer.create("sgd")
    sp2 = tpar.make_mesh(CPUS[:4], dp=2, sp=2)
    for kw in (dict(zero1=True), dict(fsdp=True)):
        with pytest.raises(MXNetError, match=r"3 \(c2\)"):
            tpar.ShardedTrainer(sym, opt, sp2, seq_axis=1, **kw)
    with pytest.raises(MXNetError, match=r"without seq_axis.*3 \(c2\)"):
        tpar.ShardedTrainer(sym, opt, sp2)
    for kw in (dict(sp=2, tp=2), dict(sp=2, ep=2)):
        with pytest.raises(MXNetError, match=r"3 \(c2\)"):
            tpar.ShardedTrainer(sym, opt, tpar.make_mesh(CPUS[:4], **kw),
                                seq_axis=1)
    from mxnet_tpu_torch.parallel.mesh import _check_axes
    with pytest.raises(MXNetError, match=r"sp=2 .*3 \(k\)"):
        _check_axes(["dp", "sp"], [1, 2], 2)
    # seq_axis without an sp axis is the JAX package's no-op
    assert tpar.ShardedTrainer(sym, opt, tpar.make_mesh(CPUS[:2], dp=2),
                               seq_axis=1).sp == 1


def _walk_residual_bytes(tr, p, a, b):
    """Bytes one training walk of the sp trainer keeps for its backward
    (``executor.trace_residual_bytes``' count over the lockstep walk)."""
    texec._RESIDUALS.tensors = kept = []
    try:
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                texec._keep, lambda t: t):
            outs = tr._walk(p, a, b, None, True,
                            leaves=tr._full_leaves(p, True))
    finally:
        texec._RESIDUALS.tensors = None
    del outs
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in kept}
    return sum(seen.values())


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_mirrored_sp_step_equals_unmirrored_and_keeps_fewer_tensors(dropout):
    """``mirror_blocks=True`` on a dp=2 x sp=2 mesh: the steps bit for bit
    the unmirrored ones (each layer's segment recomputed on every member
    in lockstep in the backward, its ring with the same rotations, so
    its hops run twice; with dropout, its masks drawn again from the
    generators' states at the segment's start), and the walk keeps
    fewer bytes."""
    got, kept, hops = {}, {}, {}
    for mirror in (False, True):
        sym = tmx.models.transformer.get_symbol(
            vocab_size=V, num_layers=2, num_heads=2, dim=8, seq_len=S,
            mirror_blocks=mirror, dropout=dropout)
        mesh = tpar.make_mesh(CPUS[:4], dp=2, sp=2)
        tra.reset_ring_counts()
        _i, got[mirror], out, tr = _run(tmx, tpar, sym, mesh, steps=2)
        hops[mirror] = sum(tra.ring_counts()["hops"].values())
        p, s, a = tr.init_params({"data": (B, S)},
                                 label_shapes={"softmax_label": (B, S)})
        kept[mirror] = _walk_residual_bytes(tr, p, a,
                                            tr.shard_batch(_lm_batch()))
    for k in got[False]:
        np.testing.assert_array_equal(got[True][k], got[False][k],
                                      err_msg=k)
    assert hops[True] == 2 * hops[False]
    assert kept[True] < kept[False], kept


def test_long_context_example_runs_on_cpu_members():
    """``example/long-context-torch/train_lm_long.py`` at the JAX
    example's defaults on four CPU members (dp=2 x sp=2): its three
    assertions hold (the sp step matches one device, the mirrored
    residuals are smaller, the loss descends)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "example", "long-context-torch",
                                      "train_lm_long.py"), "--cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "long-context demo OK" in out.stderr


def test_new_modules_import_without_jax():
    """The sp modules import with JAX blocked, and a mirrored dp=1 x
    sp=2 LM step and the ring run there."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None\n"
            "import numpy as np, torch\n"
            "import mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.parallel.sequence_parallel\n"
            "from mxnet_tpu_torch.parallel import ring_attention as ra\n"
            "m = mx.parallel.make_mesh([mx.cpu(0), mx.cpu(1)], sp=2)\n"
            "sym = mx.models.transformer.get_symbol(vocab_size=16, "
            "num_layers=1, num_heads=2, dim=8, seq_len=4, "
            "mirror_blocks=True)\n"
            "tr = mx.parallel.ShardedTrainer(sym, mx.optimizer.create("
            "'sgd'), m, seq_axis=1)\n"
            "p, s, a = tr.init_params({'data': (2, 4)}, "
            "label_shapes={'softmax_label': (2, 4)})\n"
            "b = tr.shard_batch({'data': np.zeros((2, 4), np.float32), "
            "'softmax_label': np.zeros((2, 4), np.float32)})\n"
            "p, s, a, o = tr.step(p, s, a, b)\n"
            "q = [torch.zeros(1, 1, 2, 8)] * 2\n"
            "print(np.asarray(o[0]).shape, len(ra.ring_attention(q, q, q)))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(8,", "16)", "2"]
