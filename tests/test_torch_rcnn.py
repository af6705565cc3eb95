"""Faster R-CNN on the port against the JAX package, on the CPU.

- ``ROIPooling``: the twins of ``tests/test_vision_rnn_ops.py``'s two
  forward tests (numpy and the JAX op, 1e-5), forward and vjp against
  the JAX op (``_run_both``: 1e-5 and 1e-4 of the larger of 1 and the
  max-abs), and bins of tied maxima, whose gradient ``jnp.max`` splits
  evenly over the whole bin (a max over W then H would give 1/6, 1/6,
  1/6 and 1/2 where the bin's four zeros each get 1/4).
- The proposal stage (``example/rcnn-torch/proposal.py`` through the
  port's ``Custom`` op) against the JAX example's on identical inputs:
  the rois equal exactly.
- The whole graph of ``example/rcnn-torch/symbol.py`` at the example's
  defaults (128 x 128, 4 classes, 16 rois), three SGD steps (lr 1e-4:
  the example's 0.01 diverges by the third step) through both packages'
  executors from the same seeded float64 weights and inputs, moved as a
  0x112 file:
  the rois equal exactly, every output and gradient within 1e-9 of the
  tensor's max-abs (float64, so float32 rounding cannot reorder NMS).
- The example as a subprocess with ``--cpu``, and without it on a
  machine with no GPU (it must fail); the port's Custom op, vision ops
  and the example import with JAX blocked.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import create_operator as jcreate
from mxnet_tpu_torch.ops.registry import create_operator as tcreate

from test_torch_resnet_ops import _check, _close, _run_both
from test_vision_rnn_ops import _np_roipool

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
F64_TOL = 1e-9


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(subdir, tag):
    """``(proposal, symbol)`` modules of ``example/<subdir>``; the
    symbol module's ``import proposal`` gets this directory's."""
    d = os.path.join(REPO, "example", subdir)
    prop = _load(os.path.join(d, "proposal.py"), tag + "_proposal")
    saved = sys.modules.get("proposal")
    sys.modules["proposal"] = prop
    try:
        sym = _load(os.path.join(d, "symbol.py"), tag + "_symbol")
    finally:
        if saved is None:
            sys.modules.pop("proposal", None)
        else:
            sys.modules["proposal"] = saved
    return prop, sym


J_PROP, J_SYM = _example("rcnn", "jax_rcnn")
T_PROP, T_SYM = _example("rcnn-torch", "torch_rcnn")


# ----------------------------------------------------------------------
# ROIPooling
# ----------------------------------------------------------------------
def _roipool_port(data, rois, pooled, scale):
    op = tcreate("ROIPooling", pooled_size=pooled, spatial_scale=scale)
    return op.forward([torch.from_numpy(data), torch.from_numpy(rois)],
                      [], False, None)[0][0].numpy()


def test_roipooling_forward():
    rng = np.random.RandomState(99)
    data = rng.uniform(-1, 1, (2, 3, 12, 16)).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7],
                     [1, 2, 2, 15, 11],
                     [0, 4, 1, 10, 10]], np.float32)
    got = _roipool_port(data, rois, (3, 3), 1.0)
    np.testing.assert_allclose(got, _np_roipool(data, rois, (3, 3), 1.0),
                               rtol=1e-5, atol=1e-6)
    j, t = _run_both("ROIPooling", dict(pooled_size=(3, 3),
                                        spatial_scale=1.0), [data, rois])
    _check(j, t, ["data", "rois"])


def test_roipooling_scale_and_shape():
    rng = np.random.RandomState(98)
    data = rng.uniform(-1, 1, (1, 2, 8, 8)).astype(np.float32)
    rois = np.array([[0, 0, 0, 15, 15]], np.float32)
    got = _roipool_port(data, rois, (2, 2), 0.5)
    assert got.shape == (1, 2, 2, 2)
    np.testing.assert_allclose(got, _np_roipool(data, rois, (2, 2), 0.5),
                               rtol=1e-5, atol=1e-6)
    attrs = dict(pooled_size=(2, 2), spatial_scale=0.5)
    assert tcreate("ROIPooling", **attrs).infer_shape([(1, 2, 8, 8), (1, 5)]) \
        == jcreate("ROIPooling", **attrs).infer_shape([(1, 2, 8, 8), (1, 5)])


@pytest.mark.parametrize("pooled,scale,seed", [((7, 7), 1.0 / 16, 0),
                                               ((3, 2), 0.5, 1),
                                               ((2, 3), 1.0, 2)])
def test_roipooling_matches_jax(pooled, scale, seed):
    """Random rois (overlapping, some past the edge, half-pixel corners
    that round to even) on a map with runs of zeros, forward and vjp;
    the rois receive no gradient."""
    rng = np.random.RandomState(seed)
    n, c, h, w = 2, 4, 9, 11
    data = np.maximum(rng.randn(n, c, h, w), 0).astype(np.float32)
    span = 1.0 / scale
    x1 = rng.uniform(-2, w, 12) * span
    y1 = rng.uniform(-2, h, 12) * span
    rois = np.stack([rng.randint(0, n, 12), x1, y1,
                     x1 + rng.uniform(0, w, 12) * span,
                     y1 + rng.uniform(0, h, 12) * span], 1)
    rois[:3, 1:] = np.round(rois[:3, 1:] * scale) / scale + 0.5 * span
    rois = rois.astype(np.float32)
    j, t = _run_both("ROIPooling", dict(pooled_size=pooled,
                                        spatial_scale=scale), [data, rois])
    _check(j, t, ["data", "rois"])
    assert not t[2][1].any()


def test_roipooling_tied_bin_gradient_splits_over_the_bin():
    """The bin [[0, 0, 0], [0, -1, -1]] holds four tied zeros: each gets
    a quarter of the bin's gradient, as the JAX vjp gives (not the first
    argmax, and not a max over W then H)."""
    data = np.array([[[[0, 0, 0], [0, -1, -1]]]], np.float32)
    rois = np.array([[0, 0, 0, 2, 1]], np.float32)
    attrs = dict(pooled_size=(1, 1), spatial_scale=1.0)
    j, t = _run_both("ROIPooling", attrs, [data, rois])
    _check(j, t, ["data", "rois"])
    cot = np.random.RandomState(100).randn(1, 1, 1, 1)     # _run_both's
    np.testing.assert_allclose(
        t[2][0], np.float32(cot[0, 0, 0, 0]) / 4
        * np.array([[[[1, 1, 1], [1, 0, 0]]]], np.float32), rtol=1e-6)
    # zeros across whole bins of a ReLU'd, max-pooled map
    rng = np.random.RandomState(5)
    fmap = np.maximum(rng.randn(1, 3, 12, 12) - 0.8, 0).astype(np.float32)
    fmap[:, :, 2:8, 3:9] = 0.0
    rois = np.array([[0, 3, 2, 8, 7], [0, 0, 0, 11, 11],
                     [0, 2, 2, 9, 9], [0, 3, 2, 8, 7]], np.float32)
    j, t = _run_both("ROIPooling", dict(pooled_size=(3, 3),
                                        spatial_scale=1.0), [fmap, rois])
    _check(j, t, ["data", "rois"])
    assert (t[0][0][0] == 0).all()


# ----------------------------------------------------------------------
# the proposal stage
# ----------------------------------------------------------------------
def _proposal_inputs(seed, feat=8, anchors=9, size=128):
    rng = np.random.RandomState(seed)
    score = rng.randn(1, 2, anchors * feat, feat)
    e = np.exp(score - score.max(axis=1, keepdims=True))
    prob = (e / e.sum(axis=1, keepdims=True)).reshape(
        1, 2 * anchors, feat, feat).astype(np.float32)
    deltas = (0.2 * rng.randn(1, 4 * anchors, feat, feat)).astype(np.float32)
    im_info = np.array([[size, size, 1.0]], np.float32)
    return [prob, deltas, im_info]


@pytest.mark.parametrize("seed,post,output_score", [(0, 16, "False"),
                                                    (1, 300, "True"),
                                                    (2, 4, "False")])
def test_proposal_stage_matches_jax_exactly(seed, post, output_score):
    """The Custom ``proposal`` op of each package's example on the same
    inputs (post-NMS top n 16, 300 with padding, 4): rois equal bit for
    bit; the backward hands zeros to every input."""
    import jax
    import jax.numpy as jnp
    ins = _proposal_inputs(seed)
    attrs = dict(op_type="proposal", feat_stride="16",
                 output_score=output_score, rpn_post_nms_top_n=str(post),
                 rpn_pre_nms_top_n=str(4 * post))
    jop, top = jcreate("Custom", **attrs), tcreate("Custom", **attrs)
    j_outs, _ = jop.forward([jnp.asarray(x) for x in ins], [], True, None)
    t_ins = [torch.from_numpy(x).requires_grad_() for x in ins]
    t_outs, _ = top.forward(t_ins, [], True, None)
    assert len(t_outs) == (2 if output_score == "True" else 1)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert t_outs[0].shape == (post, 5)
    grads = torch.autograd.grad(t_outs[0].sum(), t_ins)
    assert all(not g.any() for g in grads)


# ----------------------------------------------------------------------
# the whole graph, three steps in float64
# ----------------------------------------------------------------------
def _graph_setup(size=128, classes=4, rois=16, seed=0):
    """Seeded float64 weights and inputs for the example's graph: normal
    weights, He-scaled in the backbone and the RPN's 3 x 3 convolution
    and at py-faster-rcnn's deviations in the heads (0.01 for the
    scores, 0.001 for the box deltas), small biases."""
    net = T_SYM.get_rcnn_symbol(num_classes=classes, rpn_post_nms_top_n=rois)
    shapes = {"data": (1, 3, size, size), "im_info": (1, 3),
                         "rpn_label": (1, 9 * (size // 16), size // 16),
                         "label": (rois,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    values = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name.endswith("weight"):
            std = np.sqrt(2.0 / int(np.prod(shape[1:])))
            if "bbox_pred" in name:
                std = 0.001
            elif "cls_score" in name:
                std = 0.01
            values[name] = rng.randn(*shape) * std
        elif name.endswith("bias"):
            values[name] = 0.01 * rng.randn(*shape)
    values["data"] = rng.rand(*shapes["data"])
    values["im_info"] = np.array([[size, size, 1.0]])
    values["rpn_label"] = rng.randint(-1, 2, shapes["rpn_label"]) * 1.0
    values["label"] = rng.randint(0, classes, (rois,)) * 1.0
    return net, shapes, values


def _bind64(mx, sym_mod, args, classes, rois):
    net = sym_mod.get_rcnn_symbol(num_classes=classes,
                                  rpn_post_nms_top_n=rois)
    grads = {n: mx.nd.zeros(args[n].shape, ctx=mx.cpu(), dtype=np.float64)
             for n in net.list_arguments()}
    return net.bind(mx.cpu(), args, args_grad=grads, grad_req="write")


def test_rcnn_graph_three_float64_steps_match_jax(tmp_path):
    """The weights and inputs reach the port as a 0x112 file the JAX
    package wrote."""
    classes, rois, lr = 4, 16, 1e-4
    net, _shapes, values = _graph_setup(classes=classes, rois=rois)
    jargs = {n: jmx.nd.array(v, ctx=jmx.cpu(), dtype=np.float64)
             for n, v in values.items()}
    path = str(tmp_path / "rcnn-0000.params")
    jmx.nd.save(path, jargs)
    with tmx.cpu():
        targs = tmx.nd.load(path)
    assert all(a.dtype == torch.float64 for a in targs.values())
    jex = _bind64(jmx, J_SYM, jargs, classes, rois)
    tex = _bind64(tmx, T_SYM, targs, classes, rois)
    assert tex._symbol.list_outputs() == jex._symbol.list_outputs()
    params = [n for n in net.list_arguments()
              if n.endswith(("weight", "bias"))]
    widths = []
    for step in range(3):
        jo = [o.asnumpy() for o in jex.forward(is_train=True)]
        to = [o.asnumpy() for o in tex.forward(is_train=True)]
        jex.backward()
        tex.backward()
        assert to[3].dtype == np.float64
        np.testing.assert_array_equal(to[3], jo[3])     # rois
        for name, a, b in zip(net.list_outputs(), to, jo):
            _close(a, b, F64_TOL, "step %d %s" % (step, name))
        for name in net.list_arguments():
            _close(tex.grad_dict[name].asnumpy(),
                   jex.grad_dict[name].asnumpy(), F64_TOL,
                   "step %d grad %s" % (step, name))
        widths.append(np.abs(to[3][:, 3] - to[3][:, 1]).max())
        for name in params:
            for ex in (jex, tex):
                ex.arg_dict[name][:] = (ex.arg_dict[name].asnumpy()
                                        - lr * ex.grad_dict[name].asnumpy())
    assert min(widths) > 0, widths      # real boxes at every step


# ----------------------------------------------------------------------
# the example script, and imports with JAX blocked
# ----------------------------------------------------------------------
def _run_example(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "train_end2end.py"] + list(argv),
                          cwd=os.path.join(REPO, "example", "rcnn-torch"),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_example_trains_on_the_cpu():
    r = _run_example("--cpu", "--steps", "2", "--image-size", "64",
                     "--rois", "8")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "smoke OK" in r.stderr + r.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the run without a GPU")
def test_example_without_cpu_flag_needs_a_gpu():
    r = _run_example("--steps", "1", "--image-size", "64", "--rois", "8")
    assert r.returncode != 0
    assert "gpu(0) requested but no CUDA device" in r.stderr


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.path.insert(0, 'example/rcnn-torch')\n"
        "import mxnet_tpu_torch.operator, mxnet_tpu_torch.ops.vision\n"
        "import proposal, symbol, train_end2end\n"
        "import runpy\n"
        "runpy.run_path('example/numpy-ops-torch/custom_softmax.py',\n"
        "               run_name='not_main')\n"
        "s = symbol.get_rcnn_symbol()\n"
        "assert 'rois_output' in s.list_outputs()\n"
        "bad = [m for m in sys.modules if m == 'mxnet_tpu' or\n"
        "       m.startswith(('mxnet_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
