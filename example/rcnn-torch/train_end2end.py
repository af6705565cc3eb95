"""Smoke-train the Faster R-CNN graph end-to-end on synthetic detections,
on the PyTorch/CUDA port (``mxnet_tpu_torch``).

The copy of ``example/rcnn/train_end2end.py`` on ``gpu(0)``, or the CPU
with ``--cpu``: the same graph (a multi-loss Group, ROIPooling and the
host-side Proposal custom op), the same seeded synthetic inputs and the
same ``asnumpy`` SGD step.  Its pieces (:func:`bind`,
:func:`fill_inputs`, :func:`sgd_step`) are functions so that a harness
can drive the same step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
import symbol as rcnn_symbol

NUM_ANCHORS = 9


def input_shapes(image_size, rois):
    feat = image_size // 16
    return {"data": (1, 3, image_size, image_size), "im_info": (1, 3),
            "rpn_label": (1, NUM_ANCHORS * feat, feat), "label": (rois,)}


def bind(ctx, image_size=128, num_classes=4, rois=16):
    """The R-CNN graph bound on ``ctx`` with gradients for every argument:
    ``(executor, input shapes)``."""
    net = rcnn_symbol.get_rcnn_symbol(num_classes=num_classes,
                                      rpn_post_nms_top_n=rois)
    shapes = input_shapes(image_size, rois)
    return net.simple_bind(ctx, grad_req="write", **shapes), shapes


def init_params(exe, shapes):
    """Xavier(in, 2) on every argument but the inputs."""
    init = mx.init.Xavier(factor_type="in", magnitude=2.0)
    for name, arr in exe.arg_dict.items():
        if name in shapes:
            continue
        init(name, arr)


def fill_inputs(exe, image_size, num_classes, rois, seed=0):
    """The seeded synthetic image, image info, anchor labels (-1 ignore,
    0, 1) and roi labels."""
    S = image_size
    feat = S // 16
    rng = np.random.RandomState(seed)
    exe.arg_dict["data"][:] = rng.rand(1, 3, S, S).astype(np.float32)
    exe.arg_dict["im_info"][:] = np.array([[S, S, 1.0]], np.float32)
    rl = rng.randint(-1, 2, (1, NUM_ANCHORS * feat, feat))
    exe.arg_dict["rpn_label"][:] = rl.astype(np.float32)
    exe.arg_dict["label"][:] = rng.randint(
        0, num_classes, (rois,)).astype(np.float32)


def sgd_step(exe, lr):
    """Plain SGD on the weights and biases, through host arrays."""
    for name, grad in exe.grad_dict.items():
        if grad is not None and name.endswith(("weight", "bias")):
            exe.arg_dict[name][:] = (exe.arg_dict[name].asnumpy()
                                     - lr * grad.asnumpy())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--num-classes", type=int, default=4)
    parser.add_argument("--rois", type=int, default=16)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of gpu(0)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    exe, shapes = bind(ctx, args.image_size, args.num_classes, args.rois)
    init_params(exe, shapes)
    fill_inputs(exe, args.image_size, args.num_classes, args.rois)

    lr = 0.01
    for step in range(args.steps):
        outs = exe.forward(is_train=True)
        exe.backward()
        sgd_step(exe, lr)
        rois = outs[3].asnumpy()
        logging.info("step %d: rpn_prob %s cls_prob %s rois mean w=%.1f",
                     step, outs[0].shape, outs[1].shape,
                     float((rois[:, 3] - rois[:, 1]).mean()))
    logging.info("rcnn end-to-end smoke OK")


if __name__ == "__main__":
    main()
