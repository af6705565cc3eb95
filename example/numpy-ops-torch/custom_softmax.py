"""Train an MLP whose loss layer is a python CustomOp, on the
PyTorch/CUDA port (``mxnet_tpu_torch``).

The copy of ``example/numpy-ops/custom_softmax.py`` on ``gpu(0)``, or
the CPU with ``--cpu``: softmax + cross-entropy gradient written in
numpy, registered as 'custom_softmax', dropped into ``Module.fit``.
``main`` seeds numpy's and the port's generators, so that a run on the
card and one on the CPU start from the same weights and batches.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx


class Softmax(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0]
        y = np.exp(x - x.max(axis=1, keepdims=True))
        y /= y.sum(axis=1, keepdims=True)
        self.assign(out_data[0], req[0], y)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        l = in_data[1].astype(np.int64)
        y = out_data[0].copy()
        y[np.arange(l.shape[0]), l] -= 1.0
        self.assign(in_grad[0], req[0], y)
        self.assign(in_grad[1], req[1], np.zeros_like(in_grad[1]))


@mx.operator.register("custom_softmax")
class SoftmaxProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        data_shape = in_shape[0]
        label_shape = [in_shape[0][0]]
        return [data_shape, label_shape], [data_shape], []

    def create_operator(self, ctx, shapes, dtypes):
        return Softmax()


def main(ctx=None, seed=0, num_epoch=3):
    """Fit on ``ctx`` (default ``gpu(0)``); returns the final accuracy."""
    logging.basicConfig(level=logging.INFO)
    np.random.seed(seed)
    mx.random.seed(seed)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, num_hidden=64, name="fc1")
    act1 = mx.sym.Activation(data=fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, num_hidden=10, name="fc2")
    net = mx.sym.Custom(data=fc2, label=mx.sym.Variable("softmax_label"),
                        op_type="custom_softmax", name="softmax")

    rng = np.random.RandomState(0)
    protos = rng.uniform(-1, 1, (10, 784)).astype(np.float32)
    y = rng.randint(0, 10, 2048)
    X = (protos[y] + 0.5 * rng.randn(2048, 784)).astype(np.float32)
    train = mx.io.NDArrayIter(X, y.astype(np.float32), batch_size=128,
                              shuffle=True)

    mod = mx.mod.Module(net, context=ctx if ctx is not None else mx.gpu(0))
    mod.fit(train, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(),
            batch_end_callback=mx.callback.Speedometer(128, 8))
    score = dict(mod.score(mx.io.NDArrayIter(X, y.astype(np.float32),
                                             batch_size=128), "acc"))
    logging.info("final accuracy: %s", score)
    assert score["accuracy"] > 0.8
    return score["accuracy"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of gpu(0)")
    main(ctx=mx.cpu() if ap.parse_args().cpu else None)
