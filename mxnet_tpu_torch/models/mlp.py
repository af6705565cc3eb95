"""Multi-layer perceptron (reference: example/image-classification/train_mnist.py:15-25).

The port's copy of ``mxnet_tpu/models/mlp.py``: the same graph and JSON."""
from .. import symbol as sym


def get_symbol(num_classes=10, hidden=(128, 64)):
    net = sym.Variable("data")
    net = sym.Flatten(data=net)
    for i, nh in enumerate(hidden):
        net = sym.FullyConnected(data=net, name="fc%d" % (i + 1), num_hidden=nh)
        net = sym.Activation(data=net, name="relu%d" % (i + 1), act_type="relu")
    net = sym.FullyConnected(data=net, name="fc%d" % (len(hidden) + 1),
                             num_hidden=num_classes)
    return sym.SoftmaxOutput(data=net, name="softmax")
