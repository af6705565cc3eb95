"""LeNet-5 style convnet (reference: example/image-classification/train_mnist.py:27-42).

The port's copy of ``mxnet_tpu/models/lenet.py``: the same graph and JSON
(LeNet/MNIST via the Module API).
"""
from .. import symbol as sym


def get_symbol(num_classes=10):
    data = sym.Variable("data")
    # first conv
    conv1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(data=conv1, act_type="tanh")
    pool1 = sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # second conv
    conv2 = sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(data=conv2, act_type="tanh")
    pool2 = sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # first fullc
    flatten = sym.Flatten(data=pool2)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=500)
    tanh3 = sym.Activation(data=fc1, act_type="tanh")
    # second fullc
    fc2 = sym.FullyConnected(data=tanh3, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc2, name="softmax")
