"""AlexNet (Krizhevsky et al., 2012), spec-table construction.

A copy of ``mxnet_tpu/models/alexnet.py`` on the port's ``symbol``: the
same graph and names, so parameters and checkpoints move between the two
packages.  Architecture constants match the reference zoo entry
(example/image-classification/symbol_alexnet.py); the construction is
table-driven: each row of
``_CONV_STAGES`` is one conv stage (filters, kernel, stride, pad, then
optional max-pool / local-response-norm), and the classifier is two
dropout-regularized FC layers ahead of the softmax head.
"""
from .. import symbol as sym

# (num_filter, kernel, stride, pad, pool_after, lrn_after)
_CONV_STAGES = (
    (96,  (11, 11), (4, 4), (0, 0), True,  True),
    (256, (5, 5),   (1, 1), (2, 2), True,  True),
    (384, (3, 3),   (1, 1), (1, 1), False, False),
    (384, (3, 3),   (1, 1), (1, 1), False, False),
    (256, (3, 3),   (1, 1), (1, 1), True,  False),
)

_FC_WIDTH = 4096
_DROP_P = 0.5


def get_symbol(num_classes=1000):
    from ..name import NameManager
    with NameManager():       # deterministic auto-names per build
        return _build(num_classes)


def _build(num_classes):
    x = sym.Variable("data")
    for filters, kernel, stride, pad, pool, lrn in _CONV_STAGES:
        x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                            stride=stride, pad=pad)
        x = sym.Activation(data=x, act_type="relu")
        if pool:
            x = sym.Pooling(data=x, pool_type="max", kernel=(3, 3),
                            stride=(2, 2))
        if lrn:
            x = sym.LRN(data=x, alpha=0.0001, beta=0.75, knorm=1, nsize=5)
    x = sym.Flatten(data=x)
    for _ in range(2):
        x = sym.FullyConnected(data=x, num_hidden=_FC_WIDTH)
        x = sym.Activation(data=x, act_type="relu")
        x = sym.Dropout(data=x, p=_DROP_P)
    x = sym.FullyConnected(data=x, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=x, name="softmax")
