"""GoogLeNet / Inception-v1 (Szegedy et al., 2014), spec-table construction.

A copy of ``mxnet_tpu/models/googlenet.py`` on the port's ``symbol``:
the same graph and names.  Architecture constants match the reference
zoo entry (example/image-classification/symbol_googlenet.py); the
construction is table-driven like the rest of this zoo: the stem is a
list of conv/pool rows and the body is a list of inception-block width
tuples with "P" markers for the stage-boundary max-pools.
"""
from .. import symbol as sym

# stem rows: ("c", filters, kernel, stride, pad) convs or ("p",) max-pools
_STEM = (
    ("c", 64, (7, 7), (2, 2), (3, 3)),
    ("p",),
    ("c", 64, (1, 1), (1, 1), (0, 0)),
    ("c", 192, (3, 3), (1, 1), (1, 1)),
    ("p",),
)

# each tuple is one inception block:
#   (b1x1, b3x3_bottleneck, b3x3, b5x5_bottleneck, b5x5, pool_projection)
# "P" inserts the between-stage max-pool
_BODY = (
    (64, 96, 128, 16, 32, 32),
    (128, 128, 192, 32, 96, 64),
    "P",
    (192, 96, 208, 16, 48, 64),
    (160, 112, 224, 24, 64, 64),
    (128, 128, 256, 24, 64, 64),
    (112, 144, 288, 32, 64, 64),
    (256, 160, 320, 32, 128, 128),
    "P",
    (256, 160, 320, 32, 128, 128),
    (384, 192, 384, 48, 128, 128),
)


def _conv_relu(x, filters, kernel, stride=(1, 1), pad=(0, 0)):
    x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad)
    return sym.Activation(data=x, act_type="relu")


def _max_pool(x):
    return sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2),
                       pool_type="max")


def _inception(x, widths):
    """Four parallel branches concatenated on channels: 1x1, bottlenecked
    3x3, bottlenecked 5x5, and a pooled 1x1 projection."""
    b1, r3, b3, r5, b5, proj = widths
    chains = (
        ((b1, (1, 1), (0, 0)),),
        ((r3, (1, 1), (0, 0)), (b3, (3, 3), (1, 1))),
        ((r5, (1, 1), (0, 0)), (b5, (5, 5), (2, 2))),
    )
    branches = []
    for chain in chains:
        b = x
        for filters, kernel, pad in chain:
            b = _conv_relu(b, filters, kernel, pad=pad)
        branches.append(b)
    pooled = sym.Pooling(data=x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                         pool_type="max")
    branches.append(_conv_relu(pooled, proj, (1, 1)))
    return sym.Concat(*branches)


def get_symbol(num_classes=1000):
    from ..name import NameManager
    with NameManager():       # deterministic auto-names per build
        return _build(num_classes)


def _build(num_classes):
    x = sym.Variable("data")
    for row in _STEM:
        if row[0] == "p":
            x = _max_pool(x)
        else:
            _tag, filters, kernel, stride, pad = row
            x = _conv_relu(x, filters, kernel, stride, pad)
    for block in _BODY:
        x = _max_pool(x) if block == "P" else _inception(x, block)
    x = sym.Pooling(data=x, kernel=(7, 7), stride=(1, 1), global_pool=True,
                    pool_type="avg")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=num_classes)
    return sym.SoftmaxOutput(data=x, name="softmax")
