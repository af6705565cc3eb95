"""Inception-BN (Ioffe & Szegedy, 2015), spec-table construction.

A copy of ``mxnet_tpu/models/inception_bn.py`` on the port's ``symbol``:
the same graph and names, so parameters and checkpoints move between the
two packages.  The BASELINE's ImageNet configuration trains this network
beside ResNet-50; width constants match the reference zoo entry
(example/image-classification/symbol_inception-bn.py).

Layout: every inception block — regular ("A") or downsampling
("B") — is a row of branch chains, where a chain is a sequence of
(filters, kernel, stride, pad) conv+BN+relu units; the block concatenates
its branch outputs with a pooled projection (A) or a bare max-pool (B).
"""
from .. import symbol as sym

_BN_EPS = 0.001 + 1e-5
_BN_MOM = 0.9

_K1, _K3 = (1, 1), (3, 3)
_S1, _S2 = (1, 1), (2, 2)
_P0, _P1 = (0, 0), (1, 1)


def _unit(x, filters, kernel, stride=_S1, pad=_P0):
    """conv (no bias) + batch-norm + relu."""
    x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True)
    x = sym.BatchNorm(data=x, fix_gamma=False, eps=_BN_EPS,
                      momentum=_BN_MOM)
    return sym.Activation(data=x, act_type="relu")


def _block_a(widths):
    """Regular block: 1x1 / 3x3 / double-3x3 branches + pooled projection.
    widths = (b1, r3, n3, rd, nd, pool_type, proj)."""
    b1, r3, n3, rd, nd, pool_type, proj = widths
    return (
        ((b1, _K1, _S1, _P0),),
        ((r3, _K1, _S1, _P0), (n3, _K3, _S1, _P1)),
        ((rd, _K1, _S1, _P0), (nd, _K3, _S1, _P1), (nd, _K3, _S1, _P1)),
    ), (pool_type, _S1, proj)


def _block_b(widths):
    """Stride-2 downsampling block: 3x3 / double-3x3 branches + max-pool.
    widths = (r3, n3, rd, nd)."""
    r3, n3, rd, nd = widths
    return (
        ((r3, _K1, _S1, _P0), (n3, _K3, _S2, _P1)),
        ((rd, _K1, _S1, _P0), (nd, _K3, _S1, _P1), (nd, _K3, _S2, _P1)),
    ), ("max", _S2, None)

_BODY = (
    ("A", (64, 64, 64, 64, 96, "avg", 32)),
    ("A", (64, 64, 96, 64, 96, "avg", 64)),
    ("B", (128, 160, 64, 96)),
    ("A", (224, 64, 96, 96, 128, "avg", 128)),
    ("A", (192, 96, 128, 96, 128, "avg", 128)),
    ("A", (160, 128, 160, 128, 160, "avg", 128)),
    ("A", (96, 128, 192, 160, 192, "avg", 128)),
    ("B", (128, 192, 192, 256)),
    ("A", (352, 192, 320, 160, 224, "avg", 128)),
    ("A", (352, 192, 320, 192, 224, "max", 128)),
)


def _inception(x, kind, widths):
    chains, (pool_type, pool_stride, proj) = \
        (_block_a if kind == "A" else _block_b)(widths)
    branches = []
    for chain in chains:
        b = x
        for filters, kernel, stride, pad in chain:
            b = _unit(b, filters, kernel, stride, pad)
        branches.append(b)
    pooled = sym.Pooling(data=x, kernel=_K3, stride=pool_stride, pad=_P1,
                         pool_type=pool_type)
    branches.append(pooled if proj is None else _unit(pooled, proj, _K1))
    return sym.Concat(*branches)


def get_symbol(num_classes=1000):
    from ..name import NameManager
    with NameManager():       # deterministic auto-names per build
        return _build(num_classes)


def _build(num_classes):
    x = sym.Variable("data")
    x = _unit(x, 64, (7, 7), _S2, (3, 3))
    x = sym.Pooling(data=x, kernel=_K3, stride=_S2, pool_type="max")
    x = _unit(x, 64, _K1)
    x = _unit(x, 192, _K3, _S1, _P1)
    x = sym.Pooling(data=x, kernel=_K3, stride=_S2, pool_type="max")
    for kind, widths in _BODY:
        x = _inception(x, kind, widths)
    x = sym.Pooling(data=x, kernel=(7, 7), stride=_S1, global_pool=True,
                    pool_type="avg")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=num_classes,
                           name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")
