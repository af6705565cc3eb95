"""Inception-v3 (Szegedy et al., 2015), spec-table construction.

A copy of ``mxnet_tpu/models/inception_v3.py`` on the port's ``symbol``:
the same graph and names.  Width/kernel constants match the reference zoo
entry (example/image-classification/symbol_inception-v3.py); its input is
299 x 299.  Like the rest of this zoo the construction is a small spec
interpreter: a block is a list of branches, a branch is either a conv
chain, a chain that SPLITS into two factorized leaves (the v3 "mixed"
towers), or a pooled projection; stage-boundary blocks end in a bare
max-pool branch.
"""
from .. import symbol as sym

_S1, _S2 = (1, 1), (2, 2)


def _unit(x, filters, kernel=(1, 1), stride=_S1, pad=(0, 0)):
    """conv (no bias) + batch-norm + relu — the v3 building block."""
    x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True)
    x = sym.BatchNorm(data=x, fix_gamma=True, eps=0.001)
    return sym.Activation(data=x, act_type="relu")


def _chain(x, rows):
    for filters, kernel, stride, pad in rows:
        x = _unit(x, filters, kernel, stride, pad)
    return x


# branch constructors: (kind, payload)
def _c(*rows):
    return ("chain", rows)


def _split(stem_rows, leaves):
    return ("split", (stem_rows, leaves))


def _pp(pool_type, proj):
    return ("poolproj", (pool_type, proj))

_BARE_POOL = ("barepool", None)

# conv row shorthand: (filters, kernel, stride, pad)
def _r(f, k=(1, 1), s=_S1, p=(0, 0)):
    return (f, k, s, p)


def _block(x, branches):
    outs = []
    for kind, payload in branches:
        if kind == "chain":
            outs.append(_chain(x, payload))
        elif kind == "split":
            stem_rows, leaves = payload
            stem = _chain(x, stem_rows)
            for leaf in leaves:
                outs.append(_chain(stem, [leaf]))
        elif kind == "poolproj":
            pool_type, proj = payload
            pooled = sym.Pooling(data=x, kernel=(3, 3), stride=_S1,
                                 pad=(1, 1), pool_type=pool_type)
            outs.append(_unit(pooled, proj))
        else:  # barepool: the stage-boundary stride-2 max pool
            outs.append(sym.Pooling(data=x, kernel=(3, 3), stride=_S2,
                                    pool_type="max"))
    return sym.Concat(*outs)


def _block_a(b1, r3, n3a, n3b, r5, n5, pool, proj):
    return (
        _c(_r(b1)),
        _c(_r(r5), _r(n5, (5, 5), _S1, (2, 2))),
        _c(_r(r3), _r(n3a, (3, 3), _S1, (1, 1)),
           _r(n3b, (3, 3), _S1, (1, 1))),
        _pp(pool, proj),
    )


def _block_b(n3, rd, d1, d2):
    return (
        _c(_r(n3, (3, 3), _S2)),
        _c(_r(rd), _r(d1, (3, 3), _S1, (1, 1)), _r(d2, (3, 3), _S2)),
        _BARE_POOL,
    )


def _block_c(b1, r7, d71, d72, q7r, q71, q72, q73, q74, pool, proj):
    h, v = ((1, 7), (0, 3)), ((7, 1), (3, 0))
    return (
        _c(_r(b1)),
        _c(_r(r7), _r(d71, h[0], _S1, h[1]), _r(d72, v[0], _S1, v[1])),
        _c(_r(q7r), _r(q71, v[0], _S1, v[1]), _r(q72, h[0], _S1, h[1]),
           _r(q73, v[0], _S1, v[1]), _r(q74, h[0], _S1, h[1])),
        _pp(pool, proj),
    )


def _block_d(r3, n3, rd, d1, d2, d3):
    h, v = ((1, 7), (0, 3)), ((7, 1), (3, 0))
    return (
        _c(_r(r3), _r(n3, (3, 3), _S2)),
        _c(_r(rd), _r(d1, h[0], _S1, h[1]), _r(d2, v[0], _S1, v[1]),
           _r(d3, (3, 3), _S2)),
        _BARE_POOL,
    )


def _block_e(b1, rd3, d3ab, r33, n33, e12, pool, proj):
    h, v = ((1, 3), (0, 1)), ((3, 1), (1, 0))
    leaves = [_r(d3ab, h[0], _S1, h[1]), _r(d3ab, v[0], _S1, v[1])]
    leaves2 = [_r(e12, h[0], _S1, h[1]), _r(e12, v[0], _S1, v[1])]
    return (
        _c(_r(b1)),
        _split([_r(rd3)], leaves),
        _split([_r(r33), _r(n33, (3, 3), _S1, (1, 1))], leaves2),
        _pp(pool, proj),
    )

# the network body: one entry per mixed block (reference stage 3-5 widths)
_BODY = (
    _block_a(64, 64, 96, 96, 48, 64, "avg", 32),
    _block_a(64, 64, 96, 96, 48, 64, "avg", 64),
    _block_a(64, 64, 96, 96, 48, 64, "avg", 64),
    _block_b(384, 64, 96, 96),
    _block_c(192, 128, 128, 192, 128, 128, 128, 128, 192, "avg", 192),
    _block_c(192, 160, 160, 192, 160, 160, 160, 160, 192, "avg", 192),
    _block_c(192, 160, 160, 192, 160, 160, 160, 160, 192, "avg", 192),
    _block_c(192, 192, 192, 192, 192, 192, 192, 192, 192, "avg", 192),
    _block_d(192, 320, 192, 192, 192, 192),
    _block_e(320, 384, 384, 448, 384, 384, "avg", 192),
    _block_e(320, 384, 384, 448, 384, 384, "max", 192),
)


def get_symbol(num_classes=1000):
    from ..name import NameManager
    with NameManager():       # deterministic auto-names per build
        return _build(num_classes)


def _build(num_classes):
    x = sym.Variable("data")
    # stem: 299x299 -> 35x35
    x = _chain(x, [_r(32, (3, 3), _S2), _r(32, (3, 3)),
                   _r(64, (3, 3), _S1, (1, 1))])
    x = sym.Pooling(data=x, kernel=(3, 3), stride=_S2, pool_type="max")
    x = _chain(x, [_r(80), _r(192, (3, 3))])
    x = sym.Pooling(data=x, kernel=(3, 3), stride=_S2, pool_type="max")
    for branches in _BODY:
        x = _block(x, branches)
    x = sym.Pooling(data=x, kernel=(8, 8), stride=_S1, global_pool=True,
                    pool_type="avg")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=num_classes,
                           name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")
