"""The port's model zoo: ``get_symbol`` functions.

``mlp``, ``lenet``, ``resnet`` and ``transformer`` are ported.  The rest
of the JAX package's zoo raises :class:`~mxnet_tpu_torch.base.MXNetError`
when asked for, naming the ``ROADMAP.md`` item it waits on, instead of
being left out silently.
"""
from . import lenet, mlp, resnet, transformer  # noqa: F401
from .lenet import get_symbol as get_lenet     # noqa: F401
from .mlp import get_symbol as get_mlp         # noqa: F401
from .resnet import get_symbol as get_resnet   # noqa: F401

#: the JAX package's models not ported yet, by the ROADMAP.md queue 1
#: item that brings them
_UNPORTED = {
    "alexnet": 2, "vgg": 2, "googlenet": 2, "inception_bn": 2,
    "inception_v3": 2, "get_alexnet": 2, "get_vgg": 2, "get_googlenet": 2,
    "get_inception_bn": 2, "get_inception_v3": 2,
    "lstm": 4, "gru": 4, "rnn": 4, "transformer_moe": 3,
}


def __getattr__(name):
    if name in _UNPORTED:
        from ..base import MXNetError
        raise MXNetError("models.%s is not ported yet: it comes with "
                         "ROADMAP.md queue 1 item %d"
                         % (name, _UNPORTED[name]))
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
