"""The port's model zoo: ``get_symbol`` functions.

``mlp``, ``lenet``, the image-classification zoo (``alexnet``, ``vgg``,
``googlenet``, ``inception_bn``, ``inception_v3``, ``resnet``),
``transformer`` and the unrolled recurrent language models (``lstm``,
``gru``, ``rnn``) are ported, with the JAX package's ``get_*`` aliases.
``transformer_moe`` raises :class:`~mxnet_tpu_torch.base.MXNetError`
when asked for, naming the ``ROADMAP.md`` item it waits on, instead of
being left out silently.
"""
from . import alexnet, googlenet, inception_bn, inception_v3  # noqa: F401
from . import lenet, mlp, resnet, transformer, vgg            # noqa: F401
from . import gru, lstm, rnn                                  # noqa: F401
from .alexnet import get_symbol as get_alexnet                # noqa: F401
from .googlenet import get_symbol as get_googlenet            # noqa: F401
from .inception_bn import get_symbol as get_inception_bn      # noqa: F401
from .inception_v3 import get_symbol as get_inception_v3      # noqa: F401
from .lenet import get_symbol as get_lenet                    # noqa: F401
from .mlp import get_symbol as get_mlp                        # noqa: F401
from .resnet import get_symbol as get_resnet                  # noqa: F401
from .vgg import get_symbol as get_vgg                        # noqa: F401

#: the JAX package's models not ported yet, by the ROADMAP.md queue 1
#: item that brings them
_UNPORTED = {"transformer_moe": 3}


def __getattr__(name):
    if name in _UNPORTED:
        from ..base import MXNetError
        raise MXNetError("models.%s is not ported yet: it comes with "
                         "ROADMAP.md queue 1 item %d"
                         % (name, _UNPORTED[name]))
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
