"""The port's model zoo: ``get_symbol`` functions.

``mlp``, ``lenet``, the image-classification zoo (``alexnet``, ``vgg``,
``googlenet``, ``inception_bn``, ``inception_v3``, ``resnet``),
``transformer``, ``transformer_moe`` and the unrolled recurrent language
models (``lstm``, ``gru``, ``rnn``): the JAX package's whole zoo, with its
``get_*`` aliases.
"""
from . import alexnet, googlenet, inception_bn, inception_v3  # noqa: F401
from . import lenet, mlp, resnet, transformer, vgg            # noqa: F401
from . import transformer_moe                                 # noqa: F401
from . import gru, lstm, rnn                                  # noqa: F401
from .alexnet import get_symbol as get_alexnet                # noqa: F401
from .googlenet import get_symbol as get_googlenet            # noqa: F401
from .inception_bn import get_symbol as get_inception_bn      # noqa: F401
from .inception_v3 import get_symbol as get_inception_v3      # noqa: F401
from .lenet import get_symbol as get_lenet                    # noqa: F401
from .mlp import get_symbol as get_mlp                        # noqa: F401
from .resnet import get_symbol as get_resnet                  # noqa: F401
from .vgg import get_symbol as get_vgg                        # noqa: F401
