"""Model builders of the port."""
from . import mlp, resnet, transformer         # noqa: F401
from .mlp import get_symbol as get_mlp         # noqa: F401
from .resnet import get_symbol as get_resnet   # noqa: F401
