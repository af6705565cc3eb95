"""Model builders of the port."""
from . import mlp, transformer           # noqa: F401
from .mlp import get_symbol as get_mlp   # noqa: F401
