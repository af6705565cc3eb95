"""Operators of the port; importing this package registers them."""
from . import registry, tensor, nn, attention, loss  # noqa: F401
from . import rnn, sequence, vision, moe             # noqa: F401
