"""Model builders of the port."""
from . import transformer   # noqa: F401
