"""Random state (parity: python/mxnet/random.py).

The JAX package keeps one splittable PRNG key and splits it per call; the
port keeps one explicit ``torch.Generator`` per device, all seeded by
:func:`seed`.  The trainer hands the generator of its device to every op
that declares ``need_rng`` (dropout is the only consumer), and the
initializers draw from the CPU generator, so the same seed gives the
same weights whichever device the model lands on.  The two packages draw
different numbers from the same seed: tests that compare them make their
inputs with numpy.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_SEED = 0
_GENERATORS = {}     # torch.device -> torch.Generator


def seed(seed_state):
    """Reset every device's generator to ``seed_state``."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()


def generator(device="cpu"):
    """The generator of ``device``, created and seeded on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_SEED)
            _GENERATORS[device] = gen
        return gen
