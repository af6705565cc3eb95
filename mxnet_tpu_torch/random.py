"""Random state and samplers (parity: python/mxnet/random.py,
``mxnet_tpu/random.py``).

The JAX package keeps one splittable PRNG key and splits it per call; the
port keeps one explicit ``torch.Generator`` per device, all seeded by
:func:`seed`.  The samplers (:func:`uniform`, :func:`normal` alias
:func:`gaussian`, :func:`randint`) draw from the generator of the device
they fill.  The trainer hands the generator of its device to every op
that declares ``need_rng`` (dropout is the only consumer), and the
initializers draw from the CPU generator, so the same seed gives the
same weights whichever device the model lands on.  The two packages draw
different numbers from the same seed: tests that compare them make their
inputs with numpy, and compare only distributions of what is drawn.
"""
from __future__ import annotations

import threading

import torch

from .ndarray import NDArray, _place, _torch_dtype

__all__ = ["seed", "generator", "uniform", "normal", "gaussian", "randint"]

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


def _draw(sample, shape, ctx, out, dtype):
    """Fill a new tensor of ``shape`` (``out``'s shape, else ``(1,)``)
    on ``out``'s device or ``ctx``'s with ``sample(tensor, generator)``;
    write it into ``out`` in place, in ``out``'s dtype, when given."""
    if shape is None:
        shape = out.shape if out is not None else (1,)
    if out is not None:
        device = out.data.device
    else:
        ctx, device = _place(ctx)
    res = torch.empty(tuple(shape), dtype=_torch_dtype(dtype), device=device)
    sample(res, generator(device))
    if out is not None:
        out._set_data(res)
        return out
    return NDArray(res, ctx=ctx)


def uniform(low=0.0, high=1.0, shape=None, ctx=None, out=None,
            dtype=torch.float32):
    """Samples of U[low, high)."""
    return _draw(lambda t, g: t.uniform_(low, high, generator=g),
                 shape, ctx, out, dtype)


def normal(loc=0.0, scale=1.0, shape=None, ctx=None, out=None,
           dtype=torch.float32):
    """Samples of N(loc, scale**2)."""
    def sample(t, g):
        t.normal_(generator=g)
        t.mul_(scale).add_(loc)
    return _draw(sample, shape, ctx, out, dtype)


#: reference alias (mx.random.gaussian)
gaussian = normal


def randint(low, high, shape=None, ctx=None, out=None, dtype="int32"):
    """Integers drawn uniformly from [low, high)."""
    return _draw(lambda t, g: t.random_(low, high, generator=g),
                 shape, ctx, out, dtype)
