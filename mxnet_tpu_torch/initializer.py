"""Weight initializers (parity: python/mxnet/initializer.py).

The port's slice of ``mxnet_tpu/initializer.py``: the name-suffix
dispatch of ``Initializer`` and the two initializers the training slice
uses, ``Uniform`` (the trainer's default) and ``Xavier``.  Draws come
from an explicit ``torch.Generator`` on the CPU (by default
``random.generator("cpu")``, reset by ``random.seed``) and are then
copied into the target array, so a seed gives the same weights on every
device.  The two packages draw different numbers: parity tests move
weights between them as numpy arrays.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray
from . import random as _random

__all__ = ["Initializer", "Uniform", "Xavier"]


class Initializer:
    """Base: dispatch on the parameter name's suffix; the first matching
    rule of ``_SUFFIX_RULES`` wins (role: initializer.py:15 __call__)."""

    _SUFFIX_RULES = (
        ("bias", "_init_bias"),
        ("gamma", "_init_gamma"),
        ("beta", "_init_beta"),
        ("weight", "_init_weight"),
        ("moving_mean", "_init_zero"),
        ("moving_inv_var", "_init_zero"),
        ("moving_var", "_init_one"),
        ("moving_avg", "_init_zero"),
    )

    def __init__(self, generator=None):
        self._generator = generator

    @property
    def generator(self):
        return self._generator if self._generator is not None \
            else _random.generator("cpu")

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        for suffix, handler in self._SUFFIX_RULES:
            if name.endswith(suffix):
                getattr(self, handler)(name, arr)
                return
        self._init_default(name, arr)

    @staticmethod
    def _fill(arr, value):
        with torch.no_grad():
            arr.data.copy_(value)

    def _init_zero(self, _, arr):
        self._fill(arr, torch.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._fill(arr, torch.ones(arr.shape))

    def _init_bias(self, _, arr):
        self._init_zero(_, arr)

    def _init_gamma(self, _, arr):
        self._init_one(_, arr)

    def _init_beta(self, _, arr):
        self._init_zero(_, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to \"weight\", \"bias\", \"gamma\" (1.0), and "
            "\"beta\" (0.0)." % name)

    def _uniform(self, shape, low, high):
        u = torch.rand(tuple(shape), generator=self.generator,
                       dtype=torch.float32)
        return u * (high - low) + low


class Uniform(Initializer):
    """U(-scale, scale) (parity: initializer.py Uniform)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._fill(arr, self._uniform(arr.shape, -self.scale, self.scale))


class Xavier(Initializer):
    """Xavier/Glorot (parity: initializer.py Xavier): the scale from
    fan_in/fan_out, ``rnd_type`` uniform or gaussian."""

    _FACTORS = {"avg": lambda fi, fo: (fi + fo) / 2.0,
                "in": lambda fi, fo: fi,
                "out": lambda fi, fo: fo}

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        receptive = _np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
        if self.factor_type not in self._FACTORS:
            raise ValueError("Xavier factor_type must be one of %s, got %r"
                             % (sorted(self._FACTORS), self.factor_type))
        factor = self._FACTORS[self.factor_type](fan_in, fan_out)
        scale = float(_np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            val = self._uniform(shape, -scale, scale)
        elif self.rnd_type == "gaussian":
            val = torch.randn(tuple(shape), generator=self.generator) * scale
        else:
            raise ValueError("Xavier rnd_type must be uniform or gaussian, "
                             "got %r" % (self.rnd_type,))
        self._fill(arr, val)
