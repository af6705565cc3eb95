"""Weight initializers (parity: python/mxnet/initializer.py).

The port of ``mxnet_tpu/initializer.py``: the name dispatch of
``Initializer`` (an ``upsampling*`` parameter gets the bilinear kernel,
then the suffix rules), ``Uniform`` (the trainer's default), ``Normal``,
``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``Constant``,
``Zero``, ``One``, and the ``Load`` and ``Mixed`` wrappers.  Draws come
from an explicit ``torch.Generator`` on the CPU (by default
``random.generator("cpu")``, reset by ``random.seed``) and are then
copied into the target array, so a seed gives the same weights on every
device.  The two packages draw different numbers: parity tests compare
the deterministic initializers bit for bit and the random ones by their
distribution, and move weights between the packages as numpy arrays.
"""
from __future__ import annotations

import logging
import re

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray
from . import random as _random

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Constant", "One", "Zero", "Bilinear", "Load",
           "Mixed"]


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
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
            return
        for suffix, handler in self._SUFFIX_RULES:
            if name.endswith(suffix):
                getattr(self, handler)(name, arr)
                return
        self._init_default(name, arr)

    @staticmethod
    def _fill(arr, value):
        with torch.no_grad():
            arr.data.copy_(value)

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel over the last two axes, as the
        JAX package computes it (float32, on the host)."""
        shape = arr.shape
        weight = _np.zeros(int(_np.prod(shape)), dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._fill(arr, torch.from_numpy(weight.reshape(shape)))

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

    def _normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=torch.float32)


class Load(object):
    """Initialize from a saved parameter dict (or the path of one), else
    with ``default_init`` (parity: initializer.py Load); the ``arg:`` and
    ``aux:`` prefixes of a checkpoint are stripped."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            param = nd_load(param)
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                self.param[name[4:]] = arr
            else:
                self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(arr.shape) != tuple(src.shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading. "
                    "Shape mismatch, target %s vs loaded %s"
                    % (name, tuple(arr.shape), tuple(src.shape)))
            value = src.data if isinstance(src, NDArray) \
                else torch.as_tensor(_np.asarray(src))
            with torch.no_grad():
                arr.data.copy_(value)
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initializer provided" % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


class Mixed(object):
    """Initializers chosen by regular expression over the name, the first
    match winning (parity: initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            "\".*\" pattern at the end with default Initializer." % name)


class Constant(Initializer):
    """Fill with a constant whatever the name."""

    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def __call__(self, name, arr):
        self._fill(arr, torch.full(tuple(arr.shape), self.value,
                                   dtype=arr.data.dtype))


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


class Uniform(Initializer):
    """U(-scale, scale) (parity: initializer.py Uniform)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._fill(arr, self._uniform(arr.shape, -self.scale, self.scale))


class Normal(Initializer):
    """N(0, sigma) (parity: initializer.py Normal)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._fill(arr, self._normal(arr.shape) * self.sigma)


class Orthogonal(Initializer):
    """A scaled orthogonal matrix from the SVD of a uniform or normal
    draw (parity: initializer.py Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._uniform((nout, nin), -1.0, 1.0)
        else:
            tmp = self._normal((nout, nin))
        u, _s, v = _np.linalg.svd(tmp.numpy(), full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        self._fill(arr, torch.from_numpy(
            (self.scale * q.reshape(arr.shape)).astype(_np.float32)))


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


class MSRAPrelu(Xavier):
    """He initialization adjusted for a PReLU slope (parity:
    initializer.py MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude,
                         generator=generator)


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a deconvolution's weight."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)
