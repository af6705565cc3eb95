"""Optimizers as pure update functions on tensors.

The port's slice of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base
(registry, ``create``, ``lr``/``wd``/``rescale_grad``/``clip_gradient``/
``lr_scheduler``, ``_preprocess_grad``, ``create_state_arrays``, the
``elementwise`` flag) and the two optimizers of the training slice, SGD
and Adam.  Each exposes ``update_fn(weight, grad, state, lr, wd, t) ->
(weight, state)``, written with the JAX package's formulas in the same
order of operations, so the leafwise trainer step, the fused sweep's
plain version and the sweep's CUDA kernel (``kernels/fused_opt.py``)
round alike.  ``update_fn`` is pure: it allocates its results.
"""
from __future__ import annotations

import logging

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]


class Optimizer:
    """Base optimizer (parity: optimizer.py:22 class Optimizer).

    Subclasses implement ``create_state_arrays(shape, dtype, device)``
    (a tensor, a tuple of tensors, or None) and ``update_fn``.
    ``elementwise`` marks optimizers whose update is purely elementwise,
    which the fused optimizer sweep may flatten and concatenate with
    bit-identical results.
    """

    opt_registry = {}
    elementwise = False

    @staticmethod
    def register(klass):
        """Parity: optimizer.py Optimizer.register decorator."""
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("Optimizer %s is overridden", name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1.0, **kwargs):
        """Parity: optimizer.py:69 create_optimizer."""
        if name.lower() not in Optimizer.opt_registry:
            raise ValueError("Cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](
            rescale_grad=rescale_grad, **kwargs)

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        """State for one weight; None if stateless."""
        return None

    def update_fn(self, weight, grad, state, lr, wd, t):
        """Pure update: (new_weight, new_state).  Subclasses override."""
        raise NotImplementedError()

    def _preprocess_grad(self, grad):
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        return grad


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum/wd/clip (parity: optimizer.py:234).

    state = momentum buffer (None when momentum == 0);
    update: m = mu*m - lr*(grad + wd*w);  w += m
    """

    elementwise = True

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        if self.momentum == 0.0:
            return None
        return torch.zeros(tuple(shape), dtype=dtype, device=device)

    def update_fn(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if state is None:
            return weight - lr * g, None
        m = self.momentum * state - lr * g
        return weight + m, m


@register
class Adam(Optimizer):
    """Adam (parity: optimizer.py:292).  state = (mean, var); the bias
    corrections take ``t`` as a float32 scalar on the weight's device,
    as the JAX package casts it."""

    elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return (torch.zeros(tuple(shape), dtype=dtype, device=device),
                torch.zeros(tuple(shape), dtype=dtype, device=device))

    def update_fn(self, weight, grad, state, lr, wd, t):
        if state is None:
            raise MXNetError("Adam needs its (mean, var) state")
        mean, var = state
        g = grad + wd * weight
        mean = self.beta1 * mean + (1.0 - self.beta1) * g
        var = self.beta2 * var + (1.0 - self.beta2) * g * g
        tf = torch.as_tensor(t, dtype=torch.float32, device=weight.device)
        mhat = mean / (1.0 - self.beta1 ** tf)
        vhat = var / (1.0 - self.beta2 ** tf)
        w = weight - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return w, (mean, var)
