"""Optimizers as pure update functions on tensors.

The port of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base (registry,
``create``, ``lr``/``wd``/``rescale_grad``/``clip_gradient``/
``lr_scheduler``, per-parameter ``lr_mult``/``wd_mult``,
``_preprocess_grad``, ``create_state_arrays``, the ``elementwise`` flag,
the imperative ``update`` and :func:`get_updater` of the kvstore path)
and every optimizer of the JAX package: SGD, NAG, SGLD, ccSGD, Adam,
AdamW, AdaGrad, RMSProp, AdaDelta, LAMB and Test.  Each exposes
``update_fn(weight, grad, state, lr, wd, t) -> (weight, state)``,
written with the JAX package's formulas in the same order of
operations, so the leafwise trainer step, the fused sweep's plain
version and the sweep's CUDA kernel (``kernels/fused_opt.py``) round
alike.  ``update_fn`` is pure: it allocates its results.
"""
from __future__ import annotations

import logging

import torch

from .base import MXNetError
from .ndarray import NDArray
from .lr_scheduler import LRScheduler   # noqa: F401  (re-exported, as there)

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "Adam", "AdamW",
           "AdaGrad", "RMSProp", "AdaDelta", "LAMB", "Test", "create",
           "get_updater", "register"]


def _zeros(shape, dtype, device, n=1):
    """``n`` separate zero tensors (the fused sweep writes each state
    leaf in place, so leaves must never share storage)."""
    out = tuple(torch.zeros(tuple(shape), dtype=dtype, device=device)
                for _ in range(n))
    return out[0] if n == 1 else out


def _state_map(fn, state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(fn(s) for s in state)
    return fn(state)


class Optimizer:
    """Base optimizer (parity: optimizer.py:22 class Optimizer).

    Subclasses implement ``create_state_arrays(shape, dtype, device)``
    (a tensor, a tuple of tensors, or None) and ``update_fn``.
    ``elementwise`` marks optimizers whose update is purely elementwise,
    which the fused optimizer sweep may flatten and concatenate with
    bit-identical results; LAMB (per-tensor norms) and SGLD (a noise
    draw per leaf) keep the default False.  ``update(index, weight,
    grad, state)`` keeps the reference's imperative signature for the
    kvstore updaters and ``Module.update``.
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

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names")
        self.idx2name = param_idx2name.copy()
        self.sym = sym

    # -- per-weight lr/wd multipliers (optimizer.py:118-176) --------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # biases / norm params are exempt from weight decay by default
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state + update ----------------------------------------------------
    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        """State for one weight; None if stateless."""
        return None

    def create_state(self, index, weight):
        """NDArray-wrapped state on the weight's device (the reference's
        create_state signature)."""
        state = self.create_state_arrays(weight.shape, weight.dtype,
                                         weight.data.device)
        return _state_map(lambda a: NDArray(a, ctx=weight.context), state)

    def update_fn(self, weight, grad, state, lr, wd, t):
        """Pure update: (new_weight, new_state).  Subclasses override."""
        raise NotImplementedError()

    def _preprocess_grad(self, grad):
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        return grad

    def _step(self, weight, grad, state, lr, wd, t):
        """``_preprocess_grad`` then ``update_fn`` on tensors."""
        return self.update_fn(weight, self._preprocess_grad(grad), state,
                              lr, wd, t)

    def update(self, index, weight, grad, state):
        """Imperative update used by kvstore updaters / Module.update:
        ``weight`` and the state's NDArrays are written in place."""
        if not (isinstance(weight, NDArray) and isinstance(grad, NDArray)):
            raise MXNetError("Optimizer.update takes NDArrays")
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        tstate = _state_map(lambda a: a.data, state)
        with torch.no_grad():
            new_w, new_state = self._step(weight.data, grad.data, tstate,
                                          lr, wd, t)
        weight._set_data(new_w)
        if state is not None:
            if isinstance(state, (tuple, list)):
                for nd, a in zip(state, new_state):
                    nd._set_data(a)
            else:
                state._set_data(new_state)


register = Optimizer.register
create = Optimizer.create_optimizer


def _t_tensor(t, like):
    """The update count as a float32 scalar on the weight's device, as the
    JAX package casts it (``t.astype(float32)``)."""
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


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
        return _zeros(shape, dtype, device)

    def update_fn(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if state is None:
            return weight - lr * g, None
        m = self.momentum * state - lr * g
        return weight + m, m


@register
class NAG(SGD):
    """Nesterov accelerated SGD (parity: optimizer.py:313)."""

    def update_fn(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        if state is None:
            return weight - lr * g, None
        m = self.momentum * state + g
        lookahead = g + self.momentum * m
        return weight - lr * lookahead, m


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (parity: optimizer.py:361):
    w -= lr/2 * (grad + wd*w) + N(0, lr).

    The noise comes from an explicit ``torch.Generator`` on the CPU seeded
    with ``seed`` (one draw per update, copied to the weight's device), so
    a seed gives the same noise on every device; it is not the JAX
    package's noise.  ``update_fn`` takes the noise from :meth:`noise`."""

    def __init__(self, seed=0, **kwargs):
        super().__init__(**kwargs)
        self.seed = seed
        self._generator = None

    def __getstate__(self):
        d = self.__dict__.copy()
        gen = d.pop("_generator")
        d["_generator_state"] = None if gen is None else gen.get_state()
        return d

    def __setstate__(self, d):
        state = d.pop("_generator_state", None)
        self.__dict__.update(d)
        self._generator = None
        if state is not None:
            self._generator = torch.Generator()
            self._generator.set_state(state)

    def noise(self, weight):
        """A standard normal draw of the weight's shape and dtype."""
        if self._generator is None:
            self._generator = torch.Generator()
            self._generator.manual_seed(int(self.seed))
        z = torch.randn(tuple(weight.shape), generator=self._generator,
                        dtype=torch.float32)
        return z.to(device=weight.device, dtype=weight.dtype)

    def update_fn(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        noise = self.noise(weight) * (float(lr) ** 0.5)
        return weight - lr / 2.0 * g + noise, None


@register
class ccSGD(SGD):
    """Reference ccSGD (optimizer.py:426) ran SGD inside the C++ engine;
    here it is SGD, kept for API parity and for pickling to the kvstore
    (and the fused sweep runs SGD's body for it)."""


@register
class Adam(Optimizer):
    """Adam (parity: optimizer.py:504).  state = (mean, var); the bias
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
        return _zeros(shape, dtype, device, 2)

    def update_fn(self, weight, grad, state, lr, wd, t):
        if state is None:
            raise MXNetError("Adam needs its (mean, var) state")
        mean, var = state
        g = grad + wd * weight
        mean = self.beta1 * mean + (1.0 - self.beta1) * g
        var = self.beta2 * var + (1.0 - self.beta2) * g * g
        tf = _t_tensor(t, weight)
        mhat = mean / (1.0 - self.beta1 ** tf)
        vhat = var / (1.0 - self.beta2 ** tf)
        w = weight - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return w, (mean, var)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (the JAX package's AdamW)."""

    elementwise = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device, 2)

    def update_fn(self, weight, grad, state, lr, wd, t):
        mean, var = state
        mean = self.beta1 * mean + (1.0 - self.beta1) * grad
        var = self.beta2 * var + (1.0 - self.beta2) * grad * grad
        tf = _t_tensor(t, weight)
        mhat = mean / (1.0 - self.beta1 ** tf)
        vhat = var / (1.0 - self.beta2 ** tf)
        w = weight - lr * (mhat / (torch.sqrt(vhat) + self.epsilon)
                           + wd * weight)
        return w, (mean, var)


@register
class AdaGrad(Optimizer):
    """AdaGrad (parity: optimizer.py:605).  state = sum of squared
    gradients."""

    elementwise = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device)

    def update_fn(self, weight, grad, state, lr, wd, t):
        g = grad + wd * weight
        hist = state + g * g
        w = weight - lr * g / torch.sqrt(hist + self.float_stable_eps)
        return w, hist


@register
class RMSProp(Optimizer):
    """RMSProp, Graves-style with momentum of the update (parity:
    optimizer.py:654).

    state = (n, g, delta): n = ema(grad^2), g = ema(grad),
    delta = gamma2*delta - lr*grad/sqrt(n - g^2 + 1e-4); w += delta.
    """

    elementwise = True
    #: the constant under the square root
    EPS = 1e-4

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device, 3)

    def update_fn(self, weight, grad, state, lr, wd, t):
        n, g, delta = state
        grad = grad + wd * weight
        n = (1.0 - self.gamma1) * grad * grad + self.gamma1 * n
        g = (1.0 - self.gamma1) * grad + self.gamma1 * g
        delta = self.gamma2 * delta - lr * grad / torch.sqrt(
            n - g * g + self.EPS)
        return weight + delta, (n, g, delta)


@register
class AdaDelta(Optimizer):
    """AdaDelta (parity: optimizer.py:728).  state = (acc_g, acc_delta);
    the learning rate is not used."""

    elementwise = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device, 2)

    def update_fn(self, weight, grad, state, lr, wd, t):
        acc_g, acc_delta = state
        g = grad + wd * weight
        acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_delta = self.rho * acc_delta + (1.0 - self.rho) * delta * delta
        return weight - delta, (acc_g, acc_delta)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (the JAX package's LAMB):
    Adam's step scaled by the trust ratio ||w|| / ||r|| of each tensor."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device, 2)

    def update_fn(self, weight, grad, state, lr, wd, t):
        mean, var = state
        mean = self.beta1 * mean + (1.0 - self.beta1) * grad
        var = self.beta2 * var + (1.0 - self.beta2) * grad * grad
        tf = _t_tensor(t, weight)
        mhat = mean / (1.0 - self.beta1 ** tf)
        vhat = var / (1.0 - self.beta2 ** tf)
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * weight
        w_norm = torch.linalg.vector_norm(weight)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return weight - lr * trust * r, (mean, var)


@register
class Test(Optimizer):
    """Test optimizer (parity: optimizer.py:782; the distributed kvstore
    tests' server-side update): ``update_fn`` is w + grad, the imperative
    ``update`` w + grad * rescale_grad."""

    elementwise = True

    def create_state_arrays(self, shape, dtype=torch.float32, device=None):
        return _zeros(shape, dtype, device)

    def update_fn(self, weight, grad, state, lr, wd, t):
        return weight + grad * 1.0 - 0.0 * lr, state

    def update(self, index, weight, grad, state):
        weight._set_data(weight.data + grad.data * self.rescale_grad)


def get_updater(optimizer):
    """Closure used as kvstore updater (parity: optimizer.py:801)."""
    states = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])
    updater.optimizer = optimizer
    updater.states = states
    return updater

