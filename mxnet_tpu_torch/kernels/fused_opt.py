"""Fused optimizer step: bucketed flatten -> update -> unflatten.

The port of ``mxnet_tpu/kernels/fused_opt.py``.  The per-leaf optimizer
loop of ``ShardedTrainer.step`` launches several small kernels per
parameter; this module replaces it with one sweep per size-targeted
bucket:

1. leaves are grouped by dtype and packed into buckets by
   ``parallel.overlap.partition_buckets`` (``MXTPU_FUSED_OPT_BUCKET_MB``,
   default 64);
2. each bucket's weights, gradients and state leaves are flattened and
   concatenated into single vectors (``torch.cat``, as the JAX package
   concatenates inside its traced step);
3. one update runs over the concatenated vectors: the hand-written CUDA
   sweep ``csrc/fused_opt.cu`` with ``MXTPU_FUSED_OPT=kernel``
   (:func:`sweep`), the optimizer's plain ``update_fn`` with
   ``MXTPU_FUSED_OPT=1``;
4. the results are split back into views of the original leaf shapes.

Only optimizers whose update is elementwise (``Optimizer.elementwise``)
may be fused: then flatten/concat commutes with the update exactly,
including the gradient's preprocessing, and the fused step is bitwise
equal to the leafwise one.  The CUDA sweep has one body per optimizer
(SGD with and without momentum, Adam); kernel mode with any other
optimizer raises, and nothing switches to mode ``'1'`` behind the
caller's back.

- :func:`sweep_reference` is the plain PyTorch version of one bucket's
  update (``_preprocess_grad`` then ``update_fn``).
- :func:`sweep` is the wrapper of the CUDA kernel; it updates the weight
  and state vectors in place.  CPU tensors take the plain version (and
  are then written back in place too); CUDA tensors launch the kernel or
  raise.  ``sweep.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .common import env_flag

__all__ = ["fused_opt_mode", "bucket_nbytes", "supports_fused",
           "plan_buckets", "sweep_body", "sweep_reference", "sweep",
           "fused_apply"]


def fused_opt_mode(explicit=None):
    """``MXTPU_FUSED_OPT``: '' (off), '1' (fused plain sweep), 'kernel'
    (fused CUDA sweep).  ``explicit`` overrides the env."""
    mode = explicit if explicit is not None else env_flag("MXTPU_FUSED_OPT")
    if mode in (True, 1):
        mode = "1"
    if mode in ("", "0", False, None):
        return ""
    if mode not in ("1", "kernel"):
        raise MXNetError("MXTPU_FUSED_OPT must be '', '1' or 'kernel', "
                         "got %r" % (mode,))
    return mode


def bucket_nbytes(explicit=None):
    """Bucket size target in bytes (``MXTPU_FUSED_OPT_BUCKET_MB``,
    default 64 MB)."""
    if explicit is not None:
        return int(explicit)
    try:
        mb = float(env_flag("MXTPU_FUSED_OPT_BUCKET_MB") or 64)
    except ValueError:
        mb = 64.0
    return int(mb * (1 << 20))


def supports_fused(optimizer):
    """True when the optimizer's update is elementwise (flatten-safe)."""
    return bool(getattr(optimizer, "elementwise", False))


def plan_buckets(params, names=None, nbytes=None):
    """Partition param names into fused buckets: same-dtype leaves pack
    together, each group split by the size-targeted greedy partition.
    Returns ``[[name, ...], ...]`` covering every name."""
    from ..parallel.overlap import partition_buckets, _nbytes
    names = list(names if names is not None else params)
    by_dtype = {}
    for n in names:
        by_dtype.setdefault(str(params[n].dtype), []).append(n)
    target = bucket_nbytes(nbytes)
    buckets = []
    for _dt, group in sorted(by_dtype.items()):
        sized = [(n, _nbytes(params[n])) for n in group]
        buckets.extend(partition_buckets(sized, target))
    return buckets


# ----------------------------------------------------------------------
# state structure: None, one tensor, or a tuple of tensors
# ----------------------------------------------------------------------
def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


def _state_like(optimizer, leaves):
    """Rebuild the optimizer's state structure from its leaves."""
    proto = optimizer.create_state_arrays((1,))
    if proto is None:
        return None
    if isinstance(proto, (tuple, list)):
        return tuple(leaves)
    return leaves[0]


def _n_state(optimizer):
    return len(_state_leaves(optimizer.create_state_arrays((1,))))


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------
def sweep_body(optimizer):
    """The CUDA sweep's body code for ``optimizer``: 0 SGD, 1 SGD with
    momentum, 2 Adam.  Raises for any other optimizer (a subclass that
    overrides ``update_fn`` included): its body is not written."""
    from ..optimizer import SGD, Adam
    kind = type(optimizer)
    if kind is SGD:
        return 1 if optimizer.momentum != 0.0 else 0
    if kind is Adam:
        return 2
    raise MXNetError(
        "MXTPU_FUSED_OPT=kernel: the CUDA sweep has no body for %s (it has "
        "SGD and Adam); use MXTPU_FUSED_OPT='' for this optimizer"
        % kind.__name__)


def sweep_reference(optimizer, w, g, states, lr, wd, t, preprocess=True):
    """Plain version of one bucket's update: ``_preprocess_grad`` (when
    ``preprocess``), then ``update_fn``.  ``states`` is the list of flat
    state vectors.  Pure: returns ``(new_w, [new_state, ...])``."""
    if preprocess:
        g = optimizer._preprocess_grad(g)
    nw, ns = optimizer.update_fn(w, g, _state_like(optimizer, states),
                                 lr, wd, t)
    return nw, _state_leaves(ns)


def _check_sweep(w, g, states, n_state):
    if len(states) != n_state:
        raise MXNetError("fused sweep: %d state vectors given, the "
                         "optimizer has %d" % (len(states), n_state))
    for name, x in [("w", w), ("g", g)] + [("state%d" % i, s)
                                          for i, s in enumerate(states)]:
        if x.dtype != torch.float32:
            raise MXNetError("fused sweep: the CUDA kernel takes float32, "
                             "%s is %s" % (name, x.dtype))
        if not x.is_cuda or x.device != w.device:
            raise MXNetError("fused sweep: %s is on %s, w on %s"
                             % (name, x.device, w.device))
        if x.dim() != 1 or x.numel() != w.numel():
            raise MXNetError("fused sweep: %s must be a flat vector of %d "
                             "elements, got %s" % (name, w.numel(),
                                                   tuple(x.shape)))
        if not x.is_contiguous():
            raise MXNetError("fused sweep: %s must be contiguous" % name)


def sweep(optimizer, w, g, states, lr, wd, t, preprocess=True):
    """One bucket's update, IN PLACE on ``w`` and ``states`` (flat
    vectors); returns ``(w, states)``.  CPU tensors take
    :func:`sweep_reference` and copy its results back; CUDA tensors
    launch ``csrc/fused_opt.cu`` (float32 only) or raise."""
    if not w.is_cuda:
        nw, ns = sweep_reference(optimizer, w, g, states, lr, wd, t,
                                 preprocess)
        w.copy_(nw)
        for s, n in zip(states, ns):
            s.copy_(n)
        return w, states
    from ._build import check, library
    body = sweep_body(optimizer)
    _check_sweep(w, g, states, _n_state(optimizer))
    if w.numel() == 0:
        return w, states
    rescale, clip = 1.0, -1.0
    if preprocess:
        rescale = optimizer.rescale_grad
        if optimizer.clip_gradient is not None:
            clip = optimizer.clip_gradient
    ptrs = [s.data_ptr() for s in states] + [None] * (2 - len(states))
    beta1 = getattr(optimizer, "beta1", 0.0)
    beta2 = getattr(optimizer, "beta2", 0.0)
    lib = library("fused_opt")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        code = lib.mxtt_fused_opt_sweep(
            body, w.data_ptr(), g.data_ptr(), ptrs[0], ptrs[1],
            ctypes.c_longlong(w.numel()), float(lr), float(wd), float(t),
            float(rescale), float(clip),
            float(getattr(optimizer, "momentum", 0.0)),
            beta1, 1.0 - beta1, beta2, 1.0 - beta2,
            float(getattr(optimizer, "epsilon", 0.0)), stream)
    check(lib, code, "fused_opt sweep")
    sweep.launches += 1
    return w, states


#: launches of the CUDA kernel in this process (callers may reset it)
sweep.launches = 0


# ----------------------------------------------------------------------
# the fused apply
# ----------------------------------------------------------------------
def fused_apply(optimizer, params, grads, opt_state, lr, wd, t,
                names=None, nbytes=None, mode=None, preprocess=False):
    """One fused optimizer step over ``names`` (default: all params).

    Returns ``(new_params, new_opt_state)`` dicts for exactly the covered
    names; each new weight and state leaf is a view of its bucket's flat
    vector.  With ``preprocess`` the optimizer's own ``_preprocess_grad``
    is folded into the sweep, on the concatenated gradient: elementwise,
    so identical to per-leaf application.
    """
    if not supports_fused(optimizer):
        raise MXNetError(
            "%s is not elementwise (per-tensor norms or per-leaf rng): "
            "the fused optimizer sweep would change semantics"
            % type(optimizer).__name__)
    mode = fused_opt_mode(mode) or "1"
    if mode == "kernel":
        sweep_body(optimizer)
    names = list(names if names is not None else params)
    n_state = _n_state(optimizer)
    new_params, new_state = {}, {}
    for bucket in plan_buckets(params, names=names, nbytes=nbytes):
        sizes = [params[n].numel() for n in bucket]
        w_flat = torch.cat([params[n].reshape(-1) for n in bucket])
        g_flat = torch.cat([grads[n].reshape(-1) for n in bucket])
        states = []
        for i in range(n_state):
            leaves = []
            for n in bucket:
                got = _state_leaves(opt_state.get(n))
                if len(got) != n_state:
                    raise MXNetError("fused_apply: state of %r has %d "
                                     "leaves, the optimizer declares %d"
                                     % (n, len(got), n_state))
                leaves.append(got[i].reshape(-1))
            states.append(torch.cat(leaves))
        if mode == "kernel":
            nw, ns = sweep(optimizer, w_flat, g_flat, states, lr, wd, t,
                           preprocess=preprocess)
        else:
            nw, ns = sweep_reference(optimizer, w_flat, g_flat, states, lr,
                                     wd, t, preprocess=preprocess)
        w_parts = torch.split(nw, sizes)
        s_parts = [torch.split(s, sizes) for s in ns]
        for j, n in enumerate(bucket):
            shape = params[n].shape
            new_params[n] = w_parts[j].view(shape)
            new_state[n] = _state_like(
                optimizer, [p[j].view(shape) for p in s_parts]) \
                if n_state else None
    return new_params, new_state
