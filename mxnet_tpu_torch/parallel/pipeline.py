"""Microbatched pipeline parallelism over a ``pp`` mesh axis.

The port of ``mxnet_tpu/parallel/pipeline.py``.  A stack of identical
blocks is split over ``pp``: stage ``s`` holds layers ``[s*L/K,
(s+1)*L/K)`` on mesh member ``s`` (of each dp replica), the batch is cut
into ``M`` microbatches, and activations cross each stage boundary by
``collectives.send`` (a peer copy between two cards; nothing when two
stages share a device, as ``pp=2`` on one card does).  The JAX package
compiles the schedule into one program of ``ppermute``s inside
``shard_map``; the port runs it eagerly, in the schedule's slot order:

- ``gpipe``: the forward wave (``M + K - 1`` ticks, stage ``s`` busy on
  ticks ``[s, s + M)``), the head's loss over the whole local batch,
  then the mirrored backward wave, microbatch by microbatch, each stage's
  backward seeded with the gradient its successor sent back;
- ``1f1b``: the slots of :func:`build_1f1b_tables` (the same tables, the
  same greedy), one forward or one backward a stage a slot; the last
  stage turns each microbatch into its loss and its seed gradient at
  once, and the loss is the mean of the microbatch losses accumulated
  in microbatch order.

Each stage's forward keeps its autograd graph until that microbatch's
backward (the JAX 1F1B recomputes it from the stashed stage input; the
values are the same).  Gradients accumulate in the JAX package's order
(``gpipe``: the backward wave's, last microbatch first; ``1f1b``: the
microbatch order), and with ``dp`` they are averaged over the replicas
(the JAX ``pmean``).  The embedding and the head run on the first and the
last stage.

:func:`build_1f1b_tables` and :func:`schedule_occupancy` are the JAX
package's framework-free functions, copied whole; ``analysis/schedule``
prices the same tables.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["pipeline_apply", "GPipeTrainer", "build_1f1b_tables",
           "schedule_occupancy"]


# ----------------------------------------------------------------------
# 1F1B (one-forward-one-backward) schedule tables (copied from
# mxnet_tpu/parallel/pipeline.py)
# ----------------------------------------------------------------------
def build_1f1b_tables(k, m):
    """Lock-step 1F1B schedule for ``k`` stages x ``m`` microbatches.

    Returns ``(kind, mb)`` numpy int32 arrays of shape ``[S, k]`` where
    slot table entry ``kind[t, s]`` is 0 idle / 1 forward / 2 backward
    (mid stage) / 3 backward (last stage, initiates the microbatch's
    gradient from its loss) and ``mb[t, s]`` the microbatch index.

    Construction is the standard synchronous 1F1B greedy: each stage
    prefers a backward whose gradient has arrived, else a forward whose
    activation has arrived — capped at ``k - s`` in-flight microbatches
    (the activation stash the analyzer prices).  A payload sent at slot
    ``t`` is usable from slot ``t + 1``.
    """
    k, m = int(k), int(m)
    if k < 1 or m < 1:
        raise ValueError("1F1B needs k >= 1 stages and m >= 1 "
                         "microbatches (got k=%d m=%d)" % (k, m))
    f_slot = [[None] * m for _ in range(k)]
    b_slot = [[None] * m for _ in range(k)]
    f_done = [0] * k
    b_done = [0] * k
    kind_rows, mb_rows = [], []
    t = 0
    while min(b_done) < m:
        krow, mrow = [0] * k, [0] * k
        for s in range(k):
            jb, jf = b_done[s], f_done[s]
            can_b = jb < m and (
                (s == k - 1 and f_slot[s][jb] is not None
                 and f_slot[s][jb] < t) or
                (s < k - 1 and b_slot[s + 1][jb] is not None
                 and b_slot[s + 1][jb] < t))
            can_f = jf < m and (f_done[s] - b_done[s]) < (k - s) and (
                s == 0 or (f_slot[s - 1][jf] is not None
                           and f_slot[s - 1][jf] < t))
            if can_b:
                krow[s] = 3 if s == k - 1 else 2
                mrow[s] = jb
                b_slot[s][jb] = t
                b_done[s] += 1
            elif can_f:
                krow[s] = 1
                mrow[s] = jf
                f_slot[s][jf] = t
                f_done[s] += 1
        kind_rows.append(krow)
        mb_rows.append(mrow)
        t += 1
        if t > 4 * (m + k) + 8:  # the greedy above always terminates;
            raise RuntimeError(   # belt-and-braces against table bugs
                "1F1B schedule did not converge for k=%d m=%d" % (k, m))
    return (_np.asarray(kind_rows, dtype=_np.int32),
            _np.asarray(mb_rows, dtype=_np.int32))


def schedule_occupancy(k, m, schedule="1f1b", fwd_time=1.0, bwd_time=2.0):
    """Measured bubble fraction of the lock-step schedule the trainer
    actually executes: slot-occupancy of the static tables,
    time-weighted (backward ~ 2x forward by default), with each slot's
    wall time set by its slowest member.  Independent of the analyzer's
    event-driven simulator."""
    if schedule == "1f1b":
        kind, _ = build_1f1b_tables(k, m)
    elif schedule == "gpipe":
        # GPipe: m+k-1 fill/drain fwd ticks then the mirrored bwd ticks
        kind = _np.zeros((2 * (m + k - 1), k), dtype=_np.int32)
        for t in range(m + k - 1):
            for s in range(k):
                if s <= t < s + m:
                    kind[t, s] = 1
                    kind[2 * (m + k - 1) - 1 - t, s] = 3
    else:
        raise ValueError("unknown schedule %r" % (schedule,))
    w = _np.where(kind == 0, 0.0,
                  _np.where(kind == 1, float(fwd_time), float(bwd_time)))
    total = float(w.max(axis=1).sum())
    busy = float(w.sum())
    bubble = 1.0 - busy / (kind.shape[1] * total) if total else 0.0
    return {"slots": int(kind.shape[0]), "busy_time": busy,
            "total_time": total, "bubble_fraction": bubble}


# ----------------------------------------------------------------------
# trees of tensors: dicts (keys in sorted order, as jax flattens them),
# lists and tuples
# ----------------------------------------------------------------------
def _flatten(tree):
    """``(leaves, rebuild)``: the leaves in order, and a function that
    builds the same structure from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (sub, fn) in zip(keys, parts):
                out[k] = fn(leaves[i:i + len(sub)])
                i += len(sub)
            return out
        return [x for sub, _ in parts for x in sub], rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        kind = type(tree)

        def rebuild(leaves):
            out, i = [], 0
            for sub, fn in parts:
                out.append(fn(leaves[i:i + len(sub)]))
                i += len(sub)
            return kind(out)
        return [x for sub, _ in parts for x in sub], rebuild
    return [tree], lambda leaves: leaves[0]


def _as_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    arr = _np.asarray(a)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return torch.from_numpy(_np.ascontiguousarray(arr).copy()).to(device)


def _stack_apply(block_fn, layers, rebuild, h):
    """``h`` through a stage's stacked layers (``layers``: leaves of
    shape ``[n, ...]``), in order."""
    for i in range(layers[0].shape[0]):
        h = block_fn(rebuild([a[i] for a in layers]), h)
    return h


def pipeline_apply(block_fn, stage_layers, microbatches, devices,
                   rebuild=None):
    """Run the microbatch stream through the pipeline in the GPipe
    forward wave: tick ``t`` runs microbatch ``t - s`` on stage ``s``.

    block_fn : (layer_params, h) -> h for ONE block.
    stage_layers : one list of stacked leaves (leading dim ``L/K``) a
        stage, on ``devices[s]`` (``rebuild`` turns one layer's leaves
        into ``block_fn``'s params; default: a list).
    microbatches : ``M`` tensors on ``devices[0]``.
    Returns ``(outputs, inputs, stage_outputs)``: the last stage's ``M``
    outputs, and each stage's input and output a microbatch (the
    stage inputs after the first are leaves that require grad when the
    stream does: a stage's backward ends at its input).
    """
    from .collectives import send
    rebuild = rebuild or list
    k, m = len(stage_layers), len(microbatches)
    grad = torch.is_grad_enabled()
    ins = [[None] * m for _ in range(k)]
    outs = [[None] * m for _ in range(k)]
    for t in range(m + k - 1):
        for s in range(k):
            j = t - s
            if not 0 <= j < m:
                continue
            if s == 0:
                x = microbatches[j]
            else:
                x = send(outs[s - 1][j].detach(), devices[s])
                if grad:
                    x.requires_grad_(True)
            ins[s][j] = x
            outs[s][j] = _stack_apply(block_fn, stage_layers[s], rebuild, x)
    return outs[k - 1], ins, outs


class GPipeTrainer:
    """Microbatched pipeline trainer for repeated-block models.

    Parameters
    ----------
    embed_fn / block_fn / head_loss_fn : functions of tensors
        ``embed_fn(embed_params, batch) -> h`` (token/patch embedding),
        ``block_fn(layer_params, h) -> h`` (ONE block; applied L times
        from stacked params), ``head_loss_fn(head_params, h, batch) ->
        scalar loss`` (mean over the microbatch).  Params are dicts (or
        lists) of tensors; ``batch`` a dict of tensors.
    params : dict with keys ``embed``, ``layers`` (stacked [L, ...]),
        ``head``: the JAX package's layout, numpy arrays or tensors.
    mesh : mesh with a ``pp`` axis (optionally ``dp``).
    optimizer : the port's optimizer (its ``update_fn`` is applied leaf
        by leaf, as in the JAX trainer).
    num_microbatches : M; the global batch must divide into M * dp.
    schedule : ``"gpipe"`` or ``"1f1b"`` (needs pp >= 2).
    """

    def __init__(self, embed_fn, block_fn, head_loss_fn, params, mesh,
                 optimizer, num_microbatches=4, schedule="gpipe"):
        if "pp" not in mesh.axis_names:
            raise ValueError("GPipeTrainer needs a 'pp' mesh axis")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError("schedule must be 'gpipe' or '1f1b', got %r"
                             % (schedule,))
        if schedule == "1f1b" and mesh.shape["pp"] < 2:
            raise ValueError("1f1b schedule needs pp >= 2")
        if set(mesh.axis_names) - {"pp", "dp"} and any(
                mesh.shape[a] > 1 for a in mesh.axis_names
                if a not in ("pp", "dp")):
            raise ValueError("GPipeTrainer takes pp and dp axes only, got "
                             "%s" % dict(mesh.shape))
        self.schedule = schedule
        self.mesh = mesh
        self.pp = mesh.shape["pp"]
        self.dp = mesh.shape.get("dp", 1)
        self.m = int(num_microbatches)
        self.optimizer = optimizer
        self._embed_fn = embed_fn
        self._block_fn = block_fn
        self._head_loss_fn = head_loss_fn
        self.num_update = 0
        self._schedule_emitted = False

        layer_leaves, self._layer_rebuild = _flatten(params["layers"])
        n_layers = int(_np.shape(layer_leaves[0])[0])
        if n_layers % self.pp:
            raise ValueError("pp (%d) must divide layers (%d)"
                             % (self.pp, n_layers))
        self.n_layers = n_layers
        per = n_layers // self.pp
        # device of stage s in dp replica d
        self._dev = [[mesh.devices[i] for i in mesh.members(pp=s)]
                     for s in range(self.pp)]
        self._groups = [mesh.group_of(mesh.members(pp=s))
                        for s in range(self.pp)]
        embed_leaves, self._embed_rebuild = _flatten(params["embed"])
        head_leaves, self._head_rebuild = _flatten(params["head"])
        # the parameters, one copy a dp replica: {"embed": [d][leaf],
        # "layers": [s][d][leaf], "head": [d][leaf]}
        self._p = {
            "embed": [[_as_tensor(a, dev) for a in embed_leaves]
                      for dev in self._dev[0]],
            "layers": [[[_as_tensor(a[s * per:(s + 1) * per], dev)
                         for a in layer_leaves]
                        for dev in self._dev[s]] for s in range(self.pp)],
            "head": [[_as_tensor(a, dev) for a in head_leaves]
                     for dev in self._dev[-1]],
        }

        def states(copies):
            return [[optimizer.create_state_arrays(a.shape, a.dtype,
                                                   a.device)
                     for a in leaves] for leaves in copies]
        self._s = {"embed": states(self._p["embed"]),
                   "layers": [states(stage) for stage in self._p["layers"]],
                   "head": states(self._p["head"])}

    @property
    def params(self):
        """The parameters in the JAX package's layout, as numpy, from the
        first dp replica's copies (the layer stacks of every stage
        concatenated)."""
        def host(leaves):
            return [a.detach().cpu().numpy() for a in leaves]
        layers = [_np.concatenate([host(self._p["layers"][s][0])[i]
                                   for s in range(self.pp)])
                  for i in range(len(self._p["layers"][0][0]))]
        return {"embed": self._embed_rebuild(host(self._p["embed"][0])),
                "layers": self._layer_rebuild(layers),
                "head": self._head_rebuild(host(self._p["head"][0]))}

    def schedule_occupancy(self):
        """Measured schedule occupancy (bubble fraction etc.) of the
        lock-step tables this trainer executes."""
        return schedule_occupancy(self.pp, self.m, self.schedule)

    # -- the step --------------------------------------------------------
    def _replica_batch(self, batch, d, device):
        """dp replica ``d``'s rows of the batch, on ``device``."""
        rows = _np.shape(next(iter(batch.values())))[0] // self.dp
        return {k: _as_tensor(v[d * rows:(d + 1) * rows], device)
                for k, v in batch.items()}

    def _microbatches(self, batch):
        return [{k: v.reshape((self.m, v.shape[0] // self.m)
                              + tuple(v.shape[1:]))[j]
                 for k, v in batch.items()} for j in range(self.m)]

    def _replica_grads(self, batch, d):
        """One dp replica's loss and gradients (unscaled by dp): the
        loss a float tensor, the gradients as ``.grad`` of the leaves
        returned (``{"embed": [...], "layers": [s][...], "head":
        [...]}``)."""
        from .collectives import send
        k, m = self.pp, self.m
        leaves = {
            "embed": [a.detach().requires_grad_(True)
                      for a in self._p["embed"][d]],
            "layers": [[a.detach().requires_grad_(True)
                        for a in self._p["layers"][s][d]]
                       for s in range(k)],
            "head": [a.detach().requires_grad_(True)
                     for a in self._p["head"][d]],
        }
        devs = [self._dev[s][d] for s in range(k)]
        b0 = self._replica_batch(batch, d, devs[0])
        bk = b0 if devs[-1] == devs[0] else \
            self._replica_batch(batch, d, devs[-1])
        block, rebuild = self._block_fn, self._layer_rebuild
        with torch.enable_grad():
            h = self._embed_fn(self._embed_rebuild(leaves["embed"]), b0)
            stream = h.reshape((m, h.shape[0] // m) + tuple(h.shape[1:]))
            xs0 = [stream[j].detach().requires_grad_(True)
                   for j in range(m)]
            dstream = [None] * m
            head_p = self._head_rebuild(leaves["head"])
            if self.schedule == "gpipe":
                last, ins, outs = pipeline_apply(
                    block, leaves["layers"], xs0, devs, rebuild)
                zs = [y.detach().requires_grad_(True) for y in last]
                loss = self._head_loss_fn(head_p, torch.cat(zs), bk)
                loss.backward()
                # the mirrored backward wave: tick tt runs microbatch
                # m + k - 2 - tt - s on stage s
                g_in = [[None] * m for _ in range(k)]
                for tt in range(m + k - 1):
                    for s in range(k - 1, -1, -1):
                        j = m + k - 2 - tt - s
                        if not 0 <= j < m:
                            continue
                        g = zs[j].grad if s == k - 1 else g_in[s][j]
                        torch.autograd.backward(outs[s][j], g)
                        gx = ins[s][j].grad
                        if s:
                            g_in[s - 1][j] = send(gx, devs[s - 1])
                        else:
                            dstream[j] = gx
                torch.autograd.backward(h, torch.stack(dstream)
                                        .reshape(h.shape))
            else:
                loss = self._run_1f1b(leaves, xs0, bk, devs, head_p,
                                      dstream)
                torch.autograd.backward(
                    h, torch.stack(dstream).reshape(h.shape) / m)
        return loss.detach(), leaves

    def _run_1f1b(self, leaves, xs0, batch, devs, head_p, dstream):
        """The slots of :func:`build_1f1b_tables`; returns the mean of
        the microbatch losses.  The head's and the layers' gradients are
        left summed over the microbatches, divided by M at the end, as
        the JAX trainer divides them."""
        from .collectives import send
        k, m = self.pp, self.m
        kind, mb = build_1f1b_tables(k, m)
        mbs = self._microbatches(batch)
        ins = [[None] * m for _ in range(k)]
        outs = [[None] * m for _ in range(k)]
        act = [[None] * m for _ in range(k)]      # arrivals from s - 1
        grad = [[None] * m for _ in range(k)]     # arrivals from s + 1
        loss_sum = torch.zeros((), dtype=xs0[0].dtype, device=devs[-1])
        for t in range(kind.shape[0]):
            sends = []
            for s in range(k):
                kd, j = int(kind[t, s]), int(mb[t, s])
                if kd == 1:
                    x = xs0[j] if s == 0 else act[s][j]
                    ins[s][j] = x
                    outs[s][j] = _stack_apply(self._block_fn,
                                              leaves["layers"][s],
                                              self._layer_rebuild, x)
                    if s < k - 1:
                        sends.append(("f", s + 1, j, outs[s][j].detach()))
                elif kd >= 2:
                    if kd == 3:
                        loss_j = self._head_loss_fn(head_p, outs[s][j],
                                                    mbs[j])
                        loss_sum = loss_sum + loss_j.to(loss_sum.dtype)
                        loss_j.backward()
                    else:
                        torch.autograd.backward(outs[s][j], grad[s][j])
                    gx = ins[s][j].grad
                    outs[s][j] = ins[s][j] = None
                    if s:
                        sends.append(("b", s - 1, j, gx))
                    else:
                        dstream[j] = gx
            # a payload sent at slot t is usable from slot t + 1
            for way, s, j, v in sends:
                v = send(v, devs[s])
                if way == "f":
                    act[s][j] = v.requires_grad_(True)
                else:
                    grad[s][j] = v
        for leaf in leaves["head"] + [a for stage in leaves["layers"]
                                      for a in stage]:
            if leaf.grad is not None:
                leaf.grad = leaf.grad / m
        return loss_sum / m

    def step(self, batch):
        """One pipelined train step on a host batch dict; returns the
        loss (a float)."""
        from .collectives import all_reduce
        rows = _np.shape(next(iter(batch.values())))[0]
        if rows % (self.m * self.dp):
            raise ValueError(
                "batch rows (%d) must divide into num_microbatches (%d) "
                "* dp (%d)" % (rows, self.m, self.dp))
        if not self._schedule_emitted:
            self._schedule_emitted = True
            from ..observability import events as _events
            if _events.enabled():
                occ = self.schedule_occupancy()
                _events.emit("schedule", schedule=self.schedule,
                             stages=self.pp, microbatches=self.m,
                             bubble_fraction=round(
                                 occ["bubble_fraction"], 4))
        self.num_update += 1
        opt = self.optimizer
        lr = (opt.lr_scheduler(self.num_update)
              if opt.lr_scheduler is not None else opt.lr)
        got = [self._replica_grads(batch, d) for d in range(self.dp)]
        losses = [g[0] for g in got]

        def grads_of(part, s=None):
            """[d][leaf] gradients of one part (a stage of the layers),
            averaged over dp."""
            per = [(g[1][part] if s is None else g[1][part][s])
                   for g in got]
            out = [[a.grad if a.grad is not None else torch.zeros_like(a)
                    for a in leaves] for leaves in per]
            if self.dp == 1:
                return out
            group = self._groups[0 if part == "embed" else
                                 self.pp - 1 if part == "head" else s]
            sizes = [a.numel() for a in out[0]]
            flats = all_reduce(group, [torch.cat([a.reshape(-1)
                                                  for a in g])
                                       for g in out])
            return [[p.view(a.shape) / self.dp
                     for p, a in zip(torch.split(f, sizes), out[0])]
                    for f in flats]
        with torch.no_grad():
            self._update("embed", grads_of("embed"), lr)
            self._update("head", grads_of("head"), lr)
            for s in range(self.pp):
                self._update("layers", grads_of("layers", s), lr, s)
        dev = losses[0].device
        return float(sum(v.to(dev) for v in losses) / self.dp)

    def _update(self, part, grads, lr, s=None):
        opt = self.optimizer
        params = self._p[part] if s is None else self._p[part][s]
        states = self._s[part] if s is None else self._s[part][s]
        for d in range(len(params)):
            dev = params[d][0].device if params[d] else None
            t_dev = torch.tensor(float(self.num_update), device=dev)
            for i in range(len(params[d])):
                params[d][i], states[d][i] = opt.update_fn(
                    params[d][i], opt._preprocess_grad(grads[d][i]),
                    states[d][i], lr, opt.wd, t_dev)

    # -- checkpoint / resume (the host format, parallel/ckpt.py) --------
    def _ckpt_tree(self):
        def state(v):
            if isinstance(v, (tuple, list)):
                return {str(i): a for i, a in enumerate(v)}
            return v

        def states(leaves):
            return {str(i): state(v) for i, v in enumerate(leaves)
                    if v is not None}
        layer_states = []
        for i in range(len(self._s["layers"][0][0])):
            v = self._s["layers"][0][0][i]
            if v is None:
                layer_states.append(None)
                continue
            parts = [self._s["layers"][s][0][i] for s in range(self.pp)]
            if isinstance(v, (tuple, list)):
                layer_states.append(tuple(
                    torch.cat([p[c].cpu() for p in parts])
                    for c in range(len(v))))
            else:
                layer_states.append(torch.cat([p.cpu() for p in parts]))
        params = self.params
        return {"params": {"embed": _tree_dict(params["embed"]),
                           "layers": _tree_dict(params["layers"]),
                           "head": _tree_dict(params["head"])},
                "opt_state": {"embed": states(self._s["embed"][0]),
                              "layers": states(layer_states),
                              "head": states(self._s["head"][0])}}

    def save_checkpoint(self, path):
        """Write the parameters, the optimizer state and the update
        counter to the directory ``path`` in the port's host format
        (``parallel/ckpt.py``; the JAX trainer writes orbax's sharded
        format, ROADMAP.md queue 1 item 3 (f))."""
        from .ckpt import host_save
        return host_save(path, self._ckpt_tree(), self.num_update)

    def load_checkpoint(self, path):
        """Restore in place; the update counter resumes (lr schedules and
        Adam's bias correction continue where they stopped)."""
        from .ckpt import host_restore
        tree, step = host_restore(path, self._ckpt_tree())
        per = self.n_layers // self.pp
        for part in ("embed", "head"):
            leaves = _tree_leaves(tree["params"][part])
            stage = 0 if part == "embed" else self.pp - 1
            for d, dev in enumerate(self._dev[stage]):
                self._p[part][d] = [_as_tensor(a, dev) for a in leaves]
                self._s[part][d] = _restore_states(
                    tree["opt_state"][part], self._s[part][d], dev)
        leaves = _tree_leaves(tree["params"]["layers"])
        for s in range(self.pp):
            for d, dev in enumerate(self._dev[s]):
                self._p["layers"][s][d] = [
                    _as_tensor(a[s * per:(s + 1) * per], dev)
                    for a in leaves]
                self._s["layers"][s][d] = _restore_states(
                    tree["opt_state"]["layers"], self._s["layers"][s][d],
                    dev, slice(s * per, (s + 1) * per))
        self.num_update = step
        return self

    # -- symbol-language entry ----------------------------------------
    @classmethod
    def from_block_symbol(cls, block_sym, *, n_layers, mesh, optimizer,
                          embed_fn, head_loss_fn, embed_params,
                          head_params, input_shape, data_name="data",
                          initializer=None, num_microbatches=4,
                          seed=0, schedule="gpipe"):
        """Build the pipeline from ONE block defined in the Symbol
        language: the block symbol is traced through the port's executor
        into ``block_fn`` and replicated ``n_layers`` times with
        independently-initialized stacked parameters (drawn from a
        generator of their own, seeded with ``seed``: the caller's
        ``mx.random`` stream is untouched).

        Constraints (raise otherwise): the block must be aux-free (no
        BatchNorm moving stats), rng-free (no op that draws random
        numbers: Dropout, attention with ``dropout > 0``), and must map
        ``data_name`` -> single output of the same shape.  The JAX
        package refuses every op that declares ``need_rng``, so its guard
        also refuses the LM's transformer block, whose attention declares
        it at ``dropout=0`` and draws nothing; the port's takes it.
        ``input_shape`` is the per-microbatch activation shape EXCLUDING
        the leading batch dim.
        """
        from ..executor import build_program
        from .. import initializer as init_mod
        from .. import ndarray as nd_mod

        if block_sym.list_auxiliary_states():
            raise ValueError("pipeline block must be aux-free (found %s)"
                             % block_sym.list_auxiliary_states())
        program = build_program(block_sym)
        if any(_draws(n.op) for n in block_sym._topo()
               if n.op is not None):
            raise ValueError("pipeline block must be rng-free (Dropout "
                             "etc. not supported in the microbatch "
                             "schedule)")
        args = block_sym.list_arguments()
        if data_name not in args:
            raise ValueError("block symbol has no input %r" % data_name)
        param_names = [n for n in args if n != data_name]
        if not param_names:
            raise ValueError("pipeline block has no parameters: nothing "
                             "to stack over %d layers" % n_layers)
        arg_shapes, out_shapes, _aux = block_sym.infer_shape(
            **{data_name: (1,) + tuple(input_shape)})
        if arg_shapes is None:
            raise ValueError(
                "pipeline block shapes are underdetermined from input "
                "%s: every parameter shape must follow from %r"
                % (tuple(input_shape), data_name))
        if len(out_shapes) != 1 or tuple(out_shapes[0][1:]) != tuple(
                input_shape):
            raise ValueError(
                "pipeline block must map %s -> one output of the same "
                "shape (got %s from %s)" % (input_shape, out_shapes,
                                            input_shape))
        shapes = dict(zip(args, arg_shapes))
        init = initializer or init_mod.Xavier()
        saved = init._generator
        init._generator = torch.Generator().manual_seed(int(seed))
        try:
            stacked = {}
            for n in param_names:
                layers = []
                for _li in range(n_layers):
                    arr = nd_mod.NDArray(torch.zeros(shapes[n]))
                    init(n, arr)
                    layers.append(arr.data.numpy())
                stacked[n] = _np.stack(layers)
        finally:
            init._generator = saved

        def block_fn(lp, h):
            merged = dict(lp)
            merged[data_name] = h
            outs, _aux_out = program.trace(merged, {}, None, True)
            return outs[0]

        params = {"embed": embed_params, "layers": stacked,
                  "head": head_params}
        return cls(embed_fn, block_fn, head_loss_fn, params, mesh,
                   optimizer, num_microbatches=num_microbatches,
                   schedule=schedule)

    # -- unpipelined references ---------------------------------------
    def _sequential_parts(self, batch):
        """The embedding and the whole layer stack over ``batch`` on the
        first stage's device, from the first dp replica's parameters."""
        dev = self._dev[0][0]
        layers = [torch.cat([self._p["layers"][s][0][i].to(dev)
                             for s in range(self.pp)])
                  for i in range(len(self._p["layers"][0][0]))]
        b = {k: _as_tensor(v, dev) for k, v in batch.items()}
        head = self._head_rebuild([a.to(dev) for a in self._p["head"][0]])
        embed = self._embed_rebuild(self._p["embed"][0])
        return b, embed, layers, head

    def sequential_loss(self, batch):
        """The unpipelined loss: the whole batch through the embedding,
        the layer stack and the head on one device."""
        with torch.no_grad():
            b, embed, layers, head = self._sequential_parts(batch)
            h = self._embed_fn(embed, b)
            h = _stack_apply(self._block_fn, layers, self._layer_rebuild, h)
            return float(self._head_loss_fn(head, h, b))

    def sequential_loss_microbatched(self, batch):
        """The unpipelined reference of the 1F1B loss: the whole batch
        through the layer stack on one device, then the mean of the
        microbatch head losses accumulated in microbatch order — the
        float summation the 1F1B schedule performs.  Where a product
        rounds alike at the batch's rows and a microbatch's (as on the
        CPU) the two agree bit for bit."""
        m = self.m
        with torch.no_grad():
            b, embed, layers, head = self._sequential_parts(batch)
            h = self._embed_fn(embed, b)
            h = _stack_apply(self._block_fn, layers, self._layer_rebuild, h)
            hm = h.reshape((m, h.shape[0] // m) + tuple(h.shape[1:]))
            mbs = self._microbatches(b)
            loss_sum = torch.zeros((), dtype=hm.dtype, device=hm.device)
            for j in range(m):
                loss_sum = loss_sum + self._head_loss_fn(
                    head, hm[j], mbs[j]).to(hm.dtype)
            return float(loss_sum / m)


def _draws(op):
    """Does ``op`` draw random numbers in a training forward?  An op that
    declares ``need_rng`` does, unless a ``dropout`` rate of 0 switches
    its only draw off."""
    if not getattr(op, "need_rng", False):
        return False
    rate = getattr(getattr(op, "param", None), "dropout", None)
    return rate is None or float(rate) > 0.0


def _tree_dict(tree):
    """A tree as nested dicts for the host format (a list's entries keyed
    by their index)."""
    if isinstance(tree, dict):
        return {k: _tree_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _tree_dict(v) for i, v in enumerate(tree)}
    return tree


def _tree_leaves(tree):
    """The leaves of a restored host tree in :func:`_flatten`'s order
    (a list's index keys sorted as numbers)."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (int(k), k) if k.isdigit()
                      else (float("inf"), k))
        return [x for k in keys for x in _tree_leaves(tree[k])]
    return [tree]


def _restore_states(saved, current, device, rows=None):
    """The optimizer states of one part restored from ``saved``
    (``{leaf index: state}``) onto ``device``; ``rows`` cuts a layer
    stack to a stage's layers."""
    def take(a):
        a = _np.asarray(a)
        return _as_tensor(a if rows is None else a[rows], device)
    out = []
    for i, v in enumerate(current):
        if v is None:
            out.append(None)
        elif isinstance(v, (tuple, list)):
            out.append(tuple(take(saved[str(i)][str(c)])
                             for c in range(len(v))))
        else:
            out.append(take(saved[str(i)]))
    return out
