#!/usr/bin/env python3
"""Where the time of a data-parallel training step goes, by card.

Run from the root of a checkout on a machine with CUDA devices:

    python3 example/image-classification-torch/profile_dp.py \
        [--model resnet50|lm] [--dp N] [--cards] [--zero1] [--seed N]
        [--steps N] [--out F]

``tools/profile_train_torch.py``'s profile (the step time untraced and
traced, the device time of every kernel summed by group, the ten kernels
with the most device time) of ``chip_smoke.py`` phase 15's
``ShardedTrainer`` runs in float32 (TF32 off): ResNet-50 at 224 x 224,
batch 64 over ``--dp`` replicas, or the transformer LM at 4 a replica;
all replicas on the first card, or with ``--cards`` each on its own
card (NCCL between them); ``--zero1`` splits the optimizer state.  The
device busy share is given for each card (its kernel time over the
traced wall), and the NCCL kernels' time as the group "nccl" (replicas
on one card sum with plain adds, which fall in "other kernels").

The host's share is split too, over the untraced steps: the main
thread's time in the forward walk (``Program.trace_replicas``, its
collectives apart), in ``torch.autograd.backward`` (the device threads'
backward and the waits for them), and in the rest of the step (the
gradient buckets' last sums, the update); and every collective's host
time and calls, on the main thread or on the autograd engine's device
threads (the time includes waiting for the one NCCL call at a time).
Imports neither JAX nor ``mxnet_tpu``.
"""
import argparse
import functools
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build(torch, model, seed, dp, cards, zero1):
    """``model`` on a dp mesh of ``dp`` replicas, as phase 15 builds it:
    ``(trainer, params, states, aux, batch, mesh)``."""
    import numpy as np
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import params_from_numpy
    from mxnet_tpu_torch.parallel.sharding import place
    mesh = mx.parallel.make_mesh(
        [mx.gpu(i if cards else 0) for i in range(dp)], dp=dp)
    if model == "lm":
        from mxnet_tpu_torch.models import transformer as tf
        batch = cs.train_batch(seed, cs.DP_LM_BATCH * dp)
        opt = mx.optimizer.create(
            "sgd", rescale_grad=1.0 / (cs.DP_LM_BATCH * dp
                                       * cs.TRAIN["seq_len"]),
            **cs.TRAIN_SGD)
        sym, params, aux = tf.get_symbol(**cs.TRAIN), \
            cs.seeded_train_params(seed), {}
    else:
        params, aux, batch = cs.seeded_resnet(seed, cs.RESNET_BATCH)
        opt = mx.optimizer.create("sgd", rescale_grad=1.0 / cs.RESNET_BATCH,
                                  **cs.RESNET_SGD)
        sym = cs.resnet_symbol()
    tr = mx.parallel.ShardedTrainer(sym, opt, mesh, zero1=zero1)
    p, a = params_from_numpy(params, aux, mesh=mesh)
    st = {n: place(np.zeros(v.shape, np.float32), mesh,
                   tr.opt_state_sharding(n, v.shape).spec)
          for n, v in params.items()}
    return tr, p, st, a, batch, mesh


class HostSplit:
    """Host seconds by part of a step, from wrappers around the walk, the
    backward and the collectives: :meth:`install` puts them in,
    :meth:`remove` takes them out, :meth:`start` zeroes the sums."""

    COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather",
                   "broadcast")

    def __init__(self, torch, trainer):
        from mxnet_tpu_torch.parallel import collectives
        self.torch, self.trainer, self.coll = torch, trainer, collectives
        self.main = threading.get_ident()
        self.local = threading.local()
        self.lock = threading.Lock()
        self.saved = {}
        self.in_walk = False
        self.start()

    def start(self):
        self.parts = {"walk": 0.0, "backward": 0.0}
        self.calls = {}     # (name, "walk"|"main"|"device threads") -> [s, n]

    def _where(self):
        if threading.get_ident() != self.main:
            return "device threads"
        return "walk" if self.in_walk else "main"

    def _collective(self, name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            if getattr(self.local, "inside", False):
                return fn(*a, **k)      # reduce_scatter's own all_reduce
            self.local.inside = True
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                self.local.inside = False
                with self.lock:
                    c = self.calls.setdefault((name, self._where()),
                                              [0.0, 0])
                    c[0] += dt
                    c[1] += 1
        return wrapper

    def _part(self, name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            if threading.get_ident() != self.main:
                return fn(*a, **k)
            self.in_walk = name == "walk"
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.parts[name] += time.perf_counter() - t0
                self.in_walk = False
        return wrapper

    def install(self):
        for name in self.COLLECTIVES:
            fn = getattr(self.coll, name)
            self.saved[name] = fn
            setattr(self.coll, name, self._collective(name, fn))
        self.saved["backward"] = self.torch.autograd.backward
        self.torch.autograd.backward = self._part(
            "backward", self.torch.autograd.backward)
        self.trainer._trace_replicas = self._part(
            "walk", self.trainer._trace_replicas)

    def remove(self):
        for name in self.COLLECTIVES:
            setattr(self.coll, name, self.saved[name])
        self.torch.autograd.backward = self.saved["backward"]
        self.trainer._trace_replicas = self.trainer._trace_replicas.__wrapped__

    def report(self, steps, step_s):
        """Milliseconds a step: the walk less its collectives, those
        collectives, the backward, the rest of the step; and every
        collective's time and calls by thread."""
        def ms(seconds):
            return seconds / steps * 1e3
        in_walk = sum(v[0] for (_n, w), v in self.calls.items()
                      if w == "walk")
        return {
            "step_ms": step_s * 1e3,
            "walk_ms": ms(self.parts["walk"] - in_walk),
            "walk_collectives_ms": ms(in_walk),
            "backward_ms": ms(self.parts["backward"]),
            "rest_ms": step_s * 1e3 - ms(self.parts["walk"]
                                        + self.parts["backward"]),
            "collectives": {"%s (%s)" % k: {"ms": ms(v[0]),
                                            "calls": v[1] / steps}
                            for k, v in sorted(self.calls.items())}}


def profile(torch, model, seed, steps, dp, cards, zero1):
    import profile_train_torch as ptt
    from torch.profiler import ProfilerActivity, profile as trace
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    tr, p, st, aux, batch, mesh = build(torch, model, seed, dp, cards, zero1)
    devices = sorted(set(mesh.devices), key=str)

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)
    b = tr.shard_batch(batch)
    for _ in range(2):
        p, st, aux, _o = tr.step(p, st, aux, b)
    sync()
    untraced = []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, st, aux, _o = tr.step(p, st, aux, b)
        sync()
        untraced.append(time.perf_counter() - t0)
    split = HostSplit(torch, tr)
    split.install()
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            p, st, aux, _o = tr.step(p, st, aux, b)
        sync()
        host = split.report(steps, (time.perf_counter() - t0) / steps)
    finally:
        split.remove()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            p, st, aux, _o = tr.step(p, st, aux, b)
        sync()
        traced = (time.perf_counter() - t0) / steps
    groups, kernels = {}, []
    for evt in prof.key_averages():
        us = ptt._device_time_us(evt) / steps
        if us <= 0 or evt.device_type.name != "CUDA":
            continue
        g = "nccl" if "nccl" in evt.key.lower() else ptt._group(evt.key)
        groups[g] = groups.get(g, 0.0) + us
        kernels.append((us, evt.count / steps, evt.key))
    kernels.sort(reverse=True)
    busy = {}
    for evt in prof.events():
        if evt.device_type.name == "CUDA":
            key = "cuda:%d" % evt.device_index
            busy[key] = busy.get(key, 0.0) + float(
                getattr(evt, "device_time", 0.0)
                or getattr(evt, "cuda_time", 0.0))
    untraced.sort()
    return {"model": model, "dp": dp, "cards": len(devices),
            "zero1": zero1,
            "step_ms_untraced": untraced[len(untraced) // 2] * 1e3,
            "step_ms_traced": traced * 1e3,
            "busy_by_card": {k: {"busy_ms": v / 1e3 / steps,
                                 "busy_share": v / 1e6 / steps / traced}
                             for k, v in sorted(busy.items())},
            "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
            "host_split": host,
            "top_kernels": [{"device_ms": us / 1e3, "per_step": n,
                             "name": k} for us, n, k in kernels[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("resnet50", "lm"),
                    default="resnet50")
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--cards", action="store_true",
                    help="each replica on its own card")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_dp: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = profile(torch, args.model, args.seed, args.steps, args.dp,
                args.cards, args.zero1)
    r["nvidia_smi"] = cs.nvidia_smi_line()
    print("%s dp=%d on %d card(s)%s: step %.2f ms untraced, %.2f ms "
          "traced; busy by card %s; device ms a step by group %s"
          % (r["model"], r["dp"], r["cards"], " zero1" if r["zero1"]
             else "", r["step_ms_untraced"], r["step_ms_traced"],
             {k: "%.2f ms, %.1f%%" % (v["busy_ms"], 100 * v["busy_share"])
              for k, v in r["busy_by_card"].items()},
             {k: round(v, 3) for k, v in
              sorted(r["device_ms_by_group"].items())}))
    h = r["host_split"]
    print("host ms a step (%.2f in all): walk %.2f, its collectives %.2f, "
          "backward %.2f, rest %.2f; collectives %s"
          % (h["step_ms"], h["walk_ms"], h["walk_collectives_ms"],
             h["backward_ms"], h["rest_ms"],
             {k: "%.2f ms, %g calls" % (v["ms"], v["calls"])
              for k, v in h["collectives"].items()}))
    for k in r["top_kernels"]:
        print("   %9.3f ms %6.1f x  %s" % (k["device_ms"], k["per_step"],
                                          k["name"][:90]))
    print(r["nvidia_smi"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
