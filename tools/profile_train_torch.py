#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/profile_train_torch.py [--model lm|resnet50] [--seed N]
                                         [--steps N]
                                         [--dtype both|float32|bfloat16]
                                         [--tree DIR] [--out profile.json]

It builds one of ``chip_smoke.py``'s full-width training runs (``lm``:
the transformer LM of ``bench.py``'s chip configuration, batch 8 of 1024
tokens, phase 7; ``resnet50``: ``bench.py``'s ResNet-50 at 224 x 224,
batch 64, phase 9; SGD with momentum, seeded numpy weights,
``MXTPU_FUSED_OPT=kernel``), in float32 (TF32 off) and then with
``compute_dtype="bfloat16"``, takes two
warm-up steps, times ``--steps`` steps untraced (each ended by a
synchronize), then traces ``--steps`` more under ``torch.profiler`` (CPU
and CUDA activities), and prints for each:

- the step time untraced and traced;
- the device time of every kernel, summed by group (the port's
  flash-attention forward and fused-sweep kernels, cuDNN convolutions,
  matrix products, batch norm, copies, everything else) and the device
  busy share (kernel time over
  traced wall time: the rest is the device waiting for the host);
- the ten kernels with the most device time.

``--dtype`` profiles one of the two only; ``--tree`` profiles the
``mxnet_tpu_torch`` of another checkout (an older commit unpacked with
``git archive`` into a directory ``.gitignore`` lists), so two trees can
be compared in one run on one card.

The profiler adds host time, so the busy share it reports is a lower
bound of the untraced one.  Imports neither JAX nor ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _group(name):
    low = name.lower()
    if "flash_forward" in low:
        return "flash_attention"
    if "sweep_" in low:
        return "fused_opt"
    if any(k in low for k in ("batch_norm", "batchnorm", "bn_fw", "bn_bw")):
        return "batch_norm"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "convolution"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other kernels"


def _device_time_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _build_lm(torch, seed, compute_dtype):
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tf
    S = cs.TRAIN["seq_len"]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (cs.TRAIN_BATCH * S),
                              **cs.TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**cs.TRAIN), opt,
                                    ctx=torch.device("cuda"),
                                    compute_dtype=compute_dtype)
    p = tf.params_from_numpy(cs.seeded_train_params(seed),
                             ctx=torch.device("cuda"))
    return tr, opt, p, {}, cs.train_batch(seed)


def _build_resnet50(torch, seed, compute_dtype):
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import params_from_numpy
    params, aux, batch = cs.seeded_resnet(seed, cs.RESNET_BATCH)
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / cs.RESNET_BATCH,
                              **cs.RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(cs.resnet_symbol(), opt,
                                    ctx=torch.device("cuda"),
                                    compute_dtype=compute_dtype)
    p, a = params_from_numpy(params, aux, ctx=torch.device("cuda"))
    return tr, opt, p, a, batch


MODELS = {"lm": _build_lm, "resnet50": _build_resnet50}


def profile_one(torch, model, seed, compute_dtype, steps):
    from torch.profiler import ProfilerActivity, profile
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    tr, opt, p, aux, batch = MODELS[model](torch, seed, compute_dtype)
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    b = tr.shard_batch(batch)
    for _ in range(2):
        p, st, aux, _o = tr.step(p, st, aux, b)
    torch.cuda.synchronize()
    untraced = []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, st, aux, _o = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            p, st, aux, _o = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / steps
    groups, kernels = {}, []
    for evt in prof.key_averages():
        us = _device_time_us(evt) / steps
        if us <= 0 or evt.device_type.name != "CUDA":
            continue
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + us
        kernels.append((us, evt.count / steps, evt.key))
    kernels.sort(reverse=True)
    busy_us = sum(groups.values())
    untraced.sort()
    return {"model": model, "compute_dtype": str(compute_dtype or "float32"),
            "step_ms_untraced": untraced[len(untraced) // 2] * 1e3,
            "step_ms_traced": traced * 1e3,
            "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / traced,
            "top_kernels": [{"device_ms": us / 1e3, "per_step": n, "name": k}
                            for us, n, k in kernels[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="lm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", choices=("both", "float32", "bfloat16"),
                    default="both")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import mxnet_tpu_torch
    if not mxnet_tpu_torch.__file__.startswith(tree):
        raise RuntimeError("imported %s, not from %s"
                           % (mxnet_tpu_torch.__file__, tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"device": torch.cuda.get_device_name(0), "tree": tree,
               "nvidia_smi": cs.nvidia_smi_line(), "runs": []}
    for dtype in {"both": (None, "bfloat16"), "float32": (None,),
                  "bfloat16": ("bfloat16",)}[args.dtype]:
        r = profile_one(torch, args.model, args.seed, dtype, args.steps)
        results["runs"].append(r)
        print("%s %s: step %.2f ms untraced, %.2f ms traced; device busy "
              "%.2f ms a step (%.1f%% of traced wall), by group %s"
              % (args.model, r["compute_dtype"], r["step_ms_untraced"],
                 r["step_ms_traced"], r["device_busy_ms"],
                 100 * r["device_busy_share"],
                 {k: round(v, 3) for k, v in
                  sorted(r["device_ms_by_group"].items())}))
        for k in r["top_kernels"]:
            print("   %9.3f ms %6.1f x  %s" % (k["device_ms"], k["per_step"],
                                              k["name"][:90]))
        torch.cuda.empty_cache()
    print(results["nvidia_smi"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
