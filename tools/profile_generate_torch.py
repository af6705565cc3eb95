#!/usr/bin/env python3
"""Where the time of the PyTorch port's generation goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/profile_generate_torch.py [--seed N] [--new-tokens N]
                                            [--repeats N] [--tree DIR]
                                            [--out profile.json]

``--tree`` profiles the ``mxnet_tpu_torch`` of another checkout (an
older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) with this checkout's model, weights and prompts,
so two trees can be compared in one run on one card.

It builds ``chip_smoke.py``'s full-width engine (the transformer LM of
``bench.py``, seeded random weights, the engine's default buckets), in
float32 and then int8, generates once untraced (the first call), then
``--repeats`` more times untraced, then once more under
``torch.profiler`` (CPU and CUDA activities), and prints for each:

- the wall time of ``generate()`` untraced (the first call, and the
  median, fastest and slowest of the repeats) and traced;
- the device time of every kernel, summed by group (the port's
  flash-decode and int8-matmul kernels, other matrix products, copies,
  everything else) and the device busy share (kernel time over traced
  wall time: the rest is the device waiting for the host);
- the ten kernels with the most device time;
- kernel launches (and copies) a decode step: the traced run's counts
  less those of a second traced run of the same prompts with half the
  new tokens (the prefills are the same), over the decode steps between
  the two.

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
    if "flash_decode" in low:
        return "flash_decode"
    if "quantized_matmul" in low or "qmm_" in low:
        # csrc/quantized_matmul.cu: qmm_gemv, qmm_wgmma, qmm_split and
        # qmm_reduce (this test comes before the "gemv" of cuBLAS below)
        return "quantized_matmul"
    if "gemm" in low or "gemv" in low or "sgemm" in low or "cutlass" in low:
        return "other matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other kernels"


def _device_time_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _traced(torch, eng, prompts, new_tokens):
    """generate() under torch.profiler: (wall s, decode steps, device
    events as (key, count, device us))."""
    from torch.profiler import ProfilerActivity, profile
    steps0 = eng.stats()["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = [(e.key, e.count, _device_time_us(e))
              for e in prof.key_averages()
              if e.device_type.name == "CUDA" and _device_time_us(e) > 0]
    return traced, eng.stats()["decode_steps"] - steps0, events


def _launches(events):
    """(kernel launches, copies and sets) among device events."""
    copies = sum(n for k, n, _ in events if _group(k) == "copies")
    return sum(n for _, n, _ in events) - copies, copies


def profile_one(torch, params, prompts, quantize, new_tokens, repeats):
    import chip_smoke as cs
    from mxnet_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(params, ctx=torch.device("cuda"),
                           quantize=quantize, max_new_tokens=new_tokens,
                           **cs.MODEL)
    untraced = []
    for _ in range(1 + repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts)
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)
    again = sorted(untraced[1:])
    traced, steps, events = _traced(torch, eng, prompts, new_tokens)
    _t, half_steps, half = _traced(torch, eng, prompts, new_tokens // 2)
    groups, kernels = {}, []
    for key, count, us in events:
        g = _group(key)
        groups[g] = groups.get(g, 0.0) + us
        kernels.append((us, count, key))
    kernels.sort(reverse=True)
    busy_us = sum(groups.values())
    (k_all, c_all), (k_half, c_half) = _launches(events), _launches(half)
    return {"quantize": quantize or "float32",
            "generate_s_untraced": untraced[0],
            "generate_s_untraced_repeats": untraced[1:],
            "generate_s_untraced_median": (again[len(again) // 2]
                                           if again else None),
            "generate_s_traced": traced,
            "decode_steps": steps,
            "kernel_launches": k_all, "copies": c_all,
            "kernel_launches_per_decode_step":
                (k_all - k_half) / (steps - half_steps),
            "copies_per_decode_step": (c_all - c_half) / (steps - half_steps),
            "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / traced,
            "top_kernels": [{"device_ms": us / 1e3, "count": n, "name": k}
                            for us, n, k in kernels[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=0,
                    help="untraced generate() calls after the first")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_generate_torch: no CUDA device", file=sys.stderr)
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
    params = cs.seeded_params(args.seed)
    rng = np.random.RandomState(args.seed + 2)
    lengths = [17, 900] + sorted(int(n) for n in
                                 rng.randint(18, 900, size=cs.N_PROMPTS - 2))
    prompts = [rng.randint(0, cs.MODEL["vocab_size"], size=n).tolist()
               for n in lengths]
    results = {"device": torch.cuda.get_device_name(0), "tree": tree,
               "nvidia_smi": cs.nvidia_smi_line(), "runs": []}
    for quantize in (None, "int8"):
        r = profile_one(torch, params, prompts, quantize, args.new_tokens,
                        args.repeats)
        results["runs"].append(r)
        print("%s: generate %.1f ms untraced, %.1f ms traced; device busy "
              "%.1f ms (%.1f%% of traced wall), by group %s; %d decode "
              "steps, %.2f kernel launches and %.2f copies a decode step"
              % (r["quantize"], r["generate_s_untraced"] * 1e3,
                 r["generate_s_traced"] * 1e3, r["device_busy_ms"],
                 100 * r["device_busy_share"],
                 {k: round(v, 3) for k, v in
                  sorted(r["device_ms_by_group"].items())},
                 r["decode_steps"], r["kernel_launches_per_decode_step"],
                 r["copies_per_decode_step"]))
        if r["generate_s_untraced_repeats"]:
            rep = r["generate_s_untraced_repeats"]
            print("   untraced repeats: median %.1f ms, %.1f-%.1f ms over %d"
                  % (r["generate_s_untraced_median"] * 1e3, min(rep) * 1e3,
                     max(rep) * 1e3, len(rep)))
        for k in r["top_kernels"]:
            print("   %9.3f ms %6d x  %s" % (k["device_ms"], k["count"],
                                             k["name"][:90]))
    print(results["nvidia_smi"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
