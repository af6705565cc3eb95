#!/usr/bin/env python3
"""Where the time of the PyTorch port's generation goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 tools/profile_generate_torch.py [--seed N] [--new-tokens N]
                                            [--out profile.json]

It builds ``chip_smoke.py``'s full-width engine (the transformer LM of
``bench.py``, seeded random weights, the engine's default buckets), in
float32 and then int8, generates once untraced, then once more under
``torch.profiler`` (CPU and CUDA activities), and prints for each:

- the wall time of ``generate()`` untraced and traced;
- the device time of every kernel, summed by group (the port's
  flash-decode and int8-matmul kernels, other matrix products, copies,
  everything else) and the device busy share (kernel time over traced
  wall time: the rest is the device waiting for the host);
- the ten kernels with the most device time.

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


def profile_one(torch, params, prompts, quantize, new_tokens):
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from mxnet_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(params, ctx=torch.device("cuda"),
                           quantize=quantize, max_new_tokens=new_tokens,
                           **cs.MODEL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    groups, kernels = {}, []
    for evt in prof.key_averages():
        us = _device_time_us(evt)
        if us <= 0 or evt.device_type.name != "CUDA":
            continue
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + us
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_us = sum(groups.values())
    st = eng.stats()
    return {"quantize": quantize or "float32",
            "generate_s_untraced": untraced, "generate_s_traced": traced,
            "decode_steps": st["decode_steps"] // 2,
            "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / traced,
            "top_kernels": [{"device_ms": us / 1e3, "count": n, "name": k}
                            for us, n, k in kernels[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_generate_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = cs.seeded_params(args.seed)
    rng = np.random.RandomState(args.seed + 2)
    lengths = [17, 900] + sorted(int(n) for n in
                                 rng.randint(18, 900, size=cs.N_PROMPTS - 2))
    prompts = [rng.randint(0, cs.MODEL["vocab_size"], size=n).tolist()
               for n in lengths]
    results = {"device": torch.cuda.get_device_name(0),
               "nvidia_smi": cs.nvidia_smi_line(), "runs": []}
    for quantize in (None, "int8"):
        r = profile_one(torch, params, prompts, quantize, args.new_tokens)
        results["runs"].append(r)
        print("%s: generate %.1f ms untraced, %.1f ms traced; device busy "
              "%.1f ms (%.1f%% of traced wall), by group %s"
              % (r["quantize"], r["generate_s_untraced"] * 1e3,
                 r["generate_s_traced"] * 1e3, r["device_busy_ms"],
                 100 * r["device_busy_share"],
                 {k: round(v, 3) for k, v in
                  sorted(r["device_ms_by_group"].items())}))
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
