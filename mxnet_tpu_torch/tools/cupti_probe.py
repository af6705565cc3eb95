#!/usr/bin/env python3
"""How often the profiler's CUPTI probe finds no device event, over fresh
processes on the card.

``mxnet_tpu_torch.profiler.profiler_set_state("run")`` first traces
``PROBE_KERNELS`` small kernels (``profiler.probe_session``, up to
``_PROBE_TRIES`` tries, each waiting ``FLUSH_S`` after a synchronize) and
raises when CUPTI recorded no device event in any of them.  This script starts
``--processes`` fresh Python processes a condition (``--parallel`` at a
time) and, in each, counts the device events of every try of the probe
(all of them, not stopping at the first that sees one) and then calls
``profiler_set_state("run")``/``("stop")`` itself, recording whether it
raised.  The conditions:

- ``default``: the probe as the profiler runs it (``FLUSH_S`` 0.1 s);
- ``flush``: ``FLUSH_S`` at 0.5 s;
- ``warm``: one CUDA profiler session of its own first, thrown away;
- ``after``: eight profiler sessions over a few hundred kernels first,
  as the earlier phases of ``chip_smoke.py`` run ``torch.profiler`` for
  their busy shares in the same process before phase 18 (b).

Run it from the root of a checkout on a machine with a CUDA card:

    python3 -m mxnet_tpu_torch.tools.cupti_probe --processes 50 \\
        --parallel 4 --out build/cupti_probe.json

It prints one line a condition and writes every process's record to
``--out``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

#: the checkout's root (the children import the package from it)
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONDITIONS = ("default", "flush", "warm", "after")


def _session(torch, acts, kernels):
    """One profiler session over ``kernels`` small kernels: the device
    events it recorded."""
    with torch.profiler.profile(activities=acts) as prof:
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(kernels):
            x = x * 2
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if str(getattr(ev, "device_type", "")).endswith("CUDA"))


def child(condition):
    """One fresh process: the probe's tries, then the profiler's own
    start and stop; prints one JSON record."""
    import torch
    t0 = time.perf_counter()
    from mxnet_tpu_torch import profiler
    if condition == "flush":
        profiler.FLUSH_S = 0.5
    torch.cuda.init()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = []
    if condition == "warm":
        before.append(_session(torch, acts, 4))
    elif condition == "after":
        before = [_session(torch, acts, 50) for _ in range(8)]
    tries = []
    for _ in range(profiler._PROBE_TRIES):
        tries.append(profiler.probe_session(torch, acts))
    error = None
    try:
        profiler.profiler_set_config(filename=os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "cupti_probe_%d" % os.getpid()))
        profiler.profiler_set_state("run")
        x = torch.ones(1 << 20, device="cuda") * 3
        torch.cuda.synchronize()
        path = profiler.profiler_set_state("stop")
        if path:
            os.remove(path)
    except Exception as exc:        # the failure this script counts
        error = "%s: %s" % (type(exc).__name__, exc)
    print(json.dumps({"condition": condition, "sessions_before": before,
                      "tries": tries, "probe_failed": not any(tries),
                      "profiler_error": error,
                      "seconds": time.perf_counter() - t0}))


def run_one(condition):
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m",
                          "mxnet_tpu_torch.tools.cupti_probe", "--child",
                          condition], capture_output=True, text=True,
                         timeout=300, cwd=HERE, env=env)
    line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    try:
        return json.loads(line)
    except ValueError:
        return {"condition": condition, "crashed": True,
                "returncode": out.returncode, "stderr": out.stderr[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=50)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--conditions", default=",".join(CONDITIONS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("cupti_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    results = {}
    for cond in args.conditions.split(","):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(args.parallel) as pool:
            recs = list(pool.map(run_one, [cond] * args.processes))
        crashed = sum(1 for r in recs if r.get("crashed"))
        ok = [r for r in recs if not r.get("crashed")]
        tries = [t for r in ok for t in r["tries"]]
        summary = {
            "processes": len(recs), "crashed": crashed,
            "probe_failed": sum(1 for r in ok if r["probe_failed"]),
            "profiler_raised": sum(1 for r in ok if r["profiler_error"]),
            "tries": len(tries),
            "tries_without_device_event": sum(1 for t in tries if t == 0),
            "first_try_without_device_event": sum(
                1 for r in ok if r["tries"] and r["tries"][0] == 0),
            "seconds": time.perf_counter() - t0}
        results[cond] = {"summary": summary, "records": recs}
        print("cupti_probe %-8s %s; on %s" % (cond, json.dumps(summary),
                                             smi[0] if smi else "?"),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
