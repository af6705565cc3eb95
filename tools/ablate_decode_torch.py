#!/usr/bin/env python3
"""Ablations of the port's flash-decode plan and of the Rtc saxpy body's
memory layout, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/ablate_decode_torch.py [--iters N] [--rounds N]

With ``chip_smoke.py``'s timer (CUDA events, the L2 flushed and a spin
before every launch) it times, ``--rounds`` times in turn:

- ``csrc/flash_decode.cu`` at ``chip_smoke.py`` phase 2's shapes and
  positions (B=8 float32 and bfloat16, B=1 float32) under the default
  plan and under the plans of ``blocks_per_split`` 1, 2, 4 and 8 (each
  the plan ``plan_flash_decode`` makes for some other SM count), each
  checked against the plain version first;
- ``2.5 x + y`` over 2^24 float32 elements pushed through ``Rtc`` with
  three bodies: the repo's (a grid-stride loop over contiguous tiles of
  8 x 256 vectors), a grid-stride loop whose four vectors a thread lie a
  whole grid apart, and one element a thread (the body before the 16-byte
  vectors), at 4, 8, 16 and 32 blocks an SM, beside ``torch.add``.

Prints one JSON line.  Imports neither JAX nor ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: four vectors a thread, a whole grid apart
STRIDED = r"""
    const long long n = out0_size, n4 = n / 4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (((unsigned long long)in0 | (unsigned long long)in1
         | (unsigned long long)out0) % 16 == 0) {
        const float4* x4 = reinterpret_cast<const float4*>(in0);
        const float4* y4 = reinterpret_cast<const float4*>(in1);
        float4* o4 = reinterpret_cast<float4*>(out0);
        for (; i + 3 * stride < n4; i += 4 * stride) {
            float4 x[4], y[4];
            #pragma unroll
            for (int u = 0; u < 4; ++u) {
                x[u] = x4[i + u * stride];
                y[u] = y4[i + u * stride];
            }
            #pragma unroll
            for (int u = 0; u < 4; ++u)
                o4[i + u * stride] = make_float4(
                    2.5f * x[u].x + y[u].x, 2.5f * x[u].y + y[u].y,
                    2.5f * x[u].z + y[u].z, 2.5f * x[u].w + y[u].w);
        }
        for (; i < n4; i += stride) {
            const float4 x = x4[i], y = y4[i];
            o4[i] = make_float4(2.5f * x.x + y.x, 2.5f * x.y + y.y,
                                2.5f * x.z + y.z, 2.5f * x.w + y.w);
        }
        i = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
    }
    for (; i < n; i += stride) out0[i] = 2.5f * in0[i] + in1[i];
"""

#: one element a thread
SCALAR = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < out0_size) out0[i] = 2.5f * in0[i] + in1[i];
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ablate_decode_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    timer = cs.Timer(torch, args.iters, cs.LEAD_CYCLES)
    rng = np.random.RandomState(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line(), "sms": sms,
           "flash_decode": {}, "saxpy": {}}

    def sms_for(q, k, table, bps):
        """An SM count for which the planner splits at ``bps`` slots."""
        shape = (q.shape[0], q.shape[1], table.shape[1], k.shape[1],
                 q.shape[2])
        return next(n for n in range(1, 1 << 14) if plan_fn(
            *shape, n)["blocks_per_split"] == bps)

    cases = {}
    for B, dtype in ((8, torch.float32), (8, torch.bfloat16),
                     (1, torch.float32)):
        pos = cs.FD_POSITIONS if B == 8 else cs.FD_POS_B1
        cases["B%d_%s" % (B, str(dtype).replace("torch.", ""))] = (
            cs.flash_decode_case(torch, rng, pos, dtype))
    plan_fn = fd.plan_flash_decode
    try:
        for rnd in range(args.rounds):
            for name, (q, k, v, table, p) in cases.items():
                want = fd.decode_attention_reference(q, k, v, table, p)
                tol = 2e-5 if q.dtype == torch.float32 else 2e-2
                plans = {"default": sms}
                plans.update(("bps%d" % bps, sms_for(q, k, table, bps))
                             for bps in (1, 2, 4, 8))
                for pname, n_sms in plans.items():
                    fd.plan_flash_decode = (
                        lambda B, H, MB, BS, D, _sms, n_sms=n_sms:
                        plan_fn(B, H, MB, BS, D, n_sms))
                    fd._PLANS.clear()
                    got = fd.flash_decode_attention(q, k, v, table, p)
                    err = float((got.float() - want.float()).abs().max())
                    if not err <= tol:
                        raise AssertionError("flash_decode %s %s: %g"
                                             % (name, pname, err))
                    plan = fd.plan_flash_decode(
                        q.shape[0], q.shape[1], table.shape[1],
                        k.shape[1], q.shape[2], sms)
                    key = "%s/%s" % (name, pname)
                    row = out["flash_decode"].setdefault(key, {
                        "splits": plan["splits"],
                        "blocks_per_split": plan["blocks_per_split"],
                        "ms": []})
                    row["ms"].append(timer(
                        lambda: fd.flash_decode_attention(q, k, v, table,
                                                          p)))
    finally:
        fd.plan_flash_decode = plan_fn
        fd._PLANS.clear()

    n = 1 << 24
    x, y = (mx.nd.array(torch.rand(n, device="cuda"), ctx=mx.gpu(0))
            for _ in range(2))
    want = rk.saxpy_reference(x.data, y.data)
    bodies = {"tiled": rk.SAXPY, "strided": STRIDED, "scalar": SCALAR}
    for rnd in range(args.rounds):
        for name, body in bodies.items():
            r = mx.rtc.Rtc(body, pallas=True)
            for per_sm in (4, 8, 16, 32):
                grid = (sms * per_sm if name != "scalar"
                        else -(-n // 256), 1, 1)
                (got,) = r.push([x, y], grid, (256, 1, 1))
                if not torch.allclose(got.data, want, rtol=2.0 ** -23,
                                      atol=0):
                    raise AssertionError("saxpy %s: more than 1 ulp" % name)
                key = "%s/%d_per_sm" % (name, per_sm) if name != "scalar" \
                    else name
                out["saxpy"].setdefault(key, []).append(
                    timer(lambda: r.push([x, y], grid, (256, 1, 1))))
                if name == "scalar":
                    break
        out["saxpy"].setdefault("torch_add", []).append(
            timer(lambda: torch.add(y.data, x.data, alpha=2.5)))
    for key, row in sorted(out["flash_decode"].items()):
        print("flash_decode %-28s splits=%-2d ms %s" % (
            key, row["splits"], " ".join("%.4f" % t for t in row["ms"])))
    for key, ms in sorted(out["saxpy"].items()):
        print("saxpy %-20s ms %s" % (key, " ".join("%.4f" % t for t in ms)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
