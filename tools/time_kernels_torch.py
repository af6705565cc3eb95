#!/usr/bin/env python3
"""Time the port's redesigned kernels and training step of one checkout,
to compare two.

Run on a machine with an NVIDIA H100, once for each checkout to compare
(for example this one and an older commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists), alternating them in one
session so both land on the same card:

    python3 tools/time_kernels_torch.py --tree build/parent   # old
    python3 tools/time_kernels_torch.py --tree .              # new

It imports ``mxnet_tpu_torch`` from ``--tree`` (its kernels build into
that tree's ``build/``) and times, with ``chip_smoke.py``'s timer of this
checkout (CUDA events, the L2 flushed and a spin before every launch),
the int8 weight-only matmul at the decode ``lm_head`` (M=8) and the
largest prompt bucket (M=960), K=512, N=8192, float32 x, the
flash-attention forward at the training shape (B=8, H=8, S=1024, D=64,
causal) in bfloat16 and float32 (float32 also at phase 5's other shapes:
non-causal, S=1000, D=32, D=128, S=77), flash-decode at ``chip_smoke.py``
phase 2's shapes and positions (B=8 float32 and bfloat16, B=1 float32)
and the Rtc saxpy body (``2.5 x + y``) at 2^24 float32 elements.  Each
result is checked against the plain version of the same tree first.  Then it times ``--train-steps``
steps (after two warm-up steps, each ended by a synchronize, on the host
clock) of ``chip_smoke.py``'s full-width training run through the
tree's ``ShardedTrainer``, in float32 (TF32 off; the control: its kernels
are the same in both trees) and with ``compute_dtype="bfloat16"``, and
gives each dtype's median, fastest and slowest step.  Prints one JSON
line.  Imports neither JAX nor ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, HERE)
    import chip_smoke
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    for mod in [m for m in sys.modules if m.startswith("mxnet_tpu_torch")]:
        del sys.modules[mod]
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    if not fa.__file__.startswith(tree):
        raise RuntimeError("imported %s, not from %s" % (fa.__file__, tree))
    timer = chip_smoke.Timer(torch, args.iters, chip_smoke.LEAD_CYCLES)
    rng = np.random.RandomState(args.seed)
    out = {"tree": tree, "nvidia_smi": chip_smoke.nvidia_smi_line()}
    q8, scale = qz.quantize_array((rng.randn(8192, 512) * 0.02)
                                  .astype(np.float32))
    wq = torch.from_numpy(q8).cuda()
    sc = torch.from_numpy(scale).cuda()
    for m in (8, 960):
        x = torch.from_numpy(rng.randn(m, 512).astype(np.float32)).cuda()
        err = float((qz.quantized_matmul(x, wq, sc)
                     - qz.quantized_matmul_reference(x, wq, sc)).abs().max())
        if not err <= 1e-4:
            raise AssertionError("int8 matmul M=%d: %g from plain" % (m, err))
        out["qmm_M%d_ms" % m] = timer(lambda: qz.quantized_matmul(x, wq, sc))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = [torch.from_numpy(rng.randn(8, 8, 1024, 64).astype(
            np.float32)).to("cuda", dtype) for _ in range(3)]
        o, _l = fa.flash_attention_forward(q, k, v, causal=True)
        ro, _l = fa.flash_attention_forward_reference(q, k, v, causal=True)
        d = (o.float() - ro.float()).abs()
        if not bool((d <= ro.float().abs() * 2.0 ** -7 + 2e-5).all()):
            raise AssertionError("flash %s: %g from plain" % (dtype, d.max()))
        name = "flash_%s_ms" % str(dtype).replace("torch.", "")
        out[name] = timer(lambda: fa.flash_attention_forward(q, k, v,
                                                             causal=True))
    # the float32 body at chip_smoke.py phase 5's other shapes
    for S, D, causal in ((1024, 64, False), (1000, 64, True),
                         (1024, 32, True), (1024, 128, True), (77, 64, False)):
        q, k, v = [torch.from_numpy(rng.randn(8, 8, S, D).astype(
            np.float32)).cuda() for _ in range(3)]
        o, _l = fa.flash_attention_forward(q, k, v, causal=causal)
        ro, _l = fa.flash_attention_forward_reference(q, k, v, causal=causal)
        err = float((o - ro).abs().max())
        if not err <= 2e-5:
            raise AssertionError("flash float32 S=%d D=%d: %g from plain"
                                 % (S, D, err))
        name = "flash_float32_S%d_D%d_%s_ms" % (
            S, D, "causal" if causal else "full")
        out[name] = timer(lambda: fa.flash_attention_forward(
            q, k, v, causal=causal))
    del q, k, v
    for B, dtype in ((8, torch.float32), (8, torch.bfloat16),
                     (1, torch.float32)):
        pos = chip_smoke.FD_POSITIONS if B == 8 else chip_smoke.FD_POS_B1
        q, k, v, table, p = chip_smoke.flash_decode_case(torch, rng, pos,
                                                         dtype)
        err = float((fd.flash_decode_attention(q, k, v, table, p).float()
                     - fd.decode_attention_reference(q, k, v, table, p)
                     .float()).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        if not err <= tol:
            raise AssertionError("flash_decode B=%d %s: %g from plain"
                                 % (B, dtype, err))
        name = "flash_decode_B%d_%s_ms" % (B, str(dtype).replace("torch.",
                                                                 ""))
        out[name] = timer(lambda: fd.flash_decode_attention(q, k, v, table,
                                                            p))
    import mxnet_tpu_torch as mx
    x, y = (mx.nd.array(torch.rand(1 << 24, device="cuda"), ctx=mx.gpu(0))
            for _ in range(2))
    (got,) = rk.saxpy(x, y)
    if not torch.allclose(got.data, rk.saxpy_reference(x.data, y.data),
                          rtol=2.0 ** -23, atol=0):
        raise AssertionError("saxpy: more than 1 ulp from plain")
    out["saxpy_2e24_ms"] = timer(lambda: rk.saxpy(x, y))
    if args.train_steps > 0:
        params = chip_smoke.seeded_train_params(args.seed)
        batch = chip_smoke.train_batch(args.seed)
        for dtype in (None, "bfloat16"):
            steps = time_train_steps(torch, chip_smoke, params, batch, dtype,
                                     args.train_steps)
            steps.sort()
            out["train_%s_step_ms" % (dtype or "float32")] = {
                "median": steps[len(steps) // 2], "min": steps[0],
                "max": steps[-1], "steps": len(steps)}
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def time_train_steps(torch, cs, params, batch, compute_dtype, n):
    """Host ms of each of ``n`` training steps after two warm-up steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tf
    os.environ["MXTPU_FUSED_OPT"] = "kernel"
    dev = torch.device("cuda")
    opt = mx.optimizer.create(
        "sgd", rescale_grad=1.0 / (cs.TRAIN_BATCH * cs.TRAIN["seq_len"]),
        **cs.TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**cs.TRAIN), opt, ctx=dev,
                                    compute_dtype=compute_dtype)
    p = tf.params_from_numpy(params, ctx=dev)
    st = {name: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for name, w in p.items()}
    aux = {}
    b = tr.shard_batch(batch)
    for _ in range(2):
        p, st, aux, _o = tr.step(p, st, aux, b)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        p, st, aux, _o = tr.step(p, st, aux, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


if __name__ == "__main__":
    sys.exit(main())
