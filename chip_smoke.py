#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--iters N] [--out results.json]

It imports nothing of JAX or of the JAX package ``mxnet_tpu``.  Phases,
in order; any failure ends the run with a non-zero exit and no result
line:

1. the device, ``nvidia-smi``'s name and power limit, and the build of
   every CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together), with each kernel's registers
   and spills from ``ptxas`` (the float32 flash forward at D=64 must not
   spill);
2. flash-decode, kernel vs its plain PyTorch version, on the card, at the
   slice's shapes (the decode buckets B in {1, 2, 4, 8} and a ragged B=3,
   H=8, D=64, 32-token blocks, a 256-block pool, 32 table slots), in
   float32, bfloat16 and float32 q over a bfloat16 pool, at mixed
   positions and at every edge of the kernel's split (each case run twice
   and required to repeat bit for bit), and with a row at pos < 0 (the
   mean of v over its table, as the plain version), with the plan
   (splits, thread blocks) and times of the kernel, the plain version,
   ``F.scaled_dot_product_attention`` on the gathered cache (a yardstick
   only) and the bandwidth bound;
3. the int8 weight-only matmul, kernel vs plain, at M in {1, 8, 16, 17,
   33, 240, 960} and the three (K, N) of the model: M <= 16 runs the
   split-K GEMV body, larger M the wgmma body (float32 x as three
   bfloat16 pieces), each within 1e-4; with the same four times
   (``torch.matmul`` against the dequantized float32 weight is the
   yardstick; the wgmma rows' bound counts their bfloat16 tensor work);
   then with fp8 e4m3 weights at K=512, N=8192 and M in {8, 17, 960}
   (the GEMV, then the wgmma body); every row the same bits on a second
   call;
4. the slice end to end at full width: ``GenerationEngine(ctx=gpu(0))``
   for the transformer LM the repo benchmarks (vocab 8192, 8 layers, 8
   heads, dim 512, max_seq_len 1024, seeded random weights) generates 64
   tokens for 8 prompts of 17 to 900 tokens, in float32 and then with
   ``quantize="int8"``.  It checks that both kernels ran on that path
   (launch counts reset just before each run), the int8 run through
   both int8 bodies (prefill: wgmma, decode: GEMV; counted by body),
   that the float32 logits agree with a plain full-sequence forward
   written here, and that the int8 logits keep a cosine >= 0.999 against
   float32 at every step.
4b. the in-process ``ModelServer`` at the same full width: one server
   holds ``lm-f32`` and ``lm-fp8`` (``quantize="fp8_e4m3"``), both at
   the engine's defaults, and ``mlp`` (``models.mlp``, 128 inputs,
   buckets 1, 2, 4, 8).  Four client threads send 16 prompts to each LM
   (phase 4's 8 and 8 more, 64 new tokens, two with an ``eos_id``,
   retrying after a 429) and 200 MLP requests of sizes 1:60, 2:25,
   4:10, 8:5.  Gates: every generated token's logit within 1e-3 of its
   row's maximum in a plain float32 forward over prompt and tokens
   (``lm-fp8``: over its dequantized weights); MLP results equal to a
   serial ``Predictor`` (rtol 1e-5, atol 1e-6); no lowering after
   warmup; flash-decode once a layer on every decode step; the fp8
   model through both fp8 bodies; a second server with a 40-block pool
   answers a second 900-token request with a 429 carrying
   ``blocks_free`` while the first finishes.  Printed: tokens/s, TTFT
   and ITL p50/p99, decode ms a step (``serve`` telemetry), the MLP's
   req/s and p50/p99 latency, ``engine.generate()`` of the same prompts,
   the fp8 logits' cosine against float32 (a report, not a gate).
4c. the serving fleet on the same card: ``launch_fleet`` spawns two
   ``python -m mxnet_tpu_torch.tools.mxfleet replica`` processes on
   free ports serving ``lm-fp8``, the LM through
   ``models.transformer.get_symbol(seq_len=512)`` (its softmax output
   reshaped to (batch, 512, 8192)) from a seeded 0x112 checkpoint with
   ``MXTPU_QUANTIZE=fp8_e4m3`` at buckets 1, 2, 4.  Four client threads
   send 48 requests of 1 or 2 sequences through a ``FleetClient`` and
   the ``mxfleet serve`` front door.  Gates: every response bit for bit
   an in-process ``Predictor``'s on the same checkpoint and quantization
   at a bucket the request fits (that Predictor and each replica must
   have run the fp8 ``wgmma`` body and the float32 flash forward, by
   their own launch counts); SIGKILL of replica 1 with requests in
   flight: each completes (bitwise) or fails with ``ReplicaDead``, none
   hangs, the ledger shows generation 1 with the death verdict, and the
   respawned replica is healthy within 60 s and answers bitwise; a
   rolling swap to a second checkpoint with zero lowerings a replica and
   the skew map at ``v2``, then bitwise outputs of the new weights; a
   1-replica fleet with a queue bound of 2 answers a burst of 8 with at
   least one 429 carrying ``Retry-After``; ``drain()`` turns the front
   door to 503; no replica process is left.  Printed: the router's
   req/s and p50/p99 latency against the same requests through one
   in-process ``ModelServer`` (a yardstick), failovers, respawn
   seconds, swap pause ms, GPU memory by process.
5. the flash-attention forward of training, kernel vs plain (``o`` and
   ``lse``), at B=8, H=8, S=1024, D=64, causal and not, float32 (the FMA
   body, also required to repeat bit for bit) and bfloat16 (the wgmma
   body), each also at a ragged S=1000, at D=32 and D=128 and at S=77,
   and (checked, not timed) at Sq != Sk (200 and 77 queries against 77
   and 200 keys), with times of the kernel, the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only) and the bound
   (operations at 67 TFLOP/s float32 or 989 TFLOP/s bfloat16, or bytes at
   3.35 TB/s, whichever is larger);
6. the fused optimizer sweep, kernel vs plain, for every body (SGD with
   and without momentum, NAG, Adam, AdamW, AdaGrad, RMSProp, AdaDelta,
   Test): bit for bit and bitwise on repeat at 16 M elements and at 4099
   elements one element into their arrays (the scalar path), with and
   without ``clip_gradient``, at t = 1 and t = 3; each body timed at 16 M
   elements, and SGD with momentum on each bucket of the full-width LM,
   with times of the kernel, the plain version, ``torch.optim``'s fused
   step where PyTorch has one (a yardstick only) and the bytes bound;
7. training at full width: ``ShardedTrainer(ctx=gpu(0))`` on the
   transformer LM (vocab 8192, 8 layers, 8 heads, dim 512, seq_len
   1024, batch 8, SGD lr 0.1 momentum 0.9, rescale_grad 1/8192, seeded
   numpy weights) with ``MXTPU_FUSED_OPT=kernel``: 3 float32 steps (TF32
   off), each step and the three together no further from a plain
   training step written here, run in float64, than twice as far as the
   same plain step in float32 is; bit for bit equal to the same steps
   with the leafwise update; then bfloat16 compute.  It checks the flash
   forward ran once a layer a step (the FMA body in float32, the wgmma
   body in bfloat16, counted by dtype) and the sweep once a bucket a
   step, and prints ms a step and tokens/s;
8. the imperative surface and runtime-compiled kernels: NDArrays made
   under ``with mx.gpu(0):`` with no ``ctx`` at (4096, 4096) float32,
   arithmetic, views that write through, in-place operators, registered
   functions, ``random.uniform(out=)``, and five CUDA C kernel bodies
   (``kernels/rtc_kernels.py``) pushed through ``mx.rtc.Rtc`` (NVRTC),
   each against numpy, with the Rtc launch count reset just before;
   then each kernel against its plain PyTorch version on the card (saxpy
   also at 2^24 + 3 elements and on views offset by one element), the
   error paths (an NVRTC compile error, a 2048-thread block, a CPU
   tensor), and times (kernel, plain, one-call library, the bytes
   bound, NVRTC's compile time per key, the host time of a cached push).
9. ResNet-50 through ``ShardedTrainer(ctx=gpu(0))`` at ``bench.py``'s
   configuration (224 x 224, 1000 classes, batch 64, SGD lr 0.1,
   momentum 0.9, wd 1e-4, rescale_grad 1/64, seeded numpy weights and
   images) with ``MXTPU_FUSED_OPT=kernel`` and cuDNN deterministic: the
   sweep once a bucket a step and no other hand kernel; 3 float32 steps
   bit for bit (parameters and aux) equal to the same steps leafwise;
   one float32 step at batch 8 no further from a plain step written here
   in float64 than twice the plain float32 step; bfloat16 compute
   (softmax outputs within 5e-2 of float32's, finite parameters after 3
   steps); one step each with NAG and RMSProp through their bodies; ms
   a step and images/s beside the float32 (bfloat16) operations bound;
10. ``Module.fit`` of ResNet-50 on the current context (``gpu(0)``) as
   ``example/image-classification/common.py`` drives it: Xavier (in,
   2.34), a ``KVStore("local")`` object (the update on the store), a
   Speedometer, ``eval_metric="acc"``, 8 training and 2 validation
   batches of 64 made by ``synthetic_iters``' formula a batch at a time:
   finite training accuracy, no hand kernel launched (neither update
   route runs the sweep, as in the JAX package), a checkpoint that
   round-trips bit for bit, and the fused step (``kvstore=None``) within
   1e-5 of the store's route after 2 steps; images/s.

It exits 2 when CUDA is unavailable or when the package is not beside
this script.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is ``nvidia-smi``'s
name and power limit, and the one before that the per-kernel JSON.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
#: float32 FMA-pipe operations/s (no tensor cores) and dense bfloat16
#: tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: where every tensor of the run lives (a CPU rehearsal of the control
#: flow may set "cpu"; the kernels then take their plain versions)
DEVICE = "cuda"

MODEL = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
             max_seq_len=1024, ffn_mult=4)
N_PROMPTS = 8
MAX_NEW = 64

#: the training slice's full width: bench.py's chip configuration
#: (bench.py:913-930) of the same LM, batch 8 of 1024 tokens
TRAIN = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
             seq_len=1024, ffn_mult=4)
TRAIN_BATCH = 8
TRAIN_SGD = dict(learning_rate=0.1, momentum=0.9)


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


class Timer(object):
    """Median of per-launch CUDA-event times, with the 50 MB L2 flushed
    (a 128 MB buffer overwritten) before every launch: the serving loop
    streams every layer's weights and cache between two calls of one
    kernel, so each call finds its inputs cold."""

    def __init__(self, torch, iters, lead_cycles=0):
        self.torch = torch
        self.iters = iters
        #: a spin of this many clock cycles after the flush keeps the
        #: card busy while the host enqueues a launch whose Python path
        #: is slower than the flush (a wrapper's checks, plan and
        #: allocations; phase 8's ``Rtc.push``), so the host's time stays
        #: out of the events' interval
        self.lead_cycles = lead_cycles
        self.flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                                 device=DEVICE)

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        starts = [torch.cuda.Event(enable_timing=True)
                  for _ in range(self.iters)]
        ends = [torch.cuda.Event(enable_timing=True)
                for _ in range(self.iters)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            if self.lead_cycles:
                torch.cuda._sleep(self.lead_cycles)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))


def ptxas_functions(text):
    """(entry function, registers, spill store bytes, spill load bytes)
    of each kernel in an ``nvcc -Xptxas -v`` log."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


#: kernels that must build without spills: the float32 flash forward at
#: the training head dim (``flash_forward_fma<64>``)
NO_SPILL = {"flash_attention": "flash_forward_fmaILi64E"}


def check_no_spills(info):
    """Fail when a kernel of NO_SPILL spills, or its build log (kept
    beside a cached library) does not say."""
    for lib, marker in NO_SPILL.items():
        found = [f for f in ptxas_functions(info[lib]["log"])
                 if marker in f[0]]
        if not found:
            raise AssertionError("ptxas log of %s has no %s" % (lib, marker))
        for fn, regs, st, ld in found:
            if st or ld:
                raise AssertionError("%s spills: %d bytes stored, %d loaded"
                                     % (fn, st, ld))
            log("  no spills: %s, %d registers" % (fn, regs))


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------------------
# phase 2: flash-decode
# ----------------------------------------------------------------------
def flash_decode_case(torch, rng, pos, dtype, kv_dtype=None, NB=256, BS=32,
                      H=8, D=64, MB=32):
    """One row a position of ``pos``, each row's live blocks distinct
    random pool blocks, trailing slots on trash block 0; the whole pool
    (block 0 included) holds random values.  ``kv_dtype``: the pools'
    type (q's by default)."""
    pos = np.asarray(pos, np.int32)
    B = len(pos)
    free = list(rng.permutation(np.arange(1, NB)))
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = int(pos[b]) // BS + 1
        table[b, :n] = [free.pop() for _ in range(n)]
    dev = DEVICE
    kv_dtype = kv_dtype or dtype
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, kv_dtype), v.to(dev, kv_dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


#: phase 2's positions: the decode batch of 8 (0, 31, 32 and 1023 among
#: them) and, at B=1, one deep row
FD_POSITIONS = [0, 31, 32, 1023, 17, 300, 640, 900]
FD_POS_B1 = [700]
#: a row with pos < 0, which the engine never passes: the kernel must give
#: the mean of v over the row's table, as the plain version does
FD_POS_NEGATIVE = [-1, 700, 0]


def _fd_check(torch, fd, case, scale, tol, what):
    """Kernel vs plain on one case, twice: the two kernel results must be
    equal bit for bit.  Returns max |kernel - plain|."""
    q, k, v, table, pos = case
    got = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
    again = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
    want = fd.decode_attention_reference(q, k, v, table, pos, scale=scale)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        raise AssertionError("flash_decode %s: max |kernel - plain| = %g > %g"
                             % (what, err, tol))
    if not torch.equal(got, again):
        raise AssertionError("flash_decode %s: two runs differ" % what)
    return err


def phase_flash_decode(torch, timer, seed):
    """The decode buckets B in {1, 2, 4, 8} and a ragged B=3, float32,
    bfloat16 and float32 q over a bfloat16 pool: kernel vs plain (and a
    bitwise repeat) at phase 2's positions, timed, and at every split edge
    of the B's plan (0, BS-1, BS, blocks_per_split*BS - 1,
    blocks_per_split*BS, MB*BS - 1), B rows at a time."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    rows = []
    rng = np.random.RandomState(seed)
    #: float32: same arithmetic, other summation order (a float32 q over
    #: a bfloat16 pool too: the plain version widens the pool); bfloat16:
    #: the plain version rounds scores and probabilities to bfloat16
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    BS, H, D, MB = 32, 8, 64, 32
    for B in (1, 2, 3, 4, 8):
        plan = fd.plan_flash_decode(B, H, MB, BS, D, sms)
        span = plan["blocks_per_split"] * BS
        edges = [0, BS - 1, BS, span - 1, span, MB * BS - 1]
        pos_main = FD_POSITIONS[:B] if B > 1 else FD_POS_B1
        for dtype, kv_dtype in ((torch.float32, torch.float32),
                                (torch.bfloat16, torch.bfloat16),
                                (torch.float32, torch.bfloat16)):
            tol = tols[dtype]
            what = "B=%d q %s pool %s" % (B, dtype, kv_dtype)
            scale = 1.0 / math.sqrt(D)
            edge_err = 0.0
            for i in range(0, len(edges), B):
                chunk = (edges[i:i + B] + pos_main)[:B]
                edge_err = max(edge_err, _fd_check(
                    torch, fd, flash_decode_case(torch, rng, chunk, dtype,
                                                 kv_dtype), scale, tol,
                    what + " at positions %s" % chunk))
            case = flash_decode_case(torch, rng, pos_main, dtype, kv_dtype)
            rows.append(_fd_timed_row(torch, fd, timer, plan, case, scale,
                                      tol, what, edge_err, edges))
    # a row with pos < 0 (outside the engine's use): every slot of its
    # table weighs alike, as in the plain version and the JAX package
    for dtype, kv_dtype in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16)):
        pos_neg = FD_POS_NEGATIVE
        plan = fd.plan_flash_decode(len(pos_neg), H, MB, BS, D, sms)
        case = flash_decode_case(torch, rng, pos_neg, dtype, kv_dtype)
        q, k, v, table, pos = case
        scale = 1.0 / math.sqrt(D)
        what = "B=%d q %s pool %s at positions %s" % (
            len(pos_neg), dtype, kv_dtype, pos_neg)
        got = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
        mean = v[table[0].long()].float().reshape(MB * BS, H, D).mean(0)
        mean_err = float((got[0].float() - mean).abs().max())
        if not mean_err <= tols[dtype]:
            raise AssertionError("flash_decode %s: row 0 is %g from the mean "
                                 "of v over its table" % (what, mean_err))
        row = _fd_timed_row(torch, fd, timer, plan, case, scale, tols[dtype],
                            what, 0.0, [])
        row["mean_max_abs_err"] = mean_err
        rows.append(row)
    return rows


def _fd_timed_row(torch, fd, timer, plan, case, scale, tol, what, edge_err,
                  edges):
    """Kernel vs plain on ``case`` (twice, bitwise), then the times of the
    kernel, the plain version, SDPA on the gathered cache and the bytes
    bound.  A row with pos < 0 reads its whole table; SDPA gets -1e30
    additive masks there so that it weighs every slot alike too."""
    import torch.nn.functional as F
    q, k, v, table, pos = case
    B, H, D = q.shape
    NB, BS = k.shape[:2]
    MB = table.shape[1]
    err = _fd_check(torch, fd, case, scale, tol, what)
    # yardstick: SDPA on the gathered cache (gather not timed)
    kk = k[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
    vv = v[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
    kk, vv = kk.to(q.dtype).contiguous(), vv.to(q.dtype).contiguous()
    mask = (torch.arange(MB * BS, device=DEVICE)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    if bool((pos < 0).any()):
        mask = torch.where(mask | (pos < 0)[:, None, None, None],
                           torch.zeros((), device=DEVICE),
                           torch.full((), -1e30, device=DEVICE)).to(q.dtype)
    q4 = q[:, :, None, :]
    want = fd.decode_attention_reference(q, k, v, table, pos, scale=scale)
    lib = F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask,
                                         scale=scale)[:, :, 0]
    lib_err = float((lib.float() - want.float()).abs().max())
    n_tok = int(torch.where(pos < 0, MB * BS, pos.long() + 1).sum())
    n_bytes = (2 * n_tok * H * D * k.element_size()
               + 2 * q.numel() * q.element_size()
               + table.numel() * 4 + pos.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * n_tok * H * D)
    row = {
        "B": B, "dtype": str(q.dtype).replace("torch.", ""),
        "kv_dtype": str(k.dtype).replace("torch.", ""),
        "pos": pos.tolist(), "edges": edges,
        "plan": {key: plan[key] for key in (
            "splits", "blocks_per_split", "ctas")},
        "max_abs_err": max(err, edge_err), "edge_max_abs_err": edge_err,
        "tol": tol, "repeat_bitwise": True,
        "library_max_abs_err": lib_err,
        "ms": timer(lambda: fd.flash_decode_attention(
            q, k, v, table, pos, scale=scale)),
        "plain_ms": timer(lambda: fd.decode_attention_reference(
            q, k, v, table, pos, scale=scale)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=mask, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
    log("flash_decode B=%d q %-8s pool %-8s pos %s splits=%d ctas=%d "
        "err=%.3g edges err=%.3g (tol %g) repeat bitwise "
        "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
        % (B, row["dtype"], row["kv_dtype"], row["pos"] if B <= 3 else "...",
           plan["splits"], plan["ctas"], err, edge_err, tol, row["ms"],
           row["plain_ms"], row["library_ms"], b_ms, b_by))
    return row


# ----------------------------------------------------------------------
# phase 3: int8 weight-only matmul
# ----------------------------------------------------------------------
def phase_quantized_matmul(torch, timer, seed):
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(seed + 1)
    rows = []
    #: float32 sums over K <= 16384 in another order (the wgmma body: x as
    #: three bfloat16 pieces holding all 24 bits, exact products summed
    #: in float32); bfloat16 output rounding (8 mantissa bits) of values
    #: of order 1
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    #: M <= 16 takes the GEMV body (one instance per M rounded up to a
    #: power of two: 1, 2, 4 and 8 are the decode buckets, 3 is ragged),
    #: larger M the wgmma body: 16 and 17 straddle the threshold, 33 is
    #: ragged, 240 and 960 are prompt buckets
    cases = [(m, k, n, torch.float32, "int8")
             for m in (1, 2, 3, 4, 8, 16, 17, 33, 240, 960)
             for k, n in ((512, 2048), (2048, 512), (512, 8192))]
    # a wider model's ffn2 and lm_head at decode: K that the GEMV splits
    # so x fits its shared memory
    cases += [(8, 16384, 4096, torch.float32, "int8"),
              (16, 4096, 8192, torch.float32, "int8")]
    cases += [(8, 512, 8192, torch.bfloat16, "int8"),
              (240, 512, 2048, torch.bfloat16, "int8")]
    # fp8 e4m3 weights at the lm_head shape: decode (the GEMV), just past
    # the GEMV's 16 rows and the largest prompt bucket (wgmma)
    cases += [(m, 512, 8192, torch.float32, "fp8_e4m3") for m in (8, 17, 960)]
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    for m, k, n, dtype, qdtype in cases:
        q, scale = qz.quantize_array(
            (rng.randn(n, k) * 0.02).astype(np.float32), qdtype=qdtype)
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
            DEVICE, dtype)
        wq = torch.as_tensor(q).to(DEVICE)
        sc = torch.from_numpy(scale).to(DEVICE)
        plan = qz.plan_quantized_matmul(m, n, k, sms)
        got = qz.quantized_matmul(x, wq, sc)
        again = qz.quantized_matmul(x, wq, sc)
        want = qz.quantized_matmul_reference(x, wq, sc)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tols[dtype]:
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s %s (%s): max |kernel - "
                "plain| = %g > %g" % (m, k, n, dtype, qdtype, plan["route"],
                                      err, tols[dtype]))
        if not torch.equal(got, again):
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s %s (%s): a second call "
                "gave other bits" % (m, k, n, dtype, qdtype, plan["route"]))
        w_deq = (wq.float() * sc[:, None]).to(dtype)
        n_bytes = (m * k * x.element_size() + n * k + n * 4
                   + m * n * x.element_size())
        if plan["route"] == "gemv":
            # float32 FMAs on the CUDA cores
            pieces = 0
            b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k)
        else:
            # the function's 2 M N K operations at the bfloat16 tensor
            # rate; the three products a float32 x takes are the kernel's
            # design, not work the function needs (row's "tensor_ops")
            pieces = 3 if dtype == torch.float32 else 1
            b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, BF16_OPS_PER_S)
        row = {"M": m, "K": k, "N": n,
               "dtype": str(dtype).replace("torch.", ""), "qdtype": qdtype,
               "route": plan["route"], "splits": plan["splits"],
               "bf16_pieces": pieces,
               "max_abs_err": err, "tol": tols[dtype],
               "ms": timer(lambda: qz.quantized_matmul(x, wq, sc)),
               "plain_ms": timer(lambda: qz.quantized_matmul_reference(
                   x, wq, sc)),
               "library_ms": timer(lambda: torch.matmul(x, w_deq.t())),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": 2 * m * n * k,
               "tensor_ops": pieces * 2 * m * n * k}
        rows.append(row)
        log("quantized_matmul M=%-4d K=%-4d N=%-4d %-8s %-8s %-5s "
            "splits=%-2d err=%.3g (tol %g, bitwise on repeat) kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
            % (m, k, n, row["dtype"], qdtype, plan["route"], plan["splits"],
               err, tols[dtype], row["ms"], row["plain_ms"],
               row["library_ms"], b_ms, b_by))
    return rows


# ----------------------------------------------------------------------
# phase 4: the slice at full width
# ----------------------------------------------------------------------
def seeded_params(seed):
    """Random weights of the decode graph, from ``seed`` with numpy:
    N(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm."""
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_decode_symbol(**MODEL)
    E, H = MODEL["dim"], MODEL["num_heads"]
    caches = {"layer%d_att_%s_cache" % (i, c): (2, 32, H, E // H)
              for i in range(MODEL["num_layers"]) for c in "kv"}
    shapes, _, _ = sym.infer_shape(data=(1, 1), pos_ids=(1, 1), seq_pos=(1,),
                                   block_table=(1, 1), **caches)
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "pos_ids", "seq_pos", "block_table") \
                or name in caches:
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def plain_lm_logits(torch, params, tokens):
    """Logits of every position of ``tokens`` from a plain full-sequence
    float32 forward of the same LM: no cache, no kernels, causal softmax
    attention over the whole sequence."""
    F = torch.nn.functional
    p = {k: torch.from_numpy(v).to(DEVICE) for k, v in params.items()}
    E, H = MODEL["dim"], MODEL["num_heads"]
    D = E // H
    S = len(tokens)
    ids = torch.tensor(tokens, device=DEVICE)
    x = p["tok_embed_weight"][ids] + p["pos_embed_weight"][:S]
    causal = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    for i in range(MODEL["num_layers"]):
        n = "layer%d_" % i
        h = F.layer_norm(x, (E,), p[n + "ln1_gamma"], p[n + "ln1_beta"])
        qkv = h @ p[n + "att_qkv_weight"].t() + p[n + "att_qkv_bias"]
        q, k, v = (t.reshape(S, H, D).transpose(0, 1)
                   for t in qkv.split(E, dim=-1))
        s = (q @ k.transpose(1, 2)) / math.sqrt(D)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + a.transpose(0, 1).reshape(S, E) @ p[n + "att_out_weight"].t() \
            + p[n + "att_out_bias"]
        h = F.layer_norm(x, (E,), p[n + "ln2_gamma"], p[n + "ln2_beta"])
        h = torch.relu(h @ p[n + "ffn1_weight"].t() + p[n + "ffn1_bias"])
        x = x + h @ p[n + "ffn2_weight"].t() + p[n + "ffn2_bias"]
    x = F.layer_norm(x, (E,), p["final_ln_gamma"], p["final_ln_beta"])
    return (x @ p["lm_head_weight"].t() + p["lm_head_bias"]).cpu().numpy()


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def run_engine(torch, params, prompts, quantize):
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.serving import GenerationEngine
    t0 = time.perf_counter()
    eng = GenerationEngine(params, ctx=torch.device(DEVICE), quantize=quantize,
                           **MODEL)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng.collect_logits = True
    # launch counts cover the generate() run only
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    t0 = time.perf_counter()
    tokens = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    n_tok = sum(len(t) for t in tokens)
    res = {"quantize": quantize or "float32",
           "prompt_buckets": st["prompt_buckets"],
           "decode_buckets": st["decode_buckets"],
           "engine_build_s": build_s, "generate_s": wall,
           "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "prefill_ms_per_prompt": st["prefill_s"] * 1e3 / st["prefills"],
           "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
           "decode_steps": st["decode_steps"],
           "launches": {"flash_decode": fd.flash_decode_attention.launches,
                        "quantized_matmul": qz.quantized_matmul.launches},
           "quantized_matmul_by_route":
               dict(qz.quantized_matmul.launches_by_route)}
    log("engine %-7s buckets prompt=%s decode=%s: prefill %.3f ms/prompt, "
        "decode %.3f ms/step over %d steps, %.1f tokens/s, launches %s, "
        "int8 matmul by body %s"
        % (res["quantize"], res["prompt_buckets"], res["decode_buckets"],
           res["prefill_ms_per_prompt"], res["decode_ms_per_step"],
           res["decode_steps"], res["tokens_per_s"], res["launches"],
           res["quantized_matmul_by_route"]))
    for toks, rows in zip(tokens, eng.last_logits):
        if len(toks) != MAX_NEW or len(rows) != MAX_NEW:
            raise AssertionError("%s: %d tokens / %d logit rows, want %d"
                                 % (res["quantize"], len(toks), len(rows),
                                    MAX_NEW))
        for r in rows:
            if r.shape != (MODEL["vocab_size"],) or not np.isfinite(r).all():
                raise AssertionError("%s: bad logits row" % res["quantize"])
    return res, tokens, eng.last_logits


def make_prompts(seed, n_more=0):
    """Phase 4's prompts (17 to 900 tokens), then ``n_more`` drawn after
    them from the same generator."""
    rng = np.random.RandomState(seed + 2)
    lengths = [17, 900] + sorted(int(n) for n in
                                 rng.randint(18, 900, size=N_PROMPTS - 2))
    prompts = [rng.randint(0, MODEL["vocab_size"], size=n).tolist()
               for n in lengths]
    for n in rng.randint(17, 901, size=n_more):
        prompts.append(rng.randint(0, MODEL["vocab_size"], size=n).tolist())
    return prompts


def phase_engine(torch, seed):
    params = seeded_params(seed)
    prompts = make_prompts(seed)
    lengths = [len(p) for p in prompts]
    f32, f_tok, f_logits = run_engine(torch, params, prompts, None)
    i8, q_tok, q_logits = run_engine(torch, params, prompts, "int8")
    if f32["launches"]["flash_decode"] < 1 or i8["launches"]["flash_decode"] < 1:
        raise AssertionError("flash_decode kernel did not run on the path")
    if i8["launches"]["quantized_matmul"] < 1:
        raise AssertionError("int8 kernel did not run on the path")
    if min(i8["quantized_matmul_by_route"].values()) < 1:
        raise AssertionError("generate() did not run both int8 bodies "
                             "(decode GEMV, prefill wgmma): %s"
                             % i8["quantized_matmul_by_route"])

    # float32 engine vs a plain full-sequence forward, shortest prompt:
    # logits rows n_prompt-1 .. end come from the paged cache + kernel
    seq = prompts[0] + f_tok[0]
    plain = plain_lm_logits(torch, params, seq[:-1])[len(prompts[0]) - 1:]
    ref_err = float(np.abs(np.stack(f_logits[0]) - plain).max())
    if not ref_err <= 1e-3:
        raise AssertionError("float32 engine vs plain forward: max |diff| "
                             "= %g > 1e-3" % ref_err)

    # int8 vs float32, per step, up to the first step whose tokens
    # differ (after it the two runs condition on different prefixes)
    worst, steps, same = 1.0, 0, 0
    for ft, qt, fr, qr in zip(f_tok, q_tok, f_logits, q_logits):
        for i in range(MAX_NEW):
            worst = min(worst, _cosine(fr[i], qr[i]))
            steps += 1
            if ft[i] != qt[i]:
                break
            same += 1
    if not worst >= 0.999:
        raise AssertionError("int8 logits cosine %.6f < 0.999" % worst)
    log("engine checks: float32 vs plain forward max|diff|=%.3g (tol 1e-3); "
        "int8 vs float32 min cosine %.6f over %d steps (%d with identical "
        "tokens)" % (ref_err, worst, steps, same))
    return {"float32": f32, "int8": i8, "prompt_lengths": lengths,
            "float32_vs_plain_max_abs_diff": ref_err,
            "int8_min_cosine": worst, "cosine_steps": steps,
            "identical_token_steps": same, "float32_tokens": f_tok}


# ----------------------------------------------------------------------
# phase 4b: the in-process ModelServer at full width
# ----------------------------------------------------------------------
#: phase 4's 8 prompts and 8 more, to each LM of the server
SERVE_PROMPTS = 16
#: the MLP's traffic: request sizes by weight (tools/serve_bench.py's
#: histogram for its toy MLP) and the number of requests
MLP_HIST = {1: 60, 2: 25, 4: 10, 8: 5}
MLP_REQUESTS = 200
CLIENTS = 4


def dequantized_params(params, qdtype):
    """The float32 weights that the quantized model computes with:
    each quantized weight replaced by float(q) * scale."""
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.models import transformer as tf
    names = qz.quantizable_weights(tf.get_decode_symbol(**MODEL).tojson())
    out = dict(params)
    for name in names:
        q, scale = qz.quantize_array(params[name], qdtype=qdtype)
        out[name] = qz.dequantize_array(q, scale)
    return out


def _telemetry_records(directory):
    records = []
    for path in sorted(os.listdir(directory)):
        if path.startswith("events-rank") and path.endswith(".jsonl"):
            with open(os.path.join(directory, path)) as f:
                records.extend(json.loads(line) for line in f)
    return records


def _client_threads(jobs):
    """Run ``jobs`` (callables) on CLIENTS threads, round robin; returns
    each job's result in order.  A job's exception fails the phase."""
    import threading
    results, errors = [None] * len(jobs), []

    def worker(idx):
        try:
            for i in range(idx, len(jobs), CLIENTS):
                results[i] = jobs[i]()
        except Exception as exc:             # raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _submit_generation(srv, model, prompt, eos_id, busy):
    """Admit one generation, retrying after a 429 (KV-cache pressure) as
    its ``retry_after_ms`` says; returns the request's future."""
    from mxnet_tpu_torch.serving import ServerBusy
    while True:
        try:
            future, _stream = srv.generate(model, prompt, eos_id=eos_id)
            return future
        except ServerBusy as exc:
            if exc.code != 429:
                raise
            busy[model] = busy.get(model, 0) + 1
            time.sleep(exc.retry_after_ms / 1e3)


def check_generated(torch, model, params, prompts, results):
    """Gate (a): every generated token's logit within 1e-3 of the
    maximum of its row of a plain full-sequence float32 forward over
    prompt + generated tokens (``params``: the weights the model
    computes with).  Returns the worst gap."""
    worst = 0.0
    for prompt, res in zip(prompts, results):
        toks = res["tokens"]
        if not toks or len(toks) > MAX_NEW:
            raise AssertionError("%s: %d tokens generated" % (model,
                                                               len(toks)))
        logits = plain_lm_logits(torch, params, prompt + toks[:-1])[
            len(prompt) - 1:]
        if logits.shape != (len(toks), MODEL["vocab_size"]) \
                or not np.isfinite(logits).all():
            raise AssertionError("%s: bad plain logits" % model)
        gap = float((logits.max(axis=1) - logits[np.arange(len(toks)),
                                                 toks]).max())
        worst = max(worst, gap)
    if not worst <= 1e-3:
        raise AssertionError("%s: a generated token's logit is %g below "
                             "its row's maximum (> 1e-3)" % (model, worst))
    return worst


def phase_serve(torch, seed, smi, phase4_tokens):
    """The in-process ModelServer at full width: two LMs (float32 and
    fp8 e4m3 weights) and the MLP on one server, CLIENTS client threads,
    then a small-pool server for the 429 path."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor import program_registry_stats
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import events, percentile
    from mxnet_tpu_torch.serving import ModelServer, ServerBusy, serve_report
    here = os.path.dirname(os.path.abspath(__file__))
    tel_dir = os.path.join(here, "build", "chip_smoke_telemetry")
    if os.path.isdir(tel_dir):
        for f in os.listdir(tel_dir):
            os.remove(os.path.join(tel_dir, f))
    os.environ["MXTPU_TELEMETRY"] = "1"
    os.environ["MXTPU_TELEMETRY_DIR"] = tel_dir
    events.refresh()
    # ctx=None: the server's default, the current context (gpu(0))
    ctx = None if DEVICE == "cuda" else torch.device(DEVICE)
    params = seeded_params(seed)
    prompts = make_prompts(seed, SERVE_PROMPTS - N_PROMPTS)
    # two requests stop at an eos_id: the token phase 4's float32 engine
    # generated 20th for the same prompt
    eos = {0: phase4_tokens[0][19], 1: phase4_tokens[1][19]}
    rng = np.random.RandomState(seed + 5)
    net = mx.models.get_mlp(num_classes=10, hidden=(128, 64))
    arg_shapes = net.infer_shape(data=(1, 128))[0]
    mlp_params = {"arg:" + n: (rng.randn(*sh) * 0.1).astype(np.float32)
                  for n, sh in zip(net.list_arguments(), arg_shapes)
                  if n not in ("data", "softmax_label")}
    sizes = rng.choice(sorted(MLP_HIST), size=MLP_REQUESTS,
                       p=np.array([MLP_HIST[k] for k in sorted(MLP_HIST)],
                                  np.float64) / sum(MLP_HIST.values()))
    mlp_inputs = [rng.rand(int(n), 128).astype(np.float32) for n in sizes]

    t0 = time.perf_counter()
    srv = ModelServer()
    engines = {
        "lm-f32": srv.add_generative_model("lm-f32", params, ctx=ctx,
                                           **MODEL),
        "lm-fp8": srv.add_generative_model("lm-fp8", params, ctx=ctx,
                                           quantize="fp8_e4m3", **MODEL)}
    srv.add_model("mlp", net.tojson(), mlp_params, {"data": (128,)},
                  buckets=(1, 2, 4, 8), ctx=ctx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name, eng in engines.items():
        st = eng.stats()
        if (st["block_size"], st["blocks_total"] + 1, eng.max_new) \
                != (32, 256, MAX_NEW):
            raise AssertionError("%s: not the engine's defaults: %s"
                                 % (name, st))
    lowerings = program_registry_stats()["lowerings"]
    fd.flash_decode_attention.launches = 0
    qz.quantized_matmul.launches = 0
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
    busy = {}
    gen_jobs = [(model, i) for i in range(SERVE_PROMPTS)
                for model in engines]
    mlp_lat = []

    def gen_job(model, i):
        return lambda: _submit_generation(srv, model, prompts[i],
                                          eos.get(i), busy)

    def mlp_job(x):
        def run():
            t = time.perf_counter()
            out = srv.submit("mlp", x).result(timeout=600)
            mlp_lat.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    t_start = time.perf_counter()
    futures = _client_threads([gen_job(m, i) for m, i in gen_jobs])
    mlp_out = _client_threads([mlp_job(x) for x in mlp_inputs])
    t_mlp = time.perf_counter() - t_start
    gen_res = [f.result(timeout=900) for f in futures]
    t_window = time.perf_counter() - t_start
    srv.drain(timeout=600)
    torch.cuda.synchronize()
    launches = {"flash_decode": fd.flash_decode_attention.launches,
                "quantized_matmul": qz.quantized_matmul.launches,
                "quantized_matmul_by_route":
                    dict(qz.quantized_matmul.launches_by_route),
                "quantized_matmul_by_qdtype":
                    dict(qz.quantized_matmul.launches_by_qdtype)}
    stats = srv.stats()
    events.flush()
    records = _telemetry_records(tel_dir)

    # (c) zero lowerings after warmup (each model's lowerings_since_warmup
    # counts from its own add_*, so only the last added reads 0 here)
    if program_registry_stats()["lowerings"] != lowerings \
            or stats["models"]["mlp"]["lowerings_since_warmup"]:
        raise AssertionError("lowerings after warmup: %d -> %d"
                             % (lowerings,
                                program_registry_stats()["lowerings"]))
    if stats["failed"]:
        raise AssertionError("%d requests failed" % stats["failed"])
    # (e) flash-decode once a layer on every decode step of either LM;
    # the fp8 model through both bodies of the weight-only kernel
    decode_steps = sum(1 for r in records if r.get("kind") == "serve"
                       and r.get("phase") == "decode")
    if launches["flash_decode"] != decode_steps * MODEL["num_layers"]:
        raise AssertionError(
            "flash_decode launched %d times over %d decode steps of %d "
            "layers" % (launches["flash_decode"], decode_steps,
                        MODEL["num_layers"]))
    if launches["quantized_matmul_by_qdtype"]["fp8_e4m3"] < 1 \
            or launches["quantized_matmul_by_qdtype"]["int8"] \
            or min(launches["quantized_matmul_by_route"].values()) < 1:
        raise AssertionError("the fp8 model did not run both fp8 bodies: "
                             "%s" % launches)
    # (a) generated tokens against a plain forward
    by_model = {m: [r for (mm, _i), r in zip(gen_jobs, gen_res) if mm == m]
                for m in engines}
    gaps = {}
    gaps["lm-f32"] = check_generated(
        torch, "lm-f32", params, prompts, by_model["lm-f32"])
    fp8_params = dequantized_params(params, "fp8_e4m3")
    gaps["lm-fp8"] = check_generated(
        torch, "lm-fp8", fp8_params, prompts, by_model["lm-fp8"])
    finish = {m: [r["finish_reason"] for r in by_model[m]] for m in engines}
    for m in engines:
        for i, r in enumerate(by_model[m]):
            stop = eos.get(i)
            if r["finish_reason"] == "eos" and r["tokens"][-1] != stop \
                    or r["finish_reason"] == "length" \
                    and len(r["tokens"]) != MAX_NEW:
                raise AssertionError("%s request %d: finished %s with %d "
                                     "tokens" % (m, i, r["finish_reason"],
                                                 len(r["tokens"])))
    # (f) report: the fp8 model's plain logits against float32's plain
    # logits over the same (fp8-generated) sequences
    cos = 1.0
    for prompt, res in zip(prompts, by_model["lm-fp8"]):
        f32 = plain_lm_logits(torch, params, prompt + res["tokens"][:-1])[
            len(prompt) - 1:]
        f8 = plain_lm_logits(torch, fp8_params,
                             prompt + res["tokens"][:-1])[len(prompt) - 1:]
        cos = min(cos, min(_cosine(a, b) for a, b in zip(f32, f8)))
    # (b) MLP against a serial Predictor
    mlp_err = 0.0
    preds = {}
    for x, out in zip(mlp_inputs, mlp_out):
        pred = preds.get(x.shape[0])
        if pred is None:
            pred = preds[x.shape[0]] = mx.Predictor(
                net.tojson(), mlp_params, {"data": x.shape}, ctx=ctx)
        ref = pred.forward(data=x)[0]
        np.testing.assert_allclose(out[0], ref, rtol=1e-5, atol=1e-6)
        mlp_err = max(mlp_err, float(np.abs(out[0] - ref).max()))

    rep = serve_report(records)
    res = {"build_s": build_s, "window_s": t_window, "retries_429": busy,
           "finish_reasons": finish,
           "launches": launches, "decode_steps": decode_steps,
           "token_logit_gap": gaps, "fp8_min_cosine": cos,
           "mlp_max_abs_err": mlp_err, "models": {}}
    for name in engines:
        recs = [r for r in records if r.get("kind") == "serve"
                and r.get("model") == name]
        ttft = [v for r in recs for v in r.get("ttft_ms") or ()]
        itl = [v for r in recs for v in r.get("itl_ms") or ()]
        dec = [r["device_ms"] for r in recs if r.get("phase") == "decode"]
        n_tok = sum(len(r["tokens"]) for r in by_model[name])
        m = {"tokens": n_tok, "tokens_per_s": n_tok / t_window,
             "ttft_ms": {"p50": percentile(ttft, 50),
                         "p99": percentile(ttft, 99)},
             "itl_ms": {"p50": percentile(itl, 50),
                        "p99": percentile(itl, 99)},
             "decode_ms_per_step": float(np.mean(dec)),
             "decode_steps": len(dec),
             "decode_batch_mean": float(np.mean(
                 [r["n_samples"] for r in recs
                  if r.get("phase") == "decode"])),
             "serve_report": rep["models"].get(name)}
        res["models"][name] = m
        log("serve %-7s %d tokens in %.3f s: %.1f tokens/s; TTFT p50 %.1f "
            "p99 %.1f ms; ITL p50 %.2f p99 %.2f ms; decode %.3f ms a step "
            "over %d steps (mean batch %.2f); logit gap <= %.3g (%s)"
            % (name, n_tok, t_window, m["tokens_per_s"], m["ttft_ms"]["p50"],
               m["ttft_ms"]["p99"], m["itl_ms"]["p50"], m["itl_ms"]["p99"],
               m["decode_ms_per_step"], m["decode_steps"],
               m["decode_batch_mean"], gaps[name], smi))
    mrep = rep["models"]["mlp"]
    res["models"]["mlp"] = {
        "requests": len(mlp_inputs), "req_per_s": len(mlp_inputs) / t_mlp,
        "latency_ms": {"p50": percentile(mlp_lat, 50),
                       "p99": percentile(mlp_lat, 99)},
        "serve_report": mrep}
    log("serve mlp     %d requests in %.3f s: %.1f req/s; client latency "
        "p50 %.3f p99 %.3f ms (batcher: p50 %s p99 %s ms, occupancy %s); "
        "max |server - Predictor| %.3g (%s)"
        % (len(mlp_inputs), t_mlp, res["models"]["mlp"]["req_per_s"],
           res["models"]["mlp"]["latency_ms"]["p50"],
           res["models"]["mlp"]["latency_ms"]["p99"],
           mrep["latency_ms"]["p50"], mrep["latency_ms"]["p99"],
           mrep["occupancy"], mlp_err, smi))
    log("serve checks: lowerings after warmup 0; flash_decode %d launches "
        "= %d decode steps x %d layers; weight-only matmul %s by body %s "
        "by type %s; 429 retries %s; fp8 vs float32 plain logits min "
        "cosine %.6f (reported, not gated)"
        % (launches["flash_decode"], decode_steps, MODEL["num_layers"],
           launches["quantized_matmul"],
           launches["quantized_matmul_by_route"],
           launches["quantized_matmul_by_qdtype"], busy, cos))

    # the same prompts through engine.generate() on the same engines, the
    # server closed first (its scheduler would step the engine's active
    # sequences); eight prompts a call, as phase 4 (sixteen outgrow the
    # 255-block pool at admission)
    srv.close()
    for name, eng in engines.items():
        t = time.perf_counter()
        toks = (eng.generate(prompts[:N_PROMPTS])
                + eng.generate(prompts[N_PROMPTS:]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_tok = sum(len(x) for x in toks)
        same = sum(a == b["tokens"] for a, b, i in zip(
            toks, by_model[name], range(SERVE_PROMPTS)) if i not in eos)
        res["models"][name]["generate_s"] = wall
        res["models"][name]["generate_tokens_per_s"] = n_tok / wall
        res["models"][name]["same_tokens_as_generate"] = same
        log("serve %-7s engine.generate() of the same prompts: %.3f s, "
            "%.1f tokens/s; %d of %d requests without eos_id gave the "
            "same tokens through the server (printed, not gated)"
            % (name, wall, n_tok / wall, same, SERVE_PROMPTS - len(eos)))

    # (d) KV-cache pressure: a pool of 40 blocks holds one 900-token
    # request (31 blocks) and not a second
    small = ModelServer()
    small.add_generative_model("lm-small", params, ctx=ctx, kv_blocks=40,
                               prompt_buckets=(960,), decode_buckets=(1,),
                               **MODEL)
    first, _s = small.generate("lm-small", prompts[1])
    try:
        small.generate("lm-small", prompts[1])
    except ServerBusy as exc:
        doc = exc.to_dict()
        if exc.code != 429 or "blocks_free" not in doc:
            raise AssertionError("429 without blocks_free: %s" % doc)
        res["busy_429"] = doc
    else:
        raise AssertionError("a second 900-token request was admitted "
                             "into a 39-block pool")
    done = first.result(timeout=300)
    if len(done["tokens"]) != MAX_NEW:
        raise AssertionError("the admitted request did not finish: %s"
                             % done)
    small.close()
    log("serve 429 under KV-cache pressure: %s; the admitted request "
        "finished with %d tokens" % (res["busy_429"], len(done["tokens"])))
    del os.environ["MXTPU_TELEMETRY"], os.environ["MXTPU_TELEMETRY_DIR"]
    events.refresh()
    return res


# ----------------------------------------------------------------------
# phase 4c: the serving fleet at full width
# ----------------------------------------------------------------------
#: the LM the fleet serves: phase 4's model (vocab 8192, 8 layers, 8
#: heads, dim 512) through ``models.transformer.get_symbol`` at a
#: 512-token window
FLEET_LM = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
                seq_len=512, ffn_mult=4)
FLEET_BUCKETS = (1, 2, 4)
FLEET_REQUESTS = 48
FLEET_DRILL_REQUESTS = 16
FLEET_SWAP_REQUESTS = 8
FLEET_QUANTIZE = "fp8_e4m3"
#: heartbeat staleness bound of the drill, seconds
FLEET_HB_TIMEOUT_S = 3.0
#: the respawned replica must answer within this many seconds of the kill
FLEET_RESPAWN_LIMIT_S = 60.0
FLEET_TIMEOUT_S = 120.0


def fleet_symbol():
    """The served graph: ``get_symbol``'s LM with its softmax output
    reshaped to (batch, seq_len, vocab), so the batch axis leads as the
    server slices results by rows."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tf
    S, V = FLEET_LM["seq_len"], FLEET_LM["vocab_size"]
    return mx.sym.Reshape(tf.get_symbol(**FLEET_LM), shape=(-1, S, V),
                          name="lm_out")


def fleet_params(sym, seed):
    """Seeded weights of the served LM (phase 4's rules: N(0, 0.02)
    matrices and embeddings, zero biases, unit LayerNorm)."""
    S = FLEET_LM["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def fleet_requests(seed, count):
    """``count`` requests of 1 or 2 sequences of seq_len token ids."""
    S, V = FLEET_LM["seq_len"], FLEET_LM["vocab_size"]
    rng = np.random.RandomState(seed)
    out = []
    for n in rng.choice([1, 2], size=count):
        ids = rng.randint(0, V, (int(n), S)).astype(np.float32)
        out.append({"data": ids, "softmax_label": np.zeros_like(ids)})
    return out


def _digest(arr):
    import hashlib
    arr = np.ascontiguousarray(arr)
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest() \
        + str(arr.shape) + arr.dtype.str


class FleetReference(object):
    """In-process Predictors of the served LM, one per bucket, on the
    same checkpoint and quantization as the replicas: the digest of each
    request's output at every bucket it can have run at (a request of n
    rows padded with zero rows to the bucket, as the server packs it).
    Each bucket's Predictor is built afresh from the checkpoint, not by
    ``reshape`` as the server binds its later buckets, so a bucket bound
    wrong there cannot agree with its reference here."""

    def __init__(self, torch, sym_json, params_path, ctx):
        from mxnet_tpu_torch.predictor import Predictor
        S = FLEET_LM["seq_len"]
        self.preds = {
            b: Predictor(sym_json, params_path,
                         {"data": (b, S), "softmax_label": (b, S)},
                         ctx=ctx, quantize=FLEET_QUANTIZE)
            for b in FLEET_BUCKETS}

    def outputs(self, req):
        """{bucket: output rows of the request}."""
        n = req["data"].shape[0]
        out = {}
        for b, pred in self.preds.items():
            if b < n:
                continue
            feed = {k: np.zeros((b,) + v.shape[1:], v.dtype)
                    for k, v in req.items()}
            for k, v in req.items():
                feed[k][:n] = v
            out[b] = pred.forward(**feed)[0][:n]
        return out

    def digests(self, reqs):
        return [{b: _digest(o) for b, o in self.outputs(r).items()}
                for r in reqs]


def check_fleet_outputs(what, reqs, refs, got, reference):
    """Gate: each response bit for bit equal to the in-process Predictor
    at one of the buckets it can have run at.  Returns the count of
    matches by bucket."""
    by_bucket = {}
    for i, digest in got:
        hit = [b for b, d in refs[i].items() if d == digest]
        if not hit:
            outs = reference.outputs(reqs[i])
            raise AssertionError(
                "%s: request %d (n=%d) is not bit for bit the in-process "
                "Predictor's output at any bucket it fits (digest %s; "
                "buckets %s)" % (what, i, reqs[i]["data"].shape[0], digest,
                                 sorted(outs)))
        by_bucket[hit[0]] = by_bucket.get(hit[0], 0) + 1
    return by_bucket


def check_fleet_launches(what, launches):
    """Gate: the path ran the fp8 weight-only matmul's wgmma body and the
    float32 (FMA) flash-attention forward."""
    qmm = launches.get("quantized_matmul", {})
    fa = launches.get("flash_attention", {})
    if not (qmm.get("by_qdtype", {}).get("fp8_e4m3", 0) > 0
            and qmm.get("by_route", {}).get("wgmma", 0) > 0
            and fa.get("by_dtype", {}).get("float32", 0) > 0):
        raise AssertionError("%s did not run the fp8 wgmma body and the "
                             "float32 flash forward: %s" % (what, launches))


def gpu_memory_by_pid():
    """``nvidia-smi``'s compute processes: [(pid, used memory), ...]."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr.strip())
    return [tuple(p.strip() for p in line.split(",", 1))
            for line in out.stdout.strip().splitlines() if line.strip()]


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _timed_jobs(call, reqs, idx):
    """CLIENTS threads send ``reqs[i]`` for i in ``idx`` through
    ``call``; returns (wall seconds, [(i, digest)], [latency ms])."""
    got, lat = [None] * len(idx), [None] * len(idx)

    def job(j):
        def run():
            t = time.perf_counter()
            out = call(reqs[idx[j]])
            lat[j] = (time.perf_counter() - t) * 1e3
            got[j] = (idx[j], _digest(out))
        return run

    t0 = time.perf_counter()
    _client_threads([job(j) for j in range(len(idx))])
    return time.perf_counter() - t0, got, lat


def _front_door(router):
    import threading
    from http.server import ThreadingHTTPServer
    from mxnet_tpu_torch.tools.mxfleet import make_front_handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_front_handler(router))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_port


def _raw_predict(url, model, req):
    """One npz POST to a front door: (status, headers, body)."""
    import http.client
    from mxnet_tpu_torch.serving.fleet import encode_arrays
    host, port = url.split("://", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=FLEET_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/predict", body=encode_arrays(req),
                     headers={"Content-Type": "application/x-npz",
                              "X-MXTPU-Model": model})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def phase_fleet(torch, seed, smi):
    """The serving fleet on one card: ``launch_fleet`` spawns two
    ``mxfleet replica`` processes serving the full-width LM with fp8
    weights; traffic through the ``mxfleet serve`` front door, held bit
    for bit to in-process Predictors; a SIGKILL drill, a rolling swap,
    admission (429) and drain (503)."""
    import shutil
    import signal
    import threading
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import quantize as qz
    from mxnet_tpu_torch.observability import percentile
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.serving import ModelServer, ServerBusy
    from mxnet_tpu_torch.serving.fleet import (FleetClient, ReplicaDead,
                                               fleet_ledger_path,
                                               launch_fleet)
    from mxnet_tpu_torch.observability.metrics import kernel_counters
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx_name = "gpu" if DEVICE == "cuda" else "cpu"
    ctx = mx.Context(ctx_name)
    model = "lm-fp8"
    S = FLEET_LM["seq_len"]

    # the checkpoint: symbol JSON and two seeded 0x112 params files
    sym = fleet_symbol()
    sym_path = os.path.join(work, "lm-symbol.json")
    sym.save(sym_path)
    paths = {}
    for tag, s in (("v1", seed + 31), ("v2", seed + 32)):
        paths[tag] = os.path.join(work, "lm-%s.params" % tag)
        mx.nd.save(paths[tag], {"arg:" + k: torch.from_numpy(v) for k, v
                                in fleet_params(sym, s).items()})
    spec_path = os.path.join(work, "fleet.json")
    with open(spec_path, "w") as f:
        json.dump({"models": [{"name": model, "symbol": sym_path,
                               "params": paths["v1"],
                               "input_shapes": {"data": [S],
                                                "softmax_label": [S]},
                               "buckets": list(FLEET_BUCKETS)}],
                   "version": "v1", "ctx": ctx_name}, f)
    reqs = fleet_requests(seed + 33, FLEET_REQUESTS)
    res = {"model": dict(FLEET_LM, quantize=FLEET_QUANTIZE,
                         buckets=list(FLEET_BUCKETS)),
           "requests": FLEET_REQUESTS,
           "sizes": [int(r["data"].shape[0]) for r in reqs]}

    # (1) the reference: in-process Predictors, their launches counted
    for c in (fa.flash_attention_forward, qz.quantized_matmul):
        c.launches = 0
    fa.flash_attention_forward.launches_by_dtype.update(float32=0,
                                                        bfloat16=0)
    qz.quantized_matmul.launches_by_route.update(gemv=0, wgmma=0)
    qz.quantized_matmul.launches_by_qdtype.update(int8=0, fp8_e4m3=0)
    t0 = time.perf_counter()
    ref1 = FleetReference(torch, sym_path, paths["v1"], ctx)
    refs1 = ref1.digests(reqs)
    res["reference_launches"] = kernel_counters()
    check_fleet_launches("the in-process Predictor",
                         res["reference_launches"])
    log("fleet reference: %d requests at every bucket they fit in %.2f s; "
        "launches %s" % (len(reqs), time.perf_counter() - t0,
                         json.dumps(res["reference_launches"])))

    # (2) yardstick: the same requests through one in-process ModelServer
    prev_q = os.environ.get("MXTPU_QUANTIZE")
    os.environ["MXTPU_QUANTIZE"] = FLEET_QUANTIZE
    try:
        srv = ModelServer()
        srv.add_model(model, sym_path, paths["v1"],
                      {"data": (S,), "softmax_label": (S,)},
                      buckets=FLEET_BUCKETS, ctx=ctx)
        wall, got, lat = _timed_jobs(
            lambda r: srv.predict(model, r, timeout=FLEET_TIMEOUT_S)[0],
            reqs, list(range(len(reqs))))
        srv.close()
    finally:
        if prev_q is None:
            del os.environ["MXTPU_QUANTIZE"]
        else:
            os.environ["MXTPU_QUANTIZE"] = prev_q
    check_fleet_outputs("in-process server", reqs, refs1, got, ref1)
    res["in_process"] = {"req_per_s": len(reqs) / wall,
                         "p50_ms": percentile(lat, 50),
                         "p99_ms": percentile(lat, 99)}
    log("fleet yardstick, one in-process ModelServer: %s"
        % json.dumps(res["in_process"]))

    # (3) the fleet: two replica processes, the front door, traffic;
    # the routers read the heartbeat bound from the environment
    env = {"MXTPU_QUANTIZE": FLEET_QUANTIZE}
    prev_hb = os.environ.get("MXTPU_FLEET_HB_TIMEOUT_S")
    os.environ["MXTPU_FLEET_HB_TIMEOUT_S"] = str(FLEET_HB_TIMEOUT_S)
    procs, routers, doors = [], [], []
    t0 = time.perf_counter()
    router = launch_fleet(spec_path, n_replicas=2,
                          directory=os.path.join(work, "fleet"),
                          ports=[_free_port(), _free_port()],
                          startup_timeout_s=300.0, extra_env=env)
    routers.append(router)
    procs.extend(r.proc for r in router._replicas.values())
    res["startup_s"] = time.perf_counter() - t0
    try:
        httpd, url = _front_door(router)
        doors.append(httpd)
        client = FleetClient([url], timeout=FLEET_TIMEOUT_S)
        wall, got, lat = _timed_jobs(
            lambda r: client.predict(model, r, n=r["data"].shape[0])[0],
            reqs, list(range(len(reqs))))
        res["matched_buckets"] = check_fleet_outputs(
            "fleet", reqs, refs1, got, ref1)
        res["fleet"] = {"req_per_s": len(reqs) / wall,
                        "p50_ms": percentile(lat, 50),
                        "p99_ms": percentile(lat, 99)}
        rstats = router.replica_stats()
        res["replica_launches"] = {i: st["kernel_launches"]
                                   for i, st in rstats.items()}
        # the caching allocator's bytes by process (nvidia-smi's per-
        # process rows may not name processes inside a container)
        res["cuda_memory"] = dict(
            {"chip_smoke": {"reserved": torch.cuda.memory_reserved(),
                            "max_allocated":
                                torch.cuda.max_memory_allocated()}
             if DEVICE == "cuda" else None},
            **{"replica%s" % i: st["cuda_memory"]
               for i, st in rstats.items()})
        for i, launches in res["replica_launches"].items():
            check_fleet_launches("replica %s" % i, launches)
        res["gpu_memory"] = [
            {"pid": pid, "used_memory": used,
             "role": "chip_smoke" if pid == str(os.getpid())
             else "replica" if pid in {str(p.pid) for p in procs}
             else "other"} for pid, used in gpu_memory_by_pid()]
        log("fleet: 2 replicas up in %.2f s; %s; outputs bitwise the "
            "in-process Predictor's (by bucket %s); replica launches %s"
            % (res["startup_s"], json.dumps(res["fleet"]),
               res["matched_buckets"], json.dumps(res["replica_launches"])))
        log("fleet GPU memory by process (nvidia-smi): %s; CUDA allocator "
            "bytes: %s" % (json.dumps(res["gpu_memory"]),
                           json.dumps(res["cuda_memory"])))

        # (4) failover: SIGKILL replica 1 while requests are in flight
        drill = list(range(FLEET_DRILL_REQUESTS))
        outcomes = [None] * len(drill)

        def drill_job(j):
            def run():
                r = reqs[drill[j]]
                try:
                    out = router.predict(model, r, n=r["data"].shape[0],
                                         timeout=FLEET_TIMEOUT_S)[0]
                    outcomes[j] = ("ok", _digest(out))
                except ReplicaDead as exc:
                    outcomes[j] = ("replica_dead", exc.to_dict())
            return run

        jobs = [drill_job(j) for j in range(len(drill))]
        threads = [threading.Thread(
            target=lambda k=k: [jobs[j]() for j in range(k, len(jobs),
                                                         CLIENTS)])
            for k in range(CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        while router.stats()["replicas"]["1"]["inflight"] == 0:
            if time.monotonic() > deadline:
                raise AssertionError("replica 1 never had a request in "
                                     "flight")
            time.sleep(0.005)
        victim = router._replicas[1].proc
        t_kill = time.perf_counter()
        os.kill(victim.pid, signal.SIGKILL)
        ledger_path = fleet_ledger_path(os.path.join(work, "fleet"))
        first_verdict = None
        while first_verdict is None:
            led = elastic.read_ledger(path=ledger_path)
            if led and int(led.get("generation", 0)) >= 1:
                first_verdict = led
            elif time.perf_counter() - t_kill > 30.0:
                raise AssertionError("no death verdict in the ledger")
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=2 * FLEET_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("a request hung past its timeout")
        if (first_verdict.get("generation"), first_verdict.get("reason"),
                first_verdict.get("members")) != (1, "replica_death", [0]):
            raise AssertionError("ledger after the kill: %s"
                                 % first_verdict)
        ok = [(drill[j], o[1]) for j, o in enumerate(outcomes)
              if o[0] == "ok"]
        dead = [o[1] for o in outcomes if o[0] == "replica_dead"]
        if len(ok) + len(dead) != len(drill):
            raise AssertionError("drill outcomes: %s" % outcomes)
        check_fleet_outputs("failover", reqs, refs1, ok, ref1)
        while router.stats()["replicas"]["1"]["state"] != "ready":
            if time.perf_counter() - t_kill > FLEET_RESPAWN_LIMIT_S:
                raise AssertionError("replica 1 not healthy %.0f s after "
                                     "the kill" % FLEET_RESPAWN_LIMIT_S)
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        procs.append(router._replicas[1].proc)
        rep1 = router._replicas[1].client
        st1 = rep1.stats()
        if st1["generation"] != 1 or st1["pid"] == victim.pid:
            raise AssertionError("respawned replica: generation %s pid %s"
                                 % (st1["generation"], st1["pid"]))
        again = [(i, _digest(rep1.predict(model, reqs[i],
                                          n=reqs[i]["data"].shape[0])[0]))
                 for i in range(4)]
        check_fleet_outputs("respawned replica", reqs, refs1, again, ref1)
        rs = router.stats()
        res["failover"] = {"completed": len(ok), "replica_dead": len(dead),
                           "router_retries": rs["retries"],
                           "deaths": rs["replicas"]["1"]["deaths"],
                           "verdict": first_verdict,
                           "generation_now": rs["generation"],
                           "respawn_s": respawn_s}
        log("fleet failover: %s" % json.dumps(res["failover"]))

        # (5) rolling swap to the second checkpoint
        swap_idx = list(range(FLEET_SWAP_REQUESTS))
        ref2 = FleetReference(torch, sym_path, paths["v2"], ctx)
        refs2 = {i: d for i, d in zip(swap_idx, ref2.digests(
            [reqs[i] for i in swap_idx]))}
        sw = client.swap(paths["v2"], version="v2")
        for i, r in sorted(sw["replicas"].items()):
            if "error" in r or r.get("lowerings") != 0 \
                    or r.get("version") != "v2":
                raise AssertionError("swap on replica %s: %s" % (i, r))
        skew = router.stats()["version_skew"]
        if skew != {"v2": [0, 1]}:
            raise AssertionError("version skew after the swap: %s" % skew)
        _, got, _ = _timed_jobs(
            lambda r: client.predict(model, r, n=r["data"].shape[0])[0],
            reqs, swap_idx)
        check_fleet_outputs("after the swap", reqs, refs2, got, ref2)
        res["swap"] = {"swap_pause_ms": sw["swap_pause_ms"],
                       "lowerings": {i: r["lowerings"] for i, r
                                     in sorted(sw["replicas"].items())},
                       "version_skew": skew}
        log("fleet swap: %s" % json.dumps(res["swap"]))

        # (6) admission: a 1-replica fleet with a queue bound of 2
        small = launch_fleet(spec_path, n_replicas=1,
                             directory=os.path.join(work, "fleet-small"),
                             ports=[_free_port()], max_queue=2,
                             startup_timeout_s=300.0, extra_env=env)
        routers.append(small)
        procs.extend(r.proc for r in small._replicas.values())
        small_door, small_url = _front_door(small)
        doors.append(small_door)
        burst = [None] * 8
        bthreads = [threading.Thread(target=lambda k=k: burst.__setitem__(
            k, _raw_predict(small_url, model, reqs[k]))) for k in range(8)]
        for t in bthreads:
            t.start()
        for t in bthreads:
            t.join(timeout=2 * FLEET_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("a burst request hung")
        codes = [b[0] for b in burst]
        busy = [b for b in burst if b[0] == 429]
        if not busy or set(codes) - {200, 429}:
            raise AssertionError("burst of 8 at queue bound 2: codes %s"
                                 % codes)
        for _status, headers, body in busy:
            doc = json.loads(body.decode())
            if "Retry-After" not in headers \
                    or doc.get("error") != "server_busy" \
                    or doc.get("limit") != 2:
                raise AssertionError("429 without Retry-After or a "
                                     "structured body: %s %s"
                                     % (headers, doc))
        res["admission"] = {"codes": codes,
                            "retry_after": busy[0][1]["Retry-After"],
                            "body": json.loads(busy[0][2].decode())}
        log("fleet admission: %s" % json.dumps(res["admission"]))

        # (7) drain: the front door answers 503
        router.drain(timeout=FLEET_TIMEOUT_S)
        try:
            client.predict(model, reqs[0], n=reqs[0]["data"].shape[0])
        except ServerBusy as exc:
            if exc.code != 503:
                raise
            res["drain"] = exc.to_dict()
        else:
            raise AssertionError("a drained fleet answered a request")
        log("fleet drain: %s" % json.dumps(res["drain"]))
    finally:
        for door in doors:
            door.shutdown()
            door.server_close()
        for r in routers:
            r.close(drain=False)
        if prev_hb is None:
            del os.environ["MXTPU_FLEET_HB_TIMEOUT_S"]
        else:
            os.environ["MXTPU_FLEET_HB_TIMEOUT_S"] = prev_hb
    left = []
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            left.append(p.pid)
    if left:
        raise AssertionError("replica processes left running: %s" % left)
    res["replica_pids"] = [p.pid for p in procs]
    log("fleet closed: no replica left of pids %s" % res["replica_pids"])
    log("fleet on %s: router %.2f req/s (p50 %.1f ms, p99 %.1f ms) "
        "against %.2f req/s in one in-process server; failovers %d "
        "(retries), respawn %.2f s, swap pause ms %s"
        % (smi, res["fleet"]["req_per_s"], res["fleet"]["p50_ms"],
           res["fleet"]["p99_ms"], res["in_process"]["req_per_s"],
           res["failover"]["router_retries"], res["failover"]["respawn_s"],
           res["swap"]["swap_pause_ms"]))
    return res


# ----------------------------------------------------------------------
# phase 5: flash-attention forward
# ----------------------------------------------------------------------
def _bf16_close(torch, got, want):
    """Max |got - want| and whether every element is within one
    bfloat16 ulp of ``want`` (2**-7 |want|, plus 1e-5 near zero): the
    kernel and the plain version both compute in float32 and round the
    output once, so a float32 difference can flip that rounding by one
    ulp, no more."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= want.float().abs() * 2.0 ** -7 + 1e-5).all())
    return float(d.max()), ok


def phase_flash_attention(torch, timer, seed):
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(seed + 3)
    B, H, D = TRAIN_BATCH, TRAIN["num_heads"], \
        TRAIN["dim"] // TRAIN["num_heads"]
    S = TRAIN["seq_len"]
    #: float32 o: the same float32 online softmax as the plain version,
    #: summed over 1024 keys in another order; lse (about 7 to 12) to
    #: float32 rounding of exp/log sums; bfloat16 o: one bfloat16 ulp
    tol_o, tol_lse = 2e-5, 1e-4
    cases = [(S, D, causal, dt) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False)]
    # both bodies at a ragged S, at their other head dims and at a short,
    # ragged, non-causal S
    for dt in (torch.float32, torch.bfloat16):
        cases += [(1000, D, True, dt), (S, 32, True, dt), (S, 128, True, dt),
                  (77, D, False, dt)]
    rows = []
    for s_len, D, causal, dtype in cases:
        q, k, v = [torch.from_numpy(rng.randn(B, H, s_len, D).astype(
            np.float32)).to(DEVICE, dtype) for _ in range(3)]
        scale = 1.0 / math.sqrt(D)
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                            scale=scale)
        ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal,
                                                      scale=scale)
        torch.cuda.synchronize()
        lse_err = float((lse - rl).abs().max())
        if dtype == torch.float32:
            err = float((o - ro).abs().max())
            ok = err <= tol_o
            # the FMA body has no atomics and a fixed order of every sum
            o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal,
                                                  scale=scale)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(
                    "flash_attention S=%d D=%d causal=%s float32: two runs "
                    "differ" % (s_len, D, causal))
        else:
            err, ok = _bf16_close(torch, o, ro)
        if not (ok and lse_err <= tol_lse):
            raise AssertionError(
                "flash_attention S=%d D=%d causal=%s %s: max |kernel - "
                "plain| o %g, lse %g" % (s_len, D, causal, dtype, err,
                                         lse_err))
        pairs = s_len * (s_len + 1) // 2 if causal else s_len * s_len
        n_ops = 4 * B * H * pairs * D
        item = q.element_size()
        n_bytes = 4 * B * H * s_len * D * item + B * H * s_len * 4
        b_ms, b_by = bound_ms(n_bytes, n_ops,
                              F32_OPS_PER_S if dtype == torch.float32
                              else BF16_OPS_PER_S)
        row = {"B": B, "H": H, "S": s_len, "D": D, "causal": causal,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tol": tol_o if dtype == torch.float32 else "1 bf16 ulp",
               "repeat_bitwise": dtype == torch.float32,
               "ms": timer(lambda: fa.flash_attention_forward(
                   q, k, v, causal=causal, scale=scale)),
               "plain_ms": timer(lambda: fa.flash_attention_forward_reference(
                   q, k, v, causal=causal, scale=scale)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, scale=scale)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": n_ops}
        rows.append(row)
        log("flash_attention S=%-4d D=%-3d causal=%-5s %-8s err o=%.3g "
            "lse=%.3g kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f "
            "bound_ms=%.5f (%s)"
            % (s_len, D, causal, row["dtype"], err, lse_err, row["ms"],
               row["plain_ms"], row["library_ms"], b_ms, b_by))
    # Sq != Sk: q and k tiles that do not line up (checked, not timed)
    D = TRAIN["dim"] // TRAIN["num_heads"]
    for (sq, sk), causal, dtype in itertools.product(
            ((200, 77), (77, 200)), (True, False),
            (torch.float32, torch.bfloat16)):
        q = torch.from_numpy(rng.randn(B, H, sq, D).astype(np.float32)).to(
            DEVICE, dtype)
        k, v = [torch.from_numpy(rng.randn(B, H, sk, D).astype(
            np.float32)).to(DEVICE, dtype) for _ in range(2)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        ro, rl = fa.flash_attention_forward_reference(q, k, v, causal=causal)
        o2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        lse_err = float((lse - rl).abs().max())
        if dtype == torch.float32:
            err = float((o - ro).abs().max())
            ok = err <= tol_o and torch.equal(o, o2) \
                and torch.equal(lse, lse2)
        else:
            err, ok = _bf16_close(torch, o, ro)
        if not (ok and lse_err <= tol_lse):
            raise AssertionError(
                "flash_attention Sq=%d Sk=%d D=%d causal=%s %s: max |kernel "
                "- plain| o %g, lse %g (or float32 runs differ)"
                % (sq, sk, D, causal, dtype, err, lse_err))
        log("flash_attention Sq=%d Sk=%d D=%d causal=%-5s %-8s err o=%.3g "
            "lse=%.3g" % (sq, sk, D, causal, str(dtype).replace("torch.", ""),
                          err, lse_err))
    return rows


# ----------------------------------------------------------------------
# phase 6: the fused optimizer sweep
# ----------------------------------------------------------------------
def train_param_shapes():
    from mxnet_tpu_torch.models import transformer as tf
    sym = tf.get_symbol(**TRAIN)
    S = TRAIN["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(TRAIN_BATCH, S),
                                   softmax_label=(TRAIN_BATCH, S))
    return {n: s for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


#: every body of the sweep, as phase 6 holds and times it: (row name,
#: optimizer, its arguments, buffers moved an element: every buffer the
#: body reads once, the weight and the states it changes written once)
SWEEP_BODIES = [
    ("sgd", "sgd", {}, 3),
    ("sgd_momentum", "sgd", {"momentum": 0.9}, 5),
    ("adam", "adam", {}, 7),
    ("nag", "nag", {"momentum": 0.9}, 5),
    ("adamw", "adamw", {}, 7),
    ("adagrad", "adagrad", {}, 5),
    ("rmsprop", "rmsprop", {}, 9),
    ("adadelta", "adadelta", {}, 7),
    ("test", "test", {}, 3),
]
SWEEP_N = 16 * 1024 * 1024


def _library_optimizer(torch, row, w, g):
    """One PyTorch optimizer step on the same buffer, fused where PyTorch
    has a fused kernel, else ``foreach`` (a timing yardstick: its formula
    may differ, its bytes do not; centered RMSprop with momentum keeps
    Graves' three states but adds eps after the square root).
    ``(step, name)``, or ``(None, None)`` where PyTorch has no
    counterpart (Test)."""
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    table = {
        "sgd": ("SGD", dict(lr=0.1)),
        "sgd_momentum": ("SGD", dict(lr=0.1, momentum=0.9)),
        "nag": ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
        "adam": ("Adam", dict(lr=0.01)),
        "adamw": ("AdamW", dict(lr=0.01)),
        "adagrad": ("Adagrad", dict(lr=0.01)),
        "rmsprop": ("RMSprop", dict(lr=0.002, alpha=0.95, eps=1e-4,
                                    momentum=0.9, centered=True)),
        "adadelta": ("Adadelta", dict(lr=1.0, rho=0.9, eps=1e-5)),
    }
    if row not in table:
        return None, None
    cls, kw = table[row]
    try:
        opt = getattr(torch.optim, cls)([p], fused=True, **kw)
        name = "torch.optim.%s(fused=True)" % cls
        opt.step()          # creates the state
    except (RuntimeError, TypeError, ValueError):
        opt = getattr(torch.optim, cls)([p], foreach=True, **kw)
        name = "torch.optim.%s(foreach=True)" % cls
        opt.step()
    return opt.step, name


def _sweep_inputs(torch, gen, kind, kw, n, offset=0, clip=None):
    """An optimizer and w, g and state vectors of ``n`` elements drawn on
    the card from the seeded generator ``gen`` (``offset`` > 0: views that
    start that many elements in, so the kernel takes its scalar path),
    states of the sizes each formula keeps (variances positive,
    RMSProp's n >= g^2)."""
    from mxnet_tpu_torch import optimizer as opt_mod
    opt = opt_mod.create(kind, rescale_grad=1.0 / (TRAIN_BATCH *
                                                    TRAIN["seq_len"]),
                         clip_gradient=clip, **kw)

    def vec(scale, positive=False):
        a = torch.randn(n + offset, generator=gen, device=DEVICE) * scale
        return (a.abs() if positive else a)[offset:]

    proto = opt.create_state_arrays((1,))
    n_state = 0 if proto is None else (
        len(proto) if isinstance(proto, tuple) else 1)
    w, g = vec(0.02), vec(1e-3 * TRAIN_BATCH * TRAIN["seq_len"])
    states = [vec(1e-4, positive=(i > 0 or kind in ("adagrad", "adadelta")))
              for i in range(n_state)]
    if kind == "rmsprop":
        states[0] = states[1] * states[1] + states[0].abs()
    return opt, w, g, states


def _sweep_check(torch, fo, opt, w, g, states, lr, wd, t):
    """The kernel twice from the same inputs against the plain version:
    ``(max |kernel - plain|, ulps, bitwise on repeat)``."""
    want_w, want_s = fo.sweep_reference(opt, w, g, states, lr, wd, t)
    runs = []
    for _ in range(2):
        ww, ss = w.clone(), [s.clone() for s in states]
        fo.sweep(opt, ww, g, ss, lr, wd, t)
        runs.append([ww] + ss)
    torch.cuda.synchronize()
    errs, ulps = [], []
    for got, want in zip(runs[0], [want_w] + want_s):
        if not bool(torch.isfinite(want).all()):
            raise AssertionError("fused sweep %s: non-finite plain result"
                                 % type(opt).__name__)
        errs.append(float((got - want).abs().max()))
        ulps.append(float(((got - want).abs()
                           / (want.abs() * 2.0 ** -23 + 1e-38)).max()))
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    return max(errs), max(ulps), repeat


def phase_fused_opt(torch, timer, seed):
    """Every body of the sweep against its plain version, bit for bit and
    bitwise on repeat: at 16 M elements, at 4099 elements one element
    into their arrays (the scalar path), with and without clip_gradient
    (1e-3 clips about a third of the rescaled gradients), at t = 1 and
    t = 3; each body timed at 16 M elements; SGD with momentum on each
    bucket of the transformer LM."""
    from mxnet_tpu_torch.kernels import fused_opt as fo
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 4)
    shapes = train_param_shapes()
    metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    sizes = [sum(int(np.prod(shapes[n])) for n in b)
             for b in fo.plan_buckets(metas)]
    checks = 0
    for row, kind, kw, _bufs in SWEEP_BODIES:
        for n, offset in ((SWEEP_N, 0), (4099, 1)):
            for clip in (None, 1e-3):
                for t in (1, 3):
                    opt, w, g, st = _sweep_inputs(torch, gen, kind, kw, n,
                                                  offset, clip)
                    err, ulp, repeat = _sweep_check(torch, fo, opt, w, g, st,
                                                    opt.lr, 1e-4, t)
                    if err != 0.0 or not repeat:
                        raise AssertionError(
                            "fused sweep %s n=%d offset=%d clip=%s t=%d: "
                            "max err %g (%g ulp) against the plain version, "
                            "repeat bitwise %s" % (row, n, offset, clip, t,
                                                   err, ulp, repeat))
                    checks += 1
    log("fused_opt: %d bodies x (16 M, 4099 at offset 1) x clip "
        "(None, 1e-3) x t (1, 3): %d cases bit for bit against the plain "
        "version and on repeat" % (len(SWEEP_BODIES), checks))
    cases = [(r, SWEEP_N) for r in SWEEP_BODIES]
    cases += [(SWEEP_BODIES[1], n) for n in sizes]
    rows = []
    for (row, kind, kw, bufs), n in cases:
        opt, w, g, states = _sweep_inputs(torch, gen, kind, kw, n)
        body = fo.sweep_body(opt)
        lr = opt.lr
        err, ulp, repeat = _sweep_check(torch, fo, opt, w, g, states, lr,
                                        0.0, 3)
        if err != 0.0 or not repeat:
            raise AssertionError("fused sweep %s n=%d: max err %g, repeat "
                                 "bitwise %s" % (row, n, err, repeat))
        n_bytes = bufs * 4 * n
        b_ms, b_by = bound_ms(n_bytes, 0)
        lib_step, lib_name = _library_optimizer(torch, row, w, g)
        r = {"optimizer": row, "body": body, "n": n, "mbytes": 4 * n / 2 ** 20,
             "max_abs_err": err, "max_ulp": ulp, "tol": "bitwise",
             "ms": timer(lambda: fo.sweep(opt, w, g, states, lr, 0.0, 3)),
             "plain_ms": timer(lambda: fo.sweep_reference(
                 opt, w, g, states, lr, 0.0, 3)),
             "library_ms": timer(lib_step) if lib_step else None,
             "library": lib_name,
             "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(r)
        log("fused_opt %-12s n=%-9d (%.1f MB) bitwise; kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%s (%s) bound_ms=%.5f (%s)"
            % (row, n, r["mbytes"], r["ms"], r["plain_ms"],
               "%.4f" % r["library_ms"] if lib_step else "none", lib_name,
               b_ms, b_by))
    return rows, sizes


# ----------------------------------------------------------------------
# phase 7: training at full width
# ----------------------------------------------------------------------
def seeded_train_params(seed):
    """Random weights of the training graph, from ``seed`` with numpy:
    N(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in train_param_shapes().items():
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return params


def train_batch(seed):
    rng = np.random.RandomState(seed + 5)
    shape = (TRAIN_BATCH, TRAIN["seq_len"])
    return {"data": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32),
            "softmax_label": rng.randint(0, TRAIN["vocab_size"], shape)
            .astype(np.float32)}


def plain_train(torch, params, batch, steps, momentum=None):
    """``steps`` plain training steps of the same LM, written here with
    no module of the port: autograd through softmax attention (scores
    masked with -1e30), a summed cross entropy, whose gradient is
    SoftmaxOutput's p - onehot, and a leafwise SGD with momentum.
    ``params`` and ``momentum`` (None: zeros) are numpy arrays or
    tensors, left unchanged.  Returns the last step's softmax outputs,
    the parameters and the momentum."""
    F = torch.nn.functional
    E, H = TRAIN["dim"], TRAIN["num_heads"]
    D, S = E // H, TRAIN["seq_len"]
    rescale = 1.0 / (TRAIN_BATCH * S)
    lr, mom = TRAIN_SGD["learning_rate"], TRAIN_SGD["momentum"]
    p = {k: torch.as_tensor(v, device=DEVICE).clone().requires_grad_()
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) if momentum is None
         else torch.as_tensor(momentum[k], device=DEVICE).clone()
         for k, v in p.items()}
    ids = torch.from_numpy(batch["data"]).to(DEVICE).long()
    label = torch.from_numpy(batch["softmax_label"]).to(DEVICE).long()
    keep = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
    for _ in range(steps):
        x = p["tok_embed_weight"][ids] + p["pos_embed_weight"][None]
        for i in range(TRAIN["num_layers"]):
            n = "layer%d_" % i
            h = F.layer_norm(x, (E,), p[n + "ln1_gamma"], p[n + "ln1_beta"])
            qkv = h @ p[n + "att_qkv_weight"].t() + p[n + "att_qkv_bias"]
            q, k, v = (t.reshape(TRAIN_BATCH, S, H, D).transpose(1, 2)
                       for t in qkv.split(E, dim=-1))
            s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
            s = torch.where(keep, s, torch.full_like(s, -1e30))
            a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2) \
                .reshape(TRAIN_BATCH, S, E)
            x = x + a @ p[n + "att_out_weight"].t() + p[n + "att_out_bias"]
            h = F.layer_norm(x, (E,), p[n + "ln2_gamma"], p[n + "ln2_beta"])
            h = torch.relu(h @ p[n + "ffn1_weight"].t() + p[n + "ffn1_bias"])
            x = x + h @ p[n + "ffn2_weight"].t() + p[n + "ffn2_bias"]
        x = F.layer_norm(x, (E,), p["final_ln_gamma"], p["final_ln_beta"])
        logits = (x @ p["lm_head_weight"].t() + p["lm_head_bias"]) \
            .reshape(-1, TRAIN["vocab_size"])
        loss = F.cross_entropy(logits, label.reshape(-1), reduction="sum")
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k] = mom * m[k] - lr * (g * rescale)
                w += m[k]
    with torch.no_grad():
        probs = torch.softmax(logits, dim=-1)
    return probs.detach(), {k: v.detach() for k, v in p.items()}, m


def _f64(torch, state):
    """A numpy or tensor state dict (or None) in float64 on the card."""
    if state is None:
        return None
    return {k: torch.as_tensor(v, device=DEVICE).double()
            for k, v in state.items()}


def _diff(torch, o_a, p_a, o_b, p_b, before):
    """[max |o_a - o_b|, max |p_a - p_b| over every parameter]."""
    return [float((o_a.double() - o_b.double()).abs().max()),
            _param_err(torch, p_a, p_b, before)[0]]


def ulp_witness(torch, params, batch, steps):
    """How far the plain float32 trajectory moves from itself when every
    starting weight moves by one ulp: ``{steps: [outputs, parameters]}``
    after 1 step and after ``steps``.  Logged, not gated: it shows how
    much the trajectory amplifies a rounding-sized difference."""
    ulp = {k: np.nextafter(v, np.float32(np.inf)) for k, v in params.items()}
    got = {}
    for n in sorted({1, steps}):
        o, p, _m = plain_train(torch, params, batch, n)
        o_u, p_u, _m = plain_train(torch, ulp, batch, n)
        got[n] = _diff(torch, o_u, p_u, o, p, params)
    return got


def _param_err(torch, got, want, before):
    """Max |got - want| over every parameter, and the largest update
    ``want - before`` made (the scale the difference is judged on)."""
    err, upd = 0.0, 0.0
    for n, w in want.items():
        err = max(err, float((got[n] - w).abs().max()))
        upd = max(upd, float((w - torch.as_tensor(before[n], device=DEVICE))
                             .abs().max()))
    return err, upd


def run_trainer(torch, params, batch, steps, mode, compute_dtype=None,
                timed_steps=0, snapshots=False):
    """``steps`` steps of the port's ShardedTrainer on the GPU with
    ``MXTPU_FUSED_OPT=mode``; launch counts cover exactly these steps.
    Then ``timed_steps`` more, each ended by a synchronize, for the step
    time.  Returns the outputs of the last counted step, the parameters
    after it, a dict of counts and times, and (with ``snapshots``) each
    counted step's outputs, parameters and momentum."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.models import transformer as tf
    os.environ["MXTPU_FUSED_OPT"] = mode
    S = TRAIN["seq_len"]
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / (TRAIN_BATCH * S),
                              **TRAIN_SGD)
    tr = mx.parallel.ShardedTrainer(tf.get_symbol(**TRAIN), opt,
                                    ctx=torch.device(DEVICE),
                                    compute_dtype=compute_dtype)
    p = tf.params_from_numpy(params, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    aux = {}
    b = tr.shard_batch(batch)
    torch.cuda.synchronize()
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_forward.launches_by_dtype.update(float32=0, bfloat16=0)
    fo.sweep.launches = 0
    t0 = time.perf_counter()
    trail = []          # (outputs, params after, momentum after) a step
    for _ in range(steps):
        p, st, aux, outs = tr.step(p, st, aux, b)
        if snapshots:
            trail.append((outs[0], {n: w.clone() for n, w in p.items()},
                          {n: m.clone() for n, m in st.items()}))
    torch.cuda.synchronize()
    info = {"mode": mode, "compute_dtype": str(compute_dtype or "float32"),
            "steps": steps, "first_steps_s": time.perf_counter() - t0,
            "launches": {"flash_attention": fa.flash_attention_forward.launches,
                         "fused_opt": fo.sweep.launches},
            "flash_attention_by_dtype":
                dict(fa.flash_attention_forward.launches_by_dtype),
            "buckets": len(fo.plan_buckets({n: p[n]
                                            for n in tr.param_names}))}
    out = outs[0]
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("trainer %s: non-finite outputs" % info)
    counted = {n: w.clone() for n, w in p.items()}
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            p, st, aux, _o = tr.step(p, st, aux, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        info["step_ms"] = float(np.median(times)) * 1e3
        info["step_ms_all"] = [t * 1e3 for t in times]
        info["tokens_per_s"] = TRAIN_BATCH * S / (info["step_ms"] / 1e3)
    return out, counted, info, trail


#: phase 7's precision gate: the port may come at most this many times as
#: far from the float64 steps as the plain float32 step does
PRECISION_FACTOR = 2.0


def precision_check(torch, what, batch, steps, before, mom, outs, p_after):
    """The port's outputs ``outs`` and parameters ``p_after`` after
    ``steps`` steps from ``before``/``mom``, against the plain steps from
    the same state in float32 and in float64.  Each reading is
    ``[max |diff| outputs, max |diff| parameters]``; ``ok`` when the
    port's distance from float64 is within ``PRECISION_FACTOR`` times
    the plain float32 step's, in both."""
    o32, p32, _m = plain_train(torch, before, batch, steps, mom)
    o64, p64, _m = plain_train(torch, _f64(torch, before), batch, steps,
                               _f64(torch, mom))
    got = {"what": what,
           "port_vs_plain32": _diff(torch, outs, p_after, o32, p32, before),
           "port_vs_plain64": _diff(torch, outs, p_after, o64, p64, before),
           "plain32_vs_plain64": _diff(torch, o32, p32, o64, p64, before),
           "largest_update": _param_err(torch, p_after, p64, before)[1]}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    return got


def phase_train(torch, seed, smi):
    log("train: float32 products in full float32: "
        "torch.backends.cuda.matmul.allow_tf32=%s, "
        "torch.backends.cudnn.allow_tf32=%s"
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    params = seeded_train_params(seed)
    batch = train_batch(seed)
    steps = 3
    out_k, p_k, kern, trail = run_trainer(torch, params, batch, steps,
                                          "kernel", timed_steps=5,
                                          snapshots=True)
    n_layers = TRAIN["num_layers"]
    want = {"flash_attention": n_layers * steps,
            "fused_opt": kern["buckets"] * steps}
    if kern["launches"] != want or kern["flash_attention_by_dtype"] != {
            "float32": n_layers * steps, "bfloat16": 0}:
        raise AssertionError("float32 training launches %s (flash forward "
                             "by dtype %s), want %s (flash forward once a "
                             "layer a step, the FMA body; the sweep once a "
                             "bucket a step)" % (kern["launches"],
                                                 kern["flash_attention_by_dtype"],
                                                 want))
    # the same steps leafwise: bit for bit the same parameters
    _o, p_l, leaf, _t = run_trainer(torch, params, batch, steps, "")
    if leaf["launches"]["fused_opt"] != 0:
        raise AssertionError("leafwise run launched the sweep")
    diff = [n for n in p_k if not torch.equal(p_k[n], p_l[n])]
    if diff:
        raise AssertionError("fused-kernel and leafwise parameters differ "
                             "after %d steps: %s" % (steps, diff[:5]))
    del p_l, _o
    # Precision, against the same steps in float64: each step from the
    # port's state before it, and the three steps free-running from the
    # same weights.  The port must come no further from float64 than
    # PRECISION_FACTOR times the plain float32 step does, in the outputs
    # and in every parameter.  A fixed bound does not fit: SGD at lr 0.1
    # with momentum 0.9 amplifies rounding along the trajectory (a
    # one-ulp start grows about 1000x in the outputs over 3 steps; see
    # ulp_witness), and bias gradients that sum 8192 tokens with heavy
    # cancellation leave the plain float32 step itself about 1e-3 of the
    # largest update away from float64 after one step.
    checks = []
    before, mom = params, None
    for k, (outs, p_after, m_after) in enumerate(trail):
        checks.append(precision_check(torch, "step %d" % (k + 1), batch, 1,
                                      before, mom, outs, p_after))
        before, mom = p_after, m_after
    del trail
    checks.append(precision_check(torch, "%d free-running steps" % steps,
                                  batch, steps, params, None, out_k, p_k))
    del out_k, p_k
    ulp = ulp_witness(torch, params, batch, steps)
    torch.cuda.empty_cache()
    for c in checks:
        log("train precision %s: %s" % (c["what"], json.dumps(c)))
    log("train one-ulp start, plain float32 against itself [outputs, "
        "parameters] by steps: %s" % json.dumps(ulp))
    bad = [c["what"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(
            "float32 training %s: the port is more than %g times as far "
            "from the float64 steps as the plain float32 step (readings "
            "above)" % (", ".join(bad), PRECISION_FACTOR))
    out_b, _p, bf16, _t = run_trainer(torch, params, batch, steps, "kernel",
                                      compute_dtype="bfloat16", timed_steps=5)
    want_b = {"flash_attention": n_layers * steps,
              "fused_opt": bf16["buckets"] * steps}
    if bf16["launches"] != want_b or bf16["flash_attention_by_dtype"] != {
            "float32": 0, "bfloat16": n_layers * steps}:
        raise AssertionError("bfloat16 training launches %s (flash forward "
                             "by dtype %s), want %s, every flash forward "
                             "on the tensor-core body"
                             % (bf16["launches"],
                                bf16["flash_attention_by_dtype"], want_b))
    if out_b.dtype != torch.bfloat16:
        raise AssertionError("bfloat16 outputs came back %s" % out_b.dtype)
    del _p, out_b
    torch.cuda.empty_cache()
    for r in (kern, bf16):
        log("train %-8s MXTPU_FUSED_OPT=%s: %.3f ms/step (median of %d), "
            "%.1f tokens/s, launches in %d steps %s (%d buckets), flash "
            "forward by dtype %s; on %s"
            % (r["compute_dtype"], r["mode"], r["step_ms"],
               len(r["step_ms_all"]), r["tokens_per_s"], r["steps"],
               r["launches"], r["buckets"], r["flash_attention_by_dtype"],
               smi))
    log("train checks: fused kernel == leafwise bitwise over %d steps; "
        "precision within %g times the plain float32 step's, per step and "
        "free-running" % (steps, PRECISION_FACTOR))
    return {"float32": kern, "bfloat16": bf16, "leafwise": leaf,
            "precision": checks, "ulp_witness": ulp}


# ----------------------------------------------------------------------
# phase 9: ResNet-50 through ShardedTrainer at full width
# ----------------------------------------------------------------------
#: bench.py's image-classification configuration (bench.py:469-510):
#: ResNet-50 at 224 x 224, 1000 classes, 64 images, SGD lr 0.1,
#: momentum 0.9, wd 1e-4, rescale_grad 1/64
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_BATCH = 64
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
#: the batch of phase 9's float64 witness (float64 doubles the memory)
RESNET_WITNESS_BATCH = 8
#: phase 9's bfloat16 gates on the first step's softmax outputs, against
#: float32's: max |diff| (the outputs are about 1/1000 each), and the
#: norm of the difference over the norm of float32's own departure from
#: the uniform 1/1000 (a bfloat16 forward that lost its input, and gave
#: near-uniform outputs, reads about 1)
BF16_SOFTMAX_TOL = 1e-3
BF16_SOFTMAX_REL = 0.5
#: ResNet's BatchNorm epsilon (models/resnet.py)
RESNET_EPS = 2e-5


def resnet_symbol():
    import mxnet_tpu_torch as mx
    return mx.models.resnet.get_symbol(**RESNET)


def seeded_resnet(seed, batch):
    """Weights, aux and a batch of ResNet-50 from numpy: He-scaled
    convolutions, N(0, 0.01) classifier, zero biases and betas, unit
    gammas, zero moving means and unit moving variances; images N(0, 1),
    labels uniform over the classes."""
    sym = resnet_symbol()
    shape = (batch,) + RESNET["image_shape"]
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    params = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(s, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(s, np.float32)
        elif name == "fc1_weight":
            params[name] = (rng.randn(*s) * 0.01).astype(np.float32)
        else:
            params[name] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:])))\
                .astype(np.float32)
    aux = {n: (np.ones if n.endswith("moving_var") else np.zeros)(
        s, np.float32) for n, s in zip(sym.list_auxiliary_states(),
                                       aux_shapes)}
    data = {"data": rng.randn(*shape).astype(np.float32),
            "softmax_label": rng.randint(0, RESNET["num_classes"], batch)
            .astype(np.float32)}
    return params, aux, data


def resnet_step_flops(batch):
    """Operations of one training step: 3 x the forward's convolutions
    and classifier (2 a multiply-add; the backward computes the data and
    the weight gradients, each as many), from the graph's shapes."""
    from mxnet_tpu_torch.symbol import Symbol
    sym = resnet_symbol()
    shape = (batch,) + RESNET["image_shape"]
    arg_shapes, _, _ = sym.infer_shape(data=shape)
    wshape = dict(zip(sym.list_arguments(), arg_shapes))
    fwd = 0
    for node in sym._topo():
        if node.is_variable:
            continue
        w = node.inputs[1][0].name if len(node.inputs) > 1 else None
        if node.op.op_name == "Convolution":
            _, (out,), _ = Symbol([(node, 0)]).infer_shape(data=shape)
            fwd += 2 * int(np.prod(out)) * int(np.prod(wshape[w][1:]))
        elif node.op.op_name == "FullyConnected":
            fwd += 2 * batch * int(np.prod(wshape[w]))
    return 3 * fwd


def _five_counters():
    """Every hand kernel's launch counter (the five Pallas sites)."""
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import flash_decode as fd
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.kernels import quantize as qz
    return {"flash_decode": (fd.flash_decode_attention, "launches"),
            "quantized_matmul": (qz.quantized_matmul, "launches"),
            "flash_attention": (fa.flash_attention_forward, "launches"),
            "fused_opt": (fo.sweep, "launches"),
            "rtc": (rtc_mod, "launches")}


def reset_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    for obj, attr in _five_counters().values():
        setattr(obj, attr, 0)
    fo.sweep.launches_by_body.clear()


def read_counts():
    from mxnet_tpu_torch.kernels import fused_opt as fo
    out = {k: getattr(obj, attr) for k, (obj, attr) in
           _five_counters().items()}
    out["fused_opt_by_body"] = dict(fo.sweep.launches_by_body)
    return out


def run_resnet(torch, params, aux, data, steps, mode, opt_name="sgd",
               opt_kw=RESNET_SGD, compute_dtype=None, timed_steps=0):
    """``steps`` steps of the port's ShardedTrainer on ResNet-50 with
    ``MXTPU_FUSED_OPT=mode``; the five kernels' launch counts cover
    exactly these steps.  Then ``timed_steps`` more, each ended by a
    synchronize.  Returns the first step's softmax outputs, the
    parameters, aux and optimizer states after the counted steps
    (copies), and a dict of counts and times."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    from mxnet_tpu_torch.model import params_from_numpy
    os.environ["MXTPU_FUSED_OPT"] = mode
    batch = data["data"].shape[0]
    opt = mx.optimizer.create(opt_name, rescale_grad=1.0 / batch, **opt_kw)
    tr = mx.parallel.ShardedTrainer(resnet_symbol(), opt,
                                    ctx=torch.device(DEVICE),
                                    compute_dtype=compute_dtype)
    p, a = params_from_numpy(params, aux, ctx=torch.device(DEVICE))
    st = {n: opt.create_state_arrays(w.shape, w.dtype, w.device)
          for n, w in p.items()}
    st = {n: s for n, s in st.items() if s is not None}
    b = tr.shard_batch(data)
    torch.cuda.synchronize()
    reset_counts()
    first = None
    for _ in range(steps):
        p, st, a, outs = tr.step(p, st, a, b)
        if first is None:
            first = outs[0].float().clone()
    torch.cuda.synchronize()
    info = {"optimizer": opt_name, "mode": mode, "batch": batch,
            "compute_dtype": str(compute_dtype or "float32"),
            "steps": steps, "launches": read_counts(),
            "buckets": len(fo.plan_buckets({n: p[n]
                                            for n in tr.param_names}))}
    p_out = {n: w.clone() for n, w in p.items()}
    a_out = {n: v.clone() for n, v in a.items()}
    s_out = {"%s/%d" % (n, i): v.clone() for n, s in st.items()
             for i, v in enumerate(s if isinstance(s, tuple) else (s,))}
    for what, d in (("parameters", p_out), ("aux", a_out)):
        bad = [n for n, v in d.items() if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError("resnet %s: non-finite %s %s"
                                 % (info, what, bad[:5]))
    if timed_steps:
        times = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            p, st, a, _o = tr.step(p, st, a, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        info["step_ms"] = float(np.median(times)) * 1e3
        info["step_ms_all"] = [t * 1e3 for t in times]
        info["images_per_s"] = batch / (info["step_ms"] / 1e3)
    return first, p_out, a_out, s_out, info


def _want_sweep_only(info, body):
    """The counts of a run whose only hand kernel is the sweep: once a
    bucket a step, all on ``body``."""
    n = info["buckets"] * info["steps"]
    want = {"flash_decode": 0, "quantized_matmul": 0, "flash_attention": 0,
            "fused_opt": n, "rtc": 0, "fused_opt_by_body": {body: n}}
    if info["launches"] != want:
        raise AssertionError("resnet %s %s launches %s, want %s (the sweep "
                             "once a bucket a step, on body %d, and no "
                             "other kernel of the port)"
                             % (info["optimizer"], info["compute_dtype"],
                                info["launches"], want, body))


def plain_resnet_step(torch, params, data, dtype):
    """One plain training step of the same ResNet-50, written here with
    no module of the port: F.conv2d, BatchNorm's formula on the batch's
    mean and biased variance, max and mean pooling, a summed cross
    entropy (whose gradient is SoftmaxOutput's p - onehot), and SGD with
    momentum from zero and weight decay on every parameter.  Returns the
    softmax outputs and the parameters after the step, in ``dtype``."""
    F = torch.nn.functional
    batch = data["data"].shape[0]
    rescale = 1.0 / batch
    lr, mom, wd = (RESNET_SGD["learning_rate"], RESNET_SGD["momentum"],
                   RESNET_SGD["wd"])
    p = {k: torch.as_tensor(v, device=DEVICE, dtype=dtype).clone()
         .requires_grad_() for k, v in params.items()}
    x = torch.as_tensor(data["data"], device=DEVICE, dtype=dtype)
    label = torch.as_tensor(data["softmax_label"], device=DEVICE).long()

    def bn(h, name, fix_gamma=False):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        y = (h - mean) / torch.sqrt(var + RESNET_EPS)
        if not fix_gamma:
            y = y * p[name + "_gamma"].reshape(1, -1, 1, 1)
        return y + p[name + "_beta"].reshape(1, -1, 1, 1)

    def conv(h, name, stride=1, pad=0):
        return F.conv2d(h, p[name + "_weight"], None, stride, pad)

    h = conv(bn(x, "bn_data", fix_gamma=True), "conv0", 2, 3)
    h = F.max_pool2d(torch.relu(bn(h, "bn0")), 3, 2, 1)
    for i, units in enumerate([3, 4, 6, 3]):
        for j in range(units):
            name = "stage%d_unit%d" % (i + 1, j + 1)
            stride = 2 if i > 0 and j == 0 else 1
            a1 = torch.relu(bn(h, name + "_bn1"))
            c = conv(a1, name + "_conv1")
            c = conv(torch.relu(bn(c, name + "_bn2")), name + "_conv2",
                     stride, 1)
            c = conv(torch.relu(bn(c, name + "_bn3")), name + "_conv3")
            h = c + (h if j > 0 else conv(a1, name + "_sc", stride))
    h = torch.relu(bn(h, "bn1")).mean(dim=(2, 3))
    logits = h @ p["fc1_weight"].t() + p["fc1_bias"]
    loss = F.cross_entropy(logits, label, reduction="sum")
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    with torch.no_grad():
        for w, g in zip(p.values(), grads):
            g = torch.zeros_like(w) if g is None else g
            w += mom * 0.0 - lr * (g * rescale + wd * w)
        probs = torch.softmax(logits, dim=-1)
    return probs.detach(), {k: v.detach() for k, v in p.items()}


def resnet_witness(torch, seed):
    """Phase 7's precision witness at a batch of 8: one float32 step of
    the port (the sweep) and one of the plain step, each against the
    plain step in float64: [max |diff| softmax outputs, max |diff| over
    every parameter]."""
    params, aux, data = seeded_resnet(seed + 9, RESNET_WITNESS_BATCH)
    outs, p_port, _a, _s, info = run_resnet(torch, params, aux, data, 1,
                                            "kernel")
    _want_sweep_only(info, 1)
    o32, p32 = plain_resnet_step(torch, params, data, torch.float32)
    o64, p64 = plain_resnet_step(torch, params, data, torch.float64)

    def diff(o, p):
        return [float((o.double() - o64).abs().max()),
                max(float((p[n].double() - p64[n]).abs().max())
                    for n in p64)]
    got = {"port_vs_plain64": diff(outs, p_port),
           "plain32_vs_plain64": diff(o32, p32),
           "port_vs_plain32": [float((outs - o32).abs().max()),
                               max(float((p_port[n] - p32[n]).abs().max())
                                   for n in p32)],
           "largest_update": max(float((p64[n] - torch.as_tensor(
               params[n], device=DEVICE, dtype=torch.float64)).abs().max())
               for n in p64)}
    got["ok"] = all(a <= PRECISION_FACTOR * b for a, b in
                    zip(got["port_vs_plain64"], got["plain32_vs_plain64"]))
    got["launches"] = info["launches"]
    return got


class cudnn_deterministic:
    """cuDNN's deterministic algorithms and no autotuning inside the
    block (a bitwise gate between two runs needs them: cuDNN's default
    backward algorithms are not deterministic); the settings before it
    come back after."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.cudnn.deterministic, self.cudnn.benchmark)
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved


def _cudnn_settings(torch):
    c = torch.backends.cudnn
    return ("cuDNN deterministic=%s benchmark=%s allow_tf32=%s; "
            "torch.backends.cuda.matmul.allow_tf32=%s"
            % (c.deterministic, c.benchmark, c.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32))


#: phase 9's gates of fused == leafwise: (optimizer, its arguments,
#: steps, timed steps); SGD is the main path's, NAG and RMSProp launch
#: two of the new bodies at full width
RESNET_GATES = (("sgd", RESNET_SGD, 3, 5),
                ("nag", RESNET_SGD, 1, 0),
                ("rmsprop", {"learning_rate": 0.002, "wd": 1e-4}, 1, 0))


def phase_resnet(torch, seed, smi):
    """ResNet-50 through ShardedTrainer at bench.py's full width: the
    main path (float32 and bfloat16) timed under cuDNN's defaults; then,
    under deterministic cuDNN, the sweep against leafwise updates bit for
    bit for SGD, NAG and RMSProp, and the float64 witness."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import fused_opt as fo
    params, aux, data = seeded_resnet(seed, RESNET_BATCH)
    steps = 3
    log("resnet main path: " + _cudnn_settings(torch))
    o_k, _p, _a, _s, kern = run_resnet(torch, params, aux, data, steps,
                                       "kernel", timed_steps=5)
    _want_sweep_only(kern, 1)
    del _p, _a, _s
    o_b, _p, _a, _s, bf16 = run_resnet(torch, params, aux, data, steps,
                                       "kernel", compute_dtype="bfloat16",
                                       timed_steps=5)
    _want_sweep_only(bf16, 1)
    del _p, _a, _s
    bf16_err = float((o_b - o_k).abs().max())
    spread = o_k - 1.0 / RESNET["num_classes"]
    bf16_rel = float((o_b - o_k).norm() / spread.norm())
    log("resnet bfloat16 compute: first-step softmax outputs within %.3g "
        "of float32's (gate %g), relative to float32's departure from "
        "uniform %.3g (gate %g); parameters finite after %d steps"
        % (bf16_err, BF16_SOFTMAX_TOL, bf16_rel, BF16_SOFTMAX_REL, steps))
    if not (bf16_err <= BF16_SOFTMAX_TOL and bf16_rel <= BF16_SOFTMAX_REL):
        raise AssertionError("resnet bfloat16 softmax outputs %g (relative "
                             "%g) from float32's" % (bf16_err, bf16_rel))
    gates = {}
    with cudnn_deterministic(torch):
        log("resnet gates: " + _cudnn_settings(torch))
        for name, kw, n_steps, timed in RESNET_GATES:
            got = {}
            for mode in ("kernel", ""):
                _o, p, a, st, info = run_resnet(
                    torch, params, aux, data, n_steps, mode, opt_name=name,
                    opt_kw=kw, timed_steps=timed if mode else 0)
                got[mode] = (p, a, st, info)
            info = got["kernel"][3]
            body = fo.sweep_body(mx.optimizer.create(name, **kw))
            _want_sweep_only(info, body)
            if got[""][3]["launches"]["fused_opt"] != 0:
                raise AssertionError("leafwise resnet %s run launched the "
                                     "sweep" % name)
            diff = [n for i in range(3) for n in got["kernel"][i]
                    if not torch.equal(got["kernel"][i][n], got[""][i][n])]
            if diff:
                raise AssertionError(
                    "resnet %s: fused-kernel and leafwise parameters, aux or "
                    "states differ after %d steps: %s"
                    % (name, n_steps, diff[:5]))
            gates[name] = info
            log("resnet %s: %d step(s) through the sweep (body %d) == "
                "leafwise bitwise (parameters, aux, states); launches %s"
                % (name, n_steps, body, info["launches"]))
            del got
        witness = resnet_witness(torch, seed)
    log("resnet precision, one float32 step at batch %d [softmax outputs, "
        "parameters]: %s" % (RESNET_WITNESS_BATCH, json.dumps(witness)))
    if not witness["ok"]:
        raise AssertionError("resnet float32 step: the port is more than %g "
                             "times as far from the float64 step as the "
                             "plain float32 step (readings above)"
                             % PRECISION_FACTOR)
    torch.cuda.empty_cache()
    flops = resnet_step_flops(RESNET_BATCH)
    for label, r in (("float32", kern), ("bfloat16", bf16),
                     ("float32, deterministic cuDNN", gates["sgd"])):
        rate = F32_OPS_PER_S if r["compute_dtype"] == "float32" \
            else BF16_OPS_PER_S
        r["bound_ms"], r["bound_by"] = bound_ms(0, flops, rate)
        r["step_flops"] = flops
        log("resnet %s batch %d: %.3f ms/step (median of %d: %s), %.1f "
            "images/s; bound %.3f ms (%.3g TFLOP a step at %g TFLOP/s); "
            "sweep launches in %d steps %s (%d buckets); on %s"
            % (label, RESNET_BATCH, r["step_ms"], len(r["step_ms_all"]),
               ", ".join("%.2f" % t for t in r["step_ms_all"]),
               r["images_per_s"], r["bound_ms"], flops / 1e12, rate / 1e12,
               r["steps"], r["launches"]["fused_opt"], r["buckets"], smi))
    log("resnet checks: fused kernel == leafwise bitwise (parameters, aux "
        "and states) for %s; float64 witness within %g times the plain "
        "float32 step's"
        % (", ".join(g[0] for g in RESNET_GATES), PRECISION_FACTOR))
    return {"float32": kern, "bfloat16": bf16, "gates": gates,
            "witness": witness, "bf16_softmax_err": bf16_err,
            "bf16_softmax_rel": bf16_rel}


# ----------------------------------------------------------------------
# phase 10: Module.fit, as the image-classification example drives it
# ----------------------------------------------------------------------
MODULE_TRAIN_BATCHES = 8
MODULE_VAL_BATCHES = 2


def synthetic_image_batches(seed, n_batches, batch):
    """``example/image-classification/common.py:synthetic_iters``'
    formula, a batch at a time (its 1000 class prototypes of 3 x 224 x
    224 would take 1.2 GB): labels uniform over the classes, each image
    its class's prototype, U(-1, 1) drawn from a generator seeded by the
    class, plus 0.3 N(0, 1) noise; float32."""
    shape = RESNET["image_shape"]
    out = []
    for i in range(n_batches):
        rng = np.random.default_rng(seed * 1000 + i)
        y = rng.integers(0, RESNET["num_classes"], batch)
        protos = np.stack([np.random.default_rng(seed * 100003 + int(c))
                           .uniform(-1, 1, shape).astype(np.float32)
                           for c in y])
        x = protos + np.float32(0.3) * rng.standard_normal(
            (batch,) + shape, dtype=np.float32)
        out.append((x, y.astype(np.float32)))
    return out


def batch_iter(batches):
    """A DataIter over host batches made beforehand."""
    import mxnet_tpu_torch as mx
    batch = batches[0][0].shape[0]

    class _Iter(mx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = batch
            self.cur = 0

        @property
        def provide_data(self):
            return [mx.io.DataDesc("data", batches[0][0].shape)]

        @property
        def provide_label(self):
            return [mx.io.DataDesc("softmax_label", (batch,))]

        def reset(self):
            self.cur = 0

        def next(self):
            if self.cur >= len(batches):
                raise StopIteration
            x, y = batches[self.cur]
            self.cur += 1
            return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                   [mx.nd.array(y, ctx=mx.cpu())], pad=0)
    return _Iter()


def module_fit(torch, seed, train, val, kvstore):
    """``Module.fit`` of ResNet-50 as ``common.fit`` drives it: Xavier
    (in, 2.34), SGD lr 0.1, momentum 0.9, wd 1e-4, ``eval_metric="acc"``,
    a Speedometer; the weights drawn after ``random.seed(seed)``.
    Returns the module and each batch's end time and training accuracy."""
    import mxnet_tpu_torch as mx
    kv = mx.kvstore.KVStore("local") if kvstore == "local" else kvstore
    mx.random.seed(seed)
    mod = mx.mod.Module(resnet_symbol())
    seen = []

    def clock(param):
        seen.append((time.perf_counter(), param.eval_metric.get()[1]))
    mod.fit(batch_iter(train), eval_data=batch_iter(val) if val else None,
            eval_metric="acc", kvstore=kv, optimizer="sgd",
            optimizer_params=RESNET_SGD,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=1,
            batch_end_callback=[clock,
                                mx.callback.Speedometer(RESNET_BATCH, 50)])
    torch.cuda.synchronize()
    return mod, seen


def phase_module(torch, seed, smi):
    """Module.fit on ResNet-50 at batch 64 on the current context, timed
    under cuDNN's defaults; the two update routes compared under
    deterministic cuDNN."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import model as model_mod
    log("module fit: " + _cudnn_settings(torch))
    t0 = time.perf_counter()
    train = synthetic_image_batches(seed, MODULE_TRAIN_BATCHES, RESNET_BATCH)
    val = synthetic_image_batches(seed + 1, MODULE_VAL_BATCHES,
                                  RESNET_BATCH)
    data_s = time.perf_counter() - t0
    reset_counts()
    mod, seen = module_fit(torch, seed, train, val, "local")
    counts = read_counts()
    ex = mod._exec_group.execs[0]
    arg, aux = mod.get_params()
    want_dev = torch.device("cuda", 0) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    if ex._device != want_dev or any(v.data.device != want_dev
                                     for v in arg.values()):
        raise AssertionError("Module.fit ran on %s, not %s"
                             % (ex._device, want_dev))
    if not mod._update_on_kvstore:
        raise AssertionError("a KVStore object must update on the store")
    accs = [a for _t, a in seen]
    if len(seen) != MODULE_TRAIN_BATCHES or not all(
            math.isfinite(a) for a in accs):
        raise AssertionError("Module.fit training accuracy %s" % accs)
    (vname, vacc), = mod.score(batch_iter(val), "acc")
    span = seen[-1][0] - seen[0][0]
    ips = (len(seen) - 1) * RESNET_BATCH / span
    if any(counts[k] for k in counts if k != "fused_opt_by_body") \
            or counts["fused_opt_by_body"]:
        raise AssertionError("Module.fit launched hand kernels %s: neither "
                             "of its update routes runs the sweep" % counts)
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_ckpt", "resnet50")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod.save_checkpoint(prefix, 1)
    _sym, arg2, aux2 = model_mod.load_checkpoint(prefix, 1)
    for want, got in ((arg, arg2), (aux, aux2)):
        if set(want) != set(got) or any(
                not torch.equal(want[n].data.cpu(), got[n].data.cpu())
                for n in want):
            raise AssertionError("checkpoint round trip changed arrays")
    for f in (prefix + "-symbol.json", prefix + "-0001.params"):
        os.remove(f)
    # the two update routes from the same weights over the same 2 batches
    routes = {}
    with cudnn_deterministic(torch):
        for kv in ("local", None):
            m, _s = module_fit(torch, seed, train[:2], None, kv)
            routes[kv] = {n: v.data.clone()
                          for n, v in m.get_params()[0].items()}
            del m
    route_err = max(float((routes["local"][n] - routes[None][n]).abs().max())
                    for n in routes[None])
    if not route_err <= 1e-5:
        raise AssertionError("Module.fit: the fused step (kvstore=None) is "
                             "%g from the kvstore route after 2 steps"
                             % route_err)
    info = {"images_per_s": ips, "batches": len(seen),
            "batch": RESNET_BATCH, "train_accuracy": accs[-1],
            "val_" + vname: vacc, "device": str(ex._device),
            "update_on_kvstore": True, "launches": counts,
            "route_max_abs_diff": route_err, "data_s": data_s}
    log("module: Module.fit ResNet-50 on %s, kvstore local (update on the "
        "store), %d batches of %d: %.1f images/s (batches 2-%d); train "
        "accuracy %.4f, validation %.4f; checkpoint round trip bitwise; "
        "fused step (kvstore=None) within %.3g of the store's route after "
        "2 steps; hand-kernel launches %s; data made in %.2f s; on %s"
        % (ex._device, len(seen), RESNET_BATCH, ips, len(seen), accs[-1],
           vacc, route_err, counts, data_s, smi))
    torch.cuda.empty_cache()
    return info


# ----------------------------------------------------------------------
# phase 8: the imperative NDArray surface and runtime-compiled kernels
# ----------------------------------------------------------------------
#: phase 8's arrays, and the element count its elementwise kernels are
#: timed at (2^24 float32: 64 MiB an array)
IMPERATIVE_SHAPE = (4096, 4096)
RTC_TIMED_N = 1 << 24
#: the spin before each timed launch (about 100 us at the H100's 1.98 GHz
#: boost clock): every phase's timer has it
LEAD_CYCLES = 200000


def _ulps(torch, got, want):
    """Largest |got - want| in units of the float32 spacing at want."""
    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return float(((got - want).abs() / spacing).max())


def _np_ulps(got, want):
    a = np.abs(want)
    spacing = np.nextafter(a, np.float32(np.inf)) - a
    return float(np.max(np.abs(got - want) / spacing))


def _gelu_torch(x):
    """tanh-GELU on tensors (``example/rtc/pallas_kernel.py``'s)."""
    c = 0.7978845608
    return 0.5 * x * (1.0 + (c * (x + 0.044715 * x ** 3)).tanh())


def phase_imperative(torch, seed):
    """The user's path of the imperative surface, at (4096, 4096) float32:
    NDArrays made under ``with mx.gpu(0):`` with no ``ctx``, arithmetic,
    views that write through, in-place operators, registered functions,
    a sampler with ``out=`` into a view, the kernels (a)-(e) pushed
    through ``mx.rtc.Rtc`` with their grid and block, and a function
    pushed with ``pallas=False``; each result is held against numpy.
    Returns the Rtc launches of this run (the counter is reset first)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc as rtc_mod
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    rng = np.random.default_rng(seed + 8)
    rows, cols = IMPERATIVE_SHAPE
    xn = rng.random((rows, cols), dtype=np.float32)
    yn = rng.random((rows, cols), dtype=np.float32)
    vn = rng.random((cols, 256), dtype=np.float32)
    idx_n = rng.integers(0, cols, rows).astype(np.float32)
    xb_n, yb_n = (torch.from_numpy(a * 4 - 2).bfloat16().float().numpy()
                  for a in (xn, yn))
    errs = {}

    def check(what, got, want, tol, how="abs"):
        """``how``: 'abs' max |diff|, 'rel' max |diff| / max |want|,
        'ulp' float32 ulps at want; tol 0 means bit for bit."""
        got = got.asnumpy() if hasattr(got, "asnumpy") else got
        want = np.asarray(want, dtype=np.float32)
        if got.shape != want.shape:
            raise AssertionError("imperative %s: shape %s, want %s"
                                 % (what, got.shape, want.shape))
        if how == "ulp":
            err = _np_ulps(got, want)
        else:
            err = float(np.max(np.abs(got - want)))
            if how == "rel":
                err /= float(np.max(np.abs(want)))
        errs[what] = err
        if not err <= tol:
            raise AssertionError("imperative %s: error %g > %g (%s)"
                                 % (what, err, tol, how))

    grid = ((rows * cols + 255) // 256, 1, 1)
    rtc_mod.launches = 0
    t0 = time.perf_counter()
    with mx.gpu(0):
        x, y, v, idx = (mx.nd.array(a) for a in (xn, yn, vn, idx_n))
        if x.context != mx.gpu(0) or x.data.device.type != DEVICE:
            raise AssertionError("an array made under gpu(0) with no ctx "
                                 "lies on %s" % x.context)
        # arithmetic and comparisons: the same IEEE float32 operations
        # as numpy, bit for bit
        check("arithmetic", (x * y + 1) / (y + 0.5) - x,
              (xn * yn + 1) / (yn + 0.5) - xn, 0)
        check("comparisons", (x > y) * 3 - (x <= 0.25),
              (xn > yn) * 3.0 - (xn <= 0.25), 0)
        # views write through; in-place operators
        w, wn = mx.nd.array(xn), xn.copy()
        w[1:3][:] = 7.0
        wn[1:3] = 7.0
        w.reshape((rows * 2, cols // 2))[5][:] = -1.0
        wn.reshape(rows * 2, cols // 2)[5] = -1.0
        part = w[10:20]
        part += y[10:20]
        wn[10:20] += yn[10:20]
        w *= 2
        w -= 1
        w /= 4
        wn = (wn * 2 - 1) / 4
        check("views and in-place", w, wn, 0)
        # registered functions: products and sums in another order than
        # numpy's float64 (relative to the largest value), the rest exact
        check("dot", mx.nd.dot(x, v), xn.astype(np.float64) @ vn, 1e-5,
              "rel")
        check("sum", mx.nd.sum(x, axis=1), xn.astype(np.float64).sum(1),
              1e-5, "rel")
        check("argmax", mx.nd.argmax(x, axis=1), np.argmax(xn, axis=1), 0)
        oh = mx.nd.zeros((rows, cols))
        mx.nd.onehot_encode(idx, oh)
        check("onehot_encode", oh, np.eye(cols, dtype=np.float32)[
            idx_n.astype(np.int64)], 0)
        check("choose_element_0index", mx.nd.choose_element_0index(x, idx),
              xn[np.arange(rows), idx_n.astype(np.int64)], 0)
        u = mx.nd.zeros((rows, cols))
        mx.random.uniform(-1.0, 2.0, out=u[100:200])
        un = u.asnumpy()
        drawn = un[100:200]
        if not (drawn.min() >= -1.0 and drawn.max() < 2.0
                and abs(drawn.mean() - 0.5) < 0.01
                and not un[:100].any() and not un[200:].any()):
            raise AssertionError("random.uniform(out=view): range [%g, %g], "
                                 "mean %g" % (drawn.min(), drawn.max(),
                                              drawn.mean()))
        # the kernels, pushed as a user would: one element a thread at
        # [0, 1) inputs (NVRTC's FMA against numpy's two roundings:
        # 1 ulp), expf (2 ulp from exact, 2.5 from the rounded float64
        # value), and the bfloat16 and transpose kernels bit for bit
        (a_out,) = mx.rtc.Rtc(rk.XY_PLUS_ONE, pallas=True).push(
            [x, y], grid, (256, 1, 1))
        check("rtc x*y+1", a_out, xn * yn + 1, 1.0, "ulp")
        (b_out,) = mx.rtc.Rtc(rk.SAXPY, pallas=True).push(
            [x, y], grid, (256, 1, 1))
        check("rtc 2.5x+y", b_out, 2.5 * xn + yn, 1.0, "ulp")
        e = x[0].slice(0, 10) * 2 - 1
        en = xn[0, :10] * 2 - 1
        (c_out,) = mx.rtc.Rtc(rk.EXP_SHARED, pallas=True).push(
            [e], (1, 1, 1), (10, 1, 1))
        check("rtc exp(5x) shared", c_out,
              np.exp((en * np.float32(5)).astype(np.float64)), 2.5, "ulp")
        xb = mx.nd.array(xb_n, dtype=torch.bfloat16)
        yb = mx.nd.array(yb_n, dtype=torch.bfloat16)
        d0, d1 = mx.rtc.Rtc(rk.ADD_MUL_BF16, n_outputs=2, pallas=True,
                            out_dtypes=["float32", "float32"]).push(
            [xb, yb], grid, (256, 1, 1))
        check("rtc bf16 x+y", d0, xb_n + yb_n, 0)
        check("rtc bf16 x*y", d1, xb_n * yb_n, 0)
        (e_out,) = mx.rtc.Rtc(rk.TRANSPOSE, pallas=True,
                              out_shapes=[(cols, rows)]).push(
            [x], ((cols + 31) // 32, (rows + 31) // 32, 1), (32, 8, 1))
        check("rtc transpose", e_out, xn.T, 0)
        (g_out,) = mx.rtc.Rtc(_gelu_torch).push([x])
        xd = xn.astype(np.float64)
        check("rtc pallas=False gelu", g_out, 0.5 * xd * (1 + np.tanh(
            0.7978845608 * (xd + 0.044715 * xd ** 3))), 2e-6)
        mx.nd.waitall()
    seconds = time.perf_counter() - t0
    launches = rtc_mod.launches
    if launches != 5:
        raise AssertionError("the imperative path launched %d Rtc kernels, "
                             "want 5 (one each of (a)-(e))" % launches)
    log("imperative (4096, 4096) float32 on gpu(0): %.2f s, Rtc launches "
        "%d; errors %s" % (seconds, launches, ", ".join(
            "%s %.3g" % kv for kv in errs.items())))
    return {"launches": launches, "seconds": seconds, "errors": errs}


#: a one-input body for the error path of a block over the kernel's limit
ONE_INPUT_BODY = r"""
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < out0_size) out0[i] = 2.5f * in0[i] + 0.0f;
"""


def phase_rtc_kernels(torch, timer, seed):
    """Kernels (a)-(e) against their plain versions on the card (these
    launches are not the main path's), the error paths, and the times:
    kernel, plain and one-call library time, the bound, NVRTC's compile
    time of each key, and the host time of a cached push."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import rtc_kernels as rk
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    gpu = mx.gpu(0)

    def arr(shape, dtype=torch.float32, lo=0.0, hi=1.0):
        t = torch.rand(shape, generator=gen, device=DEVICE)
        return mx.nd.array((t * (hi - lo) + lo).to(dtype), ctx=gpu)

    def view(shape, offset):
        """A 1-D view that starts ``offset`` elements into a larger array
        (not 16-byte aligned for offset 1: saxpy's scalar path)."""
        return arr((shape[0] + offset,))[offset:offset + shape[0]]

    one = torch.ones((), device=DEVICE)
    #: (kernel, shape, offset of the inputs into a larger array)
    cases = [("xy_plus_one", (8, 8), 0), ("xy_plus_one", IMPERATIVE_SHAPE, 0),
             ("saxpy", (128, 128), 0), ("saxpy", (RTC_TIMED_N,), 0),
             ("saxpy", (RTC_TIMED_N + 3,), 0), ("saxpy", (RTC_TIMED_N,), 1),
             ("exp_shared", (10,), 0), ("add_mul_bf16", IMPERATIVE_SHAPE, 0),
             ("transpose", IMPERATIVE_SHAPE, 0)]
    #: (check, tolerance): 'ulp' float32 ulps at the plain value, or
    #: 'bitwise'
    tols = {"xy_plus_one": ("ulp", 1.0), "saxpy": ("ulp", 1.0),
            "exp_shared": ("ulp", 2.0), "add_mul_bf16": ("bitwise", 0.0),
            "transpose": ("bitwise", 0.0)}
    rows = []
    for name, shape, offset in cases:
        if offset:
            ins = [view(shape, offset), view(shape, offset)]
        elif name == "exp_shared":
            ins = [arr(shape, lo=-1.0)]
        elif name == "add_mul_bf16":
            ins = [arr(shape, torch.bfloat16, -2.0, 2.0) for _ in range(2)]
        elif name == "transpose":
            ins = [arr(shape)]
        else:
            ins = [arr(shape), arr(shape)]
        kernel = getattr(rk, name)
        plain = getattr(rk, name + "_reference")
        ts = [a.data for a in ins]
        got = [o.data for o in kernel(*ins)]
        want = plain(*ts)
        want = list(want) if isinstance(want, tuple) else [want]
        torch.cuda.synchronize()
        how, tol = tols[name]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if how == "ulp":
            meas = max(_ulps(torch, g, w) for g, w in zip(got, want))
        else:
            meas = err
        if not meas <= tol:
            raise AssertionError("rtc %s %s: %g %s > %g from the plain "
                                 "version" % (name, shape, meas, how, tol))
        n_bytes = (sum(t.numel() * t.element_size() for t in ts)
                   + sum(t.numel() * t.element_size() for t in want))
        b_ms, b_by = bound_ms(n_bytes, 0)
        x = ts[0]
        library = {"xy_plus_one": lambda: torch.addcmul(one, ts[0], ts[1]),
                   "saxpy": lambda: torch.add(ts[1], ts[0], alpha=2.5),
                   "transpose": lambda: x.t().contiguous()}.get(name)
        row = {"kernel": name, "shape": list(shape), "offset": offset,
               "n": x.numel(),
               "dtype": str(x.dtype).replace("torch.", ""),
               "max_abs_err": err, "check": how, "measured": meas,
               "tol": tol,
               "ms": timer(lambda: kernel(*ins)),
               "plain_ms": timer(lambda: plain(*ts)),
               "library_ms": timer(library) if library else None,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(row)
        log("rtc %-12s %-13s %-8s err=%.3g (%s %g, tol %g) kernel_ms=%.4f "
            "plain_ms=%.4f library_ms=%s bound_ms=%.5f (%s)"
            % (name, "x".join(str(d) for d in shape)
               + ("+%d" % offset if offset else ""), row["dtype"], err,
               how, meas, tol, row["ms"], row["plain_ms"],
               "%.4f" % row["library_ms"] if library else "null", b_ms,
               b_by))

    # the error paths: each must raise MXNetError, with the reason
    x = arr((64,))
    errors = {}
    for what, call, needle in (
            ("syntax error",
             lambda: mx.rtc.Rtc("out0[threadIdx.x] = in0[threadIdx.x] +;",
                                pallas=True).push([x], (1, 1, 1),
                                                  (64, 1, 1)),
             "NVRTC could not compile"),
            ("block of 2048 threads",
             lambda: mx.rtc.Rtc(ONE_INPUT_BODY, pallas=True).push(
                 [x], (1, 1, 1), (2048, 1, 1)),
             "more than the kernel's limit"),
            ("CPU tensor",
             lambda: mx.rtc.Rtc(rk.SAXPY, pallas=True).push(
                 [x.copyto(mx.cpu()), x.copyto(mx.cpu())], (1, 1, 1),
                 (64, 1, 1)),
             "cannot run on the CPU")):
        try:
            call()
        except mx.MXNetError as err:
            if needle not in str(err):
                raise AssertionError("rtc %s raised without %r: %s"
                                     % (what, needle, err))
            errors[what] = str(err).splitlines()[0]
            if what == "syntax error" and "error" not in str(err).split(
                    "--- source ---")[0].split("\n", 1)[1]:
                raise AssertionError("rtc syntax error: no NVRTC log in %s"
                                     % err)
        else:
            raise AssertionError("rtc %s did not raise" % what)
    log("rtc error paths raise: %s" % "; ".join(
        "%s -> %s" % kv for kv in errors.items()))

    # the host time of a cached push against one torch.add of the size
    a, b = arr((128, 128)), arr((128, 128))
    r = mx.rtc.Rtc(rk.SAXPY, pallas=True)
    dims = ((128 * 128 + 255) // 256, 1, 1), (256, 1, 1)
    host = {}
    for what, fn in (("push", lambda: r.push([a, b], *dims)),
                     ("torch_add", lambda: torch.add(b.data, a.data,
                                                     alpha=2.5))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        n = 500
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host[what + "_us"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    compile_s = sorted(
        k.compile_seconds for rt in list(rk._RTCS.values()) + [r]
        for k in rt._compiled.values())
    log("rtc host time of a cached push at 128x128: %.2f us; torch.add: "
        "%.2f us; NVRTC compile per key: %s s"
        % (host["push_us"], host["torch_add_us"],
           ", ".join("%.3f" % c for c in compile_s)))
    return {"rows": rows, "errors": errors, "host": host,
            "compile_s": compile_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per measurement (median)")
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print("chip_smoke: the mxnet_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    # float32 comparisons throughout: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        from mxnet_tpu_torch.kernels import _build
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log("device: %s (count %d), torch %s, CUDA %s"
            % (kind, torch.cuda.device_count(), torch.__version__,
               torch.version.cuda))
        log("nvidia-smi: %s" % smi)
        t0 = time.perf_counter()
        info = _build.build_all()
        log("build: %.2f s wall; %s" % (
            time.perf_counter() - t0,
            ", ".join("%s %.2f s" % (n, i["seconds"])
                      for n, i in sorted(info.items()))))
        for name, i in sorted(info.items()):
            for fn, regs, st, ld in ptxas_functions(i["log"]):
                log("  ptxas %s: %s: %d registers, %d bytes spill stores, "
                    "%d bytes spill loads" % (name, fn, regs, st, ld))
            for line in i["log"].splitlines():
                if "Performance Loss" in line:
                    log("  ptxas %s: %s" % (name, line.strip()))
        check_no_spills(info)
        torch.manual_seed(args.seed)
        timer = Timer(torch, args.iters, LEAD_CYCLES)
        phase_s = {}

        def run(name, fn, *a):
            t = time.perf_counter()
            out = fn(*a)
            phase_s[name] = round(time.perf_counter() - t, 2)
            return out
        fd_rows = run("2", phase_flash_decode, torch, timer, args.seed)
        qmm_rows = run("3", phase_quantized_matmul, torch, timer, args.seed)
        eng = run("4", phase_engine, torch, args.seed)
        serve = run("4b", phase_serve, torch, args.seed, smi,
                    eng["float32_tokens"])
        fleet = run("4c", phase_fleet, torch, args.seed, smi)
        fa_rows = run("5", phase_flash_attention, torch, timer, args.seed)
        fo_rows, bucket_sizes = run("6", phase_fused_opt, torch, timer,
                                    args.seed)
        train = run("7", phase_train, torch, args.seed, smi)
        imperative = run("8", phase_imperative, torch, args.seed)
        rtc_res = run("8 rtc", phase_rtc_kernels, torch, timer, args.seed)
        resnet = run("9", phase_resnet, torch, args.seed, smi)
        module = run("10", phase_module, torch, args.seed, smi)
        log("seconds by phase: %s" % json.dumps(phase_s))
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # one row per kernel: flash-decode at the decode batch of 8 (float32),
    # the int8 matmul at the decode lm_head shape (M=8, K=512, N=8192)
    fd_main = next(r for r in fd_rows if r["B"] == 8
                   and r["dtype"] == "float32" and r["kv_dtype"] == "float32")
    qmm_main = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                    == (8, 512, 8192) and r["dtype"] == "float32"
                    and r["qdtype"] == "int8")
    # the int8 matmul's prefill row: the wgmma body at the largest prompt
    # bucket (M=960, the lm_head shape, float32 x)
    qmm_prefill = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                       == (960, 512, 8192) and r["dtype"] == "float32"
                       and r["qdtype"] == "int8")
    # its fp8 e4m3 rows at the same shapes
    qmm_fp8 = {r["M"]: r for r in qmm_rows if r["qdtype"] == "fp8_e4m3"}
    # the generation paths: phase 4's two engines and the serve phase
    launches = {k: eng["float32"]["launches"][k] + eng["int8"]["launches"][k]
                + serve["launches"][k]
                for k in ("flash_decode", "quantized_matmul")}
    launches.update({k: train["float32"]["launches"][k]
                     + train["bfloat16"]["launches"][k]
                     for k in ("flash_attention", "fused_opt")})
    # the image-classification path (phase 9) launches the sweep alone:
    # its main path is the batch-64 SGD runs, float32 and bfloat16; the
    # gates' runs (deterministic cuDNN: SGD, NAG, RMSProp) and the
    # batch-8 witness are counted apart
    resnet_main = sum(resnet[d]["launches"]["fused_opt"]
                      for d in ("float32", "bfloat16"))
    launches["fused_opt"] += resnet_main
    resnet_other = {"resnet50_gate_" + n: g["launches"]
                    for n, g in resnet["gates"].items()}
    resnet_other["resnet50_witness_batch8"] = resnet["witness"]["launches"]
    transformer_sweeps = train["float32"]["launches"]["fused_opt"] \
        + train["bfloat16"]["launches"]["fused_opt"]
    # by body, over every path in launches_by_path
    sweep_by_body = {1: transformer_sweeps}
    for c in [resnet[d]["launches"] for d in ("float32", "bfloat16")] \
            + list(resnet_other.values()):
        for body, n in c["fused_opt_by_body"].items():
            sweep_by_body[body] = sweep_by_body.get(body, 0) + n
    # flash attention at the training shape (causal, float32); the sweep
    # at the model's largest bucket (SGD with momentum, as trained)
    fa_main = next(r for r in fa_rows if r["S"] == TRAIN["seq_len"]
                   and r["D"] == TRAIN["dim"] // TRAIN["num_heads"]
                   and r["causal"] and r["dtype"] == "float32")
    fa_bf16 = next(r for r in fa_rows if r["S"] == TRAIN["seq_len"]
                   and r["D"] == TRAIN["dim"] // TRAIN["num_heads"]
                   and r["causal"] and r["dtype"] == "bfloat16")
    fo_main = next(r for r in fo_rows if r["n"] == max(bucket_sizes)
                   and r["optimizer"] == "sgd_momentum")
    kernels = []
    for name, src, repl, main_row, rows in (
            ("flash_decode", "mxnet_tpu_torch/csrc/flash_decode.cu",
             "mxnet_tpu/kernels/flash_decode.py:100", fd_main, fd_rows),
            ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
             "mxnet_tpu/kernels/quantize.py:230", qmm_main, qmm_rows),
            ("flash_attention", "mxnet_tpu_torch/csrc/flash_attention.cu",
             "mxnet_tpu/parallel/ring_attention.py:128", fa_main, fa_rows),
            ("fused_opt", "mxnet_tpu_torch/csrc/fused_opt.cu",
             "mxnet_tpu/kernels/fused_opt.py:112", fo_main, fo_rows)):
        f32_rows = [r for r in rows if r.get("dtype", "float32") == "float32"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": {k: main_row[k] for k in ("B", "M", "K", "N", "H", "S",
                                               "D", "causal", "n",
                                               "optimizer", "dtype")
                      if k in main_row}})
    # the bodies beside the main rows: the flash forward's bfloat16
    # (wgmma) row at the training shape, the int8 matmul's prefill
    # (wgmma) row; and the launches of the main paths by body
    timing_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "max_abs_err")
    for k in kernels:
        if k["name"] == "fused_opt":
            k["launches_by_body"] = {str(b): n for b, n
                                     in sorted(sweep_by_body.items())}
            k["bodies"] = {
                r["optimizer"]: dict({t: r[t] for t in timing_keys},
                                     body=r["body"], n=r["n"],
                                     library=r["library"])
                for r in fo_rows if r["n"] == SWEEP_N}
            k["launches_by_path"] = dict(
                {"transformer_training": transformer_sweeps,
                 "resnet50_training": resnet_main},
                **{p: c["fused_opt"] for p, c in resnet_other.items()})
        elif k["name"] == "flash_attention":
            k["bfloat16"] = dict({t: fa_bf16[t] for t in timing_keys},
                                 shape={"B": fa_bf16["B"], "H": fa_bf16["H"],
                                        "S": fa_bf16["S"], "D": fa_bf16["D"],
                                        "causal": True})
            k["launches_by_dtype"] = {
                d: train["float32"]["flash_attention_by_dtype"][d]
                + train["bfloat16"]["flash_attention_by_dtype"][d]
                for d in ("float32", "bfloat16")}
        elif k["name"] == "quantized_matmul":
            k["prefill"] = dict({t: qmm_prefill[t] for t in timing_keys},
                                shape={"M": 960, "K": 512, "N": 8192,
                                       "dtype": "float32"})
            k["qdtypes"] = ["int8", "fp8_e4m3"]
            k["fp8_e4m3"] = {
                "M%d" % m: dict({t: r[t] for t in timing_keys},
                                route=r["route"])
                for m, r in sorted(qmm_fp8.items())}
            k["launches_by_route"] = {
                r: eng["int8"]["quantized_matmul_by_route"][r]
                + serve["launches"]["quantized_matmul_by_route"][r]
                for r in ("gemv", "wgmma")}
            k["launches_by_qdtype"] = {
                "int8": eng["int8"]["launches"]["quantized_matmul"],
                "fp8_e4m3": serve["launches"]["quantized_matmul_by_qdtype"][
                    "fp8_e4m3"]}
    # Rtc: kernel (b), 2.5*x + y at 2^24 float32 (example/rtc's kernel);
    # its launches are the imperative path's (phase 8)
    rtc_main = next(r for r in rtc_res["rows"] if r["kernel"] == "saxpy"
                    and r["n"] == RTC_TIMED_N and not r["offset"])
    kernels.append({
        "name": "rtc", "route": "cuda", "compiler": "nvrtc",
        "source": "mxnet_tpu_torch/kernels/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:79",
        "launches": imperative["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rtc_res["rows"]
                           if r["dtype"] == "float32"),
        "ms": rtc_main["ms"], "plain_ms": rtc_main["plain_ms"],
        "bound_ms": rtc_main["bound_ms"], "bound_by": rtc_main["bound_by"],
        "library_ms": rtc_main["library_ms"],
        "shape": {"kernel": "saxpy", "n": RTC_TIMED_N, "dtype": "float32"}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "build": {n: i["seconds"] for n, i in info.items()},
                       "flash_decode": fd_rows, "quantized_matmul": qmm_rows,
                       "engine": eng, "serve": serve, "fleet": fleet,
                       "flash_attention": fa_rows,
                       "fused_opt": fo_rows, "train": train,
                       "resnet": resnet, "module": module,
                       "phase_seconds": phase_s,
                       "imperative": imperative, "rtc": rtc_res,
                       "kernels": kernels}, f, indent=1)
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
