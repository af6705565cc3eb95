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
5. the flash-attention forward of training, kernel vs plain (``o`` and
   ``lse``), at B=8, H=8, S=1024, D=64, causal and not, float32 (the FMA
   body, also required to repeat bit for bit) and bfloat16 (the wgmma
   body), each also at a ragged S=1000, at D=32 and D=128 and at S=77,
   and (checked, not timed) at Sq != Sk (200 and 77 queries against 77
   and 200 keys), with times of the kernel, the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only) and the bound
   (operations at 67 TFLOP/s float32 or 989 TFLOP/s bfloat16, or bytes at
   3.35 TB/s, whichever is larger);
6. the fused optimizer sweep, kernel vs plain, on a 64 MB float32 bucket
   (SGD with momentum: bitwise; Adam: within 2 ulp) and on each bucket
   of the full-width model, with times of the kernel, the plain
   version, ``torch.optim.SGD``/``Adam(fused=True)`` on the same buffer
   (a yardstick only) and the bytes bound;
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
    cases = [(m, k, n, torch.float32)
             for m in (1, 2, 3, 4, 8, 16, 17, 33, 240, 960)
             for k, n in ((512, 2048), (2048, 512), (512, 8192))]
    # a wider model's ffn2 and lm_head at decode: K that the GEMV splits
    # so x fits its shared memory
    cases += [(8, 16384, 4096, torch.float32), (16, 4096, 8192, torch.float32)]
    cases += [(8, 512, 8192, torch.bfloat16), (240, 512, 2048, torch.bfloat16)]
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    for m, k, n, dtype in cases:
        q, scale = qz.quantize_array(
            (rng.randn(n, k) * 0.02).astype(np.float32))
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
            DEVICE, dtype)
        wq = torch.from_numpy(q).to(DEVICE)
        sc = torch.from_numpy(scale).to(DEVICE)
        plan = qz.plan_quantized_matmul(m, n, k, sms)
        got = qz.quantized_matmul(x, wq, sc)
        want = qz.quantized_matmul_reference(x, wq, sc)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tols[dtype]:
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s (%s): max |kernel - "
                "plain| = %g > %g" % (m, k, n, dtype, plan["route"], err,
                                      tols[dtype]))
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
               "dtype": str(dtype).replace("torch.", ""),
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
        log("quantized_matmul M=%-4d K=%-4d N=%-4d %-8s %-5s splits=%-2d "
            "err=%.3g (tol %g) kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f "
            "bound_ms=%.5f (%s)"
            % (m, k, n, row["dtype"], plan["route"], plan["splits"], err,
               tols[dtype], row["ms"], row["plain_ms"], row["library_ms"],
               b_ms, b_by))
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


def phase_engine(torch, seed):
    rng = np.random.RandomState(seed + 2)
    params = seeded_params(seed)
    lengths = [17, 900] + sorted(int(n) for n in
                                 rng.randint(18, 900, size=N_PROMPTS - 2))
    prompts = [rng.randint(0, MODEL["vocab_size"], size=n).tolist()
               for n in lengths]
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
            "identical_token_steps": same}


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


def _library_optimizer(torch, kind, w, g, states):
    """One fused PyTorch optimizer step on the same buffer (a timing
    yardstick; its formula differs, its bytes do not)."""
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    if kind == "sgd":
        opt = torch.optim.SGD([p], lr=0.1, momentum=0.9, fused=True)
    else:
        opt = torch.optim.Adam([p], lr=0.01, fused=True)
    opt.step()          # creates the state
    return opt.step


def phase_fused_opt(torch, timer, seed):
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.kernels import fused_opt as fo
    rng = np.random.RandomState(seed + 4)
    shapes = train_param_shapes()
    metas = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    sizes = [sum(int(np.prod(shapes[n])) for n in b)
             for b in fo.plan_buckets(metas)]
    cases = [("sgd", 16 * 1024 * 1024), ("adam", 16 * 1024 * 1024)]
    cases += [("sgd", n) for n in sizes]
    rows = []
    for kind, n in cases:
        opt = opt_mod.create(kind, rescale_grad=1.0 / (TRAIN_BATCH *
                                                        TRAIN["seq_len"]),
                             **(TRAIN_SGD if kind == "sgd" else {}))

        def vec(scale=1.0):
            return torch.from_numpy(
                (rng.randn(n) * scale).astype(np.float32)).to(DEVICE)

        w, g = vec(0.02), vec(1e-3)
        states = [vec(1e-4)] if kind == "sgd" else [vec(1e-4),
                                                    vec(1e-6).abs()]
        lr = opt.lr
        want_w, want_s = fo.sweep_reference(opt, w, g, states, lr, 0.0, 3)
        fo.sweep(opt, w, g, states, lr, 0.0, 3)
        torch.cuda.synchronize()
        errs, ulps = [], []
        for got, want in zip([w] + states, [want_w] + want_s):
            errs.append(float((got - want).abs().max()))
            ulps.append(float(((got - want).abs()
                               / (want.abs() * 2.0 ** -23 + 1e-38)).max()))
        if kind == "sgd" and max(errs) != 0.0:
            raise AssertionError("fused sweep sgd n=%d: not bitwise equal "
                                 "to the plain version (max err %g)"
                                 % (n, max(errs)))
        if kind == "adam" and max(ulps) > 2.0:
            raise AssertionError("fused sweep adam n=%d: %g ulp > 2 from "
                                 "the plain version" % (n, max(ulps)))
        n_bytes = (5 if kind == "sgd" else 7) * 4 * n
        b_ms, b_by = bound_ms(n_bytes, 0)
        lib_step = _library_optimizer(torch, kind, w, g, states)
        row = {"optimizer": kind + ("_momentum" if kind == "sgd" else ""),
               "n": n, "mbytes": 4 * n / 2 ** 20, "max_abs_err": max(errs),
               "max_ulp": max(ulps),
               "tol": "bitwise" if kind == "sgd" else "2 ulp",
               "ms": timer(lambda: fo.sweep(opt, w, g, states, lr, 0.0, 3)),
               "plain_ms": timer(lambda: fo.sweep_reference(
                   opt, w, g, states, lr, 0.0, 3)),
               "library_ms": timer(lib_step),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        rows.append(row)
        log("fused_opt %-12s n=%-9d (%.1f MB) err=%.3g (%.3g ulp) "
            "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
            % (row["optimizer"], n, row["mbytes"], row["max_abs_err"],
               row["max_ulp"], row["ms"], row["plain_ms"], row["library_ms"],
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
        fd_rows = phase_flash_decode(torch, timer, args.seed)
        qmm_rows = phase_quantized_matmul(torch, timer, args.seed)
        eng = phase_engine(torch, args.seed)
        fa_rows = phase_flash_attention(torch, timer, args.seed)
        fo_rows, bucket_sizes = phase_fused_opt(torch, timer, args.seed)
        train = phase_train(torch, args.seed, smi)
        imperative = phase_imperative(torch, args.seed)
        rtc_res = phase_rtc_kernels(
            torch, timer, args.seed)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # one row per kernel: flash-decode at the decode batch of 8 (float32),
    # the int8 matmul at the decode lm_head shape (M=8, K=512, N=8192)
    fd_main = next(r for r in fd_rows if r["B"] == 8
                   and r["dtype"] == "float32" and r["kv_dtype"] == "float32")
    qmm_main = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                    == (8, 512, 8192) and r["dtype"] == "float32")
    # the int8 matmul's prefill row: the wgmma body at the largest prompt
    # bucket (M=960, the lm_head shape, float32 x)
    qmm_prefill = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                       == (960, 512, 8192) and r["dtype"] == "float32")
    launches = {k: eng["float32"]["launches"][k] + eng["int8"]["launches"][k]
                for k in ("flash_decode", "quantized_matmul")}
    launches.update({k: train["float32"]["launches"][k]
                     + train["bfloat16"]["launches"][k]
                     for k in ("flash_attention", "fused_opt")})
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
        if k["name"] == "flash_attention":
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
            k["launches_by_route"] = dict(
                eng["int8"]["quantized_matmul_by_route"])
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
                       "engine": eng, "flash_attention": fa_rows,
                       "fused_opt": fo_rows, "train": train,
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
