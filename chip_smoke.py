#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--iters N] [--out results.json]

It imports nothing of JAX or of the JAX package ``mxnet_tpu``.  Phases,
in order; any failure ends the run with a non-zero exit and no result
line:

1. the device, ``nvidia-smi``'s name and power limit, and the build of
   every CUDA kernel of the slice from ``mxnet_tpu_torch/csrc``;
2. flash-decode, kernel vs its plain PyTorch version, on the card, at the
   slice's shapes (B in {1, 8}, H=8, D=64, 32-token blocks, a 256-block
   pool, 32 table slots), in float32 and bfloat16, with times of the
   kernel, the plain version, ``F.scaled_dot_product_attention`` on the
   gathered cache (a yardstick only) and the bandwidth bound;
3. the int8 weight-only matmul, kernel vs plain, at M in {1, 8, 240, 960}
   and the three (K, N) of the model, with the same four times
   (``torch.matmul`` against the dequantized float32 weight is the
   yardstick);
4. the slice end to end at full width: ``GenerationEngine(ctx=gpu(0))``
   for the transformer LM the repo benchmarks (vocab 8192, 8 layers, 8
   heads, dim 512, max_seq_len 1024, seeded random weights) generates 64
   tokens for 8 prompts of 17 to 900 tokens, in float32 and then with
   ``quantize="int8"``.  It checks that both kernels ran on that path
   (launch counts reset just before each run), that the float32 logits
   agree with a plain full-sequence forward written here, and that the
   int8 logits keep a cosine >= 0.999 against float32 at every step.

It exits 2 when CUDA is unavailable or when the package is not beside
this script.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is ``nvidia-smi``'s
name and power limit, and the one before that the per-kernel JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s
#: and float32 FMA-pipe operations/s (no tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: where every tensor of the run lives (a CPU rehearsal of the control
#: flow may set "cpu"; the kernels then take their plain versions)
DEVICE = "cuda"

MODEL = dict(vocab_size=8192, num_layers=8, num_heads=8, dim=512,
             max_seq_len=1024, ffn_mult=4)
N_PROMPTS = 8
MAX_NEW = 64


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

    def __init__(self, torch, iters):
        self.torch = torch
        self.iters = iters
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
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ----------------------------------------------------------------------
# phase 2: flash-decode
# ----------------------------------------------------------------------
def flash_decode_case(torch, rng, B, dtype, NB=256, BS=32, H=8, D=64, MB=32):
    """Mixed positions (0, 31, 32, 1023 among them), each row's live
    blocks distinct random pool blocks, trailing slots on trash block 0;
    the whole pool (block 0 included) holds random values."""
    pos = np.array([0, 31, 32, 1023, 17, 300, 640, 900][:B] if B > 1
                   else [700], np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        n = int(pos[b]) // BS + 1
        table[b, :n] = [free.pop() for _ in range(n)]
    dev = DEVICE
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(NB, BS, H, D).astype(np.float32))
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


def phase_flash_decode(torch, timer, seed):
    import torch.nn.functional as F
    from mxnet_tpu_torch.kernels import flash_decode as fd
    rows = []
    rng = np.random.RandomState(seed)
    #: float32: same arithmetic, other summation order; bfloat16: the
    #: plain version rounds scores and probabilities to bfloat16
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for B in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, pos = flash_decode_case(torch, rng, B, dtype)
            H, D = q.shape[1], q.shape[2]
            BS, MB = k.shape[1], table.shape[1]
            scale = 1.0 / math.sqrt(D)
            got = fd.flash_decode_attention(q, k, v, table, pos, scale=scale)
            want = fd.decode_attention_reference(q, k, v, table, pos,
                                                 scale=scale)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not err <= tols[dtype]:
                raise AssertionError(
                    "flash_decode B=%d %s: max |kernel - plain| = %g > %g"
                    % (B, dtype, err, tols[dtype]))
            # yardstick: SDPA on the gathered cache (gather not timed)
            kk = k[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
            vv = v[table.long()].reshape(B, MB * BS, H, D).transpose(1, 2)
            kk, vv = kk.contiguous(), vv.contiguous()
            mask = (torch.arange(MB * BS, device=DEVICE)[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask,
                                                 scale=scale)[:, :, 0]
            lib_err = float((lib.float() - want.float()).abs().max())
            n_tok = int((pos.long() + 1).sum())
            item = q.element_size()
            n_bytes = (2 * n_tok * H * D * item + 2 * q.numel() * item
                       + table.numel() * 4 + pos.numel() * 4)
            b_ms, b_by = bound_ms(n_bytes, 4 * n_tok * H * D)
            row = {
                "B": B, "dtype": str(dtype).replace("torch.", ""),
                "pos": pos.tolist(), "max_abs_err": err, "tol": tols[dtype],
                "library_max_abs_err": lib_err,
                "ms": timer(lambda: fd.flash_decode_attention(
                    q, k, v, table, pos, scale=scale)),
                "plain_ms": timer(lambda: fd.decode_attention_reference(
                    q, k, v, table, pos, scale=scale)),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    q4, kk, vv, attn_mask=mask, scale=scale)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
            rows.append(row)
            log("flash_decode B=%d %-8s err=%.3g (tol %g) kernel_ms=%.4f "
                "plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
                % (B, row["dtype"], err, tols[dtype], row["ms"],
                   row["plain_ms"], row["library_ms"], b_ms, b_by))
    return rows


# ----------------------------------------------------------------------
# phase 3: int8 weight-only matmul
# ----------------------------------------------------------------------
def phase_quantized_matmul(torch, timer, seed):
    from mxnet_tpu_torch.kernels import quantize as qz
    rng = np.random.RandomState(seed + 1)
    rows = []
    #: float32 sums over K <= 2048 in another order; bfloat16 output
    #: rounding (8 mantissa bits) of values of order 1
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = [(m, k, n, torch.float32) for m in (1, 8, 240, 960)
             for k, n in ((512, 2048), (2048, 512), (512, 8192))]
    cases.append((8, 512, 8192, torch.bfloat16))
    for m, k, n, dtype in cases:
        q, scale = qz.quantize_array(
            (rng.randn(n, k) * 0.02).astype(np.float32))
        x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
            DEVICE, dtype)
        wq = torch.from_numpy(q).to(DEVICE)
        sc = torch.from_numpy(scale).to(DEVICE)
        got = qz.quantized_matmul(x, wq, sc)
        want = qz.quantized_matmul_reference(x, wq, sc)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= tols[dtype]:
            raise AssertionError(
                "quantized_matmul M=%d K=%d N=%d %s: max |kernel - plain| "
                "= %g > %g" % (m, k, n, dtype, err, tols[dtype]))
        w_deq = (wq.float() * sc[:, None]).to(dtype)
        n_bytes = (m * k * x.element_size() + n * k + n * 4
                   + m * n * x.element_size())
        b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k)
        row = {"M": m, "K": k, "N": n,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tols[dtype],
               "ms": timer(lambda: qz.quantized_matmul(x, wq, sc)),
               "plain_ms": timer(lambda: qz.quantized_matmul_reference(
                   x, wq, sc)),
               "library_ms": timer(lambda: torch.matmul(x, w_deq.t())),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": 2 * m * n * k}
        rows.append(row)
        log("quantized_matmul M=%-4d K=%-4d N=%-4d %-8s err=%.3g (tol %g) "
            "kernel_ms=%.4f plain_ms=%.4f library_ms=%.4f bound_ms=%.5f (%s)"
            % (m, k, n, row["dtype"], err, tols[dtype], row["ms"],
               row["plain_ms"], row["library_ms"], b_ms, b_by))
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
                        "quantized_matmul": qz.quantized_matmul.launches}}
    log("engine %-7s buckets prompt=%s decode=%s: prefill %.3f ms/prompt, "
        "decode %.3f ms/step over %d steps, %.1f tokens/s, launches %s"
        % (res["quantize"], res["prompt_buckets"], res["decode_buckets"],
           res["prefill_ms_per_prompt"], res["decode_ms_per_step"],
           res["decode_steps"], res["tokens_per_s"], res["launches"]))
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
            for line in i["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log("  ptxas %s: %s" % (name, line.strip()))
        torch.manual_seed(args.seed)
        timer = Timer(torch, args.iters)
        fd_rows = phase_flash_decode(torch, timer, args.seed)
        qmm_rows = phase_quantized_matmul(torch, timer, args.seed)
        eng = phase_engine(torch, args.seed)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    # one row per kernel: flash-decode at the decode batch of 8 (float32),
    # the int8 matmul at the decode lm_head shape (M=8, K=512, N=8192)
    fd_main = next(r for r in fd_rows if r["B"] == 8
                   and r["dtype"] == "float32")
    qmm_main = next(r for r in qmm_rows if (r["M"], r["K"], r["N"])
                    == (8, 512, 8192) and r["dtype"] == "float32")
    launches = {k: eng["float32"]["launches"][k] + eng["int8"]["launches"][k]
                for k in ("flash_decode", "quantized_matmul")}
    kernels = []
    for name, src, repl, main_row, rows in (
            ("flash_decode", "mxnet_tpu_torch/csrc/flash_decode.cu",
             "mxnet_tpu/kernels/flash_decode.py:100", fd_main, fd_rows),
            ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
             "mxnet_tpu/kernels/quantize.py:230", qmm_main, qmm_rows)):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "float32"),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": {k: main_row[k] for k in ("B", "M", "K", "N", "dtype")
                      if k in main_row}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "build": {n: i["seconds"] for n, i in info.items()},
                       "flash_decode": fd_rows, "quantized_matmul": qmm_rows,
                       "engine": eng, "kernels": kernels}, f, indent=1)
    log("kernels: flash_decode, quantized_matmul")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
