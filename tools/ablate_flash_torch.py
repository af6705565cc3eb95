#!/usr/bin/env python3
"""What bounds the port's flash-attention forward bodies, by ablation.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/ablate_flash_torch.py [--tree DIR] [--dtype both]
        [--iters N] [--out results.json]

It copies ``mxnet_tpu_torch/csrc/flash_attention.cu`` of the checkout
``--tree`` (this one by default; an older commit unpacked with ``git
archive`` works too) and the headers beside it into
``build/ablate_flash/``, removes one part of a body in each copy, builds
each with the port's ``nvcc`` flags, and times every copy against the
body itself (an unmodified copy, checked against the plain version) and
``F.scaled_dot_product_attention`` at the training shape (B=8, H=8,
S=1024, D=64, causal and not), with the L2 flushed before each launch as
``chip_smoke.py`` does.  The copies compute wrong results on purpose.

bfloat16 (the ``wgmma`` body):

- ``no_pv``: no ``O += p v`` products (the tensor work of S only);
- ``no_softmax``: p is the raw score tile (no exponentials, no maxima);
- ``loads_only``: neither products nor softmax: what is left is the TMA
  ring, the barriers and the epilogue;
- ``no_turns``: the two consumer warpgroups issue without taking turns.

float32 (the FMA body; the copies match the body the tree has, the
earlier ``flash_forward_kernel`` with synchronous loads or the
``cp.async`` ``flash_forward_fma``):

- ``f32_no_loads``: the first k/v tile is reused for every tile (no
  copies from device memory after it);
- ``f32_no_softmax``: p is the raw score tile (no masks, maxima,
  exponentials or rescaling);
- ``f32_no_pv``: no ``O += p v`` products (nor, in ``flash_forward_fma``,
  the exchange of p that feeds them);
- ``f32_no_exchange`` (``flash_forward_fma`` only): each lane takes p
  from its own registers instead of through shared memory from its row
  group;
- ``f32_no_half`` (``flash_forward_fma`` only): the causal tiles past a
  q tile's first 64 rows compute those rows too;
- ``f32_persistent_1x``, ``f32_persistent_2x`` (``flash_forward_fma``
  only): not a removal but another grid, one or two CTAs an SM, each CTA
  walking every gridDim.x-th work item in the body's order instead of one
  CTA an item.  These two compute the right result and are checked
  against the plain version as the body is.

A copy that runs about as long as the body shows that what it removed
is not what bounds the body.  Imports neither JAX nor ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_SCORES = "issue_scores<D>(S, q_addr, k_base + stage * C::T_BYTES);"
_PV = "issue_pv<D>(O, ph, pl, v_base + prev * C::T_BYTES);"
_NOP = ("template <int NS>\n__device__ __forceinline__ void softmax_nop("
        "float (&)[NS], bool, int, int, int, int, int, int, float, float&, "
        "float&, float&, float&, float& c_a, float& c_b) { c_a = c_b = 1.f; }"
        "\n\n")
_NO_SOFTMAX = [("// p as wgmma A fragments", _NOP + "// p as wgmma A fragments"),
               ("    softmax_tile(S, C::BK > Sk", "    softmax_nop(S, C::BK > Sk"),
               ("      softmax_tile(S, k0 + C::BK", "      softmax_nop(S, k0 + C::BK")]
ABLATIONS = {
    "no_pv": [(_PV, ";")],
    "no_softmax": _NO_SOFTMAX,
    "loads_only": [(_SCORES, ";"), (_PV, ";")] + _NO_SOFTMAX,
    "no_turns": [("mxtt::named_sync(my_turn, 256);", ";"),
                 ("    mxtt::named_arrive(other_turn, 256);", ";"),
                 ("if (wg == 1) mxtt::named_arrive(1, 256);", ";"),
                 ("if (wg == 0 || !last_item) "
                  "mxtt::named_arrive(other_turn, 256);", ";")],
}

#: float32 copies of the synchronous-load body (flash_forward_kernel).  A (start, end,
#: None) triple cuts the source from start up to, not including, end.
F32_ABLATIONS_SYNC = {
    "f32_no_loads": [("    for (int e = tid; e < kBK * D; e += kThreads) {\n"
                      "      const int c = e / D",
                      "    if (j == 0) for (int e = tid; e < kBK * D; "
                      "e += kThreads) {\n      const int c = e / D")],
    "f32_no_softmax": [("    // online softmax over the tile, row by row\n",
                        "#pragma unroll\n    for (int c = 0; c < 8; ++c) {\n"
                        "      const int col = (c >> 2) * 32", None)],
    "f32_no_pv": [("            acc[i][g * 4 + u] = fmaf(pv[i], wv[u], "
                   "acc[i][g * 4 + u]);", ";")],
}
#: float32 copies of the cp.async body (flash_forward_fma)
F32_ABLATIONS_FMA = {
    "f32_no_loads": [("    const int st = j & 1;",
                      "    const int st = 0;"),
                     ("    if (j + 1 < n_tiles)\n      load_kv_tile",
                      "    if (false)\n      load_kv_tile")],
    "f32_no_softmax": [("    // online softmax in the log2 domain",
                        "    // o += p v", None)],
    "f32_no_pv": [("pv_tile<D, RM / 2>(acc, s, pw, vt, ty & 3, tx);", ";"),
                  ("pv_tile<D, 0>(acc, s, pw, vt, ty & 3, tx);", ";")],
    "f32_no_exchange": [
        ("      for (int jp = 0; jp < JP; ++jp) pw[(tl + 4 * i) * C::PLD "
         "+ 8 * jp + tx] = s[i][JP * h + jp];", "      ;"),
        ("        p4[i] = *reinterpret_cast<const float4*>(pw + (tl + 4 * i) "
         "* C::PLD + kc);",
         "        p4[i] = make_float4(s[i][kc / 4], s[i][kc / 4 + 1], "
         "s[i][kc / 4 + 2], s[i][kc / 4 + 3]);")],
    "f32_no_half": [("const bool half = RM == 8 && causal && k0 >= q0 + 64;",
                     "const bool half = false;")],
}


def _persistent(per_sm):
    """flash_forward_fma on a grid of ``per_sm`` CTAs an SM, each CTA
    walking items blockIdx.x, blockIdx.x + gridDim.x, ..."""
    return [
        ("  const int t = blockIdx.x;\n",
         "  for (int t = blockIdx.x; t < BH * n_qtiles; t += gridDim.x) {\n"
         "  __syncthreads();  // the last item's q and stages are read\n"),
        ("    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] * kLn2 + "
         "logf(ls);\n  }\n}\n",
         "    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] * kLn2 + "
         "logf(ls);\n  }\n  }\n}\n"),
        ("  flash_forward_fma<D><<<(int)items, C::THREADS",
         "  int sms = 0;\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
         "  const long long ctas = %dLL * sms;\n"
         "  flash_forward_fma<D><<<(int)(items < ctas ? items : ctas), "
         "C::THREADS" % per_sm)]


F32_ABLATIONS_FMA.update(f32_persistent_1x=_persistent(1),
                         f32_persistent_2x=_persistent(2))
#: copies that compute the body's result, checked against the plain version
EXACT = ("body", "f32_persistent_1x", "f32_persistent_2x")


def _edit(src, name, subs):
    for old, new, *cut in subs:
        if old not in src:
            raise RuntimeError("ablation %s: %r not in the source" % (name, old))
        if cut:
            a = src.index(old)
            b = src.index(new, a)
            src = src[:a] + src[b:]
        else:
            src = src.replace(old, new)
    return src


def build_copies(tree, copies):
    """Build flash_attention.cu of ``tree`` once for each (name, subs) of
    ``copies``, one ``nvcc`` each, all started together.  Returns
    {name: library}."""
    from mxnet_tpu_torch.kernels import _build
    csrc = os.path.join(tree, "mxnet_tpu_torch", "csrc")
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        original = f.read()
    procs = {}
    for name, subs in copies:
        out_dir = os.path.join(HERE, "build", "ablate_flash", name)
        os.makedirs(out_dir, exist_ok=True)
        for fn in os.listdir(csrc):
            if fn.endswith(".cuh"):
                with open(os.path.join(csrc, fn)) as f, \
                        open(os.path.join(out_dir, fn), "w") as g:
                    g.write(f.read())
        src = _edit(original, name, subs)
        cu = os.path.join(out_dir, "flash_attention.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib_path = os.path.join(out_dir, "flash_attention.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc()] + _build._NVCC_FLAGS + ["-o", lib_path, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib_path)
    libs = {}
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, lib_path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("ablation %s did not build:\n%s" % (name, out))
        lib = ctypes.CDLL(lib_path)
        lib.mxtt_flash_attention_forward.argtypes = [
            i, vp, vp, vp, vp, vp, i, i, i, i, i, f, vp]
        lib.mxtt_flash_attention_forward.restype = i
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose csrc/flash_attention.cu is ablated")
    ap.add_argument("--dtype", choices=("both", "bfloat16", "float32"),
                    default="both")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ablate_flash_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from mxnet_tpu_torch.kernels import flash_attention as fa
    tree = os.path.abspath(args.tree)
    with open(os.path.join(tree, "mxnet_tpu_torch", "csrc",
                           "flash_attention.cu")) as f:
        fma_body = "flash_forward_fma" in f.read()
    timer = chip_smoke.Timer(torch, args.iters, chip_smoke.LEAD_CYCLES)
    smi = chip_smoke.nvidia_smi_line()
    B, H, S, D = 8, 8, 1024, 64
    rng = np.random.RandomState(args.seed)
    dtypes = {"both": (torch.bfloat16, torch.float32),
              "bfloat16": (torch.bfloat16,),
              "float32": (torch.float32,)}[args.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype in dtypes:
        name = str(dtype).replace("torch.", "")
        q, k, v = [torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
                   .to("cuda", dtype) for _ in range(3)]
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        if dtype == torch.bfloat16:
            copies = dict(ABLATIONS)
        else:
            copies = dict(F32_ABLATIONS_FMA if fma_body
                          else F32_ABLATIONS_SYNC)
        built = build_copies(tree, [("%s_%s" % (name, c), subs) for c, subs
                                    in [("body", [])] + list(copies.items())])
        libs = {c: built["%s_%s" % (name, c)]
                for c in ["body"] + list(copies)}

        def run(lib, causal):
            code = lib.mxtt_flash_attention_forward(
                0 if dtype == torch.float32 else 1, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B * H, S, S, D, int(causal), 1.0 / np.sqrt(D), stream)
            if code != 0:
                raise RuntimeError("launch failed: CUDA error %d" % code)

        for causal in (True, False):
            want, want_lse = fa.flash_attention_forward_reference(
                q, k, v, causal=causal)
            for c in (c for c in EXACT if c in libs):
                o.zero_()
                run(libs[c], causal)
                torch.cuda.synchronize()
                d = (o.float() - want.float()).abs()
                if dtype == torch.float32:
                    ok = float(d.max()) <= 2e-5
                else:
                    ok = bool((d <= want.float().abs() * 2.0 ** -7
                               + 1e-5).all())
                if not ok or float((lse - want_lse).abs().max()) > 1e-4:
                    raise AssertionError("the %s %s of %s is off the plain "
                                         "version" % (name, c, tree))
            row = {"dtype": name, "causal": causal, "tree": tree,
                   "body": ("flash_forward_fma" if fma_body
                            else "flash_forward_kernel")
                   if dtype == torch.float32 else "flash_forward_wgmma",
                   "kernel_ms": timer(lambda: run(libs["body"], causal)),
                   "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal))}
            for c in copies:
                row[c + "_ms"] = timer(lambda: run(libs[c], causal))
            rows.append(row)
            print("flash %s B=8 H=8 S=1024 D=64 causal=%-5s %s"
                  % (name, causal, ", ".join(
                      "%s %.4f" % (key, val) for key, val in row.items()
                      if key.endswith("_ms"))), flush=True)
        del q, k, v, o, lse
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
