#!/usr/bin/env python3
"""What bounds the port's bfloat16 flash-attention forward, by ablation.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/ablate_flash_torch.py [--iters N] [--out results.json]

It copies ``mxnet_tpu_torch/csrc/flash_attention.cu`` (and the headers
it includes) into ``build/ablate_flash/``, removes one part of the
tensor-core body in each copy, builds each with the same ``nvcc`` flags
as the port, and times every copy against the kernel itself and
``F.scaled_dot_product_attention`` at the training shape (B=8, H=8,
S=1024, D=64, bfloat16, causal and not), with the L2 flushed before each
launch as ``chip_smoke.py`` does.  The copies compute wrong results on
purpose; only the kernel itself is checked (one bfloat16 ulp of the
plain version).  Copies:

- ``no_pv``: no ``O += p v`` products (the tensor work of S only);
- ``no_softmax``: p is the raw score tile (no exponentials, no maxima);
- ``loads_only``: neither products nor softmax: what is left is the TMA
  ring, the barriers and the epilogue;
- ``no_turns``: the two consumer warpgroups issue without taking turns.

A copy that runs about as long as the kernel shows that what it removed
is not what bounds the kernel.  Imports neither JAX nor ``mxnet_tpu``.
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


def build_copy(name, subs):
    from mxnet_tpu_torch.kernels import _build
    csrc = os.path.join(HERE, "mxnet_tpu_torch", "csrc")
    out_dir = os.path.join(HERE, "build", "ablate_flash", name)
    os.makedirs(out_dir, exist_ok=True)
    for fn in os.listdir(csrc):
        if fn.endswith(".cuh"):
            with open(os.path.join(csrc, fn)) as f, \
                    open(os.path.join(out_dir, fn), "w") as g:
                g.write(f.read())
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError("ablation %s: %r not in the source" % (name, old))
        src = src.replace(old, new)
    cu = os.path.join(out_dir, "flash_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib_path = os.path.join(out_dir, "flash_attention.so")
    proc = subprocess.run([_build._nvcc()] + _build._NVCC_FLAGS
                          + ["-o", lib_path, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("ablation %s did not build:\n%s"
                           % (name, proc.stdout + proc.stderr))
    lib = ctypes.CDLL(lib_path)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mxtt_flash_attention_forward.argtypes = [i, vp, vp, vp, vp, vp, i, i,
                                                 i, i, i, f, vp]
    lib.mxtt_flash_attention_forward.restype = i
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ablate_flash_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mxnet_tpu_torch.kernels import flash_attention as fa
    timer = chip_smoke.Timer(torch, args.iters, chip_smoke.LEAD_CYCLES)
    smi = chip_smoke.nvidia_smi_line()
    B, H, S, D = 8, 8, 1024, 64
    rng = np.random.RandomState(args.seed)
    q, k, v = [torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")

    def run(lib, causal):
        code = lib.mxtt_flash_attention_forward(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, S, S, D, int(causal), 1.0 / np.sqrt(D),
            stream)
        if code != 0:
            raise RuntimeError("launch failed: CUDA error %d" % code)

    rows = []
    for causal in (True, False):
        got, _l = fa.flash_attention_forward(q, k, v, causal=causal)
        want, _l = fa.flash_attention_forward_reference(q, k, v,
                                                        causal=causal)
        d = (got.float() - want.float()).abs()
        if not bool((d <= want.float().abs() * 2.0 ** -7 + 1e-5).all()):
            raise AssertionError("the kernel is not within one bfloat16 ulp")
        row = {"causal": causal,
               "kernel_ms": timer(lambda: fa.flash_attention_forward(
                   q, k, v, causal=causal)),
               "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal))}
        rows.append(row)
    for name, subs in ABLATIONS.items():
        lib = build_copy(name, subs)
        for row in rows:
            row[name + "_ms"] = timer(lambda: run(lib, row["causal"]))
    for row in rows:
        print("flash bfloat16 B=8 H=8 S=1024 D=64 causal=%-5s %s"
              % (row["causal"], ", ".join(
                  "%s %.4f" % (k, v) for k, v in row.items()
                  if k.endswith("_ms"))))
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
