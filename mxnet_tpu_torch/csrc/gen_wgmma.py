#!/usr/bin/env python3
"""Write ``wgmma.cuh``: inline-PTX wrappers of the Hopper ``wgmma``
instructions the port's kernels issue (bfloat16 inputs, float32
accumulators, M = 64, K = 16).

Each ``wgmma.mma_async`` lists every accumulator register as an operand,
so the wrappers are generated rather than written by hand.  Run from the
root of the checkout after changing ``SHAPES``:

    python3 mxnet_tpu_torch/csrc/gen_wgmma.py

(``tests/test_torch_wgmma.py`` checks that the committed header is what
this script writes.)
"""
import os

#: (form, N, transpose-B) of every instruction used:
#: "ss" takes A and B from shared memory, "rs" A from registers
SHAPES = [
    ("ss", 64, 0), ("ss", 128, 0),                 # flash: S = q k^T
    ("rs", 32, 1), ("rs", 64, 1), ("rs", 128, 1),  # flash: O += p v
    ("rs", 64, 0), ("rs", 240, 0),                 # int8 matmul: y^T tiles
]

HEADER = """\
// Generated by mxnet_tpu_torch/csrc/gen_wgmma.py -- do not edit by hand.
//
// wgmma.mma_async m64nNk16, bfloat16 inputs, float32 accumulators d (N/2
// registers a thread, the layout of the PTX ISA's "wgmma D fragment").
// scale_d = 0 overwrites d, 1 accumulates.  Overloads by the size of d:
//   wgmma_ss(d, desc_a, desc_b, scale_d)         A and B in shared memory,
//                                                 both K-major
//   wgmma_rs(d, a, desc_b, scale_d)              A from registers (4 x 32
//                                                 bits: 8 bfloat16), B K-major
//   wgmma_rs_bt(d, a, desc_b, scale_d)           the same, B MN-major
// The caller brackets them with wgmma_fence / wgmma_commit / wgmma_wait
// (hopper.cuh).
#pragma once
#include <stdint.h>

namespace mxtt {
"""


def wrapper(form, n, tb):
    nd = n // 2
    regs = ", ".join("%%%d" % i for i in range(nd))
    outs = ", ".join('"+f"(d[%d])' % i for i in range(nd))
    if form == "ss":
        name, a_decl = "wgmma_ss", "uint64_t desc_a"
        a_ops, ins = "%%%d" % nd, '"l"(desc_a)'
        nxt = nd + 1
        tail = "p, 1, 1, 0, %d" % tb
    else:
        name = "wgmma_rs_bt" if tb else "wgmma_rs"
        a_decl = "const uint32_t (&a)[4]"
        a_ops = "{%s}" % ", ".join("%%%d" % (nd + i) for i in range(4))
        ins = ", ".join('"r"(a[%d])' % i for i in range(4))
        nxt = nd + 4
        tail = "p, 1, 1, %d" % tb
    return (
        "__device__ __forceinline__ void %s(float (&d)[%d], %s,\n"
        "    uint64_t desc_b, int scale_d) {\n"
        "  asm volatile(\n"
        "      \"{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n\"\n"
        "      \"wgmma.mma_async.sync.aligned.m64n%dk16.f32.bf16.bf16 \"\n"
        "      \"{%s}, %s, %%%d, %s;\\n}\\n\"\n"
        "      : %s\n"
        "      : %s, \"l\"(desc_b), \"r\"(scale_d));\n"
        "}\n" % (name, nd, a_decl, nxt + 1, n, regs, a_ops, nxt, tail,
                 outs, ins))


def render():
    body = "\n".join(wrapper(*s) for s in SHAPES)
    return HEADER + "\n" + body + "\n}  // namespace mxtt\n"


def main():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wgmma.cuh")
    with open(path, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
