#!/usr/bin/env python3
"""Where the time of Inception-BN's training step goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 example/image-classification-torch/profile_inception_bn.py \
        [--seed N] [--steps N] [--dtype both|float32|bfloat16] [--out F]

``tools/profile_train_torch.py``'s profile (the step time untraced and
traced, the device time of every kernel summed by group, the device
busy share, the ten kernels with the most device time) of
``chip_smoke.py`` phase 12's main path: Inception-BN at 224 x 224,
batch 64, 1000 classes, SGD with momentum, seeded numpy weights,
``MXTPU_FUSED_OPT=kernel``, through ``ShardedTrainer``.  Imports neither
JAX nor ``mxnet_tpu``.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build_inception_bn(torch, seed, compute_dtype):
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import params_from_numpy
    sym = cs.zoo_symbol("inception_bn")
    params, aux, batch = cs.seeded_zoo(sym, cs.ZOO_BATCH, cs.ZOO_SIZE,
                                       seed + 29)
    opt = mx.optimizer.create("sgd", rescale_grad=1.0 / cs.ZOO_BATCH,
                              **cs.RESNET_SGD)
    tr = mx.parallel.ShardedTrainer(sym, opt, ctx=torch.device("cuda"),
                                    compute_dtype=compute_dtype)
    p, a = params_from_numpy(params, aux, ctx=torch.device("cuda"))
    return tr, opt, p, a, batch


def main(argv=None):
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import profile_train_torch as ptt
    ptt.MODELS["inception-bn"] = _build_inception_bn
    argv = list(sys.argv[1:] if argv is None else argv)
    return ptt.main(["--model", "inception-bn"] + argv)


if __name__ == "__main__":
    sys.exit(main())
