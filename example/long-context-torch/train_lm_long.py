"""Long-context LM training: sequence parallelism + per-layer mirroring.

The port of ``example/long-context/train_lm_long.py``.  One decoder-only
transformer trains with the three levers that make long context fit and
scale:

1. **sequence parallelism**: the batch's sequence axis is split over the
   mesh's ``sp`` axis (``ShardedTrainer(seq_axis=1)``); every member
   walks its ``(B/dp, S/sp)`` block and ``MultiHeadAttention`` runs ring
   attention over the sp members: k and v rotate one member a hop
   (peer copies between cards), so no member ever holds the whole
   sequence's scores;
2. **flash attention**: every ring hop is the hand-written flash forward
   (``csrc/flash_attention.cu`` on a card, its plain version on the
   CPU), combined across hops by their logsumexp;
3. **per-layer mirroring**: ``transformer.get_symbol(mirror_blocks=True)``
   tags each layer for recompute, so the backward keeps the
   layer-boundary activations only; on a mesh each layer's segment is
   recomputed on every member in lockstep, its ring included.

The demo asserts, not just runs: the sp step matches a one-device run,
the mirrored walk keeps fewer bytes (``executor.trace_residual_bytes``),
and the loss descends.

Runs on the cards (``--members`` of them, several members a card when
there are fewer cards) or, with ``--cpu``, on contexts ``cpu(0)`` ...
that share the one CPU.  The flash kernel takes head dims 32, 64 and
128, so on a card give ``--dim`` and ``--heads`` with ``dim / heads`` one
of those (the defaults, the JAX example's, have 16).

    python example/long-context-torch/train_lm_long.py --cpu
    python example/long-context-torch/train_lm_long.py --dim 64 --heads 2
"""
import argparse
import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.executor import trace_residual_bytes  # noqa: E402
from mxnet_tpu_torch.models import transformer  # noqa: E402
from mxnet_tpu_torch.parallel import make_mesh  # noqa: E402
from mxnet_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: E402


def build_trainer(mesh, args, seq_axis, mirror):
    sym = transformer.get_symbol(
        vocab_size=args.vocab, num_layers=args.layers,
        num_heads=args.heads, dim=args.dim, seq_len=args.seq,
        mirror_blocks=mirror)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              rescale_grad=1.0 / (args.batch * args.seq))
    return ShardedTrainer(sym, opt, mesh, seq_axis=seq_axis)


def host(x):
    """A trainer's array on the host: a one-device tensor or a mesh's
    ``ShardedArray`` (assembled in the global order)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_steps(tr, args, n_steps):
    mx.random.seed(7)   # init draws from the global stream
    params, opt_state, aux = tr.init_params(
        {"data": (args.batch, args.seq)},
        label_shapes={"softmax_label": (args.batch, args.seq)})
    rs = np.random.RandomState(0)
    toks = rs.randint(0, args.vocab, (args.batch, args.seq))
    batch = tr.shard_batch({
        "data": toks.astype(np.float32),
        "softmax_label": np.roll(toks, -1, axis=1).astype(np.float32),
    })
    losses = []
    lab = np.roll(toks, -1, axis=1).reshape(-1)
    for _ in range(n_steps):
        params, opt_state, aux, outs = tr.step(params, opt_state, aux,
                                               batch)
        # outs[0]: the softmax probabilities, (B*S, V) in the global row
        # order whatever the mesh
        p = host(outs[0]).reshape(args.batch * args.seq, args.vocab)
        losses.append(float(-np.mean(np.log(
            np.maximum(p[np.arange(lab.size), lab], 1e-9)))))
    return losses, params


def members(args):
    """The mesh's contexts: ``--members`` CPU contexts with ``--cpu``;
    else the cards, each taking ``members / cards`` members when there
    are fewer cards than members."""
    if args.cpu:
        return [mx.cpu(i) for i in range(args.members or 4)]
    cards = torch.cuda.device_count()
    n = args.members or max(cards - cards % args.sp, args.sp)
    return [mx.gpu(i * cards // n) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--members", type=int, default=0,
                    help="mesh members (default: 4 with --cpu, else every "
                         "card, at least --sp)")
    ap.add_argument("--cpu", action="store_true",
                    help="members on cpu(0), cpu(1), ... (default: cards)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # float32 products in float32 on a card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False

    devices = members(args)
    n_dev = len(devices)
    sp = args.sp if n_dev % args.sp == 0 else 1
    dp = n_dev // sp
    mesh = make_mesh(devices, dp=dp, sp=sp)
    logging.info("mesh: dp=%d sp=%d seq=%d on %s", dp, sp, args.seq,
                 sorted({str(d) for d in mesh.devices}))

    # sp-split ring-attention run, with per-layer mirroring
    tr = build_trainer(mesh, args, seq_axis=1, mirror=True)
    losses, params = run_steps(tr, args, args.steps)
    assert losses[-1] < losses[0], losses
    logging.info("ring+mirror: loss %.4f -> %.4f", losses[0], losses[-1])

    # cross-check: a one-device (replicated) run must match step for step
    mesh1 = make_mesh(devices[:1], dp=1)
    tr1 = build_trainer(mesh1, args, seq_axis=None, mirror=False)
    losses1, _ = run_steps(tr1, args, 3)
    for a, b in zip(losses[:3], losses1):
        assert abs(a - b) < 2e-3, (losses[:3], losses1)
    logging.info("sp-split losses match one device: %s ~= %s",
                 ["%.4f" % x for x in losses[:3]],
                 ["%.4f" % x for x in losses1])

    # the mirroring story: per-layer mirroring must shrink the residuals
    tr_plain = build_trainer(mesh, args, seq_axis=1, mirror=False)
    dev = mesh.devices[0]
    zeros = {"data": torch.zeros((args.batch, args.seq), device=dev),
             "softmax_label": torch.zeros((args.batch, args.seq),
                                          device=dev)}

    def resid(tr_x):
        mx.random.seed(7)
        p, _s, a = tr_x.init_params(
            {"data": (args.batch, args.seq)},
            label_shapes={"softmax_label": (args.batch, args.seq)})
        full = {k: torch.as_tensor(host(v), device=dev)
                for k, v in p.items()}
        full.update(zeros)
        return trace_residual_bytes(
            tr_x._trace, full, {k: torch.as_tensor(host(v), device=dev)
                                for k, v in a.items()}, tr_x.param_names)

    rp, rm = resid(tr_plain), resid(tr)
    assert rm < rp, (rm, rp)
    logging.info("per-layer mirroring residuals: %d -> %d bytes (-%.0f%%)",
                 rp, rm, 100.0 * (rp - rm) / rp)
    logging.info("long-context demo OK")
    return {"losses": losses, "losses_one_device": losses1,
            "residual_bytes": {"plain": rp, "mirrored": rm},
            "mesh": dict(mesh.shape)}


if __name__ == "__main__":
    main()
