"""Shared harness for the image-classification examples, on the PyTorch/CUDA
port (``mxnet_tpu_torch``).

The copy of ``example/image-classification/common.py`` that differs only
in the import line, in the synthetic set's seeded shuffle and
``--deterministic``, and in ``--devices`` defaulting to ``gpu(0)`` (in a
``dist_*`` kvstore's worker, ``gpu(rank)``: one process a card, as
``tools/launch.py -n N`` starts them).  ``--devices gpu:0,1,2,3`` trains
on several cards of one process (the Module's sharded executor; with
``--kvstore device`` the gradients are summed inside the step).
Parity: example/image-classification/train_model.py + find_mxnet.py in the
reference — argument conventions (--network, --batch-size, --lr, --kvstore,
--gpus -> --devices, --model-prefix, --num-epochs) are kept so reference
users can port invocation lines unchanged.

Data: tries the real dataset first (MNIST idx files / RecordIO), else
falls back to a deterministic synthetic set so every example is runnable
in a hermetic environment.
"""
import argparse
import logging
import os

import numpy as np

import mxnet_tpu_torch as mx


def add_common_args(parser):
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--lr-factor", type=float, default=1.0)
    parser.add_argument("--lr-factor-epoch", type=float, default=1.0)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=1e-4)
    parser.add_argument("--kvstore", type=str, default="local",
                        help="local|device|dist_sync|dist_async")
    parser.add_argument("--devices", type=str, default="",
                        help="e.g. 'gpu:0' or 'cpu'; default: gpu(0)")
    parser.add_argument("--model-prefix", type=str, default=None)
    parser.add_argument("--load-epoch", type=int, default=None)
    parser.add_argument("--log-level", type=str, default="INFO")
    parser.add_argument("--synthetic", action="store_true",
                        help="force synthetic data")
    parser.add_argument("--deterministic", action="store_true",
                        help="cuDNN's deterministic algorithms: two runs "
                        "of one seed give the same weights bit for bit")
    return parser


def parse_devices(spec, kv=None):
    if not spec:
        if kv is not None and kv.type.startswith("dist"):
            return [mx.gpu(kv.rank)]
        return [mx.gpu(0)]
    devs = []
    for tok in spec.split(","):
        tok = tok.strip()
        if ":" in tok:
            kind, idx = tok.split(":")
            devs.append(getattr(mx, kind)(int(idx)))
        else:
            devs.append(getattr(mx, tok)())
    return devs


def synthetic_iters(data_shape, num_classes, batch_size, train_n=1024,
                    val_n=256, seed=0, part=0):
    """Deterministic class-separable gaussian blobs shaped like images;
    ``part`` draws another worker's samples of the same classes."""
    rng = np.random.RandomState(seed)
    protos = rng.uniform(-1, 1, (num_classes,) + data_shape)

    def make(n, seed2):
        r2 = np.random.RandomState(seed2)
        y = r2.randint(0, num_classes, n)
        x = protos[y] + 0.3 * r2.randn(n, *data_shape)
        return x.astype(np.float32), y.astype(np.float32)

    Xt, yt = make(train_n, seed + 1 + 1000 * part)
    Xv, yv = make(val_n, seed + 2 + 1000 * part)
    # a seeded shuffle: two runs of one seed see the same batches
    train = mx.io.NDArrayIter(Xt, yt, batch_size=batch_size, shuffle=True,
                              seed=seed + 3 + 1000 * part)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=batch_size)
    return train, val


def mnist_iters(batch_size, data_dir="data/mnist", flat=False,
                synthetic=False):
    shape = (784,) if flat else (1, 28, 28)
    paths = [os.path.join(data_dir, f) for f in
             ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
    if not synthetic and all(os.path.exists(p) for p in paths):
        train = mx.io.MNISTIter(image=paths[0], label=paths[1],
                                batch_size=batch_size, shuffle=True,
                                flat=flat)
        val = mx.io.MNISTIter(image=paths[2], label=paths[3],
                              batch_size=batch_size, flat=flat)
        return train, val
    logging.info("MNIST files not found under %s — using synthetic data "
                 "(pass --synthetic to silence)", data_dir)
    return synthetic_iters(shape, 10, batch_size)


def fit(args, net, train, val, data_names=("data",),
        batches_per_checkpoint=None):
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(levelname)s %(message)s")
    if getattr(args, "deterministic", False):
        import torch
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    # kvstore FIRST, as in the JAX package: a dist_* store joins the
    # launch's process group before any device work
    kv = mx.kvstore.create(args.kvstore)
    devs = parse_devices(args.devices, kv)
    if kv.type.startswith("dist"):
        import torch.distributed as dist
        logging.info("kvstore %s: worker %d of %d on %s, torch.distributed "
                     "backend %s", kv.type, kv.rank, kv.num_workers, devs,
                     dist.get_backend() if dist.is_initialized() else None)

    lr_scheduler = None
    if args.lr_factor < 1.0:
        epoch_size = max(train.num_data // args.batch_size, 1) \
            if hasattr(train, "num_data") else 100
        step = max(int(epoch_size * args.lr_factor_epoch), 1)
        lr_scheduler = mx.lr_scheduler.FactorScheduler(
            step=step, factor=args.lr_factor)

    mod = mx.mod.Module(net, context=devs, data_names=list(data_names))
    arg_params = aux_params = None
    begin_epoch = 0
    if args.model_prefix and args.load_epoch is not None:
        _, arg_params, aux_params = mx.model.load_checkpoint(
            args.model_prefix, args.load_epoch)
        begin_epoch = args.load_epoch

    epoch_cb = None
    if args.model_prefix:
        epoch_cb = mx.callback.do_checkpoint(
            args.model_prefix if kv.rank == 0
            else "%s-%d" % (args.model_prefix, kv.rank))

    mod.fit(train, eval_data=val,
            eval_metric="acc",
            kvstore=kv,
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.momentum, "wd": args.wd,
                              "lr_scheduler": lr_scheduler},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            arg_params=arg_params, aux_params=aux_params,
            begin_epoch=begin_epoch, num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 50),
            epoch_end_callback=epoch_cb)
    return mod
