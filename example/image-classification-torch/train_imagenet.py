"""Train ResNet-50 / Inception-BN / AlexNet / VGG on ImageNet, on the
PyTorch/CUDA port (``mxnet_tpu_torch``), on one GPU or several.

The copy of ``example/image-classification/train_imagenet.py`` that
differs only in the import line (and, through ``common.py``, in
``--devices`` defaulting to ``gpu(0)``).  ``--data-dir`` holds
``train.rec`` (and ``val.rec``), e.g. from ``python -m
mxnet_tpu_torch.tools.im2rec --pack-raw 3 224 224``; ``--data-dtype
uint8`` ships raw pixels, widened to float32 on the GPU;
``MXTPU_PREFETCH=1`` turns on ``Module.fit``'s async device feed, and
``MXNET_BACKWARD_DO_MIRROR=1`` recomputes the BatchNorm, ReLU and
pooling outputs in the backward instead of keeping them.  Every network
of ``NETS`` runs (Inception-v3 at 299 x 299, the others at 224 x 224).
``--devices gpu:0,1,2,3 --kvstore device`` trains on four cards of one
process; ``python tools/launch.py -n 4 python
example/image-classification-torch/train_imagenet.py --kvstore dist_sync``
starts four worker processes, one a card (``gpu(rank)``), each reading
its part of the records (``num_parts``/``part_index`` from the store;
with ``--synthetic``, samples drawn for its rank).
"""
import argparse
import logging
import os

import mxnet_tpu_torch as mx
import common


NETS = {
    "resnet-50": lambda n: mx.models.resnet.get_symbol(n, num_layers=50),
    "resnet-101": lambda n: mx.models.resnet.get_symbol(n, num_layers=101),
    "inception-bn": lambda n: mx.models.inception_bn.get_symbol(n),
    "inception-v3": lambda n: mx.models.inception_v3.get_symbol(n),
    "alexnet": lambda n: mx.models.alexnet.get_symbol(n),
    "vgg": lambda n: mx.models.vgg.get_symbol(n),
    "googlenet": lambda n: mx.models.googlenet.get_symbol(n),
}


def main():
    parser = argparse.ArgumentParser(description="train imagenet")
    parser.add_argument("--network", type=str, default="resnet-50",
                        choices=sorted(NETS))
    parser.add_argument("--data-dir", type=str, default="data/imagenet")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--data-nthreads", type=int, default=4,
                        help="decode threads (reference --data-nthreads)")
    parser.add_argument("--data-dtype", type=str, default="float32",
                        choices=("float32", "uint8"),
                        help="uint8 ships raw pixels and normalizes "
                             "on-device (use with im2rec --pack-raw)")
    common.add_common_args(parser)
    parser.set_defaults(lr=0.1, num_epochs=90, batch_size=256)
    args = parser.parse_args()
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(message)s")

    net = NETS[args.network](args.num_classes)
    shape = (3, 299, 299) if args.network == "inception-v3" \
        else (3, 224, 224)
    kv = mx.kvstore.create(args.kvstore)
    rec = os.path.join(args.data_dir, "train.rec")
    if not args.synthetic and os.path.exists(rec):
        train = mx.io.ImageRecordIter(
            path_imgrec=rec, data_shape=shape, batch_size=args.batch_size,
            shuffle=True, rand_crop=True, rand_mirror=True,
            preprocess_threads=args.data_nthreads, dtype=args.data_dtype,
            num_parts=kv.num_workers, part_index=kv.rank)
        val_rec = os.path.join(args.data_dir, "val.rec")
        val = mx.io.ImageRecordIter(
            path_imgrec=val_rec, data_shape=shape,
            batch_size=args.batch_size,
            preprocess_threads=args.data_nthreads, dtype=args.data_dtype,
            num_parts=kv.num_workers, part_index=kv.rank) \
            if os.path.exists(val_rec) else None
    else:
        # several workers: each draws its own samples of the classes
        part = {"part": kv.rank} if kv.num_workers > 1 else {}
        train, val = common.synthetic_iters(
            shape, args.num_classes, args.batch_size,
            train_n=8 * args.batch_size, val_n=2 * args.batch_size, **part)
    common.fit(args, net, train, val)


if __name__ == "__main__":
    main()
