"""Train MLP / LeNet on MNIST, on the PyTorch/CUDA port (``mxnet_tpu_torch``).

The copy of ``example/image-classification/train_mnist.py`` that differs
only in the import line (the first BASELINE config).  Usage:
    python train_mnist.py --network lenet --batch-size 128 --num-epochs 10
Falls back to synthetic data when MNIST idx files are absent.
"""
import argparse
import logging

import mxnet_tpu_torch as mx
import common


def main():
    parser = argparse.ArgumentParser(description="train mnist")
    parser.add_argument("--network", type=str, default="mlp",
                        choices=("mlp", "lenet"))
    parser.add_argument("--data-dir", type=str, default="data/mnist")
    common.add_common_args(parser)
    parser.set_defaults(lr=0.1, num_epochs=10, batch_size=128)
    args = parser.parse_args()
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(message)s")

    flat = args.network == "mlp"
    if args.network == "mlp":
        net = mx.models.get_mlp(num_classes=10, hidden=(128, 64))
    else:
        net = mx.models.get_lenet(num_classes=10)
    train, val = common.mnist_iters(args.batch_size, args.data_dir,
                                    flat=flat, synthetic=args.synthetic)
    common.fit(args, net, train, val)


if __name__ == "__main__":
    main()
