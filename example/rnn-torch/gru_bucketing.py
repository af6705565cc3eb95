"""GRU language model with bucketing (PTB-style), on the PyTorch/CUDA
port (``mxnet_tpu_torch``).

The copy of ``example/rnn/gru_bucketing.py`` that differs only in the import
lines and in the context: ``gpu(0)``, or the CPU with ``--cpu``.  With
``--data-dir`` pointing at PTB text files it trains the real LM;
without, a synthetic corpus keeps the script hermetic.  Buckets bind one
executor each through BucketingModule, over the default bucket's
parameters.
"""
import argparse
import logging
import os

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models.gru import gru_unroll, init_state_shapes

from bucket_io import (BucketSentenceIter, default_build_vocab,
                       default_text2id, synthetic_corpus)


def main():
    parser = argparse.ArgumentParser(description="gru lm with bucketing")
    parser.add_argument("--data-dir", type=str, default="data/ptb")
    parser.add_argument("--num-hidden", type=int, default=200)
    parser.add_argument("--num-embed", type=int, default=200)
    parser.add_argument("--num-gru-layer", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epochs", type=int, default=5)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--kvstore", type=str, default="local")
    parser.add_argument("--buckets", type=str, default="10,20,30,40")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of gpu(0)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    buckets = [int(b) for b in args.buckets.split(",")]
    train_path = os.path.join(args.data_dir, "ptb.train.txt")
    if os.path.exists(train_path):
        vocab = default_build_vocab(train_path)
        sents = [default_text2id(s, vocab)
                 for s in open(train_path).read().split("\n")]
        vocab_size = len(vocab) + 1
    else:
        logging.info("PTB not found under %s — synthetic corpus",
                     args.data_dir)
        vocab_size = 120
        sents = synthetic_corpus(vocab_size=vocab_size)

    init_states = init_state_shapes(args.num_gru_layer, args.batch_size,
                                    args.num_hidden)
    train = BucketSentenceIter(sents, args.batch_size, buckets=buckets,
                               init_states=init_states)

    def sym_gen(seq_len):
        s = gru_unroll(args.num_gru_layer, seq_len, vocab_size,
                       num_hidden=args.num_hidden,
                       num_embed=args.num_embed, num_label=vocab_size)
        data_names = ["data"] + [n for n, _ in init_states]
        return s, data_names, ["softmax_label"]

    mod = mx.mod.BucketingModule(
        sym_gen, default_bucket_key=train.default_bucket_key,
        context=[mx.cpu()] if args.cpu else [mx.gpu(0)])
    mod.fit(train, eval_metric=mx.metric.Perplexity(ignore_label=None),
            kvstore=args.kvstore,
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.momentum, "wd": 1e-5},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=args.num_epochs,
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 20))


if __name__ == "__main__":
    main()
