#!/usr/bin/env python
"""Bidirectional LSTM sequence sorting (reference example/bi-lstm-sort),
on the PyTorch/CUDA port (``mxnet_tpu_torch``).

Task: input a sequence of small integers; output the same multiset
sorted.  A bidirectional RNN sees the whole sequence both ways, so each
output position can be predicted from the full context — the classic
bi-RNN demo.  The copy of ``example/bi-lstm-sort/sort_io.py`` that
differs only in the import line and in the context: ``gpu(0)`` (the
fused RNN op on cuDNN), or the CPU with ``--cpu``.

Run: python sort_io.py [--cpu]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import mxnet_tpu_torch as mx

SEQ, VOCAB, BATCH, HIDDEN, EMBED = 5, 10, 32, 48, 16


def make_data(n, rng):
    xs = rng.randint(0, VOCAB, size=(n, SEQ))
    ys = np.sort(xs, axis=1)
    return xs.astype(np.float32), ys.astype(np.float32)


def build_net():
    data = mx.sym.Variable("data")            # (N, SEQ) token ids
    label = mx.sym.Variable("softmax_label")  # (N, SEQ) sorted ids
    emb = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                           name="embed")      # (N, SEQ, EMBED)
    seq = mx.sym.SwapAxis(emb, dim1=0, dim2=1, name="tnc")  # (SEQ, N, E)
    rnn = mx.sym.RNN(seq, state_size=HIDDEN, num_layers=1, mode="lstm",
                     bidirectional=True, name="birnn")      # (SEQ, N, 2H)
    flat = mx.sym.Reshape(rnn, shape=(-1, 2 * HIDDEN), name="steps")
    logits = mx.sym.FullyConnected(flat, num_hidden=VOCAB, name="cls")
    # softmax per time-step; labels flattened to match (SEQ*N,)
    return mx.sym.SoftmaxOutput(logits, name="softmax")


def main(epochs=15, n=512, ctx=None):
    rng = np.random.RandomState(0)
    X, Y = make_data(n, rng)

    net = build_net()
    exe = net.simple_bind(ctx or mx.gpu(0), data=(BATCH, SEQ),
                          softmax_label=(SEQ * BATCH,), grad_req="write")
    init = mx.init.Xavier()
    fallback = mx.init.Uniform(0.1)
    for name, arr in exe.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        try:
            init(name, arr)
        except ValueError:   # rnn parameter blob / state don't match
            fallback._init_weight(name, arr)
    opt = mx.optimizer.create("adam", learning_rate=0.01)
    states = exe.init_fused_states(opt)

    step = 0
    for epoch in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - BATCH + 1, BATCH):
            idx = perm[i:i + BATCH]
            # label layout must match the (SEQ*N) flatten of the logits:
            # time-major steps, so transpose before ravel
            step += 1
            states = exe.fused_step(
                opt, states, step, data=X[idx],
                softmax_label=Y[idx].T.ravel())
        if (epoch + 1) % 5 == 0:
            probs = exe.outputs[0].asnumpy()      # (SEQ*BATCH, VOCAB)
            pred = probs.argmax(axis=1).reshape(SEQ, BATCH).T
            acc = (pred == Y[idx]).mean()
            print("epoch %d last-batch per-token acc %.3f"
                  % (epoch + 1, acc))
    return acc


if __name__ == "__main__":
    acc = main(ctx=mx.cpu() if "--cpu" in sys.argv[1:] else None)
    assert acc > 0.85, "bi-lstm sort failed to learn (%.3f)" % acc
    print("OK bi-lstm-sort example")
