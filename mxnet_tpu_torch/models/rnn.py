"""Explicitly-unrolled vanilla (tanh) RNN for language modeling.

Reference: example/rnn/rnn.py (RNNState/RNNParam/rnn cell + unroll).  A
copy of ``mxnet_tpu/models/rnn.py`` on the port's ``symbol``, with the
same harness contract as models/lstm.py and models/gru.py: one
FullyConnected pair per step, parameters named for bucketing reuse
across sequence lengths.
"""
from collections import namedtuple

from .. import symbol as sym

RNNState = namedtuple("RNNState", ["h"])
RNNParam = namedtuple("RNNParam", ["i2h_weight", "i2h_bias",
                                   "h2h_weight", "h2h_bias"])


def rnn_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0):
    """h' = tanh(W_i x + W_h h) — the reference's vanilla cell."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    return RNNState(h=sym.Activation(i2h + h2h, act_type="tanh"))


def rnn_unroll(num_rnn_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0):
    """Unrolled vanilla-RNN LM symbol (reference rnn.py)."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_rnn_layer):
        param_cells.append(RNNParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
        last_states.append(RNNState(h=sym.Variable("l%d_init_h" % i)))

    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=input_size,
                          weight=embed_weight, output_dim=num_embed,
                          name="embed")
    wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len,
                               squeeze_axis=1)

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_rnn_layer):
            dp = 0.0 if i == 0 else dropout
            state = rnn_cell(num_hidden, indata=hidden,
                             prev_state=last_states[i],
                             param=param_cells[i], seqidx=seqidx,
                             layeridx=i, dropout=dp)
            hidden = state.h
            last_states[i] = state
        if dropout > 0.0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, dim=0)
    pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label = sym.transpose(data=label)
    label = sym.Reshape(data=label, target_shape=(0,))
    return sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def init_state_shapes(num_rnn_layer, batch_size, num_hidden):
    """(name, shape) pairs for the init states — feed as extra data."""
    return [("l%d_init_h" % l, (batch_size, num_hidden))
            for l in range(num_rnn_layer)]
