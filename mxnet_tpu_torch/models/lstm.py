"""Explicitly-unrolled LSTM for language modeling.

Reference: example/rnn/lstm.py (lstm cell :32-70, lstm_unroll :73-134),
which lstm_bucketing.py (the BASELINE's LSTM PTB configuration) trains.
A copy of ``mxnet_tpu/models/lstm.py`` on the port's ``symbol``: the
same graph and names, so the unrolled graph of every bucket length
shares its parameters, and the one-step inference symbol takes a
trained bucket's parameters as they are.
"""
from collections import namedtuple

from .. import symbol as sym

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
              dropout=0.0):
    """One LSTM step: gates via two FullyConnected + slice."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(data=indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(data=prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    slice_gates = sym.SliceChannel(gates, num_outputs=4,
                                   name="t%d_l%d_slice" % (seqidx, layeridx))
    in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
    in_transform = sym.Activation(slice_gates[1], act_type="tanh")
    forget_gate = sym.Activation(slice_gates[2], act_type="sigmoid")
    out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0):
    """Unrolled LSTM LM symbol; arguments named like the reference so
    bucketing checkpoints share parameters across seq_len."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        param_cells.append(LSTMParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
        last_states.append(LSTMState(
            c=sym.Variable("l%d_init_c" % i),
            h=sym.Variable("l%d_init_h" % i)))

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
        for i in range(num_lstm_layer):
            dp_ratio = 0.0 if i == 0 else dropout
            next_state = lstm_cell(num_hidden, indata=hidden,
                                   prev_state=last_states[i],
                                   param=param_cells[i],
                                   seqidx=seqidx, layeridx=i,
                                   dropout=dp_ratio)
            hidden = next_state.h
            last_states[i] = next_state
        if dropout > 0.0:
            hidden = sym.Dropout(data=hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, dim=0)
    pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label = sym.transpose(data=label)
    label = sym.Reshape(data=label, target_shape=(0,))
    return sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def init_state_shapes(num_lstm_layer, batch_size, num_hidden):
    """(name, shape) pairs for the init states — feed as extra data."""
    init_c = [("l%d_init_c" % l, (batch_size, num_hidden))
              for l in range(num_lstm_layer)]
    init_h = [("l%d_init_h" % l, (batch_size, num_hidden))
              for l in range(num_lstm_layer)]
    return init_c + init_h


def lstm_inference_symbol(num_lstm_layer, input_size, num_hidden,
                          num_embed, num_label, dropout=0.0):
    """One-step LSTM for stateful inference (reference lstm.py
    lstm_inference_symbol): outputs [softmax, l0_c, l0_h, l1_c, ...] as
    a Group; weights share the unrolled symbol's names so trained
    arg_params drop straight in."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    data = sym.Variable("data")
    hidden = sym.Embedding(data=data, input_dim=input_size,
                           weight=embed_weight, output_dim=num_embed,
                           name="embed")
    out_states = []
    for i in range(num_lstm_layer):
        param = LSTMParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i))
        prev = LSTMState(c=sym.Variable("l%d_init_c" % i),
                         h=sym.Variable("l%d_init_h" % i))
        dp = 0.0 if i == 0 else dropout
        state = lstm_cell(num_hidden, indata=hidden, prev_state=prev,
                          param=param, seqidx=0, layeridx=i, dropout=dp)
        hidden = state.h
        out_states.extend([state.c, state.h])
    if dropout > 0.0:
        hidden = sym.Dropout(data=hidden, p=dropout)
    pred = sym.FullyConnected(data=hidden, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias,
                              name="pred")
    softmax = sym.SoftmaxOutput(data=pred, name="softmax")
    return sym.Group([softmax] + out_states)
