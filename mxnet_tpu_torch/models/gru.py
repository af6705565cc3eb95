"""Explicitly-unrolled GRU for language modeling.

Role parity: the reference's example/rnn/gru.py (cell + unroll) feeding
gru_bucketing.  A copy of ``mxnet_tpu/models/gru.py`` on the port's
``symbol``.  Math (standard GRU): with z = update gate and r = reset
gate, both sigmoid over fused two-gate products,

    h' = (1 - z) * h + z * tanh(W_cx x + W_ch (r * h))

Parameters are named so bucketing shares weights across sequence
lengths, matching the lstm/rnn builders in this package.
"""
from collections import namedtuple

from .. import symbol as sym

GRUState = namedtuple("GRUState", ["h"])
GRUParam = namedtuple("GRUParam", ["gates_i2h_weight", "gates_i2h_bias",
                                   "gates_h2h_weight", "gates_h2h_bias",
                                   "trans_i2h_weight", "trans_i2h_bias",
                                   "trans_h2h_weight", "trans_h2h_bias"])

def _layer_params(layer):
    """GRUParam over shared Variables: l<k>_<slot>_{weight,bias}."""
    def wb(slot):
        return (sym.Variable("l%d_%s_weight" % (layer, slot)),
                sym.Variable("l%d_%s_bias" % (layer, slot)))

    gw, gb = wb("i2h_gates")
    hw, hb = wb("h2h_gates")
    tw, tb = wb("i2h_trans")
    uw, ub = wb("h2h_trans")
    return GRUParam(gates_i2h_weight=gw, gates_i2h_bias=gb,
                    gates_h2h_weight=hw, gates_h2h_bias=hb,
                    trans_i2h_weight=tw, trans_i2h_bias=tb,
                    trans_h2h_weight=uw, trans_h2h_bias=ub)


def _fc(x, weight, bias, width, tag):
    return sym.FullyConnected(data=x, weight=weight, bias=bias,
                              num_hidden=width, name=tag)


def gru_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0):
    """One GRU step.  Both gates come from one fused 2x-wide matmul
    pair; the candidate's hidden-side matmul is kept separate
    because the reset gate scales h BEFORE that transform."""
    x = sym.Dropout(data=indata, p=dropout) if dropout > 0.0 else indata
    tag = "t%d_l%d" % (seqidx, layeridx)
    both = (_fc(x, param.gates_i2h_weight, param.gates_i2h_bias,
                num_hidden * 2, tag + "_gates_i2h")
            + _fc(prev_state.h, param.gates_h2h_weight,
                  param.gates_h2h_bias, num_hidden * 2,
                  tag + "_gates_h2h"))
    z, r = sym.SliceChannel(both, num_outputs=2, name=tag + "_slice")
    z = sym.Activation(z, act_type="sigmoid")
    r = sym.Activation(r, act_type="sigmoid")
    cand = sym.Activation(
        _fc(x, param.trans_i2h_weight, param.trans_i2h_bias, num_hidden,
            tag + "_trans_i2h")
        + _fc(r * prev_state.h, param.trans_h2h_weight,
              param.trans_h2h_bias, num_hidden, tag + "_trans_h2h"),
        act_type="tanh")
    return GRUState(h=prev_state.h + z * (cand - prev_state.h))


def gru_unroll(num_gru_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0):
    """Unrolled GRU LM symbol: embed -> seq_len x layer stack -> shared
    classifier, label flattened time-major (same head contract as
    models/lstm.py so the bucketing harness is interchangeable)."""
    params = [_layer_params(i) for i in range(num_gru_layer)]
    states = [GRUState(h=sym.Variable("l%d_init_h" % i))
              for i in range(num_gru_layer)]

    tokens = sym.SliceChannel(
        sym.Embedding(data=sym.Variable("data"), input_dim=input_size,
                      weight=sym.Variable("embed_weight"),
                      output_dim=num_embed, name="embed"),
        num_outputs=seq_len, squeeze_axis=1)

    steps = []
    for t in range(seq_len):
        h = tokens[t]
        for i in range(num_gru_layer):
            states[i] = gru_cell(num_hidden, indata=h,
                                 prev_state=states[i], param=params[i],
                                 seqidx=t, layeridx=i,
                                 dropout=0.0 if i == 0 else dropout)
            h = states[i].h
        steps.append(sym.Dropout(data=h, p=dropout)
                     if dropout > 0.0 else h)

    logits = sym.FullyConnected(data=sym.Concat(*steps, dim=0),
                                num_hidden=num_label,
                                weight=sym.Variable("cls_weight"),
                                bias=sym.Variable("cls_bias"), name="pred")
    flat_label = sym.Reshape(
        data=sym.transpose(data=sym.Variable("softmax_label")),
        target_shape=(0,))
    return sym.SoftmaxOutput(data=logits, label=flat_label, name="softmax")


def init_state_shapes(num_gru_layer, batch_size, num_hidden):
    """(name, shape) pairs for the init states — feed as extra data."""
    return [("l%d_init_h" % l, (batch_size, num_hidden))
            for l in range(num_gru_layer)]
