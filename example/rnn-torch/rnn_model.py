"""Stateful LSTM inference model (reference example/rnn/rnn_model.py
LSTMInferenceModel), on the PyTorch/CUDA port (``mxnet_tpu_torch``): bind
the one-step symbol once, feed each token, and carry the (c, h) states
forward on the device: token-by-token generation from a
bucketing-trained checkpoint.  The copy of ``example/rnn/rnn_model.py``
that differs only in the import lines and in the default context, the
current one (``gpu(0)`` outside a ``with`` scope)."""
import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models.lstm import lstm_inference_symbol


class LSTMInferenceModel(object):
    def __init__(self, num_lstm_layer, input_size, num_hidden, num_embed,
                 num_label, arg_params, ctx=None, dropout=0.0):
        ctx = ctx or mx.current_context()
        self.sym = lstm_inference_symbol(num_lstm_layer, input_size,
                                         num_hidden, num_embed, num_label,
                                         dropout)
        batch_size = 1
        init_c = [("l%d_init_c" % l, (batch_size, num_hidden))
                  for l in range(num_lstm_layer)]
        init_h = [("l%d_init_h" % l, (batch_size, num_hidden))
                  for l in range(num_lstm_layer)]
        input_shapes = dict(init_c + init_h + [("data", (batch_size,))])
        self.executor = self.sym.simple_bind(ctx, grad_req="null",
                                             **input_shapes)
        for key in self.executor.arg_dict:
            if key in arg_params:
                arg_params[key].copyto(self.executor.arg_dict[key])
        self._state_names = [n for pair in
                             ((("l%d_init_c" % i), ("l%d_init_h" % i))
                              for i in range(num_lstm_layer))
                             for n in pair]

    def forward(self, input_data, new_seq=False):
        """input_data: (1,) token id array.  new_seq=True zeroes the
        carried states.  Returns the next-token distribution (numpy)."""
        if new_seq:
            for key in self._state_names:
                self.executor.arg_dict[key][:] = 0.0
        self.executor.arg_dict["data"][:] = np.asarray(
            getattr(input_data, "asnumpy", lambda: input_data)())
        outs = self.executor.forward()
        for key, out in zip(self._state_names, outs[1:]):
            out.copyto(self.executor.arg_dict[key])   # stays on device
        return outs[0].asnumpy()


def sample(model, vocab_size, length=20, seed_token=1, temperature=1.0,
           rng=None):
    """Greedy-ish sampling loop: the generation demo."""
    rng = rng or np.random.RandomState(0)
    tok = seed_token
    out = [tok]
    new_seq = True
    for _ in range(length - 1):
        prob = model.forward(np.array([tok], np.float32),
                             new_seq=new_seq)[0]
        new_seq = False
        if temperature != 1.0:
            logits = np.log(np.maximum(prob, 1e-12)) / temperature
            prob = np.exp(logits - logits.max())
            prob /= prob.sum()
        tok = int(rng.choice(vocab_size, p=prob / prob.sum()))
        out.append(tok)
    return out


if __name__ == "__main__":
    # tiny self-contained demo: random weights, just prove the loop runs
    V, H, E, L = 50, 32, 16, 1
    rng = np.random.RandomState(0)
    model = LSTMInferenceModel(L, V, H, E, V, arg_params={})
    for name, arr in model.executor.arg_dict.items():
        if name not in ("data",) and not name.endswith(("_init_c",
                                                        "_init_h")):
            arr[:] = rng.uniform(-0.1, 0.1, arr.shape)
    toks = sample(model, V, length=12)
    print("sampled:", toks)
