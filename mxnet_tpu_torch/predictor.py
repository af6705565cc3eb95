"""Standalone inference API.

The port's counterpart of ``mxnet_tpu/predictor.py`` (the reference's
``c_predict_api.cc`` surface: load symbol JSON + params, set inputs,
forward, read outputs).  ``ctx=None`` means ``gpu(0)``, and with no CUDA
device that raises: pass ``ctx=cpu()`` to predict on the CPU.
"""
from __future__ import annotations

import os

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym
from .context import Context, resolve

__all__ = ["Predictor"]


class Predictor(object):
    """Parity: MXPredCreate / MXPredForward / MXPredGetOutput.

    Parameters
    ----------
    symbol_json : str — symbol JSON text or path ending in .json
    param_file : str | dict — a 0x112 params file ('arg:'/'aux:'
        prefixed names, the save_checkpoint format) or a dict of
        numpy arrays, tensors or NDArrays
    input_shapes : dict name -> shape
    ctx : Context or None (the default, ``gpu(0)``)
    quantize : None | "int8" — weight-only quantization: rewrite the
        FullyConnected nodes to QuantizedDense and quantize their
        weights.  Idempotent on an already-quantized params dict.
    """

    def __init__(self, symbol_json, param_file, input_shapes, ctx=None,
                 quantize=None):
        if isinstance(symbol_json, os.PathLike):
            symbol_json = os.fspath(symbol_json)
        if isinstance(symbol_json, str) and symbol_json.endswith(".json"):
            self.symbol = sym.load(symbol_json)
        else:
            self.symbol = sym.load_json(symbol_json)
        self._device = resolve(ctx)

        if isinstance(param_file, dict):
            raw = param_file
        else:
            with Context.from_device(self._device):
                raw = nd.load(os.fspath(param_file))
        arg_params, aux_params = {}, {}
        for k, v in raw.items():
            if k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k[4:] if k.startswith("arg:") else k] = v

        self._quantize = quantize
        if quantize:
            from .kernels import quantize as _q
            qjs, qnames = _q.quantize_symbol(self.symbol.tojson(),
                                             qdtype=quantize)
            if qnames:
                self.symbol = sym.load_json(qjs)
                arg_params = _q.quantize_params(arg_params, qnames,
                                                qdtype=quantize)

        self._input_names = list(input_shapes)
        arg_names = self.symbol.list_arguments()
        # args in neither inputs nor params bind as inferred-shape zeros,
        # as the reference predictor does (c_predict_api.cc:149-170)
        arg_shapes, _, _ = self.symbol.infer_shape_partial(**input_shapes)
        inferred = dict(zip(arg_names, arg_shapes or ()))
        args = {}
        for name in arg_names:
            if name in input_shapes:
                args[name] = nd.zeros(input_shapes[name], ctx=self._device)
            elif name in arg_params:
                args[name] = nd.array(arg_params[name], ctx=self._device)
            elif inferred.get(name) is not None:
                args[name] = nd.zeros(inferred[name], ctx=self._device)
            else:
                raise MXNetError("Predictor: missing parameter %r" % name)
        aux = {}
        for name in self.symbol.list_auxiliary_states():
            if name not in aux_params:
                raise MXNetError("Predictor: missing aux state %r" % name)
            aux[name] = nd.array(aux_params[name], ctx=self._device)
        self._exec = self.symbol.bind(self._device, args, aux_states=aux)

    def set_input(self, name, value):
        """Parity MXPredSetInput (incl. its size validation)."""
        if name not in self._input_names:
            raise MXNetError("unknown input %r (inputs: %s)"
                             % (name, self._input_names))
        want = self._exec.arg_dict[name].shape
        if tuple(value.shape) != tuple(want):
            raise MXNetError(
                "input %r has shape %s but the predictor was bound with %s"
                % (name, tuple(value.shape), want))
        self._exec.arg_dict[name][:] = value

    def forward(self, **inputs):
        """Set any given inputs, run, return a list of numpy outputs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        return [o.asnumpy() for o in self._exec.forward(is_train=False)]

    def get_output(self, index):
        """Parity MXPredGetOutput."""
        return self._exec.outputs[index].asnumpy()
