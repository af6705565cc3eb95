"""Standalone inference API.

The port's counterpart of ``mxnet_tpu/predictor.py`` (the reference's
``c_predict_api.cc`` surface: load symbol JSON + params, set inputs,
forward, read outputs).  ``ctx=None`` means ``gpu(0)``, and with no CUDA
device that raises: pass ``ctx=cpu()`` to predict on the CPU.  Predictors
of one symbol on one device share one program through the executor's
registry (:meth:`Predictor.compile_stats`); :meth:`Predictor.forward_async`
is the serving batcher's launch.
"""
from __future__ import annotations

import os

import torch

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym
from .context import Context, resolve

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(fname_or_bytes):
    """A saved 0x112 file (a path, or its bytes) as a name -> NDArray
    dict, or a list when it has no names (MXNDListCreate): arrays land
    on the current context.  Bytes go through a temporary file, which is
    removed."""
    if isinstance(fname_or_bytes, (bytes, bytearray)):
        import tempfile
        fd, tmp = tempfile.mkstemp(suffix=".params")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(fname_or_bytes)
            return nd.load(tmp)
        finally:
            os.unlink(tmp)
    return nd.load(os.fspath(fname_or_bytes))


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
    quantize : None | "int8" | "fp8_e4m3" — weight-only quantization:
        rewrite the FullyConnected nodes to QuantizedDense and quantize
        their weights.  Defaults to the ``MXTPU_QUANTIZE`` environment
        variable.  Idempotent on an already-quantized params dict.
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

        if quantize is None:
            quantize = os.environ.get("MXTPU_QUANTIZE", "") or None
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
        self._ctx = self._device
        self._arg_params = arg_params
        self._aux_params = aux_params

    def _check_input(self, name, value):
        if name not in self._input_names:
            raise MXNetError("unknown input %r (inputs: %s)"
                             % (name, self._input_names))
        want = self._exec.arg_dict[name].shape
        if tuple(value.shape) != tuple(want):
            raise MXNetError(
                "input %r has shape %s but the predictor was bound with %s"
                % (name, tuple(value.shape), want))

    def set_input(self, name, value):
        """Parity MXPredSetInput (incl. its size validation)."""
        self._check_input(name, value)
        self._exec.arg_dict[name][:] = value

    def forward(self, **inputs):
        """Set any given inputs, run, return a list of numpy outputs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        return [o.asnumpy() for o in self._exec.forward(is_train=False)]

    def forward_async(self, **inputs):
        """Launch one forward without waiting for the device and return
        the raw output tensors.

        The inputs go to the device as new tensors (the bound argument
        slots are not written) and the outputs are new tensors of this
        call, never the executor's ``outputs``: a pipeline may launch
        batch N+1 while batch N's results are still being read (the
        serving batcher's overlap).  Reading them (``.cpu()``) waits for
        the device."""
        ex = self._exec
        values = {n: a.data for n, a in ex.arg_dict.items()}
        for name, value in inputs.items():
            t = torch.as_tensor(value)
            self._check_input(name, t)
            values[name] = t.to(device=self._device,
                                dtype=ex.arg_dict[name].dtype)
        ex._n_forward += 1
        return ex._forward_raw(values)

    @staticmethod
    def compile_stats():
        """The program registry's counters (``{"hits", "misses",
        "lowerings", "programs"}``): a second Predictor of the same
        symbol on the same device counts a hit and no lowering."""
        from .executor import program_registry_stats
        return program_registry_stats()

    def get_output(self, index):
        """Parity MXPredGetOutput."""
        return self._exec.outputs[index].asnumpy()

    def reshape(self, input_shapes):
        """Parity MXPredReshape: a Predictor of the same symbol and
        parameters for new input shapes (it shares the program)."""
        return Predictor(self.symbol.tojson(),
                         dict(self._arg_params,
                              **{"aux:" + k: v
                                 for k, v in self._aux_params.items()}),
                         input_shapes, self._ctx)
