"""Sequence operators: SequenceLast, SequenceMask, SequenceReverse.

The port of ``mxnet_tpu/ops/sequence.py`` (the reference's
``src/operator/sequence_last/mask/reverse-inl.h``).  Data is (seq_len,
batch, ...) and the optional ``sequence_length`` input is (batch,), read
as integers (no gradient reaches it).  Each body is one gather or one
``torch.where`` over the whole tensor, as the JAX package's are.
"""
from __future__ import annotations

import torch

from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known


class _SeqParam(ParamStruct):
    use_sequence_length = Field(bool, default=False)


class _SeqBase(OperatorProperty):
    param_cls = _SeqParam

    def list_arguments(self):
        if self.param.use_sequence_length:
            return ["data", "sequence_length"]
        return ["data"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known(self.op_name, in_shapes[:1], ["data"])
        ins = [data]
        if self.param.use_sequence_length:
            ins.append((data[1],))
        return ins, [self._out_shape(data)], []

    def _out_shape(self, data):
        return data

    def _lengths(self, inputs):
        """(batch,) int64 lengths: the input's, or seq_len for every row."""
        data = inputs[0]
        if self.param.use_sequence_length:
            return inputs[1].detach().to(torch.int64)
        return torch.full((data.shape[1],), data.shape[0], dtype=torch.int64,
                          device=data.device)


@register_op("SequenceLast")
class SequenceLast(_SeqBase):
    """The step ``length - 1`` of each batch row (step 0 for length 0)."""

    def _out_shape(self, data):
        return data[1:]

    def forward(self, inputs, aux, is_train, rng):
        data = inputs[0]
        idx = torch.clamp(self._lengths(inputs) - 1, min=0)
        batch = torch.arange(data.shape[1], device=data.device)
        return [data[idx, batch]], None


class _SeqMaskParam(_SeqParam):
    value = Field(float, default=0.0)


@register_op("SequenceMask")
class SequenceMask(_SeqBase):
    """Steps at or past each row's length set to ``value``."""
    param_cls = _SeqMaskParam

    def forward(self, inputs, aux, is_train, rng):
        data = inputs[0]
        lengths = self._lengths(inputs)
        steps = torch.arange(data.shape[0], device=data.device)[:, None]
        mask = steps < lengths[None, :]                 # (seq, batch)
        mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
        fill = torch.tensor(self.param.value, dtype=data.dtype,
                            device=data.device)
        return [torch.where(mask, data, fill)], None


@register_op("SequenceReverse")
class SequenceReverse(_SeqBase):
    """The first ``length`` steps of each row reversed; the rest kept."""

    def forward(self, inputs, aux, is_train, rng):
        data = inputs[0]
        lengths = self._lengths(inputs)[None, :]
        steps = torch.arange(data.shape[0], device=data.device)[:, None]
        src = torch.where(steps < lengths, lengths - 1 - steps,
                          steps)                        # (seq, batch)
        batch = torch.arange(data.shape[1], device=data.device)[None, :]
        return [data[src, batch]], None
