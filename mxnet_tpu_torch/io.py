"""Data iterators.

The port's slice of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``,
the ``DataIter`` protocol and ``NDArrayIter`` (shuffling, with ``seed``
a numpy ``RandomState`` reseeded each epoch, so a seed gives the JAX
package's order; ``last_batch_handle`` pad/discard/roll_over;
``num_parts``/``part_index``; resumable ``state()``).  Batches are host
arrays (NDArrays on the CPU); the executor copies them to its device.
``ImageRecordIter`` (and the native decoder it reads through),
``MNISTIter``, ``CSVIter`` and the prefetching iterators belong to later
slices.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "DataDesc"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape of one input stream (later mxnet DataDesc; dtype f32)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch(object):
    """One mini-batch (parity: io.py DataBatch): data/label lists of NDArray,
    pad = #fake samples at the tail, index = sample indices."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Iterator protocol (parity: io.py:87 DataIter): reset/iter_next/
    getdata/getlabel/getpad/getindex + provide_data/provide_label."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize {list|dict|array} -> list[(name, numpy)] (parity io.py:250)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity: io.py:320 NDArrayIter):
    shuffle, last_batch_handle pad/discard/roll_over, pad accounting.

    Beyond-reference (docs/resilience.md): ``seed`` makes shuffling a
    pure function of (seed, epoch) — the arrays are never physically
    reordered, batches are gathered through a permutation array that is
    deterministically reseeded at every ``reset()``.  Combined with
    ``state()``/``set_state()`` a preempted job replays the exact batch
    order it would have seen uninterrupted.  With ``seed=None`` the
    legacy semantics hold: one global-RNG shuffle at construction, same
    order every epoch.

    ``num_parts``/``part_index`` (the reference's distributed-iterator
    knobs, io.py kPartition) shard the SAME global order across
    workers: every part computes the identical (seed, epoch)
    permutation over the full dataset and takes a disjoint stride of
    it, so the parts' union is exactly the dataset — no sample dropped
    or duplicated — **for any number of parts**.  That world-size
    independence is what elastic re-meshing leans on: after a
    shrink/grow the survivors rebuild the iterator with the new
    ``num_parts`` at the resumed epoch and the pod as a whole still
    visits each sample exactly once per epoch (docs/resilience.md
    "Elasticity").
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None,
                 num_parts=1, part_index=0):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        self.shuffle = bool(shuffle)
        self.seed = seed
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        if self.num_parts < 1:
            raise MXNetError("num_parts must be >= 1, got %d"
                             % self.num_parts)
        if not 0 <= self.part_index < self.num_parts:
            raise MXNetError("part_index must be in [0, %d), got %d"
                             % (self.num_parts, self.part_index))
        if self.num_parts > 1 and self.shuffle and self.seed is None:
            raise MXNetError(
                "NDArrayIter(num_parts>1) needs seed= when shuffle=True: "
                "the parts must agree on one global order to partition "
                "(an unseeded shuffle diverges per process)")
        self.epoch = 0
        self._total = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self._kept = self._total - self._total % batch_size
        else:
            self._kept = self._total
        self.idx = self._partition(_np.arange(self._kept))
        if self.shuffle:
            self._reshuffle()

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size need to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    def _partition(self, order):
        """This part's disjoint stride of the global order.  Every part
        computes the same ``order`` (seeded permutation or arange) and
        takes ``order[part_index::num_parts]``, so for ANY num_parts
        the parts tile the kept samples exactly once — the invariant
        elastic resume leans on when the world size changes."""
        if self.num_parts <= 1:
            return order
        return order[self.part_index::self.num_parts]

    def _reshuffle(self):
        """Rebuild the permutation for the current epoch."""
        order = _np.arange(self._total)
        if self.seed is not None:
            rng = _np.random.RandomState(
                (int(self.seed) * 1000003 + self.epoch) % (2 ** 31 - 1))
            rng.shuffle(order)
        else:
            _np.random.shuffle(order)     # legacy: ambient global RNG
        self.idx = self._partition(order[:self._kept])

    # -- resumable iteration state (docs/resilience.md) ----------------
    def state(self):
        """Position as a small dict: ``{"epoch", "cursor"}`` — snapshot
        it next to a checkpoint to make the batch stream resumable."""
        return {"epoch": self.epoch, "cursor": int(self.cursor)}

    def set_state(self, state):
        """Restore a :meth:`state` snapshot; the next batch drawn is
        exactly the one the snapshotted run would have drawn.  Requires
        ``seed`` when shuffling (the legacy global-RNG order is not
        reconstructible)."""
        if self.shuffle and self.seed is None:
            raise MXNetError(
                "NDArrayIter.set_state needs seed= when shuffle=True "
                "(an unseeded shuffle order cannot be replayed)")
        self.epoch = int(state["epoch"])
        if self.shuffle:
            self._reshuffle()
        self.cursor = int(state["cursor"])

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        self.epoch += 1
        if self.shuffle and self.seed is not None:
            self._reshuffle()         # deterministic per-epoch reshuffle
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter need reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = _np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [nd_array(v[sel], ctx=cpu()) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
