"""Data iterators.

The port of ``mxnet_tpu/io.py`` (the reference's ``python/mxnet/io.py``
plus the C++ registered iterators of ``src/io/``: MNISTIter, CSVIter,
ImageRecordIter), each giving the JAX package's batches on the same
files and seeds:

- ``NDArrayIter`` (shuffling with ``seed`` a numpy ``RandomState``
  reseeded each epoch; ``last_batch_handle`` pad/discard/roll_over;
  ``num_parts``/``part_index``; resumable ``state()``), ``ResizeIter``,
  ``PrefetchingIter``, ``CSVIter`` and ``MNISTIter``;
- ``ImageRecordIter``: a streaming RecordIO reader whose records are
  decoded by the native engine's worker pool (``engine.py`` over
  ``lib/libmxtpu.so``), raw ``im2rec --pack-raw`` records without a
  decode, JPEG through the native libjpeg kernel or the Python
  augmenter, batches in ``uint8`` or normalized ``float32``.

Batches are host arrays (NDArrays on the CPU): the executor, or
``parallel.overlap.DevicePrefetcher``, copies them to the device, where
a ``uint8`` batch is widened to float (it crosses the bus in a quarter
of float32's bytes).

Distributed sharding follows the reference's ``num_parts``/``part_index``
protocol (iter_image_recordio.cc:108-133): each worker constructs its iter
with its shard so a host only touches 1/num_parts of the data.
"""
from __future__ import annotations

import functools as _functools
import threading
from collections import namedtuple

import numpy as _np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as nd_array
# imported at module level ON PURPOSE: engine.py's atexit drain must
# register BEFORE this module's _stop_producers (atexit is LIFO), so
# producers stop first, engine drains second
from . import engine as _engine_mod  # noqa: F401

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "DataDesc"]

# Producer threads must be out of the decode machinery before the
# interpreter starts finalizing: a daemon thread force-unwound by
# CPython inside a ctypes/native frame aborts the process
# ("FATAL: exception not rethrown").  _SHUTTING_DOWN makes every
# producer exit at its next loop step; the atexit hook (which runs
# BEFORE engine.py's drain — io imports engine, so registers later,
# and atexit is LIFO) joins them while the interpreter is healthy.
_SHUTTING_DOWN = False
_LIVE_PRODUCERS = None   # weakref.WeakSet, created lazily


def _register_producer(thread):
    global _LIVE_PRODUCERS
    if _LIVE_PRODUCERS is None:
        import weakref
        _LIVE_PRODUCERS = weakref.WeakSet()
    _LIVE_PRODUCERS.add(thread)


_LIVE_PREFETCHERS = None


def _register_prefetcher(it):
    global _LIVE_PREFETCHERS
    if _LIVE_PREFETCHERS is None:
        import weakref
        _LIVE_PREFETCHERS = weakref.WeakSet()
    _LIVE_PREFETCHERS.add(it)


def _stop_producers():
    global _SHUTTING_DOWN
    # GIL-atomic monotonic flag (False -> True once, at interpreter
    # exit); producers poll it, a stale read only delays shutdown by
    # one iteration  # mxl: thread-shared-ok (MXL-Q001)
    _SHUTTING_DOWN = True
    for p in list(_LIVE_PREFETCHERS or ()):
        try:
            p.started = False
            for e in p.data_taken:
                e.set()
        except Exception:
            pass
    for t in list(_LIVE_PRODUCERS or ()):
        try:
            t.join(timeout=10.0)
        except Exception:
            pass


import atexit as _atexit
_atexit.register(_stop_producers)


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


class ResizeIter(DataIter):
    """Resize an iter to ``size`` batches per epoch (parity: io.py:118)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread + event double-buffering prefetcher (parity: io.py:172;
    the analog of the C++ PrefetcherIter, iter_prefetcher.h:45).  Overlaps
    host-side batch assembly with device compute."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self._closed = False
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        _register_prefetcher(self)
        self.prefetch_threads = []
        self._start_threads()

    def _prefetch_func(self, i):
        while True:
            self.data_taken[i].wait()
            if not self.started or _SHUTTING_DOWN:
                break
            try:
                # the Event handshake IS the synchronization: slot i is
                # only touched by the side holding its turn (producer
                # after data_taken, consumer after data_ready)
                # mxl: thread-shared-ok (MXL-Q001)
                self.next_batch[i] = self.iters[i].next()
            except StopIteration:
                self.next_batch[i] = None
            # Event.clear is itself thread-safe; the list holding the
            # events is never resized after __init__
            # mxl: thread-shared-ok (MXL-Q001)
            self.data_taken[i].clear()
            self.data_ready[i].set()

    def _start_threads(self):
        if _SHUTTING_DOWN or self._closed:
            return
        # GIL-atomic bool flag: producers re-check it after every
        # data_taken handshake, so a stale read costs one extra batch,
        # never a torn value  # mxl: thread-shared-ok (MXL-Q001)
        self.started = True
        self.prefetch_threads = [
            threading.Thread(target=self._prefetch_func, args=[i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            _register_producer(thread)
            thread.start()

    def _join_threads(self, timeout=1.0):
        """Stop + join the producer threads; safe to call repeatedly and
        with threads already dead.  ``data_taken`` is set again at every
        poll: a producer inside an inner ``next()`` clears it when that
        returns, and would otherwise park on it for good (the JAX
        package's version sets it once)."""
        import time as _time
        self.started = False
        deadline = _time.monotonic() + timeout
        for thread in self.prefetch_threads:
            while thread.is_alive() and _time.monotonic() < deadline:
                for e in self.data_taken:
                    e.set()
                thread.join(timeout=0.02)
        for e in self.data_taken:
            e.set()
        self.prefetch_threads = []

    def close(self):
        """Permanently stop the prefetch threads and release the inner
        iterators.  Idempotent; the iterator is unusable afterwards."""
        if self._closed:
            return
        self._closed = True
        self._join_threads()
        for it in self.iters:
            close_fn = getattr(it, "close", None)
            if callable(close_fn):
                try:
                    close_fn()
                except Exception:
                    pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[n], s) if isinstance(r, dict) else r
                     for n, s in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[n], s) if isinstance(r, dict) else r
                     for n, s in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        """Drain any in-flight batch, rewind the inner iterators, and
        re-arm the producers.  Idempotent, and safe after the producer
        threads have died (shutdown race / prior close): dead threads
        are re-joined and fresh ones started so reset never hangs on a
        ``data_ready`` event nobody will set."""
        if self._closed:
            raise RuntimeError("PrefetchingIter.reset() after close()")
        alive = bool(self.prefetch_threads) and \
            all(t.is_alive() for t in self.prefetch_threads)
        if alive:
            # Drain: wait for the in-flight fetch so the inner iterators
            # are quiescent before rewinding them under the producers.
            for e in self.data_ready:
                while not e.wait(timeout=0.1):
                    if _SHUTTING_DOWN or \
                            not all(t.is_alive()
                                    for t in self.prefetch_threads):
                        alive = False
                        break
                if not alive:
                    break
        if not alive:
            self._join_threads()
        self.next_batch = [None] * self.n_iter
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        if not alive:
            self._start_threads()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _shard(arrays, num_parts, part_index):
    """num_parts/part_index sharding (parity: iter_image_recordio.cc:108-133)."""
    if num_parts <= 1:
        return arrays
    n = arrays[0].shape[0]
    per = n // num_parts
    lo, hi = part_index * per, (part_index + 1) * per if part_index < num_parts - 1 else n
    return [a[lo:hi] for a in arrays]


class CSVIter(NDArrayIter):
    """CSV file iterator (parity: src/io/iter_csv.cc registered CSVIter)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, num_parts=1, part_index=0,
                 data_name="data", label_name="label", **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = _np.zeros((data.shape[0],), dtype=_np.float32)
        data, label = _shard([data, label], num_parts, part_index)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch else "discard",
                         data_name=data_name, label_name=label_name)


def _load_mnist_idx(image_path, label_path):
    """Parse IDX-format MNIST files (the format MNISTIter reads,
    src/io/iter_mnist.cc)."""
    import gzip
    import struct

    def _open(p):
        return gzip.open(p, "rb") if str(p).endswith(".gz") else open(p, "rb")

    with _open(label_path) as f:
        magic, num = struct.unpack(">II", f.read(8))
        assert magic == 2049, "bad MNIST label magic"
        labels = _np.frombuffer(f.read(num), dtype=_np.uint8)
    with _open(image_path) as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "bad MNIST image magic"
        images = _np.frombuffer(f.read(num * rows * cols), dtype=_np.uint8)
        images = images.reshape(num, rows, cols)
    return images, labels


def MNISTIter(image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
              batch_size=128, shuffle=True, flat=False, silent=False,
              seed=0, input_shape=None, num_parts=1, part_index=0, **kwargs):
    """MNIST iterator (parity: src/io/iter_mnist.cc MNISTIter params).

    Reads IDX files (optionally .gz).  Returns an NDArrayIter — batching,
    shuffling, and padding semantics are shared with the in-memory path.
    """
    images, labels = _load_mnist_idx(image, label)
    images = images.astype(_np.float32) / 255.0
    if flat or (input_shape is not None and len(input_shape) == 1):
        data = images.reshape(images.shape[0], -1)
    else:
        data = images.reshape(images.shape[0], 1,
                              images.shape[1], images.shape[2])
    data, labels = _shard([data, labels.astype(_np.float32)],
                          num_parts, part_index)
    if shuffle:
        rng = _np.random.RandomState(seed)
        perm = rng.permutation(data.shape[0])
        data, labels = data[perm], labels[perm]
    return NDArrayIter(data, labels, batch_size=batch_size,
                       shuffle=False, last_batch_handle="discard")


def _scan_record_offsets(path, begin, end):
    """Byte offsets of record starts in ``[begin, end)`` — headers only,
    payloads are seeked over, so the scan touches ~16 bytes/record and the
    whole-dataset RSS stays flat (parity: the dmlc chunked InputSplit the
    reference's parser scans, iter_image_recordio.cc:108-133).

    Uses the native chunked reader (src/recordio.cc: seek + magic resync)
    when built; the pure-python fallback walks headers from offset 0 and
    filters, which yields the identical partition (a record belongs to the
    part its first byte falls in).
    """
    from .libinfo import find_lib
    lib = find_lib()
    offsets = []
    if lib is not None:
        h = lib.MXTPURecordIOReaderCreate(path.encode(), begin,
                                          -1 if end is None else end)
        if not h:
            raise IOError("cannot open %s" % path)
        try:
            while True:
                pos = lib.MXTPURecordIOReaderTell(h)
                rc = lib.MXTPURecordIOReaderSkip(h)
                if rc == -1:
                    break
                if rc == -2:
                    raise IOError("corrupt RecordIO file %s" % path)
                offsets.append(pos)
        finally:
            lib.MXTPURecordIOReaderFree(h)
        return _np.asarray(offsets, dtype=_np.int64)
    import struct
    with open(path, "rb") as f:
        while True:
            pos = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            if magic != 0xced7230a:
                raise IOError("corrupt RecordIO file %s @%d" % (path, pos))
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            f.seek(length + ((4 - (length & 3)) & 3), 1)
            if cflag in (0, 1) and pos >= begin and (end is None or pos < end):
                offsets.append(pos)
    return _np.asarray(offsets, dtype=_np.int64)


class ImageRecordIter(DataIter):
    """Streaming image RecordIO iterator (parity: iter_image_recordio.cc
    ImageRecordIter + iter_prefetcher.h:45 PrefetcherIter).

    Pipeline, mirroring the reference's parser → batcher → prefetcher stack:

    - **index**: one cheap offset scan of this worker's byte range; the
      decoded dataset is never materialised (flat RSS on multi-GB files).
    - **shard**: ``num_parts``/``part_index`` split the *file byte range*
      and resync on record boundaries — the reference's seek-based protocol
      (iter_image_recordio.cc:108-133), so pod workers touch disjoint data.
    - **shuffle**: per-epoch permutation of record offsets (not arrays).
    - **decode pool**: each record is seek-read by a per-thread reader and
      JPEG-decoded + augmented by ``preprocess_threads`` workers of the
      dependency engine (src/engine.cc) — the analog of the reference's OMP
      decode loop (iter_image_recordio.cc:184-234).  Falls back to inline
      decode under NaiveEngine / pure-python builds.
    - **prefetch**: finished batches land in a bounded queue
      (``prefetch_buffer`` deep) so decode overlaps device compute.

    Each record's route is counted in ``decode_routes``: ``raw`` (an
    ``im2rec --pack-raw`` record: no decode), ``native`` (the libjpeg
    kernel of ``lib/libmxtpu.so``, which releases the GIL) or ``python``
    (cv2/PIL and :func:`.image.augment`: the options the native kernel
    lacks, non-JPEG records, or a library built without libjpeg).
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 mean_img=None, scale=1.0, rand_crop=False, rand_mirror=False,
                 num_parts=1, part_index=0, preprocess_threads=4,
                 prefetch_buffer=4, seed=0, round_batch=True,
                 max_rotate_angle=0, rotate=-1, min_random_scale=1.0,
                 max_random_scale=1.0, max_aspect_ratio=0.0,
                 max_shear_ratio=0.0, min_crop_size=-1, max_crop_size=-1,
                 min_img_size=0.0, max_img_size=1e10, pad=0, fill_value=255,
                 random_h=0, random_s=0, random_l=0,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", **kwargs):
        super().__init__()
        import os
        from .stream import has_scheme
        self._spool_path = None
        if has_scheme(path_imgrec):
            # remote record file (s3:// gs:// ...): spool locally once so
            # the native chunked offset scan + decode pool work on a real
            # fd.  Each worker spools its own copy; with num_parts sharding
            # the byte-range split still applies to the spooled file.
            import shutil
            import tempfile
            from .stream import open_uri
            fd, self._spool_path = tempfile.mkstemp(suffix=".rec")
            os.close(fd)
            with open_uri(path_imgrec, "rb") as src, \
                    open(self._spool_path, "wb") as dst:
                shutil.copyfileobj(src, dst)
            path_imgrec = self._spool_path
        self.path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.round_batch = round_batch
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = _np.dtype(dtype)
        assert self.dtype in (_np.float32, _np.uint8), \
            "ImageRecordIter dtype must be float32 or uint8"
        self._aug = dict(rand_crop=rand_crop, rand_mirror=rand_mirror,
                         max_rotate_angle=max_rotate_angle, rotate=rotate,
                         min_random_scale=min_random_scale,
                         max_random_scale=max_random_scale,
                         max_aspect_ratio=max_aspect_ratio,
                         max_shear_ratio=max_shear_ratio,
                         min_crop_size=min_crop_size,
                         max_crop_size=max_crop_size,
                         min_img_size=min_img_size,
                         max_img_size=max_img_size,
                         pad=pad, fill_value=fill_value,
                         random_h=random_h, random_s=random_s,
                         random_l=random_l)
        # the native kernel covers the default augmenter (scale/crop/mirror);
        # affine geometry (rotate/aspect/shear), crop-size, pad, and HSL
        # jitter route through the python augmenter
        self._native_aug_ok = (max_rotate_angle == 0 and rotate <= 0
                               and max_aspect_ratio == 0.0
                               and max_shear_ratio == 0.0
                               and min_crop_size <= 0
                               and max_crop_size <= 0
                               and min_img_size == 0.0
                               and max_img_size == 1e10 and pad == 0
                               and random_h == 0 and random_s == 0
                               and random_l == 0)
        # per-channel mean vector (native-kernel friendly) vs full mean image
        self._mean_vec = None
        self._mean_full = None
        if mean_img is not None:
            if not has_scheme(mean_img) and not os.path.isfile(mean_img):
                raise MXNetError("mean_img %r does not exist" % mean_img)
            from .ndarray import load as nd_load
            with cpu():
                loaded = nd_load(mean_img)
            arr = (loaded["mean_img"] if isinstance(loaded, dict)
                   else loaded[0]).asnumpy()
            self._mean_full = arr.astype(_np.float32)      # CHW
        elif mean_r or mean_g or mean_b:
            self._mean_vec = _np.ascontiguousarray(
                [mean_r, mean_g, mean_b][:self.data_shape[0]],
                dtype=_np.float32)
        self._scale = scale
        self._seed_base = seed * 131 + part_index
        self._rng = _np.random.RandomState(seed + part_index)
        self._raw_nbytes = int(_np.prod(self.data_shape))
        from .libinfo import find_lib
        self._native_lib = find_lib()

        size = os.path.getsize(path_imgrec)
        if num_parts > 1:
            begin = size * part_index // num_parts
            end = size * (part_index + 1) // num_parts
            if part_index == num_parts - 1:
                end = None
        else:
            begin, end = 0, None
        self._offsets = _scan_record_offsets(path_imgrec, begin, end)
        if self._offsets.size == 0:
            raise MXNetError("no records in %s part %d/%d"
                             % (path_imgrec, part_index, num_parts))

        # decode pool: dedicated engine so preprocess_threads is honored
        # independently of the global engine (reference: per-iterator OMP
        # thread count).  ThreadedEngine -> native worker pool; NaiveEngine
        # (no native lib / MXNET_ENGINE_TYPE override) -> inline decode.
        from . import engine as _engine
        self._engine = _engine.create(num_threads=max(1, preprocess_threads))
        self._threaded = not isinstance(self._engine, _engine.NaiveEngine)
        self._local = threading.local()
        #: records decoded by each route since construction
        self.decode_routes = {"raw": 0, "native": 0, "python": 0}
        self._routes_lock = threading.Lock()

        import queue as _queue
        self._queue = _queue.Queue(maxsize=max(1, int(prefetch_buffer)))
        self._gen = 0
        self._producer = None
        self._cur = None
        self._exhausted = False
        self._start_producer()

    # -- readers ----------------------------------------------------------
    def _reader(self):
        """Per-thread sequential reader handle (seek + read one record)."""
        r = getattr(self._local, "reader", None)
        if r is None:
            from . import recordio as rio
            r = rio.MXRecordIO(self.path_imgrec, "r")
            self._local.reader = r
        return r

    def _decode_into(self, offset, data, label, slot, epoch):
        from . import recordio as rio
        r = self._reader()
        r._seek_to(int(offset))
        rec = r.read()
        header, img_bytes = rio.unpack(rec)
        # per-record deterministic augmentation seed (no shared-RNG races)
        seed = (int(offset) * 2654435761 + epoch * 40503 + self._seed_base) \
            & 0xffffffff
        encoded = len(img_bytes) > 4 and (
            (img_bytes[0] == 0xFF and img_bytes[1] == 0xD8)      # JPEG SOI
            or img_bytes[:4] == b"\x89PNG")
        if len(img_bytes) == self._raw_nbytes and not encoded:
            # raw pre-decoded record (im2rec --pack-raw): uint8 CHW matching
            # data_shape exactly; no decode, no augmentation — the
            # full-rate path for pre-processed datasets
            raw = _np.frombuffer(img_bytes, dtype=_np.uint8).reshape(
                self.data_shape)
            route = "raw"
            if self.dtype == _np.uint8:
                data[slot] = raw
            else:
                img = raw.astype(_np.float32)
                if self._mean_vec is not None:
                    img -= self._mean_vec.reshape(-1, 1, 1)
                if self._mean_full is not None:
                    img -= self._mean_full
                if self._scale != 1.0:
                    img *= self._scale
                data[slot] = img
        elif self._decode_native(img_bytes, data, slot, seed):
            route = "native"
        else:
            self._decode_python(img_bytes, data, slot, seed)
            route = "python"
        with self._routes_lock:
            self.decode_routes[route] += 1
        lbl = _np.asarray(header.label, dtype=_np.float32).ravel()
        if self.label_width > 1:
            label[slot, :] = lbl[:self.label_width]
        else:
            label[slot] = lbl[0]

    def _decode_native(self, img_bytes, data, slot, seed):
        """One ctypes call: decode+augment+normalize with the GIL released
        (src/image.cc MXTPUDecodeAugment) — the engine's native workers
        scale linearly, unlike cv2/PIL whose decode holds the GIL."""
        lib = self._native_lib
        if lib is None or not self._native_aug_ok:
            return False
        if not (len(img_bytes) > 2 and img_bytes[0] == 0xFF
                and img_bytes[1] == 0xD8):
            return False                      # not JPEG (e.g. PNG): fallback
        import ctypes
        c, h, w = self.data_shape
        slot_view = data[slot]
        out_ptr = slot_view.ctypes.data_as(ctypes.c_void_p)
        is_u8 = self.dtype == _np.uint8
        mean_ptr = None
        if not is_u8 and self._mean_vec is not None:
            mean_ptr = self._mean_vec.ctypes.data_as(ctypes.c_void_p)
        # with a full mean image, normalization must stay (v - mean) * scale:
        # decode raw f32 natively, then subtract+scale in numpy
        defer_norm = (not is_u8) and self._mean_full is not None
        rc = lib.MXTPUDecodeAugment(
            img_bytes, len(img_bytes), c, h, w,
            1 if self._aug["rand_crop"] else 0,
            1 if self._aug["rand_mirror"] else 0,
            float(self._aug["min_random_scale"]),
            float(self._aug["max_random_scale"]),
            seed,
            None if is_u8 else out_ptr, out_ptr if is_u8 else None,
            mean_ptr,
            1.0 if (is_u8 or defer_norm) else float(self._scale))
        if rc != 0:
            return False
        if defer_norm:
            slot_view -= self._mean_full
            if self._scale != 1.0:
                slot_view *= self._scale
        return True

    def _decode_python(self, img_bytes, data, slot, seed):
        from .image import imdecode_bytes, augment
        img = imdecode_bytes(img_bytes,
                             iscolor=1 if self.data_shape[0] == 3 else 0)
        rng = _np.random.RandomState(seed)
        img = augment(img, self.data_shape, rng=rng, **self._aug)
        img = img.transpose(2, 0, 1)                       # HWC -> CHW
        if self.dtype == _np.uint8:
            data[slot] = img
            return
        img = img.astype(_np.float32)
        if self._mean_vec is not None:
            img -= self._mean_vec.reshape(-1, 1, 1)
        if self._mean_full is not None:
            img -= self._mean_full
        if self._scale != 1.0:
            img *= self._scale
        data[slot] = img

    # -- producer ---------------------------------------------------------
    # The producer thread holds the iterator only through a weakref: an
    # abandoned (dropped, non-exhausted) iterator is garbage-collected,
    # which makes wself() return None and the thread exit — no leaked
    # threads, engines, or prefetch buffers.
    _DISCARD_TAIL = object()

    @staticmethod
    def _put_weak(q, wself, gen, item):
        import queue as _queue
        while True:
            if _SHUTTING_DOWN:
                return False
            s = wself()
            if s is None or gen != s._gen:
                return False
            del s
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                pass

    def _make_batch(self, order, start, epoch):
        n, bs = order.size, self.batch_size
        idxs = order[start:start + bs]
        pad = bs - idxs.size
        if pad:
            if not self.round_batch and n >= bs:
                return ImageRecordIter._DISCARD_TAIL
            wrap = _np.resize(order, pad) if pad > n else order[:pad]
            idxs = _np.concatenate([idxs, wrap])
        lshape = (bs, self.label_width) if self.label_width > 1 else (bs,)
        data = _np.empty((bs,) + self.data_shape, self.dtype)
        label = _np.empty(lshape, _np.float32)
        if self._threaded:
            vars_ = [self._engine.new_variable() for _ in range(bs)]
            for slot, off in enumerate(idxs):
                self._engine.push(
                    _functools.partial(self._decode_into, off,
                                       data, label, slot, epoch),
                    mutable_vars=[vars_[slot]])
            for v in vars_:
                self._engine.wait_for_var(v)
                self._engine.delete_variable(v)
        else:
            for slot, off in enumerate(idxs):
                self._decode_into(off, data, label, slot, epoch)
        return (data, label, pad)

    @staticmethod
    def _produce(wself, gen, epoch):
        self = wself()
        if self is None:
            return
        q = self._queue
        try:
            order = self._offsets.copy()
            if self.shuffle:
                self._rng.shuffle(order)
            starts = list(range(0, order.size, self.batch_size))
            del self
            for start in starts:
                if _SHUTTING_DOWN:
                    return
                self = wself()
                if self is None or gen != self._gen:
                    return
                item = self._make_batch(order, start, epoch)
                del self
                if item is ImageRecordIter._DISCARD_TAIL:
                    break
                if not ImageRecordIter._put_weak(q, wself, gen, item):
                    return
            ImageRecordIter._put_weak(q, wself, gen, None)   # epoch end
        except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
            ImageRecordIter._put_weak(q, wself, gen, exc)

    def _start_producer(self):
        import weakref
        gen = self._gen
        self._epoch = getattr(self, "_epoch", -1) + 1
        self._producer = threading.Thread(
            target=ImageRecordIter._produce,
            args=(weakref.ref(self), gen, self._epoch), daemon=True)
        _register_producer(self._producer)
        self._producer.start()

    # -- DataIter protocol -------------------------------------------------
    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = ((self.batch_size, self.label_width) if self.label_width > 1
               else (self.batch_size,))
        return [DataDesc(self.label_name, shp)]

    @property
    def num_records(self):
        """Records in this worker's shard."""
        return int(self._offsets.size)

    def reset(self):
        import queue as _queue
        self._gen += 1
        while self._producer.is_alive():
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                self._producer.join(timeout=0.02)
        while True:
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                break
        self._exhausted = False
        self._start_producer()

    def iter_next(self):
        if self._exhausted:
            return False
        import queue as _queue_mod
        while True:
            try:
                item = self._queue.get(timeout=0.2)
                break
            except _queue_mod.Empty:
                if _SHUTTING_DOWN:      # interpreter exiting: unblock
                    self._exhausted = True
                    return False
        if item is None:
            self._exhausted = True
            return False
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        data, label, pad = item
        # host arrays, wrapped without a copy: each batch owns its buffers
        self._cur = DataBatch([NDArray(torch.from_numpy(data))],
                              [NDArray(torch.from_numpy(label))], pad=pad)
        return True

    def next(self):
        if self.iter_next():
            return self._cur
        raise StopIteration

    def getdata(self):
        return self._cur.data

    def getlabel(self):
        return self._cur.label

    def getpad(self):
        return self._cur.pad

    def __del__(self):
        try:
            self._gen += 1
        except Exception:
            pass
        spool = getattr(self, "_spool_path", None)
        if spool is not None:
            try:
                import os
                os.unlink(spool)
            except OSError:
                pass
