"""The port's data iterators against the JAX package's, on the CPU.

``io.ImageRecordIter`` of both packages reads the same ``.rec`` files and
gives bitwise equal batches (data, label, pad) over whole epochs: raw
``im2rec --pack-raw`` records in uint8 and in float32 with ``mean_r/g/b``
and ``scale`` or a ``mean_img`` file; JPEG records through the native
libjpeg kernel (``rand_crop``, ``rand_mirror``, a seed) and through the
Python augmenter (``max_rotate_angle``); a seeded ``shuffle`` over two
epochs; ``num_parts=2``; ``round_batch`` on and off; ``label_width``.
The decode pool's size does not change a batch, ``reset()`` mid-epoch
restarts it, and an abandoned iterator's producer thread exits.
``MNISTIter``, ``CSVIter``, ``ResizeIter`` and ``PrefetchingIter`` are
held to the JAX package's in the same way.
"""
import gc
import gzip
import struct
import time
import weakref

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import libinfo as tlibinfo

SHAPE = (3, 16, 16)


def _write_raw(path, n, shape=SHAPE, seed=0):
    rng = np.random.RandomState(seed)
    w = jrio.MXRecordIO(path, "w")
    imgs = []
    for i in range(n):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        imgs.append(img)
        w.write(jrio.pack(jrio.IRHeader(0, float(i), i, 0),
                          img.tobytes()))
    w.close()
    return np.stack(imgs)


def _write_jpeg(path, n, hw=(20, 24), seed=1):
    rng = np.random.RandomState(seed)
    w = jrio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        w.write(jrio.pack(jrio.IRHeader(0, float(i), i, 0),
                          jimage.imencode(img, quality=90)))
    w.close()


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recs")
    raw = str(d / "raw.rec")
    jpeg = str(d / "jpeg.rec")
    pixels = _write_raw(raw, 37)
    _write_jpeg(jpeg, 21)
    mean = str(d / "mean.nd")
    jmx.nd.save(mean, {"mean_img": jmx.nd.array(
        np.random.RandomState(2).uniform(0, 255, SHAPE).astype(np.float32))})
    return {"raw": raw, "jpeg": jpeg, "pixels": pixels, "mean": mean}


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def _both(path, **kw):
    kw.setdefault("data_shape", SHAPE)
    kw.setdefault("batch_size", 8)
    return (tmx.io.ImageRecordIter(path_imgrec=path, **kw),
            jmx.io.ImageRecordIter(path_imgrec=path, **kw))


def _native_jpeg():
    """Does lib/libmxtpu.so carry the libjpeg kernel (the Makefile links
    it only where jpeglib.h is found)?"""
    import ctypes
    lib = tlibinfo.find_lib()
    if lib is None:
        return False
    enc = jimage.imencode(np.zeros((8, 8, 3), np.uint8))
    out = np.empty((3, 8, 8), np.uint8)
    return lib.MXTPUDecodeAugment(
        enc, len(enc), 3, 8, 8, 0, 0, 1.0, 1.0, 0, None,
        out.ctypes.data_as(ctypes.c_void_p), None, 1.0) == 0


CASES = {
    "raw_uint8": ("raw", dict(dtype="uint8")),
    "raw_float32_mean_scale": ("raw", dict(mean_r=123.7, mean_g=116.3,
                                           mean_b=103.5, scale=1 / 58.4)),
    "raw_mean_img": ("raw", dict(mean_img="mean", scale=0.5)),
    "raw_no_round_batch": ("raw", dict(dtype="uint8", round_batch=False)),
    "raw_shuffle": ("raw", dict(shuffle=True, seed=3, dtype="uint8")),
    "jpeg_native_crop_mirror": ("jpeg", dict(rand_crop=True,
                                             rand_mirror=True, seed=5)),
    "jpeg_native_uint8_mean": ("jpeg", dict(dtype="uint8", rand_crop=True)),
    "jpeg_python_rotate": ("jpeg", dict(max_rotate_angle=15, rand_crop=True,
                                        seed=7, mean_r=10.0, scale=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_jax(recs, case):
    """Two epochs (the second after ``reset``) bitwise the JAX
    package's; the port's batches are host arrays."""
    src, kw = CASES[case]
    kw = dict(kw)
    if "mean_img" in kw:
        kw["mean_img"] = recs["mean"]
    t, j = _both(recs[src], preprocess_threads=2, **kw)
    epochs = []
    for epoch in range(2):
        got, want = _epoch(t), _epoch(j)
        _same(got, want)
        epochs.append(got)
        t.reset()
        j.reset()
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    assert next(t).data[0].context == tmx.cpu()
    if src == "raw":
        assert t.decode_routes["native"] == t.decode_routes["python"] == 0
    elif "max_rotate_angle" in kw:
        assert t.decode_routes["native"] == 0
    elif _native_jpeg():
        assert t.decode_routes["python"] == 0 < t.decode_routes["native"]
    if case == "raw_uint8":
        data = np.concatenate([d for d, _, _ in got])
        np.testing.assert_array_equal(data[:37], recs["pixels"])
        np.testing.assert_array_equal(data[37:], recs["pixels"][:3])
        assert [p for _, _, p in got] == [0] * 4 + [3]
    if case == "raw_no_round_batch":
        assert len(got) == 4
    if case == "raw_shuffle":      # shuffled, and anew each epoch
        order = [np.concatenate([lab for _, lab, _ in e])[:37]
                 for e in epochs]
        assert sorted(order[0]) == list(range(37))
        assert not np.array_equal(order[0], np.arange(37))
        assert not np.array_equal(order[0], order[1])


@pytest.mark.parametrize("src", ["raw", "jpeg"])
def test_num_parts_match_jax_and_cover(recs, src):
    """Each byte-range part bitwise the JAX package's; the parts'
    labels are disjoint and together every record."""
    labels = []
    for part in range(2):
        t, j = _both(recs[src], num_parts=2, part_index=part,
                     round_batch=False, batch_size=1, rand_crop=True,
                     seed=4)
        got = _epoch(t)
        _same(got, _epoch(j))
        assert t.num_records == j.num_records
        labels.append({float(lab[0]) for _, lab, _ in got})
    n = 37 if src == "raw" else 21
    assert not labels[0] & labels[1]
    assert labels[0] | labels[1] == set(float(i) for i in range(n))


@pytest.mark.parametrize("src,kw", [("raw", dict(dtype="uint8")),
                                    ("jpeg", dict(rand_crop=True,
                                                  rand_mirror=True, seed=9))])
def test_decode_threads_do_not_change_batches(recs, src, kw):
    one = tmx.io.ImageRecordIter(path_imgrec=recs[src], data_shape=SHAPE,
                                 batch_size=8, preprocess_threads=1, **kw)
    four = tmx.io.ImageRecordIter(path_imgrec=recs[src], data_shape=SHAPE,
                                  batch_size=8, preprocess_threads=4, **kw)
    _same(_epoch(one), _epoch(four))


def test_reset_mid_epoch_and_label_width(recs, tmp_path):
    t = tmx.io.ImageRecordIter(path_imgrec=recs["raw"], data_shape=SHAPE,
                               batch_size=8, dtype="uint8",
                               prefetch_buffer=1)
    full = _epoch(t)
    t.reset()
    next(t)
    next(t)
    t.reset()
    _same(_epoch(t), full)
    path = str(tmp_path / "multi.rec")
    w = jrio.MXRecordIO(path, "w")
    for i in range(11):
        w.write(jrio.pack(jrio.IRHeader(4, np.arange(4, dtype=np.float32)
                                        + i, i, 0),
                          np.full(SHAPE, i, np.uint8).tobytes()))
    w.close()
    t, j = _both(path, batch_size=4, label_width=4)
    got = _epoch(t)
    _same(got, _epoch(j))
    assert got[0][1].shape == (4, 4)
    assert t.provide_label == j.provide_label


def test_abandoned_iterator_thread_exits(recs):
    """Dropping a non-exhausted iterator frees its producer thread (it
    holds the iterator only through a weakref)."""
    it = tmx.io.ImageRecordIter(path_imgrec=recs["jpeg"], data_shape=SHAPE,
                                batch_size=4, prefetch_buffer=1,
                                preprocess_threads=2)
    next(it)
    producer = it._producer
    ref = weakref.ref(it)
    del it
    deadline = time.time() + 10.0
    while time.time() < deadline and (ref() is not None
                                      or producer.is_alive()):
        gc.collect()
        time.sleep(0.05)
    assert ref() is None and not producer.is_alive()


def test_iterator_errors_match(recs, tmp_path):
    with pytest.raises(tmx.MXNetError, match="mean_img"):
        tmx.io.ImageRecordIter(path_imgrec=recs["raw"], data_shape=SHAPE,
                               batch_size=4, mean_img=str(tmp_path / "no"))
    empty = tmp_path / "empty.rec"
    empty.write_bytes(b"")
    with pytest.raises(tmx.MXNetError, match="no records"):
        tmx.io.ImageRecordIter(path_imgrec=str(empty), data_shape=SHAPE,
                               batch_size=4)


# ----------------------------------------------------------------------
# MNISTIter, CSVIter, ResizeIter, PrefetchingIter
# ----------------------------------------------------------------------
def _write_mnist(d, n=50, gz=False):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    ip, lp = str(d / ("img" + ext)), str(d / ("lbl" + ext))
    with op(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("kw", [dict(), dict(flat=True, shuffle=False),
                                dict(num_parts=2, part_index=1, seed=3),
                                dict(gz=True)])
def test_mnist_iter_matches_jax(tmp_path, kw):
    kw = dict(kw)
    ip, lp = _write_mnist(tmp_path, gz=kw.pop("gz", False))
    t = tmx.io.MNISTIter(image=ip, label=lp, batch_size=8, **kw)
    j = jmx.io.MNISTIter(image=ip, label=lp, batch_size=8, **kw)
    _same(_epoch(t), _epoch(j))


@pytest.mark.parametrize("kw", [dict(), dict(round_batch=False),
                                dict(num_parts=3, part_index=2)])
def test_csv_iter_matches_jax(tmp_path, kw):
    rng = np.random.RandomState(1)
    data = rng.randn(23, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(23.0), delimiter=",")
    args = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                label_csv=str(tmp_path / "l.csv"), batch_size=5, **kw)
    _same(_epoch(tmx.io.CSVIter(**args)), _epoch(jmx.io.CSVIter(**args)))


def test_resize_and_prefetching_iters_match_jax(recs):
    x = np.random.RandomState(3).randn(10, 4).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    t = tmx.io.ResizeIter(tmx.io.NDArrayIter(x, y, batch_size=3), 7)
    j = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, batch_size=3), 7)
    for _ in range(2):
        _same(_epoch(t), _epoch(j))
        t.reset()
        j.reset()
    t = tmx.io.PrefetchingIter(
        [tmx.io.ImageRecordIter(path_imgrec=recs["raw"], data_shape=SHAPE,
                                batch_size=8, dtype="uint8"),
         tmx.io.NDArrayIter(np.arange(37.0).reshape(37, 1), batch_size=8)],
        rename_data=[{"data": "img"}, {"data": "idx"}])
    j = jmx.io.PrefetchingIter(
        [jmx.io.ImageRecordIter(path_imgrec=recs["raw"], data_shape=SHAPE,
                                batch_size=8, dtype="uint8"),
         jmx.io.NDArrayIter(np.arange(37.0).reshape(37, 1), batch_size=8)],
        rename_data=[{"data": "img"}, {"data": "idx"}])
    assert [tuple(d) for d in t.provide_data] == \
        [tuple(d) for d in j.provide_data] == \
        [("img", (8,) + SHAPE), ("idx", (8, 1))]
    for _ in range(2):
        got = [[d.asnumpy() for d in b.data] for b in t]
        want = [[d.asnumpy() for d in b.data] for b in j]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        t.reset()
        j.reset()
    threads = list(t.prefetch_threads)
    t.close()
    j.close()
    # close() joins: its producers leave even when one was inside an
    # inner next() (the JAX package's close can leave it parked)
    assert threads and not any(th.is_alive() for th in threads)
