"""The port's RecordIO, image, engine, stream and im2rec against the JAX
package, on the CPU.

Record files written by either package are read by the other, bytes and
headers equal, for ``MXRecordIO`` and ``MXIndexedRecordIO``, on the
native reader/writer (``lib/libmxtpu.so``, one binary for both packages)
and on the Python route (``MXTPU_NO_NATIVE=1``); the files themselves are
byte for byte equal.  ``image``'s decode, encode, resize and augmenter,
``nd.imdecode``, the record-offset scan, the dependency engine and the
``im2rec`` tool are each held to the JAX package's on the same inputs,
exactly.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import image as jimage
from mxnet_tpu import libinfo as jlibinfo
from mxnet_tpu import recordio as jrio
from mxnet_tpu import stream as jstream
from mxnet_tpu.io import _scan_record_offsets as j_scan

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import libinfo as tlibinfo
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch import stream as tstream
from mxnet_tpu_torch.io import _scan_record_offsets as t_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jrio, "port": trio}
MAGIC = np.uint32(0xced7230a).tobytes()


def _payloads(n=23, seed=0):
    """Record payloads of assorted lengths (0 to 300 bytes, every
    residue mod 4), some holding the RecordIO magic inside (written as
    continuation records)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        body = rng.randint(0, 256, rng.randint(0, 300)).astype(np.uint8)
        body = body.tobytes()
        if i % 5 == 2:
            body = body[:7] + MAGIC + body[7:] + MAGIC
        out.append(trio.pack(trio.IRHeader(0, float(i), i, 0), body))
    return out


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """The native reader/writer, or the Python one (both packages read
    ``MXTPU_NO_NATIVE`` on every call)."""
    if request.param == "python":
        monkeypatch.setenv("MXTPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("MXTPU_NO_NATIVE", raising=False)
        if tlibinfo.find_lib() is None:
            pytest.fail("the native library did not build (make, g++)")
    return request.param


def test_both_packages_load_one_library():
    assert tlibinfo._LIB_PATH == jlibinfo._LIB_PATH
    assert tlibinfo.find_lib() is not None
    assert tlibinfo.find_lib()._name == jlibinfo.find_lib()._name


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_recordio_files_cross_read(tmp_path, route, writer, reader):
    recs = _payloads()
    paths = {}
    for name, rio in PKGS.items():
        paths[name] = str(tmp_path / ("%s.rec" % name))
        w = rio.MXRecordIO(paths[name], "w")
        for r in recs:
            w.write(r)
        w.close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    r = PKGS[reader].MXRecordIO(paths[writer], "r")
    got = []
    while True:
        rec = r.read()
        if rec is None:
            break
        got.append(rec)
    r.close()
    assert got == recs
    for rec, want in zip(got, recs):
        gh, gs = PKGS[reader].unpack(rec)
        wh, ws = jrio.unpack(want)
        assert tuple(gh) == tuple(wh) and gs == ws


def test_indexed_recordio_cross_read(tmp_path, route):
    recs = _payloads(12, seed=1)
    for name, rio in PKGS.items():
        w = rio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")),
                                  str(tmp_path / (name + ".rec")), "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 3, r)
        w.close()
    for ext in (".idx", ".rec"):
        assert (tmp_path / ("jax" + ext)).read_bytes() == \
            (tmp_path / ("port" + ext)).read_bytes()
    for writer, reader in (("jax", trio), ("port", jrio)):
        r = reader.MXIndexedRecordIO(str(tmp_path / (writer + ".idx")),
                                     str(tmp_path / (writer + ".rec")), "r")
        assert r.keys == [i * 3 for i in range(len(recs))]
        for i in (7, 0, 11, 4):
            assert r.read_idx(i * 3) == recs[i]
        r.close()


@pytest.mark.parametrize("label", [3.0, [1.5, -2.0, 7.0]])
def test_pack_unpack_match(label):
    header = (0, label, 17, 5)
    a = trio.pack(header, b"payload")
    assert a == jrio.pack(header, b"payload")
    (th, ts), (jh, js) = trio.unpack(a), jrio.unpack(a)
    assert ts == js == b"payload"
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


def _image(seed=0, hw=(20, 24)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,), np.uint8)


def test_pack_img_and_codecs_match():
    img = _image()
    for fmt in (".jpg", ".png"):
        enc = timage.imencode(img, img_fmt=fmt)
        assert enc == jimage.imencode(img, img_fmt=fmt)
        np.testing.assert_array_equal(timage.imdecode_bytes(enc),
                                      jimage.imdecode_bytes(enc))
        np.testing.assert_array_equal(timage.imdecode_bytes(enc, iscolor=0),
                                      jimage.imdecode_bytes(enc, iscolor=0))
    rec = trio.pack_img((0, 4.0, 1, 0), img, quality=90)
    assert rec == jrio.pack_img((0, 4.0, 1, 0), img, quality=90)
    (th, ti), (jh, ji) = trio.unpack_img(rec), jrio.unpack_img(rec)
    assert th.label == jh.label == 4.0
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(timage.imresize(img, 31, 9),
                                  jimage.imresize(img, 31, 9))


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True),
    dict(max_rotate_angle=20, fill_value=0),
    dict(max_shear_ratio=0.2, max_aspect_ratio=0.3, rand_crop=True),
    dict(min_random_scale=0.8, max_random_scale=1.3, pad=2),
    dict(min_crop_size=8, max_crop_size=14, rand_crop=True),
    dict(random_h=20, random_s=30, random_l=25, rand_mirror=True),
])
def test_augment_matches(kw):
    img = _image(3, (28, 30))
    for seed in (0, 1, 2):
        got = timage.augment(img, (3, 16, 16),
                             rng=np.random.RandomState(seed), **kw)
        want = jimage.augment(img, (3, 16, 16),
                              rng=np.random.RandomState(seed), **kw)
        np.testing.assert_array_equal(got, want)


def test_imdecode_matches():
    img = _image(5)
    enc = jimage.imencode(img)
    with tmx.cpu():
        got = tmx.nd.imdecode(enc)
        mean = tmx.nd.array(np.full((3, 20, 24), 3.5, np.float32))
        got_m = tmx.nd.imdecode(enc, clip_rect=(2, 3, 12, 15), mean=mean)
        out = tmx.nd.zeros((1, 3, 20, 24))
        tmx.nd.imdecode(enc, out=out)
    want = jmx.nd.imdecode(enc).asnumpy()
    assert got.shape == (1, 3, 20, 24) and got.asnumpy().dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(out.asnumpy(), want)
    want_m = jmx.nd.imdecode(enc, clip_rect=(2, 3, 12, 15),
                             mean=jmx.nd.array(np.full((3, 20, 24), 3.5,
                                                       np.float32)))
    np.testing.assert_array_equal(got_m.asnumpy(), want_m.asnumpy())


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_offset_scan_matches(tmp_path, route, parts):
    """Each byte-range part resyncs on record boundaries the same way;
    the parts are disjoint and together every record."""
    path = str(tmp_path / "s.rec")
    w = jrio.MXRecordIO(path, "w")
    for r in _payloads(31, seed=2):
        w.write(r)
    w.close()
    size = os.path.getsize(path)
    seen = []
    for i in range(parts):
        begin = size * i // parts
        end = None if i == parts - 1 else size * (i + 1) // parts
        got = t_scan(path, begin, end)
        np.testing.assert_array_equal(got, j_scan(path, begin, end))
        seen.extend(got.tolist())
    assert len(seen) == len(set(seen)) == 31


@pytest.mark.parametrize("kind", ["ThreadedEngine", "NaiveEngine"])
def test_engine_orders_like_jax(kind):
    """The same pushes (a write, then reads and writes of two vars) give
    the same history on both packages' engines; a pushed exception comes
    back from wait_for_all (NaiveEngine runs the push inline)."""
    def run(mod):
        eng = mod.create(kind, num_threads=3)
        assert type(eng).__name__ == kind
        a, b = eng.new_variable(), eng.new_variable()
        hist, lock = [], threading.Lock()

        def op(tag):
            def f():
                with lock:
                    hist.append(tag)
            return f
        eng.push(op("w1"), mutable_vars=[a])
        eng.push(op("w2"), const_vars=[a], mutable_vars=[b])
        eng.push(op("w3"), const_vars=[b], mutable_vars=[a])
        eng.push(op("w4"), const_vars=[a, b], mutable_vars=[a])
        eng.wait_for_var(a)
        with pytest.raises(ZeroDivisionError):    # Naive: at the push
            eng.push(lambda: 1 / 0, mutable_vars=[b])
            eng.wait_for_all()
        eng.delete_variable(a)
        return hist
    assert run(tengine) == run(jengine) == ["w1", "w2", "w3", "w4"]


def test_stream_matches(tmp_path):
    for uri in ("a/b.rec", "file:///x/y.rec", "s3://bucket/k.rec",
                "memory://m/n", "C:/x"):
        assert tstream.has_scheme(uri) == jstream.has_scheme(uri)
    p = tmp_path / "f.bin"
    p.write_bytes(b"abc")
    with tstream.open_uri("file://" + str(p)) as f:
        assert f.read() == b"abc"
    pytest.importorskip("fsspec")
    with tstream.open_uri("memory://torch-port/t.rec", "wb") as f:
        f.write(b"xyz")
    with jstream.open_uri("memory://torch-port/t.rec") as f:
        assert f.read() == b"xyz"


def test_remote_recordio_through_fsspec(route):
    """A record file at a memory:// URI, written by the port (spooled
    through a local file), reads back in the JAX package."""
    pytest.importorskip("fsspec")
    recs = _payloads(5, seed=4)
    uri = "memory://torch-port/%s.rec" % route
    w = trio.MXRecordIO(uri, "w")
    for r in recs:
        w.write(r)
    w.close()
    r = jrio.MXRecordIO(uri, "r")
    assert [r.read() for _ in recs] == recs and r.read() is None


def _image_tree(root, n=6):
    """An image directory of two classes and its .lst file."""
    from PIL import Image
    rows = []
    for i in range(n):
        d = root / ("c%d" % (i % 2))
        d.mkdir(exist_ok=True)
        Image.fromarray(_image(10 + i, (40, 36))).save(d / ("%d.png" % i))
        rows.append("%d\t%d\tc%d/%d.png\n" % (i, i % 2, i % 2, i))
    (root / "imgs.lst").write_text("".join(rows))
    return str(root / "imgs.lst")


@pytest.mark.parametrize("flags", [["--pack-raw", "3", "32", "32"],
                                   ["--quality", "90", "--pack-index"]])
def test_im2rec_matches_jax_tool(tmp_path, flags):
    """``python -m mxnet_tpu_torch.tools.im2rec`` writes the same bytes
    as ``tools/im2rec.py``; a --pack-raw file feeds the JAX
    ImageRecordIter."""
    pytest.importorskip("PIL")
    lst = _image_tree(tmp_path)
    outs = {}
    for name, cmd in (("port", [sys.executable, "-m",
                                "mxnet_tpu_torch.tools.im2rec"]),
                      ("jax", [sys.executable,
                               os.path.join(ROOT, "tools", "im2rec.py")])):
        prefix = str(tmp_path / name)
        res = subprocess.run(cmd + [prefix, str(tmp_path), "--list", lst]
                             + flags, cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs[name] = prefix
    for ext in (".rec",) + ((".idx",) if "--pack-index" in flags else ()):
        with open(outs["port"] + ext, "rb") as a, \
                open(outs["jax"] + ext, "rb") as b:
            assert a.read() == b.read()
    if "--pack-raw" in flags:
        it = jmx.io.ImageRecordIter(path_imgrec=outs["port"] + ".rec",
                                    data_shape=(3, 32, 32), batch_size=6,
                                    dtype="uint8", preprocess_threads=1)
        b = next(it)
        assert b.data[0].shape == (6, 3, 32, 32)
        np.testing.assert_array_equal(b.label[0].asnumpy(),
                                      [0, 1, 0, 1, 0, 1])
