"""RecordIO: packed binary record files.

The port's copy of ``mxnet_tpu/recordio.py`` (the reference's
``python/mxnet/recordio.py`` + the dmlc-core RecordIO writer/reader it
wraps).  The on-disk format is the dmlc format, so record files are
interchangeable with the reference and with the JAX package, byte for
byte in both directions:

    [kMagic: uint32][lrec: uint32][data][pad to 4-byte boundary]
    lrec = (cflag << 29) | length; cflag 0=whole, 1=start, 2=middle, 3=end
    (continuation records let data contain the magic; assembled on read)

``pack``/``unpack`` implement the image-record header (``IRHeader``:
flag/label/id/id2, ``src/io/image_recordio.h``), with flag>0 meaning a
float-array label of that many entries.  A native C++ reader
(src/recordio.cc, loaded via ctypes) accelerates scans when built; this pure-python
implementation is the always-available fallback and the format oracle.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "unpack_img", "pack_img"]

_kMagic = 0xced7230a
_FMT_MAGIC_LREC = "<II"


def _encode_record(data):
    """Encode one logical record into the dmlc multi-part wire format."""
    out = []
    magic_bytes = struct.pack("<I", _kMagic)
    # split wherever the payload contains the magic sequence
    parts = data.split(magic_bytes)
    n = len(parts)
    for i, part in enumerate(parts):
        if n == 1:
            cflag = 0
        elif i == 0:
            cflag = 1
        elif i == n - 1:
            cflag = 3
        else:
            cflag = 2
        lrec = (cflag << 29) | len(part)
        out.append(struct.pack(_FMT_MAGIC_LREC, _kMagic, lrec))
        out.append(part)
        pad = (4 - (len(part) & 3)) & 3
        if pad:
            out.append(b"\x00" * pad)
    return b"".join(out)


class MXRecordIO(object):
    """Sequential reader/writer (parity: recordio.py:14 MXRecordIO).

    Uses the native reader/writer (src/recordio.cc via lib/libmxtpu.so)
    when available — same wire format, C-speed scan — with this python
    implementation as the fallback.
    """

    def __init__(self, uri, flag):
        from .stream import has_scheme
        self.uri = uri
        # remote URIs (s3:// gs:// memory:// ...) spool through a local
        # temp file: the native reader/writer needs a real fd (dmlc::Stream
        # parity — reference record files live on S3/HDFS transparently)
        self._remote_uri = uri if has_scheme(uri) else None
        self._spool = None
        self._spooled_down = False
        self.flag = flag
        self.handle = None
        self._native = None
        self._lib = None
        self.is_open = False
        self.open()

    def _try_native(self):
        from .libinfo import find_lib  # honors MXTPU_NO_NATIVE
        return find_lib()

    def _local_uri(self):
        """The path the (native) reader/writer actually opens."""
        if self._remote_uri is None:
            return self.uri
        if self._spool is None:
            import tempfile
            fd, self._spool = tempfile.mkstemp(suffix=".rec")
            os.close(fd)
        if self.flag == "r" and not self._spooled_down:
            import shutil
            from .stream import open_uri
            with open_uri(self._remote_uri, "rb") as src, \
                    open(self._spool, "wb") as dst:
                shutil.copyfileobj(src, dst)
            self._spooled_down = True
        return self._spool

    def open(self):
        lib = self._try_native()
        path = self._local_uri()
        if self.flag == "w":
            self.writable = True
            if lib is not None:
                h = lib.MXTPURecordIOWriterCreate(path.encode())
                if h:
                    self._lib, self._native = lib, h
                else:
                    raise IOError("cannot open %s for writing" % self.uri)
            else:
                self.handle = open(path, "wb")
        elif self.flag == "r":
            self.writable = False
            if lib is not None:
                h = lib.MXTPURecordIOReaderCreate(path.encode(), 0, -1)
                if h:
                    self._lib, self._native = lib, h
                else:
                    raise IOError("cannot open %s for reading" % self.uri)
            else:
                self.handle = open(path, "rb")
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._native is not None:
                if self.writable:
                    rc = self._lib.MXTPURecordIOWriterFree(self._native)
                    self._native = None
                    if rc != 0:
                        self.is_open = False
                        raise IOError("error closing %s (earlier write "
                                      "failed?)" % self.uri)
                else:
                    self._lib.MXTPURecordIOReaderFree(self._native)
                self._native = None
            if self.handle is not None:
                self.handle.close()
                self.handle = None
            self.is_open = False
            if self._remote_uri is not None and self.writable:
                # push the finished spool to the remote object
                import shutil
                from .stream import open_uri
                with open(self._spool, "rb") as src, \
                        open_uri(self._remote_uri, "wb") as dst:
                    shutil.copyfileobj(src, dst)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
        if self._spool is not None:
            try:
                os.unlink(self._spool)
            except OSError:
                pass
            self._spool = None

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        if self._native is not None:
            if self.writable:
                return self._lib.MXTPURecordIOWriterTell(self._native)
            return self._lib.MXTPURecordIOReaderTell(self._native)
        return self.handle.tell()

    def _seek_to(self, pos):
        assert not self.writable
        if self._native is not None:
            self._lib.MXTPURecordIOReaderSeek(self._native, pos)
        else:
            self.handle.seek(pos)

    def write(self, buf):
        assert self.writable
        if self._native is not None:
            if self._lib.MXTPURecordIOWriterWrite(self._native, buf,
                                                  len(buf)) != 0:
                raise IOError("write failed on %s (disk full?)" % self.uri)
            return
        self.handle.write(_encode_record(buf))

    def read(self):
        """Read one logical record; None at EOF."""
        assert not self.writable
        if self._native is not None:
            import ctypes
            n = self._lib.MXTPURecordIOReaderNext(self._native)
            if n == -1:
                return None
            if n == -2:
                raise IOError("Invalid/truncated RecordIO file %s"
                              % self.uri)
            ptr = self._lib.MXTPURecordIOReaderData(self._native)
            return ctypes.string_at(ptr, n)
        parts = []
        while True:
            head = self.handle.read(8)
            if len(head) < 8:
                if parts:
                    raise IOError("Truncated RecordIO file: EOF inside a "
                                  "multi-part record")
                return None
            magic, lrec = struct.unpack(_FMT_MAGIC_LREC, head)
            if magic != _kMagic:
                raise IOError("Invalid RecordIO magic at offset %d"
                              % (self.handle.tell() - 8))
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            data = self.handle.read(length)
            if len(data) < length:
                raise IOError("Truncated RecordIO record")
            pad = (4 - (length & 3)) & 3
            if pad:
                self.handle.read(pad)
            parts.append(data)
            if cflag == 0:
                return data
            if cflag == 3:
                return b"".join(_interleave_magic(parts))
            # cflag 1/2: continue reading


def _interleave_magic(parts):
    """Reassemble continuation parts: the split token was the magic bytes."""
    magic_bytes = struct.pack("<I", _kMagic)
    out = []
    for i, p in enumerate(parts):
        if i:
            out.append(magic_bytes)
        out.append(p)
    return out


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random-access record file via a ``.idx`` sidecar
    (parity: recordio.py:85 MXIndexedRecordIO; key \\t byte-offset lines)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def _idx_exists(self):
        from .stream import has_scheme
        if not has_scheme(self.idx_path):
            return os.path.isfile(self.idx_path)
        try:
            import fsspec
            fs, _, paths = fsspec.get_fs_token_paths(self.idx_path)
            return fs.exists(paths[0])
        except Exception:
            return False

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and self._idx_exists():
            from .stream import open_uri
            with open_uri(self.idx_path, "r") as fin:
                for line in fin:
                    if isinstance(line, bytes):
                        line = line.decode()
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            from .stream import open_uri
            with open_uri(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        self._seek_to(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + payload into one record payload (parity: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(flag=0)
        payload = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                              header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        payload = struct.pack(_IR_FORMAT, header.flag, 0.0,
                              header.id, header.id2) + label.tobytes()
    return payload + s


def unpack(s):
    """Unpack a record payload into (IRHeader, bytes) (parity: recordio.py unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack a packed image record to (header, HWC uint8 array)."""
    from .image import imdecode_bytes
    header, s = unpack(s)
    img = imdecode_bytes(s, iscolor=iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array into a record (parity: recordio.py pack_img)."""
    from .image import imencode
    buf = imencode(img, quality=quality, img_fmt=img_fmt)
    return pack(header, buf)
