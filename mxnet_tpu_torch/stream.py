"""URI-aware streams: the dmlc::Stream role.

The port's copy of ``mxnet_tpu/stream.py``.

In the reference every file path is a ``dmlc::Stream`` URI, which is what
makes data and checkpoints cloud-capable (docs/how_to/cloud.md:84 trains
straight off S3).  Here any plain path keeps using builtin ``open``;
paths carrying a scheme (``s3://``, ``gs://``, ``hdfs://``, ``memory://``,
...) route through fsspec via :func:`open_uri`.  Consumers that need a
real local fd (the native RecordIO reader, ImageRecordIter's chunked
scan) spool remote objects through a temp file themselves — their spool
lifetimes outlive any ``with`` block (spools survive ``reset()`` and
upload on ``close()``), so no context-manager helper is offered here.

``file://`` is normalized to a plain local path.
"""
from __future__ import annotations

import re

__all__ = ["has_scheme", "open_uri"]

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.\-]*://")


def _strip_file(uri):
    return uri[len("file://"):] if uri.startswith("file://") else uri


def has_scheme(uri):
    """True when ``uri`` names a remote object (scheme other than file)."""
    uri = str(uri)
    return bool(_SCHEME_RE.match(uri)) and not uri.startswith("file://")


def _fs_open(uri, mode):
    import fsspec
    return fsspec.open(uri, mode).open()


def open_uri(uri, mode="rb"):
    """Open ``uri`` for streaming; local paths use builtin open."""
    uri = _strip_file(str(uri))
    if not has_scheme(uri):
        return open(uri, mode)
    return _fs_open(uri, mode)
