"""Networked coordination KV: pluggable backends + fault discipline.

The port's copy of ``mxnet_tpu/resilience/netkv.py``.  The on-disk
layout of :class:`FileKV` and the JSON-lines wire format of
:class:`TcpKV`/:class:`TcpKVServer` are the JAX package's, byte for
byte: a port replica heartbeats where a JAX router scans, and a port
client talks to a JAX ``mxkv serve``.

- :class:`CoordKV` -- the four-method client surface everything here
  codes against (the subset of a coordination service's client that the
  JAX package uses): ``key_value_set`` / ``blocking_key_value_get`` /
  ``key_value_dir_get`` / ``key_value_delete``.  Heartbeat stamping
  (``kvstore._start_heartbeat``), the dead scan
  (``kvstore.scan_dead_ranks``), the elastic verdict exchange and the
  hot-state source agreement all speak this surface, so a backend swap
  is a URL change, not a code change.
- :class:`FileKV` -- a directory of atomically-renamed files;
  ``allow_overwrite=False`` is atomic (``link(2)``), so it can carry
  the leader lease.
- :class:`TcpKV` / :class:`TcpKVServer` -- a small threaded JSON-lines
  TCP server (embeddable in a router process, standalone via
  ``python -m mxnet_tpu_torch.tools.mxkv serve``) and its client.
  Blocking gets are served by a condition variable, not polling;
  oversized values are rejected server-side (``MXTPU_KV_MAX_VALUE``).
- :class:`ResilientKV` -- the fault-discipline wrapper every caller
  should hold: per-op timeouts, exponential backoff with deterministic
  jitter bounded by a retry budget (``MXTPU_KV_RETRIES``), and a
  structured :class:`KVUnreachable` once the budget is spent.  "KV
  unreachable" is DISTINCT from "key absent" (:class:`KeyAbsent`) and
  from "rank stale": a scanner that cannot reach the KV holds its last
  verdict and never fabricates deaths.
- :func:`connect_kv` — backend selection by ``MXTPU_KV_URL``
  (``file:///path`` | ``tcp://host:port``), defaulting to the file
  layout ``<fleet dir>/kv`` when unset.

Fault injection (``MXTPU_FAULT_SPEC``, seam ``kv_op``): ``kv_partition``
fails every op for ``seconds`` (default 5), ``kv_flap`` alternates
fail/ok, ``kv_slow`` sleeps before the op.
"""
from __future__ import annotations

import json as _json
import os as _os
import socket as _socket
import threading as _threading
import time as _time

from . import ResilienceError
from ..base import collective_seam

__all__ = ["CoordKV", "FileKV", "TcpKV", "TcpKVServer", "ResilientKV",
           "Lease", "KVUnreachable", "KeyExists", "KeyAbsent",
           "connect_kv", "kv_url", "kv_timeout_s", "kv_retries",
           "kv_max_value_bytes"]


# ----------------------------------------------------------------------
# env knobs — read at call time so tests can
# monkeypatch the environment
# ----------------------------------------------------------------------
def kv_url(explicit=None):
    """``MXTPU_KV_URL``: coordination KV endpoint — ``file:///path``
    or ``tcp://host:port``.  None/unset: the caller's file-backend
    default (the ``<fleet dir>/kv`` layout)."""
    return explicit or _os.environ.get("MXTPU_KV_URL") or None


def kv_timeout_s(explicit=None):
    """``MXTPU_KV_TIMEOUT_S``: per-operation connect/read timeout
    (default 5 s)."""
    if explicit is not None:
        return float(explicit)
    try:
        return float(_os.environ.get("MXTPU_KV_TIMEOUT_S", "5"))
    except ValueError:
        return 5.0


def kv_retries(explicit=None):
    """``MXTPU_KV_RETRIES``: attempts per KV operation before
    :class:`KVUnreachable` (default 3)."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_KV_RETRIES", "3"))
    except ValueError:
        return 3


def kv_max_value_bytes(explicit=None):
    """``MXTPU_KV_MAX_VALUE``: server-side value-size cap in bytes
    (default 1 MiB).  The KV carries pointers and verdicts, never
    payloads — an oversized value is a bug, not a need."""
    if explicit is not None:
        return int(explicit)
    try:
        return int(_os.environ.get("MXTPU_KV_MAX_VALUE",
                                   str(1 << 20)))
    except ValueError:
        return 1 << 20


# ----------------------------------------------------------------------
# structured failures
# ----------------------------------------------------------------------
class KVUnreachable(ResilienceError):
    """The coordination KV did not answer within the retry budget.

    DISTINCT from staleness: a rank whose heartbeat stamp is old is
    dead; a KV that cannot be read says nothing about any rank.
    Callers hold their last verdict (within their grace window) and
    re-raise past it — they never translate this into deaths."""

    def __init__(self, message, op=None, attempts=0, timeout_s=None):
        self.op = op
        self.attempts = int(attempts)
        super().__init__(message, phase="kv:%s" % (op or "?"),
                         kind="kv_unreachable", timeout_s=timeout_s)


class KeyExists(ValueError):
    """``key_value_set(..., allow_overwrite=False)`` lost the race:
    the key is already set.  Subclasses ValueError, as the JAX
    package's does."""


class KeyAbsent(TimeoutError):
    """``blocking_key_value_get`` expired with the key never set.  A
    *semantic* timeout — the server answered, the key is not there —
    never retried and never confused with transport loss.  Subclasses
    TimeoutError, as the JAX package's does."""


# ----------------------------------------------------------------------
# the contract
# ----------------------------------------------------------------------
class CoordKV(object):
    """The coordination-client surface every backend implements:

    - ``key_value_set(key, value, allow_overwrite=True)`` —
      last-write-wins string set; ``allow_overwrite=False`` is an
      ATOMIC set-if-absent raising :class:`KeyExists` on conflict (the
      lease primitive).
    - ``blocking_key_value_get(key, timeout_ms)`` — wait until the key
      is set, raising :class:`KeyAbsent` at the deadline.
    - ``key_value_dir_get(prefix)`` — ``[(key, value), ...]`` for every
      key under ``prefix`` (the heartbeat scan).
    - ``key_value_delete(key)`` — idempotent delete.
    """

    def key_value_set(self, key, value, allow_overwrite=True):
        raise NotImplementedError

    def blocking_key_value_get(self, key, timeout_ms):
        raise NotImplementedError

    def key_value_dir_get(self, prefix):
        raise NotImplementedError

    def key_value_delete(self, key):
        raise NotImplementedError

    def close(self):
        """Release client resources (no-op for stateless backends)."""


# ----------------------------------------------------------------------
# FileKV: the coordination surface over a directory
# ----------------------------------------------------------------------
class FileKV(CoordKV):
    """File-backed key-value client over a directory.

    A serving fleet's replicas die and respawn under a long-lived
    router, so the coordination state must not live in any one process.
    A directory of atomically-renamed files gives the contract the
    heartbeat/dead-scan machinery needs (last-write-wins set, prefix
    scan, polling get).  Keys are URL-quoted into flat filenames, so the
    ``mxtpu_hb/<rank>`` keys the stamping thread writes need no
    translation.  ``allow_overwrite=False`` uses ``link(2)`` so two
    racing writers (lease takeover) serialize atomically.
    """

    def __init__(self, root):
        self.root = _os.fspath(root)
        _os.makedirs(self.root, exist_ok=True)

    def _fname(self, key):
        from urllib.parse import quote
        return _os.path.join(self.root, quote(key, safe=""))

    def key_value_set(self, key, value, allow_overwrite=True):
        path = self._fname(key)
        tmp = "%s.tmp.%d" % (path, _os.getpid())
        with open(tmp, "w") as fout:
            fout.write(str(value))
        if allow_overwrite:
            _os.rename(tmp, path)   # atomic: readers see old or new
            return
        try:
            # link(2) fails EEXIST atomically — no window between the
            # existence check and the publish for a racing writer
            _os.link(tmp, path)
        except FileExistsError:
            raise KeyExists("key %r already set" % key)
        finally:
            try:
                _os.unlink(tmp)
            except OSError:
                pass

    def key_value_dir_get(self, prefix):
        from urllib.parse import unquote
        out = []
        try:
            names = _os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if ".tmp" in name:
                continue
            key = unquote(name)
            if not key.startswith(prefix):
                continue
            try:
                with open(_os.path.join(self.root, name)) as fin:
                    out.append((key, fin.read()))
            except OSError:
                continue            # deleted between listdir and open
        return out

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = _time.monotonic() + timeout_ms / 1e3
        path = self._fname(key)
        while True:
            try:
                with open(path) as fin:
                    return fin.read()
            except OSError:
                if _time.monotonic() > deadline:
                    raise KeyAbsent("key %r not set within %d ms"
                                    % (key, timeout_ms))
                _time.sleep(0.02)

    def key_value_delete(self, key):
        try:
            _os.unlink(self._fname(key))
        except OSError:
            pass


# ----------------------------------------------------------------------
# TcpKV: the same surface over a JSON-lines TCP server
# ----------------------------------------------------------------------
class TcpKVServer(object):
    """Threaded JSON-lines KV server (the in-process ps-lite scheduler
    analog).  One request per line, one JSON reply per line; a
    connection may issue any number of requests.  Ops::

        {"op": "set",  "key": k, "value": v, "overwrite": bool}
        {"op": "get",  "key": k}                      -> immediate
        {"op": "bget", "key": k, "timeout_ms": t}     -> blocks
        {"op": "dir",  "prefix": p}                   -> [[k, v], ...]
        {"op": "del",  "key": k}
        {"op": "ping"}

    Replies are ``{"ok": true, ...}`` or ``{"ok": false, "kind":
    "exists" | "absent" | "too_big" | "bad_request", "error": ...}``.
    Blocking gets wait on a condition variable and wake on the set —
    no polling.  Values above ``MXTPU_KV_MAX_VALUE`` are rejected.

    ``partition(seconds)`` is the server-side chaos hook: every
    connection during the window is accepted and immediately dropped,
    which the client sees as transport loss — the drillable half of a
    network partition that an in-process fault spec cannot reach
    (the router under test is a separate process).
    """

    def __init__(self, host="127.0.0.1", port=0, max_value_bytes=None):
        self._data = {}
        self._lock = _threading.Lock()
        self._cv = _threading.Condition(self._lock)
        self._max_value = kv_max_value_bytes(max_value_bytes)
        self._stop = _threading.Event()
        self._threads = []
        self._accept_thread = None
        self._partition_until = 0.0
        self._sock = _socket.socket(_socket.AF_INET,
                                    _socket.SOCK_STREAM)
        self._sock.setsockopt(_socket.SOL_SOCKET,
                              _socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]

    @property
    def url(self):
        return "tcp://%s:%d" % (self.host, self.port)

    def start(self):
        """Start the accept loop in the background; returns self."""
        self._accept_thread = _threading.Thread(
            target=self._accept_loop, daemon=True, name="mxkv-accept")
        self._accept_thread.start()
        return self

    def serve_forever(self):
        """Foreground variant (``mxkv serve``): accept until
        :meth:`stop`."""
        self._accept_loop()

    def partition(self, seconds):
        """Chaos hook: drop every connection for ``seconds``."""
        with self._lock:
            self._partition_until = _time.monotonic() + float(seconds)

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()      # unblocks accept()
        except OSError:
            pass
        with self._cv:
            self._cv.notify_all()   # unblock parked bgets
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)

    # -- accept / serve ------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return              # socket closed by stop()
            with self._lock:
                partitioned = _time.monotonic() < self._partition_until
            if partitioned:
                try:
                    conn.close()    # transport loss, as the wire sees it
                except OSError:
                    pass
                continue
            t = _threading.Thread(target=self._serve_conn, args=(conn,),
                                  daemon=True, name="mxkv-conn")
            with self._lock:
                # drop finished handlers so a long-lived server doesn't
                # accumulate one Thread object per connection ever made
                self._threads = [x for x in self._threads
                                 if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn):
        try:
            conn.settimeout(300.0)
            buf = b""
            while not self._stop.is_set():
                nl = buf.find(b"\n")
                while nl < 0:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                    nl = buf.find(b"\n")
                line, buf = buf[:nl], buf[nl + 1:]
                if not line.strip():
                    continue
                try:
                    req = _json.loads(line.decode())
                    resp = self._handle(req)
                except Exception as exc:
                    resp = {"ok": False, "kind": "bad_request",
                            "error": repr(exc)}
                conn.sendall(_json.dumps(resp).encode() + b"\n")
        except OSError:
            pass                    # client went away mid-exchange
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- ops -----------------------------------------------------------

    def _handle(self, req):
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "keys": len(self._data)}
        if op == "set":
            key, value = req["key"], str(req.get("value", ""))
            if len(value.encode()) > self._max_value:
                return {"ok": False, "kind": "too_big",
                        "error": "value for %r exceeds %d bytes"
                                 % (key, self._max_value)}
            with self._cv:
                if not req.get("overwrite", True) \
                        and key in self._data:
                    return {"ok": False, "kind": "exists",
                            "error": "key %r already set" % key}
                self._data[key] = value
                self._cv.notify_all()
            return {"ok": True}
        if op == "get":
            with self._lock:
                if req["key"] in self._data:
                    return {"ok": True, "value": self._data[req["key"]]}
            return {"ok": False, "kind": "absent",
                    "error": "key %r not set" % req["key"]}
        if op == "bget":
            key = req["key"]
            timeout_ms = float(req.get("timeout_ms", 0))
            deadline = _time.monotonic() + timeout_ms / 1e3
            with self._cv:
                while key not in self._data:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        return {"ok": False, "kind": "absent",
                                "error": "key %r not set within %d ms"
                                         % (key, timeout_ms)}
                    self._cv.wait(min(remaining, 0.5))
                return {"ok": True, "value": self._data[key]}
        if op == "dir":
            prefix = req.get("prefix", "")
            with self._lock:
                items = [[k, v] for k, v in sorted(self._data.items())
                         if k.startswith(prefix)]
            return {"ok": True, "items": items}
        if op == "del":
            with self._lock:
                self._data.pop(req["key"], None)
            return {"ok": True}
        return {"ok": False, "kind": "bad_request",
                "error": "unknown op %r" % op}


class TcpKV(CoordKV):
    """Client for :class:`TcpKVServer` — one connection per operation,
    so no socket is ever shared across router threads (and no lock is
    ever held across a recv).  Transport failures (refused, reset,
    socket timeout) surface as ``ConnectionError`` — the cue
    :class:`ResilientKV` retries on — while semantic answers
    (:class:`KeyExists` / :class:`KeyAbsent` / oversized) raise exactly
    what :class:`FileKV` raises, keeping backend parity."""

    def __init__(self, host, port, timeout_s=None):
        self.host = host
        self.port = int(port)
        self.timeout = kv_timeout_s(timeout_s)

    def _roundtrip(self, doc, timeout_s=None):
        payload = _json.dumps(doc).encode() + b"\n"
        timeout = timeout_s if timeout_s is not None else self.timeout
        try:
            conn = _socket.create_connection(
                (self.host, self.port), timeout=timeout)
        except OSError as exc:
            raise ConnectionError(
                "kv %s:%d unreachable: %r" % (self.host, self.port,
                                              exc))
        try:
            try:
                conn.sendall(payload)
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        raise ConnectionError(
                            "kv %s:%d closed the connection"
                            % (self.host, self.port))
                    buf += chunk
            except ConnectionError:
                raise
            except OSError as exc:  # incl. socket timeout: transport
                raise ConnectionError(
                    "kv %s:%d i/o failed: %r" % (self.host, self.port,
                                                 exc))
        finally:
            try:
                conn.close()
            except OSError:
                pass
        resp = _json.loads(buf.decode())
        if resp.get("ok"):
            return resp
        kind = resp.get("kind")
        if kind == "exists":
            raise KeyExists(resp.get("error", "key already set"))
        if kind == "absent":
            raise KeyAbsent(resp.get("error", "key not set"))
        raise ValueError(resp.get("error", "kv request rejected"))

    def key_value_set(self, key, value, allow_overwrite=True):
        self._roundtrip({"op": "set", "key": key, "value": str(value),
                         "overwrite": bool(allow_overwrite)})

    def blocking_key_value_get(self, key, timeout_ms):
        # the server parks the request; the socket deadline must
        # outlive the semantic one or a long bget reads as a dead KV
        return self._roundtrip(
            {"op": "bget", "key": key, "timeout_ms": float(timeout_ms)},
            timeout_s=float(timeout_ms) / 1e3 + self.timeout)["value"]

    def key_value_dir_get(self, prefix):
        items = self._roundtrip({"op": "dir",
                                 "prefix": prefix})["items"]
        return [(k, v) for k, v in items]

    def key_value_delete(self, key):
        self._roundtrip({"op": "del", "key": key})

    def ping(self):
        """Round-trip liveness probe (``mxkv ping``)."""
        return self._roundtrip({"op": "ping"})


# ----------------------------------------------------------------------
# ResilientKV: the fault-discipline layer
# ----------------------------------------------------------------------
class ResilientKV(CoordKV):
    """Wrap any :class:`CoordKV` backend in the repo's KV fault
    discipline (module docstring): bounded retries with exponential
    backoff and deterministic jitter, then a structured
    :class:`KVUnreachable`.  Semantic answers (:class:`KeyExists`,
    :class:`KeyAbsent`, oversized-value ``ValueError``) pass straight
    through — only transport loss is retried.

    One ``kv_unreachable`` telemetry event is emitted per outage
    stretch (first exhaustion arms it; the next success re-arms), so a
    5 s partition is one line in the log, not one per health tick.

    The ``kv_op`` fault seam fires per attempt: ``kv_partition`` opens
    a fail-everything window of ``seconds``, ``kv_flap`` alternates
    fail/ok per call, ``kv_slow`` sleeps inside ``maybe_fault`` before
    the attempt proceeds.
    """

    def __init__(self, kv, timeout_s=None, retries=None, name=None):
        self.kv = kv
        self.name = name or type(kv).__name__
        self._timeout = kv_timeout_s(timeout_s)
        self._retries = kv_retries(retries)
        self._lock = _threading.Lock()
        self._flap_count = 0
        self._partition_until = 0.0
        self._down = False          # in an unreachable stretch?

    # -- fault seam ----------------------------------------------------

    def _maybe_inject(self, op):
        from .faultinject import maybe_fault
        spec = maybe_fault("kv_op")
        if spec is not None:
            if spec.kind == "kv_partition":
                window = spec.seconds if spec.seconds is not None \
                    else 5.0
                with self._lock:
                    self._partition_until = _time.monotonic() + window
            elif spec.kind == "kv_flap":
                with self._lock:
                    self._flap_count += 1
                    flap = self._flap_count % 2 == 1
                if flap:
                    raise ConnectionError(
                        "injected kv_flap at op=%s" % op)
            # kv_slow already slept inside maybe_fault
        with self._lock:
            partitioned = _time.monotonic() < self._partition_until
        if partitioned:
            raise ConnectionError("injected kv_partition at op=%s" % op)

    # -- the retry loop ------------------------------------------------

    def _delays(self):
        """Exponential backoff (retry.RetryPolicy semantics) plus a
        deterministic per-attempt jitter in [0, 50%) — decorrelated
        enough that N routers hammered by the same outage do not
        retry in lockstep, with no wall-clock/randomness so a failing
        drill replays exactly."""
        from .retry import RetryPolicy
        policy = RetryPolicy(max_tries=self._retries,
                             base_delay_s=0.05,
                             max_delay_s=max(self._timeout / 2, 0.05))
        for attempt, delay in enumerate(policy.delays(), 1):
            frac = ((attempt * 2654435761 + len(self.name)) % 512) \
                / 1024.0
            yield min(delay * (1.0 + frac), policy.max_delay_s)

    def _call(self, op, fn):
        delays = list(self._delays()) + [None]
        last_exc = None
        for delay in delays:
            try:
                self._maybe_inject(op)
                result = fn()
            except (KeyExists, KeyAbsent):
                raise               # semantic: the KV answered
            except OSError as exc:  # ConnectionError, timeouts, NFS
                last_exc = exc
                if delay is None:
                    break
                _time.sleep(delay)
                continue
            with self._lock:
                was_down, self._down = self._down, False
            if was_down:
                self._emit("kv_recovered", op, 0, None)
            return result
        with self._lock:
            first, self._down = not self._down, True
        if first:
            self._emit("kv_unreachable", op, len(delays), last_exc)
        raise KVUnreachable(
            "kv backend %s unreachable: %r" % (self.name, last_exc),
            op=op, attempts=len(delays), timeout_s=self._timeout)

    def _emit(self, fault, op, attempts, exc):
        try:
            from .. import observability as _obs
            _obs.emit("fault", fault=fault, op=op, backend=self.name,
                      attempts=attempts,
                      error=repr(exc) if exc else None)
        except Exception:
            pass

    # -- the surface ---------------------------------------------------

    def key_value_set(self, key, value, allow_overwrite=True):
        return self._call("set", lambda: self.kv.key_value_set(
            key, value, allow_overwrite=allow_overwrite))

    def blocking_key_value_get(self, key, timeout_ms):
        return self._call("bget", lambda: self.kv.blocking_key_value_get(
            key, timeout_ms))

    def key_value_dir_get(self, prefix):
        return self._call("dir",
                          lambda: self.kv.key_value_dir_get(prefix))

    def key_value_delete(self, key):
        return self._call("del",
                          lambda: self.kv.key_value_delete(key))

    def close(self):
        self.kv.close()


# ----------------------------------------------------------------------
# leader lease
# ----------------------------------------------------------------------
class Lease(object):
    """Expiring leader lease over any :class:`CoordKV` backend.

    The record is one JSON key ``{"holder", "expires"}`` (wall-clock
    expiry, ``ttl_s`` ahead).  :meth:`poll` runs one election step and
    returns whether THIS candidate currently leads:

    - absent/expired lease -> take it with an atomic set-if-absent
      (expired: delete first; the re-set still races atomically, so
      exactly one standby wins the takeover);
    - own lease -> renew once a third of the TTL has burned;
    - someone else's unexpired lease -> stand by.

    On :class:`KVUnreachable` an incumbent KEEPS leading until its own
    written expiry passes — the KV being down says nothing about the
    leader being down, and no standby can steal the lease through a
    partition either (same unreachable KV).  Past its own expiry it
    steps down: a healed partition may have elected someone else.

    Rank-uniform by construction — every candidate runs the same
    compare-and-take against the same key and acts only on the KV's
    one answer — which is what the ``@collective_seam`` certification
    on :meth:`poll` asserts for the MXL-D lint.
    """

    def __init__(self, kv, holder, ttl_s=3.0,
                 key="mxtpu_router/lease"):
        self.kv = kv
        self.holder = str(holder)
        self.ttl_s = float(ttl_s)
        self.key = key
        self.leading = False
        self._expires = 0.0         # our own written expiry
        self._takeovers = 0

    def _record(self, now):
        return _json.dumps({"holder": self.holder,
                            "expires": now + self.ttl_s})

    def _read(self):
        """Current lease record or None (absent)."""
        try:
            raw = self.kv.blocking_key_value_get(self.key, 50)
        except KeyAbsent:
            return None
        try:
            doc = _json.loads(raw)
            return {"holder": str(doc["holder"]),
                    "expires": float(doc["expires"])}
        except (ValueError, KeyError, TypeError):
            return None             # torn/garbage record: up for grabs

    def _take(self, now, had_record):
        """Atomic set-if-absent takeover; True when we won."""
        if had_record:
            self.kv.key_value_delete(self.key)
        try:
            self.kv.key_value_set(self.key, self._record(now),
                                  allow_overwrite=False)
        except KeyExists:
            return False            # a sibling won the race
        cur = self._read()          # confirm: delete+set can interleave
        if cur is None or cur["holder"] != self.holder:
            return False
        self.leading = True
        self._expires = cur["expires"]
        self._takeovers += 1
        return True

    @collective_seam
    def poll(self):
        """One election step; returns True while this candidate holds
        the lease."""
        now = _time.time()
        try:
            if self.leading:
                if now < self._expires - self.ttl_s / 3.0:
                    return True
                if now < self._expires:
                    self.kv.key_value_set(self.key, self._record(now),
                                          allow_overwrite=True)
                    self._expires = now + self.ttl_s
                    return True
                # our lease ran out un-renewed (we were paused or
                # partitioned past the TTL): a standby may have taken
                # over — never stomp its record; step down and
                # re-compete like any candidate
                self.leading = False
            cur = self._read()
            if cur is not None and cur["holder"] == self.holder:
                # our own record (e.g. a restart with the same id):
                # renew in place rather than waiting out our own TTL
                self.kv.key_value_set(self.key, self._record(now),
                                      allow_overwrite=True)
                self.leading = True
                self._expires = now + self.ttl_s
                return True
            if cur is None or cur["expires"] <= now:
                return self._take(now, had_record=cur is not None)
            return False
        except KVUnreachable:
            if self.leading and now < self._expires:
                return True         # hold within our own written lease
            self.leading = False
            return False

    def release(self):
        """Drop the lease (best-effort) so a standby takes over in one
        poll instead of one TTL."""
        was = self.leading
        self.leading = False
        if was:
            try:
                self.kv.key_value_delete(self.key)
            except Exception:
                pass

    def peek(self):
        """Current lease record ``{"holder", "expires"}`` or None —
        the leader hint routers put in stats and 409 bodies."""
        try:
            return self._read()
        except KVUnreachable:
            return None

    def stats(self):
        return {"holder": self.holder, "leading": self.leading,
                "ttl_s": self.ttl_s, "takeovers": self._takeovers}


# ----------------------------------------------------------------------
# backend selection
# ----------------------------------------------------------------------
def connect_kv(url=None, default_root=None, resilient=True,
               timeout_s=None, retries=None):
    """Resolve ``MXTPU_KV_URL`` (or ``url``) to a ready client.

    ``file:///path`` -> :class:`FileKV`; ``tcp://host:port`` ->
    :class:`TcpKV`; unset -> :class:`FileKV` on ``default_root`` (the
    caller's layout, e.g. ``<fleet dir>/kv``) so existing
    single-host fleets run unchanged.  ``resilient=True`` (the
    default, and the right call everywhere outside unit tests) wraps
    the backend in :class:`ResilientKV`.
    """
    url = kv_url(url)
    if url is None:
        if default_root is None:
            base_dir = _os.environ.get("MXTPU_FLEET_DIR") or \
                _os.path.join(_os.getcwd(), "mxtpu_fleet")
            default_root = _os.path.join(base_dir, "kv")
        base = FileKV(default_root)
    elif url.startswith("file://"):
        base = FileKV(url[len("file://"):] or "/")
    elif url.startswith("tcp://"):
        hostport = url[len("tcp://"):]
        host, _, port = hostport.partition(":")
        if not port:
            raise ValueError("MXTPU_KV_URL %r needs tcp://host:port"
                             % url)
        base = TcpKV(host or "127.0.0.1", int(port),
                     timeout_s=timeout_s)
    else:
        raise ValueError("MXTPU_KV_URL %r: want file://<path> or "
                         "tcp://<host>:<port>" % url)
    if not resilient:
        return base
    return ResilientKV(base, timeout_s=timeout_s, retries=retries)
