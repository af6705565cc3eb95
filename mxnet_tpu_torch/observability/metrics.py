"""Live metrics: mergeable quantile sketches, typed instruments, and
time-windowed rollups behind one process registry.

The port's copy of ``mxnet_tpu/observability/metrics.py`` (host code
only, unchanged).

The percentile math everywhere else in the tree (``counters.percentile``
over a raw-sample deque, the per-replica ``_lat`` lists in
``serving.telemetry``) cannot be combined exactly: averaging per-rank
p95s is not a pod p95, and a 512-sample window forgets the tail under
load.  This module replaces the raw lists with a **relative-error
log-bucketed quantile sketch** (the DDSketch construction):

- **Bounded memory.**  Samples land in geometrically-spaced buckets
  (``gamma = (1+alpha)/(1-alpha)``); six orders of magnitude of values
  at the default ``alpha = 0.01`` occupy ~700 buckets of one integer
  each, independent of sample count.
- **Relative-error guarantee.**  Any quantile estimate ``q̂`` of a true
  value ``q`` satisfies ``|q̂ - q| <= alpha * q``.
- **Exact associative merge.**  Merging adds integer bucket counts, so
  ``merge(a, merge(b, c)) == merge(merge(a, b), c)`` and a merge of N
  per-replica sketches yields **bit-identical quantiles** to one sketch
  fed the concatenated stream — the property pod/fleet rollups rely on
  (quantiles depend only on bucket counts and the bucket->value map,
  never on float-summation order).
- **Deterministic serialization.**  ``to_json`` emits sorted compact
  JSON, so equal sketches serialize to equal bytes (content-hashable,
  diffable across ranks).

On top of the sketch sit the typed instruments (:class:`Counter`
monotone, :class:`Gauge` set-or-callback, :class:`Histogram`
sketch-backed) and the :class:`MetricsRegistry` every producer feeds
(``serving.telemetry.emit_batch``, ``counters.StepStats``, the fleet
router).  A histogram additionally keeps a **time-windowed ring** of
per-slot sketches: the windows named by ``MXTPU_METRICS_WINDOWS``
(default ``10,60,300,3600`` seconds) are answered by merging ring slots
— aggregation by sketch-merge, never by re-sampling — which is what
the SLO engine's burn rates (:mod:`.sloengine`) read.

``render_prometheus`` serializes the registry in the Prometheus text
exposition format for the ``GET /metrics`` doors on ``mxserve`` and
``mxfleet serve``; ``parse_prometheus`` is the matching tolerant reader
(``mxtop --watch``, the CI scrape smoke).
"""
from __future__ import annotations

import json
import math
import os
import threading

__all__ = ["QuantileSketch", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "registry", "reset_registry", "windows",
           "render_prometheus", "parse_prometheus",
           "DEFAULT_ALPHA", "DEFAULT_WINDOWS"]

DEFAULT_ALPHA = 0.01
#: rollup horizons (seconds) when MXTPU_METRICS_WINDOWS is unset
DEFAULT_WINDOWS = (10, 60, 300, 3600)

#: bucket-count ceiling.  At alpha=0.01 six orders of magnitude span
#: ~690 buckets, so the default never collapses in practice — which is
#: what keeps the merge bit-identity guarantee unconditional; collapse
#: (lowest keys fold together) only exists as a runaway backstop.
_MAX_BUCKETS = 4096


def windows(raw=None):
    """The configured rollup horizons, ascending: parse
    ``MXTPU_METRICS_WINDOWS`` (comma-separated seconds) or fall back to
    :data:`DEFAULT_WINDOWS`.  Bad entries are dropped, not fatal."""
    raw = raw if raw is not None \
        else os.environ.get("MXTPU_METRICS_WINDOWS")
    if not raw:
        return tuple(DEFAULT_WINDOWS)
    out = []
    for part in str(raw).replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            val = int(float(part))
        except ValueError:
            continue
        if val > 0:
            out.append(val)
    return tuple(sorted(set(out))) or tuple(DEFAULT_WINDOWS)


class QuantileSketch(object):
    """Relative-error log-bucketed quantile sketch (DDSketch family).

    ``add`` is the hot call: one ``log``, one dict increment.  Values
    land in bucket ``ceil(log_gamma(v))`` and are estimated at the
    bucket midpoint ``2 * gamma^key / (gamma + 1)``, which bounds the
    relative error by ``alpha``.  Negative values mirror into a
    separate key space; exact zeros get their own counter (log-space
    buckets cannot represent 0).
    """

    __slots__ = ("alpha", "gamma", "_lg", "max_buckets", "buckets",
                 "neg_buckets", "zero", "count", "total", "min", "max")

    def __init__(self, alpha=DEFAULT_ALPHA, max_buckets=_MAX_BUCKETS):
        if not 0.0 < alpha < 1.0:
            raise ValueError("alpha must be in (0, 1): %r" % (alpha,))
        self.alpha = float(alpha)
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._lg = math.log(self.gamma)
        self.max_buckets = int(max_buckets)
        self.buckets = {}        # key -> int count (positive values)
        self.neg_buckets = {}    # key -> int count (abs of negatives)
        self.zero = 0
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    # -- ingest --------------------------------------------------------
    def _key(self, mag):
        return int(math.ceil(math.log(mag) / self._lg))

    def add(self, value, count=1):
        value = float(value)
        count = int(count)
        if count <= 0 or value != value:      # drop NaN, non-positive n
            return
        if value == 0.0:
            self.zero += count
        elif value > 0.0:
            key = self._key(value)
            self.buckets[key] = self.buckets.get(key, 0) + count
        else:
            key = self._key(-value)
            self.neg_buckets[key] = self.neg_buckets.get(key, 0) + count
        self.count += count
        self.total += value * count
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if len(self.buckets) > self.max_buckets:
            self._collapse(self.buckets)
        if len(self.neg_buckets) > self.max_buckets:
            self._collapse(self.neg_buckets)

    def extend(self, values):
        for v in values:
            self.add(v)
        return self

    @staticmethod
    def _collapse(buckets):
        """Runaway backstop: fold the two lowest keys together.  Never
        reached under the default alpha/max_buckets pairing."""
        lo = sorted(buckets)[:2]
        if len(lo) == 2:
            buckets[lo[1]] += buckets.pop(lo[0])

    # -- merge ---------------------------------------------------------
    def merge(self, other):
        """Fold ``other`` into self.  Integer bucket addition — exact,
        associative, commutative; quantiles of the merge are
        bit-identical to quantiles of the concatenated stream."""
        if other is None or other.count == 0:
            return self
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("cannot merge sketches with different "
                             "alpha (%g vs %g)" % (self.alpha,
                                                   other.alpha))
        for key, n in other.buckets.items():
            self.buckets[key] = self.buckets.get(key, 0) + n
        for key, n in other.neg_buckets.items():
            self.neg_buckets[key] = self.neg_buckets.get(key, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.total += other.total
        for attr, fn in (("min", min), ("max", max)):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, theirs if mine is None
                    else (mine if theirs is None else fn(mine, theirs)))
        return self

    @classmethod
    def merged(cls, sketches):
        """A fresh sketch folding every sketch in ``sketches``."""
        sketches = [s for s in sketches if s is not None]
        if not sketches:
            return cls()
        out = cls(alpha=sketches[0].alpha,
                  max_buckets=sketches[0].max_buckets)
        for s in sketches:
            out.merge(s)
        return out

    # -- query ---------------------------------------------------------
    def _value_of(self, key):
        return 2.0 * math.exp(key * self._lg) / (self.gamma + 1.0)

    def quantile(self, q):
        """The q-quantile estimate (``q`` in [0, 1]), or None when
        empty.  Deterministic: depends only on bucket counts, so equal
        bucket contents always answer equal values."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        rank = q * (self.count - 1)
        cum = 0
        # order: negatives (most negative first), zeros, positives
        for key in sorted(self.neg_buckets, reverse=True):
            cum += self.neg_buckets[key]
            if cum > rank:
                return -self._value_of(key)
        cum += self.zero
        if cum > rank:
            return 0.0
        for key in sorted(self.buckets):
            cum += self.buckets[key]
            if cum > rank:
                return self._value_of(key)
        return self._value_of(max(self.buckets)) if self.buckets \
            else self.max

    def percentile(self, pct):
        return self.quantile(float(pct) / 100.0)

    def mean(self):
        return self.total / self.count if self.count else None

    def count_above(self, threshold):
        """Samples strictly above ``threshold`` — the burn-rate
        numerator.  Counted whole-bucket: a bucket is "above" when its
        estimate exceeds the threshold, so the answer is deterministic
        and merge-stable."""
        threshold = float(threshold)
        n = 0
        if threshold < 0.0:
            n += self.zero
            n += sum(self.buckets.values())
            for key, c in self.neg_buckets.items():
                if -self._value_of(key) > threshold:
                    n += c
            return n
        for key, c in self.buckets.items():
            if self._value_of(key) > threshold:
                n += c
        return n

    # -- serialization -------------------------------------------------
    def to_dict(self):
        """Compact JSON-able form.  Keys sorted at the json layer; the
        float fields round-trip via repr so deserialize(serialize(s))
        is bit-identical."""
        out = {"a": self.alpha, "n": self.count, "z": self.zero,
               "s": self.total,
               "b": {str(k): v for k, v in self.buckets.items()}}
        if self.neg_buckets:
            out["nb"] = {str(k): v for k, v in self.neg_buckets.items()}
        if self.min is not None:
            out["lo"], out["hi"] = self.min, self.max
        return out

    def to_json(self):
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, doc):
        if not isinstance(doc, dict) or "a" not in doc:
            return None
        sk = cls(alpha=float(doc["a"]))
        sk.count = int(doc.get("n") or 0)
        sk.zero = int(doc.get("z") or 0)
        sk.total = float(doc.get("s") or 0.0)
        sk.buckets = {int(k): int(v)
                      for k, v in (doc.get("b") or {}).items()}
        sk.neg_buckets = {int(k): int(v)
                          for k, v in (doc.get("nb") or {}).items()}
        if doc.get("lo") is not None:
            sk.min = float(doc["lo"])
            sk.max = float(doc["hi"])
        return sk

    @classmethod
    def from_json(cls, raw):
        try:
            return cls.from_dict(json.loads(raw))
        except (ValueError, TypeError):
            return None

    def __len__(self):
        return self.count

    def __repr__(self):
        return ("QuantileSketch(n=%d, p50=%s, p95=%s)"
                % (self.count, self.quantile(0.5), self.quantile(0.95)))


# ----------------------------------------------------------------------
# typed instruments
# ----------------------------------------------------------------------
class Counter(object):
    """Monotone counter.  ``inc`` only; a decrement is a bug."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name, help="", labels=None):
        self.name = name
        self.help = help
        self.labels = labels or {}
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge(object):
    """Point-in-time value: ``set`` it, or construct with ``fn`` and it
    is polled at render/read time (queue depths, lease state)."""

    __slots__ = ("name", "help", "labels", "_value", "_fn")

    def __init__(self, name, help="", labels=None, fn=None):
        self.name = name
        self.help = help
        self.labels = labels or {}
        self._value = 0.0
        self._fn = fn

    def set(self, v):
        self._value = float(v)  # mxl: thread-shared-ok (MXL-Q001)

    @property
    def value(self):
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return self._value
        return self._value


class Histogram(object):
    """Sketch-backed distribution with a time-windowed ring.

    ``observe`` feeds (a) the cumulative sketch — the whole-process
    distribution the Prometheus summary renders — and (b) the current
    ring slot.  ``window_sketch(seconds, now)`` answers a horizon by
    merging the slots inside it: rollup by sketch-merge, so a 5m window
    IS the exact union of its 10s slots.  Slot width is the smallest
    configured window; ring length covers the largest.
    """

    __slots__ = ("name", "help", "labels", "alpha", "cumulative",
                 "windows", "slot_s", "_slots", "_nslots", "_lock")

    def __init__(self, name, help="", labels=None, alpha=DEFAULT_ALPHA,
                 windows_s=None):
        self.name = name
        self.help = help
        self.labels = labels or {}
        self.alpha = float(alpha)
        self.windows = tuple(windows_s) if windows_s else windows()
        self.slot_s = max(1, int(self.windows[0]))
        self._nslots = max(2, int(self.windows[-1] // self.slot_s) + 1)
        self.cumulative = QuantileSketch(alpha=self.alpha)
        self._slots = {}         # slot id -> QuantileSketch
        self._lock = threading.Lock()

    def observe(self, value, now=None):
        import time as _t
        now = _t.time() if now is None else float(now)
        slot = int(now // self.slot_s)
        with self._lock:
            self.cumulative.add(value)
            sk = self._slots.get(slot)
            if sk is None:
                sk = self._slots[slot] = QuantileSketch(alpha=self.alpha)
                floor = slot - self._nslots
                for sid in [s for s in self._slots if s <= floor]:
                    del self._slots[sid]
            sk.add(value)

    def window_sketch(self, seconds, now=None):
        """Merged sketch of every sample in the last ``seconds``."""
        import time as _t
        now = _t.time() if now is None else float(now)
        slot = int(now // self.slot_s)
        # every slot intersecting [now - seconds, now] — may over-cover
        # by up to one slot width at the old edge, never under-cover
        first = int((now - float(seconds)) // self.slot_s)
        with self._lock:
            picks = [sk for sid, sk in self._slots.items()
                     if first <= sid <= slot]
        return QuantileSketch.merged(picks)

    def snapshot(self, now=None):
        """JSON-able view: cumulative quantiles + per-window counts and
        p95s (what mxtop's SLO pane and /metrics windows render)."""
        with self._lock:
            cum = QuantileSketch.merged([self.cumulative])
        out = {"count": cum.count, "sum": cum.total,
               "p50": cum.quantile(0.5), "p95": cum.quantile(0.95),
               "p99": cum.quantile(0.99), "windows": {}}
        for w in self.windows:
            sk = self.window_sketch(w, now=now)
            out["windows"][str(w)] = {"count": sk.count,
                                      "p95": sk.quantile(0.95)}
        return out


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
def _label_key(labels):
    return tuple(sorted((labels or {}).items()))


class MetricsRegistry(object):
    """The process-wide instrument table.  ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent per (name, labels)), so
    producers never coordinate instrument construction."""

    def __init__(self):
        self._instruments = {}   # (name, label items) -> instrument
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is not None:
            return inst
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, help=help, labels=labels, **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name, help="", labels=None):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None, fn=None):
        g = self._get(Gauge, name, help, labels)
        if fn is not None:
            g._fn = fn           # late-bound callback wins
        return g

    def histogram(self, name, help="", labels=None,
                  alpha=DEFAULT_ALPHA, windows_s=None):
        return self._get(Histogram, name, help, labels, alpha=alpha,
                         windows_s=windows_s)

    def instruments(self):
        with self._lock:
            return sorted(self._instruments.values(),
                          key=lambda i: (i.name, _label_key(i.labels)))

    def find(self, name, labels=None):
        return self._instruments.get((name, _label_key(labels)))

    def histograms(self, name=None):
        return [i for i in self.instruments()
                if isinstance(i, Histogram)
                and (name is None or i.name == name)]

    def snapshot(self, now=None):
        """Flat JSON-able dump (debug door / tests)."""
        out = {}
        for inst in self.instruments():
            key = inst.name
            if inst.labels:
                key += "{%s}" % ",".join(
                    "%s=%s" % kv for kv in _label_key(inst.labels))
            if isinstance(inst, Histogram):
                out[key] = inst.snapshot(now=now)
            else:
                out[key] = inst.value
        return out


_REGISTRY = {"reg": None}


def registry():
    """The process MetricsRegistry singleton."""
    if _REGISTRY["reg"] is None:
        _REGISTRY["reg"] = MetricsRegistry()
    return _REGISTRY["reg"]


def reset_registry():
    """Drop the singleton (tests)."""
    _REGISTRY["reg"] = None


def exposition_enabled():
    """``MXTPU_METRICS`` gates the HTTP /metrics doors (default on —
    the registry itself always exists; only exposition is toggled)."""
    raw = os.environ.get("MXTPU_METRICS", "1").strip().lower()
    return raw not in ("0", "false", "off", "no")


# ----------------------------------------------------------------------
# Prometheus text exposition
# ----------------------------------------------------------------------
def _prom_labels(labels, extra=None):
    items = list(_label_key(labels))
    if extra:
        items += list(sorted(extra.items()))
    if not items:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, str(v).replace('"', '\\"')) for k, v in items)


def _prom_num(v):
    if v is None:
        return "NaN"
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


def render_prometheus(reg=None, now=None):
    """The registry in the Prometheus text exposition format.

    Counters/gauges render as single samples; histograms render as a
    summary (``{quantile="0.5|0.95|0.99"}`` + ``_count``/``_sum`` from
    the cumulative sketch) plus per-window p95 gauges
    (``<name>_window{window="60"}``) so the scrape carries the same
    horizons the SLO engine evaluates.
    """
    reg = reg or registry()
    lines = []
    seen_meta = set()
    for inst in reg.instruments():
        name = inst.name
        if isinstance(inst, Counter):
            if name not in seen_meta:
                seen_meta.add(name)
                if inst.help:
                    lines.append("# HELP %s %s" % (name, inst.help))
                lines.append("# TYPE %s counter" % name)
            lines.append("%s%s %s" % (name, _prom_labels(inst.labels),
                                      _prom_num(inst.value)))
        elif isinstance(inst, Gauge):
            if name not in seen_meta:
                seen_meta.add(name)
                if inst.help:
                    lines.append("# HELP %s %s" % (name, inst.help))
                lines.append("# TYPE %s gauge" % name)
            lines.append("%s%s %s" % (name, _prom_labels(inst.labels),
                                      _prom_num(inst.value)))
        elif isinstance(inst, Histogram):
            if name not in seen_meta:
                seen_meta.add(name)
                if inst.help:
                    lines.append("# HELP %s %s" % (name, inst.help))
                lines.append("# TYPE %s summary" % name)
            cum = inst.cumulative
            for q in (0.5, 0.95, 0.99):
                lines.append("%s%s %s" % (
                    name,
                    _prom_labels(inst.labels, {"quantile": "%g" % q}),
                    _prom_num(cum.quantile(q))))
            lines.append("%s_count%s %d" % (
                name, _prom_labels(inst.labels), cum.count))
            lines.append("%s_sum%s %s" % (
                name, _prom_labels(inst.labels), _prom_num(cum.total)))
            for w in inst.windows:
                sk = inst.window_sketch(w, now=now)
                lines.append("%s_window%s %s" % (
                    name,
                    _prom_labels(inst.labels,
                                 {"window": str(w), "quantile": "0.95"}),
                    _prom_num(sk.quantile(0.95))))
    return "\n".join(lines) + "\n"


def parse_prometheus(text):
    """Tolerant reader for the text format: ``[(name, labels, value)]``.
    Skips comments and malformed lines rather than raising — the shape
    ``mxtop --watch`` and the CI scrape smoke consume."""
    out = []
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            metric, raw_val = line.rsplit(None, 1)
        except ValueError:
            continue
        labels = {}
        name = metric
        if "{" in metric and metric.endswith("}"):
            name, _, blob = metric.partition("{")
            for pair in blob[:-1].split(","):
                if "=" not in pair:
                    continue
                k, _, v = pair.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        try:
            value = float(raw_val)
        except ValueError:
            continue
        out.append((name, labels, value))
    return out
