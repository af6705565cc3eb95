"""Live SLO engine: burn-rate alerting over the metrics registry.

The port's copy of ``mxnet_tpu/observability/sloengine.py`` (host code
only, unchanged): it reads the port's windowed :mod:`.metrics` registry
and writes its recommendations to the port's coordination KV (the
process group's TCP store, or the KV a caller passes, as ``mxfleet``
passes its router's).

:mod:`.slo` prices *committed* BENCH files after the fact; nothing in
the tree evaluated an objective **live**.  This module closes that gap:
it reads the windowed sketches in the :mod:`.metrics` registry,
computes multi-window burn rates, raises/clears tiered alerts with
hysteresis, and writes advisory scale recommendations to the
coordination KV — the structured signal the (future) autoscaling
controller will consume.  Today mxtop observes them; nobody acts.

**Spec grammar** — ``MXTPU_SLO_SPEC`` is either inline spec(s) or a
path to a file of one spec per line (``#`` comments).  A spec is
colon-separated ``key=value`` pairs, specs separated by ``;``::

    metric=mxtpu_serve_latency_ms:target=250:budget=0.01

- ``metric``    histogram name in the registry (required)
- ``target``    objective threshold in metric units (required) —
  "a good event is a sample <= target"
- ``budget``    allowed bad-event fraction (default 0.01, i.e. 99%)
- ``page``      page-tier burn multiple (default 14)
- ``ticket``    ticket-tier burn multiple (default 2)
- ``fast``/``slow``          page window pair, seconds (default the
  two smallest configured windows: slow=60, fast=10)
- ``tfast``/``tslow``        ticket window pair (default the next
  pair up: tslow=300, tfast=60)
- ``clear``     hysteresis clear ratio (default 0.5): an active alert
  clears only after ``hold`` consecutive evaluations with every
  windowed burn below ``tier_threshold * clear``
- ``hold``      consecutive clear evaluations required (default 3)
- ``min_n``     minimum window sample count before a verdict (default
  10; thin windows neither fire nor clear — no verdicts from noise)

**Burn-rate math** (Google SRE Workbook multi-window multi-burn-rate):
``burn(w) = bad_fraction(w) / budget`` where ``bad_fraction`` counts
sketch samples above ``target`` in window ``w``.  A tier fires when
**both** its windows burn past its multiple — the long window proves
the spend is real, the short window proves it is *still happening*
(and makes recovery clear fast).  ``burn == 1`` means spending exactly
the budget; 14x over a 1%-budget objective pages because the error
budget would be gone within hours.

**Outputs**

- structured ``slo_alert`` events (fire and clear edges, flight-ring
  automatic like every emit),
- generation-stamped ``recommend_grow`` / ``recommend_shrink`` records
  under ``mxtpu_slo/`` in the coordination KV (schema:
  docs/observability.md "Live metrics & SLO engine") — advisory only,
- a JSON-able :meth:`SloEngine.state` snapshot mxtop renders.

Every clock the engine reads is injectable (``evaluate(now=...)``), so
the burn-rate matrix in tests is fully deterministic.
"""
from __future__ import annotations

import json
import os
import threading

from . import events
from . import metrics as _metrics

__all__ = ["SloSpec", "SloEngine", "parse_specs", "engine",
           "reset_engine", "maybe_start", "SLO_PREFIX"]

#: coordination-KV prefix for scale recommendations
SLO_PREFIX = "mxtpu_slo/"

_DEFAULTS = dict(budget=0.01, page=14.0, ticket=2.0, clear=0.5,
                 hold=3, min_n=10)


class SloSpec(object):
    """One parsed objective (see module docstring for the grammar)."""

    __slots__ = ("metric", "target", "budget", "page", "ticket",
                 "fast", "slow", "tfast", "tslow", "clear", "hold",
                 "min_n")

    def __init__(self, metric, target, budget=None, page=None,
                 ticket=None, fast=None, slow=None, tfast=None,
                 tslow=None, clear=None, hold=None, min_n=None):
        self.metric = str(metric)
        self.target = float(target)
        self.budget = float(_DEFAULTS["budget"] if budget is None
                            else budget)
        if not 0.0 < self.budget < 1.0:
            raise ValueError("budget must be in (0,1): %r" % budget)
        self.page = float(_DEFAULTS["page"] if page is None else page)
        self.ticket = float(_DEFAULTS["ticket"] if ticket is None
                            else ticket)
        wins = _metrics.windows()
        self.fast = int(fast) if fast is not None else wins[0]
        self.slow = int(slow) if slow is not None \
            else (wins[1] if len(wins) > 1 else wins[0] * 6)
        self.tfast = int(tfast) if tfast is not None else self.slow
        self.tslow = int(tslow) if tslow is not None \
            else (wins[2] if len(wins) > 2 else self.slow * 5)
        self.clear = float(_DEFAULTS["clear"] if clear is None
                           else clear)
        self.hold = int(_DEFAULTS["hold"] if hold is None else hold)
        self.min_n = int(_DEFAULTS["min_n"] if min_n is None
                         else min_n)

    def windows(self):
        return sorted({self.fast, self.slow, self.tfast, self.tslow})

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return "SloSpec(%s<=%g, budget=%g)" % (self.metric,
                                               self.target, self.budget)


def _parse_one(blob):
    kv = {}
    for part in blob.strip().split(":"):
        if not part:
            continue
        if "=" not in part:
            raise ValueError("bad SLO spec token %r in %r"
                             % (part, blob))
        key, _, val = part.partition("=")
        kv[key.strip()] = val.strip()
    if "metric" not in kv or "target" not in kv:
        raise ValueError("SLO spec needs metric= and target=: %r"
                         % blob)
    num = {k: float(v) for k, v in kv.items() if k != "metric"}
    return SloSpec(metric=kv["metric"], **num)


def parse_specs(raw=None):
    """``MXTPU_SLO_SPEC`` (or ``raw``) -> [SloSpec].  A value naming an
    existing file is read as one spec per line; inline values hold
    ``;``-separated specs.  Unset/empty -> []."""
    raw = raw if raw is not None else os.environ.get("MXTPU_SLO_SPEC")
    if not raw:
        return []
    raw = raw.strip()
    if os.path.isfile(raw):
        with open(raw) as fin:
            lines = [ln.strip() for ln in fin
                     if ln.strip() and not ln.strip().startswith("#")]
        return [_parse_one(ln) for ln in lines]
    return [_parse_one(blob) for blob in raw.split(";")
            if blob.strip()]


class _TierState(object):
    """Hysteresis ledger for one (spec, tier)."""

    __slots__ = ("active", "clear_streak", "fired_at", "last_burns")

    def __init__(self):
        self.active = False
        self.clear_streak = 0
        self.fired_at = None
        self.last_burns = {}


class SloEngine(object):
    """Continuous evaluator: call :meth:`evaluate` at poll cadence (or
    :meth:`start` a daemon thread that does).  All state transitions
    emit ``slo_alert`` events; page-tier fires write ``recommend_grow``
    and sustained idle writes ``recommend_shrink``.
    """

    #: burn level below which a window counts toward the idle streak
    IDLE_BURN = 0.1
    #: consecutive idle evaluations before a shrink recommendation
    IDLE_HOLD = 6

    def __init__(self, specs=None, reg=None, kv=None, source=None):
        self.specs = list(specs) if specs is not None else parse_specs()
        self._reg = reg
        self._kv = kv
        self.source = source or "sloengine"
        self._gen = 0
        self._tiers = {}         # (metric, tier) -> _TierState
        self._idle = {}          # metric -> consecutive idle evals
        self._last_alert = None
        self._last_reco = None
        self._evals = 0
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()

    # -- plumbing ------------------------------------------------------
    @property
    def registry(self):
        return self._reg or _metrics.registry()

    def _kv_client(self):
        if self._kv is not None:
            return self._kv
        from . import aggregate
        return aggregate._client()

    def _burn(self, spec, window_s, now):
        """(burn rate, sample count) over one window, or (None, n)
        when the window is too thin for a verdict."""
        hist = None
        for h in self.registry.histograms(spec.metric):
            hist = h
            break
        if hist is None:
            return None, 0
        sk = hist.window_sketch(window_s, now=now)
        if sk.count < spec.min_n:
            return None, sk.count
        bad = sk.count_above(spec.target) / float(sk.count)
        return bad / spec.budget, sk.count

    # -- evaluation ----------------------------------------------------
    def evaluate(self, now=None):
        """One evaluation pass over every spec.  Returns the list of
        alert event dicts emitted this pass (fires AND clears)."""
        import time as _t
        now = _t.time() if now is None else float(now)
        emitted = []
        with self._lock:
            self._evals += 1
            for spec in self.specs:
                emitted.extend(self._eval_spec(spec, now))
        return emitted

    def _eval_spec(self, spec, now):
        out = []
        burns = {}
        for w in spec.windows():
            burn, n = self._burn(spec, w, now)
            burns[w] = {"burn": burn, "n": n}
        for tier, mult, pair in (
                ("page", spec.page, (spec.slow, spec.fast)),
                ("ticket", spec.ticket, (spec.tslow, spec.tfast))):
            st = self._tiers.setdefault((spec.metric, tier),
                                        _TierState())
            pair_burns = [burns[w]["burn"] for w in pair]
            st.last_burns = {str(w): burns[w]["burn"] for w in pair}
            if any(b is None for b in pair_burns):
                continue         # thin window: no verdict either way
            breach = all(b >= mult for b in pair_burns)
            if breach and not st.active:
                st.active = True
                st.clear_streak = 0
                st.fired_at = now
                alert = self._emit_alert(
                    spec, tier, "fire", pair, pair_burns, mult, now)
                out.append(alert)
                if tier == "page":
                    self._recommend(spec, "recommend_grow", alert, now)
            elif st.active:
                cleared = all(b < mult * spec.clear
                              for b in pair_burns)
                if cleared:
                    st.clear_streak += 1
                    if st.clear_streak >= spec.hold:
                        st.active = False
                        st.clear_streak = 0
                        out.append(self._emit_alert(
                            spec, tier, "clear", pair, pair_burns,
                            mult, now))
                else:
                    st.clear_streak = 0
        # idle tracking: sustained near-zero burn on the slow window
        # with real traffic -> the fleet is oversized for the load
        slow = burns.get(spec.tslow) or burns.get(spec.slow) or {}
        page_active = self._tiers[(spec.metric, "page")].active
        ticket_active = self._tiers[(spec.metric, "ticket")].active
        if (slow.get("burn") is not None
                and slow["burn"] <= self.IDLE_BURN
                and not page_active and not ticket_active):
            self._idle[spec.metric] = self._idle.get(spec.metric, 0) + 1
            if self._idle[spec.metric] == self.IDLE_HOLD:
                self._recommend(spec, "recommend_shrink", {
                    "metric": spec.metric, "tier": "idle",
                    "burns": {str(spec.tslow): slow.get("burn")},
                }, now)
        else:
            self._idle[spec.metric] = 0
        return out

    # -- outputs -------------------------------------------------------
    def _emit_alert(self, spec, tier, edge, pair, pair_burns, mult,
                    now):
        alert = {"metric": spec.metric, "tier": tier, "edge": edge,
                 "target": spec.target, "budget": spec.budget,
                 "threshold_burn": mult,
                 "windows_s": list(pair),
                 "burns": {str(w): round(b, 3)
                           for w, b in zip(pair, pair_burns)},
                 "at": now, "source": self.source}
        self._last_alert = alert
        events.emit("slo_alert", **alert)
        events.flush()
        return alert

    def _recommend(self, spec, action, evidence, now):
        """Write one generation-stamped advisory scale record under
        ``mxtpu_slo/``.  KV unreachable -> skip silently (advice is
        droppable; the hold-the-verdict discipline belongs to readers,
        and fabricating staleness here would be worse than silence)."""
        self._gen += 1
        reason = ("page-tier burn %s over %ss/%ss windows"
                  % (evidence.get("burns"), spec.slow, spec.fast)
                  if action == "recommend_grow" else
                  "burn <= %g for %d evaluations"
                  % (self.IDLE_BURN, self.IDLE_HOLD))
        rec = {"action": action, "gen": self._gen,
               "metric": spec.metric, "target": spec.target,
               "budget": spec.budget, "reason": reason,
               "evidence": evidence, "at": now,
               "source": self.source}
        self._last_reco = rec
        events.emit("counter", name="slo_recommendation", **rec)
        try:
            client = self._kv_client()
            if client is not None:
                blob = json.dumps(rec, default=str, sort_keys=True,
                                  separators=(",", ":"))
                client.key_value_set(
                    "%sreco-%s-%05d" % (SLO_PREFIX, spec.metric,
                                        self._gen),
                    blob, allow_overwrite=True)
                client.key_value_set(SLO_PREFIX + "latest",
                                     blob, allow_overwrite=True)
        except Exception:
            pass
        return rec

    # -- views ---------------------------------------------------------
    def state(self, now=None):
        """JSON-able snapshot for mxtop's SLO pane: per-spec objective,
        current windowed burns, tier states, last alert/reco."""
        import time as _t
        now = _t.time() if now is None else float(now)
        specs = []
        with self._lock:
            for spec in self.specs:
                burns = {}
                for w in spec.windows():
                    burn, n = self._burn(spec, w, now)
                    burns[str(w)] = {
                        "burn": None if burn is None
                        else round(burn, 3), "n": n}
                tiers = {}
                for tier in ("page", "ticket"):
                    st = self._tiers.get((spec.metric, tier))
                    tiers[tier] = {
                        "active": bool(st and st.active),
                        "clear_streak": st.clear_streak if st else 0}
                specs.append({"metric": spec.metric,
                              "target": spec.target,
                              "budget": spec.budget,
                              "burns": burns, "tiers": tiers})
            return {"specs": specs, "evals": self._evals,
                    "last_alert": self._last_alert,
                    "last_recommendation": self._last_reco}

    # -- background loop ----------------------------------------------
    def start(self, interval_s=None):
        """Poll :meth:`evaluate` on a daemon thread (idempotent)."""
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get("MXTPU_SLO_INTERVAL_S", "2"))
            except ValueError:
                interval_s = 2.0
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(interval_s,), daemon=True,
                name="mxtpu-sloengine")
            self._thread.start()
        return self

    def _run(self, interval_s):
        while not self._stop.wait(interval_s):
            try:
                self.evaluate()
            except Exception:    # advisory tier: never kill the host
                pass

    def stop(self):
        self._stop.set()
        t = self._thread
        self._thread = None      # mxl: thread-shared-ok (MXL-Q001)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)


_ENGINE = {"eng": None}


def engine():
    """The process SloEngine singleton (specs from the environment)."""
    if _ENGINE["eng"] is None:
        _ENGINE["eng"] = SloEngine()
    return _ENGINE["eng"]


def reset_engine():
    eng = _ENGINE["eng"]
    if eng is not None:
        eng.stop()
    _ENGINE["eng"] = None


def maybe_start(source=None, kv=None):
    """Server-door seam: when ``MXTPU_SLO_SPEC`` names objectives,
    start the background evaluator and return it; else None.  Called
    by mxserve/mxfleet at serve start."""
    specs = parse_specs()
    if not specs:
        return None
    eng = engine()
    if source:
        eng.source = source
    if kv is not None:
        eng._kv = kv
    eng.specs = specs
    return eng.start()
