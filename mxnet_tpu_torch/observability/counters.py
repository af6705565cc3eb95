"""Derived training counters: throughput, step-time EMA + percentiles,
MFU, loss-scale/sentinel state.

The port of ``mxnet_tpu/observability/counters.py``.  One
:class:`StepStats` per process folds host step timings into the numbers
an operator reads (EMA, p50/p95, samples/sec); :func:`emit_trainer_counters`
prices a trainer's step against the card's peak
(``ShardedTrainer.compiled_step_cost_analysis()`` counts the step's model
FLOPs from the bound graph's shapes) and :func:`emit_sentinel_counters`
reports ``ShardedTrainer.sentinel_stats()``.

Peaks come from :data:`PEAKS`, the one table of the card's data-sheet
rates: ``chip_smoke.py``'s kernel bounds read it too, so a bound and an
MFU can never price the same work at two rates.  Unlike the JAX package,
which prices every step at its bfloat16 peak, :func:`peak_tflops` takes
the step's compute dtype: the port's float32 products run on the FMA
pipes with TF32 off, and pricing them at the bfloat16 tensor-core peak
would understate their MFU about 15-fold.

``collective_bytes`` and ``emit_static_roofline`` read the static
analyzer (``analysis/``): the collective bytes its sharding propagation
prices (MXL-P) and its static roofline (MXL-R) at the card's peaks from
:data:`PEAKS`, which a ``static_roofline`` counter carries beside
``trainer_cost``.  :data:`LIMITS` holds the cards' launch limits, which
the analyzer's launch-budget rules (MXL-K) read off the card.
"""
from __future__ import annotations

import os

from . import events
from .metrics import QuantileSketch, registry as _metrics_registry

__all__ = ["percentile", "rel_spread", "StepStats", "global_stats",
           "reset", "PEAKS", "LIMITS", "launch_limits", "peak_tflops", "mfu",
           "collective_bytes", "emit_trainer_counters",
           "emit_sentinel_counters", "emit_static_roofline"]


def percentile(values, pct):
    """Nearest-rank percentile of a sequence (no numpy on the hot
    path); None for an empty input."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    idx = max(0, min(len(vals) - 1,
                     int(round(pct / 100.0 * (len(vals) - 1)))))
    return vals[idx]


def rel_spread(values):
    """Robust relative spread of a metric series: median absolute
    deviation over |median| (0.0 for <2 samples or a zero median).
    The noise estimate the SLO sentry (:mod:`.slo`) widens its
    regression thresholds by — MAD, not stddev, because a bench
    trajectory routinely contains one wild outlier round."""
    vals = [float(v) for v in values if v is not None]
    if len(vals) < 2:
        return 0.0
    med = percentile(vals, 50)
    if not med:
        return 0.0
    mad = percentile([abs(v - med) for v in vals], 50)
    return abs(mad / med)


class StepStats(object):
    """Step-time EMA + sketch-backed percentiles + throughput.

    ``observe`` is the hot call: one sketch bucket increment + one
    multiply-add.  The :class:`~.metrics.QuantileSketch` backing p50/p95
    is bounded-memory, bit-exactly mergeable, and rides along in the
    snapshot (``step_sketch``) so pod aggregation merges rank
    distributions instead of averaging per-rank percentiles.  A tighter
    ``alpha`` than the registry default keeps the snapshot numbers
    within 0.5% of the raw-sample truth.  The process singleton also
    mirrors timings into the live metrics registry (``mxtpu_step_ms``)
    so training shares the /metrics + SLO path with serving.
    """

    SKETCH_ALPHA = 0.005

    def __init__(self, batch_size=None, window=512, ema_decay=0.9,
                 feed_registry=False):
        self.batch_size = batch_size
        del window                   # kept in the signature for compat
        self.sketch = QuantileSketch(alpha=self.SKETCH_ALPHA)
        self.ema_decay = float(ema_decay)
        self.ema_s = None
        self.steps = 0
        self.last_step = None
        self._feed_registry = bool(feed_registry)

    def observe(self, dur_s, step=None, batch_size=None):
        dur_s = float(dur_s)
        self.sketch.add(dur_s * 1e3)
        self.ema_s = dur_s if self.ema_s is None else (
            self.ema_decay * self.ema_s + (1.0 - self.ema_decay) * dur_s)
        self.steps += 1
        if step is not None:
            self.last_step = step
        if batch_size is not None:
            self.batch_size = batch_size
        if self._feed_registry:
            try:
                _metrics_registry().histogram(
                    "mxtpu_step_ms",
                    help="training step wall time (ms)",
                ).observe(dur_s * 1e3)
            except Exception:
                pass

    def snapshot(self):
        """Dict of derived figures (the compact per-rank summary the
        aggregator publishes); ``step_sketch`` carries the full
        serialized distribution for exact cross-rank merging."""
        out = {"steps": self.steps, "last_step": self.last_step}
        if self.ema_s is not None:
            out["step_ms_ema"] = round(self.ema_s * 1e3, 3)
        if self.sketch.count:
            out["step_ms_p50"] = round(self.sketch.percentile(50), 3)
            out["step_ms_p95"] = round(self.sketch.percentile(95), 3)
            mean = self.sketch.mean()
            out["step_ms_mean"] = round(mean, 3)
            if self.batch_size and mean > 0:
                out["samples_per_sec"] = round(
                    self.batch_size / (mean / 1e3), 2)
            out["step_sketch"] = self.sketch.to_dict()
        return out


_GLOBAL = {"stats": None}


def global_stats():
    """The process-wide StepStats the built-in wiring feeds (the
    singleton also mirrors into the live metrics registry)."""
    if _GLOBAL["stats"] is None:
        _GLOBAL["stats"] = StepStats(feed_registry=True)
    return _GLOBAL["stats"]


def reset():
    _GLOBAL["stats"] = None


# ----------------------------------------------------------------------
# hardware-derived figures
# ----------------------------------------------------------------------
#: NVIDIA's data-sheet peaks, dense (no sparsity), at the card's full
#: power limit, keyed by ``torch.cuda.get_device_name()``: TFLOP/s by
#: compute dtype ("float32" is the FMA pipes outside the tensor cores;
#: "int8" is TOP/s), HBM bytes/s, the memory the card is sold with
#: (``memory_bytes``, 80 GiB; a card's own ``total_memory`` reads a little
#: less), and the card-to-card interconnect (``link``, and
#: ``link_bytes_per_s``: the data sheet's figure, both directions
#: together: NVLink 900 GB/s on the SXM card; PCIe Gen5 128 GB/s on the
#: PCIe card).  The static schedule lint (``analysis/schedule.py``,
#: MXL-E) prices stage boundaries and the MoE all-to-all at it.  A card set below its limit runs slower under load; its name
#: and power limit belong beside every figure priced here.
PEAKS = {
    # SXM5, 700 W
    "NVIDIA H100 80GB HBM3": {
        "tflops": {"float32": 67.0, "bfloat16": 989.0, "float16": 989.0,
                   "int8": 1979.0, "fp8": 1979.0},
        "bytes_per_s": 3.35e12, "memory_bytes": 80 * (1 << 30),
        "link": "NVLink", "link_bytes_per_s": 900e9},
    # PCIe, 350 W
    "NVIDIA H100 PCIe": {
        "tflops": {"float32": 51.0, "bfloat16": 756.0, "float16": 756.0,
                   "int8": 1513.0, "fp8": 1513.0},
        "bytes_per_s": 2.0e12, "memory_bytes": 80 * (1 << 30),
        "link": "PCIe", "link_bytes_per_s": 128e9},
}

#: the launch limits of each card of :data:`PEAKS` (compute capability
#: 9.0: NVIDIA's data sheet and CUDA's documented technical
#: specifications), read by the static analyzer's launch-budget
#: rules (``analysis/tiling.py``, MXL-K) off the card; on the card
#: :func:`launch_limits` reads the device's own properties.  Shared
#: memory: 48 KB a block, 227 KB after opting in
#: (``cudaFuncSetAttribute``), 228 KB an SM, of which the CUDA driver keeps
#: 1 KB for each resident block.
LIMITS = {
    "NVIDIA H100 80GB HBM3": {
        "sms": 132, "smem_per_block": 49152, "smem_per_block_optin": 232448,
        "smem_per_sm": 233472, "smem_reserved_per_block": 1024,
        "regs_per_sm": 65536,
        "regs_per_thread": 255, "threads_per_block": 1024,
        "threads_per_sm": 2048, "grid_x": (1 << 31) - 1, "grid_yz": 65535},
    "NVIDIA H100 PCIe": {
        "sms": 114, "smem_per_block": 49152, "smem_per_block_optin": 232448,
        "smem_per_sm": 233472, "smem_reserved_per_block": 1024,
        "regs_per_sm": 65536,
        "regs_per_thread": 255, "threads_per_block": 1024,
        "threads_per_sm": 2048, "grid_x": (1 << 31) - 1, "grid_yz": 65535},
}

#: the row of a card that is not in the tables
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def launch_limits(device=None):
    """The launch limits of one card, as a :data:`LIMITS` row (a copy).
    ``device`` a CUDA device (a ``torch.device``, an index or
    ``"cuda:N"``): its properties (SM count, shared memory a block and an
    SM, registers an SM, threads a block and an SM) over its name's row, or
    :data:`DEFAULT_CARD`'s.  ``device`` None: the current CUDA device when
    there is one, else the H100 SXM's data-sheet row; a card's name:
    that row."""
    if isinstance(device, str) and device in LIMITS:
        return dict(LIMITS[device])
    import torch
    if device is None and torch.cuda.is_available():
        device = torch.cuda.current_device()
    if device is None:
        return dict(LIMITS[DEFAULT_CARD])
    props = torch.cuda.get_device_properties(device)
    row = dict(LIMITS.get(props.name, LIMITS[DEFAULT_CARD]))
    for key, attr in (("sms", "multi_processor_count"),
                      ("smem_per_block", "shared_memory_per_block"),
                      ("smem_per_block_optin",
                       "shared_memory_per_block_optin"),
                      ("smem_per_sm", "shared_memory_per_multiprocessor"),
                      ("regs_per_sm", "regs_per_multiprocessor"),
                      ("threads_per_block", "max_threads_per_block"),
                      ("threads_per_sm", "max_threads_per_multi_processor")):
        value = getattr(props, attr, None)
        if value:
            row[key] = int(value)
    return row


def _device_name(device_name):
    if device_name is not None:
        return device_name
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:
        pass
    return None


def peak_tflops(device_name=None, dtype="float32"):
    """Peak TFLOP/s of one card at ``dtype``: ``BENCH_PEAK_TFLOPS``
    overrides, else :data:`PEAKS` (``device_name`` None: the current
    CUDA device's name), else None (an unknown card: no MFU)."""
    raw = os.environ.get("BENCH_PEAK_TFLOPS")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    row = PEAKS.get(_device_name(device_name))
    if row is None:
        return None
    return row["tflops"].get(str(dtype or "float32").replace("torch.", ""))


def mfu(flops_per_step, step_time_s, n_devices=1, device_name=None,
        dtype="float32"):
    """Model-FLOPs utilization at ``dtype``'s peak, or None when the
    peak is unknown."""
    peak = peak_tflops(device_name, dtype)
    if not peak or not step_time_s:
        return None
    return float(flops_per_step) / float(step_time_s) / (
        peak * 1e12 * max(1, int(n_devices)))


def collective_bytes(symbol, mesh, shapes=None, **analyze_kwargs):
    """Per-device collective bytes of one step of ``symbol`` under
    ``mesh``, from the analysis cost model (MXL-P transfer rules) — the
    figure the collective audit computes at lint time, exposed as a
    telemetry counter.  Returns the ``comm_report`` dict or None."""
    try:
        from .. import analysis
        from ..analysis.propagation import comm_report
        ctx_out = []
        analysis.analyze(symbol, shapes=shapes, mesh=mesh,
                         _ctx_out=ctx_out, **analyze_kwargs)
        return comm_report(ctx_out[0])
    except Exception:
        return None


def emit_static_roofline(symbol, shapes, device_kind=None,
                         compute_dtype=None):
    """Emit the analyzer's card-free MXL-R roofline for ``symbol`` as a
    ``static_roofline`` counter (FLOPs, bytes, intensity, ridge, MFU
    ceiling, bound, and the static step bound ``max(flops / peak,
    bytes / bandwidth)`` in ms), so the measured-vs-ceiling gap is
    trackable in the event log next to ``trainer_cost``.  Returns the
    report dict (or {} when telemetry is off or the analyzer fails)."""
    if not events.enabled():
        return {}
    try:
        from ..analysis import static_mfu_ceiling
        rep = static_mfu_ceiling(symbol, shapes, device_kind=device_kind,
                                 compute_dtype=compute_dtype)
    except Exception:
        return {}
    fields = dict(flops_per_step=rep["flops_per_step"],
                  hbm_bytes_per_step=rep["hbm_bytes_per_step"],
                  intensity=rep["intensity"], ridge=rep["ridge"],
                  mfu_ceiling=rep["mfu_ceiling"], bound=rep["bound"],
                  device_kind=rep["device_kind"],
                  compute_dtype=rep["compute_dtype"])
    if rep["peak_tflops"] and rep["peak_hbm_gbps"]:
        fields["bound_ms"] = 1e3 * max(
            rep["flops_per_step"] / (rep["peak_tflops"] * 1e12),
            rep["hbm_bytes_per_step"] / (rep["peak_hbm_gbps"] * 1e9))
    events.emit("counter", name="static_roofline", **fields)
    return rep


# ----------------------------------------------------------------------
# emit helpers (each one guarded: no-ops when telemetry is off)
# ----------------------------------------------------------------------
def emit_trainer_counters(trainer, step_time_s=None):
    """Emit the ``trainer_cost`` counter of a ShardedTrainer: its step's
    model FLOPs (needs one executed step), and with ``step_time_s`` the
    MFU at the card's peak for the trainer's compute dtype.  On a mesh of
    several members (dp replicas, and the tp or ep members of each) it
    also emits ``flops_per_member``, the work of one member, and the MFU
    is one member's: its FLOPs over the step time at one card's peak.
    Returns the fields emitted (or {})."""
    if not events.enabled():
        return {}
    fields = {}
    try:
        cost = trainer.compiled_step_cost_analysis()
    except Exception:
        cost = None
    if cost and cost.get("flops"):
        fields["flops_per_step"] = float(cost["flops"])
        if cost.get("members"):
            fields["flops_per_member"] = float(cost["flops_per_member"])
            fields["members"] = int(cost["members"])
    if step_time_s and fields.get("flops_per_step"):
        device = getattr(trainer, "device", None)
        name = None
        if getattr(device, "type", None) == "cuda":
            import torch
            name = torch.cuda.get_device_name(device)
        util = mfu(fields.get("flops_per_member",
                              fields["flops_per_step"]), step_time_s,
                   1 if "flops_per_member" in fields
                   else getattr(trainer, "dp", 1), name,
                   getattr(trainer, "compute_dtype", None) or "float32")
        if util is not None:
            fields["mfu"] = round(util, 4)
        fields["step_time_s"] = round(float(step_time_s), 6)
    stats = _GLOBAL["stats"]
    if stats is not None and stats.sketch.count:
        # the full step-time distribution rides along so pod rollups
        # merge rank sketches exactly instead of averaging percentiles
        fields["step_sketch"] = stats.sketch.to_dict()
    if fields:
        events.emit("counter", step=getattr(trainer, "num_update", None),
                    name="trainer_cost", **fields)
    return fields


def emit_sentinel_counters(stats, step=None):
    """Emit loss-scale / skip-count counters from a sentinel-stats dict
    (``ShardedTrainer.sentinel_stats()`` or a host ``Sentinel``)."""
    if not events.enabled() or not stats:
        return
    events.emit("counter", step=step, name="sentinel",
                loss_scale=stats.get("scale"),
                skipped=stats.get("skipped"),
                good_steps=stats.get("good_steps"),
                last_good=stats.get("last_good"))
