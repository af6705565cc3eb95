"""The in-process batching model server: planner + warmup + batcher glue.

The port of ``mxnet_tpu/serving/server.py``.  :class:`ModelServer` is the
in-process serving API.  ``add_model``:

1. plans buckets from the offered-load histogram (or takes explicit
   ``buckets=``) via :func:`~mxnet_tpu_torch.serving.buckets.plan_buckets`,
   fed the model's own per-sample matrix-product rows
   (:func:`~mxnet_tpu_torch.serving.buckets.model_matmul_dims`);
2. binds one :class:`~mxnet_tpu_torch.predictor.Predictor` per bucket --
   all buckets share ONE program through the executor's program registry
   (the graph hash carries no shapes) -- and runs one warmup batch per
   bucket before the first request;
3. registers the model with the :class:`~mxnet_tpu_torch.serving.batcher.
   ContinuousBatcher` under its priority.

After warmup the steady state performs **zero lowerings** (in the port a
lowering is one program build, a registry miss): the registry counters
are snapshotted at the end of ``add_model`` and :meth:`ModelServer.stats`
reports ``lowerings_since_warmup`` per model.

``add_generative_model`` opens a decoder-only LM for token generation
(:class:`~mxnet_tpu_torch.serving.generate.GenerativeEntry`: a bucketed
prefill per prompt, decode batched at iteration granularity, 429s under
KV-cache pressure).  ``ctx=None`` means :func:`~mxnet_tpu_torch.context.
current_context`, ``gpu(0)`` outside a ``with`` scope; serve on the CPU
with ``ctx=mx.cpu()``.

Request/response contract: inputs are numpy arrays with a leading
sample axis (``n`` samples per request, ``n`` <= the largest bucket);
results are the model's outputs sliced back to ``n`` rows, as numpy.
Single-input models may pass the bare array instead of a dict.

Warm elasticity: :meth:`ModelServer.snapshot_hotstate` offloads every
served model into the hot-state hand-off area and
:meth:`ModelServer.warm_resume_models` rebuilds them from it.  Not
ported: the retrace sentry's warmup markers.
"""
from __future__ import annotations

import os as _os
import time

import numpy as _np
import torch

from ..base import MXNetError
from .batcher import ContinuousBatcher
from .buckets import (BucketPlan, model_matmul_dims, parse_buckets,
                      plan_buckets, request_waste)

__all__ = ["ModelServer", "checkpoint_files"]


def checkpoint_files(prefix, epoch):
    """The ``save_checkpoint`` file pair for (prefix, epoch):
    ``(prefix-symbol.json, prefix-%04d.params)``."""
    prefix = _os.fspath(prefix)
    return "%s-symbol.json" % prefix, "%s-%04d.params" % (prefix, epoch)


def _requantized(params, qdtype):
    """A snapshot's params with each quantized weight (the ones with a
    ``<name>_scale`` beside them) back in its storage dtype: the payload
    holds them widened to float32 (numpy has no fp8), exactly."""
    if not qdtype:
        return dict(params)
    from ..kernels.quantize import storage_dtype
    st = storage_dtype(qdtype)
    return {k: torch.from_numpy(_np.ascontiguousarray(v)).to(st)
            if k + "_scale" in params else v
            for k, v in params.items()}


def _symbol_text(symbol_json):
    """Symbol JSON text from text or a ``.json`` path."""
    if isinstance(symbol_json, _os.PathLike):
        symbol_json = _os.fspath(symbol_json)
    if isinstance(symbol_json, str) and symbol_json.endswith(".json"):
        with open(symbol_json) as fin:
            return fin.read()
    return symbol_json


def _param_to_host(v):
    """numpy copy of a bound parameter (an NDArray or a tensor; numpy
    has no fp8, so an fp8 weight comes back as float32, exactly)."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if hasattr(v, "detach"):
        t = v.detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            t = t.float()
        return t.cpu().numpy()
    return _np.asarray(v)


def _to_host(t):
    """numpy copy of a result tensor (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _ModelEntry(object):
    """One served model: the batcher's duck-typed pack/launch/unpack
    protocol over per-bucket Predictors."""

    def __init__(self, name, plan, predictors, input_shapes, dtypes,
                 priority=0, source_json=None, quantize=None):
        self.name = name
        #: the symbol as added, before any weight-only quantization
        #: rewrote it, and that quantization's mode (None: none);
        #: swap_params re-quantizes new params from both
        self.source_json = source_json
        self.quantize = quantize or None
        self.plan = plan
        self.buckets = plan.buckets
        self.priority = int(priority)
        self.predictors = predictors          # {bucket: Predictor}
        self.input_shapes = input_shapes      # {input: per-sample shape}
        self.dtypes = dtypes                  # {input: numpy dtype}

    # -- batcher protocol --------------------------------------------------

    def pack(self, requests, bucket):
        """Concatenate request payloads row-wise into zero-padded
        bucket-shaped host arrays (host work; runs on the scheduler
        thread, overlapping the previous batch's device time)."""
        packed = {
            nm: _np.zeros((bucket,) + tuple(shape), dtype=self.dtypes[nm])
            for nm, shape in self.input_shapes.items()}
        row = 0
        for req in requests:
            for nm, arr in req.payload.items():
                packed[nm][row:row + req.n] = arr
            row += req.n
        return packed

    def launch(self, payload, bucket):
        """Asynchronous launch on the bucket's Predictor; returns (device
        tensors, dispatch stamp) without waiting for the device."""
        t0 = time.perf_counter()
        outs = self.predictors[bucket].forward_async(**payload)
        return outs, t0

    def unpack(self, handle, requests, bucket):
        """Wait for the device tensors, slice each request's rows back
        out.  Returns (per-request result lists, phase timings)."""
        outs, t0 = handle
        host = [_to_host(o) for o in outs]        # waits: device phase
        t1 = time.perf_counter()
        results, row = [], 0
        for req in requests:
            results.append([o[row:row + req.n] for o in host])
            row += req.n
        t2 = time.perf_counter()
        return results, {"device_ms": (t1 - t0) * 1e3,
                         "unpack_ms": (t2 - t1) * 1e3}

    def waste(self, n_samples, bucket):
        """Padding-waste fraction of one dispatch (planner cost model)."""
        return request_waste(n_samples, bucket, self.plan.mats,
                             self.plan.compute_dtype)

    def validate(self, payload, n):
        """Normalize one request's inputs: bare array → single-input
        dict; check names, per-sample shapes, and a consistent sample
        count."""
        if not isinstance(payload, dict):
            if len(self.input_shapes) != 1:
                raise MXNetError(
                    "model %r has inputs %s; pass a dict"
                    % (self.name, sorted(self.input_shapes)))
            payload = {next(iter(self.input_shapes)): payload}
        out = {}
        for nm, shape in self.input_shapes.items():
            if nm not in payload:
                raise MXNetError("model %r: missing input %r"
                                 % (self.name, nm))
            arr = _np.asarray(payload[nm])
            if arr.ndim == len(shape):      # single sample, no batch axis
                arr = arr[None]
            if tuple(arr.shape[1:]) != tuple(shape):
                raise MXNetError(
                    "model %r input %r: per-sample shape %s != bound %s"
                    % (self.name, nm, arr.shape[1:], tuple(shape)))
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise MXNetError(
                    "model %r: inconsistent sample counts across inputs"
                    % self.name)
            out[nm] = arr
        return out, int(n)


class ModelServer(object):
    """In-process batching server (see module docstring).

    Parameters mirror the ``MXTPU_SERVE_*`` env knobs; explicit
    arguments win.  ``close()`` drains gracefully.
    """

    def __init__(self, max_delay_ms=None, max_queue=None):
        self._batcher = ContinuousBatcher(max_delay_ms_=max_delay_ms,
                                          max_queue_=max_queue)
        self._entries = {}
        self._warmup = {}        # model -> registry-counter snapshot
        self._swap_count = 0
        self.param_version = "v0"    # bumped by swap_params

    # -- model lifecycle ---------------------------------------------------

    def add_model(self, name, symbol_json, params, input_shapes,
                  histogram=None, buckets=None, ctx=None, priority=0,
                  max_buckets=None, compute_dtype="float32",
                  dtypes=None):
        """Plan buckets, pre-compile every (model, bucket) pair, and
        open the model for requests.  Returns the :class:`BucketPlan`.

        ``input_shapes``: ``{input: per-sample shape}`` (no batch axis).
        ``histogram``: offered request-size load (``{n: weight}`` /
        ``"1:100,8:20"``) for the planner; ``buckets=`` skips planning.
        """
        from ..predictor import Predictor
        if name in self._entries:
            raise MXNetError("model %r already added" % name)
        input_shapes = {nm: tuple(int(d) for d in shape)
                        for nm, shape in input_shapes.items()}
        env_buckets = _os.environ.get("MXTPU_SERVE_BUCKETS")
        if buckets is None and env_buckets:
            buckets = env_buckets

        source_json = _symbol_text(symbol_json)
        first = None
        predictors = {}

        def bind(batch):
            shapes = {nm: (batch,) + shape
                      for nm, shape in input_shapes.items()}
            if first is None:
                return Predictor(source_json, params, shapes, ctx=ctx)
            # later buckets share the first's (possibly quantized) symbol
            # and parameters: one program through the registry, and no
            # float32 weight bound where a quantized one belongs
            return first.reshape(shapes)

        if buckets is not None:
            plan_b = parse_buckets(buckets)
            first = bind(plan_b[0])
            mats = model_matmul_dims(
                first.symbol, {nm: (1,) + shape
                               for nm, shape in input_shapes.items()})
            plan = BucketPlan(plan_b, histogram or {b: 1.0
                                                    for b in plan_b},
                              mats or ((1, 128, 128),), compute_dtype)
        else:
            if histogram is None:
                raise MXNetError(
                    "add_model needs a request histogram (to plan "
                    "buckets) or an explicit buckets= list")
            # bind the smallest observed size first just to get the
            # Symbol for the cost rows; planning is pure host math
            from .buckets import parse_histogram
            hist = parse_histogram(histogram)
            first = bind(min(hist))
            mats = model_matmul_dims(
                first.symbol, {nm: (1,) + shape
                               for nm, shape in input_shapes.items()})
            plan = plan_buckets(hist, mats=mats, max_buckets=max_buckets,
                                compute_dtype=compute_dtype)
        # per-bucket binds: all share one program through the graph-hash
        # registry
        first_batch = first._exec.arg_dict[
            next(iter(input_shapes))].shape[0]
        for b in plan.buckets:
            predictors[b] = first if b == first_batch else bind(b)
        dtypes = {nm: _np.dtype(dtypes[nm]) if dtypes and nm in dtypes
                  else _np.dtype("float32") for nm in input_shapes}
        entry = _ModelEntry(name, plan, predictors, input_shapes, dtypes,
                            priority=priority, source_json=source_json,
                            quantize=first._quantize)
        # warmup: one blocking forward per bucket before the first
        # request; after this, zero lowerings
        for b in plan.buckets:
            zeros = {nm: _np.zeros((b,) + shape, dtype=dtypes[nm])
                     for nm, shape in input_shapes.items()}
            predictors[b].forward(**zeros)
        from ..executor import program_registry_stats
        self._entries[name] = entry
        self._warmup[name] = program_registry_stats()["lowerings"]
        self._batcher.register(entry)
        return plan

    def add_checkpoint(self, name, prefix, epoch, input_shapes, **kwargs):
        """``add_model`` from a ``save_checkpoint`` (prefix, epoch)."""
        sym_path, params_path = checkpoint_files(prefix, epoch)
        return self.add_model(name, sym_path, params_path, input_shapes,
                              **kwargs)

    def add_generative_model(self, name, params, vocab_size, num_layers,
                             num_heads, dim, priority=0, **engine_kwargs):
        """Open a decoder-only LM for token generation: builds the
        :class:`~mxnet_tpu_torch.serving.generate.GenerationEngine` (paged
        KV cache + prefill/decode Predictors -- prompt-length buckets and
        decode batch buckets both planned through the exact-DP planner,
        every bucket warmed here; ``engine_kwargs`` include ``ctx``,
        ``quantize`` and the cache sizes) and registers its
        :class:`~mxnet_tpu_torch.serving.generate.GenerativeEntry` with
        the batcher.  After this call the generation steady state performs
        zero lowerings.  Returns the engine (its ``prompt_plan``/
        ``decode_plan`` carry the planner ledgers)."""
        from .generate import GenerationEngine, GenerativeEntry
        if name in self._entries:
            raise MXNetError("model %r already added" % name)
        engine = GenerationEngine(
            params=params, vocab_size=vocab_size, num_layers=num_layers,
            num_heads=num_heads, dim=dim, **engine_kwargs)
        entry = GenerativeEntry(name, engine, priority=priority)
        from ..executor import program_registry_stats
        self._entries[name] = entry
        self._warmup[name] = program_registry_stats()["lowerings"]
        self._batcher.register(entry)
        return engine

    def generate(self, model, prompt_tokens, max_new_tokens=None,
                 eos_id=None):
        """Admit one generation request.  Returns ``(future, stream)``:
        the :class:`~mxnet_tpu_torch.serving.generate.TokenStream` yields
        tokens as decode iterations land; the Future resolves at
        finish with ``{"tokens", "n_prompt", "finish_reason"}``.
        Raises :class:`~mxnet_tpu_torch.serving.batcher.ServerBusy` — 429
        with ``blocks_free`` in ``to_dict()`` — when the KV cache
        cannot hold the sequence's whole block budget (admission-time
        reservation: running decodes never hit allocation failures)."""
        entry = self._entries.get(model)
        if entry is None or not getattr(entry, "generative", False):
            raise MXNetError("unknown generative model %r (have: %s)"
                             % (model, [m for m, e in self._entries.items()
                                        if getattr(e, "generative", False)]))
        prompt = [int(t) for t in prompt_tokens]
        seq_id, stream = entry.new_request(prompt, max_new=max_new_tokens,
                                           eos_id=eos_id)
        try:
            future = self._batcher.submit(model, {"seq_id": seq_id},
                                          n=len(prompt))
        except BaseException:
            entry.abort(seq_id)
            raise
        return future, stream

    def generate_sync(self, model, prompt_tokens, max_new_tokens=None,
                      eos_id=None, timeout=60.0):
        """Blocking convenience: generate + wait; returns the result
        dict (``tokens`` is the generated ids, prompt excluded)."""
        future, _stream = self.generate(model, prompt_tokens,
                                        max_new_tokens=max_new_tokens,
                                        eos_id=eos_id)
        return future.result(timeout=timeout)

    # -- warm elasticity ---------------------------------------------------

    def snapshot_hotstate(self, step=0):
        """Host-offload every served model -- bound params AND the bind
        config (symbol JSON, input shapes, buckets, priority, dtypes) --
        into the warm-handoff area under the ``serve`` namespace
        (``resilience.hotstate.snapshot``), so an elastic serving re-mesh
        can rebuild this server without the original checkpoint files.
        Generative entries are skipped (clients re-issue prompts)."""
        from ..resilience import hotstate as _hotstate
        tree, configs = {}, {}
        for name, entry in self._entries.items():
            if getattr(entry, "generative", False):
                continue
            first = entry.predictors[min(entry.buckets)]
            params = {}
            for k, v in first._arg_params.items():
                params["arg:" + k] = _param_to_host(v)
            for k, v in first._aux_params.items():
                params["aux:" + k] = _param_to_host(v)
            # bound inputs live in arg_dict, not _arg_params, so the
            # payload holds exactly the learned state
            tree[name] = params
            configs[name] = {
                "symbol_json": first.symbol.tojson(),
                "source_json": entry.source_json,
                "input_shapes": {nm: list(shape) for nm, shape
                                 in entry.input_shapes.items()},
                "buckets": [int(b) for b in entry.buckets],
                "priority": entry.priority,
                "compute_dtype": entry.plan.compute_dtype,
                "dtypes": {nm: _np.dtype(dt).str for nm, dt
                           in entry.dtypes.items()},
                "quantize": entry.quantize,
            }
        return _hotstate.snapshot(tree, step=step, namespace="serve",
                                  extra={"models": configs})

    def warm_resume_models(self, kv=None, ctx=None):
        """Rebuild every model from the ``serve`` handoff area -- the
        serving half of warm elasticity.  Params come back from host
        memory and each bucket re-binds through the executor's program
        registry, so a warm swap in a process that already served the
        symbol performs **zero new lowerings**
        (``stats()['models'][m]['lowerings_since_warmup']`` stays 0).
        Raises :class:`~mxnet_tpu_torch.resilience.HotStateUnavailable`
        when no complete payload survives -- the caller's cue to re-add
        models from checkpoint files.  Returns the restored names."""
        from ..resilience import elastic as _elastic
        from ..resilience import hotstate as _hotstate
        t0 = time.monotonic()
        tree, step, meta = _hotstate.warm_resume(None, kv=kv,
                                                 namespace="serve")
        configs = (meta.get("extra") or {}).get("models") or {}
        restored = []
        for name in sorted(configs):
            cfg = configs[name]
            # host arrays: each Predictor places them on ``ctx``
            self.add_model(
                name, cfg["symbol_json"],
                _requantized(tree.get(name) or {}, cfg.get("quantize")),
                {nm: tuple(shape) for nm, shape
                 in cfg["input_shapes"].items()},
                buckets=cfg["buckets"], ctx=ctx,
                priority=cfg.get("priority", 0),
                compute_dtype=cfg.get("compute_dtype", "float32"),
                dtypes=cfg.get("dtypes"))
            # a quantized model re-binds from its quantized graph; its
            # swaps start from the graph as it was first added, in the
            # mode it was served in (not this process's MXTPU_QUANTIZE)
            entry = self._entries[name]
            entry.source_json = cfg.get("source_json") or cfg["symbol_json"]
            entry.quantize = cfg.get("quantize") or None
            restored.append(name)
        _elastic.emit_transition(
            "resume", step=step, tier="serve", path="warm",
            models=restored, n_payloads=meta.get("n_payloads"),
            duration_ms=round((time.monotonic() - t0) * 1000.0, 3))
        return restored

    # -- live weight hot-swap ----------------------------------------------

    def swap_params(self, params, version=None, models=None):
        """Re-bind served models onto new parameters WITHOUT drain.

        The swap primitive behind the fleet's rolling swap: build a fresh
        :class:`~mxnet_tpu_torch.predictor.Predictor` per (model, bucket)
        from ``params`` (a path, bytes, or ``arg:``/``aux:``-prefixed
        dict — the ``save_checkpoint`` format), then install the new
        predictor set in one reference swap per model.  Requests in
        flight finish on the old programs; the next dispatched batch
        sees the new weights.  Because the symbol and bucket shapes are
        unchanged, every re-bind resolves through the program registry
        -- **zero new lowerings**, counted here from the registry
        counters and reported back.

        A failure anywhere before install — including an injected
        ``swap_crash`` at the ``swap_install`` seam — leaves the old
        version serving untouched.  Generative entries are skipped
        (their engine owns params jointly with live KV state; swap
        those by replica replacement instead).

        Returns ``{"version", "models", "lowerings", "swap_ms"}``.
        """
        from ..predictor import Predictor
        from ..executor import program_registry_stats
        from ..resilience.faultinject import maybe_fault
        t0 = time.perf_counter()
        wanted = sorted(self._entries) if models is None else list(models)
        for name in wanted:
            if name not in self._entries:
                raise MXNetError("unknown model %r (have: %s)"
                                 % (name, sorted(self._entries)))
        names = [m for m in wanted
                 if not getattr(self._entries[m], "generative", False)]
        before = program_registry_stats()["lowerings"]
        staged = {}
        for name in names:
            entry = self._entries[name]
            ctx = entry.predictors[min(entry.buckets)]._ctx
            preds, first = {}, None
            for b in entry.buckets:
                shapes = {nm: (b,) + shape
                          for nm, shape in entry.input_shapes.items()}
                if first is None:
                    # the new params go through the model's own
                    # quantization, from the symbol as it was added
                    first = preds[b] = Predictor(
                        entry.source_json, params, shapes, ctx=ctx,
                        quantize=entry.quantize or "")
                else:
                    preds[b] = first.reshape(shapes)
            staged[name] = preds
        # the crash seam sits between build and install: an injected
        # swap_crash (or any real failure above) discards the staged
        # predictors and the old version keeps serving
        maybe_fault("swap_install")
        self._swap_count += 1
        new_version = version if version is not None \
            else "v%d" % self._swap_count
        for name, preds in staged.items():
            # single reference assignment: the batcher's launch stage
            # reads entry.predictors[bucket] once per batch, so it sees
            # either the old set or the new set, never a mix
            self._entries[name].predictors = preds
        self.param_version = str(new_version)
        lowerings = program_registry_stats()["lowerings"] - before
        return {"version": self.param_version, "models": names,
                "lowerings": lowerings,
                "swap_ms": round((time.perf_counter() - t0) * 1e3, 3)}

    # -- request path ------------------------------------------------------

    def submit(self, model, inputs, n=None, trace_id=None):
        """Admit one request; returns a Future whose ``result()`` is the
        list of per-output arrays (``n`` rows each).  Raises
        :class:`~mxnet_tpu_torch.serving.batcher.ServerBusy` on backpressure.
        ``trace_id`` adopts a caller-minted id (the fleet router's)."""
        entry = self._entries.get(model)
        if entry is None:
            raise MXNetError("unknown model %r (have: %s)"
                             % (model, sorted(self._entries)))
        if getattr(entry, "generative", False):
            raise MXNetError("model %r is generative; use generate()"
                             % model)
        payload, n = entry.validate(inputs, n)
        return self._batcher.submit(model, payload, n=n,
                                    trace_id=trace_id)

    def predict(self, model, inputs, timeout=30.0):
        """Blocking convenience: submit + wait."""
        return self.submit(model, inputs).result(timeout=timeout)

    # -- introspection / lifecycle ----------------------------------------

    def models(self):
        return sorted(self._entries)

    def plan(self, model):
        return self._entries[model].plan

    def stats(self):
        """Batcher counters + per-model plans + the warmup proof
        (``lowerings_since_warmup`` per model, from the program-registry
        counters snapshotted at the end of each ``add_model``)."""
        from ..executor import program_registry_stats
        reg = program_registry_stats()
        out = self._batcher.stats()
        out["registry"] = reg
        out["param_version"] = self.param_version
        out["models"] = {}
        for name, entry in self._entries.items():
            m = {"buckets": list(entry.buckets),
                 "priority": entry.priority,
                 "lowerings_since_warmup":
                     reg["lowerings"] - self._warmup[name]}
            if getattr(entry, "generative", False):
                m["generative"] = True
                m.update(entry.stats())     # kv occupancy, token counts
            else:
                m["planned_waste"] = round(entry.plan.waste, 4)
            out["models"][name] = m
        return out

    def queue_depth(self):
        return self._batcher.queue_depth()

    def drain(self, timeout=None):
        self._batcher.drain(timeout=timeout)

    def close(self, drain=True, timeout=None):
        self._batcher.close(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
