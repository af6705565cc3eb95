"""Generative serving: the prefill/decode engine and the batcher entry.

The port of ``GenerationEngine``, ``TokenStream`` and ``GenerativeEntry``
from ``mxnet_tpu/serving/generate.py``.  Two families of Predictors per
model:

- **prefill**, one per prompt-length bucket: one sequence a dispatch,
  causal attention over the prompt, its k/v scattered into the paged
  cache, the first token the argmax of the last valid logit row;
- **decode**, one per batch bucket: every step feeds each active
  sequence's newest token, appends its k/v and attends over its block
  table through the flash-decode kernel.  Sequences join and leave the
  decode batch at step granularity.

Admission reserves a sequence's whole block budget up front
(:class:`~mxnet_tpu_torch.serving.kvcache.PagedKVCache`), so cache
pressure is a :class:`CacheExhausted` at admission, never a failure
mid-decode; :class:`GenerativeEntry` turns it into a 429
:class:`~mxnet_tpu_torch.serving.batcher.ServerBusy` carrying
``blocks_free`` and streams tokens to the caller as the batcher's decode
iterations land.  ``ctx=None`` runs on the current context (``gpu(0)``
outside a ``with`` scope) and raises when there is no CUDA device; the
CPU runs only on ``ctx=cpu()`` or under ``with cpu():``.

``mesh=`` (with ``tp_axis``, as the JAX engine takes them) serves one
model over the tp members of a mesh: the KV pools split on their head
axis (``PagedKVCache.shard_pools``), and the products split by the tp
policy the trainer uses (``parallel.sharding.param_pspec``; the JAX
engine replicates its weights, which gives the same tokens), so each
member's decode step launches flash-decode once a layer over its own
heads and, under ``quantize``, the weight-only kernel on its rows of
each product (``parallel/tensor_parallel.py``).  The walk and the
logits stay on the first member's device.

As in the JAX package, every step copies its whole logits block to the
host (31 MB for a 960-token prompt at vocab 8192).
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve
from .buckets import (BucketPlan, bucket_for, parse_buckets,
                      parse_histogram, plan_buckets)
from .batcher import ServerBusy
from .kvcache import (CacheExhausted, KVCacheConfig, PagedKVCache,
                      max_new_tokens as _max_new_tokens)

__all__ = ["GenerationEngine", "GenerativeEntry", "TokenStream",
           "generation_mats"]


def generation_mats(vocab_size, num_layers, num_heads, dim, ffn_mult=4):
    """Per-token matmul work of the decoder stack as planner rows:
    ``(linear_mats, quad_mats)``, as in the JAX package."""
    E, H = int(dim), int(num_heads)
    D = E // H
    linear, quad = [], []
    for _ in range(int(num_layers)):
        linear.extend([(1, E, 3 * E), (1, E, E),
                       (1, E, ffn_mult * E), (1, ffn_mult * E, E)])
        quad.extend([(1, D, 1)] * H + [(1, 1, D)] * H)
    linear.append((1, E, int(vocab_size)))
    return tuple(linear), tuple(quad)


class TokenStream(object):
    """Per-request token stream: tokens arrive as decode steps land.

    Iterate (``for tok in stream``) or poll :meth:`next_token`; the
    stream ends after the final token and re-raises the server-side
    error if generation failed mid-flight."""

    _END = object()

    def __init__(self):
        self._q = _queue.Queue()
        self._exc = None

    def _put(self, token):
        self._q.put(int(token))

    def _close(self):
        self._q.put(self._END)

    def _fail(self, exc):
        self._exc = exc
        self._q.put(self._END)

    def next_token(self, timeout=None):
        """The next generated token id, or None at end of stream."""
        try:
            item = self._q.get(timeout=timeout)
        except _queue.Empty:
            raise TimeoutError("no token within %ss" % timeout)
        if item is self._END:
            if self._exc is not None:
                raise self._exc
            return None
        return item

    def __iter__(self):
        while True:
            tok = self.next_token()
            if tok is None:
                return
            yield tok


class _SeqState(object):
    __slots__ = ("seq_id", "tokens", "n_prompt", "max_new", "eos_id",
                 "table_row", "n_generated", "started", "done",
                 "finish_reason", "logits", "inline")

    def __init__(self, seq_id, prompt, max_new, eos_id, table_row,
                 inline=False):
        self.seq_id = seq_id
        self.tokens = list(int(t) for t in prompt)
        self.n_prompt = len(self.tokens)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.table_row = table_row
        self.n_generated = 0
        self.started = False        # prefill landed
        self.done = False
        self.finish_reason = None
        self.logits = []            # per-step rows when collect_logits
        self.inline = inline        # stepped by generate() alone

    def record(self, token):
        """Append one generated token; True when the sequence just
        finished (EOS or length cap)."""
        self.tokens.append(int(token))
        self.n_generated += 1
        if self.eos_id is not None and int(token) == int(self.eos_id):
            self.done, self.finish_reason = True, "eos"
        elif self.n_generated >= self.max_new:
            self.done, self.finish_reason = True, "length"
        return self.done

    def generated(self):
        return list(self.tokens[self.n_prompt:])


class GenerationEngine(object):
    """Paged-cache greedy generation over bucketed prefill/decode
    Predictors.

    No threads: :meth:`generate` or the batcher (through
    :class:`GenerativeEntry`) drives it.  Methods that touch the sequence
    map are locked; step execution (``run_async`` + ``finish_*``) must be
    serialized by the caller, which the batcher's one-job-per-entry gate
    does.  ``quantize="int8"`` or ``"fp8_e4m3"`` (default: the
    ``MXTPU_QUANTIZE`` environment variable) serves weight-only quantized
    FullyConnected layers through the weight-only kernel.  Setting ``collect_logits = True`` keeps each step's logits
    row per sequence in ``last_logits`` (the int8-vs-float32 gate's
    input).
    """

    def __init__(self, params, vocab_size, num_layers, num_heads, dim,
                 max_seq_len=512, ffn_mult=4, prompt_buckets=None,
                 prompt_histogram=None, decode_buckets=None,
                 decode_histogram=None, max_new_tokens=None,
                 kv_blocks=None, kv_block_size=None,
                 cache_dtype="float32", compute_dtype="float32",
                 max_buckets=None, ctx=None, mesh=None, tp_axis="tp",
                 quantize=None):
        import os
        from ..predictor import Predictor
        from ..models import transformer as _tf
        self.mesh, self.tp_axis = mesh, tp_axis
        self._tp_group = None
        if mesh is not None:
            others = {a: n for a, n in mesh.shape.items()
                      if a != tp_axis and n > 1}
            if others:
                raise MXNetError(
                    "GenerationEngine: mesh axes %s: one engine serves one "
                    "replica over its tp members; serve replicas behind "
                    "the fleet's router" % others)
            if ctx is not None and resolve(ctx) != mesh.device:
                raise MXNetError("GenerationEngine: ctx %s differs from the "
                                 "mesh's first device %s"
                                 % (resolve(ctx), mesh.device))
            ctx = mesh.device
            if mesh.shape.get(tp_axis, 1) > 1:
                self._tp_group = mesh.axis_group(0, tp_axis)
        self.device = resolve(ctx)
        if quantize is None:
            quantize = os.environ.get("MXTPU_QUANTIZE", "") or None
        self.quantize = quantize
        #: the dtype tokens are computed at
        self.serving_dtype = quantize or compute_dtype
        self.collect_logits = False   # per-step logits on _SeqState
        self.last_logits = []         # filled by generate() when set
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.dim = int(dim)
        self.max_seq_len = int(max_seq_len)
        self.max_new = _max_new_tokens(max_new_tokens)
        linear, quad = generation_mats(vocab_size, num_layers, num_heads,
                                       dim, ffn_mult)

        max_prompt = self.max_seq_len - self.max_new
        if max_prompt < 1:
            raise MXNetError(
                "max_new_tokens %d leaves no room for a prompt under "
                "max_seq_len %d" % (self.max_new, self.max_seq_len))
        if prompt_buckets is not None:
            pb = parse_buckets(prompt_buckets)
            hist = parse_histogram(prompt_histogram
                                   or {b: 1.0 for b in pb})
            self.prompt_plan = BucketPlan(pb, hist, linear,
                                          compute_dtype, quad_mats=quad)
        else:
            hist = parse_histogram(
                prompt_histogram
                or {max(1, max_prompt // 4): 2.0,
                    max(1, max_prompt // 2): 1.0, max_prompt: 1.0})
            self.prompt_plan = plan_buckets(
                hist, mats=linear, max_buckets=max_buckets,
                compute_dtype=compute_dtype, quad_mats=quad,
                include=(max_prompt,))
        self.prompt_buckets = self.prompt_plan.buckets
        if self.prompt_buckets[-1] > max_prompt:
            raise MXNetError(
                "largest prompt bucket %d + max_new_tokens %d exceeds "
                "max_seq_len %d" % (self.prompt_buckets[-1],
                                    self.max_new, self.max_seq_len))

        if decode_buckets is not None:
            db = parse_buckets(decode_buckets)
            dhist = parse_histogram(decode_histogram
                                    or {b: 1.0 for b in db})
            self.decode_plan = BucketPlan(db, dhist, linear, compute_dtype)
        else:
            dhist = parse_histogram(decode_histogram
                                    or {1: 1.0, 2: 1.0, 4: 1.0, 8: 1.0})
            self.decode_plan = plan_buckets(
                dhist, mats=linear, max_buckets=max_buckets,
                compute_dtype=compute_dtype)
        self.decode_buckets = self.decode_plan.buckets

        total_len = self.prompt_buckets[-1] + self.max_new
        self.cache = PagedKVCache(KVCacheConfig(
            num_layers=num_layers, num_heads=num_heads,
            head_dim=self.dim // self.num_heads, max_seq_len=total_len,
            num_blocks=kv_blocks, block_size=kv_block_size,
            dtype=cache_dtype), self.device)
        if mesh is not None:
            self.cache.shard_pools(mesh, tp_axis=tp_axis)
        mb = self.cache.config.blocks_per_seq
        pool = self.cache.config.pool_shape
        cache_shapes = {}
        for i in range(self.num_layers):
            cache_shapes["layer%d_att_k_cache" % i] = pool
            cache_shapes["layer%d_att_v_cache" % i] = pool

        kw = dict(vocab_size=vocab_size, num_layers=num_layers,
                  num_heads=num_heads, dim=dim, max_seq_len=max_seq_len,
                  ffn_mult=ffn_mult)
        dec_json = _tf.get_decode_symbol(**kw).tojson()
        # weights go to the device ONCE; every bucket's Predictor then
        # wraps the same tensors without a copy
        params = _tf.params_from_numpy(params, self.device)
        if quantize:
            # quantize once up front; each Predictor's own rewrite then
            # finds the weights already quantized (quantize_params is
            # idempotent)
            from ..kernels import quantize as _q
            qnames = _q.quantizable_weights(dec_json)
            params = _tf.params_from_numpy(
                _q.quantize_params(params, qnames, qdtype=quantize),
                self.device)
        self._prefill = {}
        for S in self.prompt_buckets:
            shapes = dict({"data": (1, S), "pos_ids": (1, S),
                           "seq_pos": (1,), "block_table": (1, mb)},
                          **cache_shapes)
            self._prefill[S] = Predictor(
                _tf.get_prefill_symbol(S, **kw).tojson(), params, shapes,
                ctx=self.device, quantize=quantize)
        self._decode = {}
        for B in self.decode_buckets:
            shapes = dict({"data": (B, 1), "pos_ids": (B, 1),
                           "seq_pos": (B,), "block_table": (B, mb)},
                          **cache_shapes)
            self._decode[B] = Predictor(dec_json, params, shapes,
                                        ctx=self.device, quantize=quantize)
        #: under tp, each split product's parts (name -> TPShards)
        self._tp_params = self._split_params(params) \
            if self._tp_group is not None else {}

        self._lock = threading.Lock()
        self._seqs = {}
        self._tokens_out = 0
        #: host-clock seconds of prefill and decode steps in generate()
        #: (each ends in a logits copy to the host, which waits for the
        #: device) and the number of decode steps
        self._step_time = {"prefill_s": 0.0, "decode_s": 0.0,
                           "prefills": 0, "decode_steps": 0}
        self.warmup()

    def _split_params(self, params):
        """The weights the tp policy splits, placed on the tp members as
        :class:`~mxnet_tpu_torch.parallel.tensor_parallel.TPShards`."""
        from ..parallel.sharding import param_pspec, place
        from ..parallel.tensor_parallel import TPShards
        out = {}
        for name, v in params.items():
            spec = param_pspec(name, tuple(v.shape), self.mesh)
            dims = [i for i, e in enumerate(spec) if e == self.tp_axis]
            if dims:
                arr = place(v, self.mesh, spec)
                out[name] = TPShards(arr.shards, self._tp_group, dims[0])
        return out

    # -- warmup ------------------------------------------------------------

    def warmup(self):
        """One forward per (family, bucket) before the first request.
        Warmup inputs point every table slot at the trash block and run
        at position 0, so they write only the trash block.  Marks the
        retrace sentry's compile phase (``observability.retrace``)."""
        from ..observability import retrace as _retrace
        _retrace.warmup_begin()   # legit compile phase: sentry disarms
        mb = self.cache.config.blocks_per_seq
        for S, pred in self._prefill.items():
            self.run_async(pred, {
                "data": _np.zeros((1, S), _np.float32),
                "pos_ids": _np.zeros((1, S), _np.float32),
                "seq_pos": _np.zeros((1,), _np.float32),
                "block_table": _np.zeros((1, mb), _np.float32)})
        for B, pred in self._decode.items():
            outs = self.run_async(pred, {
                "data": _np.zeros((B, 1), _np.float32),
                "pos_ids": _np.zeros((B, 1), _np.float32),
                "seq_pos": _np.zeros((B,), _np.float32),
                "block_table": _np.zeros((B, mb), _np.float32)})
        outs[0].cpu()                 # wait: warmup fully materialized
        _retrace.warmup_boundary()    # steady state: zero lowerings now

    # -- admission / lifecycle --------------------------------------------

    def admit(self, seq_id, prompt_tokens, max_new=None, eos_id=None,
              inline=False):
        """Reserve cache blocks and register the sequence (``inline``: one
        of :meth:`generate`'s, which no scheduler steps).  Raises
        :class:`CacheExhausted` (no side effects) when the block budget
        does not fit."""
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise MXNetError("empty prompt")
        if len(prompt) > self.prompt_buckets[-1]:
            raise MXNetError(
                "prompt of %d tokens exceeds the largest prompt bucket "
                "%d" % (len(prompt), self.prompt_buckets[-1]))
        max_new = min(int(max_new) if max_new else self.max_new,
                      self.max_new)
        row = self.cache.allocate(seq_id, len(prompt) + max_new)
        state = _SeqState(seq_id, prompt, max_new, eos_id, row, inline)
        with self._lock:
            self._seqs[seq_id] = state
        return state

    def abort(self, seq_id):
        """Drop a sequence that never ran (admission succeeded but the
        queue submit failed): free its blocks."""
        with self._lock:
            self._seqs.pop(seq_id, None)
        self.cache.free(seq_id)

    def release(self, seq_id):
        """Finish bookkeeping: free cache blocks, drop state."""
        with self._lock:
            state = self._seqs.pop(seq_id, None)
        if state is not None:
            self.cache.free(seq_id)
        return state

    def state(self, seq_id):
        with self._lock:
            return self._seqs[seq_id]

    def decode_candidates(self, limit=None):
        """Active (prefilled, unfinished) sequence ids, oldest-admitted
        first, capped at ``limit``: one decode iteration's batch.  The
        sequences of a running :meth:`generate` are its own: a server's
        scheduler that stepped them would finish and release them under
        that call."""
        with self._lock:
            ids = [s for s, st in self._seqs.items()
                   if st.started and not st.done and not st.inline]
        ids.sort()
        return ids[:limit] if limit else ids

    def has_active(self):
        return bool(self.decode_candidates(limit=1))

    # -- step construction -------------------------------------------------

    def prefill_bucket(self, n_prompt):
        b = bucket_for(n_prompt, self.prompt_buckets)
        if b is None:
            raise MXNetError("prompt of %d tokens is inadmissible"
                             % n_prompt)
        return b

    def start_prefill(self, seq_id, bucket=None):
        """Host inputs for one sequence's prefill: ``(predictor, inputs,
        bucket)``.  Padded positions carry ``seq_pos`` = the real length,
        so their k/v scatter to the trash block."""
        state = self.state(seq_id)
        S = bucket or self.prefill_bucket(state.n_prompt)
        data = _np.zeros((1, S), _np.float32)
        data[0, :state.n_prompt] = state.tokens[:state.n_prompt]
        inputs = {
            "data": data,
            "pos_ids": _np.arange(S, dtype=_np.float32)[None, :],
            "seq_pos": _np.array([state.n_prompt], _np.float32),
            "block_table": state.table_row[None, :].astype(_np.float32),
        }
        return self._prefill[S], inputs, S

    def finish_prefill(self, seq_id, outs):
        """Install the cache update and take the first token (greedy
        argmax of the last valid logit row).  Returns ``(token, done)``."""
        state = self.state(seq_id)
        logits = outs[0].float().cpu().numpy()          # (S, vocab)
        tok = int(_np.argmax(logits[state.n_prompt - 1]))
        if self.collect_logits:
            state.logits.append(logits[state.n_prompt - 1].copy())
        self._install(outs)
        state.started = True
        done = state.record(tok)
        with self._lock:
            self._tokens_out += 1
        return tok, done

    def start_decode(self, seq_ids, bucket=None):
        """Host inputs for one decode iteration over ``seq_ids``.  Rows
        beyond the active count are padding: position 0 and an all-trash
        block table, so they write only the trash block."""
        B = bucket or bucket_for(len(seq_ids), self.decode_buckets)
        if B is None:
            raise MXNetError("decode batch of %d exceeds the largest "
                             "bucket %d" % (len(seq_ids),
                                            self.decode_buckets[-1]))
        mb = self.cache.config.blocks_per_seq
        data = _np.zeros((B, 1), _np.float32)
        pos = _np.zeros((B,), _np.float32)
        table = _np.zeros((B, mb), _np.float32)
        for b, sid in enumerate(seq_ids):
            state = self.state(sid)
            data[b, 0] = state.tokens[-1]
            pos[b] = len(state.tokens) - 1      # the fed token's slot
            table[b] = state.table_row
        inputs = {"data": data, "pos_ids": pos[:, None].copy(),
                  "seq_pos": pos, "block_table": table}
        return self._decode[B], inputs, B

    def finish_decode(self, seq_ids, outs):
        """Install the cache update and record each row's argmax token.
        Returns ``[(seq_id, token, done)]``."""
        logits = outs[0].float().cpu().numpy()          # (B, vocab)
        self._install(outs)
        results = []
        for b, sid in enumerate(seq_ids):
            state = self.state(sid)
            tok = int(_np.argmax(logits[b]))
            if self.collect_logits:
                state.logits.append(logits[b].copy())
            done = state.record(tok)
            results.append((sid, tok, done))
        with self._lock:
            self._tokens_out += len(seq_ids)
        return results

    def _install(self, outs):
        if self._tp_group is not None:
            return      # each member's pools were updated in place
        self.cache.set_pools(
            [outs[1 + 2 * i] for i in range(self.num_layers)],
            [outs[2 + 2 * i] for i in range(self.num_layers)])

    # -- execution ---------------------------------------------------------

    def run_async(self, pred, host_inputs):
        """Dispatch one prefill/decode forward without waiting for the
        device.  Host inputs are copied to the device; the cache pools
        go in as they are (updated in place).  Returns the raw output
        tensors ``[logits, k0, v0, …]``."""
        ex = pred._exec
        values = {n: a.data for n, a in ex.arg_dict.items()}
        for k, v in host_inputs.items():
            values[k] = torch.from_numpy(v).to(self.device)
        for i in range(self.num_layers):
            for c, pools in (("k", self.cache.k_pools),
                             ("v", self.cache.v_pools)):
                values["layer%d_att_%s_cache" % (i, c)] = \
                    self._pool(pools[i])
        values.update(self._tp_params)
        ex._n_forward += 1
        return ex._forward_raw(values)

    def _pool(self, pool):
        """A pool as the walk takes it: a tensor on the device, or under
        tp its members' head slices."""
        if self._tp_group is not None:
            from ..parallel.tensor_parallel import TPShards
            return TPShards(pool.shards, self._tp_group, 2, weight=False)
        if hasattr(pool, "shards"):
            return pool.shards[0]
        return pool

    # -- synchronous convenience (transformer.generate) --------------------

    def generate(self, prompts, max_new_tokens=None, eos_id=None):
        """Greedy generation for a list of prompts: prefill each, then
        iterate decode over the active set in largest-bucket chunks.
        Returns the generated token lists, prompt order preserved."""
        ids = []
        for i, prompt in enumerate(prompts):
            sid = ("gen", id(self), i)
            self.admit(sid, prompt, max_new=max_new_tokens, eos_id=eos_id,
                       inline=True)
            ids.append(sid)
        results = {}
        timing = self._step_time
        try:
            for sid in ids:
                t0 = time.perf_counter()
                pred, inputs, _b = self.start_prefill(sid)
                self.finish_prefill(sid, self.run_async(pred, inputs))
                timing["prefill_s"] += time.perf_counter() - t0
                timing["prefills"] += 1
            while True:
                active = [s for s in ids if s in self._seqs
                          and not self.state(s).done]
                if not active:
                    break
                t0 = time.perf_counter()
                chunk = active[:self.decode_buckets[-1]]
                pred, inputs, _bucket = self.start_decode(chunk)
                self.finish_decode(chunk, self.run_async(pred, inputs))
                timing["decode_s"] += time.perf_counter() - t0
                timing["decode_steps"] += 1
        finally:
            logits_out = {}
            for sid in ids:
                state = self.release(sid)
                if state is not None:
                    results[sid] = state.generated()
                    logits_out[sid] = state.logits
            if self.collect_logits:
                #: one (n_generated, vocab) row list per prompt, aligned
                #: with the returned token lists
                self.last_logits = [logits_out.get(sid, []) for sid in ids]
        return [results.get(sid, []) for sid in ids]

    # -- introspection -----------------------------------------------------

    def kernel_path(self):
        """Which decode-attention path steps take: the CUDA kernel on a
        GPU, the plain PyTorch version on the CPU."""
        return "flash_decode" if self.device.type == "cuda" else "reference"

    def stats(self):
        s = self.cache.stats()
        s["prompt_buckets"] = list(self.prompt_buckets)
        s["decode_buckets"] = list(self.decode_buckets)
        s["serving_dtype"] = self.serving_dtype
        s["kernel_path"] = self.kernel_path()
        s["device"] = str(self.device)
        with self._lock:
            s["seqs_known"] = len(self._seqs)
            s["tokens_generated"] = self._tokens_out
            s.update(self._step_time)
        return s


class _GenRequest(object):
    __slots__ = ("seq_id", "stream", "future", "t_admit", "t_first",
                 "t_last")

    def __init__(self, seq_id):
        self.seq_id = seq_id
        self.stream = TokenStream()
        self.future = None
        self.t_admit = time.perf_counter()
        self.t_first = None
        self.t_last = None


class GenerativeEntry(object):
    """The batcher's duck-typed entry for a generative model (the port
    of the JAX package's, unchanged).

    ``buckets`` are PROMPT-LENGTH buckets (admission checks the prompt
    against them); decode work is surfaced through the generative
    extensions (``has_decode_work``/``pack_decode``/``complete``) the
    batcher's scheduler drives at iteration granularity.  The batcher
    serializes jobs per generative entry (decode step N+1 consumes
    step N's tokens), so engine step execution needs no internal lock.
    """

    generative = True

    def __init__(self, name, engine, priority=0):
        self.name = name
        self.engine = engine
        self.priority = int(priority)
        self.buckets = engine.prompt_buckets
        self.decode_buckets = engine.decode_buckets
        self._lock = threading.Lock()
        self._next_id = 0
        self._reqs = {}                 # seq_id -> _GenRequest
        self.prefer_prefill = False     # round-robin fairness flag

    # -- admission (server-side, before batcher.submit) --------------------

    def new_request(self, prompt_tokens, max_new=None, eos_id=None):
        """Admit one generation request: reserve its whole cache-block
        budget now.  Raises :class:`ServerBusy` (429 with
        ``blocks_free`` in the payload) when blocks are short — the
        structured form of cache exhaustion; running decodes are
        untouched.  Returns ``(seq_id, stream)``."""
        with self._lock:
            seq_id = self._next_id
            self._next_id += 1
        try:
            self.engine.admit(seq_id, prompt_tokens, max_new=max_new,
                              eos_id=eos_id)
        except CacheExhausted as exc:
            raise ServerBusy(
                self.name, 0, 0, code=429, reason="kv cache exhausted",
                retry_after_ms=100.0, extra=exc.to_dict())
        req = _GenRequest(seq_id)
        with self._lock:
            self._reqs[seq_id] = req
        return seq_id, req.stream

    def abort(self, seq_id):
        with self._lock:
            self._reqs.pop(seq_id, None)
        self.engine.abort(seq_id)

    # -- batcher protocol: prefill rides the normal request path ----------

    def pack(self, requests, bucket):
        """Prefill pack (one sequence per dispatch — requests is a
        single-element list by the scheduler's generative popping
        rule)."""
        req = requests[0]
        seq_id = req.payload["seq_id"]
        with self._lock:
            gen = self._reqs[seq_id]
            gen.future = req.future
        pred, inputs, _b = self.engine.start_prefill(seq_id, bucket)
        return {"phase": "prefill", "pred": pred, "inputs": inputs,
                "seq_ids": [seq_id]}

    def has_decode_work(self):
        return self.engine.has_active()

    def pack_decode(self):
        """One decode iteration over the active set (host pack on the
        scheduler thread)."""
        seq_ids = self.engine.decode_candidates(
            limit=self.decode_buckets[-1])
        pred, inputs, bucket = self.engine.start_decode(seq_ids)
        return ({"phase": "decode", "pred": pred, "inputs": inputs,
                 "seq_ids": seq_ids}, bucket, len(seq_ids))

    def launch(self, payload, bucket):
        t0 = time.perf_counter()
        outs = self.engine.run_async(payload["pred"], payload["inputs"])
        return outs, t0, payload

    def complete(self, handle, batch):
        """Unpack-side: block on the step, stream tokens, settle
        finished sequences, free their blocks.  Returns the telemetry
        fields for the batch's ``serve`` record."""
        outs, t0, payload = handle
        phase = payload["phase"]
        seq_ids = payload["seq_ids"]
        if phase == "prefill":
            tok, done = self.engine.finish_prefill(seq_ids[0], outs)
            results = [(seq_ids[0], tok, done)]
        else:
            results = self.engine.finish_decode(seq_ids, outs)
        t1 = time.perf_counter()
        now = t1
        tel = {"phase": phase, "tokens": len(results),
               "device_ms": (t1 - t0) * 1e3, "lat_ms": [],
               "ttft_ms": [], "itl_ms": [], "n_seqs": len(seq_ids)}
        for sid, tok, done in results:
            with self._lock:
                gen = self._reqs[sid]
            if gen.t_first is None:
                gen.t_first = now
                tel["ttft_ms"].append((now - gen.t_admit) * 1e3)
            elif gen.t_last is not None:
                tel["itl_ms"].append((now - gen.t_last) * 1e3)
            gen.t_last = now
            gen.stream._put(tok)
            if done:
                state = self.engine.release(sid)
                with self._lock:
                    self._reqs.pop(sid, None)
                tel["lat_ms"].append((now - gen.t_admit) * 1e3)
                gen.stream._close()
                if gen.future is not None:
                    gen.future._set({
                        "tokens": state.generated(),
                        "n_prompt": state.n_prompt,
                        "finish_reason": state.finish_reason})
        kv = self.engine.cache.stats()
        tel["kv_occupancy"] = kv["occupancy"]
        tel["kv_blocks_used"] = kv["blocks_used"]
        tel["dtype"] = self.engine.serving_dtype
        tel["kernel"] = self.engine.kernel_path()
        tel["unpack_ms"] = (time.perf_counter() - t1) * 1e3
        return tel

    def fail_inflight(self, exc, payload):
        """A prefill/decode step died: fail every sequence it carried
        (stream + future) and free their blocks.  Other sequences and
        the cache pools are untouched — the entry stays serviceable."""
        for sid in payload.get("seq_ids", ()):
            with self._lock:
                gen = self._reqs.pop(sid, None)
            try:
                self.engine.release(sid)
            except MXNetError:
                pass
            if gen is not None:
                gen.stream._fail(exc)
                if gen.future is not None:
                    gen.future._fail(exc)

    def waste(self, n_samples, bucket):
        # generative batches report occupancy-based padding directly
        # in their telemetry record; the planner-cost hook is a no-op
        return 1.0 - n_samples / float(bucket)

    def stats(self):
        s = self.engine.stats()
        with self._lock:
            s["requests_open"] = len(self._reqs)
        s["prompt_plan"] = self.engine.prompt_plan.to_dict()
        s["decode_plan"] = self.engine.decode_plan.to_dict()
        return s
