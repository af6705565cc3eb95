"""mxserve — HTTP/JSON front end for the port's batching server.

The port's copy of ``tools/mxserve.py``.  Serves ``save_checkpoint``
prefixes (or raw symbol JSON + params files) through
:class:`mxnet_tpu_torch.serving.ModelServer` on ``--ctx`` (``gpu``, the
default, or ``cpu``): buckets are planned (or taken from ``--buckets``),
every (model, bucket) pair is built and warmed at startup, and
concurrent requests are continuously batched under the
``MXTPU_SERVE_*`` knobs.

    # one model from a checkpoint prefix (epoch 3)
    python -m mxnet_tpu_torch.tools.mxserve --checkpoint model/mnist@3 \\
        --name mnist --shapes "data=(784,)" --histogram "1:100,8:20"

    # raw symbol + params, explicit buckets, on the CPU
    python -m mxnet_tpu_torch.tools.mxserve --symbol net-symbol.json \\
        --params net.params --name net --shapes "data=(3,224,224)" \\
        --buckets 1,8,32 --ctx cpu

Endpoints:
    POST /v1/predict   {"model": "mnist", "inputs": {"data": [[...]]}}
                       -> {"model", "n", "outputs": [[...]]}
                       (single-input models may pass "inputs": [[...]])
    POST /v1/generate  {"model": "lm", "prompt": [1, 2, 3],
                        "max_new_tokens": 16, "eos_id": null}
                       -> {"model", "tokens", "n_prompt",
                           "finish_reason"}
                       (requires a --generative model; KV-cache
                       exhaustion returns 429 with blocks_free)
    GET  /v1/stats     ModelServer.stats() JSON
    GET  /metrics      Prometheus text exposition from the live metrics
                       registry (latency/TTFT/ITL sketches, queue depth,
                       occupancy, KV-block high water) + server stats
                       gauges; disable with MXTPU_METRICS=0
    GET  /healthz      200 "ok"

``MXTPU_SLO_SPEC`` names latency objectives for the live SLO engine
(``observability.sloengine``): it evaluates burn rates over the
registry's windowed sketches on a background thread, emits
``slo_alert`` events and writes advisory scale recommendations to the
coordination KV.

Backpressure surfaces as real HTTP 429 (queue full — or, for
``/v1/generate``, KV-cache block exhaustion with ``blocks_free`` in
the body — with a ``retry_after_ms`` hint mirrored in the Retry-After
header) or 503 (draining); both bodies are the structured ServerBusy
dict.

``--generative`` serves the checkpoint as a decoder-only LM through
``add_generative_model`` (paged KV cache + AOT prefill/decode): pass
the model dims (``--vocab --layers --heads --dim --max-seq-len``) and
optionally the bucket/cache knobs.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

def parse_shapes(spec):
    """``"data=(784,),mask=(16,)"`` -> {name: per-sample shape tuple}."""
    out = {}
    depth, start = 0, 0
    parts = []
    for i, ch in enumerate(spec):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(spec[start:i])
            start = i + 1
    parts.append(spec[start:])
    for part in parts:
        part = part.strip()
        if not part:
            continue
        name, _, dims = part.partition("=")
        dims = dims.strip().strip("()")
        shape = tuple(int(d) for d in dims.split(",") if d.strip())
        out[name.strip()] = shape
    return out


def build_server(args):
    from mxnet_tpu_torch.serving import ModelServer, checkpoint_files

    srv = ModelServer(max_delay_ms=args.max_delay_ms,
                      max_queue=args.max_queue)
    if args.checkpoint:
        prefix, _, epoch = args.checkpoint.partition("@")
        symbol, params = checkpoint_files(prefix, int(epoch or 0))
    elif args.params:
        symbol, params = args.symbol, args.params
    else:
        raise SystemExit("mxserve: pass --checkpoint prefix@epoch or "
                         "--symbol + --params")
    if args.generative:
        engine = srv.add_generative_model(
            args.name, params, vocab_size=args.vocab,
            num_layers=args.layers, num_heads=args.heads, dim=args.dim,
            max_seq_len=args.max_seq_len, max_new_tokens=args.max_new,
            prompt_buckets=args.prompt_buckets,
            prompt_histogram=args.histogram,
            decode_buckets=args.decode_buckets,
            kv_blocks=args.kv_blocks, kv_block_size=args.kv_block_size,
            priority=args.priority, ctx=args.ctx)
        sys.stderr.write(
            "mxserve: generative model %r prompt buckets %s decode "
            "buckets %s, %d KV blocks x %d\n"
            % (args.name, list(engine.prompt_buckets),
               list(engine.decode_buckets),
               engine.cache.stats()["blocks_total"],
               engine.cache.config.block_size))
        return srv
    shapes = parse_shapes(args.shapes)
    if not shapes:
        raise SystemExit("mxserve: --shapes is required (per-sample, "
                         "no batch axis)")
    if not args.checkpoint and not args.symbol:
        raise SystemExit("mxserve: pass --checkpoint prefix@epoch or "
                         "--symbol + --params")
    plan = srv.add_model(
        args.name, symbol, params, shapes,
        histogram=args.histogram, buckets=args.buckets,
        ctx=args.ctx, priority=args.priority,
        max_buckets=args.max_buckets)
    sys.stderr.write("mxserve: model %r buckets %s (planned waste %.3f, "
                     "pow2 %.3f)\n" % (args.name, list(plan.buckets),
                                       plan.waste, plan.pow2_waste))
    return srv


def metrics_text(srv=None, stats=None):
    """The /metrics body: refresh server-stats gauges into the live
    registry, then render the Prometheus text exposition.  Shared by
    the mxserve and mxfleet doors (``stats`` wins when given)."""
    from mxnet_tpu_torch.observability import metrics as _metrics
    reg = _metrics.registry()
    st = stats if stats is not None else srv.stats()
    for key, name, help_text in (
            ("requests", "mxtpu_stats_requests", "server stats: "
             "requests completed"),
            ("rejected", "mxtpu_stats_rejected", "server stats: "
             "requests rejected (backpressure)"),
            ("queue_depth", "mxtpu_stats_queue_depth", "server stats: "
             "current queue depth"),
            ("occupancy", "mxtpu_stats_occupancy", "server stats: "
             "mean bucket occupancy"),
            ("generation", "mxtpu_fleet_generation", "fleet ledger "
             "generation"),
            ("leader", "mxtpu_fleet_leader", "1 when this router "
             "holds the leader lease")):
        val = st.get(key)
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, (int, float)):
            reg.gauge(name, help=help_text).set(val)
    replicas = st.get("replicas")
    if isinstance(replicas, dict):
        reg.gauge("mxtpu_fleet_replicas",
                  help="live replica count").set(len(replicas))
    tenants = st.get("tenants")
    if isinstance(tenants, dict):
        for tenant, tstats in sorted(tenants.items()):
            if isinstance(tstats, dict):
                for field, name in (
                        ("admitted", "mxtpu_tenant_admitted"),
                        ("rejected", "mxtpu_tenant_rejected")):
                    if isinstance(tstats.get(field), (int, float)):
                        reg.gauge(name, help="per-tenant admission",
                                  labels={"tenant": tenant}).set(
                                      tstats[field])
    return _metrics.render_prometheus(reg)


def make_handler(srv):
    from http.server import BaseHTTPRequestHandler
    import numpy as np
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.serving import ServerBusy
    from mxnet_tpu_torch.observability.metrics import exposition_enabled

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code, doc, headers=()):
            body = json.dumps(doc, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *fmt_args):  # quiet by default
            if os.environ.get("MXTPU_SERVE_VERBOSE"):
                sys.stderr.write("mxserve: " + fmt % fmt_args + "\n")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._reply(200, srv.stats())
            elif self.path == "/metrics" and exposition_enabled():
                body = metrics_text(srv).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "not_found", "path": self.path})

        def do_POST(self):
            if self.path == "/v1/generate":
                self._generate()
                return
            if self.path != "/v1/predict":
                self._reply(404, {"error": "not_found", "path": self.path})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
                model = doc.get("model") or srv.models()[0]
                inputs = doc["inputs"]
                if isinstance(inputs, dict):
                    inputs = {k: np.asarray(v, dtype="float32")
                              for k, v in inputs.items()}
                else:
                    inputs = np.asarray(inputs, dtype="float32")
                outs = srv.predict(model, inputs,
                                   timeout=float(doc.get("timeout") or 30))
            except ServerBusy as busy:
                hdrs = []
                if busy.retry_after_ms:
                    hdrs.append(("Retry-After",
                                 "%.3f" % (busy.retry_after_ms / 1e3)))
                self._reply(busy.code, busy.to_dict(), hdrs)
                return
            except (KeyError, ValueError, TypeError, MXNetError) as exc:
                # unknown model / shape mismatch / malformed body: the
                # client's fault, not the server's
                self._reply(400, {"error": "bad_request",
                                  "reason": str(exc)})
                return
            except Exception as exc:
                self._reply(500, {"error": "internal",
                                  "reason": str(exc)})
                return
            self._reply(200, {"model": model, "n": int(outs[0].shape[0]),
                              "outputs": [o.tolist() for o in outs]})

        def _generate(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
                model = doc.get("model") or srv.models()[0]
                prompt = [int(t) for t in doc["prompt"]]
                res = srv.generate_sync(
                    model, prompt,
                    max_new_tokens=doc.get("max_new_tokens"),
                    eos_id=doc.get("eos_id"),
                    timeout=float(doc.get("timeout") or 60))
            except ServerBusy as busy:
                hdrs = []
                if busy.retry_after_ms:
                    hdrs.append(("Retry-After",
                                 "%.3f" % (busy.retry_after_ms / 1e3)))
                self._reply(busy.code, busy.to_dict(), hdrs)
                return
            except (KeyError, ValueError, TypeError, MXNetError) as exc:
                self._reply(400, {"error": "bad_request",
                                  "reason": str(exc)})
                return
            except Exception as exc:
                self._reply(500, {"error": "internal",
                                  "reason": str(exc)})
                return
            self._reply(200, dict(res, model=model))

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxserve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint",
                    help="save_checkpoint prefix@epoch (e.g. m/mnist@3)")
    ap.add_argument("--symbol", help="symbol JSON path")
    ap.add_argument("--params", help="params file path")
    ap.add_argument("--name", default="model", help="served model name")
    ap.add_argument("--shapes", default="",
                    help='per-sample input shapes, "data=(784,)" '
                         "(required unless --generative)")
    ap.add_argument("--histogram",
                    help='offered-load histogram "1:100,8:20" '
                         "(plans buckets)")
    ap.add_argument("--buckets", help='explicit buckets "1,8,32"')
    ap.add_argument("--max-buckets", type=int, default=None)
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="admission timer (MXTPU_SERVE_MAX_DELAY_MS)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="queue bound (MXTPU_SERVE_MAX_QUEUE)")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"),
                    help="device to serve on (default gpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8911)
    gen = ap.add_argument_group("generative serving")
    gen.add_argument("--generative", action="store_true",
                     help="serve the checkpoint as a decoder-only LM "
                          "(/v1/generate)")
    gen.add_argument("--vocab", type=int, default=32000)
    gen.add_argument("--layers", type=int, default=4)
    gen.add_argument("--heads", type=int, default=8)
    gen.add_argument("--dim", type=int, default=256)
    gen.add_argument("--max-seq-len", type=int, default=512)
    gen.add_argument("--max-new", type=int, default=None,
                     help="per-request token cap "
                          "(MXTPU_SERVE_MAX_NEW_TOKENS)")
    gen.add_argument("--prompt-buckets",
                     help='explicit prompt-length buckets "8,16,32"')
    gen.add_argument("--decode-buckets",
                     help='explicit decode batch buckets "1,2,4,8"')
    gen.add_argument("--kv-blocks", type=int, default=None,
                     help="KV cache blocks (MXTPU_SERVE_KV_BLOCKS)")
    gen.add_argument("--kv-block-size", type=int, default=None,
                     help="tokens per block "
                          "(MXTPU_SERVE_KV_BLOCK_SIZE)")
    args = ap.parse_args(argv)

    srv = build_server(args)
    # MXTPU_SLO_SPEC set -> evaluate burn rates live in this process
    from mxnet_tpu_torch.observability import sloengine as _sloengine
    _sloengine.maybe_start(source="mxserve")

    from http.server import ThreadingHTTPServer
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv))

    stoppers = []

    def shutdown(_sig, _frm):
        # graceful drain: stop admission, flush accepted requests (off the
        # signal frame: httpd.shutdown waits for serve_forever to return)
        t = threading.Thread(target=httpd.shutdown, daemon=True)
        stoppers.append(t)
        t.start()
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    sys.stderr.write("mxserve: listening on http://%s:%d\n"
                     % (args.host, args.port))
    try:
        httpd.serve_forever()
    finally:
        for t in stoppers:
            t.join()
        srv.close()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
