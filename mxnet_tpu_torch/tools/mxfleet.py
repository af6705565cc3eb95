"""mxfleet — multi-replica serving fleet.

The port's copy of ``tools/mxfleet.py``, run as
``python -m mxnet_tpu_torch.tools.mxfleet``.  Replicas serve on the
spec's ``"ctx"`` (``"gpu"`` by default; ``"cpu"`` to run without a
card).

Runs N ``ModelServer`` replica processes behind one front-end router:
least-loaded dispatch, FLEET-aggregate admission control (structured
429/503 with Retry-After), replica health via the kvstore heartbeat
machinery, generation-stamped shrink/grow on replica death (elastic
ledger reuse), and live weight hot-swap replica-by-replica without
drain (zero new lowerings, through the program registry).

    # spec file: models + shapes the fleet serves
    cat > fleet.json <<'EOF'
    {"models": [{"name": "net", "symbol": "net-symbol.json",
                 "params": "net.params",
                 "input_shapes": {"data": [784]},
                 "buckets": [1, 8, 32]}],
     "version": "v1", "ctx": "cpu"}
    EOF

    # 3 replicas on ports 8931..8933, router front door on 8930
    python -m mxnet_tpu_torch.tools.mxfleet serve --spec fleet.json \
        --replicas 3

    # push new weights into the running fleet, one replica at a time
    python -m mxnet_tpu_torch.tools.mxfleet swap --params net-v2.params \
        --version v2

    # fleet stats: per-replica state + version skew + router counters
    python -m mxnet_tpu_torch.tools.mxfleet stats

Networked fleet: point the fleet at a TCP coordination KV and run N
router processes — the expiring lease elects one leader (verdicts,
respawn, swap); standbys serve reads and take over within one lease
TTL:

    python -m mxnet_tpu_torch.tools.mxkv serve --port 8940 &
    python -m mxnet_tpu_torch.tools.mxfleet serve --spec fleet.json \
        --kv tcp://127.0.0.1:8940 --router-id r1 --port 8930
    python -m mxnet_tpu_torch.tools.mxfleet serve --adopt \
        --kv tcp://127.0.0.1:8940 --router-id r2 --port 8950

Front-door endpoints (router):
    POST /v1/predict   JSON {"model", "inputs", "tenant"?} ->
                       {"outputs": ...} (429 = fleet queue full,
                        AGGREGATE depth, or the named tenant's token
                        budget; 503 = draining; ServerBusy dicts)
    POST /v1/swap      {"params": path, "version": v} -> per-replica
                       results incl. each replica's lowerings delta
                       (409 not_leader + leader hint on a standby)
    GET  /v1/stats     router stats (role/lease/tenants) + per-replica
                       /v1/stats rollup
    GET  /metrics      Prometheus text from the live registry + router
                       gauges (queue depth, lease/leader state, replica
                       count, per-tenant admission); MXTPU_METRICS=0
                       disables
    POST /v1/drain     stop admission fleet-wide, flush, drain replicas
    GET  /healthz      200 once all replicas answered startup checks

``replica`` is the internal per-process entry point the router spawns;
it speaks npz over HTTP and exits 3 when its launch generation is
older than the fleet ledger's (the elastic stale-incarnation fence).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

def _default_router_url(args):
    port = getattr(args, "port", None) or int(
        os.environ.get("MXTPU_FLEET_PORT", "8930"))
    return "http://127.0.0.1:%d" % port


def _router_request(url, method, path, body=None):
    import http.client
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname,
                                      parts.port or 80, timeout=300)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"}
                     if body else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


def make_front_handler(router):
    """Router front door: JSON predict (mxserve-compatible), swap,
    stats (router + per-replica rollup), drain."""
    from http.server import BaseHTTPRequestHandler
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.serving import ServerBusy

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *fmt_args):
            if os.environ.get("MXTPU_SERVE_VERBOSE"):
                sys.stderr.write("mxfleet: " + fmt % fmt_args + "\n")

        def _reply(self, code, doc, headers=()):
            body = json.dumps(doc, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                doc = router.stats()
                doc["replica_stats"] = router.replica_stats()
                self._reply(200, doc)
            elif self.path == "/metrics":
                from mxnet_tpu_torch.observability.metrics import \
                    exposition_enabled
                if not exposition_enabled():
                    self._reply(404, {"error": "not_found",
                                      "path": self.path})
                    return
                from mxnet_tpu_torch.tools.mxserve import metrics_text
                body = metrics_text(stats=router.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "not_found",
                                  "path": self.path})

        def do_POST(self):
            if self.path == "/v1/predict":
                self._predict()
            elif self.path == "/v1/swap":
                self._swap()
            elif self.path == "/v1/drain":
                try:
                    router.drain()
                except TimeoutError as exc:
                    self._reply(504, {"error": "drain_timeout",
                                      "reason": str(exc)})
                    return
                self._reply(200, {"status": "drained"})
            else:
                self._reply(404, {"error": "not_found",
                                  "path": self.path})

        def _predict(self):
            import numpy as np
            from mxnet_tpu_torch.serving.fleet import (ReplicaDead,
                                                 decode_arrays,
                                                 encode_arrays)
            # two dialects on one door: JSON {"model", "inputs"}
            # (mxserve-compatible, human-curlable) and npz bodies with
            # X-MXTPU-* headers (FleetClient — arrays never transit
            # JSON); the reply mirrors the request's dialect
            npz = "npz" in (self.headers.get("Content-Type") or "")
            try:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if npz:
                    inputs = decode_arrays(raw)
                    model = self.headers.get("X-MXTPU-Model")
                    n_raw = self.headers.get("X-MXTPU-N")
                    n = int(n_raw) if n_raw else None
                    trace_id = self.headers.get("X-MXTPU-Trace") or None
                    timeout = 30.0
                else:
                    doc = json.loads(raw or b"{}")
                    model = doc.get("model")
                    inputs = doc["inputs"]
                    if isinstance(inputs, dict):
                        inputs = {k: np.asarray(v, dtype="float32")
                                  for k, v in inputs.items()}
                    else:
                        inputs = np.asarray(inputs, dtype="float32")
                    n = None
                    trace_id = self.headers.get("X-MXTPU-Trace") or None
                    timeout = float(doc.get("timeout") or 30)
                tenant = (None if npz else doc.get("tenant")) \
                    or self.headers.get("X-MXTPU-Tenant") or None
                outs = router.submit(model, inputs, n=n,
                                     trace_id=trace_id,
                                     tenant=tenant).result(
                    timeout=timeout)
            except ServerBusy as busy:
                hdrs = []
                if busy.retry_after_ms:
                    hdrs.append(("Retry-After",
                                 "%.3f" % (busy.retry_after_ms / 1e3)))
                self._reply(busy.code, busy.to_dict(), hdrs)
                return
            except ReplicaDead as dead:
                self._reply(502, dead.to_dict())
                return
            except (KeyError, ValueError, TypeError, MXNetError) as exc:
                self._reply(400, {"error": "bad_request",
                                  "reason": str(exc)})
                return
            except Exception as exc:
                self._reply(500, {"error": "internal",
                                  "reason": str(exc)})
                return
            if npz:
                body = encode_arrays(
                    {"out%03d" % i: o for i, o in enumerate(outs)})
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._reply(200, {"model": model,
                              "n": int(outs[0].shape[0]),
                              "outputs": [o.tolist() for o in outs]})

        def _swap(self):
            from mxnet_tpu_torch.serving.fleet import NotLeader
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
                res = router.swap(doc["params"],
                                  version=doc.get("version"))
            except NotLeader as nl:
                # standby front door: 409 + leader hint so the client
                # re-aims instead of mutating through the wrong router
                self._reply(409, nl.to_dict())
                return
            except (KeyError, ValueError, TypeError) as exc:
                self._reply(400, {"error": "bad_request",
                                  "reason": str(exc)})
                return
            except Exception as exc:
                self._reply(500, {"error": "swap_failed",
                                  "reason": repr(exc)})
                return
            self._reply(200, res)

    return Handler


def cmd_serve(args):
    from mxnet_tpu_torch.serving.fleet import adopt_fleet, launch_fleet
    from mxnet_tpu_torch.tools.mxserve import _refuse_slo_spec
    _refuse_slo_spec()
    if args.adopt:
        router = adopt_fleet(
            n_replicas=args.replicas, directory=args.dir,
            base_port=args.base_port, max_queue=args.max_queue,
            kv_url=args.kv, router_id=args.router_id,
            lease_ttl_s=args.lease_ttl, tenants=args.tenants,
            spec_path=args.spec,
            respawn=None if args.respawn is None
            else bool(args.respawn))
    elif args.spec is None:
        sys.stderr.write("mxfleet: serve needs --spec "
                         "(or --adopt over a running fleet)\n")
        return 2
    else:
        router = launch_fleet(
            args.spec, n_replicas=args.replicas,
            directory=args.dir, base_port=args.base_port,
            max_queue=args.max_queue,
            respawn=None if args.respawn is None
            else bool(args.respawn),
            kv_url=args.kv, router_id=args.router_id,
            lease_ttl_s=args.lease_ttl, tenants=args.tenants)
    from http.server import ThreadingHTTPServer
    port = args.port or int(os.environ.get("MXTPU_FLEET_PORT", "8930"))
    httpd = ThreadingHTTPServer((args.host, port),
                                make_front_handler(router))

    def shutdown(_sig, _frm):
        threading.Thread(target=httpd.shutdown, daemon=True).start()
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    stats = router.stats()
    sys.stderr.write(
        "mxfleet: %d replica(s), front door http://%s:%d "
        "(router %s, %s, generation %d)\n"
        % (len(stats["replicas"]), args.host, port,
           stats["router_id"], stats["role"], router.generation))
    try:
        httpd.serve_forever()
    finally:
        router.close()
        httpd.server_close()
    return 0


def cmd_replica(args):
    from mxnet_tpu_torch.serving.fleet import run_replica
    return run_replica(args.spec, args.index, args.port,
                       host=args.host)


def cmd_swap(args):
    status, doc = _router_request(
        args.url or _default_router_url(args), "POST", "/v1/swap",
        body=json.dumps({"params": args.params,
                         "version": args.version}).encode())
    print(json.dumps(doc, indent=2, default=str))
    if status != 200:
        return 1
    # surface the AOT proof: a healthy swap re-binds through the
    # program registry, so every replica must report lowerings == 0
    bad = {i: r for i, r in doc.get("replicas", {}).items()
           if r.get("lowerings", 0) or "error" in r}
    if bad:
        sys.stderr.write("mxfleet: swap anomalies: %s\n"
                         % json.dumps(bad, default=str))
        return 1
    return 0


def cmd_stats(args):
    status, doc = _router_request(
        args.url or _default_router_url(args), "GET", "/v1/stats")
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
        return 0 if status == 200 else 1
    print("fleet generation %s  queue %s/%s  requests %s  "
          "rejected %s  failed %s"
          % (doc.get("generation"), doc.get("queue_depth"),
             doc.get("max_queue"), doc.get("requests"),
             doc.get("rejected"), doc.get("failed")))
    if doc.get("router_id"):
        lease = doc.get("lease") or {}
        print("  router %s: %s  takeovers=%s%s"
              % (doc["router_id"], doc.get("role"),
                 doc.get("takeovers", 0),
                 "  [KV HELD]" if doc.get("kv_held") else ""))
        if lease:
            print("  lease: holder=%s ttl=%ss"
                  % (lease.get("holder"), lease.get("ttl_s")))
    for name, ten in sorted((doc.get("tenants") or {}).items()):
        print("  tenant %-12s queued=%-4s admitted=%-6s "
              "rejected=%-5s tokens=%s w=%s"
              % (name, ten.get("queued"), ten.get("admitted"),
                 ten.get("rejected"), ten.get("tokens"),
                 ten.get("weight")))
    for idx, rep in sorted(doc.get("replicas", {}).items()):
        print("  replica %s: %-9s inflight=%-3s requests=%-6s "
              "version=%s" % (idx, rep.get("state"),
                              rep.get("inflight"),
                              rep.get("requests"),
                              rep.get("param_version") or "?"))
    skew = doc.get("version_skew") or {}
    if len(skew) > 1:
        print("  VERSION SKEW: %s" % json.dumps(skew))
    if "swap_pause_ms_p95" in doc:
        print("  swap pause p95: %.3f ms" % doc["swap_pause_ms_p95"])
    return 0 if status == 200 else 1


def cmd_drain(args):
    status, doc = _router_request(
        args.url or _default_router_url(args), "POST", "/v1/drain")
    print(json.dumps(doc, default=str))
    return 0 if status == 200 else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxfleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="launch replicas + router")
    sp.add_argument("--spec", default=None,
                    help="fleet spec JSON (models/shapes/buckets); "
                         "required unless --adopt (where it only arms "
                         "respawn)")
    sp.add_argument("--adopt", action="store_true",
                    help="router-only: adopt an already-running fleet "
                         "(standby front door; the lease elects the "
                         "leader)")
    sp.add_argument("--kv", default=None,
                    help="coordination backend URL (MXTPU_KV_URL): "
                         "file:///path or tcp://host:port")
    sp.add_argument("--router-id", default=None,
                    help="lease identity (MXTPU_FLEET_ROUTER_ID, "
                         "default r<pid>)")
    sp.add_argument("--lease-ttl", type=float, default=None,
                    help="leader-lease TTL seconds "
                         "(MXTPU_FLEET_LEASE_TTL_S, default 3)")
    sp.add_argument("--tenants", default=None,
                    help="per-tenant budgets name:rate:burst[:weight]"
                         ";... (MXTPU_FLEET_TENANTS)")
    sp.add_argument("-n", "--replicas", type=int, default=None,
                    help="replica count (MXTPU_FLEET_REPLICAS)")
    sp.add_argument("--dir", default=None,
                    help="fleet dir: heartbeat KV + ledger "
                         "(MXTPU_FLEET_DIR)")
    sp.add_argument("--base-port", type=int, default=None,
                    help="replica i listens on base+i "
                         "(MXTPU_FLEET_BASE_PORT)")
    sp.add_argument("--port", type=int, default=None,
                    help="router front-door port (MXTPU_FLEET_PORT, "
                         "default 8930)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--max-queue", type=int, default=None,
                    help="fleet-wide admission bound "
                         "(MXTPU_FLEET_MAX_QUEUE)")
    sp.add_argument("--respawn", type=int, default=None,
                    help="1/0: grow back after replica death "
                         "(MXTPU_FLEET_RESPAWN)")
    sp.set_defaults(func=cmd_serve)

    rp = sub.add_parser("replica",
                        help="one replica process (internal)")
    rp.add_argument("--spec", required=True)
    rp.add_argument("--index", type=int, required=True)
    rp.add_argument("--port", type=int, required=True)
    rp.add_argument("--host", default="127.0.0.1")
    rp.set_defaults(func=cmd_replica)

    wp = sub.add_parser("swap",
                        help="live weight hot-swap, no drain")
    wp.add_argument("--params", required=True,
                    help="checkpoint/params file to push")
    wp.add_argument("--version", default=None,
                    help="version label (default: replica-side v<n>)")
    wp.add_argument("--url", default=None,
                    help="router front door (default "
                         "http://127.0.0.1:$MXTPU_FLEET_PORT)")
    wp.set_defaults(func=cmd_swap)

    tp = sub.add_parser("stats", help="fleet stats")
    tp.add_argument("--url", default=None)
    tp.add_argument("--json", action="store_true")
    tp.set_defaults(func=cmd_stats)

    dp = sub.add_parser("drain", help="stop admission fleet-wide")
    dp.add_argument("--url", default=None)
    dp.set_defaults(func=cmd_drain)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
