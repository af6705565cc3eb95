"""mxkv — standalone coordination KV server + client ops.

The port's copy of ``tools/mxkv.py``.  The serving fleet's
coordination plane (heartbeats, elastic ledger verdicts, the router
leader lease, versioned-params pointers) speaks one four-method client
surface (``mxnet_tpu_torch/resilience/netkv.py``, wire-compatible with
the JAX package's).  This tool runs the TCP backend as its own process
and gives shell access to any backend:

    # the server (routers + replicas point MXTPU_KV_URL at it)
    python -m mxnet_tpu_torch.tools.mxkv serve --host 0.0.0.0 --port 8940

    # client ops, against --kv or $MXTPU_KV_URL
    python -m mxnet_tpu_torch.tools.mxkv set  mxtpu_fleet/params_ptr '{...}'
    python -m mxnet_tpu_torch.tools.mxkv get  mxtpu_fleet/params_ptr
    python -m mxnet_tpu_torch.tools.mxkv bget mxtpu_elastic/g1 --timeout-ms 5000
    python -m mxnet_tpu_torch.tools.mxkv dir  mxtpu_hb/
    python -m mxnet_tpu_torch.tools.mxkv del  mxtpu_router/lease
    python -m mxnet_tpu_torch.tools.mxkv ping

Exit codes: 0 ok; 1 semantic failure (key absent/exists); 2 the KV is
unreachable after the retry budget (``MXTPU_KV_RETRIES`` /
``MXTPU_KV_TIMEOUT_S``).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

def cmd_serve(args):
    from mxnet_tpu_torch.resilience.netkv import TcpKVServer
    srv = TcpKVServer(host=args.host, port=args.port,
                      max_value_bytes=args.max_value)
    stopping = threading.Event()
    stoppers = []

    def shutdown(_sig, _frm):
        if not stopping.is_set():
            stopping.set()
            # stop() joins handler threads; run it off the signal frame
            t = threading.Thread(target=srv.stop, daemon=True)
            stoppers.append(t)
            t.start()
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    sys.stderr.write("mxkv: serving on %s\n" % srv.url)
    sys.stderr.flush()
    srv.serve_forever()
    # serve_forever returns once stop() has closed the socket; the exit
    # waits for stop() to join the handler threads too
    for t in stoppers:
        t.join()
    return 0


def _client(args):
    from mxnet_tpu_torch.resilience.netkv import connect_kv
    return connect_kv(url=args.kv or None)


def _run_op(args, fn):
    from mxnet_tpu_torch.resilience.netkv import (KVUnreachable, KeyAbsent,
                                            KeyExists)
    try:
        out = fn(_client(args))
    except (KeyAbsent, KeyExists) as exc:
        sys.stderr.write("mxkv: %s\n" % exc)
        return 1
    except KVUnreachable as exc:
        sys.stderr.write("mxkv: %s\n" % exc)
        return 2
    if out is not None:
        print(out)
    return 0


def cmd_set(args):
    return _run_op(args, lambda kv: kv.key_value_set(
        args.key, args.value, allow_overwrite=not args.if_absent))


def cmd_get(args):
    return _run_op(args, lambda kv: kv.blocking_key_value_get(
        args.key, 50))


def cmd_bget(args):
    return _run_op(args, lambda kv: kv.blocking_key_value_get(
        args.key, args.timeout_ms))


def cmd_dir(args):
    def _dir(kv):
        return "\n".join("%s\t%s" % (k, v) for k, v in
                         kv.key_value_dir_get(args.prefix)) or None
    return _run_op(args, _dir)


def cmd_del(args):
    return _run_op(args, lambda kv: kv.key_value_delete(args.key))


def cmd_ping(args):
    import json
    from mxnet_tpu_torch.resilience.netkv import ResilientKV, TcpKV

    def _ping(kv):
        base = kv.kv if isinstance(kv, ResilientKV) else kv
        if isinstance(base, TcpKV):
            return json.dumps(base.ping())
        # file backend: a dir scan IS the liveness probe
        kv.key_value_dir_get("")
        return '{"ok": true}'
    return _run_op(args, _ping)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxkv", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kv", default=None,
                    help="backend URL (default $MXTPU_KV_URL, then "
                         "file://$MXTPU_FLEET_DIR/kv)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="run the TCP KV server")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int,
                    default=int(os.environ.get("MXTPU_KV_PORT",
                                               "8940")))
    sp.add_argument("--max-value", type=int, default=None,
                    help="value-size cap in bytes (MXTPU_KV_MAX_VALUE)")
    sp.set_defaults(func=cmd_serve)

    p = sub.add_parser("set", help="set a key")
    p.add_argument("key")
    p.add_argument("value")
    p.add_argument("--if-absent", action="store_true",
                   help="atomic set-if-absent (exit 1 when taken)")
    p.set_defaults(func=cmd_set)

    p = sub.add_parser("get", help="read a key (exit 1 when absent)")
    p.add_argument("key")
    p.set_defaults(func=cmd_get)

    p = sub.add_parser("bget", help="blocking read with a deadline")
    p.add_argument("key")
    p.add_argument("--timeout-ms", type=float, default=5000)
    p.set_defaults(func=cmd_bget)

    p = sub.add_parser("dir", help="list keys under a prefix")
    p.add_argument("prefix", nargs="?", default="")
    p.set_defaults(func=cmd_dir)

    p = sub.add_parser("del", help="delete a key")
    p.add_argument("key")
    p.set_defaults(func=cmd_del)

    p = sub.add_parser("ping", help="round-trip liveness probe")
    p.set_defaults(func=cmd_ping)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
