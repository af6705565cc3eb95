"""The port's ``mxtrace``, ``mxtop --follow`` and the hung-collective
drill against the JAX package's, on the CPU.

Twins of ``tests/test_tracing.py``'s mxtrace tests, of
``test_mxtop_follow_survives_rotation`` and of ``test_dist_flight_drill``.
The same seeded records and flight dumps go through
``tools/mxtrace.py`` and ``python -m mxnet_tpu_torch.tools.mxtrace``;
the Chrome traces must be equal.  The twins of the two JAX tests that
fail in the reference (``test_mxtop_follow_survives_rotation``,
``test_dist_flight_drill``) assert the intended behaviour, and every
wait in them has a timeout of its own.
"""
import argparse
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

import torch_obs_records as recs_mod

from mxnet_tpu_torch.tools import mxtrace as tmxtrace

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))
import launch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jmxtrace", os.path.join(_ROOT, "tools", "mxtrace.py"))
jmxtrace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jmxtrace)


def _env():
    return dict(os.environ, PYTHONPATH=_ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flight_dump(directory, rank, seq):
    with open(os.path.join(directory, "flight-rank%05d-0.json" % rank),
              "w") as f:
        json.dump({"reason": "watchdog_timeout", "rank": rank,
                   "wall_ms": recs_mod.BASE_MS + 500, "absent_ranks": [1],
                   "pending_collectives": [
                       {"op": "allreduce", "seq": seq,
                        "launch_wall_ms": recs_mod.BASE_MS + 400,
                        "participants": [0, 1]}],
                   "events": []}, f)


# ----------------------------------------------------------------------
# mxtrace
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_mxtrace_build_trace_equal(tmp_path, seed):
    """The same dir (seeded records of two ranks, a torn line, a flight
    dump) through both packages' readers and ``build_trace``."""
    d = recs_mod.write_dir(str(tmp_path / "tel"), recs_mod.records(seed))
    _flight_dump(d, 0, 12)
    recs, dumps = tmxtrace.read_records(d), tmxtrace.read_flight_dumps(d)
    assert recs == jmxtrace.read_records(d)
    assert dumps == jmxtrace.read_flight_dumps(d)
    got = tmxtrace.build_trace(recs, dumps)
    assert recs_mod.roundtrip(got) == recs_mod.roundtrip(
        jmxtrace.build_trace(recs, dumps))
    evs = got["traceEvents"]
    names = {(e["pid"], e["args"]["name"]) for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {(0, "rank 0"), (1, "rank 1")}
    steps = [e for e in evs if e["ph"] == "X"
             and e["tid"] == tmxtrace.TID_STEP]
    assert len(steps) == 24 and {e["name"] for e in steps} == {"step"}
    starts = [e for e in evs if e["ph"] == "s"]
    finishes = [e for e in evs if e["ph"] == "f"]
    assert len(starts) == len(finishes) == 12
    assert {e["name"] for e in evs if e["ph"] == "X"
            and e["tid"] == tmxtrace.TID_SERVE} >= {"lm device", "mlp pack"}
    assert any(e["ph"] == "i" and e["name"] == "PENDING allreduce seq=12"
               for e in evs)


def test_mxtrace_cli(tmp_path):
    """Twins of ``test_mxtrace_merges_ranks_and_stitches_flows``,
    ``test_mxtrace_ingests_flight_dumps`` and
    ``test_mxtrace_empty_dir_exits_1``: the CLI writes the document
    ``build_trace`` gives (to a file and to stdout); an empty dir exits
    1, a missing one 2."""
    d = recs_mod.write_dir(str(tmp_path / "tel"), recs_mod.records(3))
    _flight_dump(d, 1, 4)
    out = str(tmp_path / "trace.json")
    assert tmxtrace.main([d, "-o", out]) == 0
    want = tmxtrace.build_trace(tmxtrace.read_records(d),
                                tmxtrace.read_flight_dumps(d))
    assert json.load(open(out)) == recs_mod.roundtrip(want)
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.mxtrace", d],
        cwd=_ROOT, capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == recs_mod.roundtrip(want)
    os.makedirs(str(tmp_path / "empty"))
    assert tmxtrace.main([str(tmp_path / "empty")]) == 1
    assert tmxtrace.main([str(tmp_path / "missing")]) == 2


# ----------------------------------------------------------------------
# mxtop --follow across a rotation
# ----------------------------------------------------------------------
def _reader(stream, sink):
    for line in iter(stream.readline, ""):
        sink.append(line)


def _docs(text):
    decoder = json.JSONDecoder()
    docs, idx = [], 0
    while idx < len(text):
        while idx < len(text) and text[idx].isspace():
            idx += 1
        try:
            doc, idx = decoder.raw_decode(text, idx)
        except ValueError:
            break
        docs.append(doc)
    return docs


def _wait_for(pred, timeout, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError("timed out after %gs waiting for %s" % (timeout,
                                                                what))


def test_mxtop_follow_survives_rotation(tmp_path):
    """Twin of the JAX test of the same name: a following ``mxtop``
    keeps reporting records appended after the live file was rotated,
    and Ctrl-C ends it with exit 0.  Each report is flushed as it is
    rendered, so the test waits for the first report (however long the
    tool takes to start) before it rotates, with a timeout a wait."""
    d = str(tmp_path / "tel")
    os.makedirs(d)
    path = os.path.join(d, "events-rank00000.jsonl")

    def rec(i):
        return json.dumps({"run_id": "rot", "rank": 0, "kind": "step",
                           "step": i, "wall_ms": 1000 + i,
                           "dur_ms": 2.0}) + "\n"

    with open(path, "w") as f:
        f.write(rec(1) + rec(2))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.mxtop", d,
         "--follow", "--json", "--interval", "0.2"],
        cwd=_ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=_reader, args=(proc.stdout, lines),
                              daemon=True)
    reader.start()

    def steps_seen(n):
        docs = _docs("".join(lines))
        return bool(docs) and docs[-1]["per_rank"]["0"]["steps"] == n

    try:
        _wait_for(lambda: steps_seen(2), 90, "the first report")
        os.rename(path, path + ".1")      # the writer rotates ...
        with open(path, "w") as f:        # ... and keeps appending
            f.write(rec(3))
        _wait_for(lambda: steps_seen(3), 30, "the post-rotation step")
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)
    reader.join(timeout=10)
    docs = _docs("".join(lines))
    assert docs[-1]["per_rank"]["0"]["steps"] == 3
    assert docs[-1]["per_rank"]["0"]["last_step"] == 3


# ----------------------------------------------------------------------
# the hung-collective drill
# ----------------------------------------------------------------------
FLIGHT_DRILL = r"""
import glob, json, os, sys, time
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore as kvmod
from mxnet_tpu_torch import observability as obs
from mxnet_tpu_torch.kvstore import _dist_client, _stop_heartbeat
from mxnet_tpu_torch.resilience import ResilienceError, run_with_timeout
ROUNDS = 3
kvmod._HB_INTERVAL = 0.5              # stale after 5 intervals: 2.5 s
HANG_TIMEOUT_S = 4.0                  # longer than the staleness window
with mx.cpu():
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    kv.init("w", mx.nd.ones((64,)) * (rank + 1))
    out = mx.nd.zeros((64,))
    for _ in range(ROUNDS):
        kv.push("w", mx.nd.ones((64,)) * (rank + 1))
        kv.pull("w", out=out)
    assert not obs.flight.pending_collectives()
    client = _dist_client()
    if rank == 1:
        # a wedged peer: its heartbeat stops and it never joins
        # allreduce seq=ROUNDS; it exits once rank 0 is done
        obs.flush()
        _stop_heartbeat()
        client.key_value_set("drill_flight/dying", "1")
        client.blocking_key_value_get("drill_flight/done", 120000)
        client.key_value_set("drill_flight/bye", "1")
        print("FLIGHT DRILL OK", flush=True)
        os._exit(0)
    client.blocking_key_value_get("drill_flight/dying", 60000)
    t0 = time.time()
    last = mx.nd.ones((64,))          # the watchdog's thread has no scope
    try:
        run_with_timeout(lambda: kv.push("w", last),
                         HANG_TIMEOUT_S, phase="drill_hung_push",
                         step=ROUNDS)
        raise SystemExit("push completed against a wedged peer")
    except ResilienceError:
        pass
    waited = time.time() - t0
    obs.flush()
    client.key_value_set("drill_flight/done", "1")
    # rank 0 hosts the store: it stays up until rank 1 has read "done"
    client.blocking_key_value_get("drill_flight/bye", 60000)
    print("waited %.2f" % waited, flush=True)
    print("FLIGHT DRILL OK", flush=True)
    os._exit(0)
"""


def test_dist_flight_drill(tmp_path):
    """Twin of the JAX test of the same name over gloo: with rank 1
    wedged (its heartbeat stopped, allreduce seq=3 never joined), rank
    0's watchdog dump names the hung collective's (op, seq) and the
    absent rank; ``mxtrace`` merges the run's logs into a Chrome trace
    with per-rank tracks, cross-rank flow arrows and the pending
    marker.  A free port, the subprocess timeouts and the KV waits each
    bound the drill."""
    script = tmp_path / "drill.py"
    script.write_text(FLIGHT_DRILL)
    tel = str(tmp_path / "tel")
    args = argparse.Namespace(coordinator="127.0.0.1", port=_free_port(),
                              num_workers=2)
    procs = []
    for rank in range(2):
        env = launch.build_env(rank, args)
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.update(MXTPU_TELEMETRY="1", MXTPU_TELEMETRY_DIR=tel,
                   MXTPU_RUN_ID="flightdrill")
        env.pop("MXTPU_STEP_TIMEOUT_S", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append(out)
            assert p.returncode == 0 and "FLIGHT DRILL OK" in out, \
                out[-2000:] + err[-3000:]
    finally:
        for p in procs:
            p.kill()
    waited = float(outs[0].split("waited ")[1].split()[0])
    assert 4.0 <= waited < 30.0
    dumps = sorted(f for f in os.listdir(tel)
                   if f.startswith("flight-rank00000"))
    assert dumps, os.listdir(tel)
    doc = json.load(open(os.path.join(tel, dumps[-1])))
    assert doc["reason"] == "watchdog_timeout"
    assert ("allreduce", 3) in {(e["op"], e["seq"])
                                for e in doc["pending_collectives"]}
    assert 1 in doc["absent_ranks"]
    assert doc["events"]
    assert doc["collective_seq"]["allreduce"] == 4
    out = str(tmp_path / "trace.json")
    assert tmxtrace.main([tel, "-o", out]) == 0
    evs = json.load(open(out))["traceEvents"]
    assert {e["pid"] for e in evs if e["ph"] == "M"} == {0, 1}
    starts = [e for e in evs if e["ph"] == "s"]
    finishes = [e for e in evs if e["ph"] == "f"]
    assert len(starts) == len(finishes) == 3     # seqs 0-2 on both ranks
    assert {e["pid"] for e in starts + finishes} == {0, 1}
    assert any(e["ph"] == "i" and "PENDING allreduce seq=3" in e["name"]
               for e in evs)
