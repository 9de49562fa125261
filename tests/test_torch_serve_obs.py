"""The port's serving-plane observability on the CPU: end-to-end request
tracing, live ``/metrics`` + ``/healthz`` + ``/statusz``, first-call
profiling of the cached programs, SLO burn-rate alerting and the
single-flight program cache — the port counterparts of
``tests/test_serve_obs.py`` — and the event schema across the packages:
the same traffic through the JAX package's server and the port's emits
the same serving events with the same keys, and the report renders both
alike."""

import json
import re
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dpgo_tpu import obs as jobs
from dpgo_tpu.config import AgentParams as JParams
from dpgo_tpu.serve import SolveRequest as JRequest
from dpgo_tpu.serve import SolveServer as JServer
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.obs.report import (live_report, render_report,
                                       render_statusz, serving_stats)
from dpgo_tpu_torch.serve import (ExecutableCache, OverCapacityError,
                                  ServeSLO, SolveRequest, SolveServer)

PARAMS = AgentParams(d=3, r=5, num_robots=2)

_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*")*\})? '
    r'(-?\d+(\.\d+)?([eE][-+]?\d+)?|NaN|\+Inf|-Inf)$')


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=24, seed=0, num_lc=5):
    return make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.01,
                             trans_noise=0.01)[0]


def _request(meas, **kw):
    kw.setdefault("params", PARAMS)
    kw.setdefault("max_iters", 4)
    kw.setdefault("grad_norm_tol", 1e-12)
    kw.setdefault("eval_every", 2)
    return SolveRequest(meas=meas, num_robots=2, **kw)


def _server(**kw):
    return SolveServer(device="cpu", **kw)


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def _spans(events):
    return [e for e in events if e.get("event") == "span"]


def test_serving_observability_end_to_end(tmp_path):
    """A traced serving run: every completed request shows admission ->
    queue_wait -> dispatch -> reply spans with a flow arrow into its
    shared batch ``dispatch`` span; ``/metrics`` returns parseable
    Prometheus text with the cache build/hit counters and per-tenant SLO
    burn gauges; ``/statusz`` and ``report --live`` agree; every cached
    program's first call is recorded."""
    run_dir = str(tmp_path / "run")
    n_req = 4
    with obs.run_scope(run_dir):
        with _server(max_batch=2, batch_window_s=0.05, quantum=64,
                     slo=ServeSLO(latency_s=1e-9, window_s=60.0),
                     metrics_port=0) as srv:
            assert srv.sidecar is not None and srv.sidecar.port > 0
            for wave in range(2):
                wave_tickets = [
                    srv.submit(_request(_problem(n=24 + k, seed=2 * wave + k),
                                        tenant=f"t{k % 2}"))
                    for k in range(2)]
                for t in wave_tickets:
                    t.result(timeout=600)
            shed = srv.submit(_request(_problem(), deadline_s=0.0))
            with pytest.raises(OverCapacityError):
                shed.result(timeout=60)
            base = f"http://{srv.sidecar.host}:{srv.sidecar.port}"
            code, prom = _get(base + "/metrics")
            assert code == 200
            code, hz = _get(base + "/healthz")
            assert code == 200 and json.loads(hz)["ok"] is True
            code, st = _get(base + "/statusz")
            assert code == 200
            status = json.loads(st)
            assert live_report(f"{srv.sidecar.host}:{srv.sidecar.port}") == 0

    for line in prom.splitlines():
        if line and not line.startswith("#"):
            assert _PROM_SAMPLE.match(line), f"bad exposition line: {line!r}"
    assert 'serve_cache_requests_total{outcome="compile"}' in prom
    assert 'serve_cache_requests_total{outcome="hit"}' in prom
    assert "serve_slo_burn_rate" in prom and 'tenant="t0"' in prom
    assert "serve_compile_seconds_total" in prom
    assert "serve_device_time_seconds_total" in prom

    assert status["queue_depth"] == 0
    assert status["requests_served"] == n_req
    assert status["cache"]["compiles"] >= 1
    assert status["replica"]["device"] == {"platform": "cpu", "ordinal": 0}
    assert status["slo"]["t0"]["latency_burn"] > 1.0
    assert render_statusz(status)

    events = obs.read_events(f"{run_dir}/events.jsonl")
    spans = _spans(events)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    for name in ("admission", "prepare", "queue_wait", "dispatch",
                 "batch_member", "reply", "stack", "device_dispatch",
                 "slice", "shed"):
        assert name in by_name, f"missing span {name!r}"
    dispatch_ids = {s["span"] for s in by_name["dispatch"]}
    dispatch_traces = {s["trace"] for s in by_name["dispatch"]}
    req_traces = {s["trace"] for s in by_name["admission"]
                  if s.get("outcome") == "queued"}
    assert len(req_traces) == n_req + 1
    completed = {s["trace"] for s in by_name["reply"]}
    assert len(completed) == n_req and completed <= req_traces
    assert {s["link_trace"] for s in by_name["batch_member"]} == completed
    assert all(s["trace"] in dispatch_traces
               for s in by_name["batch_member"])
    assert all(s["link_span"] in dispatch_ids for s in by_name["reply"])
    assert by_name["shed"][0]["reason"] == "deadline"
    assert all(s["parent"] in dispatch_ids for s in by_name["stack"])

    compiles = [e for e in events if e.get("event") == "compile_profile"]
    assert {c["label"] for c in compiles} >= {"segment", "metrics",
                                              "epilogue:off"}
    for c in compiles:
        assert c["first_call_s"] > 0 and "key" in c and c["launches"] == 0

    burns = [e for e in events if e.get("event") == "anomaly"
             and e.get("kind") == "slo_burn"]
    assert {b["tenant"] for b in burns if b["slo"] == "latency"} == \
        {"t0", "t1"}

    from dpgo_tpu_torch.obs import timeline

    path = timeline.write_chrome_trace(str(tmp_path / "trace.json"),
                                       timeline.merge([run_dir]))
    assert timeline.validate_chrome_trace(path)["spans"] >= len(spans)
    arrows = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "s"]
    assert len(arrows) >= 2 * n_req

    text = render_report(run_dir)
    assert "serving:" in text and "slo burn: tenant" in text
    stats = serving_stats(events)
    assert stats["slo"]["t0"]["alerts"] >= 1 and not stats["no_traffic"]


def _serving_events(run_dir):
    events = obs.read_events(f"{run_dir}/events.jsonl")
    return {e["event"]: set(e) for e in events
            if e.get("event") in ("serve_request", "serve_batch",
                                  "serve_shed")}


def test_serving_event_schema_equals_jax(tmp_path):
    """The same two requests and one shed through both packages' servers:
    the ``serve_request`` / ``serve_batch`` / ``serve_shed`` events carry
    the same keys, and both runs' reports carry a serving section with
    the same tenants and shed reasons."""
    meas = [_problem(n=24 + k, seed=k) for k in range(2)]
    jp = JParams(d=3, r=5, num_robots=2)
    kw = dict(max_iters=4, grad_norm_tol=1e-12, eval_every=2)
    with jobs.run_scope(str(tmp_path / "jax")):
        with JServer(max_batch=2, batch_window_s=0.05, quantum=64) as srv:
            ts = [srv.submit(JRequest(meas=m, num_robots=2, params=jp,
                                      tenant=f"t{k}", **kw))
                  for k, m in enumerate(meas)]
            for t in ts:
                t.result(timeout=300)
            with pytest.raises(Exception):
                srv.submit(JRequest(meas=meas[0], num_robots=2, params=jp,
                                    deadline_s=0.0, **kw)).result(60)
    with obs.run_scope(str(tmp_path / "port")):
        with _server(max_batch=2, batch_window_s=0.05, quantum=64) as srv:
            ts = [srv.submit(_request(m, tenant=f"t{k}"))
                  for k, m in enumerate(meas)]
            for t in ts:
                t.result(timeout=300)
            with pytest.raises(OverCapacityError):
                srv.submit(_request(meas[0], deadline_s=0.0)).result(60)
    a = _serving_events(tmp_path / "jax")
    b = _serving_events(tmp_path / "port")
    assert set(a) == set(b) == {"serve_request", "serve_batch", "serve_shed"}
    for k in a:
        assert a[k] == b[k], k
    sa = serving_stats(obs.read_events(str(tmp_path / "jax" /
                                           "events.jsonl")))
    sb = serving_stats(obs.read_events(str(tmp_path / "port" /
                                           "events.jsonl")))
    assert set(sa["tenants"]) == set(sb["tenants"]) == {"t0", "t1"}
    assert [s["reason"] for s in sa["shed"]] == \
        [s["reason"] for s in sb["shed"]]


def test_shed_only_run_reports_no_traffic(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    with obs.run_scope(run_dir):
        with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
            t = srv.submit(_request(_problem(), deadline_s=0.0))
            with pytest.raises(OverCapacityError):
                t.result(timeout=60)
    stats = serving_stats(obs.read_events(f"{run_dir}/events.jsonl"))
    assert stats is not None and stats["no_traffic"] is True
    assert stats["tenants"] == {}
    text = render_report(run_dir)
    assert "no completed requests (no traffic)" in text
    assert "shed: tenant default x1 (deadline)" in text
    from dpgo_tpu_torch.obs.report import main as report_main

    assert report_main([run_dir]) == 0
    assert report_main([run_dir, "--json"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out)["serving"]["no_traffic"] is True


def test_live_report_unreachable_is_clean(capsys):
    assert live_report("127.0.0.1:9") == 2
    assert "cannot scrape" in capsys.readouterr().err


def test_executable_cache_single_flight():
    """Parallel get() on one fingerprint invokes the builder once;
    everyone else blocks on that build and counts as a hit."""
    cache = ExecutableCache()
    fp = {"solver": "x", "rank": 5}
    n = 8
    started = threading.Barrier(n)
    build_entered = threading.Event()
    release_build = threading.Event()
    builds = []

    def builder():
        builds.append(threading.get_ident())
        build_entered.set()
        assert release_build.wait(30)
        return object()

    results = [None] * n

    def go(k):
        started.wait(30)
        results[k] = cache.get(fp, builder)

    threads = [threading.Thread(target=go, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    assert build_entered.wait(30)
    release_build.set()
    for th in threads:
        th.join(30)
    assert len(builds) == 1
    assert all(r is results[0] and r is not None for r in results)
    assert cache.stats() == {"entries": 1, "compiles": 1, "hits": n - 1}


def test_executable_cache_failed_build_retries():
    cache = ExecutableCache()
    fp = {"solver": "y"}
    calls = []

    def bad():
        calls.append(1)
        raise RuntimeError("build exploded")

    with pytest.raises(RuntimeError):
        cache.get(fp, bad)
    sentinel = object()
    assert cache.get(fp, lambda: sentinel) is sentinel
    assert cache.compiles == 1 and len(calls) == 1


def test_wire_trace_context_joins_server_trace(tmp_path):
    """A client-stamped wire trace context makes the server's
    ``frontend`` span join the client's trace and link back to its
    span."""
    from dpgo_tpu_torch.comms.protocol import (ORIGIN_SERVE_CLIENT,
                                               pack_trace_entries)
    from dpgo_tpu_torch.serve.frontend import _pack_str, handle_request

    with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        frame = {"op": _pack_str("ping")}
        frame.update(pack_trace_entries(0x1234, 0x5678,
                                        ORIGIN_SERVE_CLIENT))
        assert int(handle_request(srv, frame)["ok"]) == 1
        assert "_trace" not in frame
        with obs.run_scope(str(tmp_path / "run")):
            frame = {"op": _pack_str("ping")}
            frame.update(pack_trace_entries(0x1234, 0x5678,
                                            ORIGIN_SERVE_CLIENT))
            assert int(handle_request(srv, frame)["ok"]) == 1
    events = obs.read_events(str(tmp_path / "run" / "events.jsonl"))
    fr = [e for e in _spans(events) if e["name"] == "frontend"]
    assert len(fr) == 1
    assert fr[0]["trace"] == f"{0x1234:016x}"
    assert fr[0]["link_span"] == f"{0x5678:016x}"
    assert fr[0]["link_robot"] == ORIGIN_SERVE_CLIENT
