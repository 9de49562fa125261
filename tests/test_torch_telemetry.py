"""Telemetry on the port's solve paths, on the CPU in float64, against the
JAX package on the same inputs:

* the event stream of ``solve_rbcd`` — per-eval driver and verdict loop —
  has the JAX package's event names and fields, values at rtol 1e-9
  (timings, run ids and span ids excepted; ``compile_profile`` records
  the port's first call, not an XLA compile, so only its key and label
  are compared), and the same registry series;
* the certificate's telemetry (``certify_solution`` and the device
  epilogue's ``decide_device_certificate``) matches JAX's counters;
* the flight recorder: the port's copies of ``tests/test_recorder.py``'s
  cases, and a black box the JAX package wrote replays in the port at
  rtol 1e-9;
* ``obs.devprof`` on synthetic ``torch.profiler`` Chrome traces, and a real
  profiler window on the CPU;
* telemetry off is zero overhead (``tests/test_obs.py``'s contract).
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import obs as jobs
from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import RobustCostParams as JRobust
from dpgo_tpu.config import RobustCostType as JType
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.obs.recorder import FlightRecorder as JFlightRecorder
from dpgo_tpu.obs.recorder import inject_nan as j_inject_nan
from dpgo_tpu.utils.partition import partition_contiguous as j_partition
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                   RobustCostType, Schedule, SolverParams)
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.obs import devprof
from dpgo_tpu_torch.obs import run as run_mod
from dpgo_tpu_torch.obs.events import EventStream, read_events
from dpgo_tpu_torch.obs.recorder import (FlightRecorder, decode_config,
                                         encode_config, inject_nan,
                                         load_blackbox, replay)
from dpgo_tpu_torch.obs.recorder import main as recorder_main
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements

RTOL = 1e-9
#: Fields that are clocks, durations or random ids: never compared.
TIMING = {"run", "seq", "t_wall", "t_mono", "duration_s", "round_latency_s",
          "dur_s", "t0_mono", "t0_wall", "span", "trace", "latency_s",
          "f64_fallback_s"}


@pytest.fixture(autouse=True)
def _one_thread_no_run():
    obs.end_run()
    jobs.end_run()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.end_run()
    jobs.end_run()


def _tiny_problem(n=40, num_lc=20, seed=0):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=num_lc, rot_noise=0.01,
                                trans_noise=0.01)
    return meas


def _params(mod=None, **kw):
    if mod is None:
        return AgentParams(
            d=3, r=5, num_robots=2, rel_change_tol=1e-16,
            robust=RobustCostParams(cost_type=RobustCostType.GNC_TLS),
            robust_opt_inner_iters=4, **kw)
    return JAgentParams(
        d=3, r=5, num_robots=2, rel_change_tol=1e-16,
        robust=JRobust(cost_type=JType.GNC_TLS),
        robust_opt_inner_iters=4, **kw)


def _close(a, b, where):
    if isinstance(a, dict) and isinstance(b, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is b, where
        elif math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), where
        else:
            assert a == pytest.approx(b, rel=RTOL, abs=1e-15), where
    else:
        assert a == b, where


def _compare_streams(port_evs, jax_evs):
    assert [e["event"] for e in port_evs] == [e["event"] for e in jax_evs]
    for i, (p, j) in enumerate(zip(port_evs, jax_evs)):
        where = f"event {i} ({p['event']})"
        if p["event"] == "compile_profile":
            assert (p["key"], p["label"]) == (j["key"], j["label"]), where
            continue
        p = {k: v for k, v in p.items() if k not in TIMING}
        j = {k: v for k, v in j.items() if k not in TIMING}
        if p["event"] == "run_summary":
            p["fingerprint"].pop("version"), j["fingerprint"].pop("version")
        _close(p, j, where)


def _snapshot(d):
    with open(os.path.join(d, "metrics.json")) as fh:
        return json.load(fh)["metrics"]


@pytest.mark.parametrize("verdict_every", [None, 4])
def test_solve_event_stream_matches_jax(tmp_path, verdict_every):
    """GNC solve long enough for weight updates and several verdict
    boundaries: the same events, fields and values as the JAX package's."""
    meas = _tiny_problem()
    kw = dict(max_iters=16, eval_every=2, grad_norm_tol=1e-9,
              verdict_every=verdict_every)
    with obs.run_scope(str(tmp_path / "port")):
        res = rbcd.solve_rbcd(meas, 2, params=_params(), device="cpu",
                              dtype=torch.float64, **kw)
    with jobs.run_scope(str(tmp_path / "jax")):
        jres = jrbcd.solve_rbcd(meas, 2, params=_params(jobs),
                                dtype=jnp.float64, **kw)
    assert res.iterations == jres.iterations == 16
    evs = read_events(str(tmp_path / "port" / "events.jsonl"))
    jevs = read_events(str(tmp_path / "jax" / "events.jsonl"))
    _compare_streams(evs, jevs)
    costs = [e["value"] for e in evs if e.get("metric") == "solver_cost"]
    assert costs == res.cost_history
    snap, jsnap = _snapshot(tmp_path / "port"), _snapshot(tmp_path / "jax")
    timing = {"round_latency_seconds", "agent_round_latency_seconds",
              "solve_compile_seconds_total", "solve_compile_flops",
              "solve_compile_temp_bytes", "solve_bytes_per_flop",
              "solve_first_call_launches",
              "solve_first_call_device_seconds"}
    assert set(snap) - timing == set(jsnap) - timing
    for name in set(snap) - timing:
        _close(snap[name]["series"], jsnap[name]["series"], name)


def test_host_syncs_per_100_rounds_is_two_per_window(tmp_path,
                                                      monkeypatch):
    """The verdict loop with telemetry on reads the word and the history
    per non-terminal boundary and the epilogue once: 2 x 100/K, every read
    through ``_host_fetch`` (the gate the card holds the production arm
    to); with telemetry off, the words and the epilogue."""
    meas = _tiny_problem()
    params = AgentParams(d=3, r=5, num_robots=2, rel_change_tol=0.0)
    calls = []
    real = rbcd._host_fetch
    monkeypatch.setattr(rbcd, "_host_fetch",
                        lambda x: calls.append(1) or real(x))
    kw = dict(params=params, max_iters=32, grad_norm_tol=0.0,
              verdict_every=8, device="cpu")
    rbcd.solve_rbcd(meas, 2, **kw)
    assert len(calls) == 32 // 8 + 1
    calls.clear()
    with obs.run_scope(str(tmp_path / "run")) as run:
        rbcd.solve_rbcd(meas, 2, **kw)
        rate = run.registry.snapshot()[
            "host_syncs_per_100_rounds"]["series"][0]["value"]
    assert rate == 2 * 100 / 8
    assert len(calls) == 2 * 32 // 8


def test_certificate_telemetry_matches_jax(tmp_path):
    from dpgo_tpu.models import certify as jcertify
    from dpgo_tpu.types import edge_set_from_measurements as j_edges
    from dpgo_tpu_torch.models import certify, local_pgo
    from dpgo_tpu_torch.types import edge_set_from_measurements

    meas = _tiny_problem(n=20, num_lc=8)
    res = local_pgo.solve_local(meas, rank=5, device="cpu")
    X = res.X
    edges = edge_set_from_measurements(meas, dtype=torch.float64,
                                       device="cpu")
    with obs.run_scope(str(tmp_path / "port")):
        cert = certify.certify_solution(X, edges)
        # The device payload of a solve_local point refuses on its
        # deflation bound; the host f64 fallback decides (and is timed).
        pay = certify.device_certificate_payload(X, edges)
        dcert = certify.decide_device_certificate(
            pay, 1e-5, float(torch.finfo(torch.float64).eps),
            f64_solve=certify.host_f64_solve(
                X, edges, 1e-5 * float(pay["wscale"]),
                warm=pay["direction"]))
    with jobs.run_scope(str(tmp_path / "jax")):
        jcert = jcertify.certify_solution(
            jnp.asarray(X.numpy()), j_edges(meas, dtype=jnp.float64))
    assert cert.certified == jcert.certified and dcert.certified
    evs = [e for e in read_events(str(tmp_path / "port" / "events.jsonl"))
           if e["event"] == "certificate"]
    (jev,) = [e for e in read_events(str(tmp_path / "jax" / "events.jsonl"))
              if e["event"] == "certificate"]
    assert [set(e) - TIMING for e in evs][0] == set(jev) - TIMING
    for k in ("certified", "decidable", "tol", "dim"):
        assert evs[0][k] == jev[k], k
    assert evs[0]["eigenvalue_gap"] == pytest.approx(
        (cert.lambda_min_f64 if cert.lambda_min_f64 is not None
         else cert.lambda_min) + cert.tol)
    assert evs[1]["source"] == "device_epilogue"
    assert evs[1]["device_verdict"] == "refuse"
    assert evs[1]["f64_fallback_s"] > 0.0
    snap, jsnap = _snapshot(tmp_path / "port"), _snapshot(tmp_path / "jax")
    assert snap["cert_status_total"]["series"][0]["labels"] == \
        jsnap["cert_status_total"]["series"][0]["labels"]
    assert snap["certificates_evaluated"]["series"][0]["value"] == 2
    (fb,) = snap["cert_f64_fallback_seconds_total"]["series"]
    assert fb["labels"] == {"source": "device_epilogue"} and fb["value"] > 0
    assert {tuple(sorted(s["labels"].items()))
            for s in snap["cert_status_total"]["series"]} == {
        (("source", "certify_solution"), ("status", "accept")),
        (("source", "device_epilogue"), ("status", "accept"))}


# ---------------------------------------------------------------------------
# The flight recorder (tests/test_recorder.py's cases on the port)
# ---------------------------------------------------------------------------

def _run_recorded_solve(run, params, meas, max_iters=10, eval_every=2,
                        fault=None, crash_at=None, snapshot_every=1,
                        verdict_every=None):
    """``run_rbcd`` driven as ``solve_rbcd`` drives it, with a segment
    wrapper that injects ``inject_nan`` the first time the round count
    crosses ``fault['iteration']``."""
    rec = FlightRecorder.attach(run, snapshot_every=snapshot_every)
    if fault is not None:
        rec.set_context(fault=fault)
    part = partition_contiguous(meas, params.num_robots)
    graph, meta = rbcd.build_graph(part, params.r, torch.float64,
                                   device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    state = rbcd.init_state(graph, meta, X0, params=params)
    rounds = {"n": 0}
    applied = {"v": False}

    def seg(s, k, uw, rs):
        s = rbcd.rbcd_segment(s, graph, k, meta, params,
                              first_update_weights=uw, first_restart=rs)
        rounds["n"] += k
        if crash_at is not None and rounds["n"] >= crash_at:
            raise RuntimeError("synthetic driver crash")
        if fault is not None and not applied["v"] \
                and rounds["n"] >= fault["iteration"]:
            s = inject_nan(s, fault["agent"], fault["pose"])
            applied["v"] = True
        return s

    res = rbcd.run_rbcd(state, graph, meta, seg, part, max_iters,
                        grad_norm_tol=1e-12, eval_every=eval_every,
                        dtype=torch.float64, params=params,
                        verdict_every=verdict_every)
    return res, rec


def test_config_roundtrip():
    p = _params(schedule=Schedule.COLORED, acceleration=False,
                solver=SolverParams(pallas_tcg=False, max_inner_iters=7))
    enc = encode_config(p)
    json.dumps(enc)
    assert decode_config(enc) == p


def test_ring_is_bounded_and_snapshots_rotate(tmp_path):
    with obs.run_scope(str(tmp_path / "r")) as run:
        rec = FlightRecorder(run, capacity=4, snapshot_every=2,
                             max_snapshots=2)
        for i in range(10):
            rec.record_eval(i, {"cost": float(i), "grad_norm": 1.0})
        assert [r["iteration"] for r in rec.ring] == [6, 7, 8, 9]
        assert rec.snapshots.maxlen == 2


def test_dump_writes_npz_and_jsonl(tmp_path):
    d = str(tmp_path / "r")
    with obs.run_scope(d) as run:
        run.set_fingerprint(dataset="synthetic-tiny")
        rec = FlightRecorder.attach(run)
        rec.record_eval(2, {"cost": 1.5, "grad_norm": 0.5,
                            "rel_change": np.array([0.1, float("nan")])})
        path = rec.dump("unit-test")
        assert rec.dump("second-call") == path  # first dump wins
    arrays = dict(np.load(path))
    assert arrays["ring_cost"].tolist() == [1.5]
    assert not arrays["ring_healthy"][0]
    with open(os.path.join(d, "blackbox.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    assert lines[0]["kind"] == "context" and lines[0]["reason"] == "unit-test"
    assert lines[0]["fingerprint"]["dataset"] == "synthetic-tiny"
    assert lines[1]["kind"] == "round" and lines[1]["iteration"] == 2
    (ev,) = [e for e in read_events(os.path.join(d, "events.jsonl"))
             if e["event"] == "blackbox_dump"]
    assert ev["reason"] == "unit-test"


def test_replay_refuses_problemless_blackbox(tmp_path):
    with obs.run_scope(str(tmp_path / "r")) as run:
        rec = FlightRecorder.attach(run)
        rec.record_eval(1, {"cost": 1.0, "grad_norm": 1.0})
        path = rec.dump("no-problem")
    with pytest.raises(ValueError, match="not replayable"):
        replay(path, device="cpu")
    assert recorder_main(["--replay", path, "--device", "cpu"]) == 2


def test_clean_run_replays_bit_for_bit(tmp_path):
    with obs.run_scope(str(tmp_path / "run")) as run:
        _res, rec = _run_recorded_solve(run, _params(), _tiny_problem(),
                                        max_iters=10, snapshot_every=2)
        path = rec.dump("manual")
    rep = replay(path, device="cpu")
    assert rep.match, rep.mismatches
    assert rep.iterations
    assert rep.cost == rep.recorded_cost
    assert recorder_main(["--replay", path, "--device", "cpu"]) == 0


def test_nan_injection_anomaly_blackbox_and_exact_replay(tmp_path, capsys):
    d = str(tmp_path / "run")
    fault = {"iteration": 6, "agent": 1, "pose": 0}
    with obs.run_scope(d) as run:
        res, _ = _run_recorded_solve(run, _params(), _tiny_problem(),
                                     max_iters=10, fault=fault)
        assert res.iterations == 10
        assert math.isnan(res.cost_history[-1])
    evs = read_events(os.path.join(d, "events.jsonl"))
    anomalies = [e for e in evs if e["event"] == "anomaly"]
    assert anomalies[0]["kind"] == "non_finite"
    assert anomalies[0]["severity"] == "critical"
    assert anomalies[0]["iteration"] == fault["iteration"]
    (dump,) = [e for e in evs if e["event"] == "blackbox_dump"]
    assert dump["reason"] == "anomaly:non_finite"
    npz = os.path.join(d, "blackbox.npz")
    context, arrays = load_blackbox(npz)
    assert context["fault"] == fault
    nan_mask = [math.isnan(c) for c in arrays["ring_cost"].tolist()]
    assert nan_mask == [it >= fault["iteration"]
                        for it in arrays["ring_iteration"].tolist()]
    rep = replay(npz, device="cpu")
    assert rep.snapshot_iteration == 4
    assert rep.match, rep.mismatches
    assert rep.iterations == [6]
    assert recorder_main(["--replay", npz, "--device", "cpu"]) == 0
    assert "REPRODUCED bit-for-bit" in capsys.readouterr().out
    arrays2 = dict(np.load(npz))
    arrays2["ring_cost"] = arrays2["ring_cost"].copy()
    arrays2["ring_cost"][-1] = 123.0
    with open(npz, "wb") as fh:
        np.savez_compressed(fh, **arrays2)
    assert not replay(npz, device="cpu").match
    assert recorder_main(["--replay", npz, "--device", "cpu"]) == 1


def test_crash_dumps_blackbox(tmp_path):
    d = str(tmp_path / "run")
    with obs.run_scope(d) as run:
        with pytest.raises(RuntimeError, match="synthetic driver crash"):
            _run_recorded_solve(run, _params(), _tiny_problem(),
                                max_iters=10, crash_at=5)
    (dump,) = [e for e in read_events(os.path.join(d, "events.jsonl"))
               if e["event"] == "blackbox_dump"]
    assert dump["reason"] == "crash"


def test_report_renders_health_and_blackbox(tmp_path, capsys):
    from dpgo_tpu_torch.obs.report import main as report_main

    d = str(tmp_path / "run")
    with obs.run_scope(d):
        _run_recorded_solve(obs.get_run(), _params(), _tiny_problem(),
                            max_iters=8,
                            fault={"iteration": 6, "agent": 0, "pose": 1})
    assert report_main([d]) == 0
    out = capsys.readouterr().out
    assert "numerical health:" in out and "non_finite" in out
    assert "blackbox:" in out and "anomaly:non_finite" in out


def test_verdict_history_rows_bitwise_match_central_metrics():
    from dpgo_tpu_torch.types import edge_set_from_measurements

    meas, params = _tiny_problem(), _params()
    part = partition_contiguous(meas, params.num_robots)
    graph, meta = rbcd.build_graph(part, params.r, torch.float64,
                                   device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    state = rbcd.init_state(graph, meta, X0, params=params)
    n_total, num_meas = part.meas_global.num_poses, len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float64, device="cpu")
    central = rbcd._central_metrics_body(graph, edges_g, n_total, num_meas,
                                         telemetry=True)
    vstep = rbcd.make_verdict_program(
        graph, edges_g, n_total, num_meas, telemetry=True,
        grad_norm_tol=1e-12, robust_params=params.robust,
        health_cfg=obs.HealthConfig())
    vs = rbcd.init_verdict_state(4, meta.num_robots, torch.float64,
                                 telemetry=True, device="cpu")
    for k in range(4):
        state = rbcd.rbcd_segment(state, graph, 2, meta, params)
        vs = vstep(state.X, state.weights, state.ready, state.mu,
                   state.rel_change, state.iteration, vs)
        ref = central(state.X, state.weights, state.ready, state.mu,
                      state.rel_change)
        assert vs.hist[k].numpy().tobytes() == ref.numpy().tobytes()


def test_verdict_mode_replay_crosses_boundary_bit_for_bit(tmp_path):
    fault = {"iteration": 9, "agent": 1, "pose": 3}
    d = str(tmp_path / "run")
    with obs.run_scope(d) as run:
        _run_recorded_solve(run, _params(), _tiny_problem(), max_iters=16,
                            eval_every=2, fault=fault, verdict_every=4)
    npz = os.path.join(d, "blackbox.npz")
    ctx, _ = load_blackbox(npz)
    snaps = ctx["snapshots"]
    assert snaps and all(s["iteration"] % 4 == 0 for s in snaps)
    assert any(s["healthy"] for s in snaps)
    evs = read_events(os.path.join(d, "events.jsonl"))
    assert "non_finite" in {e.get("kind") for e in evs
                            if e.get("event") == "anomaly"}
    (end,) = [e for e in evs if e.get("event") == "solve_end"]
    assert end["verdict"]["anomaly"] == "non_finite"
    rep = replay(npz, device="cpu")
    assert rep.match, rep.mismatches
    assert recorder_main(["--replay", npz, "--device", "cpu"]) == 0


def test_verdict_mode_emits_identical_event_stream(tmp_path):
    meas, params = _tiny_problem(), _params()
    fault = {"iteration": 9, "agent": 1, "pose": 3}
    streams = {}
    for mode, k in (("per_eval", None), ("verdict", 8)):
        d = str(tmp_path / mode)
        with obs.run_scope(d) as run:
            _run_recorded_solve(run, params, meas, max_iters=16,
                                eval_every=2, fault=fault, verdict_every=k)
        streams[mode] = read_events(os.path.join(d, "events.jsonl"))

    def anomalies(evs):
        return [(e["kind"], e["severity"], e["iteration"])
                for e in evs if e.get("event") == "anomaly"]

    def metrics(evs, name):
        return [(e["iteration"], repr(e["value"])) for e in evs
                if e.get("event") == "metric" and e.get("metric") == name
                and e.get("phase") == "eval"]

    assert anomalies(streams["verdict"]) == anomalies(streams["per_eval"])
    assert anomalies(streams["verdict"])
    for name in ("solver_cost", "solver_grad_norm", "gnc_mu",
                 "gnc_inlier_fraction"):
        assert metrics(streams["verdict"], name) == \
            metrics(streams["per_eval"], name), name


@pytest.mark.parametrize("verdict_every", [None, 4])
def test_jax_blackbox_replays_in_the_port(tmp_path, verdict_every):
    """A black box the JAX package dumped (a NaN fault, GNC) loads and
    replays in the port: the same snapshot, the same evals, the recorded
    trajectory at rtol 1e-9 and the NaNs where JAX had them."""
    meas = _tiny_problem()
    params = _params(jobs)
    fault = {"iteration": 9, "agent": 1, "pose": 3}
    d = str(tmp_path / "jax")
    with jobs.run_scope(d) as run:
        rec = JFlightRecorder.attach(run, snapshot_every=1)
        rec.set_context(fault=fault)
        part = j_partition(meas, 2)
        graph, meta = jrbcd.build_graph(part, 5, jnp.float64)
        X0 = jrbcd.centralized_chordal_init(part, meta, graph, jnp.float64)
        state = jrbcd.init_state(graph, meta, X0, params=params)
        applied = {"n": 0, "v": False}

        def seg(s, k, uw, rs):
            s = jrbcd.rbcd_segment(s, graph, k, meta, params,
                                   first_update_weights=uw,
                                   first_restart=rs)
            applied["n"] += k
            if not applied["v"] and applied["n"] >= fault["iteration"]:
                s = j_inject_nan(s, fault["agent"], fault["pose"])
                applied["v"] = True
            return s

        step = lambda s, uw, rs: jrbcd.rbcd_step(s, graph, meta, params,
                                                 update_weights=uw,
                                                 restart=rs)
        jrbcd.run_rbcd(state, graph, meta, step, part, 16,
                       grad_norm_tol=1e-12, eval_every=2,
                       dtype=jnp.float64, params=params, segment=seg,
                       verdict_every=verdict_every)
    npz = os.path.join(d, "blackbox.npz")
    ctx, _ = load_blackbox(npz)
    assert ctx["replayable"] and decode_config(ctx["problem"]["params"]) \
        == _params()
    rep = replay(npz, device="cpu")
    assert rep.iterations
    assert [math.isnan(c) for c in rep.cost] == \
        [math.isnan(c) for c in rep.recorded_cost]
    assert any(math.isnan(c) for c in rep.cost)
    for a, b in zip(rep.cost + rep.grad_norm,
                    rep.recorded_cost + rep.recorded_grad_norm):
        if not math.isnan(b):
            assert a == pytest.approx(b, rel=RTOL)


# ---------------------------------------------------------------------------
# devprof on torch.profiler Chrome traces
# ---------------------------------------------------------------------------

def _kernel(name, ts, dur, tid, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "name": name, "args": {"stream": tid}}


def test_classify_op_prefix_table():
    for op in ("ncclDevKernel_AllReduce_Sum_f32_RING_LL",
               "ncclKernel_AllGather", "NCCLsomething"):
        assert devprof.classify_op(op) == "collective", op
    for op in ("rtr_full_cluster_kernel", "void at::native::elementwise",
               "Memcpy DtoH (Device -> Pinned)"):
        assert devprof.classify_op(op) == "compute", op


def test_attribute_trace_by_category_and_cross_lane_hiding():
    """Lane 1 (stream 7) runs a 40 us kernel then a 60 us NCCL all-reduce;
    lane 2 (stream 8) computes for 80 us.  Host events (``cpu_op``,
    ``cuda_runtime``) are not device time; an instant event is not a
    slice; a memcpy is device compute."""
    events = [
        _kernel("rtr_full_cluster_kernel", 0.0, 40.0, tid=7),
        _kernel("ncclDevKernel_AllReduce_Sum", 40.0, 60.0, tid=7),
        _kernel("kernel_operands_gather", 0.0, 70.0, tid=8),
        _kernel("Memcpy HtoD (Pinned -> Device)", 70.0, 10.0, tid=8,
                cat="gpu_memcpy"),
        {"ph": "X", "cat": "cpu_op", "pid": 9, "tid": 1, "ts": 0,
         "dur": 500, "name": "aten::add"},
        {"ph": "X", "cat": "cuda_runtime", "pid": 9, "tid": 1, "ts": 0,
         "dur": 5, "name": "cudaLaunchKernel"},
        {"ph": "i", "cat": "kernel", "pid": 0, "tid": 7, "ts": 5,
         "name": "marker"},
    ]
    att = devprof.attribute_trace(events, num_rounds=2)
    assert att["lanes"] == 2
    assert att["window_s"] == pytest.approx(100e-6)
    assert att["compute_s"] == pytest.approx(120e-6)
    assert att["collective_s"] == pytest.approx(60e-6)
    assert att["idle_s"] == pytest.approx(20e-6)
    assert att["collective_hidden_s"] == pytest.approx(40e-6)
    assert att["overlap_efficiency_measured"] == pytest.approx(2.0 / 3.0)
    assert att["per_round"]["collective_s"] == pytest.approx(30e-6)
    tops = {t["op"]: t for t in att["top_ops"]}
    assert tops["ncclDevKernel_AllReduce_Sum"]["kind"] == "collective"
    assert tops["rtr_full_cluster_kernel"]["total_s"] == \
        pytest.approx(40e-6)
    assert devprof.op_device_seconds(events, "rtr_full") == \
        (pytest.approx(40e-6), 1)
    only = devprof.attribute_trace(events, module_filter="rtr_full")
    assert only["lanes"] == 1 and only["compute_s"] == pytest.approx(40e-6)


def test_attribute_trace_no_device_ops_is_zeroed():
    att = devprof.attribute_trace(
        [{"ph": "X", "cat": "cpu_op", "pid": 0, "tid": 0, "ts": 0,
          "dur": 5, "name": "host"}], num_rounds=4)
    assert att["lanes"] == 0
    assert att["compute_s"] == att["collective_s"] == att["idle_s"] == 0.0
    assert att["slices"] == [] and att["top_ops"] == []


def test_decide_overlap_hysteresis_and_evidence():
    att = {"overlap_efficiency_measured": 0.4,
           "per_round": {"collective_s": 2e-3, "compute_s": 5e-3}}
    arms = {"lockstep": {"seconds": 1.0, "rounds": 8, "attribution": att},
            "overlapped": {"seconds": 0.90, "rounds": 8}}
    rec = devprof.decide_overlap(arms, threshold=0.05)
    assert rec["overlap"] is True
    assert rec["efficiency"] == pytest.approx(0.10)
    assert rec["lockstep_overlap_efficiency_measured"] == 0.4
    assert "overlapped_overlap_efficiency_measured" not in rec
    arms["overlapped"]["seconds"] = 0.97
    assert devprof.decide_overlap(arms, threshold=0.05)["overlap"] is False


def test_device_trace_window_emits_attribution_event(tmp_path):
    """A real ``torch.profiler`` window on the CPU: the trace is written
    and parsed, and the event carries the attribution schema (the CPU has
    no device lanes, so the split is zero)."""
    d = str(tmp_path / "run")
    with obs.run_scope(d):
        win = devprof.DeviceTraceWindow(str(tmp_path / "prof"),
                                        plane="solve").start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        att = win.stop(num_rounds=3, label="unit", rounds=3)
        assert float(x[0, 0]) == 64.0
    assert devprof.find_trace_files(str(tmp_path / "prof"))
    assert att is not None and att["num_rounds"] == 3
    (ev,) = [e for e in read_events(os.path.join(d, "events.jsonl"))
             if e["event"] == "device_attribution"]
    assert ev["label"] == "unit" and ev["rounds"] == 3
    for k in ("lanes", "window_s", "compute_s", "collective_s", "idle_s",
              "per_round", "overlap_efficiency_measured", "top_ops",
              "slices", "trace_files"):
        assert k in ev, k


def test_device_trace_window_without_run_emits_nothing(tmp_path):
    win = devprof.DeviceTraceWindow(str(tmp_path / "prof")).start()
    torch.ones(8).sum()
    att = win.stop(num_rounds=1)
    assert att is not None
    assert win.stop() is None  # a stopped window stays stopped


def test_profiled_program_records_first_call_once(tmp_path):
    d = str(tmp_path / "run")
    calls = []
    with obs.run_scope(d) as run:
        prog = devprof.profiled_program(run, lambda x: calls.append(x) or x,
                                        key="k", label="lbl", plane="solve")
        for i in range(3):
            assert prog(torch.tensor(float(i))) == i
        prog.flush()
    assert len(calls) == 3
    (ev,) = [e for e in read_events(os.path.join(d, "events.jsonl"))
             if e["event"] == "compile_profile"]
    assert (ev["key"], ev["label"], ev["phase"]) == ("k", "lbl", "solve")
    assert ev["launches"] == 0 and ev["device"] == "cpu"
    assert ev["first_call_s"] >= 0.0


# ---------------------------------------------------------------------------
# The zero-overhead contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("verdict_every", [None, 2])
def test_port_telemetry_off_is_zero_overhead(monkeypatch, verdict_every):
    """With no ambient run, a solve emits no event, touches no registry,
    makes no obs-owned transfer, builds no span, detector, recorder,
    profiler window or profiled program."""
    from dpgo_tpu_torch.obs import health as health_mod
    from dpgo_tpu_torch.obs import ledger as ledger_mod
    from dpgo_tpu_torch.obs import metrics as metrics_mod
    from dpgo_tpu_torch.obs import profile as profile_mod
    from dpgo_tpu_torch.obs import recorder as recorder_mod
    from dpgo_tpu_torch.obs import trace as trace_mod

    def boom(*a, **kw):
        raise AssertionError("telemetry path taken while disabled")

    monkeypatch.setattr(EventStream, "emit", boom)
    monkeypatch.setattr(run_mod, "materialize", boom)
    monkeypatch.setattr(obs, "materialize", boom)
    monkeypatch.setattr(metrics_mod.Counter, "inc", boom)
    monkeypatch.setattr(metrics_mod.Gauge, "set", boom)
    monkeypatch.setattr(metrics_mod.Histogram, "observe_many", boom)
    monkeypatch.setattr(trace_mod.Span, "__init__", boom)
    monkeypatch.setattr(trace_mod, "emit_span", boom)
    monkeypatch.setattr(health_mod.HealthMonitor, "__init__", boom)
    monkeypatch.setattr(health_mod.HealthMonitor, "observe_solver", boom)
    monkeypatch.setattr(recorder_mod.FlightRecorder, "__init__", boom)
    monkeypatch.setattr(recorder_mod.FlightRecorder, "record_eval", boom)
    monkeypatch.setattr(devprof.DeviceTraceWindow, "__init__", boom)
    monkeypatch.setattr(devprof, "profiled_program", boom)
    monkeypatch.setattr(profile_mod, "aot_compile_profile", boom)
    monkeypatch.setattr(ledger_mod.PerfLedger, "__init__", boom)
    assert obs.get_run() is None
    res = rbcd.solve_rbcd(_tiny_problem(), 2,
                          params=AgentParams(d=3, r=5, num_robots=2),
                          max_iters=4, eval_every=2, grad_norm_tol=1e-9,
                          dtype=torch.float64, device="cpu",
                          verdict_every=verdict_every)
    assert res.iterations > 0 and res.cost_history
