"""The port's telemetry tools and small ride-alongs on the CPU, against the
JAX package on the same inputs:

* ``utils.profiling`` (``trace``, ``annotate``, ``RoundTimer``) and
  ``obs.profile`` (first-call records, the profiler window);
* ``obs.timeline`` (clock offsets, the merged Chrome trace, the CLI) on
  synthetic streams and on a traced loopback fleet of port agents;
* ``obs.report``, ``obs.regress`` and ``obs.ledger``: the port renders,
  compares and gates what the JAX package does, output for output;
* ``utils.logger``'s checkpoint tier: a checkpoint either package wrote
  loads in the other, and a resumed solve continues exactly;
* the top-level re-exports, ``utils.lie`` (``random_stiefel`` through its
  ``stiefel_from_gaussian`` seam, ``check_rotation_matrix``,
  ``se_matrix``, ``project_to_stiefel_svd``) and
  ``utils.synthetic.trajectory_error``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import obs as jobs
from dpgo_tpu.obs import ledger as jledger
from dpgo_tpu.obs import regress as jregress
from dpgo_tpu.obs import timeline as jtimeline
from dpgo_tpu.obs.report import render_report as j_render_report
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.obs import ledger, regress, timeline, trace
from dpgo_tpu_torch.obs.events import read_events, read_events_meta
from dpgo_tpu_torch.obs.report import main as report_main
from dpgo_tpu_torch.obs.report import render_report
from dpgo_tpu_torch.utils import logger, profiling
from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                            partition_contiguous)
from dpgo_tpu_torch.utils.synthetic import make_measurements

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 40
KILL = (3, 25)


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
    return make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.01,
                             trans_noise=0.01)[0]


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("work"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".trace.json")]
    assert len(files) == 1 and float(x[0, 0]) == 64.0
    with open(os.path.join(logdir, files[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "work" in names


def test_round_timer_accumulates_and_nests():
    t = profiling.RoundTimer()
    with t.phase("solve", sync_fn=lambda: torch.ones(4)):
        torch.ones(8)
    t.start("exchange")
    t.stop("exchange")
    with t.phase("solve"):
        with t.phase("inner"):
            pass
    assert t.counts == {"solve": 2, "exchange": 1, "inner": 1}
    assert t.totals["solve"] >= t.totals["inner"] >= 0.0
    assert "solve" in t.summary() and "exchange" in t.summary()
    t2 = profiling.RoundTimer()
    t2.start("p")
    t2.start("p")
    t2.stop("p")
    assert t2.counts["p"] == 1
    with pytest.raises(ValueError):
        t2.stop("p")


def test_round_timer_stop_guard_precedes_sync_and_fence_waits():
    class Probe:
        materialized = False

        def __array__(self, dtype=None, copy=None):
            Probe.materialized = True
            return np.zeros(1)

    t = profiling.RoundTimer()
    with pytest.raises(ValueError, match="without a matching start"):
        t.stop("never_started", sync=Probe())
    assert not Probe.materialized
    t.start("solve")
    with pytest.raises(ValueError, match=r"open phases: solve"):
        t.stop("slove")
    t.stop("solve", sync=Probe())
    assert Probe.materialized
    t.start("solve")
    assert t.stop("solve", sync=torch.arange(8.0) * 2.0) >= 0.0


def test_round_timer_as_dict_and_reset():
    t = profiling.RoundTimer()
    for _ in range(2):
        with t.phase("solve"):
            pass
    d = t.as_dict()
    assert d["solve"]["count"] == 2
    assert d["solve"]["avg_ms"] == pytest.approx(
        1e3 * t.totals["solve"] / 2)
    json.dumps(d)
    t.start("open")
    t.reset()
    assert t.totals == {} and t.counts == {}
    with pytest.raises(ValueError):
        t.stop("open")


# ---------------------------------------------------------------------------
# obs.profile
# ---------------------------------------------------------------------------

def test_profiled_executable_records_each_static_combo_once(tmp_path):
    from dpgo_tpu_torch.obs.profile import ProfiledExecutable

    calls = []

    def prog(x, uw=False):
        calls.append(uw)
        return x + int(uw)

    pe = ProfiledExecutable(prog, key="seg", label="segment",
                            static_names=("uw",))
    assert pe(torch.tensor(1.0), uw=True) == 2.0  # no run: plain call
    d = str(tmp_path / "run")
    with obs.run_scope(d):
        for uw in (False, True, False, True):
            pe(torch.tensor(1.0), uw=uw)
        pe.flush()
    assert len(calls) == 5
    evs = [e for e in read_events(os.path.join(d, "events.jsonl"))
           if e["event"] == "compile_profile"]
    assert [e["static"] for e in evs] == [{"uw": False}, {"uw": True}]
    assert all(e["phase"] == "serve" and e["launches"] == 0 for e in evs)


def test_profiler_window_captures_first_k_batches(tmp_path):
    from dpgo_tpu_torch.obs.profile import ProfilerWindow

    d = str(tmp_path / "run")
    prof = str(tmp_path / "prof")
    with obs.run_scope(d):
        win = ProfilerWindow(prof, num_batches=2)
        for _ in range(4):
            win.batch_begin()
            torch.ones(16).sum()
            win.batch_end()
        win.close()
    assert len(os.listdir(prof)) == 1
    (ev,) = [e for e in read_events(os.path.join(d, "events.jsonl"))
             if e["event"] == "profiler_window"]
    assert ev["profile_dir"] == prof


# ---------------------------------------------------------------------------
# obs.timeline on synthetic streams (tests/test_trace.py's cases)
# ---------------------------------------------------------------------------

OFFSET_S = 1.7
LATENCY_S = 0.005
JITTER_S = 0.001


def _write_stream(path, robot, events):
    with open(path, "w") as fh:
        for i, e in enumerate(events):
            fh.write(json.dumps({"run": f"r{robot}", "seq": i, **e}) + "\n")


def _synthetic_pair(tmp_path, n_samples=60, seed=0):
    rng = np.random.default_rng(seed)
    t_wall0 = 1_700_000_000.0
    a_events, b_events = [], []
    for k in range(n_samples):
        t = 10.0 + 0.05 * k
        lat_ab = LATENCY_S + float(rng.normal(0, JITTER_S))
        lat_ba = LATENCY_S + float(rng.normal(0, JITTER_S))
        b_events.append({
            "event": "clock_sample", "phase": "comms", "src": 0, "dst": 1,
            "t_mono": t + abs(lat_ab) + OFFSET_S, "t_wall": t_wall0 + t,
            "t_send_mono": t, "t_send_wall": t_wall0 + t})
        a_events.append({
            "event": "clock_sample", "phase": "comms", "src": 1, "dst": 0,
            "t_mono": t + abs(lat_ba), "t_wall": t_wall0 + t,
            "t_send_mono": t + OFFSET_S, "t_send_wall": t_wall0 + t})
        a_events.append({
            "event": "span", "phase": "compute", "name": "iterate",
            "robot": 0, "trace": f"{k:016x}", "span": f"{k:016x}",
            "t_mono": t + 0.01, "t_wall": t_wall0 + t,
            "t0_mono": t, "t0_wall": t_wall0 + t, "dur_s": 0.01,
            "iteration": k})
        b_events.append({
            "event": "span", "phase": "compute", "name": "iterate",
            "robot": 1, "trace": f"{k:016x}", "span": f"{k + 1:016x}",
            "t_mono": t + 0.01 + OFFSET_S, "t_wall": t_wall0 + t,
            "t0_mono": t + OFFSET_S, "t0_wall": t_wall0 + t,
            "dur_s": 0.01, "iteration": k})
    pa, pb = str(tmp_path / "robot0.jsonl"), str(tmp_path / "robot1.jsonl")
    _write_stream(pa, 0, a_events)
    _write_stream(pb, 1, b_events)
    return pa, pb


def test_clock_offset_and_merge_match_jax(tmp_path):
    pa, pb = _synthetic_pair(tmp_path)
    tl = timeline.merge([pa, pb])
    s0, s1 = tl.streams
    assert s0.aligned and s1.aligned and s0.offset == 0.0
    assert s1.offset == pytest.approx(OFFSET_S, abs=0.003)
    assert 0.0 < s1.uncertainty < 0.05
    (pair,) = tl.offsets["pairs"]
    assert pair["bidirectional"] is True and pair["samples"] == 120
    jtl = jtimeline.merge([pa, pb])
    assert tl.events == jtl.events and tl.offsets == jtl.offsets
    assert timeline.to_chrome_trace(tl) == jtimeline.to_chrome_trace(jtl)
    spans = [e for e in tl.events if e.get("event") == "span"]
    by_round = {}
    for e in spans:
        by_round.setdefault(e["iteration"], {})[e["robot"]] = e
    for pair in by_round.values():
        assert abs(pair[0]["t0_mono"] - pair[1]["t0_mono"]) < 0.01


def test_one_way_and_unaligned_streams(tmp_path):
    pa, pb = _synthetic_pair(tmp_path)
    evs, _ = read_events_meta(pb)
    _write_stream(pb, 1, [e for e in evs if e.get("event") != "clock_sample"])
    tl = timeline.merge([pa, pb])
    (pair,) = tl.offsets["pairs"]
    assert pair["bidirectional"] is False
    assert tl.streams[1].offset == pytest.approx(OFFSET_S,
                                                 abs=2 * LATENCY_S + 0.01)
    evs, _ = read_events_meta(pa)
    _write_stream(pa, 0, [e for e in evs if e.get("event") != "clock_sample"])
    tl = timeline.merge([pa, pb])
    assert sum(s.aligned for s in tl.streams) == 1


def test_timeline_cli(tmp_path, capsys):
    pa, pb = _synthetic_pair(tmp_path)
    out = str(tmp_path / "fleet.json")
    assert timeline.main([pa, pb, "-o", out, "--report"]) == 0
    printed = capsys.readouterr().out
    assert "flow edges" in printed and "clock" in printed
    assert timeline.validate_chrome_trace(out)["spans"] == 120
    assert timeline.main([str(tmp_path / "missing")]) == 2


# ---------------------------------------------------------------------------
# A traced loopback fleet of port agents: trace, report, parity
# ---------------------------------------------------------------------------

def _run_fleet(part, num_robots, injector=None, kill=None, rounds=ROUNDS,
               pace_s=0.0):
    """Lockstep loopback fleet of port agents (the in-process twin of the
    TCP example's robot loop), traced when a run is ambient."""
    from dpgo_tpu_torch.agent import PGOAgent
    from dpgo_tpu_torch.comms import (RetryPolicy, apply_peer_frame,
                                      loopback_fleet, pack_agent_frame)

    params = AgentParams(d=3, r=5, num_robots=num_robots)
    agents = {rid: PGOAgent(rid, params, device="cpu")
              for rid in range(num_robots)}
    for rid in range(1, num_robots):
        agents[rid].set_lifting_matrix(agents[0].get_lifting_matrix())
    for rid, ag in agents.items():
        ag.set_pose_graph(*agent_measurements(part, rid))
    policy = RetryPolicy(max_attempts=2, base_delay_s=0.002,
                         max_delay_s=0.01, send_timeout_s=0.5,
                         recv_timeout_s=0.5)
    bus, clients = loopback_fleet(num_robots, injector=injector,
                                  policy=policy, round_timeout_s=0.15,
                                  miss_limit=5, liveness_timeout_s=0.5)
    for c in clients.values():
        c.channel.start_heartbeat(0.05)
    dead = set()
    for it in range(rounds):
        if kill is not None and it == kill[1]:
            dead.add(kill[0])
            clients[kill[0]].close()
        for rid, ag in agents.items():
            if rid not in dead:
                clients[rid].publish(
                    pack_agent_frame(ag, include_anchor=(rid == 0)),
                    timeout=0.5)
        bus.round()
        for rid, ag in agents.items():
            if rid in dead:
                continue
            merged = clients[rid].collect(timeout=0.3)
            if merged is not None:
                for peer, pf in clients[rid].peer_frames(merged).items():
                    apply_peer_frame(ag, peer, pf,
                                     accept_anchor=(rid != 0 and peer == 0))
                for lost in clients[rid].lost:
                    ag.mark_neighbor_lost(lost)
            ag.iterate(True)
        if pace_s:
            time.sleep(pace_s)
    bus.close()
    for rid, c in clients.items():
        if rid not in dead:
            c.close()
    return agents, bus


def _fleet_problem(num_robots, n=24, num_lc=12):
    meas = make_measurements(np.random.default_rng(0), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.01,
                             trans_noise=0.01)[0]
    return partition_contiguous(meas, num_robots)


def test_traced_loopback_solve_produces_valid_chrome_trace(tmp_path):
    rounds = 8
    d = str(tmp_path / "run")
    with obs.run_scope(d):
        _run_fleet(_fleet_problem(2), 2, rounds=rounds)
    tl = timeline.merge([d])
    trace_path = timeline.write_chrome_trace(str(tmp_path / "t.json"), tl)
    with open(trace_path) as fh:
        doc = json.load(fh)
    counts = timeline.validate_chrome_trace(doc)
    assert counts["spans"] > 4 * rounds
    assert counts["cross_robot_flows"] >= rounds
    assert counts["pids"] >= 3
    assert timeline.validate_chrome_trace(trace_path) == counts
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"
          and e.get("name") == "iterate"]
    assert {e["pid"] for e in xs} == {2, 3}
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"publish", "collect", "scatter", "bus_round", "frame"} <= names
    # The JAX package's merge and report read the port's stream alike.
    jtl = jtimeline.merge([d])
    assert jtimeline.to_chrome_trace(jtl) == timeline.to_chrome_trace(tl)
    assert render_report(d) == j_render_report(d)


def test_chaos_traced_fleet_merged_trace_and_report(tmp_path, capsys):
    from dpgo_tpu_torch.comms import FaultInjector, FaultSpec

    injector = FaultInjector(FaultSpec(drop=0.10), seed=7)
    d = str(tmp_path / "chaos")
    with obs.run_scope(d):
        _, bus = _run_fleet(_fleet_problem(4), 4, injector=injector,
                            kill=KILL, pace_s=0.003)
    assert injector.stats["dropped"] > 0
    assert bus.lost == {KILL[0]}
    survivors = [r for r in range(4) if r != KILL[0]]
    tl = timeline.merge([d])
    counts = timeline.validate_chrome_trace(
        timeline.write_chrome_trace(str(tmp_path / "t.json"), tl))
    assert counts["cross_robot_flows"] > 0
    for r in survivors:
        its = {e["iteration"] for e in tl.events if e.get("event") == "span"
               and e.get("name") == "iterate" and e.get("robot") == r}
        assert len(its) >= ROUNDS - 6
    assert report_main([d]) == 0
    out = capsys.readouterr().out
    for needle in ("fleet timeline:", "busy", "wait", "critical path over",
                   "stragglers", "network health (comms):",
                   "peers lost [3]"):
        assert needle in out, needle
    assert report_main(["--json", d]) == 0
    ft = json.loads(capsys.readouterr().out)["fleet_timeline"]
    assert ft["num_flow_links"] > 0
    assert ft["round_critical_path"]["rounds"] > 0


def test_report_cli_shows_network_health(tmp_path, capsys):
    """``tests/test_comms.py``'s report case: a bus that loses a closed
    robot renders the comms health section."""
    from dpgo_tpu_torch.comms import loopback_fleet

    d = str(tmp_path / "run")
    with obs.run_scope(d):
        bus, clients = loopback_fleet(2, round_timeout_s=0.5)
        for c in clients.values():
            c.publish({"v": np.asarray(1)})
        bus.round()
        clients[1].close()
        clients[0].collect(timeout=1.0)
        clients[0].publish({"v": np.asarray(2)})
        bus.round()
        bus.close()
        clients[0].close()
    assert report_main([d]) == 0
    out = capsys.readouterr().out
    assert "network health (comms):" in out
    assert "peers lost [1]" in out
    assert "peer_lost: bus lost peer 1 (closed)" in out


# ---------------------------------------------------------------------------
# obs.report CLI (tests/test_obs.py, tests/test_trace.py)
# ---------------------------------------------------------------------------

def test_report_cli_and_json_schema(tmp_path, capsys):
    d = str(tmp_path / "run")
    with obs.run_scope(d) as run:
        run.metric("solver_cost", 10.0, phase="eval", iteration=1)
        run.metric("solver_cost", 2.0, phase="eval", iteration=5)
        run.event("phase_timings", timings={
            "solve": {"total_s": 1.0, "count": 4, "avg_ms": 250.0}})
        run.histogram("round_latency_seconds").observe(0.01)
        with trace.span("iterate", phase="compute", robot=0):
            pass
    assert report_main([d]) == 0
    out = capsys.readouterr().out
    assert "solver_cost: 2 points, first 10, last 2" in out
    assert "solve: 1.0000s / 4 (250.00 ms avg)" in out
    assert "round_latency_seconds" in out
    assert out.strip() == j_render_report(d).strip()
    assert report_main(["--json", d]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["run"] == run.run_id and rec["truncated"] is False
    assert rec["event_kinds"]["span"] == 1
    assert rec["fleet_timeline"]["robots"] and "metrics" in rec


def test_report_cli_errors_on_missing_and_empty_dirs(tmp_path, capsys):
    missing = str(tmp_path / "nope")
    assert report_main([missing]) == 2
    assert "not a run directory" in capsys.readouterr().err
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert report_main([empty]) == 2
    assert "empty run directory" in capsys.readouterr().err
    assert report_main(["--json", missing]) == 2


def test_report_renders_a_telemetry_solve_as_jax_does(tmp_path):
    """The report of a port solve names what the JAX package's report of
    the JAX solve names, line for line (timings aside)."""
    from dpgo_tpu.config import AgentParams as JAgentParams
    from dpgo_tpu.models import rbcd as jrbcd

    meas = _tiny_problem()
    with obs.run_scope(str(tmp_path / "port")):
        rbcd.solve_rbcd(meas, 2, params=AgentParams(d=3, r=5, num_robots=2),
                        max_iters=8, eval_every=2, grad_norm_tol=1e-12,
                        dtype=torch.float64, device="cpu")
    with jobs.run_scope(str(tmp_path / "jax")):
        jrbcd.solve_rbcd(meas, 2, params=JAgentParams(d=3, r=5,
                                                      num_robots=2),
                         max_iters=8, eval_every=2, grad_norm_tol=1e-12,
                         dtype=jnp.float64)

    def heads(text):
        return [ln.split(":")[0] for ln in text.splitlines()[1:]]

    assert heads(render_report(str(tmp_path / "port"))) == \
        heads(j_render_report(str(tmp_path / "jax")))


# ---------------------------------------------------------------------------
# obs.regress (tests/test_regress.py's cases on port solves)
# ---------------------------------------------------------------------------

def _solve_into(run_dir, seed=0, num_robots=2, max_iters=8):
    with obs.run_scope(run_dir):
        rbcd.solve_rbcd(_tiny_problem(seed=seed), num_robots,
                        params=AgentParams(d=3, r=5, num_robots=num_robots,
                                           rel_change_tol=1e-16),
                        max_iters=max_iters, eval_every=2,
                        grad_norm_tol=1e-12, dtype=torch.float64,
                        device="cpu")


def test_tail_band_matches_jax():
    for vals in ([3.0, 1.0, 2.0, 4.0], [float("nan")], [5.0]):
        band, jband = regress.tail_band(vals, k=3), \
            jregress.tail_band(vals, k=3)
        assert json.dumps(band) == json.dumps(jband)
    band = regress.tail_band([3.0, 1.0, 2.0, 4.0], k=3)
    assert band["min"] == 1.0 and band["max"] == 4.0
    assert band["median"] == 2.0


def test_compare_clean_corrupted_and_refused(tmp_path, capsys):
    a, b = str(tmp_path / "runA"), str(tmp_path / "runB")
    _solve_into(a)
    _solve_into(b)
    cmp = regress.compare_runs(a, b)
    assert cmp["rc"] == 0 and cmp["regressions"] == []
    assert cmp["metrics"]["solver_cost"]["max_rel_deviation"] == 0.0
    assert json.dumps(cmp, sort_keys=True) == \
        json.dumps(jregress.compare_runs(a, b), sort_keys=True)
    assert report_main(["--compare", a, b]) == 0
    assert "no regression" in capsys.readouterr().out
    meta = json.load(open(os.path.join(a, "run.json")))
    fp = meta["fingerprint"]
    assert fp["num_robots"] == 2 and fp["dtype"] == "float64"
    assert "version" in fp

    c = str(tmp_path / "runC")
    shutil.copytree(a, c)
    ev_path = os.path.join(c, "events.jsonl")
    lines = open(ev_path).read().splitlines()
    last = max(i for i, ln in enumerate(lines)
               if '"metric": "solver_cost"' in ln)
    ev = json.loads(lines[last])
    ev["value"] *= 10.0
    lines[last] = json.dumps(ev)
    open(ev_path, "w").write("\n".join(lines) + "\n")
    assert report_main(["--compare", a, c]) == 2
    text = capsys.readouterr().out
    assert "REGRESSED" in text and "solver_cost" in text
    assert report_main(["--compare", c, a]) == 0
    capsys.readouterr()

    four = str(tmp_path / "runD")
    _solve_into(four, num_robots=4)
    assert report_main(["--compare", a, four]) == 2
    out = capsys.readouterr().out
    assert "REFUSED" in out and "num_robots" in out
    assert report_main(["--compare", a, str(tmp_path / "nope")]) == 2
    assert "not a telemetry run" in capsys.readouterr().err


def test_higher_direction_metric_regresses_on_drop(tmp_path, capsys):
    def qps_run(run_dir, values):
        with obs.run_scope(run_dir) as run:
            for v in values:
                run.metric("fleet_qps", float(v), unit="1/s")

    a, bad = str(tmp_path / "runA"), str(tmp_path / "runBAD")
    qps_run(a, [4.0, 4.2, 4.1, 4.3, 4.2])
    qps_run(bad, [4.0, 4.1, 4.2, 4.1, 2.0])
    assert report_main(["--compare", a, bad]) == 2
    capsys.readouterr()
    cmp = regress.compare_runs(a, bad)
    assert "below band min" in cmp["metrics"]["fleet_qps"]["reason"]
    assert report_main(["--compare", bad, a]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# obs.ledger (tests/test_ledger.py's cases)
# ---------------------------------------------------------------------------

def _write(d, name, obj):
    (d / name).write_text(json.dumps(obj))


def _bench(value, vs_baseline, rc=0, parity=None):
    parsed = {"metric": "rbcd_rounds_per_sec", "value": value,
              "unit": "rounds/s", "vs_baseline": vs_baseline,
              "cpu_arm_band": {"min": 20.0, "max": 30.0}}
    if parity is not None:
        parsed["kernel_parity_max_abs_diff"] = parity
    return {"n": 1, "cmd": "python bench.py", "rc": rc, "tail": "",
            "parsed": parsed}


def _fixture_root(tmp_path):
    d = tmp_path / "records"
    d.mkdir()
    _write(d, "BENCH_r01.json", _bench(100.0, 3.0))
    _write(d, "BENCH_r02.json", _bench(110.0, 3.2, parity=3e-5))
    _write(d, "BENCH_r03.json", _bench(120.0, 3.5, parity=2e-5))
    _write(d, "MULTICHIP_r01.json",
           {"n_devices": 0, "ok": False, "rc": 1, "skipped": False,
            "tail": "no devices"})
    _write(d, "MULTICHIP_r02.json",
           {"record": "MULTICHIP", "ok": True, "n_devices": 8,
            "metric": "sharded_rounds_per_sec", "value": 40.0,
            "unit": "rounds/s", "overlap": {"efficiency": -0.05},
            "host_syncs_per_100_rounds": 25.0})
    _write(d, "FLEET_r01.json",
           {"ok": True, "qps": [{"replicas": 1, "qps": 5.0},
                                {"replicas": 2, "qps": 9.0}],
            "scaling_1_to_2": 1.8,
            "cold_start": {"compile_seconds_total": 30.0}})
    _write(d, "NOT_A_RECORD.json", {"x": 1})
    (d / "BENCH_notes.txt").write_text("ignored")
    return d


def test_ledger_loads_renders_and_gates_as_jax_does(tmp_path):
    d = _fixture_root(tmp_path)
    led, jled = ledger.load_ledger(str(d)), jledger.load_ledger(str(d))
    assert [(f, r) for f, r, _ in ledger.discover_records(str(d))] == [
        ("BENCH", 1), ("BENCH", 2), ("BENCH", 3), ("FLEET", 1),
        ("MULTICHIP", 1), ("MULTICHIP", 2)]
    assert led.to_json() == jled.to_json()
    assert led.render() == jled.render()
    assert led.family_rows("FLEET")[0]["value"] == 9.0
    assert led.series("MULTICHIP") == [(2, 40.0)]
    gate = regress.trend_gate(led)
    assert gate["rc"] == 0 and gate == jregress.trend_gate(jled)
    _write(d, "BENCH_r04.json", _bench(80.0, 2.0))
    gate = regress.trend_gate(ledger.load_ledger(str(d)))
    assert gate["rc"] == 2 and "BENCH:value" in gate["regressions"]
    assert "TREND REGRESSION" in regress.render_trend(gate)
    (d / "BENCH_r05.json").write_text("{not json")
    rows = ledger.load_ledger(str(d)).family_rows("BENCH")
    assert rows[-1]["ok"] is False and "error" in rows[-1]["extras"]


def test_checked_in_records_load_as_in_jax():
    led, jled = ledger.load_ledger(REPO), jledger.load_ledger(REPO)
    assert led.rows and led.to_json() == jled.to_json()
    assert regress.trend_gate(led)["rc"] == \
        jregress.trend_gate(jled)["rc"]


def test_report_ledger_cli_roundtrip(tmp_path):
    d = _fixture_root(tmp_path)
    cmd = [sys.executable, "-m", "dpgo_tpu_torch.obs.report", "--ledger",
           str(d)]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "perf ledger" in out.stdout
    out = subprocess.run(cmd + ["--json"], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=env)
    assert json.loads(out.stdout)["record"] == "LEDGER"
    assert regress.run_trend(str(d)) == 0
    _write(d, "BENCH_r04.json", _bench(10.0, 0.5))
    assert regress.run_trend(str(d)) == 2


def test_telemetry_off_builds_no_ledger(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("ledger built with telemetry off")

    monkeypatch.setattr(ledger.PerfLedger, "__init__", boom)
    res = rbcd.solve_rbcd(_tiny_problem(), 2,
                          params=AgentParams(d=3, r=5, num_robots=2),
                          max_iters=4, eval_every=2, device="cpu")
    assert res.iterations > 0


# ---------------------------------------------------------------------------
# utils.logger's checkpoint tier
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_both_ways(tmp_path):
    from dpgo_tpu.utils import logger as jlogger

    rng = np.random.default_rng(5)
    X = rng.normal(size=(3, 5, 10, 4))
    w = rng.uniform(0, 1, size=(3, 20))
    # A port checkpoint of tensors loads in the JAX package ...
    logger.save_checkpoint(logger.Checkpoint(
        X=torch.from_numpy(X), weights=torch.from_numpy(w), mu=0.125,
        iteration=42), str(tmp_path / "port"))
    out = jlogger.load_checkpoint(str(tmp_path / "port"))
    assert np.array_equal(out.X, X) and np.array_equal(out.weights, w)
    assert (out.mu, out.iteration) == (0.125, 42)
    # ... and a JAX checkpoint loads in the port.
    jlogger.save_checkpoint(jlogger.Checkpoint(
        X=jnp.asarray(X), weights=jnp.asarray(w), mu=0.25, iteration=7),
        str(tmp_path / "jax"))
    out = logger.load_checkpoint(str(tmp_path / "jax"))
    assert np.array_equal(out.X, X) and np.array_equal(out.weights, w)
    assert (out.mu, out.iteration) == (0.25, 7)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A robust JAX solve checkpointed mid-GNC (X, weights, mu,
    iteration) resumes in the port — fresh state, ``refresh_problem`` for
    the carried factors — and continues as the uninterrupted JAX solve
    does, at rtol 1e-9; a port checkpoint resumes in the port exactly."""
    from dpgo_tpu.config import AgentParams as JAgentParams
    from dpgo_tpu.config import RobustCostParams as JRobust
    from dpgo_tpu.config import RobustCostType as JType
    from dpgo_tpu.models import rbcd as jrbcd
    from dpgo_tpu.utils import logger as jlogger
    from dpgo_tpu.utils.partition import partition_contiguous as jpart
    from dpgo_tpu_torch.config import RobustCostParams, RobustCostType

    meas = make_measurements(np.random.default_rng(42), n=20, d=3,
                             num_lc=10, outlier_lc=3, rot_noise=0.01,
                             trans_noise=0.01)[0]
    rk = dict(gnc_barc=0.5)
    jparams = JAgentParams(d=3, r=5, num_robots=4,
                           robust=JRobust(cost_type=JType.GNC_TLS, **rk),
                           robust_opt_inner_iters=10)
    params = AgentParams(d=3, r=5, num_robots=4,
                         robust=RobustCostParams(
                             cost_type=RobustCostType.GNC_TLS, **rk),
                         robust_opt_inner_iters=10)

    def j_step_to(state, graph, meta, start, stop):
        for it in range(start, stop):
            uw = (it + 1) % 10 == 0
            state = jrbcd.rbcd_step(state, graph, meta, jparams,
                                    update_weights=uw)
        return state

    def step_to(state, graph, meta, start, stop):
        for it in range(start, stop):
            uw = (it + 1) % 10 == 0
            state = rbcd.rbcd_segment(state, graph, 1, meta, params,
                                      first_update_weights=uw)
        return state

    jp = jpart(meas, 4)
    jgraph, jmeta = jrbcd.build_graph(jp, 5, jnp.float64)
    jX0 = jrbcd.centralized_chordal_init(jp, jmeta, jgraph, jnp.float64)
    jstate = j_step_to(jrbcd.init_state(jgraph, jmeta, jX0, params=jparams),
                       jgraph, jmeta, 0, 25)
    jlogger.save_checkpoint(jlogger.Checkpoint(
        X=np.asarray(jstate.X), weights=np.asarray(jstate.weights),
        mu=float(jstate.mu), iteration=int(jstate.iteration)),
        str(tmp_path / "jax"))
    jfull = j_step_to(jstate, jgraph, jmeta, 25, 40)

    part = partition_contiguous(meas, 4)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)

    def resume(directory):
        ck = logger.load_checkpoint(directory)
        st = rbcd.init_state(graph, meta, X0, params=params)
        st = st._replace(X=torch.from_numpy(ck.X),
                         weights=torch.from_numpy(ck.weights),
                         mu=torch.tensor(ck.mu, dtype=torch.float64),
                         iteration=int(ck.iteration))
        return step_to(rbcd.refresh_problem(st, graph, meta, params),
                       graph, meta, ck.iteration, 40)

    resumed = resume(str(tmp_path / "jax"))
    assert resumed.iteration == int(jfull.iteration) == 40
    np.testing.assert_allclose(resumed.X.numpy(), np.asarray(jfull.X),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(resumed.weights.numpy(),
                               np.asarray(jfull.weights), rtol=1e-9,
                               atol=1e-12)

    state = step_to(rbcd.init_state(graph, meta, X0, params=params),
                    graph, meta, 0, 25)
    logger.save_checkpoint(logger.Checkpoint(
        X=state.X, weights=state.weights, mu=float(state.mu),
        iteration=state.iteration), str(tmp_path / "port"))
    full = step_to(state, graph, meta, 25, 40)
    again = resume(str(tmp_path / "port"))
    assert torch.equal(again.X, full.X)
    assert torch.equal(again.weights, full.weights)


# ---------------------------------------------------------------------------
# Ride-alongs
# ---------------------------------------------------------------------------

def test_top_level_reexports_match_jax():
    import dpgo_tpu
    import dpgo_tpu_torch

    assert dpgo_tpu_torch.__all__ == dpgo_tpu.__all__
    for name in dpgo_tpu_torch.__all__:
        assert getattr(dpgo_tpu_torch, name).__name__ == \
            getattr(dpgo_tpu, name).__name__
    m = dpgo_tpu_torch.read_g2o
    from dpgo_tpu_torch.utils.g2o import read_g2o
    assert m is read_g2o


def test_random_stiefel_through_its_seam_matches_jax():
    from dpgo_tpu.utils import lie as jlie
    from dpgo_tpu_torch.utils import lie

    key = jax.random.PRNGKey(3)
    for batch in ((), (4,)):
        G = jax.random.normal(key, batch + (5, 3), dtype=jnp.float64)
        got = lie.stiefel_from_gaussian(torch.from_numpy(np.asarray(G)))
        want = jlie.random_stiefel(key, 5, 3, batch=batch,
                                   dtype=jnp.float64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    Y = lie.random_stiefel(g, 5, 3, batch=(6,), dtype=torch.float64,
                           device="cpu")
    eye = torch.eye(3, dtype=torch.float64).expand(6, 3, 3)
    torch.testing.assert_close(Y.transpose(-1, -2) @ Y, eye)
    Y2 = lie.random_stiefel(torch.Generator().manual_seed(0), 5, 3,
                            batch=(6,), dtype=torch.float64, device="cpu")
    assert torch.equal(Y, Y2)


def test_lie_helpers_match_jax():
    from dpgo_tpu.utils import lie as jlie
    from dpgo_tpu_torch.utils import lie
    from dpgo_tpu_torch.utils.synthetic import random_rotation

    rng = np.random.default_rng(0)
    R = np.stack([random_rotation(rng) for _ in range(5)])
    t = rng.normal(size=(5, 3))
    bad = R.copy()
    bad[2] *= 1.01
    for x in (R, bad, R[0], -R[0]):
        got = lie.check_rotation_matrix(x)
        assert np.array_equal(got, jlie.check_rotation_matrix(x))
    assert list(lie.check_rotation_matrix(torch.from_numpy(bad))) == \
        [True, True, False, True, True]
    assert np.array_equal(lie.se_matrix(R, t), jlie.se_matrix(R, t))
    M = rng.normal(size=(7, 5, 3))
    np.testing.assert_allclose(
        lie.project_to_stiefel_svd(torch.from_numpy(M)).numpy(),
        np.asarray(jlie.project_to_stiefel_svd(jnp.asarray(M))),
        rtol=1e-9, atol=1e-12)


def test_trajectory_error_matches_jax():
    from dpgo_tpu.utils import synthetic as jsyn
    from dpgo_tpu_torch.utils import synthetic

    rng = np.random.default_rng(1)
    Rs = np.stack([synthetic.random_rotation(rng) for _ in range(6)])
    ts = rng.normal(size=(6, 3))
    T = np.concatenate([Rs, ts[..., None]], axis=-1)
    T = T + 1e-3 * rng.normal(size=T.shape)
    want = jsyn.trajectory_error(T, Rs, ts)
    assert synthetic.trajectory_error(T, Rs, ts) == want
    assert synthetic.trajectory_error(torch.from_numpy(T), Rs, ts) == want
