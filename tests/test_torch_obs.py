"""The port's telemetry core (``dpgo_tpu_torch.obs``) against the JAX
package's (``dpgo_tpu.obs``): for the same sequence of calls the event
records, the Prometheus text and the span records are the same (run ids,
timestamps and span ids masked), ``HealthMonitor`` fires the same
anomalies on the scalar streams of ``tests/test_health.py``, a torch
tensor crosses the ``materialize`` fence, and with telemetry off nothing
is emitted."""

import math
import os

import numpy as np
import pytest
import torch

from dpgo_tpu import obs as jobs
from dpgo_tpu.obs import health as jhealth
from dpgo_tpu.obs import trace as jtrace
from dpgo_tpu.obs.events import read_events as j_read_events
from dpgo_tpu_torch import obs as tobs
from dpgo_tpu_torch.obs import health as thealth
from dpgo_tpu_torch.obs import trace as ttrace
from dpgo_tpu_torch.obs.events import read_events as t_read_events

PACKAGES = {"jax": (jobs, jhealth, jtrace, j_read_events),
            "port": (tobs, thealth, ttrace, t_read_events)}
#: Fields that differ between any two runs: run ids, clocks, durations,
#: random span/trace ids.
MASKED = {"run", "t_wall", "t_mono", "t0_mono", "t0_wall", "dur_s",
          "duration_s", "span", "trace", "parent", "t_start_wall",
          "t_start_mono"}


@pytest.fixture(autouse=True)
def _no_leaked_ambient_run():
    jobs.end_run()
    tobs.end_run()
    yield
    jobs.end_run()
    tobs.end_run()


def _masked(evs):
    return [{k: v for k, v in e.items() if k not in MASKED} for e in evs]


def _script(pkg: str, d: str):
    """One fixed sequence of telemetry calls; returns the event records,
    the Prometheus text and the metrics snapshot."""
    obs, health, trace, read_events = PACKAGES[pkg]
    with obs.run_scope(d) as run:
        run.set_fingerprint(dataset="standin", num_robots=3, rank=5)
        c = run.counter("comms_bytes_sent", "pose payload bytes", "bytes")
        c.inc(128, robot=0)
        c.inc(64, robot=1, neighbor=0)
        run.gauge("gnc_mu", "GNC control parameter").set(1.4e-4, robot=2)
        run.gauge("agent_rel_change", "rel").set(float("inf"), robot=1)
        h = run.histogram("agent_iterate_seconds", "iterate", unit="s",
                          buckets=(0.001, 0.01, 0.1))
        for v in (0.0005, 0.002, 0.05, 0.5):
            h.observe(v, robot=0)
        h.observe_many(np.array([0.003, 0.2]), robot=1)
        run.event("agent_state", phase="lifecycle", robot=1,
                  state="INITIALIZED", instance=0, iteration=3)
        run.metric("gnc_mu", 2e-4, phase="weight_update", robot=0,
                   iteration=30, inlier_fraction=0.75, num_lc=8)
        run.event("payload", vals=np.arange(3), nan=float("nan"),
                  scalar=np.float64(2.5))
        with trace.span("publish", phase="comms", robot=0, frames=2):
            with trace.span("encode", phase="comms", robot=0) as sp:
                sp.add(bytes=512)
        trace.emit_span(run, "iterate", 1.0, 2.0, 0.25, phase="compute",
                        robot=2, iteration=7, stepped=True)
        mon = health.monitor_for(run, health.HealthConfig(
            cost_spike_rtol=0.25, grad_explosion_factor=100.0,
            stall_window=3, stall_rtol=1e-3, inlier_collapse_drop=0.4,
            cert_refuse_streak=2))
        for it, (f, g, mu, inl) in enumerate([
                (100.0, 1.0, 1e-4, 0.9), (90.0, 1.0, 1e-4, 0.8),
                (140.0, 1.0, 1e-4, 0.3), (500.0, 1.0, 1.4e-4, 0.9),
                (9.0, 150.0, 1.4e-4, 0.9), (9.0, 1.0, 1.4e-4, 0.9),
                (8.9999, 1.0, 1.4e-4, 0.9), (8.9998, 1.0, 1.4e-4, 0.9),
                (float("nan"), 1.0, 1.4e-4, 0.9)]):
            mon.observe_solver(it + 1, f, g, mu=mu, inlier_frac=inl,
                               rel_change=np.array([0.1, 0.2]))
        for cert, dec in ((False, False), (False, False), (True, True)):
            mon.observe_certificate(cert, decidable=dec)
        mon.anomaly("non_finite_neighbor_frame", "critical", robot=1,
                    neighbor=0, poses=3)
        anomalies = [{k: v for k, v in a.items() if k not in MASKED}
                     for a in mon.anomalies]
        prom = obs.to_prometheus_text(run.registry)
        snap = run.registry.snapshot()
    evs = read_events(os.path.join(d, "events.jsonl"))
    return _masked(evs), prom, snap, anomalies


def test_event_records_prometheus_and_spans_match_jax(tmp_path):
    j_evs, j_prom, j_snap, j_an = _script("jax", str(tmp_path / "j"))
    t_evs, t_prom, t_snap, t_an = _script("port", str(tmp_path / "t"))
    assert t_prom == j_prom
    assert t_snap == j_snap
    assert len(t_evs) == len(j_evs)
    for a, b in zip(t_evs, j_evs):
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, float) and math.isnan(x):
                assert isinstance(y, float) and math.isnan(y), k
            else:
                assert x == y, (k, x, y)
    spans = [e for e in t_evs if e["event"] == "span"]
    assert [s["name"] for s in spans] == ["encode", "publish", "iterate"]
    # Span ids are random, but the parent links keep their shape.
    raw = t_read_events(str(tmp_path / "t" / "events.jsonl"))
    enc, pub = [e for e in raw if e["event"] == "span"][:2]
    assert enc["parent"] == pub["span"] and enc["trace"] == pub["trace"]


@pytest.mark.parametrize("case", ["nan", "spike", "explosion_stall",
                                  "inlier", "cert", "abort"])
def test_health_monitor_anomalies_match_jax(tmp_path, case):
    """``tests/test_health.py``'s detector cases, fed to both packages'
    monitors: the same anomalies (kind, severity, iteration, stage and
    numeric context) in the same order, and the same aborts."""

    def drive(pkg):
        obs, health, _, _ = PACKAGES[pkg]
        out = []
        with obs.run_scope(str(tmp_path / f"{pkg}_{case}")) as run:
            cfg = {"spike": dict(cost_spike_rtol=0.25),
                   "explosion_stall": dict(grad_explosion_factor=100.0,
                                           stall_window=3, stall_rtol=1e-3),
                   "inlier": dict(inlier_collapse_drop=0.4),
                   "cert": dict(cert_refuse_streak=2),
                   "abort": dict(abort_on=frozenset({"critical"}))}
            mon = health.HealthMonitor(run, health.HealthConfig(
                **cfg.get(case, {})))
            if case == "nan":
                out += mon.observe_solver(4, float("nan"), 1.0)
                out += mon.observe_solver(6, 1.0, 1.0,
                                          rel_change=np.array([0.1, np.nan]))
            elif case == "spike":
                for it, f, mu in ((1, 100.0, 1e-4), (2, 90.0, 1e-4),
                                  (3, 140.0, 1e-4), (4, 500.0, 1.4e-4)):
                    out += mon.observe_solver(it, f, 1.0, mu=mu)
            elif case == "explosion_stall":
                for it, f, g in ((1, 10.0, 1.0), (2, 9.0, 150.0),
                                 (3, 9.0, 1.0), (4, 8.9999, 1.0),
                                 (5, 8.9998, 1.0)):
                    out += mon.observe_solver(it, f, g)
            elif case == "inlier":
                for it, frac in ((1, 0.9), (2, 0.8), (3, 0.3)):
                    out += mon.observe_solver(it, 1.0, 1.0, inlier_frac=frac)
            elif case == "cert":
                for c, dec in ((False, False), (False, False),
                               (False, False), (True, True),
                               (False, False), (False, False)):
                    out += mon.observe_certificate(c, decidable=dec)
            else:
                try:
                    mon.observe_solver(7, float("inf"), 1.0)
                except health.SolverHealthError as e:
                    out += [{"aborted": a["kind"]} for a in e.anomalies]
        return [{k: v for k, v in a.items() if k not in MASKED}
                for a in out]

    t, j = drive("port"), drive("jax")
    assert t and len(t) == len(j)
    for a, b in zip(t, j):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])


def test_materialize_reads_a_torch_tensor():
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    out = tobs.materialize(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, x.numpy())
    np.testing.assert_array_equal(tobs.materialize([1.0, 2.0]), [1.0, 2.0])


def test_telemetry_off_emits_zero_events(monkeypatch, tmp_path):
    """With no ambient run the port's spans, monitor and agent paths do
    no obs work: the emit, materialize, registry and span entry points are
    patched to throw, and a two-robot exchange with iterates runs."""
    from dpgo_tpu_torch.agent import PGOAgent
    from dpgo_tpu_torch.config import AgentParams
    from dpgo_tpu_torch.obs import metrics as mmod
    from dpgo_tpu_torch.obs import run as rmod
    from dpgo_tpu_torch.obs.events import EventStream
    from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                                partition_contiguous)
    from dpgo_tpu_torch.utils.synthetic import make_measurements

    torch.set_num_threads(1)

    def boom(*a, **kw):
        raise AssertionError("telemetry path taken while disabled")

    for target, name in ((EventStream, "emit"), (rmod, "materialize"),
                         (tobs, "materialize"), (mmod.Counter, "inc"),
                         (mmod.Gauge, "set"), (mmod.Histogram, "observe"),
                         (mmod.Histogram, "observe_many"),
                         (ttrace.Span, "__init__"), (ttrace, "emit_span"),
                         (thealth.HealthMonitor, "__init__")):
        monkeypatch.setattr(target, name, boom)
    assert tobs.get_run() is None
    assert thealth.monitor_for() is None
    with ttrace.span("noop") as sp:
        sp.add(x=1)
    meas, _ = make_measurements(np.random.default_rng(0), n=10, d=3,
                                num_lc=4)
    part = partition_contiguous(meas, 2)
    params = AgentParams(d=3, r=5, num_robots=2)
    agents = [PGOAgent(a, params, device="cpu") for a in range(2)]
    agents[1].set_lifting_matrix(agents[0].get_lifting_matrix())
    for ag in agents:
        ag.set_pose_graph(*agent_measurements(part, ag.robot_id))
    for _ in range(3):
        pubs = [ag.get_public_pose_arrays() for ag in agents]
        for src, dst in ((0, 1), (1, 0)):
            if pubs[src] is not None:
                agents[dst].update_neighbor_poses_packed(src, *pubs[src])
        for ag in agents:
            ag.iterate(True)
    agents[1].mark_neighbor_lost(0)
    assert all(ag.health_counters() == (0, 0) for ag in agents)
