"""The port's serving fleet (``dpgo_tpu_torch.serve.fleet``: router and
manager) on the CPU in float64, held against the JAX package's fleet.

Tolerances: the router's rendezvous weights, affinity keys and picks equal
the JAX package's exactly (they are strings and hashes); a fleet's results
equal the JAX fleet's at rtol 1e-9 (XLA and PyTorch sum in other orders);
a drain migration equals the uninterrupted solve of the port bit for bit
and the JAX package's uninterrupted solve at rtol 1e-9.  The JAX fleet runs
without ``aot_cache_dir`` (its disk round trip is not what is compared)."""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.serve import FleetRouter as JRouter
from dpgo_tpu.serve import ReplicaManager as JManager
from dpgo_tpu.serve import SolveRequest as JRequest
from dpgo_tpu.serve import SolveServer as JServer
from dpgo_tpu.serve.fleet import router as jrouter_mod
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.serve import (FleetRouter, ReplicaManager, SolveRequest,
                                  SolveServer)
from dpgo_tpu_torch.serve import server as server_mod
from dpgo_tpu_torch.serve.fleet import router as router_mod

#: Consensus unreachable (rel_change_tol < 0) + grad_norm_tol 0: solves
#: run their full iteration budget.
PARAMS = AgentParams(d=3, r=5, num_robots=2, rel_change_tol=-1.0)
JPARAMS = jconfig.AgentParams(d=3, r=5, num_robots=2, rel_change_tol=-1.0)
TOL = dict(rtol=1e-9, atol=1e-10)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.end_run()
    yield
    obs.end_run()
    torch.set_num_threads(n)


def _problem(seed=0, n=24):
    return make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=8, rot_noise=0.01, trans_noise=0.01)[0]


@pytest.fixture(scope="module")
def meas():
    return _problem()


def _req(meas, sid=None, iters=4, eval_every=2, **kw):
    return SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                        max_iters=iters, grad_norm_tol=0.0,
                        eval_every=eval_every, session_id=sid, **kw)


def _jreq(meas, sid=None, iters=4, eval_every=2, **kw):
    return JRequest(meas=meas, num_robots=2, params=JPARAMS,
                    max_iters=iters, grad_norm_tol=0.0,
                    eval_every=eval_every, session_id=sid, **kw)


def _fleet(n, sess_root=None, max_replicas=None, batch_window_s=0.0,
           **mgr_kw):
    def make_server(rid):
        return SolveServer(max_batch=2, batch_window_s=batch_window_s,
                           replica_id=rid, device="cpu",
                           session_store=sess_root, session_every=1,
                           resume_sessions=sess_root is not None)

    mgr_kw.setdefault("monitor_interval_s", 0.05)
    mgr = ReplicaManager(make_server, min_replicas=n,
                         max_replicas=max_replicas, **mgr_kw)
    return FleetRouter(mgr)


def _jfleet(n):
    def make_server(rid):
        return JServer(max_batch=2, batch_window_s=0.0, replica_id=rid)

    return JRouter(JManager(make_server, min_replicas=n,
                            monitor_interval_s=0.05))


def _wait_for_snapshot(sess_root, sid, timeout=60.0):
    deadline = time.monotonic() + timeout
    sdir = os.path.join(str(sess_root), sid)
    while time.monotonic() < deadline:
        if os.path.isdir(sdir) and any(
                f.startswith("snap-") for f in os.listdir(sdir)):
            return
        time.sleep(0.005)
    raise AssertionError(f"no snapshot for {sid} within {timeout}s")


@pytest.fixture
def slow_boundaries(monkeypatch):
    """Every batch pauses 20 ms at each eval boundary, so a solve of a few
    dozen rounds is still in flight when a test drains or kills its
    replica (the boundary is where a drain or kill stops it)."""
    real = server_mod.run_bucket

    def slow(padded, cache, **kw):
        stop = kw["should_stop"]

        def should_stop():
            time.sleep(0.02)
            return stop()

        return real(padded, cache, **dict(kw, should_stop=should_stop))

    monkeypatch.setattr(server_mod, "run_bucket", slow)


# ---------------------------------------------------------------------------
# Router: keys and picks equal the JAX package's
# ---------------------------------------------------------------------------

class _Server:
    def __init__(self, device):
        self.device = device


class _Replica:
    def __init__(self, rid, device="cpu"):
        self.replica_id = rid
        self.server = _Server(torch.device(device))

    def alive(self):
        return True


class _Manager:
    """The pool surface the router reads (no servers behind it)."""

    def __init__(self, replicas):
        self._replicas = replicas

    def attach_router(self, router):
        pass

    def start(self):
        pass

    def close(self):
        pass

    def replicas(self):
        return list(self._replicas)


def _request_pairs():
    """(port request, JAX request) pairs: tagged and untagged, several
    sizes, ranks and robot counts, float64 and float32."""
    pairs = []
    for n, robots, rank in ((24, 2, 5), (40, 3, 3), (70, 4, 5),
                            (130, 2, 4)):
        meas = _problem(seed=n, n=n)
        for sid in (None, f"sess-{n}", "shared"):
            for tdt, jdt in ((torch.float64, jnp.float64),
                             (torch.float32, jnp.float32)):
                p = AgentParams(d=3, r=rank, num_robots=robots)
                jp = jconfig.AgentParams(d=3, r=rank, num_robots=robots)
                pairs.append((
                    SolveRequest(meas=meas, num_robots=robots, params=p,
                                 dtype=tdt, session_id=sid),
                    JRequest(meas=meas, num_robots=robots, params=jp,
                             dtype=jdt, session_id=sid)))
        pairs.append((SolveRequest(meas=meas, num_robots=robots,
                                   dtype=torch.float64),
                      JRequest(meas=meas, num_robots=robots)))
    return pairs


@pytest.mark.parametrize("pool", [1, 2, 3, 4])
def test_router_keys_and_picks_equal_jax(pool):
    ids = [f"r{i}" for i in range(pool)]
    router = FleetRouter(_Manager([_Replica(r) for r in ids]))
    jrouter = JRouter(_Manager([_Replica(r) for r in ids]))
    for req, jreq in _request_pairs():
        key = router.route_key(req)
        assert key == jrouter.route_key(jreq)
        for rid in ids:
            assert router_mod._hrw_weight(key, rid) == \
                jrouter_mod._hrw_weight(key, rid)
        assert router._pick(req, set()).replica_id == \
            jrouter._pick(jreq, set()).replica_id
        # Excluding the first choice falls to the same next replica.
        first = router._pick(req, set())
        nxt = router._pick(req, {first})
        jfirst = jrouter._pick(jreq, set())
        jnxt = jrouter._pick(jreq, {jfirst})
        assert (nxt is None) == (jnxt is None)
        if nxt is not None:
            assert nxt.replica_id == jnxt.replica_id


@pytest.mark.parametrize("device, jdtype", [("cpu", jnp.float64),
                                            ("cuda", jnp.float32)])
def test_router_default_dtype_keys_as_the_replicas_solve(meas, device,
                                                          jdtype):
    """``dtype=None`` keys on the dtype the pool's replicas solve in: f64
    on the CPU, f32 on the card — never a key of its own."""
    router = FleetRouter(_Manager([_Replica("r0", device)]))
    jrouter = JRouter(_Manager([_Replica("r0")]))
    req = SolveRequest(meas=meas, num_robots=2, params=PARAMS)
    assert req.dtype is None
    key = router.route_key(req)
    assert key == jrouter.route_key(JRequest(meas=meas, num_robots=2,
                                             params=JPARAMS, dtype=jdtype))
    assert key.endswith("|" + np.dtype(jdtype).name)


# ---------------------------------------------------------------------------
# A fleet against the JAX package's fleet
# ---------------------------------------------------------------------------

def test_fleet_results_equal_jax_fleet(meas):
    """Tagged and untagged requests through a 2-replica fleet of each
    package: the same replicas, the same results (rtol 1e-9)."""
    other = _problem(seed=3, n=30)
    reqs = [(meas, "sess-A"), (meas, "sess-B"), (other, None),
            (meas, None)]
    with _fleet(2) as router:
        tickets = [router.submit(_req(m, sid=s, iters=6)) for m, s in reqs]
        ours = [(t.result(timeout=600), t._replica.replica_id)
                for t in tickets]
        st = router.status()
    with _jfleet(2) as jrouter:
        jtickets = [jrouter.submit(_jreq(m, sid=s, iters=6))
                    for m, s in reqs]
        theirs = [(t.result(timeout=600), t._replica.replica_id)
                  for t in jtickets]
        jst = jrouter.status()
    for (a, ra), (b, rb) in zip(ours, theirs):
        assert ra == rb
        assert (a.iterations, a.terminated_by) == \
            (b.iterations, b.terminated_by)
        np.testing.assert_allclose(a.cost_history, b.cost_history, **TOL)
        np.testing.assert_allclose(a.grad_norm_history,
                                   b.grad_norm_history, **TOL)
        np.testing.assert_allclose(a.T.numpy(), np.asarray(b.T), **TOL)
    assert set(st) == set(jst)
    assert st["n_replicas"] == 2 and st["requests_routed"] == len(reqs)
    assert st["migrations"] == 0 and st["accepting"]
    assert {r["replica_id"] for r in st["replicas"]} == {"r0", "r1"}
    assert [set(r) for r in st["replicas"]] == \
        [set(r) for r in jst["replicas"]]
    assert router.status()["closed"]


def test_affinity_stable_across_fleet_rebuilds(meas):
    owners = []
    for _ in range(2):
        with _fleet(2) as router:
            t = router.submit(_req(meas, sid="stable-sess", iters=2))
            t.result(timeout=600)
            owners.append(t._replica.replica_id)
    assert owners[0] == owners[1]


# ---------------------------------------------------------------------------
# Migration: drain bit for bit, kill with zero loss
# ---------------------------------------------------------------------------

def test_drain_migration_resumes_bitwise(meas, tmp_path, slow_boundaries):
    """A session drained from its replica and resumed on the other gives
    the suffix of the uninterrupted solve's histories bit for bit (the
    port's programs, a lossless snapshot, the same round schedule), and
    the JAX package's uninterrupted solve at rtol 1e-9."""
    iters = 40
    with _fleet(1, sess_root=str(tmp_path / "base")) as router:
        base = router.solve(_req(meas, sid="par", iters=iters,
                                 eval_every=1), timeout=600)
    assert len(base.cost_history) == iters
    sess_root = str(tmp_path / "mig")
    with _fleet(2, sess_root=sess_root) as router:
        t = router.submit(_req(meas, sid="par", iters=iters, eval_every=1))
        _wait_for_snapshot(sess_root, "par")
        moved = router.migrate_from(t._replica)
        assert moved == 1 and t.migrations == 1
        res = t.result(timeout=600)
        assert router.status()["migrations"] == 1
    assert res.recovered
    m = len(res.cost_history)
    assert 0 < m < iters
    assert res.cost_history == base.cost_history[-m:]
    assert res.grad_norm_history == base.grad_norm_history[-m:]
    assert torch.equal(res.T, base.T)
    with _jfleet(1) as jrouter:
        jbase = jrouter.solve(_jreq(meas, sid="par", iters=iters,
                                    eval_every=1), timeout=600)
    np.testing.assert_allclose(res.cost_history,
                               np.asarray(jbase.cost_history)[-m:], **TOL)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jbase.T), **TOL)


def test_kill_replica_mid_solve_loses_no_session(meas, tmp_path,
                                                 slow_boundaries):
    """``kill_replica`` with sessions in flight: every session completes
    (lost == 0) on the survivor from its snapshot, the router counts the
    migrations, and the pool respawns to ``min_replicas``."""
    sess_root = str(tmp_path / "sess")
    with _fleet(2, sess_root=sess_root) as router:
        mgr = router.manager
        tickets = {f"live-{i}": router.submit(
            _req(meas, sid=f"live-{i}", iters=60, eval_every=1))
            for i in range(3)}
        for sid in tickets:
            _wait_for_snapshot(sess_root, sid)
        victim = tickets["live-0"]._replica
        assert mgr.kill_replica(victim.replica_id)
        results = {sid: t.result(timeout=600) for sid, t in tickets.items()}
        lost = [sid for sid, r in results.items()
                if r.terminated_by != "max_iters"]
        assert lost == []
        assert tickets["live-0"].migrations >= 1
        assert tickets["live-0"]._replica is not victim
        assert results["live-0"].recovered
        assert 0 < results["live-0"].iterations < 60
        assert router.status()["migrations"] >= 1
        st = mgr.status()
        assert st["respawns"] >= 1 and len(mgr.replicas()) == 2
        assert victim.replica_id not in st["pool"]


# ---------------------------------------------------------------------------
# Autoscaling (deterministic: the monitor's decision is called directly)
# ---------------------------------------------------------------------------

def test_autoscale_up_then_scale_down_deterministic(meas):
    router = _fleet(1, max_replicas=2, queue_wait_slo_s=1e-9,
                    min_scale_observations=2, scale_cooldown_s=0.0,
                    scale_window_s=600.0, batch_window_s=0.01,
                    monitor_interval_s=3600.0)
    mgr = router.manager
    try:
        for _ in range(2):
            router.solve(_req(meas, iters=2), timeout=600)
        assert mgr.status()["burn"]["latency_burn"] >= 1.0
        mgr._check_scale()
        st = mgr.status()
        assert st["scale_ups"] == 1 and len(mgr.replicas()) == 2
        assert st["pool"] == ["r0", "r1"]
        # Too few new observations since the scale event: no decision.
        mgr._check_scale()
        assert len(mgr.replicas()) == 2
        assert mgr.scale_down()
        st = mgr.status()
        assert st["scale_downs"] == 1 and st["pool"] == ["r0"]
        assert not mgr.scale_down()  # at min_replicas
        # The fleet still serves after the round trip.
        res = router.solve(_req(meas, iters=2), timeout=600)
        assert res.iterations == 2
    finally:
        router.close()


def test_manager_status_keys_equal_jax():
    def make_server(rid):
        return SolveServer(max_batch=2, batch_window_s=0.0, replica_id=rid,
                           device="cpu")

    def make_jserver(rid):
        return JServer(max_batch=2, batch_window_s=0.0, replica_id=rid)

    with ReplicaManager(make_server, min_replicas=2) as mgr:
        mgr.start()
        st = mgr.status()
        alive = [r.alive() for r in mgr.replicas()]
    with JManager(make_jserver, min_replicas=2) as jmgr:
        jmgr.start()
        jst = jmgr.status()
    assert set(st) == set(jst)
    assert set(st["burn"]) == set(jst["burn"])
    assert st["pool"] == jst["pool"] == ["r0", "r1"]
    assert alive == [True, True]


def test_manager_close_joins_its_threads():
    before = set(threading.enumerate())

    def make_server(rid):
        return SolveServer(max_batch=2, batch_window_s=0.0, replica_id=rid,
                           device="cpu")

    mgr = ReplicaManager(make_server, min_replicas=2,
                         monitor_interval_s=0.01)
    FleetRouter(mgr)
    assert mgr._monitor.is_alive()
    mgr.close()
    assert not mgr._monitor.is_alive()
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert left == []


def test_fleet_events_feed_the_report_section(meas, tmp_path,
                                              slow_boundaries):
    """With a telemetry run, the fleet's spawn, death-migration and
    routing events land in the run and ``obs.report``'s fleet section
    reads them (the JAX package's report vocabulary)."""
    from dpgo_tpu_torch.obs.report import _fleet_serve_lines, fleet_serve_stats

    run_dir = tmp_path / "run"
    sess_root = str(tmp_path / "sess")
    with obs.run_scope(str(run_dir)):
        with _fleet(2, sess_root=sess_root) as router:
            t = router.submit(_req(meas, sid="rep-1", iters=60,
                                   eval_every=1))
            _wait_for_snapshot(sess_root, "rep-1")
            router.manager.kill_replica(t._replica.replica_id)
            assert t.result(timeout=600).recovered
    events = obs.read_events(str(run_dir / "events.jsonl"))
    st = fleet_serve_stats(events)
    assert st["replicas"]["spawned"] == 3
    assert st["replicas"]["spawn_reasons"] == {"start": 2, "respawn": 1}
    assert st["migrations"]["by_kind"] == {"death": 1}
    assert st["migrations"]["failed"] == 0
    assert "3 replicas spawned" in "\n".join(_fleet_serve_lines(st))
