"""The port's out-of-process fleet replicas
(``dpgo_tpu_torch.serve.fleet.procs``) on the CPU, held against the JAX
package's: the ``ProcTicket`` future, the structured replica-death error
the router reroutes on, the ``solve_m`` request frame and the ``status``
heartbeat reply byte for byte, the ``drain`` op, the fleet sidecar; then
REAL child processes (``--device cpu``, under their own subprocess
timeouts): boot, a solve over the TCP front-end, ``kill -9`` mid-flight,
drain for migration, and a two-process fleet that loses zero sessions
across a ``kill -9``.  A child asked for CUDA on a machine without one
fails loudly."""

import glob
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.comms.protocol import encode_frame as jencode_frame
from dpgo_tpu.serve import SolveRequest as JRequest
from dpgo_tpu.serve import SolveServer as JServer
from dpgo_tpu.serve.fleet import procs as jprocs
from dpgo_tpu.serve.fleet.router import _is_replica_death as j_is_death
from dpgo_tpu.serve.frontend import handle_request as jhandle_request
from dpgo_tpu.serve.frontend import solve_m_frame as jsolve_m_frame
from dpgo_tpu.serve.server import OverCapacityError as JOverCapacityError
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.comms.protocol import encode_frame, unpack_measurements
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.serve import (FleetRouter, ReplicaManager, SolveRequest,
                                  SolveServer)
from dpgo_tpu_torch.serve.fleet import ProcServer, ProcTicket
from dpgo_tpu_torch.serve.fleet.procs import _death_error, _result_from_reply
from dpgo_tpu_torch.serve.fleet.router import _is_replica_death
from dpgo_tpu_torch.serve.frontend import (_pack_str, _unpack_str,
                                           handle_request, solve_m_frame)
from dpgo_tpu_torch.serve.server import OverCapacityError

#: Consensus unreachable + zero gradient tolerance: solves run their full
#: iteration budget, so kills and drains land mid-flight.
PARAMS = AgentParams(d=3, r=5, num_robots=2, rel_change_tol=-1.0)
JPARAMS = jconfig.AgentParams(d=3, r=5, num_robots=2, rel_change_tol=-1.0)
#: A child's boot (import torch) and first solve on a shared host.
SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.end_run()
    yield
    obs.end_run()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meas():
    return make_measurements(np.random.default_rng(0), n=24, d=3, num_lc=8,
                             rot_noise=0.01, trans_noise=0.01)[0]


def _req(meas, sid=None, iters=2, eval_every=2):
    return SolveRequest(meas=meas, num_robots=2, params=PARAMS,
                        max_iters=iters, grad_norm_tol=0.0,
                        eval_every=eval_every, session_id=sid)


@pytest.fixture
def one_thread_children(monkeypatch):
    """Children inherit one intra-op thread (their tiny eager ops would
    spin a pool per child on a shared host)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _proc(tmp_path, rid, **kw):
    return ProcServer(replica_id=rid, max_batch=2, device="cpu",
                      spawn_timeout_s=SPAWN_TIMEOUT_S,
                      workdir=str(tmp_path), **kw)


# ---------------------------------------------------------------------------
# Parent-side contract against the JAX package (no child processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [ProcTicket, jprocs.ProcTicket])
def test_proc_ticket_first_finisher_wins(cls):
    t = cls(request=None)
    assert not t.done()
    t._finish(result="migrated-marker")
    t._finish(exception=RuntimeError("late pump reply must lose"))
    assert t.done() and t.result(timeout=1) == "migrated-marker"
    t2 = cls(request=None)
    t2._finish(exception=RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        t2.result(timeout=1)
    with pytest.raises(TimeoutError):
        cls(request=None).result(timeout=0.01)


def test_death_error_reads_as_replica_death_in_both_routers():
    e = _death_error("r0", "ConnectionReset")
    je = jprocs._death_error("r0", "ConnectionReset")
    assert type(e) is type(je) and str(e) == str(je)
    for classify, shed in ((_is_replica_death, OverCapacityError),
                           (j_is_death, JOverCapacityError)):
        assert classify(e)
        assert classify(shed("gone", reason="closed"))
        assert not classify(ValueError("bad request"))
        assert not classify(shed("busy", reason="queue"))


def test_result_from_reply_equals_jax():
    reply = {"ok": np.int8(1), "T": np.arange(24.0).reshape(2, 3, 4),
             "cost_history": np.asarray([2.0, 1.0]),
             "grad_norm_history": np.asarray([0.5, 0.1]),
             "iterations": np.int32(2),
             "terminated_by": _pack_str("max_iters"),
             "recovered": np.int8(1)}
    a, b = _result_from_reply(reply), jprocs._result_from_reply(reply)
    assert isinstance(a.T, torch.Tensor) and a.X is None
    np.testing.assert_array_equal(a.T.numpy(), np.asarray(b.T))
    assert a.cost_history == b.cost_history == [2.0, 1.0]
    assert a.grad_norm_history == b.grad_norm_history
    assert (a.iterations, a.terminated_by, a.recovered) == \
        (b.iterations, b.terminated_by, b.recovered) == \
        (2, "max_iters", True)


@pytest.mark.parametrize("sid, iters", [(None, 2), ("sess-7", 500)])
def test_solve_m_frame_bytes_equal_jax(meas, sid, iters):
    frame = solve_m_frame(_req(meas, sid=sid, iters=iters))
    jframe = jsolve_m_frame(JRequest(meas=meas, num_robots=2, params=JPARAMS,
                                     max_iters=iters, grad_norm_tol=0.0,
                                     eval_every=2, session_id=sid))
    assert encode_frame(frame) == jencode_frame(jframe)
    m2 = unpack_measurements(frame, "meas")
    np.testing.assert_array_equal(m2.r1, meas.r1)
    np.testing.assert_array_equal(m2.R, meas.R)


def _normalized_status_reply(reply: dict) -> dict:
    """The status reply with its volatile values (uptime, pid, start time)
    set to 0: the rest is the replica's state."""
    st = json.loads(_unpack_str(reply["status"]))
    st["uptime_s"] = 0.0
    st["replica"].update(pid=0, start_time=0.0)
    return {"ok": reply["ok"],
            "status": _pack_str(json.dumps(st, default=str))}


def test_status_reply_bytes_equal_jax_with_telemetry_off():
    """The heartbeat's wire: the same keys and values in the same order as
    the JAX package's reply (after the volatile values), and no clock
    stamp with telemetry off."""
    with SolveServer(max_batch=2, batch_window_s=0.0, replica_id="r0",
                     device="cpu") as srv:
        reply = handle_request(srv, {"op": _pack_str("status")})
    with JServer(max_batch=2, batch_window_s=0.0, replica_id="r0") as jsrv:
        jreply = jhandle_request(jsrv, {"op": _pack_str("status")})
    assert set(reply) == set(jreply) == {"ok", "status"}
    assert "_ts" not in reply
    assert encode_frame(_normalized_status_reply(reply)) == \
        jencode_frame(_normalized_status_reply(jreply))


def test_drain_op_evacuates_and_finishes_waiters(meas):
    with SolveServer(max_batch=2, batch_window_s=60.0,
                     device="cpu") as srv:
        parked = srv.submit(_req(meas))
        reply = handle_request(srv, {"op": _pack_str("drain")})
        assert int(np.asarray(reply["ok"])) == 1
        assert int(np.asarray(reply["evacuated"])) == 1
        with pytest.raises(OverCapacityError, match="evacuated") as ei:
            parked.result(timeout=10)
        assert ei.value.reason == "closed"
        assert srv.status()["accepting"] is False


def test_manager_fleet_sidecar_serves_aggregated_statusz(tmp_path):
    from dpgo_tpu_torch.obs import fleetobs

    def make_server(rid):
        return SolveServer(max_batch=2, batch_window_s=0.0, replica_id=rid,
                           device="cpu")

    mgr = ReplicaManager(make_server, min_replicas=1, metrics_port=0)
    try:
        mgr.start()
        assert mgr.sidecar is None  # telemetry off: no HTTP thread
    finally:
        mgr.close()
    with obs.run_scope(str(tmp_path / "mgr")):
        mgr = ReplicaManager(make_server, min_replicas=2, metrics_port=0)
        try:
            mgr.start()
            assert isinstance(mgr.sidecar, fleetobs.FleetSidecar)
            url = f"http://{mgr.sidecar.host}:{mgr.sidecar.port}/statusz"
            with urllib.request.urlopen(url, timeout=10) as resp:
                st = json.loads(resp.read().decode())
            assert set(st["replicas"]) == {"r0", "r1"}
            assert all(e["reachable"] for e in st["replicas"].values())
            assert st["fleet"]["pool"] == ["r0", "r1"]
        finally:
            mgr.close()
        assert mgr.sidecar is None


# ---------------------------------------------------------------------------
# Real child processes on the CPU
# ---------------------------------------------------------------------------

def test_child_asked_for_cuda_without_one_fails_loudly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProcServer(replica_id="c0", device="cuda", workdir=str(tmp_path),
                   spawn_timeout_s=SPAWN_TIMEOUT_S)


def test_proc_child_lifecycle_and_sigkill_mid_flight(meas, tmp_path,
                                                     one_thread_children):
    """Boot to accepting, the local admission mirror, a solve over the TCP
    front-end equal to the same request in process, and a mid-flight
    ``kill -9`` finishing the ticket with the reroutable death error."""
    srv = _proc(tmp_path, "p0", batch_window_s=0.0)
    try:
        st = srv.status()
        assert st["accepting"] is True and st["out_of_process"] is True
        assert st["child_alive"] is True and st["child_pid"] != os.getpid()

        srv.max_queue, saved = 0, srv.max_queue
        with pytest.raises(OverCapacityError) as ei:
            srv.submit(_req(meas))
        assert ei.value.reason == "queue"
        srv.max_queue = saved

        t = srv.submit(_req(meas, iters=4))
        res = t.result(timeout=SPAWN_TIMEOUT_S)
        assert res.iterations == 4 and res.terminated_by == "max_iters"
        assert t.queue_wait_s is not None and t.queue_wait_s >= 0.0
        deadline = time.monotonic() + 10.0
        while "replica" not in srv.status():  # the first heartbeat
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert srv.status()["replica"]["device"] == {"platform": "cpu",
                                                     "ordinal": 0}
        with SolveServer(max_batch=2, batch_window_s=0.0,
                         device="cpu") as local:
            ref = local.solve(_req(meas, iters=4), timeout=300)
        assert res.cost_history == ref.cost_history
        assert torch.equal(res.T, ref.T)

        doomed = srv.submit(_req(meas, iters=100000, eval_every=1))
        time.sleep(0.5)
        assert not doomed.done()
        srv.kill()
        with pytest.raises(RuntimeError) as ei:
            doomed.result(timeout=60)
        assert _is_replica_death(ei.value)
        st = srv.status()
        assert st["accepting"] is False and st["child_alive"] is False
        assert srv.proc.returncode == -9
        with pytest.raises(OverCapacityError) as ei:
            srv.submit(_req(meas))
        assert ei.value.reason == "closed"
    finally:
        srv.close()


def test_proc_child_drain_evacuates_for_migration(meas, tmp_path,
                                                  one_thread_children):
    sess_root = str(tmp_path / "sessions")
    srv = _proc(tmp_path, "p1", batch_window_s=0.0, session_store=sess_root,
                session_every=1, resume_sessions=True)
    try:
        t = srv.submit(_req(meas, sid="mig-1", iters=100000, eval_every=1))
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        sdir = os.path.join(sess_root, "mig-1")
        while time.monotonic() < deadline:
            if os.path.isdir(sdir) and any(
                    f.startswith("snap-") for f in os.listdir(sdir)):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("no boundary snapshot before drain")
        evacuated = srv.drain()
        assert evacuated == [t]
        with pytest.raises(OverCapacityError) as ei:
            t.result(timeout=60)
        assert ei.value.reason == "closed"
        st = srv.status()
        assert st["draining"] is True and st["accepting"] is False
    finally:
        srv.close()


def test_two_child_fleet_kill9_loses_zero_sessions(meas, tmp_path,
                                                   one_thread_children):
    """Two child processes behind the router and a shared session store:
    one is ``kill -9``'d with sessions in flight, reads as dead within the
    heartbeat budget, and every session completes on the survivor or the
    respawned child."""
    sess_root = str(tmp_path / "sessions")

    def make_server(rid):
        return _proc(tmp_path, rid, batch_window_s=0.02,
                     session_store=sess_root, session_every=1,
                     resume_sessions=True)

    mgr = ReplicaManager(make_server, min_replicas=2,
                         monitor_interval_s=0.2)
    router = FleetRouter(mgr)
    try:
        tickets = {f"soak-{i}": router.submit(
            _req(meas, sid=f"soak-{i}", iters=800, eval_every=1))
            for i in range(3)}
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not glob.glob(os.path.join(sess_root, "*", "snap-*.npz")):
            assert time.monotonic() < deadline, "no snapshot before kill"
            time.sleep(0.05)
        victim = tickets["soak-0"]._replica
        assert not tickets["soak-0"].done()
        victim.server.proc.kill()  # the real kill -9, outside the manager
        t_kill = time.monotonic()
        budget = victim.server.heartbeat_s * victim.server.heartbeat_misses
        while victim.alive():
            assert time.monotonic() - t_kill < budget + 2.0
            time.sleep(0.01)
        for sid, t in tickets.items():
            res = t.result(timeout=600)
            assert res.terminated_by == "max_iters", sid
        assert tickets["soak-0"].migrations >= 1
        assert router.migrations >= 1
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while len(mgr.replicas()) < 2:
            assert time.monotonic() < deadline, "the pool did not respawn"
            time.sleep(0.05)
        assert mgr.status()["respawns"] >= 1
    finally:
        router.close()
