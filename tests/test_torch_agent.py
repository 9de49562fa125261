"""The port's per-robot runtime (``dpgo_tpu_torch.agent.PGOAgent``) against
the JAX package's (``dpgo_tpu.agent.PGOAgent``) on the same problem, on the
CPU in float64: the same lifting matrix, the same state transitions and
the same iterate after each of 20 lockstep rounds at rtol 1e-9 (plain,
accelerated with restarts, GNC_TLS with its weights and mu); the same
state continued from one JAX mid-run state (``interop``); the same dump
files; and the port's own surface (fetch cadence, admission, reset,
sequence checks, the lost-neighbor quorum, the forced kernel's plain
version, the async loop, the host-read seam)."""

import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch

from dpgo_tpu.agent import PGOAgent as JAgent
from dpgo_tpu.config import AgentParams as JParams
from dpgo_tpu.config import RobustCostParams as JRobust
from dpgo_tpu.config import RobustCostType as JCost
from dpgo_tpu.utils import logger as jlogger
from dpgo_tpu.utils.partition import agent_measurements as j_am
from dpgo_tpu.utils.partition import partition_contiguous as j_pc
from dpgo_tpu.utils.synthetic import make_measurements as j_mm
from dpgo_tpu_torch import agent as agent_mod
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.agent import AgentState, PGOAgent
from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                   RobustCostType, SolverParams)
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils import logger
from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                            partition_contiguous)
from dpgo_tpu_torch.utils.synthetic import make_measurements

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(port: bool, kind: str, **extra) -> dict:
    """AgentParams keywords of one case, in either package's types."""
    kw = dict(extra)
    if kind == "accel":
        kw.update(acceleration=True, restart_interval=7)
    elif kind == "gnc":
        rp = RobustCostParams if port else JRobust
        ct = RobustCostType if port else JCost
        kw.update(robust=rp(cost_type=ct.GNC_TLS, gnc_barc=5.0),
                  robust_opt_inner_iters=3)
    return kw


def _agents(port: bool, A=3, n=18, num_lc=10, seed=0, kind="plain",
            device="cpu", dtype=None, outliers=0, **extra):
    mm, pc, am = (make_measurements, partition_contiguous,
                  agent_measurements) if port else (j_mm, j_pc, j_am)
    meas, _ = mm(np.random.default_rng(seed), n=n, d=3, num_lc=num_lc,
                 rot_noise=0.01, trans_noise=0.01, outlier_lc=outliers)
    part = pc(meas, A)
    P = AgentParams if port else JParams
    params = P(d=3, r=5, num_robots=A, **_kw(port, kind, **extra))
    if port:
        ags = [PGOAgent(a, params, device=device, dtype=dtype)
               for a in range(A)]
    else:
        ags = [JAgent(a, params) for a in range(A)]
    for ag in ags[1:]:
        ag.set_lifting_matrix(ags[0].get_lifting_matrix())
    for ag in ags:
        ag.set_pose_graph(*am(part, ag.robot_id))
    return ags, part


def exchange(agents, aux=False):
    """All-to-all public pose push plus status gossip (the in-process loop
    of MultiRobotExample.cpp:186-213)."""
    dicts = [ag.get_shared_pose_dict() for ag in agents]
    for src in agents:
        for dst in agents:
            if src is not dst:
                dst.update_neighbor_poses(src.robot_id, dicts[src.robot_id])
    if aux:
        dicts = [ag.get_aux_shared_pose_dict() for ag in agents]
        for src in agents:
            for dst in agents:
                if src is not dst:
                    dst.update_aux_neighbor_poses(src.robot_id,
                                                  dicts[src.robot_id])
    for src in agents:
        st = src.get_status()
        for dst in agents:
            if src is not dst:
                dst.set_neighbor_status(st)


def _assert_same(j, t, rtol=RTOL):
    for a, b in zip(j, t):
        sa, sb = a.get_status(), b.get_status()
        assert (sa.state.value, sa.iteration_number, sa.instance_number,
                sa.ready_to_terminate) == \
            (sb.state.value, sb.iteration_number, sb.instance_number,
             sb.ready_to_terminate)
        if a.X is None:
            assert b.X is None
            continue
        Xa = np.asarray(a.X)
        np.testing.assert_allclose(b.X, Xa, rtol=rtol,
                                   atol=rtol * np.abs(Xa).max())
        np.testing.assert_allclose(b._weights, a._weights, rtol=rtol,
                                   atol=rtol)
        assert b._mu == pytest.approx(a._mu, rel=1e-12)
        assert b._num_weight_updates == a._num_weight_updates


@pytest.mark.parametrize("kind", ["plain", "accel", "gnc"])
def test_lockstep_rounds_match_jax(kind):
    """20 lockstep rounds: robot 1 and 2 wait for an initialized neighbor,
    align, and then every iterate equals JAX's at rtol 1e-9."""
    A, n, lc = (2, 12, 6) if kind == "accel" else (3, 18, 10)
    out = 2 if kind == "gnc" else 0
    j, _ = _agents(False, A=A, n=n, num_lc=lc, kind=kind, outliers=out)
    t, _ = _agents(True, A=A, n=n, num_lc=lc, kind=kind, outliers=out)
    np.testing.assert_allclose(t[0].get_lifting_matrix(),
                               j[0].get_lifting_matrix(), rtol=0,
                               atol=1e-12)
    assert [a.get_status().state.value for a in t] == \
        [a.get_status().state.value for a in j] == \
        [AgentState.INITIALIZED.value] + \
        [AgentState.WAIT_FOR_INITIALIZATION.value] * (A - 1)
    seen = set()
    for _ in range(20):
        exchange(j, aux=kind == "accel")
        exchange(t, aux=kind == "accel")
        for a, b in zip(j, t):
            assert a.iterate(True) == b.iterate(True)
        _assert_same(j, t)
        seen |= {(a.robot_id, a.get_status().state.value) for a in t}
    assert all(a.get_status().state == AgentState.INITIALIZED for a in t)
    assert (1, AgentState.WAIT_FOR_INITIALIZATION.value) not in seen or \
        (1, AgentState.INITIALIZED.value) in seen
    if kind == "gnc":
        assert all(b._num_weight_updates > 0 for b in t)
        assert any((b._weights < 1).any() for b in t)


def test_continue_from_a_jax_mid_run_state():
    """Both packages continue 10 iterates from one JAX mid-run state
    (loaded through ``interop.agent_state_from_numpy``)."""
    j, _ = _agents(False, kind="gnc", outliers=2)
    t, _ = _agents(True, kind="gnc", outliers=2)
    for _ in range(7):
        exchange(j)
        for a in j:
            a.iterate(True)
    for a, b in zip(j, t):
        interop.agent_state_from_numpy(b, interop.agent_state_to_numpy(a))
    _assert_same(j, t, rtol=0)
    for _ in range(10):
        exchange(j)
        exchange(t)
        for a, b in zip(j, t):
            assert a.iterate(True) == b.iterate(True)
    _assert_same(j, t)
    # The state reads back as it was loaded.
    back = interop.agent_state_to_numpy(t[1])
    assert back["status"][2] == t[1].get_status().iteration_number


def test_status_fetch_every_latches_rel_change():
    """``status_fetch_every=4``: the gossiped relative change refreshes
    every 4th iterate only (one ``rel_change`` read per 4 stepped
    iterates), and the iterates equal the per-iterate fetch's exactly."""
    ags, _ = _agents(True, A=2, n=12, num_lc=6, status_fetch_every=4)
    ref, _ = _agents(True, A=2, n=12, num_lc=6)
    stepped = reads = 0
    for it in range(1, 9):
        exchange(ags)
        before = agent_mod.HOST_READS["rel_change"]
        for ag in ags:
            stepped += ag.iterate()
        reads += agent_mod.HOST_READS["rel_change"] - before
        exchange(ref)
        for ag in ref:
            ag.iterate()
        if it < 4:
            assert math.isinf(ags[1].get_status().relative_change)
        if it % 4 == 0:
            assert all(math.isfinite(ag.get_status().relative_change)
                       for ag in ags)
            assert ags[0].get_status().relative_change == \
                ref[0].get_status().relative_change
    # Robot 1 aligns in round 1's exchange and steps from round 1; robot
    # 0 waits for robot 1's poses until round 2.  Reads only at
    # iterations 4 and 8 of each.
    assert stepped == 15
    assert reads == 4
    for a, b in zip(ags, ref):
        np.testing.assert_array_equal(a.X, b.X)


def test_host_reads_one_scalar_per_iterate_and_one_per_publish():
    ags, _ = _agents(True, A=2, n=12, num_lc=6)
    for _ in range(2):
        exchange(ags)
        for ag in ags:
            ag.iterate()
    agent_mod.HOST_READS.clear()
    stepped = publishes = 0
    for _ in range(3):
        pubs = [ag.get_public_pose_arrays() for ag in ags]
        publishes += 2
        for src, dst in ((0, 1), (1, 0)):
            ags[dst].update_neighbor_poses_packed(src, *pubs[src])
        for ag in ags:
            stepped += ag.iterate()
    assert stepped == 6
    assert dict(agent_mod.HOST_READS) == {"rel_change": stepped,
                                          "publish": publishes}


def test_forced_kernel_plain_version_matches_ell():
    """``pallas_tcg=True`` on CPU tensors: every stepped iterate goes
    through B2's wrapper (its plain version here), a float32 agent, and
    the trajectory matches the "ell" agents (float64) within the JAX
    test's tolerance (``test_agent_iterate_pallas_kernel_matches_ell``)."""
    kw = dict(rel_change_tol=0.0)
    ag_k, _ = _agents(True, A=2, n=10, num_lc=4, dtype=torch.float32,
                      solver=SolverParams(pallas_tcg=True,
                                          grad_norm_tol=1e-9), **kw)
    ag_e, _ = _agents(True, A=2, n=10, num_lc=4,
                      solver=SolverParams(pallas_tcg=False,
                                          grad_norm_tol=1e-9), **kw)
    assert ag_k[0]._kernel and not ag_e[0]._kernel
    calls = [0]
    real = rk.rtr_full

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    try:
        rk.rtr_full = counting
        stepped = 0
        for _ in range(4):
            exchange(ag_k)
            exchange(ag_e)
            for ag in ag_k:
                stepped += ag.iterate(True)
            for ag in ag_e:
                ag.iterate(True)
    finally:
        rk.rtr_full = real
    assert calls[0] == stepped > 0
    for k, e in zip(ag_k, ag_e):
        assert k.X.dtype == np.float32
        assert np.allclose(k.X, e.X, atol=5e-5), np.abs(k.X - e.X).max()
    # A float64 agent cannot force the float32 kernel.
    with pytest.raises(ValueError, match="float32-only"):
        _agents(True, A=1, n=8, num_lc=2,
                solver=SolverParams(pallas_tcg=True))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PGOAgent(0, AgentParams(d=3, r=5, num_robots=1))


def test_admit_neighbor_extends_quorum_and_problem():
    """The JAX package's admission case on the port: the joiner extends
    the consensus test and the withheld shared edges grow the live problem
    with the iterate preserved."""
    meas, _ = make_measurements(np.random.default_rng(3), n=18, d=3,
                                num_lc=10, rot_noise=0.01, trans_noise=0.01)
    part3 = partition_contiguous(meas, 3)

    def drop_joiner(rid):
        odo, priv, shared = agent_measurements(part3, rid)
        touches = (np.asarray(shared.r1) == 2) | (np.asarray(shared.r2) == 2)
        return (odo, priv, shared.select(~touches)), shared.select(touches)

    params2 = AgentParams(d=3, r=5, num_robots=2, rel_change_tol=1e9)
    agents = {rid: PGOAgent(rid, params2, device="cpu") for rid in (0, 1)}
    agents[1].set_lifting_matrix(agents[0].get_lifting_matrix())
    withheld = {}
    for rid in (0, 1):
        kept, withheld[rid] = drop_joiner(rid)
        agents[rid].set_pose_graph(*kept)
    for _ in range(2):
        exchange(list(agents.values()))
    for ag in agents.values():
        ag.iterate(True)
    exchange(list(agents.values()))
    for ag in agents.values():
        ag.iterate(True)
    exchange(list(agents.values()))
    assert agents[0].should_terminate()
    e_before = {rid: int(agents[rid]._edges.i.shape[0]) for rid in (0, 1)}
    X_before = {rid: agents[rid].X.copy() for rid in (0, 1)}
    for rid in (0, 1):
        added = agents[rid].admit_neighbor(2, withheld[rid])
        assert added == len(withheld[rid])
        assert agents[rid].num_robots == 3
        assert int(agents[rid]._edges.i.shape[0]) == \
            e_before[rid] + len(withheld[rid])
        np.testing.assert_array_equal(agents[rid].X, X_before[rid])
        assert agents[rid]._graph.edges.i.shape[-1] == \
            e_before[rid] + len(withheld[rid])
    assert not agents[0].should_terminate()
    params3 = AgentParams(d=3, r=5, num_robots=3, rel_change_tol=1e9)
    a2 = PGOAgent(2, params3, device="cpu")
    a2.set_lifting_matrix(agents[0].get_lifting_matrix())
    a2.set_pose_graph(*agent_measurements(part3, 2))
    fleet = [agents[0], agents[1], a2]
    for _ in range(3):
        exchange(fleet)
        for ag in fleet:
            ag.iterate(True)
    exchange(fleet)
    assert agents[0].should_terminate()
    bad = dataclasses.replace(
        agents[0]._meas.select([0]),
        r1=np.asarray([0], np.int32), p1=np.asarray([agents[0].n + 3]),
        r2=np.asarray([2], np.int32), p2=np.asarray([0]))
    with pytest.raises(ValueError, match="own poses"):
        agents[0].admit_neighbor(2, bad)


def test_stale_sequence_drop_lost_quorum_and_revival():
    ags, _ = _agents(True, A=2, n=10, num_lc=6)
    a0, a1 = ags
    fresh = a0.get_shared_pose_dict()
    keys = sorted(fresh)
    a1.update_neighbor_poses(0, fresh, sequence=7)
    # A stale frame (sequence at or below the last accepted) is dropped.
    a1.update_neighbor_poses(0, {k: np.zeros_like(v)
                                 for k, v in fresh.items()}, sequence=7)
    for k in keys:
        np.testing.assert_array_equal(a1._nbr_lookup(k), fresh[k])
    # Lost-neighbor quorum: robot 1 ready alone once robot 0 is lost.
    exchange(ags)
    for _ in range(30):
        for ag in ags:
            ag.iterate(True)
        exchange(ags)
    a1._status.ready_to_terminate = True
    a1.set_neighbor_status(dataclasses.replace(a0.get_status(),
                                               ready_to_terminate=False))
    assert not a1.should_terminate()
    a1.mark_neighbor_lost(0)
    assert a1.lost_neighbors == [0] and a1.should_terminate()
    # Revival: the first frame wins whatever its sequence, the rest of the
    # pre-outage cache is invalidated.
    partial = {keys[0]: np.ones_like(fresh[keys[0]])}
    a1.update_neighbor_poses(0, partial, sequence=2)
    assert a1.lost_neighbors == []
    np.testing.assert_allclose(a1._nbr_lookup(keys[0]), 1.0)
    for k in keys[1:]:
        assert a1._nbr_lookup(k) is None
    assert a1._neighbor_buffer() is None


def test_reset_rolls_instance_and_dumps_logs(tmp_path):
    """``reset`` dumps the solve's data and rolls the instance; the dump
    files carry the same bytes as the JAX package's writer for the same
    values (measurements and X of a state loaded from a JAX agent) and the
    same rounded trajectory to 1e-9."""
    j, _ = _agents(False, A=2, n=12, num_lc=6, log_data=True,
                   log_directory=str(tmp_path / "j"))
    t, _ = _agents(True, A=2, n=12, num_lc=6, log_data=True,
                   log_directory=str(tmp_path / "t"))
    for _ in range(4):
        exchange(j)
        for a in j:
            a.iterate(True)
    anchor = np.asarray(j[0].get_global_anchor())
    for a, b in zip(j, t):
        a.set_global_anchor(anchor)
        interop.agent_state_from_numpy(b, interop.agent_state_to_numpy(a))
    for a, b in zip(j, t):
        a.reset()
        b.reset()
        assert b.get_status().instance_number == 1
        assert b.get_status().state == AgentState.WAIT_FOR_DATA
        assert b.X is None and b._graph is None
        for name in ("measurements.csv", "X.txt"):
            pj = tmp_path / "j" / f"robot{a.robot_id}" / name
            pt = tmp_path / "t" / f"robot{b.robot_id}" / name
            assert pt.read_bytes() == pj.read_bytes(), name
        pj = tmp_path / "j" / f"robot{a.robot_id}" / "trajectory_optimized.csv"
        pt = tmp_path / "t" / f"robot{b.robot_id}" / "trajectory_optimized.csv"
        assert pt.read_text().splitlines()[0] == \
            pj.read_text().splitlines()[0]
        np.testing.assert_allclose(logger.load_trajectory(str(pt)),
                                   jlogger.load_trajectory(str(pj)),
                                   rtol=1e-9, atol=1e-9)


def test_logger_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(2)
    meas, _ = make_measurements(rng, n=9, d=3, num_lc=3)
    T = np.concatenate([meas.R[:9], rng.standard_normal((9, 3, 1))], -1)
    M = rng.standard_normal((5, 12))
    for name, fn_t, fn_j, arg in (
            ("m.csv", logger.log_measurements, jlogger.log_measurements,
             meas),
            ("t.csv", logger.log_trajectory, jlogger.log_trajectory, T),
            ("x.txt", logger.save_matrix, jlogger.save_matrix, M)):
        fn_t(arg, str(tmp_path / f"t_{name}"))
        fn_j(arg, str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_bytes() == \
            (tmp_path / f"j_{name}").read_bytes(), name
    back = logger.load_measurements(str(tmp_path / "t_m.csv"))
    np.testing.assert_allclose(back.R, meas.R, atol=1e-12)
    np.testing.assert_array_equal(logger.load_matrix(
        str(tmp_path / "t_x.txt")), M)


def test_async_loop_lifecycle():
    """The Poisson-clock thread: starts, iterates while the caller keeps
    exchanging, joins on end (also from ``reset``), and rejects
    acceleration."""
    ags, _ = _agents(True, A=2, n=10, num_lc=4)
    exchange(ags)
    for ag in ags:
        ag.iterate(True)
    for ag in ags:
        ag.start_optimization_loop(rate_hz=200.0)
        assert ag.is_optimization_running()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and \
            min(ag.get_status().iteration_number for ag in ags) < 10:
        exchange(ags)
        time.sleep(0.005)
    for ag in ags:
        ag.end_optimization_loop()
        assert not ag.is_optimization_running()
    assert min(ag.get_status().iteration_number for ag in ags) >= 10
    ags[0].start_optimization_loop(rate_hz=200.0)
    done = threading.Event()

    def do_reset():
        ags[0].reset()
        done.set()
    threading.Thread(target=do_reset, daemon=True).start()
    assert done.wait(10.0)
    assert not ags[0].is_optimization_running()
    acc, _ = _agents(True, A=1, n=8, num_lc=2, kind="accel")
    with pytest.raises(ValueError, match="async"):
        acc[0].start_optimization_loop()


def test_trajectories_and_getters_match_jax():
    j, part = _agents(False)
    t, _ = _agents(True)
    for _ in range(5):
        exchange(j)
        exchange(t)
        for a, b in zip(j, t):
            a.iterate(True)
            b.iterate(True)
    anchor = np.asarray(j[0].get_global_anchor())
    np.testing.assert_allclose(t[0].get_global_anchor(), anchor, rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(j, t):
        a.set_global_anchor(anchor)
        b.set_global_anchor(anchor)
        np.testing.assert_allclose(b.trajectory_in_global_frame(),
                                   a.trajectory_in_global_frame(),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(b.trajectory_in_local_frame(),
                                   a.trajectory_in_local_frame(),
                                   rtol=1e-9, atol=1e-9)
        assert b.get_neighbors() == a.get_neighbors()
        assert b.local_cost() == pytest.approx(a.local_cost(), rel=1e-9)
        np.testing.assert_allclose(b.get_pose_in_global_frame(1),
                                   a.get_pose_in_global_frame(1),
                                   rtol=1e-9, atol=1e-12)
        assert b.get_shared_weight_dict() == a.get_shared_weight_dict()
