"""Seeded chaos on the port's deployment stack: port ``PGOAgent``s
(``device="cpu"``) over the port's loopback fleet (``dpgo_tpu_torch.comms``)
under ``tests/test_chaos.py``'s fault spec and robot kill.  Thread timing
makes a step-by-step comparison with the JAX package impossible, so its
own acceptance is the gate: the run completes without hanging, everyone
learns of the dead robot, and the survivors' cost (over the survivors'
edges) is within 1% of the fault-free run's."""

import time

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import obs
from dpgo_tpu_torch.agent import AgentState, PGOAgent
from dpgo_tpu_torch.comms import (FaultInjector, FaultSpec, RetryPolicy,
                                  apply_peer_frame, loopback_fleet,
                                  pack_agent_frame)
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.ops import quadratic
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                            partition_contiguous)
from dpgo_tpu_torch.utils.synthetic import make_measurements

NUM_ROBOTS = 3
ROUNDS = 60
KILL = (2, 40)  # robot 2 dies at round 40
PACE_S = 0.004
CHAOS = FaultSpec(drop=0.10, delay=0.25, delay_s=(PACE_S, 3 * PACE_S),
                  reorder=0.05)
POLICY = RetryPolicy(max_attempts=2, base_delay_s=0.002, max_delay_s=0.01,
                     send_timeout_s=0.5, recv_timeout_s=0.5)


@pytest.fixture(autouse=True)
def _one_thread_no_run():
    obs.end_run()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.end_run()


def _make_problem(seed=0, n=24, num_lc=12):
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=num_lc, rot_noise=0.01,
                                trans_noise=0.01)
    return meas, partition_contiguous(meas, NUM_ROBOTS)


def _run_fleet(part, injector=None, kill=None, rounds=ROUNDS):
    """A lockstep solve over the loopback fleet (``tests/test_chaos.py``'s
    ``_run_fleet`` at staleness 0)."""
    params = AgentParams(d=3, r=5, num_robots=NUM_ROBOTS)
    agents = {rid: PGOAgent(rid, params, device="cpu")
              for rid in range(NUM_ROBOTS)}
    for rid in range(1, NUM_ROBOTS):
        agents[rid].set_lifting_matrix(agents[0].get_lifting_matrix())
    for rid, ag in agents.items():
        ag.set_pose_graph(*agent_measurements(part, rid))
    bus, clients = loopback_fleet(
        NUM_ROBOTS, injector=injector, policy=POLICY,
        round_timeout_s=0.15, miss_limit=5, liveness_timeout_s=0.5)
    for c in clients.values():
        c.channel.start_heartbeat(0.05)
    dead: set[int] = set()
    for it in range(rounds):
        if kill is not None and it == kill[1]:
            dead.add(kill[0])
            clients[kill[0]].close()
        for rid, ag in agents.items():
            if rid in dead:
                continue
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
        if injector is not None:
            time.sleep(PACE_S)
    bus.close()
    for rid, c in clients.items():
        if rid not in dead:
            c.close()
    return agents, bus


def _team_cost(agents, part, meas, survivors):
    """SE(d) cost of the assembled global trajectory over the edges whose
    both endpoints belong to surviving robots (float64, host)."""
    d = meas.d
    anchor = agents[0].get_global_anchor()
    T = np.zeros((meas.num_poses, d, d + 1))
    for rid in survivors:
        ag = agents[rid]
        if ag.get_global_anchor() is None:
            ag.set_global_anchor(anchor)
        ids = part.global_index[rid][part.global_index[rid] >= 0]
        T[ids] = ag.trajectory_in_global_frame()
    pm = part.meas
    keep = np.isin(np.asarray(pm.r1), list(survivors)) & \
        np.isin(np.asarray(pm.r2), list(survivors))
    edges = edge_set_from_measurements(part.meas_global.select(keep),
                                       device="cpu")
    return float(quadratic.cost(torch.as_tensor(T), edges))


def test_chaos_solve_completes_and_matches_fault_free():
    meas, part = _make_problem()
    survivors = [0, 1]
    clean, clean_bus = _run_fleet(part)
    assert clean_bus.lost == set()
    cost_clean = _team_cost(clean, part, meas, survivors)

    injector = FaultInjector(CHAOS, seed=7)
    t0 = time.monotonic()
    agents, bus = _run_fleet(part, injector=injector, kill=KILL)
    assert time.monotonic() - t0 < 120.0
    assert injector.stats["dropped"] > 0
    assert injector.stats["delayed"] > 0
    assert bus.totals().timeouts > 0
    assert bus.lost == {KILL[0]}
    for rid in survivors:
        assert agents[rid].lost_neighbors == [KILL[0]]
        assert agents[rid].get_status().state == AgentState.INITIALIZED
        assert agents[rid].get_status().iteration_number >= ROUNDS - 5
    cost_chaos = _team_cost(agents, part, meas, survivors)
    assert cost_chaos == pytest.approx(cost_clean, rel=0.01)


def test_fault_free_fleet_reaches_consensus_like_jax():
    """The lockstep fleet without faults: every robot initializes, the
    team cost over all edges matches the JAX package's fault-free fleet
    within 1% (the same ``make_measurements`` draw on both sides)."""
    from dpgo_tpu.agent import PGOAgent as JAgent
    from dpgo_tpu.comms import apply_peer_frame as j_apply
    from dpgo_tpu.comms import loopback_fleet as j_fleet
    from dpgo_tpu.comms import pack_agent_frame as j_pack
    from dpgo_tpu.config import AgentParams as JParams
    from dpgo_tpu.utils.partition import agent_measurements as j_am
    from dpgo_tpu.utils.partition import partition_contiguous as j_pc
    from dpgo_tpu.utils.synthetic import make_measurements as j_mm

    meas, part = _make_problem(seed=1)
    agents, bus = _run_fleet(part, rounds=40)
    assert bus.lost == set()
    assert all(ag.get_status().state == AgentState.INITIALIZED
               for ag in agents.values())
    cost = _team_cost(agents, part, meas, [0, 1, 2])

    params = JParams(d=3, r=5, num_robots=NUM_ROBOTS)
    jag = {rid: JAgent(rid, params) for rid in range(NUM_ROBOTS)}
    for rid in range(1, NUM_ROBOTS):
        jag[rid].set_lifting_matrix(jag[0].get_lifting_matrix())
    jmeas, _ = j_mm(np.random.default_rng(1), n=24, d=3, num_lc=12,
                    rot_noise=0.01, trans_noise=0.01)
    jpart = j_pc(jmeas, NUM_ROBOTS)
    for rid, ag in jag.items():
        ag.set_pose_graph(*j_am(jpart, rid))
    jbus, jcl = j_fleet(NUM_ROBOTS, policy=POLICY, round_timeout_s=0.15)
    for _ in range(40):
        for rid, ag in jag.items():
            jcl[rid].publish(j_pack(ag, include_anchor=(rid == 0)),
                             timeout=0.5)
        jbus.round()
        for rid, ag in jag.items():
            merged = jcl[rid].collect(timeout=0.3)
            if merged is not None:
                for peer, pf in jcl[rid].peer_frames(merged).items():
                    j_apply(ag, peer, pf,
                            accept_anchor=(rid != 0 and peer == 0))
            ag.iterate(True)
    jbus.close()
    for c in jcl.values():
        c.close()
    anchor = np.asarray(jag[0].get_global_anchor())
    T = np.zeros((meas.num_poses, 3, 4))
    for rid, ag in jag.items():
        ag.set_global_anchor(anchor)
        ids = part.global_index[rid][part.global_index[rid] >= 0]
        T[ids] = ag.trajectory_in_global_frame()
    edges = edge_set_from_measurements(part.meas_global, device="cpu")
    jcost = float(quadratic.cost(torch.as_tensor(T), edges))
    assert cost == pytest.approx(jcost, rel=0.01)
