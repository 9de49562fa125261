"""The port's multi-process TCP deployment
(``python -m dpgo_tpu_torch.examples.tcp_deployment_example``) on the CPU:
robot processes on ``--device cpu`` over real localhost sockets, on a
synthetic dataset written by ``write_g2o`` (float64).

* The lockstep runs (2 robots, 4 robots) equal the same schedule run in
  one process over the port's ``comms.loopback_fleet`` at rtol 1e-9, and
  the 4-robot team lands where the 2-robot one does.
* Chaos over real sockets (``tests/test_tcp_deployment.py``'s seeded drop
  and delay, a robot killed mid-solve): ``lost == [k]``, the survivors'
  states and iterations as in the JAX package's test.
* The async mode completes.
* One mixed bus: a JAX robot process (the JAX package's example) and a
  port robot process on one bus bound here with the port's
  ``listen_tcp`` / ``accept_robots`` / ``RoundBus``; the survivors' cost
  equals a port-only run at rtol 1e-9 (the frames are byte-identical).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dpgo_tpu_torch import comms
from dpgo_tpu_torch.agent import PGOAgent
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.examples import tcp_deployment_example as tcp
from dpgo_tpu_torch.utils.g2o import read_g2o, write_g2o
from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                            partition_contiguous)
from dpgo_tpu_torch.utils.synthetic import make_measurements

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(REPO, "examples", "tcp_deployment_example.py")
MODULE = "dpgo_tpu_torch.examples.tcp_deployment_example"
RTOL = 1e-9


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    meas, _ = make_measurements(np.random.default_rng(0), n=36, d=3,
                                num_lc=18, rot_noise=0.01, trans_noise=0.01)
    path = str(tmp_path_factory.mktemp("data") / "synthetic.g2o")
    write_g2o(meas, path)
    return path


def _launch(dataset, out_dir, *flags, timeout=300):
    out = subprocess.run(
        [sys.executable, "-m", MODULE, dataset, "--device", "cpu",
         "--out-dir", str(out_dir), *flags],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _loopback_run(dataset, robots, rounds):
    """The launcher's lockstep schedule in one process over
    ``comms.loopback_fleet``: the lifting-matrix round, ``rounds`` rounds of
    publish (robot 0 with its anchor) / relay / ingest / iterate, the final
    anchor round; returns the survivors' cost as the launcher computes it,
    and every robot's iteration count."""
    meas = read_g2o(dataset)
    params = AgentParams(d=meas.d, r=5, num_robots=robots)
    part = partition_contiguous(meas, robots)
    agents = [PGOAgent(rid, params, device="cpu") for rid in range(robots)]
    bus, clients = comms.loopback_fleet(robots, round_timeout_s=30.0)

    def relay(frames):
        for rid, frame in frames.items():
            clients[rid].publish(frame, timeout=30.0)
        bus.round()
        return {rid: clients[rid].collect(timeout=30.0)
                for rid in range(robots)}

    merged = relay({rid: ({"ylift": agents[0].get_lifting_matrix()}
                          if rid == 0 else {}) for rid in range(robots)})
    for rid in range(1, robots):
        agents[rid].set_lifting_matrix(merged[rid]["r0|ylift"])
    for ag in agents:
        ag.set_pose_graph(*agent_measurements(part, ag.robot_id))
    for _ in range(rounds):
        merged = relay({ag.robot_id: comms.pack_agent_frame(
            ag, include_anchor=(ag.robot_id == 0)) for ag in agents})
        for ag in agents:
            c = clients[ag.robot_id]
            for peer, pf in c.peer_frames(merged[ag.robot_id]).items():
                comms.apply_peer_frame(ag, peer, pf,
                                       accept_anchor=(ag.robot_id != 0
                                                      and peer == 0))
        for ag in agents:
            ag.iterate(do_optimization=True)
    merged = relay({rid: ({"anchor": np.asarray(
        agents[0].get_global_anchor())} if rid == 0 else {})
        for rid in range(robots)})
    for rid in range(1, robots):
        agents[rid].set_global_anchor(merged[rid]["r0|anchor"])
    bus.close()
    for c in clients.values():
        c.close()
    outs = {ag.robot_id: {"T": ag.trajectory_in_global_frame()}
            for ag in agents}
    return (tcp.survivor_cost(dataset, robots, outs),
            [ag.get_status().iteration_number for ag in agents])


@pytest.mark.parametrize("robots", [2, 4])
def test_port_tcp_lockstep_equals_loopback_fleet(dataset, tmp_path, robots):
    rounds = 30
    res = _launch(dataset, tmp_path, "--robots", str(robots),
                  "--rounds", str(rounds))
    assert res["states"] == [2] * robots
    assert res["lost"] == []
    assert all(b > 0 for b in res["bytes_sent"])
    ref_cost, ref_iters = _loopback_run(dataset, robots, rounds)
    assert res["iterations"] == ref_iters == [rounds] * robots
    assert res["cost"] == pytest.approx(ref_cost, rel=RTOL)
    # Per-robot counts: a CPU robot launches no kernel; one rel_change
    # read per stepped iterate.
    for rid in range(robots):
        o = np.load(os.path.join(tmp_path, f"robot{rid}.npz"))
        assert int(o["b2_launches"]) == 0
        assert int(o["iterates"]) == rounds
        reads = json.loads(str(o["host_reads"]))
        assert reads.get("rel_change", 0) == int(o["stepped"]) > 0
        assert str(o["device"]) == "cpu"


def test_port_four_robot_team_reaches_the_two_robot_optimum(dataset,
                                                            tmp_path):
    two = _launch(dataset, tmp_path / "two", "--robots", "2",
                  "--rounds", "60")
    four = _launch(dataset, tmp_path / "four", "--robots", "4",
                   "--rounds", "60")
    assert two["states"] == [2, 2] and four["states"] == [2] * 4
    assert four["cost"] == pytest.approx(two["cost"], rel=1e-2)


def test_port_three_process_chaos_loses_the_killed_robot(dataset,
                                                          tmp_path):
    res = _launch(dataset, tmp_path, "--robots", "3", "--rounds", "40",
                  "--round-timeout", "1", "--fault-drop", "0.1",
                  "--fault-delay", "0.2", "--fault-delay-s", "0.02", "0.1",
                  "--fault-seed", "7", "--kill-robot", "2",
                  "--kill-round", "25")
    assert res["lost"] == [2]
    assert res["states"][:2] == [2, 2] and res["states"][2] is None
    # Survivors completed essentially every round despite the faults.
    assert all(it >= 35 for it in res["iterations"][:2])
    assert res["iterations"][2] is None
    assert res["cost"] < 100.0


def test_port_async_tcp_solve(dataset, tmp_path):
    res = _launch(dataset, tmp_path, "--robots", "3", "--rounds", "30",
                  "--mode", "async", "--async-rate", "30",
                  "--staleness", "1")
    assert res["states"] == [2, 2, 2]
    assert all(it >= 1 for it in res["iterations"])
    ref_cost, _ = _loopback_run(dataset, 3, 30)
    assert res["cost"] < 10 * ref_cost


def test_mixed_jax_and_port_robots_share_one_bus(dataset, tmp_path):
    """A JAX robot (robot 0, the JAX package's example on the CPU in
    float64) and a port robot (robot 1, ``--device cpu``) on one bus bound
    here; the survivors' cost equals a port-only run's at rtol 1e-9."""
    rounds = 20
    port_only = _launch(dataset, tmp_path / "port", "--robots", "2",
                        "--rounds", str(rounds))
    out_dir = tmp_path / "mixed"
    out_dir.mkdir()
    srv = comms.listen_tcp(port=0)
    port = srv.getsockname()[1]
    common = ["--robots", "2", "--port", str(port), "--rank", "5",
              "--rounds", str(rounds), "--out-dir", str(out_dir)]
    procs = [
        subprocess.Popen([sys.executable, JAX_EXAMPLE, dataset,
                          "--robot", "0", *common], cwd=REPO,
                         env=_env(DPGO_PLATFORM="cpu",
                                  JAX_PLATFORMS="cpu"),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        subprocess.Popen([sys.executable, "-m", MODULE, dataset,
                          "--robot", "1", "--device", "cpu", *common],
                         cwd=REPO, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE),
    ]
    try:
        channels = comms.bus.accept_robots(
            srv, 2, policy=comms.RetryPolicy(send_timeout_s=120.0,
                                             recv_timeout_s=120.0))
        bus = comms.RoundBus(channels, round_timeout_s=120.0, miss_limit=3,
                             liveness_timeout_s=60.0)

        def serve():
            bus.round()
            bus.serve(rounds)
            bus.round()
            bus.close()

        relay = threading.Thread(target=serve, daemon=True)
        relay.start()
        errs = [p.communicate(timeout=240)[1] for p in procs]
        relay.join(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        srv.close()
    assert [p.returncode for p in procs] == [0, 0], \
        [e[-2000:] for e in errs]
    outs = {r: dict(np.load(os.path.join(out_dir, f"robot{r}.npz")))
            for r in range(2)}
    assert [int(outs[r]["iterations"]) for r in range(2)] == [rounds] * 2
    assert "b2_launches" not in outs[0] and "b2_launches" in outs[1]
    cost = tcp.survivor_cost(dataset, 2, outs)
    assert cost == pytest.approx(port_only["cost"], rel=RTOL)
    torch.testing.assert_close(
        torch.from_numpy(outs[1]["T"]),
        torch.from_numpy(np.load(os.path.join(tmp_path / "port",
                                              "robot1.npz"))["T"]),
        rtol=RTOL, atol=1e-12)
