"""The port's sharded plane (``dpgo_tpu_torch.parallel.sharded``) on the
CPU in float64 over gloo worlds of 1, 2 and 4 ranks (spawned by
``parallel.world.spawn_world``), against the JAX package's
``dpgo_tpu.parallel`` on the virtual 8-device CPU mesh.

Tolerances: the port's histories are the same bit for bit at every world
size (every cross-rank reduction of the solve is exact: owner scatters
with disjoint supports, weights with identical copies, replicated
metrics), so each schedule is compared with JAX at rtol 1e-9 at one mesh
size and the port's world sizes with ``==``; JACOBI is compared with JAX
at all three sizes.  Within the port, all-gather equals ppermute, overlap
True equals False and the verdict loop equals the per-eval loop bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.parallel import sharded as jsharded
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.parallel import sharded
from dpgo_tpu_torch.parallel.world import spawn_world
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

A = 8
ROUNDS, EVAL, K = 12, 2, 4
JOB = "dpgo_tpu_torch.parallel.world:solve_job"

#: schedule case -> (AgentParams keywords, outlier loop closures, JAX mesh
#: size it is compared at).
CASES = {
    "jacobi": (dict(schedule="JACOBI"), 0, (1, 2, 4)),
    "greedy": (dict(schedule="GREEDY"), 0, (2,)),
    "async": (dict(schedule="ASYNC", async_update_prob=0.5), 0, (4,)),
    "colored": (dict(schedule="COLORED"), 0, (1,)),
    "nesterov": (dict(schedule="JACOBI", acceleration=True,
                      restart_interval=5), 0, (2,)),
    "gnc": (dict(schedule="JACOBI", robust_opt_inner_iters=4,
                 robust="GNC_TLS"), 3, (4,)),
}


def _meas(pkg, outliers=0, seed=3):
    make = tmake if pkg == "torch" else jmake
    return make(np.random.default_rng(seed), n=48, d=3, num_lc=14,
                rot_noise=0.01, trans_noise=0.01, outlier_lc=outliers)[0]


def _params(mod, kw):
    kw = dict(kw)
    kw["schedule"] = mod.Schedule[kw["schedule"]]
    if kw.pop("robust", None):
        kw["robust"] = mod.RobustCostParams(
            cost_type=mod.RobustCostType.GNC_TLS)
    return mod.AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0,
                           **kw)


def _async_draws(rounds=ROUNDS, p=0.5):
    """The JAX package's ASYNC clocks (its init_state key chain, seed 0)."""
    key = jax.random.split(jax.random.PRNGKey(0), A)
    out = []
    for _ in range(rounds + K):
        split = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        key, sub = split[:, 0], split[:, 1]
        out.append(np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p))(sub)))
    return np.stack(out)


_JAX = {}


def _jax_solve(case, n_dev, **kw):
    key = (case, n_dev, tuple(sorted(kw.items())))
    if key not in _JAX:
        pkw, outliers, _ = CASES[case]
        _JAX[key] = jsharded.solve_rbcd_sharded(
            _meas("jax", outliers), A, mesh=jmake_mesh(n_dev),
            params=_params(jconfig, pkw), max_iters=ROUNDS,
            eval_every=EVAL, grad_norm_tol=1e-12, verdict_every=K, **kw)
    return _JAX[key]


def _port_jobs():
    jobs = []
    for case, (pkw, outliers, _) in CASES.items():
        kw = dict(meas=_meas("torch", outliers), num_robots=A,
                  params=_params(tconfig, pkw), max_iters=ROUNDS,
                  eval_every=EVAL, grad_norm_tol=1e-12, verdict_every=K)
        if case == "async":
            kw["async_draws"] = _async_draws()
        jobs.append((JOB, kw))
    base = jobs[0][1]
    # Within-port variants of the JACOBI case: the point-to-point
    # exchange, the unpipelined halo, the per-eval loop, a multi-slice
    # mesh and the fetch count.
    jobs += [(JOB, dict(base, exchange="ppermute")),
             (JOB, dict(base, overlap=False)),
             (JOB, dict(base, verdict_every=None)),
             (JOB, dict(base, count_fetches=True))]
    return jobs


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case and variant, run once per world size (one spawn each)."""
    work = tmp_path_factory.mktemp("worlds")
    jobs = _port_jobs()
    out = {}
    for ws in (1, 2, 4):
        res = spawn_world(ws, "dpgo_tpu_torch.parallel.world:multi_job",
                          kwargs=dict(jobs=jobs), workdir=work,
                          timeout_s=60)
        for r in res[1:]:  # every rank returns the same result
            for a, b in zip(r, res[0]):
                assert a["cost_history"] == b["cost_history"]
                assert np.array_equal(a["X"], b["X"])
        out[ws] = dict(zip(list(CASES) + ["ppermute", "lockstep",
                                          "per_eval", "fetches"], res[0]))
    return out


def _same(a, b):
    assert a["cost_history"] == b["cost_history"]
    assert a["grad_norm_history"] == b["grad_norm_history"]
    assert (a["iterations"], a["terminated_by"]) == \
        (b["iterations"], b["terminated_by"])
    assert np.array_equal(a["T"], b["T"])
    assert np.array_equal(a["X"], b["X"])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_solve_matches_jax_over_worlds(port_runs, case):
    """Every schedule, Nesterov and GNC through the verdict loop: the same
    histories, iterations, reason and T at 1, 2 and 4 ranks, and JAX's at
    rtol 1e-9."""
    for ws in (2, 4):
        _same(port_runs[ws][case], port_runs[1][case])
    for n_dev in CASES[case][2]:
        ref = _jax_solve(case, n_dev)
        got = port_runs[n_dev][case]
        np.testing.assert_allclose(got["cost_history"], ref.cost_history,
                                   rtol=1e-9)
        np.testing.assert_allclose(got["grad_norm_history"],
                                   ref.grad_norm_history, rtol=1e-9)
        assert got["iterations"] == ref.iterations
        assert got["terminated_by"] == ref.terminated_by
        np.testing.assert_allclose(got["T"], np.asarray(ref.T), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got["X"], np.asarray(ref.X), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_sharded_exchange_overlap_and_loops_are_bitwise(port_runs, ws):
    """Within the port: ppermute == all_gather, overlap False == True,
    and the verdict loop's histories == the per-eval loop's."""
    runs = port_runs[ws]
    _same(runs["ppermute"], runs["jacobi"])
    _same(runs["lockstep"], runs["jacobi"])
    pe, vd = runs["per_eval"], runs["jacobi"]
    assert pe["cost_history"] == vd["cost_history"]
    assert pe["grad_norm_history"] == vd["grad_norm_history"]
    assert pe["iterations"] == vd["iterations"]


def test_sharded_verdict_host_syncs_are_100_over_k(port_runs):
    """One word read per K rounds plus the terminal epilogue fetch."""
    for ws in (1, 2, 4):
        assert port_runs[ws]["fetches"]["fetches"] == ROUNDS // K + 1


def test_world_one_in_process_equals_solve_rbcd():
    """At world size 1 the sharded solve IS the single-device solve: the
    per-eval and verdict loops, every exchange and overlap mode, bit for
    bit (the same B2 operands on a card; here the kernel's plain
    version)."""
    meas = _meas("torch")
    p = _params(tconfig, dict(schedule="GREEDY"))
    for kw in (dict(), dict(verdict_every=K)):
        ref = rbcd.solve_rbcd(meas, A, p, max_iters=ROUNDS, eval_every=EVAL,
                              grad_norm_tol=1e-12, device="cpu", **kw)
        for extra in (dict(), dict(exchange="ppermute"),
                      dict(overlap=False), dict(overlap="auto")):
            got = sharded.solve_rbcd_sharded(
                meas, A, params=p, max_iters=ROUNDS, eval_every=EVAL,
                grad_norm_tol=1e-12, device="cpu", **kw, **extra)
            assert got.cost_history == ref.cost_history
            assert got.grad_norm_history == ref.grad_norm_history
            assert got.iterations == ref.iterations
            assert torch.equal(got.T, ref.T)
            assert torch.equal(got.X, ref.X)


def test_comm_bytes_model_matches_jax():
    meas = _meas("torch")
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, "cpu")
    jpart = jpartition(_meas("jax"), A)
    jgraph, jmeta = jrbcd.build_graph(jpart, 5)
    for n_dev in (1, 2, 4, 8):
        shifts, _ = rbcd.plan_ppermute(graph, A, n_dev)
        jshifts, _ = jrbcd.plan_ppermute(jgraph, A, n_dev)
        assert shifts == jshifts
        for kw in (dict(), dict(shifts=shifts), dict(accel=True),
                   dict(greedy=True, itemsize=8)):
            assert sharded.comm_bytes_per_round(meta, n_dev, **kw) == \
                jsharded.comm_bytes_per_round(jmeta, n_dev, **kw)
    with pytest.raises(ValueError, match="multiple"):
        sharded.comm_bytes_per_round(meta, 3)


def test_ppermute_plan_matches_jax():
    meas = _meas("torch")
    graph, _ = rbcd.build_graph(partition_contiguous(meas, A), 5,
                                torch.float64, "cpu")
    jgraph, _ = jrbcd.build_graph(jpartition(_meas("jax"), A), 5)
    for n_dev in (2, 4, 8):
        shifts, plan = rbcd.plan_ppermute(graph, A, n_dev)
        jshifts, jplan = jrbcd.plan_ppermute(jgraph, A, n_dev)
        assert shifts == jshifts and len(shifts) >= 1
        assert np.array_equal(plan.src.numpy(), np.asarray(jplan.src))
        assert np.array_equal(plan.lrobot.numpy(), np.asarray(jplan.lrobot))
    with pytest.raises(ValueError, match="multiple"):
        rbcd.plan_ppermute(graph, A, 3)


def test_port_mesh_divisibility_and_refusals():
    meas = _meas("torch")
    mesh = sharded.make_mesh(device="cpu")
    assert mesh.devices.size == 1 and mesh.axis_names == ("agent",)
    with pytest.raises(ValueError, match="available"):
        sharded.make_mesh(2, device="cpu")
    p = tconfig.AgentParams(d=3, r=5, num_robots=A)
    with pytest.raises(ValueError, match="overlap"):
        sharded.solve_rbcd_sharded(meas, A, params=p, max_iters=2,
                                   overlap="sometimes", device="cpu")
    with pytest.raises(ValueError, match="verdict_every"):
        sharded.solve_rbcd_sharded(meas, A, params=p, max_iters=2,
                                   boundary_cb=lambda *a: None,
                                   device="cpu")
    ms = sharded.make_multislice_mesh(1, device="cpu")
    assert ms.axis_names == ("dcn", "ici")
    with pytest.raises(ValueError, match="1-D mesh"):
        sharded.solve_rbcd_sharded(meas, A, mesh=ms, params=p,
                                   max_iters=2, exchange="ppermute")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded.solve_rbcd_sharded(meas, A, params=p, max_iters=2)


def test_sharded_solve_telemetry_and_overlap_auto(tmp_path):
    """The ``sharded_solve`` event, the comm gauge, the fingerprint and the
    auto gate's ``single_device_mesh`` decision (world 1)."""
    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.obs.events import read_events

    meas = _meas("torch")
    p = _params(tconfig, dict(schedule="JACOBI"))
    obs.end_run()
    with obs.run_scope(str(tmp_path / "run")) as run:
        res = sharded.solve_rbcd_sharded(meas, A, params=p, max_iters=8,
                                         verdict_every=K, overlap="auto",
                                         device="cpu")
        fp = dict(run.fingerprint)
    evs = read_events(str(tmp_path / "run" / "events.jsonl"))
    (sh,) = [e for e in evs if e["event"] == "sharded_solve"]
    assert sh["mesh_size"] == 1 and sh["num_robots"] == A
    assert sh["comm_bytes_per_round"] == 0 and sh["overlap"] is False
    (dec,) = [e for e in evs if e["event"] == "overlap_decision"]
    assert dec["reason"] == "single_device_mesh" and dec["overlap"] is False
    assert fp["mesh_size"] == 1 and fp["exchange"] == "all_gather"
    assert res.iterations == 8


def test_time_arm_times_a_call():
    from dpgo_tpu_torch.obs import devprof

    dt = devprof.time_arm(lambda x: (x * 2, {"y": x}), torch.ones(3))
    assert 0.0 <= dt < 5.0


def test_eight_ranks_one_agent_each_match_jax(port_runs, tmp_path):
    """One agent per rank (8 gloo ranks) against JAX's 8-device mesh; the
    same bits as the smaller worlds."""
    pkw, outliers, _ = CASES["jacobi"]
    out = spawn_world(8, JOB, kwargs=dict(
        meas=_meas("torch", outliers), num_robots=A,
        params=_params(tconfig, pkw), max_iters=ROUNDS, eval_every=EVAL,
        grad_norm_tol=1e-12, verdict_every=K), workdir=tmp_path,
        timeout_s=60)
    for r in out:
        _same(r, port_runs[1]["jacobi"])
    ref = _jax_solve("jacobi", 8)
    np.testing.assert_allclose(out[0]["cost_history"], ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(out[0]["grad_norm_history"],
                               ref.grad_norm_history, rtol=1e-9)
    assert out[0]["iterations"] == ref.iterations


def test_overlap_auto_on_four_ranks_records_evidence(port_runs, tmp_path):
    """The adaptive gate on a 4-rank gloo world: every rank takes rank
    0's decision (an ``overlap_decision`` event with the A/B walls, the
    evidence windows' attribution), and the solve is bit for bit the
    forced mode's."""
    from dpgo_tpu_torch.obs.events import read_events

    pkw, outliers, _ = CASES["jacobi"]
    out = spawn_world(4, JOB, kwargs=dict(
        meas=_meas("torch", outliers), num_robots=A,
        params=_params(tconfig, pkw), max_iters=ROUNDS, eval_every=EVAL,
        grad_norm_tol=1e-12, verdict_every=K, overlap="auto",
        telemetry_dir=str(tmp_path / "tel")), workdir=tmp_path,
        timeout_s=60)
    decisions = []
    for r in range(4):
        evs = read_events(str(tmp_path / "tel" / f"rank{r}" /
                              "events.jsonl"))
        (dec,) = [e for e in evs if e.get("event") == "overlap_decision"]
        decisions.append(dec)
        (setup,) = [e for e in evs if e.get("event") == "sharded_solve"]
        assert setup["overlap"] is dec["overlap"]
    dec = decisions[0]
    assert dec["mesh_size"] == 4
    assert dec["threshold"] == pytest.approx(sharded._AUTO_THRESHOLD)
    for key in ("efficiency", "lockstep_seconds", "overlapped_seconds",
                "lockstep_rounds_per_s", "overlapped_rounds_per_s",
                "calib_rounds"):
        assert key in dec, key
    assert all(d["overlap"] == dec["overlap"]
               and d["efficiency"] == dec["efficiency"] for d in decisions)
    for r in out:
        _same(r, port_runs[4]["jacobi"])
