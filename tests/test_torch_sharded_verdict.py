"""The sharded verdict loop of the port (``parallel.sharded``:
``make_sharded_metrics_body`` behind ``run_rbcd``'s ``metrics_body_factory``
seam, the all-reduced global assembly of the terminal epilogue) on the CPU
in float64: the metric rows bit for bit against the single-device body, the
sharded verdict solve bit for bit against ``rbcd.solve_rbcd`` at world 1,
against the JAX package's sharded verdict solve on a 2-rank gloo world at
rtol 1e-9 (a termination latched mid-window, and GNC), and its telemetry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.parallel import sharded as jsharded
from dpgo_tpu.types import edge_set_from_measurements as jedges
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.parallel import sharded
from dpgo_tpu_torch.parallel.world import spawn_world
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

A = 8
JOB = "dpgo_tpu_torch.parallel.world:solve_job"


@pytest.fixture(autouse=True)
def _no_ambient_run():
    obs.end_run()
    yield
    obs.end_run()


def _noisy(pkg, seed=42, outliers=0):
    make = tmake if pkg == "torch" else jmake
    return make(np.random.default_rng(seed), n=48, d=3, num_lc=16,
                rot_noise=0.05, trans_noise=0.05, outlier_lc=outliers)[0]


def _params(mod, robust=False):
    kw = {}
    if robust:
        kw = dict(robust=mod.RobustCostParams(
            cost_type=mod.RobustCostType.GNC_TLS), robust_opt_inner_iters=4)
    return mod.AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0, **kw)


#: case -> (solve keywords, robust, outliers): a termination latched
#: mid-window, and GNC weight updates through the verdict program.
CASES = {"latched": (dict(max_iters=40, grad_norm_tol=0.1, eval_every=4,
                          verdict_every=8), False, 0),
         "gnc": (dict(max_iters=24, grad_norm_tol=1e-9, eval_every=2,
                      verdict_every=4), True, 3)}


def test_sharded_divisibility_validated_up_front(monkeypatch):
    """The mesh-divisibility error fires before any graph build, naming
    both values and the fix."""
    calls = []
    orig = rbcd.build_graph
    monkeypatch.setattr(rbcd, "build_graph",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    mesh = sharded.make_mesh(device="cpu")
    mesh4 = sharded.Mesh(mesh.group, range(4), mesh.device)
    with pytest.raises(ValueError) as ei:
        sharded.solve_rbcd_sharded(_noisy("torch"), 6, mesh=mesh4,
                                   params=tconfig.AgentParams(
                                       d=3, r=5, num_robots=6),
                                   max_iters=4)
    msg = str(ei.value)
    assert "num_robots=6" in msg and "4" in msg and "make_mesh" in msg
    assert not calls


def test_sharded_metrics_body_bitwise_vs_central():
    """The sharded metric row equals ``rbcd._central_metrics_body``'s bit
    for bit (world 1; the all-reduces add to zeros), with and without the
    telemetry extras, and JAX's sharded row at rtol 1e-12."""
    meas = _noisy("torch")
    params = _params(tconfig)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    state = rbcd.rbcd_steps(rbcd.init_state(graph, meta, X0, params=params),
                            graph, 2, meta, params)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float64, device="cpu")
    mesh = sharded.make_mesh(device="cpu")
    s_state, s_graph = sharded.shard_problem(mesh, state, graph)
    n_total, num_meas = meas.num_poses, len(part.meas_global)

    jmeas = _noisy("jax")
    jpart = jpartition(jmeas, A)
    jgraph, jmeta = jrbcd.build_graph(jpart, 5, jnp.float64)
    jX0 = jrbcd.centralized_chordal_init(jpart, jmeta, jgraph, jnp.float64)
    jp = _params(jconfig)
    jstate = jrbcd.rbcd_steps(jrbcd.init_state(jgraph, jmeta, jX0,
                                               params=jp),
                              jgraph, 2, jmeta, jp)
    jmesh = jmake_mesh(1)
    js_state, js_graph = jsharded.shard_problem(jmesh, jstate, jgraph)
    jedges_g = jedges(jpart.meas_global, dtype=jnp.float64)
    for telemetry in (False, True):
        args = (state.X, state.weights, state.ready, state.mu,
                state.rel_change)
        vc = rbcd._central_metrics_body(graph, edges_g, n_total, num_meas,
                                        telemetry)(*args)
        vs = sharded.make_sharded_metrics_body(
            mesh, s_graph, edges_g, n_total, num_meas, telemetry)(*args)
        assert torch.equal(vs, vc)
        vj = jax.jit(jsharded.make_sharded_metrics_body(
            jmesh, js_graph, jedges_g, n_total, num_meas, telemetry))(
            js_state.X, js_state.weights, js_state.ready, js_state.mu,
            js_state.rel_change)
        np.testing.assert_allclose(vs.numpy(), np.asarray(vj), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_verdict_equals_single_device_verdict(case):
    kw, robust, outliers = CASES[case]
    meas = _noisy("torch", outliers=outliers)
    p = _params(tconfig, robust)
    ref = rbcd.solve_rbcd(meas, A, p, device="cpu", **kw)
    got = sharded.solve_rbcd_sharded(meas, A, params=p, device="cpu", **kw)
    assert got.cost_history == ref.cost_history
    assert got.grad_norm_history == ref.grad_norm_history
    assert (got.iterations, got.terminated_by) == \
        (ref.iterations, ref.terminated_by)
    assert torch.equal(got.T, ref.T) and torch.equal(got.weights,
                                                     ref.weights)
    if case == "latched":
        assert got.terminated_by == "grad_norm" and got.iterations < 40


def test_sharded_verdict_on_two_ranks_matches_jax(tmp_path):
    jobs = []
    for case, (kw, robust, outliers) in CASES.items():
        jobs.append((JOB, dict(kw, meas=_noisy("torch", outliers=outliers),
                               num_robots=A, params=_params(tconfig, robust),
                               count_fetches=True)))
    out = spawn_world(2, "dpgo_tpu_torch.parallel.world:multi_job",
                      kwargs=dict(jobs=jobs), workdir=tmp_path,
                      timeout_s=60)[0]
    for (case, (kw, robust, outliers)), got in zip(CASES.items(), out):
        ref = jsharded.solve_rbcd_sharded(
            _noisy("jax", outliers=outliers), A, mesh=jmake_mesh(2),
            params=_params(jconfig, robust), **kw)
        assert (got["iterations"], got["terminated_by"]) == \
            (ref.iterations, ref.terminated_by)
        np.testing.assert_allclose(got["cost_history"], ref.cost_history,
                                   rtol=1e-9)
        np.testing.assert_allclose(got["grad_norm_history"],
                                   ref.grad_norm_history, rtol=1e-9)
        np.testing.assert_allclose(got["T"], np.asarray(ref.T), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got["weights"], np.asarray(ref.weights),
                                   rtol=1e-9, atol=1e-12)
        # One word per K rounds up to the window holding the latched eval,
        # and the terminal epilogue.
        assert got["fetches"] == -(-got["iterations"]
                                   // kw["verdict_every"]) + 1


def test_sharded_verdict_telemetry(tmp_path):
    """Telemetry on: ``sharded_solve`` carries the overlap/verdict
    fields, ``solve_end`` the verdict, and the sync rate is one word and
    one lazy history fetch per boundary (2 x 100/K)."""
    from dpgo_tpu_torch.obs.events import read_events
    from dpgo_tpu_torch.obs.report import render_report

    run_dir = str(tmp_path / "run")
    with obs.run_scope(run_dir):
        sharded.solve_rbcd_sharded(_noisy("torch"), A,
                                   params=_params(tconfig), max_iters=24,
                                   grad_norm_tol=0.0, eval_every=4,
                                   verdict_every=8, device="cpu")
    events = read_events(f"{run_dir}/events.jsonl")
    (setup,) = [e for e in events if e.get("event") == "sharded_solve"]
    assert setup["mesh_size"] == 1 and setup["overlap"] is True
    assert setup["verdict_every"] == 8
    (end,) = [e for e in events if e.get("event") == "solve_end"]
    assert end["verdict_every"] == 8
    syncs = [e for e in events if e.get("event") == "metric"
             and e.get("metric") == "host_syncs_per_100_rounds"]
    assert syncs and syncs[0]["value"] == pytest.approx(2 * 100.0 / 8)
    evals = [e for e in events if e.get("event") == "metric"
             and e.get("metric") == "solver_cost"]
    assert len(evals) == 24 // 4
    txt = render_report(run_dir)
    assert "sharded:" in txt and "verdict sync" in txt
