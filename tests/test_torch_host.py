"""Host-side parity of the PyTorch port (``dpgo_tpu_torch``) with the JAX
package: synthetic data, partitioning, the topology planner, the per-agent
graph arrays (bitwise), lifting and rounding, g2o I/O — plus the port's
import isolation and its refusal to fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.models import local_pgo as jlocal
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils import g2o as jg2o
from dpgo_tpu.utils import graph_plan as jplan
from dpgo_tpu.utils import lie as jlie
from dpgo_tpu.utils import partition as jpart
from dpgo_tpu.utils import synthetic as jsyn
from dpgo_tpu_torch import interop, types
from dpgo_tpu_torch.models import local_pgo, rbcd
from dpgo_tpu_torch.utils import g2o, graph_plan, lie, partition, synthetic

REPO = Path(__file__).resolve().parents[1]


def _pair(d, seed=0, n=30, num_lc=9, **kw):
    a = jsyn.make_measurements(np.random.default_rng(seed), n=n, d=d,
                               num_lc=num_lc, **kw)
    b = synthetic.make_measurements(np.random.default_rng(seed), n=n, d=d,
                                    num_lc=num_lc, **kw)
    return a, b


def _assert_meas_equal(a, b):
    assert (a.d, a.num_poses) == (b.d, b.num_poses)
    for f in ("r1", "p1", "r2", "p2", "R", "t", "kappa", "tau", "weight",
              "is_known_inlier"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("d", [2, 3])
def test_make_measurements_bitwise(d):
    (ma, (Ra, ta)), (mb, (Rb, tb)) = _pair(
        d, rot_noise=0.05, trans_noise=0.05, outlier_lc=2)
    _assert_meas_equal(ma, mb)
    assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


def test_partition_and_plan_bitwise():
    (ma, _), (mb, _) = _pair(3, n=37)
    pa = jpart.partition_contiguous(ma, 4)
    pb = partition.partition_contiguous(mb, 4)
    assert np.array_equal(pa.n, pb.n)
    assert np.array_equal(pa.global_index, pb.global_index)
    _assert_meas_equal(pa.meas, pb.meas)
    assert np.array_equal(pa.classify(), pb.classify())
    m = pb.meas
    qa = jplan.plan_topology(m.r1, m.p1, m.r2, m.p2, 4, pb.n_max,
                             backend="python")
    qb = graph_plan.plan_python(m.r1, m.p1, m.r2, m.p2, 4, pb.n_max)
    for f in qb._fields:
        x, y = np.asarray(getattr(qa, f)), np.asarray(getattr(qb, f))
        assert np.array_equal(x, y), f
    ca = jplan.color_agents(qa.nbr_robot, qa.nbr_mask, 4)
    cb = graph_plan.color_agents(qb.nbr_robot, qb.nbr_mask, 4)
    assert np.array_equal(ca[0], cb[0]) and ca[1] == cb[1]


@pytest.mark.parametrize("d,rank,A", [(3, 5, 4), (2, 3, 3)])
def test_build_graph_bitwise(d, rank, A):
    (ma, _), (mb, _) = _pair(d, n=33, num_lc=11)
    ga, meta_a = jrbcd.build_graph(jpart.partition_contiguous(ma, A), rank,
                                   jnp.float64, pallas_sel=True,
                                   planner="python")
    gb, meta_b = rbcd.build_graph(partition.partition_contiguous(mb, A),
                                  rank, torch.float64, device="cpu")
    assert meta_a.__dict__ == meta_b.__dict__
    for f in gb._fields:
        if f == "dense_inc":
            continue  # the port's own (tests/test_torch_dense_q.py)
        if f == "edges":
            for k in gb.edges._fields:
                x = np.asarray(getattr(ga.edges, k))
                assert np.array_equal(x, getattr(gb.edges, k).numpy()), k
            continue
        x, y = np.asarray(getattr(ga, f)), getattr(gb, f).numpy()
        assert x.shape == y.shape and np.array_equal(x, y), f


@pytest.mark.parametrize("r,d", [(5, 3), (3, 2), (4, 3), (3, 3)])
def test_lifting_lift_and_round(r, d):
    Y = lie.lifting_matrix(r, d, device="cpu")
    np.testing.assert_allclose(
        Y.numpy(), np.asarray(jlie.lifting_matrix(r, d, jnp.float64)),
        rtol=0, atol=1e-12)
    (ma, _), _ = _pair(d, n=12, num_lc=3)
    rng = np.random.default_rng(1)
    T = np.concatenate([ma.R[:12], rng.standard_normal((12, d, 1))], -1)
    Yj = jnp.asarray(Y.numpy())
    X = local_pgo.lift(torch.as_tensor(T), Y)
    np.testing.assert_allclose(X.numpy(), jlocal.lift(jnp.asarray(T), Yj),
                               atol=1e-12)
    Xn = X + 0.01 * torch.as_tensor(rng.standard_normal(X.shape))
    np.testing.assert_allclose(
        local_pgo.round_solution(Xn, Y).numpy(),
        jlocal.round_solution(jnp.asarray(Xn.numpy()), Yj), atol=1e-12)


@pytest.mark.parametrize("d", [2, 3])
def test_g2o_round_trip_matches_jax_reader(tmp_path, d):
    _, (mb, _) = _pair(d, n=15, num_lc=4, rot_noise=0.1, trans_noise=0.1)
    path = str(tmp_path / "g.g2o")
    g2o.write_g2o(mb, path)
    _assert_meas_equal(jg2o.read_g2o(path, backend="python"),
                       g2o.read_g2o(path, backend="python"))
    # The default dispatch reads through the native loader, as the JAX
    # package's does; native against Python is in test_torch_native.py.
    native = g2o.read_g2o(path)
    python = g2o.read_g2o_python(path)
    for f in ("r1", "p1", "r2", "p2", "R", "t", "kappa"):
        assert np.array_equal(getattr(native, f), getattr(python, f)), f


def test_port_imports_no_jax():
    """The port and chip_smoke.py must not pull in JAX or the JAX package
    (checked in a fresh interpreter: this one has imported both)."""
    code = ("import sys; import dpgo_tpu_torch, chip_smoke; "
            "import dpgo_tpu_torch.interop, dpgo_tpu_torch.models.rbcd, "
            "dpgo_tpu_torch.models.refine, dpgo_tpu_torch.robust, "
            "dpgo_tpu_torch.experiments.measure_r3, dpgo_tpu_torch.obs, "
            "dpgo_tpu_torch.obs.health, dpgo_tpu_torch.ops.chordal, "
            "dpgo_tpu_torch.utils.partition, dpgo_tpu_torch.utils.synthetic, "
            "dpgo_tpu_torch.models.certify, dpgo_tpu_torch.models.local_pgo, "
            "dpgo_tpu_torch.ops.lobpcg, "
            "dpgo_tpu_torch.experiments.cert_witness, "
            "dpgo_tpu_torch.ops.averaging, dpgo_tpu_torch.ops.df32, "
            "dpgo_tpu_torch.models.dist_init, "
            "dpgo_tpu_torch.models.refine_fused, dpgo_tpu_torch.agent, "
            "dpgo_tpu_torch.comms, dpgo_tpu_torch.obs.run, "
            "dpgo_tpu_torch.obs.trace, dpgo_tpu_torch.utils.native_io, "
            "dpgo_tpu_torch.utils.logger, dpgo_tpu_torch.utils.graph_plan, "
            "dpgo_tpu_torch.utils.profiling, dpgo_tpu_torch.obs.profile, "
            "dpgo_tpu_torch.obs.devprof, dpgo_tpu_torch.obs.recorder, "
            "dpgo_tpu_torch.obs.timeline, dpgo_tpu_torch.obs.ledger, "
            "dpgo_tpu_torch.obs.regress, dpgo_tpu_torch.obs.report, "
            "dpgo_tpu_torch.examples.tcp_deployment_example, "
            "dpgo_tpu_torch.models.incremental, dpgo_tpu_torch.serve, "
            "dpgo_tpu_torch.serve.frontend, dpgo_tpu_torch.serve.statusz, "
            "dpgo_tpu_torch.serve.__main__, dpgo_tpu_torch.parallel, "
            "dpgo_tpu_torch.parallel.sharded, "
            "dpgo_tpu_torch.parallel.resilience, "
            "dpgo_tpu_torch.parallel.certify, "
            "dpgo_tpu_torch.parallel.multihost, "
            "dpgo_tpu_torch.parallel.world, dpgo_tpu_torch.obs.fleetobs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dpgo_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_solve_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _, (mb, _) = _pair(3, n=12, num_lc=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rbcd.solve_rbcd(mb, 2, max_iters=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rbcd.prepare_problem(mb, 2)
    res = rbcd.solve_rbcd(mb, 2, max_iters=2, device="cpu")
    assert res.X.device.type == "cpu" and res.X.dtype == torch.float64


@pytest.mark.parametrize("entry", [
    "build_graph", "lifting_matrix", "rbcd.lifting_matrix",
    "edge_set_from_measurements", "graph_from_numpy", "state_from_numpy"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _, (mb, _) = _pair(3, n=12, num_lc=3)
    part = partition.partition_contiguous(mb, 2)
    meta = rbcd.GraphMeta(num_robots=2, n_max=6, e_max=8, s_max=2, p_max=2,
                          d=3, rank=5)
    call = {
        "build_graph": lambda: rbcd.build_graph(part, 5),
        "lifting_matrix": lambda: lie.lifting_matrix(5, 3),
        "rbcd.lifting_matrix": lambda: rbcd.lifting_matrix(meta),
        "edge_set_from_measurements":
            lambda: types.edge_set_from_measurements(mb),
        "graph_from_numpy": lambda: interop.graph_from_numpy({}),
        "state_from_numpy": lambda: interop.state_from_numpy({}),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
