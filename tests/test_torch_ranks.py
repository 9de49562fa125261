"""The port at the ranks the staircase climbs to with the JAX package's
defaults (r_max = 10): every kernel is instantiated for d = 3 with
3 <= r <= 10 and d = 2 with 2 <= r <= 10 (``csrc/shapes.cuh``).

* the route plan (``rtr_kernel.cluster_plan``) at r = 10: the cluster
  route at the sphere2500 stand-in's and the SE(2) stand-in's per-agent
  shapes, the spread route over C = 4 CTAs at BASELINE.md config #5's;
* ``rbcd.solve_rbcd`` at r = 7, d = 3 and at r = 4, d = 2 against the JAX
  package's, float64 on the CPU, at rtol 1e-9;
* ``parallel.certify.solve_staircase_sharded`` started above the first
  rank (r_min = 6 at d = 3, r_min = 4 at d = 2) against the JAX package's:
  the same ranks and certified flags, the per-rank costs at rtol 1e-9.

The kernels run only on the card (``test_torch_cuda.py``); here the
wrappers take their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.parallel import certify as jdcert
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.parallel import certify as dcert
from dpgo_tpu_torch.parallel import make_mesh
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

#: The staircase's default top rank.
R_TOP = 10


def _agent_shape(n, d, num_lc, robots):
    """(n_max, e_max, Kinc) of a synthetic problem's contiguous agents."""
    meas = tmake(np.random.default_rng(0), n=n, d=d, num_lc=num_lc,
                 rot_noise=0.01, trans_noise=0.01)[0]
    graph, meta = rbcd.build_graph(partition_contiguous(meas, robots), 3,
                                   torch.float32, device="cpu")
    return meta.n_max, meta.e_max, graph.inc_slot.shape[-1]


# The sphere2500 stand-in (bench.py: 2500 poses over 8 robots) and the
# SE(2) stand-in at city10000's size (10,000 poses over 32 robots): at r =
# 10 a CTA holds 48 poses (512 threads, 3 poses a warp), so their ~320-pose
# agents take 8-CTA clusters for every kernel.
@pytest.mark.parametrize("kernel", list(rk.KERNELS))
@pytest.mark.parametrize("n,d,num_lc,robots", [(2500, 3, 2449, 8),
                                               (10000, 2, 10688, 32)])
def test_stand_ins_take_clusters_at_the_top_rank(kernel, n, d, num_lc,
                                                 robots):
    n_max, e_max, kinc = _agent_shape(n, d, num_lc, robots)
    plan = rk.cluster_plan(n_max, e_max, kinc, R_TOP, d, kernel,
                           agents=robots)
    assert (plan.route, plan.C) == ("cluster", 8)
    assert plan.threads <= rk.MAX_CLUSTER_THREADS
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    assert plan.C * plan.P >= n_max


@pytest.mark.parametrize("kernel", rk.SPREAD_KERNELS)
def test_config5_spreads_over_four_ctas_at_the_top_rank(kernel):
    # BASELINE.md config #5 (n_max 1594, e_max 2236, Kinc 7, 64 agents):
    # three shared vectors of 44 floats a pose hold at most ~440 poses a
    # CTA, so 132 // 64 = 2 CTAs per agent are raised to 4: 256 CTAs.
    plan = rk.cluster_plan(1594, 2236, 7, R_TOP, 3, kernel, agents=64,
                           sms=rk.H100_SMS)
    assert (plan.route, plan.C, plan.P) == ("spread", 4, 399)
    assert plan == rk.spread_shape(R_TOP, 3, 1594, 4)
    assert rk.spread_shape(R_TOP, 3, 1594, 3).smem_bytes > rk.MAX_SMEM_BYTES
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES


@pytest.mark.parametrize("d,r", [(3, 7), (2, 4)])
def test_solve_rbcd_at_a_staircase_rank_matches_jax(d, r):
    kw = dict(n=36, d=d, num_lc=12, rot_noise=0.05, trans_noise=0.05)
    ref = jrbcd.solve_rbcd(jmake(np.random.default_rng(1), **kw)[0], 3,
                           JAgentParams(d=d, r=r, num_robots=3),
                           max_iters=20, grad_norm_tol=0.1)
    res = rbcd.solve_rbcd(tmake(np.random.default_rng(1), **kw)[0], 3,
                          AgentParams(d=d, r=r, num_robots=3), max_iters=20,
                          grad_norm_tol=0.1, device="cpu",
                          dtype=torch.float64)
    assert res.iterations == ref.iterations > 1
    assert res.terminated_by == ref.terminated_by
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-8)


@pytest.mark.parametrize("d,r_min", [(3, 6), (2, 4)])
def test_sharded_staircase_from_a_high_rank_matches_jax(d, r_min):
    kw = dict(n=32, d=d, num_lc=16, rot_noise=0.01, trans_noise=0.01)
    run = dict(r_min=r_min, r_max=r_min + 1, rounds_per_rank=60)
    jT, jXa, jrank, jcert, jhist = jdcert.solve_staircase_sharded(
        jmake(np.random.default_rng(42), **kw)[0], 8, mesh=jmake_mesh(8),
        dtype=jnp.float64, **run)
    T, Xa, rank, cert, hist = dcert.solve_staircase_sharded(
        tmake(np.random.default_rng(42), **kw)[0], 8,
        mesh=make_mesh(device="cpu"), dtype=torch.float64, device="cpu",
        **run)
    assert rank == jrank and cert.certified == jcert.certified
    assert [h[0] for h in hist] == [h[0] for h in jhist]
    np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in jhist],
                               rtol=1e-9)
    # The agents' iterates at the final rank (the rounded trajectory
    # depends on the SVD each package rounds with).
    assert Xa.shape[-2:] == (rank, d + 1)
    np.testing.assert_allclose(Xa.numpy(), np.asarray(jXa), rtol=0,
                               atol=1e-8)
    assert T.shape == (32, d, d + 1) and bool(torch.isfinite(T).all())
