"""The port above the staircase's default top rank, as the TPU runs it:
every kernel at d in {2, 3} and every r >= 11 (``csrc/shapes.cuh``'s
rank-generic instantiation).

* the route plan (``rtr_kernel.cluster_plan``) for each of B1-B4 over a
  grid of agent shapes: the sphere2500 stand-in's, the SE(2) stand-in's,
  BASELINE.md config #5's and the smallGrid3D-size stand-in's per-agent
  shapes (PERF.md section 4) and small agents, at ranks from 11 to 4482
  (``RANKS``): wherever the JAX package's VMEM gate
  (``dpgo_tpu.models.rbcd.pallas_vmem_ok``) admits the shape, the plan is
  a route that fits the card; above ``rtr_kernel.MAX_LANE_RANK`` (r = 512,
  a pose of 16 warps) no cluster: B1-B4 take the spread route, its rows
  folded over 16 warps, wherever its shared memory fits, else the
  workspace route; a cluster forced past that cap raises;
* ``rbcd.solve_rbcd`` at r = 12 (d = 3) and r = 33 (d = 2), and
  ``parallel.certify.solve_staircase_sharded`` from r = 11 to 12, against
  the JAX package's in float64.

The kernels run only on the card (``test_torch_cuda.py``); here the
wrappers take their plain versions.  ``test_torch_high_ranks_pallas.py``
holds B1-B4's plain versions against the Pallas kernels at these ranks,
``test_torch_top_ranks.py`` and ``test_torch_top_ranks_solve.py`` the
plain versions and the solve above r = 128 against the JAX package.
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
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

from test_torch_rtr_kernel import ORDER, RTR_KW, _problem

#: The ranks of the plan's grid: poses of one to four warps, the first
#: rank past four, a pose of eight and of 16 warps (the lane cap), the
#: first rank past the cap, and the top ranks the JAX gate admits at the
#: agent shapes below (396 at 120-pose agents, 817 and 1636 at the
#: smallGrid3D-size stand-in's, 3360 and 4482 at 16-pose agents).
RANKS = (11, 16, 17, 32, 33, 64, 73, 78, 128, 129, 256, 396, 512, 513, 817,
         1636, 3360, 4482)

#: Per-agent shapes (n_max, s_max, e_max, Kinc, d, agents): the stand-ins
#: of PERF.md section 4 (the sphere2500 stand-in over 8 robots, the SE(2)
#: stand-in at city10000's size over 32, BASELINE.md config #5 over 64, the
#: smallGrid3D-size stand-in over 4 and 2) and small agents at both d.
AGENT_SHAPES = {
    "sphere2500": (316, 508, 920, 11, 3, 8),
    "se2_city10000": (328, 665, 1019, 11, 2, 32),
    "config5": (1594, 671, 2236, 7, 3, 64),
    "small_d3": (16, 12, 24, 5, 3, 2),
    "mid_d3": (120, 80, 260, 8, 3, 4),
    "small_d2": (16, 12, 24, 5, 2, 2),
    "mid_d2": (200, 150, 420, 9, 2, 16),
    "large_d2": (900, 400, 1500, 10, 2, 8),
    "smallgrid3d_4": (32, 53, 112, 10, 3, 4),
    "smallgrid3d_2": (63, 47, 190, 10, 3, 2),
}


def _jax_admits(n_max, s_max, e_max, r, d):
    T, nt = jrbcd._edge_tile_shape(n_max, s_max, e_max)
    return jrbcd.pallas_vmem_ok(n_max, s_max, r, d, T, nt)


def _assert_fits(plan, kernel, n_max, r, d, kinc, agents):
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    if r > rk.MAX_LANE_RANK:
        spread = rk._spread_plan(n_max, r, d, agents, rk.H100_SMS)
        assert plan.route == ("spread" if spread else "workspace")
        assert spread is None or plan == spread
    if plan.route == "cluster":
        assert plan.threads <= rk.MAX_CLUSTER_THREADS
        assert plan.C in rk.CLUSTER_SIZES and plan.C * plan.P >= n_max
        # B2 and B4 at 11 <= r <= 32 may fold a pose's rows over 8 or 16
        # lanes (rk.FOLD_RULE); every other cluster has r lanes a pose.
        assert plan == (rk.cluster_fold_shape(r, d, n_max, kinc, plan.C,
                                              plan.lanes, kernel)
                        if plan.lanes else
                        rk.cluster_shape(r, d, n_max, kinc, plan.C, kernel))
        assert not plan.lanes or (kernel in rk.FOLD_KERNELS
                                  and r in rk.FOLD_RANKS)
    elif plan.route == "spread":
        assert plan.threads <= rk.SPREAD_THREADS
        assert plan.C * plan.P >= n_max
        assert plan == rk.spread_shape(r, d, n_max, plan.C)
        assert plan.folds == -(-r // 512)
    else:
        assert plan.route == "workspace" and plan.threads == 256
        return
    # Whole lane groups: a pose of r > 32 rows takes ceil(r / 32) warps, 16
    # once its rows fold (r > 512).
    warps = -(-min(r, 512) // 32) if r > 32 else 1
    assert plan.threads % (32 * warps) == 0


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
@pytest.mark.parametrize("where", list(AGENT_SHAPES))
def test_plan_fits_every_shape_the_jax_gate_admits(kernel, where):
    n_max, s_max, e_max, kinc, d, agents = AGENT_SHAPES[where]
    admitted = [r for r in RANKS if _jax_admits(n_max, s_max, e_max, r, d)]
    assert admitted, "the grid holds no shape the JAX package runs"
    for r in admitted:
        plan = rk.cluster_plan(n_max, e_max, kinc, r, d, kernel,
                               agents=agents, sms=rk.H100_SMS)
        _assert_fits(plan, kernel, n_max, r, d, kinc, agents)


def test_the_gate_reaches_the_stand_ins_top_ranks():
    # The TPU runs its kernel up to r = 73 on the sphere2500 stand-in's
    # agents, r = 78 on the SE(2) stand-in's, r = 18 on config #5's, r =
    # 1636 and 817 on the smallGrid3D-size stand-in's over 4 and 2 robots,
    # r = 396 on 120-pose agents and r = 3360 / 4482 on 16-pose agents.
    for where, top in (("sphere2500", 73), ("se2_city10000", 78),
                       ("config5", 18), ("smallgrid3d_4", 1636),
                       ("smallgrid3d_2", 817), ("mid_d3", 396),
                       ("small_d3", 3360), ("small_d2", 4482)):
        n_max, s_max, e_max, _, d, _ = AGENT_SHAPES[where]
        assert _jax_admits(n_max, s_max, e_max, top, d)
        assert not _jax_admits(n_max, s_max, e_max, top + 1, d)


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
def test_stand_in_routes_at_its_top_rank(kernel):
    # r = 73 on the sphere2500 stand-in: no cluster holds a 316-pose agent
    # (a pose takes three warps), so every kernel spreads over 16 CTAs an
    # agent, 480 threads (five poses at a time, four stripes).
    n_max, _, e_max, kinc, d, agents = AGENT_SHAPES["sphere2500"]
    plan = rk.cluster_plan(n_max, e_max, kinc, 73, d, kernel, agents=agents)
    assert (plan.route, plan.C, plan.threads, plan.stripes) == (
        "spread", 16, 480, 4)


@pytest.mark.parametrize("kernel", rk.SPREAD_KERNELS)
def test_config5_spreads_at_its_top_rank(kernel):
    # r = 18 at config #5: three shared vectors of 76 floats a pose hold at
    # most ~254 poses a CTA, so 132 // 64 = 2 CTAs an agent are raised to 7.
    n_max, _, e_max, kinc, d, agents = AGENT_SHAPES["config5"]
    plan = rk.cluster_plan(n_max, e_max, kinc, 18, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    assert (plan.route, plan.C, plan.P) == ("spread", 7, 228)
    assert rk.spread_shape(18, d, n_max, 6).smem_bytes > rk.MAX_SMEM_BYTES


@pytest.mark.parametrize("r", [11, 16, 32, 33, 64, 65, 96, 97, 128])
def test_lane_layout_above_the_templated_ranks(r):
    # Up to r = 32 a warp holds 32 // r poses of r lanes; above, a pose
    # takes ceil(r / 32) warps and a CTA holds whole poses.  Group-sum
    # slots (8 floats a warp) only where a pose spans warps.
    W = -(-r // 32) if r > 32 else 1
    per_warp = 32 // r if r <= 32 else 1
    base = rk.cluster_shape(r, 3, 40, 6, 4)
    assert base.threads == -(-10 // per_warp) * 32 * W
    spread = rk.spread_shape(r, 3, 2000, 4)
    groups = spread.threads // 32 // W * per_warp
    assert spread.threads <= rk.SPREAD_THREADS
    assert spread.threads % (32 * W) == 0
    assert spread.stripes == -(-spread.P // groups)
    slots = 8 * (spread.threads // 32) if r > 32 else 0
    assert spread.smem_bytes == 4 * (3 * spread.P * rk._vec_stride(4 * r)
                                     + 2 * 4 * (spread.threads // 32) * 4
                                     + slots)


#: The spread plans of B1-B4 past the lane cap on the stand-ins' agents
#: (where, r): C, P, folds (rows a lane) and shared bytes a CTA; 512
#: threads each, one pose a stripe.
FOLDED_PLANS = {("smallgrid3d_4", 513): (16, 2, 2, 57952),
                ("smallgrid3d_4", 817): (16, 2, 2, 87136),
                ("smallgrid3d_4", 1636): (16, 2, 4, 165856),
                ("smallgrid3d_2", 513): (16, 4, 2, 107200),
                ("smallgrid3d_2", 817): (16, 4, 2, 165568),
                ("small_d3", 3360): (16, 1, 7, 170032),
                ("small_d2", 4482): (16, 1, 9, 170128)}


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
def test_plan_raises_above_the_ceiling(kernel):
    # The ceiling is the cluster route's own (a pose of at most 16 warps,
    # one row a lane, r <= 512): the plan never raises for a rank.  At
    # r = 129 on 16-pose agents every kernel takes a cluster of five-warp
    # poses; past 512 every kernel takes the spread route, a pose's rows
    # folded over 16 warps (FOLDED_PLANS); a cluster forced there raises,
    # naming the 16-warp cap, and so does a spread forced at a size whose
    # shared memory does not fit.
    assert rk.MAX_LANE_RANK == 512
    for d in (3, 2):
        plan = rk.cluster_plan(16, 24, 5, 129, d, kernel)
        assert plan.route == "cluster" and plan.threads % (5 * 32) == 0
        assert rk._route(None, 16, 24, 5, 129, d, kernel) == plan
        assert rk._route(0, 16, 24, 5, 513, d, kernel) == \
            rk._workspace_plan(16, 24, 513, d, kernel)
        for C in (1, 16):
            with pytest.raises(ValueError, match="at most 16, so r <= 512"):
                rk._route(C, 16, 24, 5, 513, d, kernel)
        assert rk._route(None, 16, 24, 5, 512, d, kernel,
                         spread=16).route == "spread"
        assert rk._route(None, 16, 24, 5, 513, d, kernel,
                         spread=16).folds == 2
        with pytest.raises(ValueError, match="shared memory"):
            rk._route(None, 16, 24, 5, 4482, d, kernel, spread=1)
    for (where, r), (C, P, folds, smem) in FOLDED_PLANS.items():
        n_max, _, e_max, kinc, d, agents = AGENT_SHAPES[where]
        plan = rk.cluster_plan(n_max, e_max, kinc, r, d, kernel,
                               agents=agents, sms=rk.H100_SMS)
        assert plan == rk.ClusterPlan("spread", C, P, 512, smem, P, folds)


@pytest.mark.parametrize("kernel", ["rtr", "tcg"])
@pytest.mark.parametrize("where,r", [
    ("config5", 5), ("config5", 7), ("config5", 10), ("config5", 18),
    ("sphere2500", 17), ("sphere2500", 73), ("se2_city10000", 78),
    ("smallgrid3d_4", 513), ("smallgrid3d_4", 1636), ("small_d3", 3360),
    ("small_d2", 4482)])
def test_b1_and_b3_plan_b2s_spread_above_the_ceiling(kernel, where, r):
    # Above the cluster ceiling B1 and B3 take B2's spread route at the
    # same shape: C, P, threads, stripes, folds and shared bytes (the four
    # kernels share rtr_spread.cu's spread_shape); the workspace route only
    # where no spread fits.  Where B2 folds a pose's rows on a cluster
    # instead (rk.FOLD_RULE: the stand-in at r = 17), its spread is the one
    # a forced spread of the plan's size takes.
    n_max, _, e_max, kinc, d, agents = AGENT_SHAPES[where]
    b2 = rk.cluster_plan(n_max, e_max, kinc, r, d, "rtr_full",
                         agents=agents, sms=rk.H100_SMS)
    if b2.lanes:
        C = rk._spread_plan(n_max, r, d, agents, rk.H100_SMS).C
        b2 = rk._route(None, n_max, e_max, kinc, r, d, "rtr_full", spread=C,
                       agents=agents, sms=rk.H100_SMS)
    plan = rk.cluster_plan(n_max, e_max, kinc, r, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    assert b2.route == "spread" and plan == b2
    assert plan == rk._spread_plan(n_max, r, d, agents, rk.H100_SMS)
    assert plan.folds == (-(-r // 512) if r > 512 else 1)


def test_cpu_wrapper_runs_its_plain_version_above_the_ceiling():
    # On CPU tensors the wrapper runs its plain version at r = 129 and at
    # r = 513, past the cluster route's cap, also where a route is forced
    # (at 513 the workspace route, or a spread of folded rows); only a
    # route forced for the card that cannot hold the pose raises there.
    for r, forced in ((129, ({"_cluster": 16},)),
                      (513, ({"_cluster": 0}, {"_spread": 2}))):
        _, meta, _, _, _, ops = _problem(5, n=12, A=2, d=2, rank=r,
                                         num_lc=4)
        args = [ops[k] for k in ORDER]
        kw = dict(r=r, d=2, e_max=meta.e_max, **RTR_KW)
        before = rk.LAUNCHES
        ref = rk.rtr_full_reference(*args, **kw)
        for opts in ({}, *forced):
            out = rk.rtr_full(*args, **opts, **kw)
            for got, want in zip(out, ref):
                assert torch.equal(got, want)
        assert rk.LAUNCHES == before
        assert bool(torch.isfinite(ref.X).all())
    with pytest.raises(ValueError, match="r <= 512"):
        rk.rtr_full(*args, _cluster=1, **kw)


@pytest.mark.parametrize("r", [513, 817, 1636, 3360, 4482])
@pytest.mark.parametrize("n_max", [1, 16, 1594])
def test_spread_shape_past_the_lane_cap_does_not_fit(r, n_max):
    # Above r = 512 no cluster fits a pose (the plan never offers one),
    # and the spread shape folds its rows: 16 warps a CTA, one pose a
    # stripe, ceil(r / 512) rows a lane, the shared vectors holding every
    # fold.  It fits exactly where that shared memory does: never for
    # config #5's 1594-pose agents, so there the plan has no spread.
    for C in (1, 2, 16):
        plan = rk.spread_shape(r, 3, n_max, C)
        assert plan.threads == rk.SPREAD_THREADS
        assert plan.stripes == plan.P == -(-n_max // C)
        assert plan.folds == -(-r // 512)
        assert plan.smem_bytes == 4 * (3 * plan.P * rk._vec_stride(4 * r)
                                       + 2 * C * 16 * 4 + 16 * 8)
        assert rk._fits(plan) == (plan.smem_bytes <= rk.MAX_SMEM_BYTES)
    spread = rk._spread_plan(n_max, r, 3, 4, rk.H100_SMS)
    assert (spread is None) == (n_max == 1594)
    for kernel in rk.KERNELS:
        assert rk.cluster_plan(n_max, 24, 5, r, 3, kernel).route != "cluster"


@pytest.mark.parametrize("where,r", [("smallgrid3d_2", 1636),
                                     ("sphere2500", 513), ("config5", 600)])
@pytest.mark.parametrize("kernel", rk.SPREAD_KERNELS)
def test_spread_that_does_not_fit_plans_the_workspace_route(kernel, where, r):
    # Past the lane cap a spread whose shared vectors exceed a CTA's shared
    # memory at every C up to 16 (63-, 316- and 1594-pose agents) leaves B2
    # and B4 on the workspace route, the catch-all.
    n_max, _, e_max, kinc, d, agents = AGENT_SHAPES[where]
    assert all(rk.spread_shape(r, d, n_max, C).smem_bytes
               > rk.MAX_SMEM_BYTES for C in range(1, 17))
    plan = rk.cluster_plan(n_max, e_max, kinc, r, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    assert plan == rk._workspace_plan(n_max, e_max, r, d, kernel)


@pytest.mark.parametrize("d,r", [(3, 12), (2, 33)])
def test_solve_rbcd_above_the_templated_ranks_matches_jax(d, r):
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


def test_sharded_staircase_from_rank_11_matches_jax():
    kw = dict(n=32, d=3, num_lc=16, rot_noise=0.01, trans_noise=0.01)
    run = dict(r_min=11, r_max=12, rounds_per_rank=40)
    jT, jXa, jrank, jcert, jhist = jdcert.solve_staircase_sharded(
        jmake(np.random.default_rng(42), **kw)[0], 8, mesh=jmake_mesh(8),
        dtype=jnp.float64, **run)
    T, Xa, rank, cert, hist = dcert.solve_staircase_sharded(
        tmake(np.random.default_rng(42), **kw)[0], 8,
        mesh=make_mesh(device="cpu"), dtype=torch.float64, device="cpu",
        **run)
    assert rank == jrank and cert.certified == jcert.certified
    assert [h[0] for h in hist] == [h[0] for h in jhist]
    assert hist[0][0] == 11
    np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in jhist],
                               rtol=1e-9)
    assert Xa.shape[-2:] == (rank, 4)
    np.testing.assert_allclose(Xa.numpy(), np.asarray(jXa), rtol=0,
                               atol=1e-8)
    assert T.shape == (32, 3, 4) and bool(torch.isfinite(T).all())
