"""The port above the staircase's default top rank, as the TPU runs it:
every kernel at d in {2, 3} and 11 <= r <= 128 (``csrc/shapes.cuh``'s
rank-generic instantiation).

* the route plan (``rtr_kernel.cluster_plan``) for each of B1-B4 over a
  grid of agent shapes: the sphere2500 stand-in's, the SE(2) stand-in's
  and BASELINE.md config #5's per-agent shapes (PERF.md section 4) and
  small agents, at r in {11, 16, 17, 32, 33, 64, 73, 78, 128}: wherever the
  JAX package's VMEM gate (``dpgo_tpu.models.rbcd.pallas_vmem_ok``) admits
  the shape, the plan is a route that fits the card; above r = 128 it
  raises;
* B1-B4's plain versions against the Pallas kernels
  (``dpgo_tpu.ops.pallas_tcg``, interpreter mode) at (r, d) = (11, 3),
  (17, 3) and (12, 2);
* ``rbcd.solve_rbcd`` at r = 12 (d = 3) and r = 33 (d = 2), and
  ``parallel.certify.solve_staircase_sharded`` from r = 11 to 12, against
  the JAX package's in float64.

The kernels run only on the card (``test_torch_cuda.py``); here the
wrappers take their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import pallas_tcg as ptcg
from dpgo_tpu.parallel import certify as jdcert
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.parallel import certify as dcert
from dpgo_tpu_torch.parallel import make_mesh
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

from test_torch_refine import (D_ATOL, GN_ATOL, _d0, _handoff,
                               _kernel_operands, _recentered)
from test_torch_refine import KW as REFINE_KW
from test_torch_refine import ORDER as REFINE_ORDER
from test_torch_rtr_kernel import (B3_KW, B3_ORDER, KW, ORDER, RTR_KW,
                                   _b3_operands, _j, _problem)

#: The ranks of the plan's grid.
RANKS = (11, 16, 17, 32, 33, 64, 73, 78, 128)

#: Per-agent shapes (n_max, s_max, e_max, Kinc, d, agents): the three
#: stand-ins of PERF.md section 4 (the sphere2500 stand-in over 8 robots,
#: the SE(2) stand-in at city10000's size over 32, BASELINE.md config #5
#: over 64) and small agents at both d.
AGENT_SHAPES = {
    "sphere2500": (316, 508, 920, 11, 3, 8),
    "se2_city10000": (328, 665, 1019, 11, 2, 32),
    "config5": (1594, 671, 2236, 7, 3, 64),
    "small_d3": (16, 12, 24, 5, 3, 2),
    "mid_d3": (120, 80, 260, 8, 3, 4),
    "small_d2": (16, 12, 24, 5, 2, 2),
    "mid_d2": (200, 150, 420, 9, 2, 16),
    "large_d2": (900, 400, 1500, 10, 2, 8),
}


def _jax_admits(n_max, s_max, e_max, r, d):
    T, nt = jrbcd._edge_tile_shape(n_max, s_max, e_max)
    return jrbcd.pallas_vmem_ok(n_max, s_max, r, d, T, nt)


def _assert_fits(plan, kernel, n_max, r, d, kinc):
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    if plan.route == "cluster":
        assert plan.threads <= rk.MAX_CLUSTER_THREADS
        assert plan.C in rk.CLUSTER_SIZES and plan.C * plan.P >= n_max
        assert plan == rk.cluster_shape(r, d, n_max, kinc, plan.C, kernel)
    elif plan.route == "spread":
        assert kernel in rk.SPREAD_KERNELS
        assert plan.threads <= rk.SPREAD_THREADS
        assert plan.C * plan.P >= n_max
        assert plan == rk.spread_shape(r, d, n_max, plan.C)
    else:
        assert plan.route == "workspace" and plan.threads == 256
        return
    # Whole lane groups: a pose of r > 32 rows takes ceil(r / 32) warps.
    warps = -(-r // 32) if r > 32 else 1
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
        _assert_fits(plan, kernel, n_max, r, d, kinc)


def test_the_gate_reaches_the_stand_ins_top_ranks():
    # The TPU runs its kernel up to r = 73 on the sphere2500 stand-in's
    # agents, r = 78 on the SE(2) stand-in's and r = 18 on config #5's.
    for where, top in (("sphere2500", 73), ("se2_city10000", 78),
                       ("config5", 18)):
        n_max, s_max, e_max, _, d, _ = AGENT_SHAPES[where]
        assert _jax_admits(n_max, s_max, e_max, top, d)
        assert not _jax_admits(n_max, s_max, e_max, top + 1, d)


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
def test_stand_in_routes_at_its_top_rank(kernel):
    # r = 73 on the sphere2500 stand-in: no cluster holds a 316-pose agent
    # (a pose takes three warps), so B2 and B4 spread over 16 CTAs a
    # agent, 480 threads (five poses at a time, four stripes), and B1 and
    # B3 take the workspace route.
    n_max, _, e_max, kinc, d, agents = AGENT_SHAPES["sphere2500"]
    plan = rk.cluster_plan(n_max, e_max, kinc, 73, d, kernel, agents=agents)
    if kernel in rk.SPREAD_KERNELS:
        assert (plan.route, plan.C, plan.threads, plan.stripes) == (
            "spread", 16, 480, 4)
    else:
        assert plan.route == "workspace"


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


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
def test_plan_raises_above_the_ceiling(kernel):
    assert rk.MAX_RANK == 128
    with pytest.raises(ValueError, match="ceiling of r = 128"):
        rk.cluster_plan(16, 24, 5, 129, 3, kernel)
    with pytest.raises(ValueError, match="ceiling of r = 128"):
        rk._route(None, 16, 24, 5, 129, 2, kernel)


def test_cpu_wrapper_runs_its_plain_version_above_the_ceiling():
    # The ceiling is the card kernels' own: on CPU tensors the wrapper runs
    # its plain version at r = 129, and only a route forced for the card
    # raises there.
    _, meta, _, _, _, ops = _problem(5, n=12, A=2, d=2, rank=129, num_lc=4)
    args = [ops[k] for k in ORDER]
    kw = dict(r=129, d=2, e_max=meta.e_max, **RTR_KW)
    out = rk.rtr_full(*args, **kw)
    ref = rk.rtr_full_reference(*args, **kw)
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    assert bool(torch.isfinite(out.X).all())
    with pytest.raises(ValueError, match="ceiling"):
        rk.rtr_full(*args, _cluster=0, **kw)


#: The plain versions' shapes (d, rank, n, A, num_lc).
PARITY_SHAPES = [(3, 11, 16, 2, 6), (3, 17, 16, 2, 6), (2, 12, 16, 2, 6)]


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_tcg_reference_matches_pallas_tcg_at_high_ranks(d, rank, n, A,
                                                        num_lc):
    graph, meta, X0, Z, chol, _ = _problem(3, n=n, A=A, d=d, rank=rank,
                                           num_lc=num_lc)
    ops = _b3_operands(graph, meta, X0, Z, chol)
    args = [ops[k] for k in ORDER[:7]] + [ops["Sc"], ops["Lc"], ops["gc"],
                                          torch.ones(A), ops["inc_slot"],
                                          ops["inc_mask"]]
    ref = rk.tcg_reference(*args, r=rank, d=d, e_max=meta.e_max, **KW)
    for a in range(A):
        eta_c, heta_c, stats = ptcg.tcg_call(
            *[_j(ops[k][a]) for k in ORDER[:7]], _j(ops["Sc"][a]),
            _j(ops["Lc"][a]), _j(ops["gc"][a]),
            jnp.ones((1, 1), jnp.float32), r=rank, d=d, interpret=True,
            **KW)
        np.testing.assert_allclose(ref.eta[a].numpy(), eta_c, atol=1e-5)
        np.testing.assert_allclose(ref.heta[a].numpy(), heta_c, atol=1e-4)
        assert int(ref.stats[a, 0]) == int(stats[0, 0])
        assert bool(ref.stats[a, 1] > 0) == bool(stats[0, 1] > 0)


def _assert_step_matches(ref, a, Xo, stats):
    np.testing.assert_allclose(ref.X[a].numpy(), Xo, atol=1e-5)
    st = np.asarray(stats)[0]
    assert ref.stats[a, 0].item() == st[0]  # attempts
    assert ref.stats[a, 1].item() == st[1]  # accepted
    np.testing.assert_allclose(ref.stats[a, 2:].numpy(), st[2:], rtol=1e-5)


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_rtr_full_reference_matches_pallas_kernel_at_high_ranks(d, rank, n,
                                                                A, num_lc):
    _, meta, _, _, _, ops = _problem(5, n=n, A=A, d=d, rank=rank,
                                     num_lc=num_lc)
    ref = rk.rtr_full_reference(*[ops[k] for k in ORDER], r=rank, d=d,
                                e_max=meta.e_max, **RTR_KW)
    for a in range(A):
        Xo, stats = ptcg.rtr_full_call(
            *[_j(ops[k][a]) for k in ORDER[:9]], r=rank, d=d,
            interpret=True, **RTR_KW)
        _assert_step_matches(ref, a, Xo, stats)


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_rtr_reference_matches_pallas_kernel_at_high_ranks(d, rank, n, A,
                                                           num_lc):
    graph, meta, X0, Z, chol, _ = _problem(5, n=n, A=A, d=d, rank=rank,
                                           num_lc=num_lc)
    ops = _b3_operands(graph, meta, X0, Z, chol)
    ref = rk.rtr_reference(*ops.values(), r=rank, d=d, e_max=meta.e_max,
                           **B3_KW)
    for a in range(A):
        Xo, stats = ptcg.rtr_call(
            *[_j(ops[k][a]) for k in B3_ORDER[:11]], r=rank, d=d,
            interpret=True, **B3_KW)
        _assert_step_matches(ref, a, Xo, stats)


@pytest.mark.parametrize("d,r", [(3, 11), (3, 17), (2, 12)])
def test_rtr_refine_full_reference_matches_pallas_kernel_at_high_ranks(d, r):
    h = _handoff(d=d, r=r, n=16, A=2, rounds=20)
    _, tr = _recentered(h)
    ops = _kernel_operands(h, tr.consts, _d0(h))
    ref = rk.rtr_refine_full_reference(*ops.values(), r=r, d=d,
                                       e_max=h.meta.e_max, **REFINE_KW)
    live = h.graph.pose_mask.numpy() > 0
    for a in range(h.meta.num_robots):
        Dc, stats = ptcg.rtr_refine_full_call(
            *[jnp.asarray(ops[k][a].numpy()) for k in REFINE_ORDER[:15]],
            r=r, d=d, interpret=True, **REFINE_KW)
        got = rk.comp_minor(ref.D[a], r, d + 1).numpy()[live[a]]
        want = np.asarray(ptcg.comp_minor(Dc, r, d + 1))[live[a]]
        np.testing.assert_allclose(got, want, rtol=0, atol=D_ATOL)
        st = np.asarray(stats)[0]
        assert ref.stats[a, 0].item() == st[0]  # attempts
        assert ref.stats[a, 1].item() == st[1]  # accepted
        np.testing.assert_allclose(ref.stats[a, 4].item(), st[4], rtol=0,
                                   atol=GN_ATOL)
        np.testing.assert_allclose(ref.stats[a, 2:4].numpy(), st[2:4],
                                   rtol=1e-4, atol=1e-9)


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
