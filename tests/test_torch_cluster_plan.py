"""The host side of the cluster route of kernels B1-B4
(``dpgo_tpu_torch.ops.rtr_kernel.cluster_plan`` and ``cost_owner``) on
graphs that ``models.rbcd.build_graph`` makes from the synthetic problems of
``tests/synthetic.py``.  The kernels themselves run only on the card
(``test_torch_cuda.py``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.ops import quadratic
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.types import Measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from tests.synthetic import make_measurements

# (d, rank, poses, agents, loop closures): agents from 6 to 4200 poses.
SHAPES = [(3, 5, 48, 8, 20), (3, 5, 2500, 8, 2449), (2, 3, 900, 3, 300),
          (3, 3, 1200, 2, 600), (2, 2, 600, 1, 200), (3, 5, 2000, 1, 2000),
          (3, 4, 4200, 1, 1000)]


@functools.lru_cache(maxsize=None)
def _graph(d, rank, n, A, num_lc, dtype=torch.float32):
    jmeas = make_measurements(np.random.default_rng(7), n=n, d=d,
                              num_lc=num_lc, rot_noise=0.02,
                              trans_noise=0.02)[0]
    meas = Measurements(**{f.name: getattr(jmeas, f.name)
                           for f in dataclasses.fields(Measurements)})
    part = partition_contiguous(meas, A)
    return rbcd.build_graph(part, rank, dtype, device="cpu")


def _plan(graph, meta):
    return rk.cluster_plan(meta.n_max, meta.e_max, graph.inc_slot.shape[-1],
                           meta.rank, meta.d)


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES)
def test_cluster_plan_fits_the_card(d, rank, n, A, num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc)
    plan = _plan(graph, meta)
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    if plan.route == "cluster":
        assert plan.C in rk.CLUSTER_SIZES
        assert plan.threads <= rk.MAX_CLUSTER_THREADS
        assert plan.threads >= plan.P and plan.threads % 32 == 0
        assert plan == rk.cluster_shape(meta.rank, meta.d, meta.n_max,
                                        graph.inc_slot.shape[-1], plan.C)


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES)
def test_cluster_slices_cover_every_pose_once(d, rank, n, A, num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc)
    plan = _plan(graph, meta)  # the workspace route: one CTA, all poses
    assert (plan.route == "workspace") == (plan.C == 0)
    owner = np.full(meta.n_max, -1)
    for c in range(max(plan.C, 1)):
        lo, hi = c * plan.P, min((c + 1) * plan.P, meta.n_max)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = c
    assert (owner >= 0).all()


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES)
def test_workspace_route_exactly_when_no_cluster_fits(d, rank, n, A,
                                                      num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc)
    K = graph.inc_slot.shape[-1]
    fitting = [C for C in rk.CLUSTER_SIZES
               if rk._fits(rk.cluster_shape(rank, d, meta.n_max, K, C))]
    plan = _plan(graph, meta)
    # Above the cluster ceiling B2 takes the spread route where one fits
    # (rtr_spread.cu), the workspace route only where none does.
    assert (plan.route != "cluster") == (not fitting)
    if not fitting:
        spread = rk._spread_plan(meta.n_max, rank, d, 1, rk.H100_SMS)
        assert plan.route == ("spread" if spread else "workspace")
    if fitting:
        # The smallest portable size whose CTAs have at most SPREAD_WARPS
        # warps, else the largest portable size, else 16.
        portable = [C for C in fitting if C <= 8] or fitting
        spread = [C for C in portable
                  if rk.cluster_shape(rank, d, meta.n_max, K, C).threads
                  <= 32 * rk.SPREAD_WARPS]
        assert plan.C == (spread[0] if spread else portable[-1])


def test_plan_routes_at_the_slice_shape():
    # The chip run's shape (sphere2500 stand-in over 8 agents) takes a
    # cluster of more than one CTA; one agent of 4200 poses the spread
    # route, B3 at B2's shape.
    assert _plan(*_graph(3, 5, 2500, 8, 2449)) == rk.ClusterPlan(
        "cluster", 8, 40, 224, rk.cluster_shape(5, 3, 316, 11, 8).smem_bytes)
    graph, meta = _graph(3, 4, 4200, 1, 1000)
    assert _plan(graph, meta).route == "spread"
    assert _kernel_plan(graph, meta, "rtr") == _plan(graph, meta)


def test_forced_cluster_that_cannot_hold_the_agent_raises():
    graph, meta = _graph(3, 5, 900, 3, 300)
    assert rk.cluster_shape(5, 3, meta.n_max, graph.inc_slot.shape[-1],
                            1).threads > rk.MAX_CLUSTER_THREADS
    X = torch.zeros(3, meta.n_max, 5, 4)
    Z = torch.zeros(3, meta.s_max, 5, 4)
    chol = torch.eye(4).expand(3, meta.n_max, 4, 4)
    args = rbcd.kernel_operands(X, Z, graph.edges, chol, graph)
    kw = rbcd.kernel_options(AgentParams(d=3, r=5, num_robots=3), meta)
    with pytest.raises(ValueError, match="cluster of 1 CTAs"):
        rk.rtr_full(*args, _cluster=1, **kw)


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES[:5])
def test_cost_owner_counts_every_live_edge_once(d, rank, n, A, num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc)
    own = rk.cost_owner(graph.edges.i, graph.inc_slot, graph.inc_mask,
                        meta.n_max, meta.e_max)
    slot = graph.inc_slot.long()
    edge = torch.where(slot >= meta.e_max, slot - meta.e_max, slot)
    for a in range(A):
        counts = torch.bincount(edge[a][own[a]], minlength=meta.e_max)
        assert torch.equal(counts, graph.edges.mask[a].long())


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES[:5])
def test_pose_centric_cost_equals_the_edge_cost(d, rank, n, A, num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    k = d + 1
    X = torch.randn(A, meta.n_max, rank, k, generator=gen,
                    dtype=torch.float64)
    Z = torch.randn(A, meta.s_max, rank, k, generator=gen,
                    dtype=torch.float64) * graph.nbr_mask[..., None, None]
    buf = torch.cat([X, Z, torch.zeros(A, 1, rank, k, dtype=X.dtype)], 1)
    e = graph.edges
    # The kernel's per-edge term: wk |rR|^2 + wt |rt|^2 of each edge.
    Xi, Xj = quadratic.take(buf, e.i), quadratic.take(buf, e.j)
    rR = Xj[..., :-1] - Xi[..., :-1] @ e.R
    rt = Xj[..., -1] - Xi[..., -1] - (Xi[..., :-1] @ e.t[..., None])[..., 0]
    w = e.mask * e.weight
    term = w * (e.kappa * (rR * rR).sum((-2, -1)) + e.tau * (rt * rt).sum(-1))
    own = rk.cost_owner(e.i, graph.inc_slot, graph.inc_mask, meta.n_max,
                        meta.e_max)
    slot = graph.inc_slot.long()
    edge = torch.where(slot >= meta.e_max, slot - meta.e_max, slot)
    per_entry = torch.gather(term, 1, edge.reshape(A, -1)).reshape(
        edge.shape) * own
    pose_centric = 0.5 * per_entry.sum((1, 2))
    torch.testing.assert_close(pose_centric, quadratic.cost(buf, e),
                               rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# B1 (tcg) and B4 (rtr_refine_full): each kernel's own shape
# ---------------------------------------------------------------------------

NEW_KERNELS = ("tcg", "rtr_refine_full")


def _kernel_plan(graph, meta, kernel):
    return rk.cluster_plan(meta.n_max, meta.e_max, graph.inc_slot.shape[-1],
                           meta.rank, meta.d, kernel)


@pytest.mark.parametrize("kernel", NEW_KERNELS)
@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES)
def test_kernel_plan_fits_the_card(kernel, d, rank, n, A, num_lc):
    graph, meta = _graph(d, rank, n, A, num_lc)
    K = graph.inc_slot.shape[-1]
    plan = _kernel_plan(graph, meta, kernel)
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    if plan.route == "cluster":
        assert plan.C in rk.CLUSTER_SIZES
        assert plan.threads <= rk.MAX_CLUSTER_THREADS
        assert plan.threads >= plan.P and plan.threads % 32 == 0
        assert plan == rk.cluster_shape(rank, d, meta.n_max, K, plan.C,
                                        kernel)
    # Every pose in exactly one CTA's slice (the workspace route: one CTA).
    owner = np.full(meta.n_max, -1)
    for c in range(max(plan.C, 1)):
        lo, hi = c * plan.P, min((c + 1) * plan.P, meta.n_max)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = c
    assert (owner >= 0).all()
    # Another route exactly when no C fits, else the plan's rule: the
    # spread route where one fits, else the workspace route.
    fitting = [C for C in rk.CLUSTER_SIZES
               if rk._fits(rk.cluster_shape(rank, d, meta.n_max, K, C,
                                            kernel))]
    assert (plan.route != "cluster") == (not fitting)
    assert (plan.route == "workspace") == (plan.C == 0)
    if not fitting:
        spread = rk._spread_plan(meta.n_max, rank, d, 1, rk.H100_SMS)
        assert plan.route == ("spread" if spread else "workspace")
    if fitting:
        portable = [C for C in fitting if C <= 8] or fitting
        spread = [C for C in portable
                  if rk.cluster_shape(rank, d, meta.n_max, K, C,
                                      kernel).threads
                  <= 32 * rk.SPREAD_WARPS]
        assert plan.C == (spread[0] if spread else portable[-1])


@pytest.mark.parametrize("kernel", NEW_KERNELS)
@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES)
def test_refine_shape_holds_d_rc_and_the_residuals(kernel, d, rank, n, A,
                                                   num_lc):
    # B1 shares B2's shape; B4 adds two vectors (D, Rc) and r (d + 1)
    # payload fields per ELL entry: the bytes per CTA differ by exactly
    # that, at every C.
    graph, meta = _graph(d, rank, n, A, num_lc)
    K = graph.inc_slot.shape[-1]
    for C in rk.CLUSTER_SIZES:
        base = rk.cluster_shape(rank, d, meta.n_max, K, C)
        own = rk.cluster_shape(rank, d, meta.n_max, K, C, kernel)
        assert (own.P, own.threads) == (base.P, base.threads)
        extra = 0 if kernel == "tcg" else 4 * base.P * (
            2 * rk._vec_stride(rank * (d + 1)) + rank * (d + 1) * K)
        assert own.smem_bytes - base.smem_bytes == extra


def test_new_kernels_plan_routes_at_the_slice_shape():
    # The chip run's shape: B1 and B4 take clusters of several CTAs, as B2
    # does; one agent of the whole stand-in (2500 poses) takes the spread
    # route (16 CTAs of 157 poses, two stripes), B1 and B4 alike; B4's
    # forced workspace route keeps its payload (144 B an edge) in device
    # memory.
    graph, meta = _graph(3, 5, 2500, 8, 2449)
    assert _kernel_plan(graph, meta, "tcg") == _plan(graph, meta)
    b4 = _kernel_plan(graph, meta, "rtr_refine_full")
    assert b4 == rk.ClusterPlan("cluster", 8, 40, 224, 105792)
    g1, m1 = _graph(3, 5, 2500, 1, 2449)
    assert _kernel_plan(g1, m1, "rtr_refine_full") == rk.spread_shape(
        5, 3, 2500, 16)
    assert rk.spread_shape(5, 3, 2500, 16).stripes == 2
    assert _kernel_plan(g1, m1, "tcg") == rk.spread_shape(5, 3, 2500, 16)
    ws = rk._route(0, m1.n_max, m1.e_max, g1.inc_slot.shape[-1], 5, 3,
                   "rtr_refine_full")
    assert ws == rk.ClusterPlan("workspace", 0, 2500, 256, 128)
    assert m1.e_max * 144 > rk.MAX_SMEM_BYTES


def test_unknown_kernel_has_no_plan():
    with pytest.raises(ValueError, match="unknown kernel"):
        rk.cluster_plan(316, 920, 11, 5, 3, "rtr_fast")


def _refined(d, rank, n, A, num_lc):
    """A problem recentered at its chordal init: the refine constants and
    kernel operands of a random correction, and the graph."""
    meas = make_measurements(np.random.default_rng(7), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.02,
                             trans_noise=0.02)[0]
    tmeas = Measurements(**{f.name: getattr(meas, f.name)
                            for f in dataclasses.fields(Measurements)})
    params = AgentParams(d=d, r=rank, num_robots=A)
    prob = rbcd.prepare_problem(tmeas, A, params, device="cpu")
    Xg = rbcd.gather_to_global(prob.X0, prob.graph, n).double().numpy()
    ref = refine.recenter(Xg, prob.graph, prob.meta, params,
                          refine.host_edges_f64(tmeas))
    gen = torch.Generator().manual_seed(4)
    D = 1e-2 * torch.randn(ref.consts.R.shape, generator=gen)
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, prob.graph), prob.graph)
    ops = refine.refine_kernel_operands(D, Dz, ref.consts, prob.graph)
    return prob, [t.double() if t.is_floating_point() else t for t in ops]


@pytest.mark.parametrize("d,rank,n,A,num_lc", SHAPES[:5])
def test_refine_cost_at_the_owner_entries_equals_delta_cost(d, rank, n, A,
                                                            num_lc):
    # B4's cost: each cost-owner ELL entry reads its edge's weights and, for
    # each row a, the reference residuals rho_rot[a d : (a + 1) d] and
    # rho_trn[a] by the addresses the kernel's setup copies them from; its
    # rows' terms w [<rho, L> + |L|^2 / 2] over those entries must sum to
    # the plain version's quadratic.delta_cost, in float64.
    prob, ops = _refined(d, rank, n, A, num_lc)
    (idx_i, idx_j, rot, trn, wk, wt, rho_rot, rho_trn, _, Dc, Dzc, _, _, _,
     Lc, inc_slot, inc_mask, _) = ops
    meta, k = prob.meta, d + 1
    n_max, s_max, e_max = meta.n_max, meta.s_max, meta.e_max
    loc = rk._local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                    d=d, e_max=e_max, n=n_max, s=s_max, dtype=torch.float64)
    buf = rk._buffer(rk.comp_minor(Dc, rank, k), rk.comp_minor(Dzc, rank, k),
                     loc.n_buf)
    rhoR = rk._untile(rho_rot, e_max).reshape(A, e_max, rank, d)
    rhot = rk._untile(rho_trn, e_max)
    plain = quadratic.delta_cost(buf, rhoR, rhot, loc.edges)

    LR, Lt = quadratic._edge_terms(buf, loc.edges)  # [A, E, r, d], [A, E, r]
    own = rk.cost_owner(loc.edges.i, inc_slot, inc_mask, n_max, e_max)
    slot = inc_slot.long()
    edge = torch.where(slot >= e_max, slot - e_max, slot)  # [A, n, K]
    T = idx_i.shape[-1]
    Ep = idx_i.shape[1] * T
    tile, lane = edge // T, edge % T
    rows = torch.arange(rank)
    comp = torch.arange(d)
    # rho_rot + (tile * (R*D) + a*D + c) * T + lane; rho_trn + (tile * R +
    # a) * T + lane; wk, wt + e (per agent).
    at_rot = ((tile[..., None, None] * (rank * d) + rows[:, None] * d
               + comp) * T + lane[..., None, None])
    at_trn = (tile[..., None] * rank + rows) * T + lane[..., None]
    flat_rot = rho_rot.reshape(A, -1)
    flat_trn = rho_trn.reshape(A, -1)
    ent_rot = torch.gather(flat_rot, 1, at_rot.reshape(A, -1)).reshape(
        at_rot.shape)
    ent_trn = torch.gather(flat_trn, 1, at_trn.reshape(A, -1)).reshape(
        at_trn.shape)
    ent_wk = torch.gather(wk.reshape(A, Ep), 1, edge.reshape(A, -1)) \
        .reshape(edge.shape)
    ent_wt = torch.gather(wt.reshape(A, Ep), 1, edge.reshape(A, -1)) \
        .reshape(edge.shape)

    def per_entry(x):
        flat = x.reshape(A, e_max, -1)
        idx = edge.reshape(A, -1, 1).expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx).reshape(edge.shape + x.shape[2:])

    lr, lt = per_entry(LR), per_entry(Lt)
    term = (ent_wk[..., None] * ((ent_rot * lr).sum(-1)
                                 + 0.5 * (lr * lr).sum(-1))
            + ent_wt[..., None] * (ent_trn * lt + 0.5 * lt * lt))
    pose_centric = (term.sum(-1) * own).sum((1, 2))
    assert float(plain.abs().max()) > 0
    torch.testing.assert_close(pose_centric, plain, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kernel", NEW_KERNELS)
def test_forced_b1_b4_cluster_that_cannot_hold_the_agent_raises(kernel):
    prob, ops = _refined(3, 5, 900, 3, 300)
    meta = prob.meta
    K = ops[15].shape[-1]
    assert rk.cluster_shape(5, 3, meta.n_max, K, 1,
                            kernel).threads > rk.MAX_CLUSTER_THREADS
    ops = [t.float() if t.is_floating_point() else t for t in ops]
    kw = rbcd.kernel_options(AgentParams(d=3, r=5, num_robots=3), meta)
    with pytest.raises(ValueError, match="cluster of 1 CTAs"):
        if kernel == "rtr_refine_full":
            rk.rtr_refine_full(*ops, _cluster=1, **kw)
        else:
            kw.pop("grad_tol")
            for key in ("initial_radius", "max_rejections"):
                kw.pop(key)
            rk.tcg(*ops[:6], ops[9], ops[13], ops[14], ops[11],
                   torch.ones(3), ops[15], ops[16], _cluster=1, **kw)
