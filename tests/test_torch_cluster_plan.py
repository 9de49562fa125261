"""The host side of the cluster route of kernels B2 and B3
(``dpgo_tpu_torch.ops.rtr_kernel.cluster_plan`` and ``cost_owner``) on
graphs that ``models.rbcd.build_graph`` makes from the synthetic problems of
``tests/synthetic.py``.  The kernels themselves run only on the card
(``test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import quadratic
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.types import Measurements
from dpgo_tpu_torch.utils.partition import partition_contiguous
from tests.synthetic import make_measurements

# (d, rank, poses, agents, loop closures): agents from 6 to 4200 poses.
SHAPES = [(3, 5, 48, 8, 20), (3, 5, 2500, 8, 2449), (2, 3, 900, 3, 300),
          (3, 3, 1200, 2, 600), (2, 2, 600, 1, 200), (3, 5, 2000, 1, 2000),
          (3, 4, 4200, 1, 1000)]


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
    assert (plan.route == "workspace") == (not fitting)
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
    # cluster of more than one CTA; one agent of 4200 poses the workspace.
    assert _plan(*_graph(3, 5, 2500, 8, 2449)) == rk.ClusterPlan(
        "cluster", 8, 40, 224, rk.cluster_shape(5, 3, 316, 11, 8).smem_bytes)
    assert _plan(*_graph(3, 4, 4200, 1, 1000)).route == "workspace"


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
