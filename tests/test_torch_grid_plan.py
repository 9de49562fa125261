"""The grid route of kernels B2 and B4 on the host
(``dpgo_tpu_torch.ops.rtr_kernel.cluster_plan``, ``grid_shape`` and
``grid_workspace_floats``): the route of agents no spread holds at
BASELINE.md config #5's graph over 1-64 robots, the plans of every other
shape left as they were, the forced route's checks and the workspace's
size.  The kernels themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py``'s ``big_agents`` phase)."""

import functools

import numpy as np
import pytest
import torch

from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils import partition
from dpgo_tpu_torch.utils.synthetic import make_measurements_vectorized

SMS = rk.H100_SMS


@functools.lru_cache(maxsize=None)
def _config5_meas():
    # BASELINE.md config #5: 100,000 poses, seed 11, noise 0.05, 20,000
    # loop closures (chip_smoke.config5_instance's measurements).
    return make_measurements_vectorized(np.random.default_rng(11), 100_000,
                                        d=3, num_lc=20_000, rot_noise=0.05,
                                        trans_noise=0.05)[0]


@functools.lru_cache(maxsize=None)
def _config5_shape(robots: int) -> tuple[int, int, int]:
    """(n_max, e_max, Kinc) of config #5's graph over ``robots``
    contiguous robots at r = 5."""
    part = partition.partition_contiguous(_config5_meas(), robots)
    graph, meta = rbcd.build_graph(part, 5, torch.float32, "cpu")
    return meta.n_max, meta.e_max, graph.inc_slot.shape[-1]


def _plan(robots, kernel, sms=SMS):
    n_max, e_max, kinc = _config5_shape(robots)
    return rk.cluster_plan(n_max, e_max, kinc, 5, 3, kernel, agents=robots,
                           sms=sms)


@pytest.mark.parametrize("robots", [1, 2, 4, 6])
def test_config5_over_few_robots_takes_the_grid_route(robots):
    # 16,670-100,000 poses an agent: no spread of 16 CTAs holds one (its
    # three shared vectors), so B2 and B4 spread over the whole card, C =
    # 132 // robots CTAs an agent of ceil(n_max / C) poses, in stripes of
    # 96 poses (512 threads, six 5-lane poses a warp); B1 and B3 keep the
    # workspace route there.
    n_max, e_max, kinc = _config5_shape(robots)
    assert n_max == -(-100_000 // robots) + (3 if robots == 6 else 0)
    C = SMS // robots
    P = -(-n_max // C)
    for kernel in rk.GRID_KERNELS:
        plan = _plan(robots, kernel)
        assert plan == rk.ClusterPlan("grid", C, P, 512, 4 * 16 * 4,
                                      -(-P // 96))
        assert plan == rk.grid_shape(5, 3, n_max, C)
        assert rk._spread_plan(n_max, 5, 3, robots, SMS) is None
    for kernel in ("rtr", "tcg"):
        assert _plan(robots, kernel) == rk._workspace_plan(
            n_max, e_max, 5, 3, kernel)
    # At four robots: 33 CTAs of 758 poses, 8 stripes (config #5's spread
    # at 64 robots: 797 poses, 9 stripes).
    if robots == 4:
        assert (C, P, plan.stripes) == (33, 758, 8)


# The plans of config #5's graph at 7, 8 and 64 robots before the grid
# route existed: spread, as they were.
@pytest.mark.parametrize("robots,plan", [
    (7, rk.ClusterPlan("spread", 16, 894, 512, 222752, 10, 1)),
    (8, rk.ClusterPlan("spread", 16, 782, 512, 195872, 9, 1)),
    (64, rk.ClusterPlan("spread", 2, 797, 512, 192304, 9, 1)),
])
def test_config5_over_more_robots_keeps_its_spread_plan(robots, plan):
    for kernel in rk.KERNELS:
        assert _plan(robots, kernel) == plan


@pytest.mark.parametrize("kernel", list(rk.KERNELS))
def test_the_grid_takes_only_what_the_workspace_route_took(kernel,
                                                           monkeypatch):
    # Over a sweep of agent sizes, ranks, d and team sizes, the plan equals
    # the plan without a grid route (cluster, spread, else workspace)
    # wherever that was not the workspace route; where it was, B2 and B4
    # take the grid at r <= 512 and up to one agent an SM, the rest keep
    # it.
    shapes = [(n, r, d, A) for n in (40, 300, 1594, 5000, 14290, 16670,
                                     25000, 100_000)
              for r, d in ((3, 3), (5, 3), (10, 3), (2, 2), (10, 2),
                           (11, 3), (73, 3), (512, 3), (513, 3), (1636, 3))
              for A in (1, 4, 64, 133)]
    with_grid = {s: rk.cluster_plan(s[0], 3 * s[0], 7, s[1], s[2], kernel,
                                    agents=s[3], sms=SMS) for s in shapes}
    monkeypatch.setattr(rk, "_grid_plan", lambda *a, **k: None)
    grids = 0
    for (n, r, d, A), plan in with_grid.items():
        before = rk.cluster_plan(n, 3 * n, 7, r, d, kernel, agents=A,
                                 sms=SMS)
        if before.route != "workspace":
            assert plan == before
        elif kernel in rk.GRID_KERNELS and r <= rk.MAX_LANE_RANK and A <= SMS:
            assert plan == rk.grid_shape(r, d, n, SMS // A)
            grids += 1
        else:
            assert plan == before
    assert (grids > 0) == (kernel in rk.GRID_KERNELS)


def test_forced_grid_checks_its_shape():
    # Only B2 and B4 have the grid route; a forced grid must be resident
    # (at most one CTA an SM over all agents), hold a pose's lanes in one
    # CTA (r <= 512) and index its poses (2**20 an agent).
    assert rk._route(None, 25000, 33815, 7, 5, 3, "rtr_full", agents=4,
                     grid=33) == rk.grid_shape(5, 3, 25000, 33)
    assert rk._route(None, 25000, 33815, 7, 5, 3, "rtr_refine_full",
                     agents=4, grid=33) == rk.grid_shape(5, 3, 25000, 33)
    for kernel in ("rtr", "tcg"):
        with pytest.raises(ValueError, match="no grid route"):
            rk._route(None, 25000, 33815, 7, 5, 3, kernel, agents=4, grid=33)
    with pytest.raises(ValueError, match="cannot be resident"):
        rk._route(None, 25000, 33815, 7, 5, 3, "rtr_full", agents=4, grid=34)
    with pytest.raises(ValueError, match="cannot be resident"):
        rk._route(None, 25000, 33815, 7, 5, 3, "rtr_full", agents=4, grid=0)
    with pytest.raises(ValueError, match="r <= 512"):
        rk._route(None, 32, 100, 5, 513, 3, "rtr_full", agents=2, grid=16)
    with pytest.raises(ValueError, match="at most 1048576 poses"):
        rk._route(None, 2 ** 20 + 1, 10, 5, 5, 3, "rtr_full", agents=1,
                  grid=132)
    with pytest.raises(ValueError, match="one route"):
        rk._route(None, 25000, 33815, 7, 5, 3, "rtr_full", agents=4,
                  spread=2, grid=33)
    # On CPU tensors a forced grid the card could not hold raises too.
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="cannot be resident"):
        rk._plan(dev, None, 25000, 33815, 7, 5, 3, "rtr_full", agents=4,
                 grid=34)
    assert rk._plan(dev, None, 25000, 33815, 7, 5, 3, "rtr_full",
                    agents=4) is None


def test_grid_workspace_floats_mirror_the_launcher():
    # dpgo_rtr_grid_workspace_floats at config #5 over four robots (r = 5,
    # d = 3, C = 33, P = 758, Kinc 7): every loop vector in the workspace,
    # 10 (B2) or 12 (B4, with D and Rc) of [C P][20] floats; the factor and
    # curvature records [C P][12 + 12]; each CTA's edge records [Kinc][P]
    # [16]; B4's reference residuals [E][r (d + 1)]; the ints [C P][1 + 3
    # Kinc]; rounded to float4s, then the reduction buffers [2][C][4] and
    # the arrival counter.
    C, P, kinc, e_max = 33, 758, 7, 33815
    ints = C * P * (1 + 3 * kinc)
    base = 24 * C * P + C * kinc * P * 16 + ints
    head = 2 * C * 4 + 4
    assert rk.grid_workspace_floats(5, 3, 25000, e_max, kinc, C) == \
        -(-(10 * C * P * 20 + base) // 4) * 4 + head == 8_955_280
    assert rk.grid_workspace_floats(5, 3, 25000, e_max, kinc, C,
                                    "rtr_refine_full") == \
        -(-(12 * C * P * 20 + base + e_max * 20) // 4) * 4 + head
    # d = 2, r = 3: a pose's rows are 9 floats, padded to 12 (three float4s,
    # odd); the factor 6 -> 8, S 4, an edge record 4 + 2 + 2 = 8.
    C, P = 66, 758
    assert rk.grid_workspace_floats(3, 2, 50000, 70000, 8, C) == \
        -(-(10 * C * P * 12 + 12 * C * P + C * 8 * P * 8
            + C * P * 25) // 4) * 4 + 2 * C * 4 + 4
    with pytest.raises(ValueError, match="no grid route"):
        rk.grid_workspace_floats(5, 3, 25000, e_max, kinc, 33, "rtr")
