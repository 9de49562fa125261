"""The spread route of kernels B1-B4 on the host
(``dpgo_tpu_torch.ops.rtr_kernel.cluster_plan`` and ``spread_shape``): the
route across the cluster ceiling at BASELINE.md config #5's shape and the
stripe and shared-memory formula at its boundary
(``test_torch_rtr_plan_solve.py`` holds the solve at agents above the old
ceiling against the JAX package's).  The kernels themselves run only on
the card (``test_torch_cuda.py``)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dpgo_tpu_torch.ops import rtr_kernel as rk

#: Config #5's per-agent shape (100,000 poses over 64 robots, seed 11:
#: ``rbcd.build_graph`` gives n_max 1594, e_max 2236, Kinc 7) and the
#: stand-in's (2500 poses over 8 robots: n_max 316, e_max 920, Kinc 11).
CONFIG5 = dict(n_max=1594, e_max=2236, kinc=7, agents=64)
STANDIN = dict(n_max=316, e_max=920, kinc=11, agents=8)


# (r, shape, SMs, route, C, P): across the ceiling.  At r = 5 a CTA holds at
# most 96 poses (512 threads, 6 poses a warp), so 16 CTAs hold 1536 and
# 1537 spill over; config #5 at r = 5 spreads over 132 // 64 = 2 CTAs per
# agent (128 CTAs on 132 SMs), 16 // 64 -> 1 on a card of 16 SMs is raised
# to the 2 that shared memory needs, and at r = 7 (28 floats a row, three
# vectors of 797 poses would take 268,816 B) to 3; at r = 3 it keeps a
# 16-CTA cluster; the stand-in keeps its 8-CTA cluster of 40 poses.
@pytest.mark.parametrize("kernel", rk.SPREAD_KERNELS)
@pytest.mark.parametrize("r,shape,sms,route,C,P", [
    (5, CONFIG5, 132, "spread", 2, 797),
    (7, CONFIG5, 132, "spread", 3, 532),
    (5, CONFIG5, 16, "spread", 2, 797),
    (5, dict(CONFIG5, agents=16), 132, "spread", 8, 200),
    (3, CONFIG5, 132, "cluster", 16, 100),
    (5, dict(CONFIG5, n_max=1536), 132, "cluster", 16, 96),
    (5, dict(CONFIG5, n_max=1537), 132, "spread", 2, 769),
    (5, STANDIN, 132, "cluster", 8, 40),
])
def test_route_across_the_cluster_ceiling(kernel, r, shape, sms, route, C,
                                          P):
    plan = rk.cluster_plan(shape["n_max"], shape["e_max"], shape["kinc"], r,
                           3, kernel, agents=shape["agents"], sms=sms)
    assert (plan.route, plan.C, plan.P) == (route, C, P)
    assert plan.smem_bytes <= rk.MAX_SMEM_BYTES
    assert plan.C * plan.P >= shape["n_max"]
    if route == "spread":
        assert plan == rk.spread_shape(r, 3, shape["n_max"], C)
        assert plan.threads == rk.SPREAD_THREADS
        groups = plan.threads // 32 * (32 // r)
        assert plan.stripes == -(-plan.P // groups) > 1
        # The four kernels share the spread shape above the ceiling.
        for other in rk.KERNELS:
            assert rk.cluster_plan(shape["n_max"], shape["e_max"],
                                   shape["kinc"], r, 3, other,
                                   agents=shape["agents"], sms=sms) == plan
    else:
        assert plan == rk.cluster_shape(r, 3, shape["n_max"], shape["kinc"],
                                        C, kernel)
    if shape is STANDIN:
        smem = (105792 if kernel == "rtr_refine_full"
                else rk.cluster_shape(5, 3, 316, 11, 8).smem_bytes)
        assert plan == rk.ClusterPlan("cluster", 8, 40, 224, smem)


@pytest.mark.parametrize("P,threads,stripes", [(96, 512, 1), (97, 512, 2),
                                               (192, 512, 2), (193, 512, 3),
                                               (10, 64, 1)])
def test_stripes_and_shared_memory_at_the_boundary(P, threads, stripes):
    # r = 5: 6 lane groups a warp, 96 in 512 threads; one CTA (C = 1) of P
    # poses.  Shared memory: delta twice and z, [P, 20] floats each, and
    # two buffers of 4 floats per warp.
    plan = rk.spread_shape(5, 3, P, 1)
    assert (plan.P, plan.threads, plan.stripes) == (P, threads, stripes)
    assert plan.smem_bytes == 4 * (3 * P * 20 + 2 * (threads // 32) * 4)
    # Every pose slot in exactly one stripe of one lane group.
    groups = threads // 32 * 6
    slots = [s * groups + g for s in range(stripes) for g in range(groups)]
    assert sorted(x for x in slots if x < P) == list(range(P))
    # The cluster route holds 96 such poses in one CTA and not 97.
    assert rk._fits(rk.cluster_shape(5, 3, P, 7, 1)) == (P <= 96)


def test_forced_spread_checks_its_shape():
    # Every kernel has the spread route, at B2's shape; an unknown kernel
    # has none.
    for kernel in ("rtr", "tcg"):
        assert rk._route(None, 1594, 2236, 7, 5, 3, kernel, spread=2) == \
            rk._route(None, 1594, 2236, 7, 5, 3, "rtr_full", spread=2)
    with pytest.raises(ValueError, match="unknown kernel"):
        rk._route(None, 1594, 2236, 7, 5, 3, "rtr_fast", spread=2)
    with pytest.raises(ValueError, match="cannot hold"):
        rk._route(None, 1594, 2236, 7, 5, 3, "rtr_full", spread=1)
    with pytest.raises(ValueError, match="one route"):
        rk._route(0, 1594, 2236, 7, 5, 3, "rtr_full", spread=2)
    assert rk._route(None, 1594, 2236, 7, 5, 3, "rtr_full",
                     spread=4) == rk.spread_shape(5, 3, 1594, 4)


def test_spread_timing_needs_the_card_and_no_jax(monkeypatch):
    # The timing script of the spread route measures the card only, and
    # imports neither JAX nor the JAX package.
    from dpgo_tpu_torch.experiments import spread_timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spread_timing.main([])
    code = ("import sys; import dpgo_tpu_torch.experiments.spread_timing; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dpgo_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
