"""The cluster route's folded layout of B2 and B4 at 11 <= r <= 32 on the
host (``dpgo_tpu_torch.ops.rtr_kernel``): a pose's rows folded over an
aligned segment of L = 8 or 16 lanes (``csrc/rtr_cluster.cu``'s fold
section).

* the folded shape's mirror (``cluster_fold_shape``) at the stand-ins'
  agents against the launcher's formula, as written here;
* ``cluster_plan``'s layout at every ``high_ranks`` shape up to r = 32,
  held to the rule measured on the card (``FOLD_RULE``);
* B1 and B3 plan there exactly as before the folded layout existed, and B2
  and B4 outside 11 <= r <= 32 too;
* on CPU tensors the wrappers run their plain versions, a forced layout
  included, and a forced layout that cannot hold the agent raises.

The kernels run only on the card (``test_torch_cuda.py``).
"""

import pytest
import torch

from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements

import numpy as np

#: Per-agent shapes (n_max, e_max, Kinc, d, agents) of the stand-ins
#: (PERF.md section 4): sphere2500's over 8 robots, the SE(2) stand-in's at
#: city10000's size over 32; and a 120-pose agent over 4.
STANDINS = {"sphere2500": (316, 920, 11, 3, 8),
            "se2_city10000": (328, 1019, 11, 2, 32),
            "mid_d3": (120, 260, 8, 3, 4),
            "config5": (1594, 2236, 7, 3, 64)}
#: The high_ranks shapes up to r = 32 (chip_smoke.py times the layouts
#: there in turns).
HIGH = [("sphere2500", r) for r in (11, 12, 16, 17, 32)] + [
    ("se2_city10000", r) for r in (11, 32)]


def _vec_stride(rk_floats):
    """rtr_cluster.cu's vec_stride: whole float4s, an odd count of them."""
    s = (rk_floats + 3) // 4
    return 4 * s if s % 2 else 4 * s + 4


def _launcher_formula(r, d, n, kinc, C, L, refine_kernel):
    """rtr_cluster.cu's fold_shape: P = ceil(n / C) poses a CTA, 32 / L
    poses a warp; 10 shared vectors (12 for B4) of P poses, the factors and
    S, the payload of d d + d + 3 fields (plus r (d + 1) reference
    residuals for B4) by Kinc entries by P, and two buffers of 4 floats a
    warp of the cluster."""
    P = -(-n // C)
    threads = -(-P // (32 // L)) * 32
    k = d + 1
    vecs = 12 if refine_kernel else 10
    fields = d * d + d + 3 + (r * k if refine_kernel else 0)
    floats = (vecs * P * _vec_stride(r * k) + (k * k + d * d) * P
              + fields * kinc * P + 2 * C * (threads // 32) * 4)
    return P, threads, 4 * floats


#: The folded plans the layout takes at the stand-ins (where, r, kernel):
#: (L, C, P, threads, bytes a CTA).
FOLD_PLANS = {
    ("sphere2500", 11, "rtr_full"): (8, 8, 40, 320, 103360),
    ("sphere2500", 11, "rtr_refine_full"): (8, 8, 40, 320, 194880),
    ("sphere2500", 12, "rtr_full"): (8, 8, 40, 320, 116160),
    ("sphere2500", 12, "rtr_refine_full"): (8, 8, 40, 320, 217280),
    ("sphere2500", 16, "rtr_refine_full"): (8, 16, 20, 160, 139360),
    ("se2_city10000", 11, "rtr_full"): (8, 8, 41, 352, 80224),
    ("se2_city10000", 11, "rtr_refine_full"): (8, 8, 41, 352, 151564),
}


@pytest.mark.parametrize("where,r,kernel", list(FOLD_PLANS))
def test_fold_shape_matches_the_launcher_formula(where, r, kernel):
    n, _, kinc, d, _ = STANDINS[where]
    L, C, P, threads, smem = FOLD_PLANS[where, r, kernel]
    plan = rk.layout_plan(L, n, kinc, r, d, kernel)
    assert plan == rk.ClusterPlan("cluster", C, P, threads, smem, 1,
                                  -(-r // L), L)
    refine_kernel = kernel == "rtr_refine_full"
    for lanes in rk.FOLD_LANES:
        for c in rk.CLUSTER_SIZES:
            shape = rk.cluster_fold_shape(r, d, n, kinc, c, lanes, kernel)
            assert (shape.P, shape.threads, shape.smem_bytes) == \
                _launcher_formula(r, d, n, kinc, c, lanes, refine_kernel)
            assert (shape.C, shape.folds, shape.lanes) == (
                c, -(-r // lanes), lanes)


#: The layout the plan takes at each high_ranks shape up to r = 32, by the
#: rule measured on the card (``rk.FOLD_RULE``): "lanes_8" / "lanes_16" the
#: folded layout, "spread" the spread route.  L = 8 where a cluster of at
#: most 8 CTAs of it fits; else L = 16; else the spread route.
MEASURED = {
    ("sphere2500", 11): {"rtr_full": "lanes_8", "rtr_refine_full": "lanes_8"},
    ("sphere2500", 12): {"rtr_full": "lanes_8", "rtr_refine_full": "lanes_8"},
    ("sphere2500", 16): {"rtr_full": "lanes_8",
                         "rtr_refine_full": "lanes_16"},
    ("sphere2500", 17): {"rtr_full": "lanes_8",
                         "rtr_refine_full": "lanes_16"},
    ("sphere2500", 32): {"rtr_full": "lanes_16", "rtr_refine_full": "spread"},
    ("se2_city10000", 11): {"rtr_full": "lanes_8",
                            "rtr_refine_full": "lanes_8"},
    ("se2_city10000", 32): {"rtr_full": "lanes_8",
                            "rtr_refine_full": "lanes_16"},
}


@pytest.mark.parametrize("kernel", rk.FOLD_KERNELS)
@pytest.mark.parametrize("where,r", HIGH)
def test_plan_takes_the_measured_layout(where, r, kernel):
    n, e, kinc, d, agents = STANDINS[where]
    plan = rk.cluster_plan(n, e, kinc, r, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    want = MEASURED[where, r][kernel]
    if want == "spread":
        assert plan == rk._spread_plan(n, r, d, agents, rk.H100_SMS)
        assert all(rk.layout_plan(L, n, kinc, r, d, kernel) is None
                   for L in rk.FOLD_LANES)
        return
    lanes = int(want.removeprefix("lanes_"))
    assert plan == rk.layout_plan(lanes, n, kinc, r, d, kernel)
    assert plan.route == "cluster" and plan.lanes == lanes
    if lanes == 16:  # L = 8 takes a 16-CTA cluster here, or none
        eight = rk.layout_plan(8, n, kinc, r, d, kernel)
        assert eight is None or eight.C == 16
    else:
        assert plan.C <= 8
    # The folded layout fits wherever the row-a-lane layout does.
    assert rk.layout_plan(16, n, kinc, r, d, kernel) is not None or \
        rk.layout_plan(0, n, kinc, r, d, kernel) is None


#: The plans before the folded layout existed (route, C, P, threads,
#: bytes, stripes, folds), by (where, r): B1 and B3 (``tcg``, ``rtr``,
#: sharing B2's shape) at every high_ranks shape up to r = 32, and B2 and
#: B4 just outside 11 <= r <= 32 and at config #5.
BEFORE = {
    ("sphere2500", 11): ("cluster", 16, 20, 320, 55520, 1, 1),
    ("sphere2500", 12): ("cluster", 16, 20, 320, 61920, 1, 1),
    ("sphere2500", 16): ("cluster", 16, 20, 320, 74720, 1, 1),
    ("sphere2500", 17): ("spread", 16, 20, 512, 24512, 2, 1),
    ("sphere2500", 32): ("spread", 16, 20, 512, 39872, 2, 1),
    ("se2_city10000", 11): ("cluster", 16, 21, 352, 45280, 1, 1),
    ("se2_city10000", 32): ("spread", 4, 82, 512, 100448, 6, 1),
}
BEFORE_B2_B4 = {
    ("sphere2500", 10): {"rtr_full": ("cluster", 8, 40, 448, 104384, 1, 1),
                         "rtr_refine_full": ("cluster", 8, 40, 448, 188864,
                                             1, 1)},
    ("sphere2500", 33): {k: ("spread", 16, 20, 512, 40384, 3, 1)
                         for k in rk.FOLD_KERNELS},
    ("se2_city10000", 10): {"rtr_full": ("cluster", 8, 41, 448, 80992, 1, 1),
                            "rtr_refine_full": ("cluster", 8, 41, 448,
                                                146920, 1, 1)},
    ("mid_d3", 33): {"rtr_full": ("cluster", 16, 8, 512, 55584, 1, 1),
                     "rtr_refine_full": ("cluster", 16, 8, 512, 97824, 1,
                                         1)},
    ("config5", 11): {k: ("spread", 4, 399, 512, 212720, 13, 1)
                      for k in rk.FOLD_KERNELS},
    ("config5", 18): {k: ("spread", 7, 228, 512, 211520, 15, 1)
                      for k in rk.FOLD_KERNELS},
}


@pytest.mark.parametrize("kernel", ["tcg", "rtr"])
@pytest.mark.parametrize("where,r", HIGH)
def test_b1_and_b3_plan_as_before(where, r, kernel):
    n, e, kinc, d, agents = STANDINS[where]
    plan = rk.cluster_plan(n, e, kinc, r, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    assert tuple(plan) == (*BEFORE[where, r], 0)


@pytest.mark.parametrize("kernel", rk.FOLD_KERNELS)
@pytest.mark.parametrize("where,r", list(BEFORE_B2_B4))
def test_b2_and_b4_plan_as_before_where_no_fold_applies(where, r, kernel):
    # Outside 11 <= r <= 32 the rule is empty; config #5's 1594-pose agents
    # fit no folded cluster (100 poses a CTA at L = 8 take 25 warps).
    n, e, kinc, d, agents = STANDINS[where]
    assert rk.fold_rule(r) == () or all(
        rk.layout_plan(L, n, kinc, r, d, kernel) is None
        for L in rk.FOLD_LANES)
    plan = rk.cluster_plan(n, e, kinc, r, d, kernel, agents=agents,
                           sms=rk.H100_SMS)
    assert tuple(plan) == (*BEFORE_B2_B4[where, r][kernel], 0)


def _b2_and_b4_ops(r, d=3, n=24, A=2, num_lc=10):
    """B2's and B4's operands at the chordal init of a small problem on
    the CPU (B4 recentered there, a random correction), with options."""
    meas = make_measurements(np.random.default_rng(3), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    params = AgentParams(d=d, r=r, num_robots=A)
    prob = rbcd.prepare_problem(meas, A, params, device="cpu")
    g, m = prob.graph, prob.meta
    Z = rbcd.neighbor_buffer(rbcd.public_table(prob.X0, g), g)
    chol = rbcd.precond_chol(g.edges, g, params)
    b2 = rbcd.kernel_operands(prob.X0, Z, g.edges, chol, g)
    Xg = rbcd.gather_to_global(prob.X0, g, n).double().numpy()
    ref = refine.recenter(Xg, g, m, params, refine.host_edges_f64(meas))
    gen = torch.Generator().manual_seed(4)
    D = 1e-3 * torch.randn(ref.consts.R.shape, generator=gen,
                           dtype=ref.consts.R.dtype)
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, g), g)
    b4 = refine.refine_kernel_operands(D, Dz, ref.consts, g)
    return b2, b4, rbcd.kernel_options(params, m)


@pytest.mark.parametrize("lanes", rk.FOLD_LANES)
def test_cpu_wrappers_run_the_plain_version_on_a_forced_layout(lanes):
    # On CPU tensors B2 and B4 run their plain versions, a folded layout
    # forced or not, and count no launch.
    b2, b4, kw = _b2_and_b4_ops(11)
    before = (rk.LAUNCHES, rk.REFINE_LAUNCHES, dict(rk.FOLD_LAUNCHES))
    for fn, ref_fn, ops in ((rk.rtr_full, rk.rtr_full_reference, b2),
                            (rk.rtr_refine_full,
                             rk.rtr_refine_full_reference, b4)):
        ref = ref_fn(*ops, **kw)
        for opts in ({}, {"_lanes": lanes}, {"_lanes": lanes,
                                              "_cluster": 2}):
            out = fn(*ops, **opts, **kw)
            for got, want in zip(out, ref):
                assert torch.equal(got, want)
        assert all(bool(torch.isfinite(t).all()) for t in ref
                   if t.is_floating_point())
    assert (rk.LAUNCHES, rk.REFINE_LAUNCHES,
            dict(rk.FOLD_LAUNCHES)) == before


@pytest.mark.parametrize("kernel", rk.FOLD_KERNELS)
def test_forced_layout_that_cannot_hold_the_agent_raises(kernel):
    # One CTA of the stand-in's 316 poses at L = 8 needs 79 warps: forced,
    # it raises naming P, the threads and the bytes; B4 at (32, 3) fits no
    # cluster of either width; a folded layout exists only for B2 and B4
    # at 11 <= r <= 32, at L = 8 or 16.
    n, e, kinc, d, agents = STANDINS["sphere2500"]
    with pytest.raises(ValueError, match="P = 316, 2528 threads"):
        rk._route(1, n, e, kinc, 11, d, kernel, agents=agents, lanes=8)
    assert rk._route(8, n, e, kinc, 11, d, kernel, agents=agents,
                     lanes=8) == rk.layout_plan(8, n, kinc, 11, d, kernel)
    if kernel == "rtr_refine_full":
        with pytest.raises(ValueError, match="no cluster of the 8-lane"):
            rk._route(None, n, e, kinc, 32, d, kernel, lanes=8)
    for r, lanes in ((10, 8), (33, 8), (11, 4), (11, 32)):
        with pytest.raises(ValueError, match="no folded cluster layout"):
            rk._route(None, n, e, kinc, r, d, kernel, lanes=lanes)
    for other in ("rtr", "tcg"):
        with pytest.raises(ValueError, match="no folded cluster layout"):
            rk._route(None, n, e, kinc, 11, d, other, lanes=8)
    with pytest.raises(ValueError, match="not with a spread"):
        rk._route(None, n, e, kinc, 11, d, kernel, spread=16, lanes=8)


def test_fold_parts_build_after_the_generic_part():
    # rtr_cluster.cu compiles its folded layout in parts of its own, one
    # per segment width, after its generic part; the other sources have
    # none, and the library's name follows the parts.
    assert rk.FOLD_PARTS == {"rtr_cluster.cu": len(rk.FOLD_LANES)}
    assert set(rk.FOLD_PARTS) <= {src.name for src in rk.SOURCES}
    assert "dpgo_rtr_full_cluster_fold_launch" in rk.SYMBOLS
    assert "dpgo_rtr_refine_full_cluster_fold_launch" in rk.SYMBOLS
