"""The port's CUDA kernels on the card, against their plain PyTorch
versions (``dpgo_tpu_torch.ops.rtr_kernel``), the launch counts of the
solve, of a GREEDY round and of the refinement, fused segments and verdict
windows free of host syncs, the verdict loop against the per-eval loop,
and the certificate on the card: the sync-free small decompositions
against ``torch.linalg``, the device payload against the same payload
computed on the CPU in float64, and the certified epilogue free of host
syncs.  Every test needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                   RobustCostType, Schedule, SolverParams)
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.models import certify, local_pgo, rbcd, refine
from dpgo_tpu_torch.ops import manifold, quadratic, smallmat
from dpgo_tpu_torch.types import edge_set_from_measurements
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements

pytestmark = pytest.mark.cuda

#: Every (d, r) the kernels are instantiated for as templated shapes
#: (``csrc/shapes.cuh``): the rank staircase's d = 3 with 3 <= r <= 10 and
#: d = 2 with 2 <= r <= 10.
SHAPES = ([(3, r) for r in range(3, 11)]
          + [(2, r) for r in range(2, 11)])
#: Ranks of the rank-generic instantiation the card tests hold (every
#: r >= 11): a pose of r lanes (r <= 32, one or two poses a warp) and a
#: pose over two, three and four warps.
GENERIC_SHAPES = [(3, 11), (3, 17), (3, 33), (2, 17), (2, 33), (3, 73),
                  (3, 128)]
#: Ranks past four warps a pose, on 16-pose agents: five and eight warps
#: (clusters), 16 (the cluster route's cap, r = 512), the first rank past
#: it (B1-B4 on the spread route, two rows a lane) and the top ranks the
#: JAX package's VMEM gate admits at 16-pose agents (3360 at d = 3, 4482
#: at d = 2).
TOP_SHAPES = [(3, 129), (3, 256), (3, 512), (3, 513), (3, 3360), (2, 4482)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _round(card, d=3, r=5, n=60, A=4, num_lc=20):
    meas = make_measurements(np.random.default_rng(5), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    params = AgentParams(d=d, r=r, num_robots=A)
    prob = rbcd.prepare_problem(meas, A, params, device=card)
    g, m, X = prob.graph, prob.meta, prob.X0
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
    chol = rbcd.precond_chol(g.edges, g, params)
    return prob, params, X, Z, chol


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_full_kernel_matches_plain_version(card, d, r):
    prob, params, X, Z, chol = _round(card, d=d, r=r)
    args = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, prob.meta)
    before = rk.LAUNCHES
    out = rk.rtr_full(*args, **kw)
    ref = rk.rtr_full_reference(*args, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    assert float((out.X - ref.X).abs().max()) <= 1e-4
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref.stats[:, 2:],
                               rtol=1e-4, atol=0)


def _b3_args(prob, X, Z, chol):
    g, _, S = rbcd.gradient_pass(X, prob.graph, prob.meta)
    return rbcd.b3_operands(X, Z, g, S, prob.graph.edges, chol, prob.graph)


def _b3_kw(params, meta):
    kw = rbcd.kernel_options(params, meta)
    kw.pop("grad_tol")
    return kw


def _assert_b3_matches(out, ref):
    assert float((out.X - ref.X).abs().max()) <= 1e-4
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref.stats[:, 2:],
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_kernel_matches_plain_version(card, d, r):
    prob, params, X, Z, chol = _round(card, d=d, r=r)
    args = _b3_args(prob, X, Z, chol)
    kw = _b3_kw(params, prob.meta)
    before = rk.RTR_LAUNCHES
    out = rk.rtr(*args, **kw)
    ref = rk.rtr_reference(*args, **kw)
    torch.cuda.synchronize()
    assert rk.RTR_LAUNCHES == before + 1
    _assert_b3_matches(out, ref)


def test_rtr_kernel_payload_too_large_for_shared_memory(card):
    # The workspace route (one CTA per agent) with its payload in device
    # memory.
    prob, params, X, Z, chol = _round(card, n=2000, A=1, num_lc=2000)
    assert prob.meta.e_max * 64 > 232448
    args = _b3_args(prob, X, Z, chol)
    kw = _b3_kw(params, prob.meta)
    out = rk.rtr(*args, _cluster=0, **kw)
    ref = rk.rtr_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_b3_matches(out, ref)


def _b3_launch_holds(card, r):
    """B3 at rank r on 2 agents of 20 poses: the rank-generic
    instantiation, one launch, at the gates of its plain version."""
    prob, params, X, Z, chol = _round(card, d=3, r=r, A=2, n=40, num_lc=10)
    args, kw = _b3_args(prob, X, Z, chol), _b3_kw(params, prob.meta)
    before = rk.RTR_LAUNCHES
    out = rk.rtr(*args, **kw)
    torch.cuda.synchronize()
    assert rk.RTR_LAUNCHES == before + 1
    _assert_b3_matches(out, rk.rtr_reference(*args, **kw))


def test_rtr_kernel_runs_at_rank_129(card):
    # r = 129, past the four-warp pose of r = 128: a cluster of five-warp
    # poses.
    _b3_launch_holds(card, 129)


def test_rtr_kernel_runs_at_rank_11(card):
    # r = 11, above the staircase's default top (r_max = 10).
    _b3_launch_holds(card, 11)


def test_greedy_round_launches_once_at_one_agent(card):
    prob, _, X, _, _ = _round(card)
    params = AgentParams(d=3, r=5, num_robots=4, schedule=Schedule.GREEDY)
    plain = AgentParams(d=3, r=5, num_robots=4, schedule=Schedule.GREEDY,
                        solver=SolverParams(pallas_tcg=False))
    g, m = prob.graph, prob.meta
    state = rbcd.init_state(g, m, X, params)
    before = rk.LAUNCHES
    out = rbcd.rbcd_step(state, g, m, params)
    ref = rbcd.rbcd_step(state, g, m, plain)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    changed = (out.X != X).any(dim=(1, 2, 3))
    assert int(changed.sum()) == 1
    assert torch.equal(changed, (ref.X != X).any(dim=(1, 2, 3)))
    assert float((out.X - ref.X).abs().max()) <= 1e-4


@pytest.mark.parametrize("params,flags", [
    (AgentParams(d=3, r=5, num_robots=4, schedule=Schedule.GREEDY),
     (False, False)),
    (AgentParams(d=3, r=5, num_robots=4, schedule=Schedule.ASYNC),
     (False, False)),
    (AgentParams(d=3, r=5, num_robots=4, acceleration=True,
                 restart_interval=3), (False, True)),
    (AgentParams(d=3, r=5, num_robots=4, schedule=Schedule.COLORED,
                 robust=RobustCostParams(cost_type=RobustCostType.GNC_TLS),
                 robust_opt_warm_start=False), (True, False)),
])
def test_segment_has_no_host_sync(card, params, flags):
    prob, _, X, _, _ = _round(card)
    state = rbcd.init_state(prob.graph, prob.meta, X, params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = rbcd.rbcd_segment(state, prob.graph, 4, prob.meta, params,
                                  *flags)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.iteration == 4
    assert bool(torch.isfinite(state.X).all())


def _verdict_setup(card, K=4):
    prob, params, X, _, _ = _round(card)
    part = prob.part
    edges_g = rbcd.edge_set_from_measurements(part.meas_global,
                                              dtype=torch.float32,
                                              device=card)
    step = rbcd.make_verdict_program(
        prob.graph, edges_g, part.meas_global.num_poses,
        len(part.meas_global), False, grad_norm_tol=0.0)
    vs = rbcd.init_verdict_state(K, 4, torch.float32, False, device=card)
    return prob, params, step, vs, rbcd.init_state(prob.graph, prob.meta, X,
                                                   params)


def test_verdict_window_has_no_host_sync(card):
    """K rounds of segments and verdict steps, and the start of the word's
    copy to the host, with every host sync an error."""
    K = 4
    prob, params, step, vs, state = _verdict_setup(card, K)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(K):
            state = rbcd.rbcd_segment(state, prob.graph, 1, prob.meta,
                                      params)
            vs = step(state.X, state.weights, state.ready, state.mu,
                      state.rel_change, state.iteration, vs)
        copy = rbcd._start_fetch(vs.word)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(rbcd._host_fetch(copy)) == int(vs.word)
    assert int(vs.eval_idx) == K
    assert bool(torch.isfinite(vs.hist).all())


def test_word_fetch_waits_on_its_copy_not_the_stream(card):
    """The pinned copy's event, not the stream: the fetch returns the
    pre-speculation word while work enqueued after the copy still runs."""
    prob, params, step, vs, state = _verdict_setup(card)
    vs = step(state.X, state.weights, state.ready, state.mu,
              state.rel_change, state.iteration, vs)
    torch.cuda.synchronize()
    expect = int(vs.word)
    copy = rbcd._start_fetch(vs.word)
    torch.cuda._sleep(200_000_000)
    spec = rbcd.rbcd_segment(state, prob.graph, 1, prob.meta, params)
    spec_vs = step(spec.X, spec.weights, spec.ready, spec.mu,
                   spec.rel_change, spec.iteration, vs)
    word = int(rbcd._host_fetch(copy))
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert word == expect
    assert busy
    assert int(spec_vs.eval_idx) == 2


def test_verdict_loop_matches_per_eval_loop_bitwise(card):
    meas = make_measurements(np.random.default_rng(3), n=200, d=3,
                             num_lc=60, rot_noise=0.02,
                             trans_noise=0.02)[0]
    params = AgentParams(d=3, r=5, num_robots=4, rel_change_tol=0.0)
    kw = dict(max_iters=60, grad_norm_tol=0.05, eval_every=2)
    a = rbcd.solve_rbcd(meas, 4, params, **kw)
    before = rk.LAUNCHES
    b = rbcd.solve_rbcd(meas, 4, params, verdict_every=8, **kw)
    launches = rk.LAUNCHES - before
    assert a.cost_history == b.cost_history
    assert a.grad_norm_history == b.grad_norm_history
    assert (a.iterations, a.terminated_by) == (b.iterations, b.terminated_by)
    assert launches == rbcd.rounds_enqueued(b.iterations, max_iters=60,
                                            eval_every=2, verdict_every=8)


def test_tcg_kernel_matches_plain_version(card):
    prob, params, X, Z, chol = _round(card)
    g, m = prob.graph, prob.meta
    args = rbcd.kernel_operands(X, Z, g.edges, chol, g)
    eg = quadratic.egrad_ell(torch.cat([X, Z], dim=1), g.edges, g.inc_slot,
                             g.inc_mask)
    S = manifold.sym(X[..., :3].transpose(-1, -2) @ eg[..., :3])
    Sc = S.permute(0, 2, 3, 1).reshape(m.num_robots, 9, -1).contiguous()
    gc = rk.comp_major(manifold.rgrad(X, eg))
    for radius in (0.05, 1.0, 100.0):
        rad = torch.full((m.num_robots,), radius, device=card)
        tin = (*args[:7], Sc, args[8], gc, rad, args[9], args[10])
        kw = dict(r=5, d=3, e_max=m.e_max, max_iters=10, kappa=0.1,
                  theta=1.0)
        out = rk.tcg(*tin, **kw)
        ref = rk.tcg_reference(*tin, **kw)
        torch.cuda.synchronize()
        assert float((out.eta - ref.eta).abs().max()) <= 1e-4
        assert float((out.heta - ref.heta).abs().max()) <= 1e-3
        assert torch.equal(out.stats, ref.stats)


def test_solve_launches_kernel_once_per_round(card):
    meas = make_measurements(np.random.default_rng(3), n=200, d=3,
                             num_lc=60, rot_noise=0.02,
                             trans_noise=0.02)[0]
    before = rk.LAUNCHES
    res = rbcd.solve_rbcd(meas, 4, max_iters=30, grad_norm_tol=0.1)
    # One launch per round, the discarded speculative segment included.
    assert rk.LAUNCHES - before == rbcd.rounds_enqueued(
        res.iterations, max_iters=30, eval_every=1)
    assert res.iterations > 0
    plain = AgentParams(d=3, r=5, num_robots=4,
                        solver=SolverParams(pallas_tcg=False))
    ref = rbcd.solve_rbcd(meas, 4, plain, max_iters=res.iterations,
                          grad_norm_tol=0.0)
    assert float((res.X - ref.X).abs().max()) <= 5e-4


def test_edge_payload_too_large_for_shared_memory(card):
    # One agent with ~4000 edges on the workspace route: the payload (64 B
    # an edge at d = 3) does not fit in one block's 227 KB and lives in the
    # global workspace.
    prob, params, X, Z, chol = _round(card, n=2000, A=1, num_lc=2000)
    assert prob.meta.e_max * 64 > 232448
    args = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, prob.meta)
    out = rk.rtr_full(*args, _cluster=0, **kw)
    ref = rk.rtr_full_reference(*args, **kw)
    torch.cuda.synchronize()
    assert float((out.X - ref.X).abs().max()) <= 1e-4
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref.stats[:, 2:],
                               rtol=1e-4, atol=0)


def test_solve_runs_the_kernel_at_rank_129(card):
    # r = 129: the solve launches the kernel, as at r = 11.
    _solve_holds(card, 129)


def test_solve_runs_the_kernel_at_rank_11(card):
    _solve_holds(card, 11)


def _solve_holds(card, r):
    """B2 once per enqueued round of ``solve_rbcd`` at rank r (the
    rank-generic instantiation), and each round at the gates of the
    kernel's plain version."""
    meas = make_measurements(np.random.default_rng(5), n=40, d=3, num_lc=10,
                             rot_noise=0.05, trans_noise=0.05)[0]
    params = AgentParams(d=3, r=r, num_robots=2)
    before = rk.LAUNCHES
    res = rbcd.solve_rbcd(meas, 2, params, max_iters=4, grad_norm_tol=0.0)
    torch.cuda.synchronize()
    enqueued = rbcd.rounds_enqueued(res.iterations, params=params,
                                    max_iters=4, eval_every=1)
    assert res.iterations == 4 and rk.LAUNCHES - before == enqueued
    assert bool(torch.isfinite(res.T).all())
    assert res.cost_history[-1] < res.cost_history[0]
    prob = rbcd.prepare_problem(meas, 2, params, device=card)
    g = prob.graph
    X = prob.X0
    chol = rbcd.precond_chol(g.edges, g, params)
    kw = rbcd.kernel_options(params, prob.meta)
    for _ in range(3):
        Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
        args = rbcd.kernel_operands(X, Z, g.edges, chol, g)
        out = rk.rtr_full(*args, **kw)
        _assert_b2_matches(out, rk.rtr_full_reference(*args, **kw))
        X = rk.comp_minor(out.X, r, 4)


def _refine_operands(card, d=3, r=5, n=60, A=4, num_lc=20, rounds=20):
    """One refine round's kernel operands on the card: a few float32 JACOBI
    rounds, the handoff iterate recentered in float64, and a random
    correction made feasible (R + D on the manifold; zero on padded
    poses)."""
    meas = make_measurements(np.random.default_rng(5), n=n, d=d,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    params = AgentParams(d=d, r=r, num_robots=A, rel_change_tol=0.0,
                         solver=SolverParams(grad_norm_tol=1e-9))
    prob = rbcd.prepare_problem(meas, A, params, device=card)
    g, m = prob.graph, prob.meta
    state = rbcd.init_state(g, m, prob.X0, params)
    for _ in range(rounds):
        state = rbcd.rbcd_step(state, g, m, params)
    Xg = rbcd.gather_to_global(state.X, g, n).double().cpu().numpy()
    ref = refine.recenter(Xg, g, m, params, refine.host_edges_f64(meas))
    gen = torch.Generator(device=card).manual_seed(0)
    D = torch.randn(ref.consts.R.shape, generator=gen, device=card) * 1e-4
    D = refine._retract_d0(D * g.pose_mask[:, :, None, None].to(D.dtype),
                           ref.consts.R)
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, g), g)
    ops = refine.refine_kernel_operands(D, Dz, ref.consts, g)
    return prob, params, ref, ops


def _assert_refine_matches(out, ref_out, D_in):
    step = float((ref_out.D - D_in).abs().max())
    assert float((out.D - ref_out.D).abs().max()) <= 1e-3 * max(step, 1e-12)
    assert torch.equal(out.stats[:, :2], ref_out.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref_out.stats[:, 2:],
                               rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_refine_full_kernel_matches_plain_version(card, d, r):
    prob, params, ref, ops = _refine_operands(card, d=d, r=r)
    kw = rbcd.kernel_options(params, prob.meta)
    before = rk.REFINE_LAUNCHES
    out = rk.rtr_refine_full(*ops, **kw)
    plain = rk.rtr_refine_full_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert rk.REFINE_LAUNCHES == before + 1
    _assert_refine_matches(out, plain, ops[9])
    # Refinement rounds launch the kernel once each, for all agents.
    D0 = torch.zeros_like(ref.consts.R)
    refine.refine_rounds_accel(D0, ref.consts, prob.graph, prob.meta,
                               params, 5)
    assert rk.REFINE_LAUNCHES == before + 6


def _generic_routes(kernel, plan, n_max, r, d, kinc):
    """Every route of ``kernel`` a call can take at this shape: the planned
    one, the workspace route, the spread route and the smallest cluster
    that fits, each as the wrapper's forcing keywords."""
    routes = {"planned": {}, "workspace": {"_cluster": 0}}
    if plan.route != "spread" and rk._fits(rk.spread_shape(r, d, n_max, 2)):
        routes["spread"] = {"_spread": 2}
    fits = [C for C in rk.CLUSTER_SIZES[:4]
            if rk._fits(rk.cluster_shape(r, d, n_max, kinc, C, kernel))]
    if fits and plan.route != "cluster":
        routes["cluster"] = {"_cluster": fits[0]}
    return routes


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("d,r", GENERIC_SHAPES)
def test_generic_rank_kernels_match_plain_versions(card, d, r, size):
    # "small": 15-pose agents (a cluster is planned); "large": 300-pose
    # agents (B1-B4 spread above r = 16).
    _hold_generic_kernels(card, d, r, *((60, 4, 20) if size == "small"
                                         else (600, 2, 200)))


@pytest.mark.parametrize("d,r", TOP_SHAPES)
def test_generic_rank_kernels_match_plain_versions_above_rank_128(card, d,
                                                                  r):
    # 16-pose agents: clusters up to r = 512 (five, eight, 16 warps a
    # pose), a spread of 16-warp poses at r = 512; from r = 513 B1-B4
    # spread with a pose's rows folded over 16 warps.
    _hold_generic_kernels(card, d, r, 32, 2, 10)
    if r > rk.MAX_LANE_RANK:
        for kernel in rk.KERNELS:
            plan = rk.cluster_plan(16, 24, 5, r, d, kernel, agents=2,
                                   sms=rk.sm_count(card))
            assert (plan.route, plan.folds) == ("spread", -(-r // 512))


def _hold_generic_kernels(card, d, r, n, A, num_lc):
    """B1-B4 of the rank-generic instantiation on every route the planner
    or a forced route reaches, against their plain versions at the
    single-launch gates; one launch each."""
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=n, A=A,
                                      num_lc=num_lc)
    m = prob.meta
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, m)
    b3, kw3 = _b3_args(prob, X, Z, chol), _b3_kw(params, m)
    tkw = {k: kw[k] for k in ("r", "d", "e_max", "max_iters", "kappa",
                              "theta")}
    b1 = (*b3[:7], b3[8], b3[9], b3[10], torch.ones(A, device=card), b3[11],
          b3[12])
    K = b2[9].shape[-1]
    checks = {"rtr_full": (b2, kw, _assert_b2_matches),
              "rtr": (b3, kw3, _assert_b3_matches)}
    for kernel, (args, k, check) in checks.items():
        fn, ref_fn = ((rk.rtr_full, rk.rtr_full_reference)
                      if kernel == "rtr_full" else (rk.rtr, rk.rtr_reference))
        ref = ref_fn(*args, **k)
        plan = rk.cluster_plan(m.n_max, m.e_max, K, r, d, kernel, agents=A,
                               sms=rk.sm_count(card))
        for opts in _generic_routes(kernel, plan, m.n_max, r, d,
                                    K).values():
            out = fn(*args, **opts, **k)
            torch.cuda.synchronize()
            check(out, ref)
    tref = rk.tcg_reference(*b1, **tkw)
    plan = rk.cluster_plan(m.n_max, m.e_max, K, r, d, "tcg", agents=A,
                           sms=rk.sm_count(card))
    before = rk.TCG_LAUNCHES
    routes = _generic_routes("tcg", plan, m.n_max, r, d, K)
    for opts in routes.values():
        out = rk.tcg(*b1, **opts, **tkw)
        torch.cuda.synchronize()
        assert float((out.eta - tref.eta).abs().max()) <= 1e-4
        assert float((out.heta - tref.heta).abs().max()
                     / tref.heta.abs().max()) <= 1e-4
        assert torch.equal(out.stats, tref.stats)
    assert rk.TCG_LAUNCHES == before + len(routes)
    # B4 recentered at the init, from a random feasible correction.
    prob4, rparams, _, ops4 = _refine_operands(card, d=d, r=r, n=n, A=A,
                                               num_lc=num_lc, rounds=0)
    kw4 = rbcd.kernel_options(rparams, prob4.meta)
    plain4 = rk.rtr_refine_full_reference(*ops4, **kw4)
    plan = rk.cluster_plan(m.n_max, m.e_max, K, r, d, "rtr_refine_full",
                           agents=A, sms=rk.sm_count(card))
    before = rk.REFINE_LAUNCHES
    routes = _generic_routes("rtr_refine_full", plan, m.n_max, r, d, K)
    for opts in routes.values():
        out = rk.rtr_refine_full(*ops4, **opts, **kw4)
        torch.cuda.synchronize()
        _assert_refine_matches(out, plain4, ops4[9])
    assert rk.REFINE_LAUNCHES == before + len(routes)


def test_refine_payload_too_large_for_shared_memory(card):
    # One agent with ~2000 edges on the workspace route: the refine payload
    # (144 B an edge at d = 3, r = 5) does not fit in one block's 227 KB.
    prob, params, ref, ops = _refine_operands(card, n=1000, A=1,
                                              num_lc=1000, rounds=3)
    assert prob.meta.e_max * 144 > 232448
    kw = rbcd.kernel_options(params, prob.meta)
    out = rk.rtr_refine_full(*ops, _cluster=0, **kw)
    plain = rk.rtr_refine_full_reference(*ops, **kw)
    torch.cuda.synchronize()
    _assert_refine_matches(out, plain, ops[9])


def _recentered_at_init(card, r):
    meas = make_measurements(np.random.default_rng(5), n=40, d=3, num_lc=10,
                             rot_noise=0.05, trans_noise=0.05)[0]
    params = AgentParams(d=3, r=r, num_robots=2)
    prob = rbcd.prepare_problem(meas, 2, params, device=card)
    Xg = rbcd.gather_to_global(prob.X0, prob.graph, 40).double().cpu()
    ref = refine.recenter(Xg.numpy(), prob.graph, prob.meta, params,
                          refine.host_edges_f64(meas))
    return prob, params, ref


def test_refine_rounds_run_the_kernel_at_rank_129(card):
    _refine_rounds_hold(card, 129)


def test_refine_rounds_run_the_kernel_at_rank_11(card):
    _refine_rounds_hold(card, 11)


def _refine_rounds_hold(card, r):
    """B4 once per refine round at rank r, each round at the gates of the
    kernel's plain version."""
    prob, params, ref = _recentered_at_init(card, r)
    g, m = prob.graph, prob.meta
    kw = rbcd.kernel_options(params, m)
    D = torch.zeros_like(ref.consts.R)
    before = rk.REFINE_LAUNCHES
    for _ in range(3):
        Dz = rbcd.neighbor_buffer(rbcd.public_table(D, g), g)
        ops = refine.refine_kernel_operands(D, Dz, ref.consts, g)
        out = rk.rtr_refine_full(*ops, **kw)
        _assert_refine_matches(out, rk.rtr_refine_full_reference(*ops, **kw),
                               ops[9])
        D = rk.comp_minor(out.D, r, 4)
    assert rk.REFINE_LAUNCHES == before + 3
    D3 = refine.refine_rounds(torch.zeros_like(ref.consts.R), ref.consts, g,
                              m, params, 3)
    torch.cuda.synchronize()
    assert rk.REFINE_LAUNCHES == before + 6
    assert bool(torch.isfinite(D3).all())


# ---------------------------------------------------------------------------
# The cluster route of B2 and B3 (csrc/rtr_cluster.cu)
# ---------------------------------------------------------------------------

def _cluster_operands(card, d, r, A):
    """B2's and B3's operands at the chordal init of agents of ~300 poses
    (more than one CTA holds, so that C > 1 is reached), and the keyword
    options."""
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=300 * A, A=A,
                                      num_lc=100 * A)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    return (prob, b2, rbcd.kernel_options(params, prob.meta),
            _b3_args(prob, X, Z, chol), _b3_kw(params, prob.meta))


def _placeable(prob, b2, r, d):
    """Every cluster size the card can place for this shape."""
    n, K = prob.meta.n_max, b2[9].shape[-1]
    return [C for C in rk.CLUSTER_SIZES
            if rk._fits(rk.cluster_shape(r, d, n, K, C))
            and rk.cluster_capacity(r, d, n, K, C) >= 1]


def _assert_b2_matches(out, ref):
    assert bool(torch.isfinite(out.X).all())
    assert float((out.X - ref.X).abs().max()) <= 1e-4
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref.stats[:, 2:],
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("A", [3, 1])
@pytest.mark.parametrize("d,r", SHAPES)
def test_cluster_route_matches_plain_versions_at_every_size(card, d, r, A):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, d, r, A)
    plan = rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           b2[9].shape[-1], r, d)
    assert plan.route == "cluster" and plan.C > 1
    sizes = _placeable(prob, b2, r, d)
    assert plan.C in sizes
    ref2 = rk.rtr_full_reference(*b2, **kw)
    ref3 = rk.rtr_reference(*b3, **b3_kw)
    for C in sizes:
        before = (rk.LAUNCHES, rk.RTR_LAUNCHES)
        out2 = rk.rtr_full(*b2, _cluster=C, **kw)
        out3 = rk.rtr(*b3, _cluster=C, **b3_kw)
        torch.cuda.synchronize()
        assert (rk.LAUNCHES, rk.RTR_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
        _assert_b2_matches(out2, ref2)
        _assert_b3_matches(out3, ref3)


def test_agent_above_the_cluster_limit_takes_the_workspace_route(card):
    # 4200 poses in one agent: at C = 16 a CTA would hold 263 poses, 1408
    # threads at 5 lanes a pose, more than the kernel's 512.  B2 and B3
    # take the spread route, and the workspace route when forced.
    prob, params, X, Z, chol = _round(card, n=4200, A=1, num_lc=1000)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, prob.meta)
    assert rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           b2[9].shape[-1], 5, 3).route == "spread"
    assert rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           b2[9].shape[-1], 5, 3, "rtr").route == "spread"
    ref2 = rk.rtr_full_reference(*b2, **kw)
    _assert_b2_matches(rk.rtr_full(*b2, **kw), ref2)
    _assert_b2_matches(rk.rtr_full(*b2, _cluster=0, **kw), ref2)
    b3 = _b3_args(prob, X, Z, chol)
    b3_kw = _b3_kw(params, prob.meta)
    ref3 = rk.rtr_reference(*b3, **b3_kw)
    _assert_b3_matches(rk.rtr(*b3, **b3_kw), ref3)
    _assert_b3_matches(rk.rtr(*b3, _cluster=0, **b3_kw), ref3)


def test_cluster_that_cannot_be_placed_raises(card):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, 3, 5, 2)
    before = (rk.LAUNCHES, rk.RTR_LAUNCHES)
    with pytest.raises(RuntimeError, match="cluster"):
        rk.rtr_full(*b2, _cluster=32, **kw)
    with pytest.raises(RuntimeError, match="cluster"):
        rk.rtr(*b3, _cluster=32, **b3_kw)
    assert (rk.LAUNCHES, rk.RTR_LAUNCHES) == before


@pytest.mark.parametrize("d,r,n_max,kinc", [(3, 5, 316, 11), (3, 5, 2000, 9),
                                            (2, 3, 350, 7), (3, 4, 40, 3),
                                            (2, 2, 600, 12), (3, 3, 257, 5),
                                            (3, 10, 316, 11),
                                            (2, 10, 328, 11),
                                            (3, 11, 316, 11),
                                            (3, 33, 120, 8),
                                            (2, 78, 328, 11),
                                            (3, 128, 40, 5),
                                            (3, 256, 32, 10),
                                            (3, 512, 16, 5),
                                            (2, 4482, 16, 5)])
def test_cluster_smem_bytes_match_the_plan(card, d, r, n_max, kinc):
    # Every kernel's launcher carves the bytes its cluster_shape states.
    lib = rk.load()
    for kernel, kid in rk.KERNELS.items():
        for C in rk.CLUSTER_SIZES:
            assert lib.dpgo_rtr_cluster_smem_bytes(r, d, n_max, kinc, C,
                                                   kid) == \
                rk.cluster_shape(r, d, n_max, kinc, C, kernel).smem_bytes


def test_cluster_route_repeats_bit_for_bit(card):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, 3, 5, 2)
    for fn, args, k in ((rk.rtr_full, b2, kw), (rk.rtr, b3, b3_kw)):
        first, second = fn(*args, **k), fn(*args, **k)
        torch.cuda.synchronize()
        assert torch.equal(first.X, second.X)
        assert torch.equal(first.stats, second.stats)
        assert torch.equal(first.tcg_iters, second.tcg_iters)


# ---------------------------------------------------------------------------
# The cluster route of B1 and B4 (csrc/rtr_cluster.cu)
# ---------------------------------------------------------------------------

def _tcg_args(b3, radius):
    """B1's operands from B3's (its S and g) at per-agent ``radius``."""
    rad = torch.full((b3[6].shape[0],), radius, device=b3[6].device)
    return (*b3[:7], b3[8], b3[9], b3[10], rad, b3[11], b3[12])


def _tcg_kw(b3_kw):
    return {k: b3_kw[k] for k in ("r", "d", "e_max", "max_iters", "kappa",
                                  "theta")}


def _assert_tcg_matches(out, ref):
    # chip_smoke.py's tcg gates: |d eta| and |d Heta| / max |Heta| at 1e-4,
    # no flip of (iterations, hit).
    assert bool(torch.isfinite(out.eta).all() and torch.isfinite(out.heta)
                .all())
    assert float((out.eta - ref.eta).abs().max()) <= 1e-4
    assert float((out.heta - ref.heta).abs().max()) <= 1e-4 * float(
        ref.heta.abs().max())
    assert torch.equal(out.stats, ref.stats)


def _assert_refine_gates(out, ref, D_in):
    # chip_smoke.refine_parity's gates: the correction within 1e-3 of the
    # step's own size, no flip of attempts or accepted, df0 and df within
    # 1e-3 of their largest magnitude, gn0 at rtol 1e-4.
    assert bool(torch.isfinite(out.D).all() and torch.isfinite(out.stats)
                .all())
    step = float((ref.D - D_in).abs().max())
    assert float((out.D - ref.D).abs().max()) <= 1e-3 * max(step, 1e-30)
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    df = ref.stats[:, 2:4]
    assert float((out.stats[:, 2:4] - df).abs().max()) <= 1e-3 * float(
        df.abs().max())
    torch.testing.assert_close(out.stats[:, 4], ref.stats[:, 4], rtol=1e-4,
                               atol=0)


def _placeable_for(kernel, n, K, r, d):
    return [C for C in rk.CLUSTER_SIZES
            if rk._fits(rk.cluster_shape(r, d, n, K, C, kernel))
            and rk.cluster_capacity(r, d, n, K, C, kernel) >= 1]


@pytest.mark.parametrize("A", [3, 1])
@pytest.mark.parametrize("d,r", SHAPES)
def test_tcg_cluster_route_matches_plain_version_at_every_size(card, d, r,
                                                               A):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, d, r, A)
    tkw = _tcg_kw(b3_kw)
    n, K = prob.meta.n_max, b2[9].shape[-1]
    plan = rk.cluster_plan(n, prob.meta.e_max, K, r, d, "tcg")
    assert plan.route == "cluster" and plan.C > 1
    sizes = _placeable_for("tcg", n, K, r, d)
    assert plan.C in sizes
    for radius in (0.05, 1.0, 100.0):
        args = _tcg_args(b3, radius)
        ref = rk.tcg_reference(*args, **tkw)
        for C in sizes:
            before = rk.TCG_LAUNCHES
            out = rk.tcg(*args, _cluster=C, **tkw)
            torch.cuda.synchronize()
            assert rk.TCG_LAUNCHES == before + 1
            _assert_tcg_matches(out, ref)


def _refine_cluster_operands(card, d, r, A):
    """B4's operands on agents of ~300 poses (C > 1) and its options."""
    prob, params, _, ops = _refine_operands(card, d=d, r=r, n=300 * A, A=A,
                                            num_lc=100 * A, rounds=5)
    return prob, ops, rbcd.kernel_options(params, prob.meta)


@pytest.mark.parametrize("A", [3, 1])
@pytest.mark.parametrize("d,r", SHAPES)
def test_refine_cluster_route_matches_plain_version_at_every_size(card, d, r,
                                                                  A):
    prob, ops, kw = _refine_cluster_operands(card, d, r, A)
    n, K = prob.meta.n_max, ops[15].shape[-1]
    plan = rk.cluster_plan(n, prob.meta.e_max, K, r, d, "rtr_refine_full")
    assert plan.route == "cluster" and plan.C > 1
    sizes = _placeable_for("rtr_refine_full", n, K, r, d)
    assert plan.C in sizes
    ref = rk.rtr_refine_full_reference(*ops, **kw)
    for C in sizes:
        before = rk.REFINE_LAUNCHES
        out = rk.rtr_refine_full(*ops, _cluster=C, **kw)
        torch.cuda.synchronize()
        assert rk.REFINE_LAUNCHES == before + 1
        _assert_refine_gates(out, ref, ops[9])


def test_b1_b4_above_the_cluster_limit_take_the_workspace_route(card):
    # 4200 poses in one agent: no cluster holds it (see the B2 case above).
    # B1 and B4 take the spread route there, and the workspace route when
    # forced.
    prob, params, X, Z, chol = _round(card, n=4200, A=1, num_lc=1000)
    b3 = _b3_args(prob, X, Z, chol)
    tkw = _tcg_kw(_b3_kw(params, prob.meta))
    n, K = prob.meta.n_max, b3[11].shape[-1]
    assert rk.cluster_plan(n, prob.meta.e_max, K, 5, 3, "tcg").route == \
        "spread"
    args = _tcg_args(b3, 1.0)
    tref = rk.tcg_reference(*args, **tkw)
    _assert_tcg_matches(rk.tcg(*args, **tkw), tref)
    _assert_tcg_matches(rk.tcg(*args, _cluster=0, **tkw), tref)
    prob, params, _, ops = _refine_operands(card, n=4200, A=1, num_lc=1000,
                                            rounds=3)
    kw = rbcd.kernel_options(params, prob.meta)
    assert rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           ops[15].shape[-1], 5, 3,
                           "rtr_refine_full").route == "spread"
    ref = rk.rtr_refine_full_reference(*ops, **kw)
    _assert_refine_gates(rk.rtr_refine_full(*ops, **kw), ref, ops[9])
    _assert_refine_gates(rk.rtr_refine_full(*ops, _cluster=0, **kw), ref,
                         ops[9])


def test_b1_b4_cluster_that_cannot_be_placed_raises(card):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, 3, 5, 2)
    _, ops, rkw = _refine_cluster_operands(card, 3, 5, 2)
    before = (rk.TCG_LAUNCHES, rk.REFINE_LAUNCHES)
    with pytest.raises(RuntimeError, match="cluster"):
        rk.tcg(*_tcg_args(b3, 1.0), _cluster=32, **_tcg_kw(b3_kw))
    with pytest.raises(RuntimeError, match="cluster"):
        rk.rtr_refine_full(*ops, _cluster=32, **rkw)
    assert (rk.TCG_LAUNCHES, rk.REFINE_LAUNCHES) == before


def test_b1_b4_cluster_route_repeats_bit_for_bit(card):
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, 3, 5, 2)
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    first, second = rk.tcg(*args, **tkw), rk.tcg(*args, **tkw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, ops, rkw = _refine_cluster_operands(card, 3, 5, 2)
    first, second = (rk.rtr_refine_full(*ops, **rkw),
                     rk.rtr_refine_full(*ops, **rkw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d,r", SHAPES)
def test_workspace_route_matches_plain_versions_at_every_shape(card, d, r):
    # The single-CTA route (csrc/rtr_full.cu) of B1-B4, forced, on one
    # agent of ~300 poses: each launch counted, each against its plain
    # version.
    prob, b2, kw, b3, b3_kw = _cluster_operands(card, d, r, 1)
    # B4's operands come from a few B2 rounds: made before the count.
    _, ops, rkw = _refine_cluster_operands(card, d, r, 1)
    before = (rk.LAUNCHES, rk.RTR_LAUNCHES, rk.TCG_LAUNCHES,
              rk.REFINE_LAUNCHES)
    _assert_b2_matches(rk.rtr_full(*b2, _cluster=0, **kw),
                       rk.rtr_full_reference(*b2, **kw))
    _assert_b3_matches(rk.rtr(*b3, _cluster=0, **b3_kw),
                       rk.rtr_reference(*b3, **b3_kw))
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    _assert_tcg_matches(rk.tcg(*args, _cluster=0, **tkw),
                        rk.tcg_reference(*args, **tkw))
    _assert_refine_gates(rk.rtr_refine_full(*ops, _cluster=0, **rkw),
                         rk.rtr_refine_full_reference(*ops, **rkw), ops[9])
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.RTR_LAUNCHES, rk.TCG_LAUNCHES,
            rk.REFINE_LAUNCHES) == tuple(b + 1 for b in before)


# ---------------------------------------------------------------------------
# The spread route of B1-B4 (csrc/rtr_spread.cu)
# ---------------------------------------------------------------------------

#: Four agents of 1700 poses: no cluster holds one (at r = 5 a CTA of the
#: cluster route holds at most 96 poses, 16 CTAs 1536).
SPREAD_A, SPREAD_N = 4, 1700


def _spread_b2(card):
    prob, params, X, Z, chol = _round(card, n=SPREAD_A * SPREAD_N,
                                      A=SPREAD_A, num_lc=250 * SPREAD_A)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    return prob, b2, rbcd.kernel_options(params, prob.meta)


def _spread_b3(card, d=3, r=5, n=SPREAD_A * SPREAD_N, A=SPREAD_A,
               num_lc=250 * SPREAD_A):
    """B2's operands and options, and B3's fed the gradient pass at the
    same point (the chordal init), on agents no cluster holds."""
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=n, A=A,
                                      num_lc=num_lc)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    return (prob, b2, rbcd.kernel_options(params, prob.meta),
            _b3_args(prob, X, Z, chol), _b3_kw(params, prob.meta))


def _spread_b4(card):
    prob, params, _, ops = _refine_operands(card, n=SPREAD_A * SPREAD_N,
                                            A=SPREAD_A,
                                            num_lc=250 * SPREAD_A, rounds=3)
    return prob, ops, rbcd.kernel_options(params, prob.meta)


def _spread_sizes(kernel, n):
    """The spread sizes up to 16 the card can place for this shape."""
    return [C for C in range(1, 17)
            if rk.spread_shape(5, 3, n, C).smem_bytes <= rk.MAX_SMEM_BYTES
            and rk.spread_capacity(5, 3, n, C, kernel) >= 1]


def test_spread_route_matches_plain_versions(card):
    prob, b2, kw = _spread_b2(card)
    m = prob.meta
    plan = rk.cluster_plan(m.n_max, m.e_max, b2[9].shape[-1], 5, 3,
                           agents=SPREAD_A, sms=rk.sm_count(card))
    assert plan.route == "spread" and plan.stripes > 1
    ref = rk.rtr_full_reference(*b2, **kw)
    before = rk.LAUNCHES
    _assert_b2_matches(rk.rtr_full(*b2, **kw), ref)
    for C in (2, 5, 8):
        _assert_b2_matches(rk.rtr_full(*b2, _spread=C, **kw), ref)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 4
    prob, ops, kw4 = _spread_b4(card)
    assert rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           ops[15].shape[-1], 5, 3, "rtr_refine_full",
                           agents=SPREAD_A).route == "spread"
    ref4 = rk.rtr_refine_full_reference(*ops, **kw4)
    before = rk.REFINE_LAUNCHES
    _assert_refine_gates(rk.rtr_refine_full(*ops, **kw4), ref4, ops[9])
    _assert_refine_gates(rk.rtr_refine_full(*ops, _spread=2, **kw4), ref4,
                         ops[9])
    torch.cuda.synchronize()
    assert rk.REFINE_LAUNCHES == before + 2
    # B3 and B1 from the gradient pass's g and S: planned (B2's spread
    # shape) and forced over 2, 5 and 8 CTAs.
    prob, _, _, b3, b3_kw = _spread_b3(card)
    assert rk.cluster_plan(m.n_max, m.e_max, b3[11].shape[-1], 5, 3, "rtr",
                           agents=SPREAD_A, sms=rk.sm_count(card)) == plan
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    ref3 = rk.rtr_reference(*b3, **b3_kw)
    ref1 = rk.tcg_reference(*args, **tkw)
    before = (rk.RTR_LAUNCHES, rk.TCG_LAUNCHES)
    for opts in ({}, {"_spread": 2}, {"_spread": 5}, {"_spread": 8}):
        _assert_b3_matches(rk.rtr(*b3, **opts, **b3_kw), ref3)
        _assert_tcg_matches(rk.tcg(*args, **opts, **tkw), ref1)
    torch.cuda.synchronize()
    assert (rk.RTR_LAUNCHES, rk.TCG_LAUNCHES) == (before[0] + 4,
                                                  before[1] + 4)


def test_b3_on_the_spread_route_matches_b2_from_its_gradient(card):
    # B3 fed the gradient pass's g and S against one B2 launch at the same
    # point, both on the spread route, on the agents B2 does not exit
    # early: the same step (chip_smoke.py's b3_against_b2).  Config #5's
    # agent shape (1594 poses at r = 5, over config #5's C = 2 CTAs), and
    # the smallGrid3D-size stand-in at r = 1636 (folded rows).
    for d, r, n, A, num_lc, spread in ((3, 5, 4 * 1594, 4, 1000, 2),
                                       (3, 1636, 125, 4, 172, None)):
        prob, b2, kw, b3, b3_kw = _spread_b3(card, d=d, r=r, n=n, A=A,
                                             num_lc=num_lc)
        m = prob.meta
        assert rk.cluster_plan(m.n_max, m.e_max, b2[9].shape[-1], r, d,
                               agents=A).route == "spread"
        opts = {} if spread is None else {"_spread": spread}
        out2 = rk.rtr_full(*b2, **opts, **kw)
        out3 = rk.rtr(*b3, **opts, **b3_kw)
        torch.cuda.synchronize()
        moving = out2.stats[:, 4] >= kw["grad_tol"]
        assert bool(moving.any())
        assert float((out3.X - out2.X)[moving].abs().max()) <= 1e-4
        assert torch.equal(out3.stats[moving, :2], out2.stats[moving, :2])
        torch.testing.assert_close(out3.stats[moving, 2:4],
                                   out2.stats[moving, 2:4], rtol=1e-4,
                                   atol=0)


@pytest.mark.parametrize("d,r", [(3, 10), (2, 10)])
def test_spread_route_matches_plain_versions_at_the_top_rank(card, d, r):
    # r = 10, the staircase's default top: B2 and B4 on agents of 1700
    # poses take the spread route, planned and at C = 4.
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=SPREAD_A * SPREAD_N,
                                      A=SPREAD_A, num_lc=250 * SPREAD_A)
    m = prob.meta
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, m)
    assert rk.cluster_plan(m.n_max, m.e_max, b2[9].shape[-1], r, d,
                           agents=SPREAD_A,
                           sms=rk.sm_count(card)).route == "spread"
    ref = rk.rtr_full_reference(*b2, **kw)
    before = rk.LAUNCHES
    _assert_b2_matches(rk.rtr_full(*b2, **kw), ref)
    _assert_b2_matches(rk.rtr_full(*b2, _spread=4, **kw), ref)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 2
    prob, params, _, ops = _refine_operands(card, d=d, r=r,
                                            n=SPREAD_A * SPREAD_N,
                                            A=SPREAD_A,
                                            num_lc=250 * SPREAD_A, rounds=3)
    kw4 = rbcd.kernel_options(params, prob.meta)
    ref4 = rk.rtr_refine_full_reference(*ops, **kw4)
    before = rk.REFINE_LAUNCHES
    _assert_refine_gates(rk.rtr_refine_full(*ops, **kw4), ref4, ops[9])
    _assert_refine_gates(rk.rtr_refine_full(*ops, _spread=4, **kw4), ref4,
                         ops[9])
    torch.cuda.synchronize()
    assert rk.REFINE_LAUNCHES == before + 2


def test_spread_route_repeats_bit_for_bit(card):
    _, b2, kw = _spread_b2(card)
    first, second = rk.rtr_full(*b2, **kw), rk.rtr_full(*b2, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, ops, kw4 = _spread_b4(card)
    first, second = (rk.rtr_refine_full(*ops, **kw4),
                     rk.rtr_refine_full(*ops, **kw4))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, _, _, b3, b3_kw = _spread_b3(card)
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    for fn, a, k in ((rk.rtr, b3, b3_kw), (rk.tcg, args, tkw)):
        first, second = fn(*a, **k), fn(*a, **k)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_solve_on_the_spread_route_launches_b2_once_per_round(card):
    meas = make_measurements(np.random.default_rng(3), n=SPREAD_A * SPREAD_N,
                             d=3, num_lc=250 * SPREAD_A, rot_noise=0.02,
                             trans_noise=0.02)[0]
    params = AgentParams(d=3, r=5, num_robots=SPREAD_A)
    prob = rbcd.prepare_problem(meas, SPREAD_A, params, device=card)
    m = prob.meta
    assert rk.cluster_plan(m.n_max, m.e_max, prob.graph.inc_slot.shape[-1],
                           5, 3, agents=SPREAD_A).route == "spread"
    for verdict_every in (None, 2):
        before = rk.LAUNCHES
        res = rbcd.solve_rbcd(meas, SPREAD_A, params, max_iters=6,
                              grad_norm_tol=0.1, verdict_every=verdict_every)
        assert res.iterations > 0
        assert rk.LAUNCHES - before == rbcd.rounds_enqueued(
            res.iterations, max_iters=6, eval_every=1, params=params,
            verdict_every=verdict_every)


def test_forced_cluster_or_spread_past_the_lane_cap_raises(card):
    # r = 513: a pose of 17 warps fits no cluster CTA.  A forced cluster
    # raises before any launch, and the cluster launchers refuse the rank
    # themselves.  The spread route folds the pose's rows over 16 warps
    # for every kernel: a spread forced over 16 CTAs (one pose each) runs
    # and holds its plain version; over one CTA (16 poses) its shared
    # memory does not fit, so the plan raises and the launcher places no
    # cluster.
    prob, params, X, Z, chol = _round(card, d=3, r=513, A=2, n=32,
                                      num_lc=10)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, prob.meta)
    b3, b3_kw = _b3_args(prob, X, Z, chol), _b3_kw(params, prob.meta)
    _, _, _, ops4 = _refine_operands(card, r=513, n=32, A=2, num_lc=10,
                                     rounds=0)
    before = (rk.LAUNCHES, rk.RTR_LAUNCHES, rk.TCG_LAUNCHES,
              rk.REFINE_LAUNCHES)
    for C in (1, 16):
        with pytest.raises(ValueError, match="r <= 512"):
            rk.rtr_full(*b2, _cluster=C, **kw)
        with pytest.raises(ValueError, match="r <= 512"):
            rk.rtr(*b3, _cluster=C, **b3_kw)
        with pytest.raises(ValueError, match="r <= 512"):
            rk.tcg(*_tcg_args(b3, 1.0), _cluster=C, **_tcg_kw(b3_kw))
        with pytest.raises(ValueError, match="r <= 512"):
            rk.rtr_refine_full(*ops4, _cluster=C, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rtr_full(*b2, _spread=1, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rtr_refine_full(*ops4, _spread=1, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rtr(*b3, _spread=1, **b3_kw)
    with pytest.raises(ValueError, match="shared memory"):
        rk.tcg(*_tcg_args(b3, 1.0), _spread=1, **_tcg_kw(b3_kw))
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.RTR_LAUNCHES, rk.TCG_LAUNCHES,
            rk.REFINE_LAUNCHES) == before
    _assert_b2_matches(rk.rtr_full(*b2, _spread=16, **kw),
                       rk.rtr_full_reference(*b2, **kw))
    _assert_b3_matches(rk.rtr(*b3, _spread=16, **b3_kw),
                       rk.rtr_reference(*b3, **b3_kw))
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    _assert_tcg_matches(rk.tcg(*args, _spread=16, **tkw),
                        rk.tcg_reference(*args, **tkw))
    _assert_refine_matches(rk.rtr_refine_full(*ops4, _spread=16, **kw),
                           rk.rtr_refine_full_reference(*ops4, **kw),
                           ops4[9])
    torch.cuda.synchronize()
    assert (rk.LAUNCHES, rk.RTR_LAUNCHES, rk.TCG_LAUNCHES,
            rk.REFINE_LAUNCHES) == tuple(b + 1 for b in before)
    for kernel in rk.KERNELS:
        with pytest.raises(ValueError, match="16 warps"):
            rk.cluster_capacity(513, 3, 1, 2, 1, kernel)
        assert rk.cluster_capacity(512, 3, 1, 2, 1, kernel) >= 1
    for kernel in rk.SPREAD_KERNELS:
        assert rk.spread_capacity(513, 3, 1, 1, kernel) >= 1
        assert rk.spread_capacity(512, 3, 1, 1, kernel) >= 1
        assert rk.spread_capacity(513, 3, 16, 1, kernel) == 0


def test_spread_that_cannot_be_placed_raises(card):
    _, b2, kw = _spread_b2(card)
    _, ops, kw4 = _spread_b4(card)
    before = (rk.LAUNCHES, rk.REFINE_LAUNCHES)
    with pytest.raises(RuntimeError, match="cannot place"):
        rk.rtr_full(*b2, _spread=32, **kw)
    with pytest.raises(RuntimeError, match="cannot place"):
        rk.rtr_refine_full(*ops, _spread=32, **kw4)
    assert (rk.LAUNCHES, rk.REFINE_LAUNCHES) == before
    assert rk.spread_capacity(5, 3, SPREAD_N, 32) == 0
    assert 2 in _spread_sizes("rtr_full", SPREAD_N)


@pytest.mark.parametrize("d,r,n_max", [(3, 5, 1594), (3, 5, 97), (3, 7, 1594),
                                       (2, 3, 5000), (3, 4, 40), (2, 2, 700),
                                       (3, 10, 1594), (2, 10, 5000),
                                       (3, 17, 316), (3, 18, 1594),
                                       (3, 73, 316), (2, 78, 328),
                                       (3, 128, 1594), (3, 256, 32),
                                       (3, 512, 32), (3, 513, 32),
                                       (3, 1636, 32), (2, 4482, 16)])
def test_spread_shape_matches_the_launcher(card, d, r, n_max):
    # The launcher sizes each spread kernel by the formula spread_shape
    # states: poses, threads and stripes per CTA, the rows a lane holds
    # (past the lane cap, ceil(r / 512) folds of a 16-warp pose), shared
    # memory.
    import ctypes

    lib = rk.load()
    out = (ctypes.c_int * 4)()
    for kernel in rk.SPREAD_KERNELS:
        for C in range(1, 17):
            smem = lib.dpgo_rtr_spread_shape(r, d, n_max, C,
                                             rk.KERNELS[kernel], out)
            plan = rk.spread_shape(r, d, n_max, C)
            assert (tuple(out), smem) == ((plan.P, plan.threads,
                                           plan.stripes, plan.folds),
                                          plan.smem_bytes)
    assert plan.folds == (-(-r // 512) if r > 512 else 1)
    assert lib.dpgo_rtr_spread_shape(r, d, n_max, 2, len(rk.KERNELS),
                                     out) == -4


@pytest.mark.parametrize("d,r,n,A,num_lc", [(3, 1636, 125, 4, 172),
                                             (2, 4482, 32, 2, 10)])
def test_fold_kernels_match_plain_versions_and_repeat(card, d, r, n, A,
                                                      num_lc):
    # The top ranks the JAX gate admits: 32-pose agents at r = 1636 (the
    # smallGrid3D-size stand-in's shape, four folds a lane) and 16-pose
    # agents at r = 4482 (nine folds).  B1-B4 plan the spread route of
    # folded rows, hold their plain versions and repeat bit for bit.
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=n, A=A,
                                      num_lc=num_lc)
    m = prob.meta
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, m)
    for kernel in rk.SPREAD_KERNELS:
        plan = rk.cluster_plan(m.n_max, m.e_max, b2[9].shape[-1], r, d,
                               kernel, agents=A, sms=rk.sm_count(card))
        assert (plan.route, plan.folds) == ("spread", -(-r // 512))
    before = rk.LAUNCHES
    first, second = rk.rtr_full(*b2, **kw), rk.rtr_full(*b2, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 2
    _assert_b2_matches(first, rk.rtr_full_reference(*b2, **kw))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    b3, b3_kw = _b3_args(prob, X, Z, chol), _b3_kw(params, m)
    args, tkw = _tcg_args(b3, 1.0), _tcg_kw(b3_kw)
    before = (rk.RTR_LAUNCHES, rk.TCG_LAUNCHES)
    for fn, ref_fn, a, k, hold in (
            (rk.rtr, rk.rtr_reference, b3, b3_kw, _assert_b3_matches),
            (rk.tcg, rk.tcg_reference, args, tkw, _assert_tcg_matches)):
        first, second = fn(*a, **k), fn(*a, **k)
        torch.cuda.synchronize()
        hold(first, ref_fn(*a, **k))
        assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert (rk.RTR_LAUNCHES, rk.TCG_LAUNCHES) == (before[0] + 2,
                                                  before[1] + 2)
    prob4, rparams, _, ops4 = _refine_operands(card, d=d, r=r, n=n, A=A,
                                               num_lc=num_lc, rounds=0)
    kw4 = rbcd.kernel_options(rparams, prob4.meta)
    before = rk.REFINE_LAUNCHES
    first, second = (rk.rtr_refine_full(*ops4, **kw4),
                     rk.rtr_refine_full(*ops4, **kw4))
    torch.cuda.synchronize()
    assert rk.REFINE_LAUNCHES == before + 2
    _assert_refine_matches(first, rk.rtr_refine_full_reference(*ops4, **kw4),
                           ops4[9])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------------------------------
# The grid route of B2 and B4 (csrc/rtr_grid.cu)
# ---------------------------------------------------------------------------

#: Ranks the grid route is held at beyond the templated shapes: the
#: rank-generic instantiation with a pose of r lanes (11), of three warps
#: (73) and of 16 warps (512, the lane layout's top); by rank, the graph
#: (poses, loop closures) over GRID_A agents, smaller as r grows.
GRID_GENERIC = {(3, 11): (600, 200), (3, 73): (200, 60), (3, 512): (64, 20)}
GRID_A = 2


def _grid_operands(card, d, r, n=None, num_lc=None):
    """B2's operands and options at the chordal init, and B4's recentered
    a few rounds in (at the init above r = 11), on GRID_A agents of n / 2
    poses (by rank, GRID_GENERIC's or 300)."""
    if n is None:
        n, num_lc = GRID_GENERIC.get((d, r), (600, 200))
    prob, params, X, Z, chol = _round(card, d=d, r=r, n=n, A=GRID_A,
                                      num_lc=num_lc)
    b2 = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    prob4, rparams, _, ops4 = _refine_operands(
        card, d=d, r=r, n=n, A=GRID_A, num_lc=num_lc,
        rounds=3 if r <= 11 else 0)
    return (b2, rbcd.kernel_options(params, prob.meta), ops4,
            rbcd.kernel_options(rparams, prob4.meta))


@pytest.mark.parametrize("d,r", SHAPES + list(GRID_GENERIC))
def test_grid_route_matches_plain_versions(card, d, r):
    # B2 and B4 forced onto the grid route over 4 and 33 CTAs an agent
    # (at r = 512, 33 CTAs for 32 poses: one CTA holds none), one launch
    # each, against their plain versions at the single-launch gates.
    b2, kw, ops4, kw4 = _grid_operands(card, d, r)
    ref2 = rk.rtr_full_reference(*b2, **kw)
    ref4 = rk.rtr_refine_full_reference(*ops4, **kw4)
    before = (rk.LAUNCHES, rk.REFINE_LAUNCHES)
    for C in (4, 33):
        out2 = rk.rtr_full(*b2, _grid=C, **kw)
        out4 = rk.rtr_refine_full(*ops4, _grid=C, **kw4)
        torch.cuda.synchronize()
        _assert_b2_matches(out2, ref2)
        _assert_refine_gates(out4, ref4, ops4[9])
    assert (rk.LAUNCHES, rk.REFINE_LAUNCHES) == (before[0] + 2,
                                                 before[1] + 2)


def test_grid_route_repeats_bit_for_bit(card):
    for d, r in ((3, 5), (2, 3), (3, 73)):
        b2, kw, ops4, kw4 = _grid_operands(card, d, r)
        for fn, args, k in ((rk.rtr_full, b2, kw),
                            (rk.rtr_refine_full, ops4, kw4)):
            first, second = fn(*args, _grid=33, **k), fn(*args, _grid=33,
                                                          **k)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_grid_that_cannot_be_resident_raises(card, monkeypatch):
    # The plan gives a grid one CTA an SM: a forced grid of more CTAs than
    # the card's SMs raises before any launch.  With the plan told of a
    # larger card, the launcher itself refuses a cooperative launch of more
    # CTAs than the card keeps resident, and the wrapper raises with the
    # shape.  Agents of 7,000 poses: at sms // 2 + 1 CTAs an agent each
    # CTA still holds 105 poses, 512 threads (one CTA an SM; smaller CTAs
    # would be resident several to an SM).
    b2, kw, ops4, kw4 = _grid_operands(card, 3, 5, n=GRID_A * 7000,
                                       num_lc=2000)
    sms = rk.sm_count(card)
    C = sms // GRID_A + 1
    assert rk.grid_shape(5, 3, 7000, C).threads == 512
    assert rk.grid_capacity(5, 3, 7000, C) == sms < GRID_A * C
    before = (rk.LAUNCHES, rk.REFINE_LAUNCHES)
    with pytest.raises(ValueError, match="cannot be resident"):
        rk.rtr_full(*b2, _grid=C, **kw)
    monkeypatch.setattr(rk, "sm_count", lambda dev: GRID_A * C)
    with pytest.raises(RuntimeError, match="resident at once"):
        rk.rtr_full(*b2, _grid=C, **kw)
    with pytest.raises(RuntimeError, match="resident at once"):
        rk.rtr_refine_full(*ops4, _grid=C, **kw4)
    assert (rk.LAUNCHES, rk.REFINE_LAUNCHES) == before
    # The card is not left in a failed state: the grid launches after.
    out = rk.rtr_full(*b2, _grid=sms // GRID_A, **kw)
    torch.cuda.synchronize()
    _assert_b2_matches(out, rk.rtr_full_reference(*b2, **kw))


@pytest.mark.parametrize("d,r,n_max,kinc", [(3, 5, 25000, 7), (3, 5, 300, 9),
                                            (2, 3, 50000, 8),
                                            (3, 73, 100, 6),
                                            (3, 512, 32, 5)])
def test_grid_shape_and_workspace_match_the_launcher(card, d, r, n_max,
                                                     kinc):
    import ctypes

    lib = rk.load()
    out = (ctypes.c_int * 3)()
    for C in (1, 4, 33, 66, 132):
        smem = lib.dpgo_rtr_grid_shape(r, d, n_max, C, out)
        plan = rk.grid_shape(r, d, n_max, C)
        assert (tuple(out), smem) == ((plan.P, plan.threads, plan.stripes),
                                      plan.smem_bytes)
        for kernel in rk.GRID_KERNELS:
            assert lib.dpgo_rtr_grid_workspace_floats(
                r, d, n_max, 3 * n_max, kinc, C, rk.KERNELS[kernel]) == \
                rk.grid_workspace_floats(r, d, n_max, 3 * n_max, kinc, C,
                                         kernel)
    for kernel in ("rtr", "tcg"):
        assert lib.dpgo_rtr_grid_workspace_floats(
            r, d, n_max, 3 * n_max, kinc, 4, rk.KERNELS[kernel]) == -4


def test_solve_on_the_grid_route_launches_b2_once_per_round(card):
    # Two agents of 16,000 poses at r = 5: no spread of 16 CTAs holds one
    # (above ~15k poses), so B2 plans the grid route over sms // 2 CTAs an
    # agent, and a solve launches it once per enqueued round.
    from dpgo_tpu_torch.utils.synthetic import make_measurements_vectorized

    meas = make_measurements_vectorized(np.random.default_rng(11), 32000,
                                        d=3, num_lc=6400, rot_noise=0.05,
                                        trans_noise=0.05)[0]
    params = AgentParams(d=3, r=5, num_robots=2, rel_change_tol=0.0)
    prob = rbcd.prepare_problem(meas, 2, params, device=card)
    m = prob.meta
    plan = rk.cluster_plan(m.n_max, m.e_max, prob.graph.inc_slot.shape[-1],
                           5, 3, agents=2, sms=rk.sm_count(card))
    assert (plan.route, plan.C) == ("grid", rk.sm_count(card) // 2)
    before = rk.LAUNCHES
    res = rbcd.dispatch_prepared(prob, max_iters=4, grad_norm_tol=0.0,
                                 verdict_every=2)
    assert res.iterations == 4
    assert rk.LAUNCHES - before == rbcd.rounds_enqueued(
        res.iterations, max_iters=4, eval_every=1, params=params,
        verdict_every=2)
    assert bool(np.isfinite(res.cost_history).all())
    assert res.cost_history[-1] < res.cost_history[0]


# ---------------------------------------------------------------------------
# The certificate on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_eigh_small_and_svd_thin_match_linalg_on_card(card, dtype, tol):
    g = torch.Generator(device=card).manual_seed(0)
    for n in (4, 12):
        B = torch.randn(5, n, n, generator=g, device=card, dtype=dtype)
        A = B + B.transpose(-1, -2)
        w, V = smallmat.eigh_small(A)
        w_ref = torch.linalg.eigvalsh(A)
        scale = float(A.abs().max())
        assert float((w - w_ref).abs().max()) <= tol * scale
        rec = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
        assert float((rec - A).abs().max()) <= 10 * tol * scale
    M = torch.randn(2000, 5, generator=g, device=card, dtype=dtype)
    U, s, V = smallmat.svd_thin(M)
    s_ref = torch.linalg.svdvals(M)
    assert float((s - s_ref).abs().max()) <= tol * float(s_ref[0])
    assert float((U @ torch.diag(s) @ V.T - M).abs().max()) <= \
        10 * tol * float(s_ref[0])


def _cert_problem(seed=5, n=60, num_lc=20):
    meas = make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    res = local_pgo.solve_local(meas, rank=5, grad_norm_tol=1e-6,
                                max_iters=3, device="cpu")
    return meas, res.X


def _fixed_draws(n, dh, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return interop.fixed_probe_draws({0: (rng.standard_normal((n, 1, dh)),
                                          rng.standard_normal((n * dh, k)))})


def test_device_payload_on_card_matches_cpu_f64(card, monkeypatch):
    """The same payload, same draws, float64 on the card and on the CPU;
    then float32 on the card against it."""
    meas, X = _cert_problem()
    monkeypatch.setattr(certify, "_probe_draws",
                        _fixed_draws(X.shape[0], X.shape[2]))
    pays = {}
    for where, dev, dtype in (("cpu", "cpu", torch.float64),
                              ("card64", card, torch.float64),
                              ("card32", card, torch.float32)):
        e = edge_set_from_measurements(meas, dtype=dtype, device=dev)
        pays[where] = interop.payload_to_numpy(
            certify.device_certificate_payload(X.to(dev, dtype), e, 0))
    ref = pays["cpu"]
    noise = 1e-9 * ref["sigma"]
    for k in ("lam_min", "sigma", "rq", "defl_resid", "stat", "wscale"):
        np.testing.assert_allclose(pays["card64"][k], ref[k], rtol=1e-8,
                                   atol=noise, err_msg=k)
    # float32: ten ulps of sigma, the error band the decision assumes.
    band = 10 * float(np.finfo(np.float32).eps) * ref["sigma"]
    for k in ("lam_min", "rq"):
        assert abs(pays["card32"][k] - ref[k]) <= band, k
    np.testing.assert_allclose(pays["card32"]["sigma"], ref["sigma"],
                               rtol=1e-5)


def test_certified_epilogue_has_no_host_sync(card):
    """The certified solve through the verdict loop on the card, then its
    certified epilogue again with every host sync an error."""
    meas = make_measurements(np.random.default_rng(5), n=60, d=3,
                             num_lc=20, rot_noise=0.05,
                             trans_noise=0.05)[0]
    params = AgentParams(d=3, r=5, num_robots=4, certify_mode="device")
    prob = rbcd.prepare_problem(meas, 4, params, device=card)
    res = rbcd.dispatch_prepared(prob, max_iters=16, grad_norm_tol=0.0,
                                 verdict_every=8)
    assert res.certificate is not None
    assert res.certificate.device_verdict != certify.CERT_NONE
    part = prob.part
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float32, device=card)
    epi = rbcd.make_terminal_epilogue(
        prob.graph, edges_g, part.meas_global.num_poses,
        len(part.meas_global), prob.meta, certify_mode="device")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fin = epi(res.state.X, res.state.weights, {})
        copy = rbcd._start_fetch(fin)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = rbcd._host_fetch(copy)
    assert float(host["cert"]["lam_min"]) == res.certificate.lambda_min
    assert float(host["cert"]["sigma"]) == res.certificate.sigma
    assert host["Xg"].shape == (60, 5, 4)


# ---------------------------------------------------------------------------
# df32, the on-device recenter, the dense-Q round, the distributed init
# ---------------------------------------------------------------------------

def test_df32_error_free_transforms_exact_on_card(card):
    """For random float32 a and b, two_sum and two_prod are exact in
    float64 on the card (no contraction into a fused multiply-add), and
    fold_sum stays within its bound."""
    from dpgo_tpu_torch.ops import df32

    rng = np.random.default_rng(11)
    a64 = rng.standard_normal(1 << 16) * np.exp(rng.uniform(-8, 8, 1 << 16))
    b64 = rng.standard_normal(1 << 16) * np.exp(rng.uniform(-8, 8, 1 << 16))
    a = torch.as_tensor(a64.astype(np.float32), device=card)
    b = torch.as_tensor(b64.astype(np.float32), device=card)
    for prim, exact in ((df32.two_sum, torch.add), (df32.two_prod,
                                                    torch.mul)):
        hi, lo = prim(a, b)
        assert hi.dtype == lo.dtype == torch.float32
        assert torch.equal(hi.double() + lo.double(),
                           exact(a.double(), b.double()))
    x = df32.from_f64(a64, card)
    s = df32.fold_sum(x)
    assert s.hi.dtype == torch.float32
    ref = float(np.sum(df32.to_f64(x)))
    assert abs(float(df32.to_f64(s)) - ref) <= 1e-12 * float(
        np.abs(a64).sum())


def _fused_problem(dev):
    from dpgo_tpu_torch.models import refine_fused

    meas = make_measurements(np.random.default_rng(0), n=40, d=3,
                             num_lc=20, rot_noise=0.02,
                             trans_noise=0.02)[0]
    params = AgentParams(d=3, r=5, num_robots=3, rel_change_tol=0.0,
                         solver=SolverParams(grad_norm_tol=1e-12,
                                             max_inner_iters=10))
    prob = rbcd.prepare_problem(meas, 3, params, dtype=torch.float32,
                                device=dev)
    gp = refine_fused.build_global_df(prob.part.meas_global, device=dev)
    return meas, params, prob, gp


def test_recenter_device_on_card_matches_cpu(card):
    """The df32 recenter from one float32 iterate on the card and on the
    CPU: the same df32 operations, so R and f_ref agree to the df32 floor
    and the float32 constants to a few ulps of their scale."""
    from dpgo_tpu_torch.models import refine_fused
    from dpgo_tpu_torch.ops import df32

    out = {}
    for where, dev in (("cpu", "cpu"), ("card", card)):
        meas, params, prob, gp = _fused_problem(dev)
        st = rbcd.rbcd_steps(rbcd.init_state(prob.graph, prob.meta, prob.X0,
                                             params), prob.graph, 40,
                             prob.meta, params)
        Xg = rbcd.gather_to_global(st.X, prob.graph, meas.num_poses)
        out[where] = (Xg.cpu(), prob, params, gp)
    Xg = out["cpu"][0]
    res = {}
    for where, (_, prob, params, gp) in out.items():
        res[where] = refine_fused.recenter_device(
            Xg.to(gp.w.device), gp, prob.graph, prob.meta, params,
            Xg.shape[0])
    (Rc, fc, cc, _), (Rg, fg, cg, _) = res["cpu"], res["card"]
    assert np.abs(df32.to_f64(Rg) - df32.to_f64(Rc)).max() <= 1e-12
    assert abs(float(df32.to_f64(fg)) - float(df32.to_f64(fc))) <= \
        1e-12 * abs(float(df32.to_f64(fc)))
    for f in ("R", "Rz", "G_ref", "g0", "S0", "rho_rot_t", "Rc", "Lc"):
        c, g = getattr(cc, f), getattr(cg, f).cpu()
        assert g.dtype == torch.float32, f
        assert float((g - c).abs().max()) <= 3e-6 * max(
            float(c.abs().max()), 1e-12), f


def test_dense_verdict_window_has_no_host_sync(card):
    """The dense-Q round on CUDA runs its loops to their fixed bounds: a
    K-round window of dense segments and verdict steps raises nothing
    with every host sync an error, and launches no kernel."""
    prob, params, step, vs, _ = _verdict_setup(card, 4)
    dparams = AgentParams(d=3, r=5, num_robots=4,
                          solver=SolverParams(dense_quadratic=True))
    state = rbcd.init_state(prob.graph, prob.meta, prob.X0, dparams)
    assert state.Qbuf is not None
    before = rk.LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            state = rbcd.rbcd_segment(state, prob.graph, 1, prob.meta,
                                      dparams)
            vs = step(state.X, state.weights, state.ready, state.mu,
                      state.rel_change, state.iteration, vs)
        copy = rbcd._start_fetch(vs.word)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(rbcd._host_fetch(copy)) == int(vs.word)
    assert rk.LAUNCHES == before
    assert bool(torch.isfinite(state.X).all())
    # A GNC weight-update round rebuilds Q from the cached incidence.
    gparams = AgentParams(d=3, r=5, num_robots=4, robust=RobustCostParams(
        cost_type=RobustCostType.GNC_TLS, gnc_barc=0.5),
        solver=SolverParams(dense_quadratic=True))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flagged = rbcd.rbcd_segment(state, prob.graph, 2, prob.meta,
                                    gparams, first_update_weights=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not torch.equal(flagged.Qbuf, state.Qbuf)
    assert rk.LAUNCHES == before


def test_dense_q_repeats_bit_for_bit_on_card(card):
    prob, params, X, _, _ = _round(card)
    Q1 = rbcd.dense_q_all(prob.graph.edges, prob.meta,
                          prob.graph.dense_inc)
    Q2 = rbcd.dense_q_all(prob.graph.edges, prob.meta)
    Qc = rbcd.dense_q_all(rbcd.EdgeSet(*(t.cpu() for t in prob.graph.edges)),
                          prob.meta)
    assert torch.equal(Q1, Q2)
    torch.testing.assert_close(Q1.cpu(), Qc, rtol=1e-6, atol=1e-4)


def test_distributed_init_on_card_matches_cpu(card):
    meas = make_measurements(np.random.default_rng(5), n=60, d=3,
                             num_lc=20, rot_noise=0.02,
                             trans_noise=0.02)[0]
    params = AgentParams(d=3, r=5, num_robots=4)
    on_card = rbcd.prepare_problem(meas, 4, params, dtype=torch.float32,
                                   device=card, init="distributed")
    host = rbcd.prepare_problem(meas, 4, params, dtype=torch.float64,
                                device="cpu", init="distributed")
    err = float((on_card.X0.double().cpu() - host.X0).abs().max())
    assert err <= 1e-4 * float(host.X0.abs().max())


def _card_agents(card, A=3, n=60, num_lc=20, **kw):
    """A small lockstep fleet of port agents on the card (float32)."""
    from dpgo_tpu_torch.agent import PGOAgent
    from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                                partition_contiguous)

    meas = make_measurements(np.random.default_rng(7), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.02,
                             trans_noise=0.02)[0]
    part = partition_contiguous(meas, A)
    params = AgentParams(d=3, r=5, num_robots=A, **kw)
    ags = [PGOAgent(a, params, device=card) for a in range(A)]
    for ag in ags[1:]:
        ag.set_lifting_matrix(ags[0].get_lifting_matrix())
    for ag in ags:
        ag.set_pose_graph(*agent_measurements(part, ag.robot_id))
    return ags


def _card_exchange(ags):
    pubs = [ag.get_public_pose_arrays() for ag in ags]
    sts = [ag.get_status() for ag in ags]
    for src, pub in enumerate(pubs):
        for dst, ag in enumerate(ags):
            if src != dst:
                ag.set_neighbor_status(sts[src])
                if pub is not None:
                    ag.update_neighbor_poses_packed(src, *pub)


def test_agent_iterate_b2_at_a1_matches_plain_version(card):
    """Each robot's iterate is one B2 launch at A=1 on its own operands:
    the kernel against its plain version on those operands, and the
    launch count against the stepped iterates."""
    ags = _card_agents(card)
    for _ in range(2):
        _card_exchange(ags)
        for ag in ags:
            ag.iterate(True)
    assert all(ag._kernel for ag in ags)
    before, stepped = rk.LAUNCHES, 0
    for ag in ags:
        z = ag._neighbor_buffer()
        args = rbcd.kernel_operands(ag._X_device()[None], z,
                                    ag._edges_weighted(), ag._chol_device(),
                                    ag._graph)
        kw = rbcd.kernel_options(ag.params, ag._meta)
        out = rk.rtr_full(*args, **kw)
        ref = rk.rtr_full_reference(*args, **kw)
        torch.cuda.synchronize()
        assert float((out.X - ref.X).abs().max()) <= 1e-4
        assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    assert rk.LAUNCHES == before + len(ags)
    before = rk.LAUNCHES
    for _ in range(3):
        _card_exchange(ags)
        for ag in ags:
            stepped += ag.iterate(True)
    assert stepped == 9 and rk.LAUNCHES == before + stepped
    # From a thread of its own (as ``start_optimization_loop`` runs it) an
    # iterate launches on that thread's current stream, the default one.
    import threading

    _card_exchange(ags)
    seen = {}

    def run():
        seen["default"] = (torch.cuda.current_stream().cuda_stream
                           == torch.cuda.default_stream().cuda_stream)
        seen["stepped"] = ags[1].iterate(True)
        torch.cuda.synchronize()
    before = rk.LAUNCHES
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert seen == {"default": True, "stepped": True}
    assert rk.LAUNCHES == before + 1


def test_threads_racing_the_first_load_build_one_library(card, monkeypatch):
    """Four threads make the first ``rtr_kernel.load()`` at once: one
    build, one bound library (a fresh build directory)."""
    import threading

    monkeypatch.setattr(rk, "_lib", None)
    monkeypatch.setattr(rk, "BUILD_DIR", rk.BUILD_DIR / "race")
    builds = []
    real = rk._build

    def counting():
        builds.append(threading.get_ident())
        return real()
    monkeypatch.setattr(rk, "_build", counting)
    libs, errs = [], []

    def go():
        try:
            libs.append(rk.load())
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)
    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errs and len(libs) == 4
    assert all(lib is libs[0] for lib in libs)
    assert len(builds) == 1
    names = sorted(p.name for p in rk.BUILD_DIR.iterdir())
    assert len(names) == 1 and names[0].startswith("libdpgo_kernels_")


def test_threads_launching_b2_at_two_shapes_all_launch(card):
    """Two threads launch B2 back to back at one agent each, at shapes that
    need different shared memory (as the agents' optimization threads do,
    each at its own robot's size).  The kernel's shared-memory limit is
    the kernel's, not the thread's: every launch must still succeed and
    agree with the plain version."""
    import threading

    sets = []
    for n, num_lc in ((60, 20), (300, 100)):
        prob, params, X, Z, chol = _round(card, n=n, A=1, num_lc=num_lc)
        args = rbcd.kernel_operands(X, Z, prob.graph.edges, chol,
                                    prob.graph)
        kw = rbcd.kernel_options(params, prob.meta)
        plan = rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                               args[9].shape[-1], 5, 3)
        sets.append((args, kw, plan, rk.rtr_full_reference(*args, **kw)))
    assert all(plan.route == "cluster" for _, _, plan, _ in sets)
    assert sets[0][2].smem_bytes != sets[1][2].smem_bytes
    reps, outs, errs = 300, {}, []

    def go(i):
        args, kw, _, _ = sets[i]
        try:
            for _ in range(reps):
                outs[i] = rk.rtr_full(*args, **kw)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)
    before = rk.LAUNCHES
    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and rk.LAUNCHES == before + 2 * reps
    for i, (_, _, _, ref) in enumerate(sets):
        _assert_b2_matches(outs[i], ref)


def test_agent_iterate_without_fetch_has_no_host_sync(card):
    """At ``status_fetch_every=4`` an iterate off the fetch cadence reads
    nothing back: under the sync-error debug mode it raises nothing, and
    it launches B2 once."""
    from dpgo_tpu_torch import agent as agent_mod

    ags = _card_agents(card, status_fetch_every=4)
    for _ in range(4):
        _card_exchange(ags)
        for ag in ags:
            ag.iterate(True)
    _card_exchange(ags)
    ag = ags[1]
    assert ag.get_status().iteration_number % 4 != 3
    ag._neighbor_buffer()  # upload the fresh neighbor poses first
    torch.cuda.synchronize()
    before = rk.LAUNCHES
    reads = dict(agent_mod.HOST_READS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert ag.iterate(True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rk.LAUNCHES == before + 1
    assert dict(agent_mod.HOST_READS) == reads


def test_telemetry_on_verdict_loop_reads_two_per_window(card, tmp_path,
                                                         monkeypatch):
    """With an obs run on, the verdict loop reads the word and the history
    rows per non-terminal boundary and the epilogue once — 2 x 100/K host
    syncs per 100 rounds — each through ``_host_fetch``; the event stream's
    costs are the returned history."""
    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.obs.events import read_events

    meas = make_measurements(np.random.default_rng(5), n=60, d=3,
                             num_lc=20, rot_noise=0.05,
                             trans_noise=0.05)[0]
    # A negative tolerance: at the float32 floor an agent's change is
    # exactly 0, and a tolerance of 0 would end the run by consensus.
    params = AgentParams(d=3, r=5, num_robots=4, rel_change_tol=-1.0)
    calls = []
    real = rbcd._host_fetch
    monkeypatch.setattr(rbcd, "_host_fetch",
                        lambda x: calls.append(1) or real(x))
    d = str(tmp_path / "run")
    with obs.run_scope(d) as run:
        res = rbcd.solve_rbcd(meas, 4, params, max_iters=64,
                              grad_norm_tol=0.0, verdict_every=16,
                              device=card)
        rate = run.registry.snapshot()[
            "host_syncs_per_100_rounds"]["series"][0]["value"]
    assert res.iterations == 64 and res.terminated_by == "max_iters"
    assert rate == 2 * 100 / 16 and len(calls) == 2 * 64 // 16
    costs = [e["value"] for e in read_events(f"{d}/events.jsonl")
             if e.get("metric") == "solver_cost"]
    assert costs == res.cost_history and len(costs) == 64


def test_two_process_tcp_run_launches_b2_per_stepped_iterate(card,
                                                             tmp_path):
    """Two robot processes on the card over localhost TCP: each robot's B2
    launches equal its stepped iterates."""
    import json
    import os
    import subprocess
    import sys

    from dpgo_tpu_torch.utils.g2o import write_g2o

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    meas = make_measurements(np.random.default_rng(0), n=36, d=3,
                             num_lc=18, rot_noise=0.01,
                             trans_noise=0.01)[0]
    data = str(tmp_path / "s.g2o")
    write_g2o(meas, data)
    out = subprocess.run(
        [sys.executable, "-m",
         "dpgo_tpu_torch.examples.tcp_deployment_example", data,
         "--robots", "2", "--rounds", "20", "--device", "cuda",
         "--out-dir", str(tmp_path / "run")],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["states"] == [2, 2] and res["lost"] == []
    for rid in range(2):
        o = np.load(str(tmp_path / "run" / f"robot{rid}.npz"))
        assert str(o["device"]).startswith("cuda")
        assert int(o["b2_launches"]) == int(o["stepped"]) > 0


def _served(card, sizes=((60, 20, 5), (64, 22, 6), (57, 18, 7)), A=4,
            quantum=32):
    """Problems of several sizes padded into one bucket on the card."""
    from dpgo_tpu_torch.serve import BucketShape, bucket_shape_of, \
        pad_problem

    params = AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0)
    probs = [rbcd.prepare_problem(
        make_measurements(np.random.default_rng(s), n=n, d=3, num_lc=lc,
                          rot_noise=0.05, trans_noise=0.05)[0],
        A, params, init=None, device=card) for n, lc, s in sizes]
    shape = BucketShape(*[max(v) for v in zip(
        *[bucket_shape_of(p, quantum) for p in probs])])
    return params, [pad_problem(p, shape) for p in probs]


@pytest.mark.parametrize("verdict_every", [None, 4])
def test_served_batch_launches_b2_once_per_round(card, verdict_every):
    """A bucket of three problems steps as one batch: one B2 launch per
    round for all 3*4 agents (not one per member), every member finite,
    and the verdict batch's reported results equal the per-eval batch's
    bit for bit."""
    from dpgo_tpu_torch.serve import ExecutableCache, run_bucket

    _, padded = _served(card)
    before = rk.LAUNCHES
    res, info = run_bucket(padded, ExecutableCache(), max_iters=12,
                           grad_norm_tol=1e-9, eval_every=2,
                           verdict_every=verdict_every)
    assert rk.LAUNCHES - before == info["rounds"] == 12
    assert info["batch"] == 4 and info["size"] == 3
    for r, p in zip(res, padded):
        assert r.T.shape == (p.prob.n_total, 3, 4)
        assert bool(torch.isfinite(r.T).all())
        assert np.isfinite(r.cost_history).all()
    if verdict_every is not None:
        ref, _ = run_bucket(padded, ExecutableCache(), max_iters=12,
                            grad_norm_tol=1e-9, eval_every=2)
        for a, b in zip(ref, res):
            assert a.cost_history == b.cost_history
            assert (a.iterations, a.terminated_by) == \
                (b.iterations, b.terminated_by)


def test_served_member_b2_matches_unpadded_launch(card):
    """B2 on a padded member's operands leaves the padded poses and rows
    alone and agrees with B2 on the unpadded problem on the live rows."""
    params, padded = _served(card)
    p = padded[0]
    prob = rbcd.prepare_problem(p.prob.part.meas_global, 4, params,
                                device=card)
    kw = rbcd.kernel_options(params, prob.meta)
    g, X = prob.graph, prob.X0
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
    out = rk.rtr_full(*rbcd.kernel_operands(
        X, Z, g.edges, rbcd.precond_chol(g.edges, g, params), g), **kw)
    n, gp = prob.meta.n_max, p.graph
    Xp = rbcd.scatter_to_agents(rbcd.gather_to_global(X, g, prob.n_total),
                                gp)
    Zp = rbcd.neighbor_buffer(rbcd.public_table(Xp, gp), gp)
    outp = rk.rtr_full(*rbcd.kernel_operands(
        Xp, Zp, gp.edges, rbcd.precond_chol(gp.edges, gp, params), gp),
        **rbcd.kernel_options(params, p.meta))
    torch.cuda.synchronize()
    r, k = p.meta.rank, p.meta.d + 1
    Xn = rk.comp_minor(out.X, r, k)
    Xpn = rk.comp_minor(outp.X, r, k)
    live = g.pose_mask > 0
    assert float((Xn[live] - Xpn[:, :n][live]).abs().max()) <= 1e-4
    assert torch.equal(Xpn[:, n:], Xp[:, n:].float())


def test_delta_applied_live_problem_tiles_equal_a_fresh_pad(card):
    """After a streamed delta on the card, the live problem's tile-major
    fields equal a fresh ``pad_problem`` of the same measurements at the
    same shape, bit for bit, and its B2 solve launches once per round."""
    import dataclasses

    from dpgo_tpu_torch.models.incremental import LiveProblem
    from dpgo_tpu_torch.serve import pad_problem
    from dpgo_tpu_torch.types import loop_closure_mask

    meas = make_measurements(np.random.default_rng(2), n=80, d=3,
                             num_lc=30, rot_noise=0.02, trans_noise=0.02)[0]
    lc = np.nonzero(loop_closure_mask(meas))[0]
    keep = np.ones(len(meas), bool)
    keep[lc[-4:]] = False
    base = dataclasses.replace(meas.select(keep), num_poses=meas.num_poses)
    extra = dataclasses.replace(meas.select(~keep), num_poses=meas.num_poses)
    params = AgentParams(d=3, r=5, num_robots=4, rel_change_tol=0.0)
    live = LiveProblem(base, 4, params=params, device=card)
    res0 = live.solve(max_iters=20, grad_norm_tol=1e-9)
    assert live.apply_edges(extra).mode == "delta"
    fresh = pad_problem(rbcd.prepare_problem(live.meas, 4, params,
                                             init=None, device=card),
                        live.shape)
    for f in ("eidx_i", "eidx_j", "rot_t", "trn_t"):
        assert torch.equal(getattr(live.padded.graph, f),
                           getattr(fresh.graph, f)), f
    before = rk.LAUNCHES
    resw = live.warm_dispatch(res0, max_iters=10, grad_norm_tol=1e-12)
    assert rk.LAUNCHES - before == rbcd.rounds_enqueued(
        resw.iterations, max_iters=10, eval_every=1, params=params)


def test_padded_graph_without_tiles_raises_on_card(card):
    """No fallback: a float32 padded problem on the card whose graph lost
    its tile-major fields raises instead of running "ell"."""
    import dataclasses

    from dpgo_tpu_torch.serve import ExecutableCache, run_bucket

    _, padded = _served(card)
    bare = [dataclasses.replace(p, graph=p.graph._replace(
        eidx_i=None, eidx_j=None, rot_t=None, trn_t=None)) for p in padded]
    with pytest.raises(ValueError, match="tile-major edge fields"):
        run_bucket(bare, ExecutableCache(), max_iters=2)


@pytest.mark.parametrize("schedule,verdict_every", [
    (Schedule.JACOBI, None), (Schedule.JACOBI, 4), (Schedule.GREEDY, 4),
    (Schedule.COLORED, None)])
def test_sharded_world_one_over_nccl_equals_solve_rbcd(card, schedule,
                                                       verdict_every):
    """At world size 1 over NCCL the sharded solve is ``solve_rbcd`` bit
    for bit, every float32 round one B2 launch (= ``rounds_enqueued``),
    with both exchanges and both overlap modes."""
    import torch.distributed as dist

    from dpgo_tpu_torch.parallel import sharded

    meas = make_measurements(np.random.default_rng(4), n=120, d=3,
                             num_lc=40, rot_noise=0.03,
                             trans_noise=0.03)[0]
    params = AgentParams(d=3, r=5, num_robots=4, schedule=schedule)
    kw = dict(max_iters=24, grad_norm_tol=1e-3, verdict_every=verdict_every)
    mesh = sharded.make_mesh(device=card)
    assert "nccl" in str(dist.get_backend()).lower() and mesh.size == 1
    ref = rbcd.solve_rbcd(meas, 4, params, device=card, **kw)
    for extra in ({}, {"exchange": "ppermute"}, {"overlap": False}):
        before = rk.LAUNCHES
        got = sharded.solve_rbcd_sharded(meas, 4, mesh=mesh, params=params,
                                         **kw, **extra)
        torch.cuda.synchronize()
        assert got.cost_history == ref.cost_history
        assert got.grad_norm_history == ref.grad_norm_history
        assert (got.iterations, got.terminated_by) == \
            (ref.iterations, ref.terminated_by)
        assert torch.equal(got.T.cpu(), ref.T.cpu())
        assert rk.LAUNCHES - before == rbcd.rounds_enqueued(
            got.iterations, max_iters=24, eval_every=1, params=params,
            verdict_every=verdict_every)


def test_sharded_gn_tail_on_card_reads_twice_per_outer_step(card):
    """The sharded GN tail's CG and backtracking loops run to their bounds
    on the card: two host reads per outer step and the final gate."""
    from dpgo_tpu_torch.parallel import sharded

    meas = make_measurements(np.random.default_rng(4), n=120, d=3,
                             num_lc=40, rot_noise=0.03,
                             trans_noise=0.03)[0]
    params = AgentParams(d=3, r=5, num_robots=4)
    prob = rbcd.prepare_problem(meas, 4, params, device=card)
    st = rbcd.rbcd_steps(rbcd.init_state(prob.graph, prob.meta, prob.X0,
                                         params), prob.graph, 20, prob.meta,
                         params)
    reads = [0]
    orig = rbcd._host_fetch

    def counting(x):
        reads[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    try:
        _, tail = sharded.gn_tail_sharded(
            st.X, prob.graph, prob.meta, mesh=sharded.make_mesh(device=card),
            cfg=refine.GNTailConfig(max_outer=2, grad_norm_tol=1e-9,
                                    cg_max_iters=30))
    finally:
        rbcd._host_fetch = orig
    assert reads[0] == 2 * tail.outer_iterations + (
        tail.terminated_by != "no_decrease")
    assert np.isfinite(tail.cost_history).all()


def _fleet_request(n=60, rounds=8, sid=None):
    from dpgo_tpu_torch.serve import SolveRequest

    meas = make_measurements(np.random.default_rng(1), n=n, d=3,
                             num_lc=20, rot_noise=0.01,
                             trans_noise=0.01)[0]
    return SolveRequest(meas=meas, num_robots=2,
                        params=AgentParams(d=3, r=5, num_robots=2,
                                           rel_change_tol=0.0),
                        max_iters=rounds, grad_norm_tol=1e-12, eval_every=2,
                        session_id=sid)


def _child_events(tdir):
    from dpgo_tpu_torch import obs

    return obs.read_events(str(tdir / "events.jsonl"))


def test_warm_child_binds_the_kernel_library_from_disk(card, tmp_path):
    """A cold child on an empty artifact tier finds the built library and
    stores it; a warm child binds it from the tier (a disk hit, no nvcc,
    no compile seconds) and serves the cold child's result bit for bit;
    each child's B2 launches (its dispatch spans) equal its rounds."""
    import json

    from dpgo_tpu_torch.serve.fleet import ProcServer

    rk.build()
    req = _fleet_request()
    aot = tmp_path / "aot"
    out = {}
    for arm in ("cold", "warm"):
        tdir = tmp_path / arm
        srv = ProcServer(replica_id=arm, device="cuda",
                         aot_cache_dir=str(aot), telemetry_dir=str(tdir),
                         workdir=str(tmp_path), batch_window_s=0.0)
        try:
            res = srv.submit(req).result(timeout=600)
            disk = srv._beat_once()["cache"]["disk"]
        finally:
            srv.close()
        evs = _child_events(tdir)
        spans = [e for e in evs if e.get("event") == "span"
                 and e.get("name") == "device_dispatch"]
        with open(tdir / "metrics.json") as fh:
            fam = json.load(fh)["metrics"].get("serve_compile_seconds_total")
        out[arm] = {"res": res, "disk": disk,
                    "compiles": [e for e in evs
                                 if e.get("event") == "compile_profile"
                                 and "disk_hit" in e],
                    "b2": sum(e["b2_launches"] for e in spans),
                    "rounds": sum(e["rounds"] for e in spans),
                    "compile_s": sum(s["value"] for s in fam["series"])
                    if fam else 0.0}
    cold, warm = out["cold"], out["warm"]
    assert cold["disk"]["disk_misses"] == 1 and cold["disk"]["stores"] == 1
    assert [e["disk_hit"] for e in cold["compiles"]] == [False]
    assert warm["disk"]["disk_hits"] == 1
    assert warm["disk"]["disk_misses"] == 0 and warm["disk"]["stores"] == 0
    assert [e["disk_hit"] for e in warm["compiles"]] == [True]
    assert not any(e.get("nvcc") for e in cold["compiles"] +
                   warm["compiles"])
    assert warm["compile_s"] == 0.0
    assert warm["res"].cost_history == cold["res"].cost_history
    assert torch.equal(warm["res"].T, cold["res"].T)
    for arm in out.values():
        assert arm["b2"] == arm["rounds"] == 8


def test_in_process_replicas_launch_b2_from_two_threads(card, tmp_path):
    """Two in-process replicas on one card under the router, their worker
    threads launching B2 at once: the sessions spread over both replicas,
    one B2 launch per round of every batch, each result within 1e-5 of a
    lone server's final cost."""
    from dpgo_tpu_torch.serve import (FleetRouter, ReplicaManager,
                                      SolveServer)

    reqs = [_fleet_request(n=60 + 70 * i, rounds=12, sid=f"s{i}")
            for i in range(4)]
    with SolveServer(batch_window_s=0.0, device=card) as lone:
        ref = [lone.solve(r, timeout=600) for r in reqs]

    def make_server(rid):
        return SolveServer(batch_window_s=0.0, replica_id=rid, device=card)

    before = rk.LAUNCHES
    with FleetRouter(ReplicaManager(make_server, min_replicas=2)) as router:
        tickets = [router.submit(r) for r in reqs]
        res = [t.result(timeout=600) for t in tickets]
        placed = {t._replica.replica_id for t in tickets}
        batches = sum(r.server.status()["batches_dispatched"]
                      for r in router.manager.replicas())
    assert rk.LAUNCHES - before == 12 * batches and batches >= 2
    assert placed == {"r0", "r1"}
    for a, b in zip(res, ref):
        assert abs(a.cost_history[-1] - b.cost_history[-1]) <= \
            1e-5 * abs(b.cost_history[-1])
        assert a.T.shape == b.T.shape and bool(torch.isfinite(a.T).all())


def test_orbax_pair_round_trips_cuda_tensors_and_loads_the_jax_fixture(
        card, tmp_path):
    """A ``Checkpoint`` of CUDA tensors goes through the port's Orbax pair
    bit for bit (saved through the host, loaded as numpy, put back on the
    card), and the committed checkpoint the JAX package wrote
    (``tests/torch_data/orbax_seed0``) loads to its seed's arrays."""
    import os

    from dpgo_tpu_torch.utils import logger

    gen = torch.Generator(device=card).manual_seed(3)
    X = torch.randn((4, 50, 5, 4), generator=gen, device=card)
    w = torch.rand((4, 70), generator=gen, device=card, dtype=torch.float64)
    logger.save_checkpoint_orbax(logger.Checkpoint(
        X=X, weights=w, mu=torch.tensor(0.125, device=card), iteration=31),
        str(tmp_path))
    for like in (None, logger.Checkpoint(X=X, weights=w, mu=0.0,
                                         iteration=0)):
        got = logger.load_checkpoint_orbax(str(tmp_path), like=like)
        assert torch.equal(torch.from_numpy(got.X).to(card), X)
        assert torch.equal(torch.from_numpy(got.weights).to(card), w)
        assert got.mu == 0.125 and got.iteration == 31

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_data", "orbax_seed0")
    got = logger.load_checkpoint_orbax(fixture)
    rng = np.random.default_rng(0)
    want_X = rng.standard_normal((2, 40, 5, 4)).astype(np.float32)
    want_w = rng.uniform(size=(2, 50))
    assert got.X.dtype == want_X.dtype and got.X.tobytes() == \
        want_X.tobytes()
    assert got.weights.dtype == want_w.dtype and got.weights.tobytes() == \
        want_w.tobytes()
    assert got.mu == 0.25 and got.iteration == 17
