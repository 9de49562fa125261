"""The port's serving plane (``dpgo_tpu_torch.serve``) on the CPU in
float64: bucketing, the program cache, the batched runner and the solve
server, held against the JAX package's ``dpgo_tpu.serve`` on the same
seeded problems, plus the port counterparts of ``tests/test_serve.py``.

Tolerances: padded arrays equal the JAX package's exactly (indices and
values); the batched runner's members equal JAX's ``run_bucket`` members
at rtol 1e-9 (XLA and PyTorch sum in other orders), and each member of a
mixed batch equals its own solve at rtol 1e-9; the port's verdict batch
equals its per-eval batch with ``==``.  Inputs cross as numpy arrays; the
padded initial iterate is carried from the JAX package so both sides
start from one point (the chordal inits themselves agree to 1e-12).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.serve import bucketing as jbucket
from dpgo_tpu.serve import cache as jcache
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import obs
from dpgo_tpu_torch.config import AgentParams, Schedule, SolverParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.serve import (BucketShape, ExecutableCache,
                                  OverCapacityError, ServeSLO, SolveRequest,
                                  SolveServer, bucket_shape_of, pad_problem,
                                  problem_fingerprint, run_bucket)
from dpgo_tpu_torch.serve import runner
from dpgo_tpu_torch.serve.cache import fingerprint_key

PARAMS = AgentParams(d=3, r=5, num_robots=2)
TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=24, seed=0, num_lc=5, noise=0.01):
    return make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=num_lc, rot_noise=noise,
                             trans_noise=noise)[0]


def _request(meas, **kw):
    kw.setdefault("params", PARAMS)
    kw.setdefault("max_iters", 4)
    kw.setdefault("grad_norm_tol", 1e-12)
    kw.setdefault("eval_every", 2)
    return SolveRequest(meas=meas, num_robots=2, **kw)


def _server(**kw):
    kw.setdefault("device", "cpu")
    return SolveServer(**kw)


def _prepare(meas, A=2, params=PARAMS):
    return rbcd.prepare_problem(meas, A, params=params, init=None,
                                device="cpu")


# ---------------------------------------------------------------------------
# Bucketing: the padded arrays equal the JAX package's
# ---------------------------------------------------------------------------

#: MultiAgentGraph fields both packages' padded graphs carry.
_GRAPH_FIELDS = ("meas_id", "n", "pose_mask", "pub_idx", "pub_mask",
                 "nbr_robot", "nbr_pub", "nbr_mask", "global_index",
                 "inc_slot", "inc_mask", "color")


@pytest.mark.parametrize("A,quantum", [(2, 32), (3, 64)])
def test_pad_problem_arrays_equal_jax(A, quantum):
    """Same problem, same bucket: every padded array equals the JAX
    package's (indices exactly, values at rtol 0), and so do the bucket
    shape, the padded meta and the global edge set; the padded chordal
    init agrees to 1e-12."""
    meas = _problem(n=40, seed=2, num_lc=12)
    jp = jconfig.AgentParams(d=3, r=5, num_robots=A)
    tp = AgentParams(d=3, r=5, num_robots=A)
    jprob = jrbcd.prepare_problem(meas, A, params=jp, dtype=jnp.float64,
                                  init=None, pallas_sel=False)
    tprob = _prepare(meas, A, tp)
    shape = bucket_shape_of(tprob, quantum)
    assert tuple(shape) == tuple(jbucket.bucket_shape_of(jprob, quantum))
    jpad = jbucket.pad_problem(jprob, jbucket.BucketShape(*shape))
    tpad = pad_problem(tprob, shape)
    tmeta = dataclasses.asdict(tpad.meta)
    assert tmeta == {k: getattr(jpad.meta, k) for k in tmeta}
    for f in ("i", "j", "R", "t", "kappa", "tau", "weight", "mask", "is_lc",
              "fixed_weight"):
        np.testing.assert_array_equal(
            getattr(tpad.graph.edges, f).numpy(),
            np.asarray(getattr(jpad.graph.edges, f)), err_msg=f)
        np.testing.assert_array_equal(
            getattr(tpad.edges_g, f).numpy(),
            np.asarray(getattr(jpad.edges_g, f)), err_msg=f)
    for f in _GRAPH_FIELDS:
        np.testing.assert_array_equal(
            getattr(tpad.graph, f).numpy(),
            np.asarray(getattr(jpad.graph, f)), err_msg=f)
    np.testing.assert_allclose(tpad.X0.numpy(), np.asarray(jpad.X0),
                               rtol=0, atol=1e-12)


def test_padded_tiles_are_the_tile_layout_of_the_padded_rows():
    """The port rebuilds the kernel's tile-major fields at the bucket
    shape (the JAX package drops them): each live edge row's endpoints,
    rotation and translation sit at its tile slot, every other slot
    points at the bucket's pad index ``n_max + s_max``."""
    tprob = _prepare(_problem(n=40, seed=2, num_lc=12), 3,
                     AgentParams(d=3, r=5, num_robots=3))
    shape = bucket_shape_of(tprob, 64)
    g = pad_problem(tprob, shape).graph
    T, nt = rbcd.edge_tile_shape(shape.n_max, shape.s_max, shape.e_max)
    assert g.eidx_i.shape == (3, nt, 1, T)
    ei = g.eidx_i.reshape(3, nt * T)[:, :shape.e_max].numpy()
    mask = g.edges.mask.numpy() > 0
    np.testing.assert_array_equal(ei[mask], g.edges.i.numpy()[mask])
    assert (ei[~mask] == shape.n_max + shape.s_max).all()
    assert (g.eidx_j.reshape(3, -1)[:, shape.e_max:].numpy()
            == shape.n_max + shape.s_max).all()
    rot = g.rot_t.permute(0, 2, 1, 3).reshape(3, 9, nt * T)
    np.testing.assert_array_equal(
        rot[:, :, :shape.e_max].numpy(),
        g.edges.R.float().permute(0, 2, 3, 1).reshape(3, 9, -1).numpy())


def test_bucket_shapes_coalesce_nearby_and_split_far_sizes():
    pa = _prepare(_problem(n=24, seed=0))
    pb = _prepare(_problem(n=28, seed=1))
    pc = _prepare(_problem(n=200, seed=2, num_lc=40))
    sa, sb = bucket_shape_of(pa, 64), bucket_shape_of(pb, 64)
    sc = bucket_shape_of(pc, 64)
    assert sa == sb  # within one quantum: same bucket
    assert sa != sc  # far apart: different bucket
    assert isinstance(sa, BucketShape)


def test_pad_problem_rejects_too_small_bucket():
    p = _prepare(_problem(n=40, seed=0))
    tiny = BucketShape(n_max=1, e_max=1, s_max=1, p_max=1, k_inc=1,
                       n_total=1, num_meas=1)
    with pytest.raises(ValueError, match="smaller than problem"):
        pad_problem(p, tiny)


# ---------------------------------------------------------------------------
# The fingerprint-keyed program cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(),
    dict(schedule="GREEDY", acceleration=True),
    dict(robust="GNC_TLS", certify_mode="device"),
    dict(solver=dict(pallas_sel_mode="bf16x3", dense_quadratic=True)),
], ids=["jacobi", "greedy-nesterov", "gnc-certify", "solver"])
def test_problem_fingerprint_keys_equal_jax(case):
    """A fingerprint's JSON is the JAX package's for the same problem,
    configuration, dtype, bucket, batch width and kind."""
    def build(mod):
        kw = dict(case)
        if "schedule" in kw:
            kw["schedule"] = mod.Schedule[kw["schedule"]]
        if "robust" in kw:
            kw["robust"] = mod.RobustCostParams(
                cost_type=mod.RobustCostType[kw["robust"]])
        if "solver" in kw:
            kw["solver"] = mod.SolverParams(**kw["solver"])
        return mod.AgentParams(d=3, r=5, num_robots=2, **kw)

    meas = _problem(n=30, seed=4, num_lc=8)
    tprob = _prepare(meas, 2, build(tconfig))
    shape = bucket_shape_of(tprob, 32)
    meta = pad_problem(tprob, shape).meta
    jmeta = jrbcd.GraphMeta(**dataclasses.asdict(meta))
    for batch, kind in ((None, None), (4, "segment"), (8, "epilogue:off")):
        fp = problem_fingerprint(meta, build(tconfig), torch.float64,
                                 shape, batch, kind)
        jfp = jcache.problem_fingerprint(jmeta, build(jconfig),
                                         jnp.float64, shape, batch, kind)
        assert fingerprint_key(fp) == jcache.fingerprint_key(jfp)


def test_executable_cache_identical_fingerprints_reuse():
    meta = rbcd.GraphMeta(num_robots=2, n_max=32, e_max=64, s_max=8,
                          p_max=8, d=3, rank=5)
    shape = BucketShape(32, 64, 8, 8, 8, 64, 64)
    cache = ExecutableCache()
    builds = []
    fp = problem_fingerprint(meta, PARAMS, torch.float64, shape, 2,
                             "segment")
    for _ in range(3):
        cache.get(problem_fingerprint(meta, PARAMS, torch.float64, shape, 2,
                                      "segment"),
                  lambda: builds.append(1) or "exe")
    assert cache.compiles == 1 and len(builds) == 1
    assert cache.hits == 2
    assert fingerprint_key(fp) == fingerprint_key(
        problem_fingerprint(meta, PARAMS, torch.float64, shape, 2,
                            "segment"))


def test_executable_cache_rank_dtype_schedule_miss():
    meta = rbcd.GraphMeta(num_robots=2, n_max=32, e_max=64, s_max=8,
                          p_max=8, d=3, rank=5)
    shape = BucketShape(32, 64, 8, 8, 8, 64, 64)
    cache = ExecutableCache()
    cache.get(problem_fingerprint(meta, PARAMS, torch.float64, shape, 2,
                                  "segment"), lambda: "exe")
    meta_r6 = dataclasses.replace(meta, rank=6)
    cache.get(problem_fingerprint(meta_r6, PARAMS, torch.float64, shape, 2,
                                  "segment"), lambda: "exe-r6")
    cache.get(problem_fingerprint(meta, PARAMS, torch.float32, shape, 2,
                                  "segment"), lambda: "exe-f32")
    greedy = AgentParams(d=3, r=5, num_robots=2, schedule=Schedule.GREEDY)
    cache.get(problem_fingerprint(meta, greedy, torch.float64, shape, 2,
                                  "segment"), lambda: "exe-greedy")
    assert cache.compiles == 4 and cache.hits == 0
    assert len(cache) == 4


# ---------------------------------------------------------------------------
# The batched runner against the JAX package's and against its own solves
# ---------------------------------------------------------------------------

A_BATCH = 3
#: The batch-axis cases: every schedule, Nesterov with restarts, GNC (its
#: freeze and mu per member; with the warm start off, the restart from
#: each member's initial guess) and GNC plus Nesterov.
SCHEDULES = {
    "jacobi": dict(),
    "greedy": dict(schedule="GREEDY"),
    "async": dict(schedule="ASYNC", async_update_prob=0.5),
    "colored": dict(schedule="COLORED"),
    "nesterov": dict(acceleration=True, restart_interval=3),
    "gnc": dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
                robust_opt_inner_iters=2),
    "gnc-no-warm-start": dict(robust=dict(cost_type="GNC_TLS",
                                          gnc_barc=0.5),
                              robust_opt_inner_iters=2,
                              robust_opt_warm_start=False),
    "gnc-nesterov": dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
                         robust_opt_inner_iters=2, acceleration=True,
                         restart_interval=5),
}


def _both_params(case):
    def build(mod):
        kw = dict(case)
        if "schedule" in kw:
            kw["schedule"] = mod.Schedule[kw["schedule"]]
        if "robust" in kw:
            rob = dict(kw["robust"])
            rob["cost_type"] = mod.RobustCostType[rob["cost_type"]]
            kw["robust"] = mod.RobustCostParams(**rob)
        return mod.AgentParams(d=3, r=5, num_robots=A_BATCH,
                               rel_change_tol=0.0, **kw)
    return build(jconfig), build(tconfig)


def _mixed_batch(jp, tp):
    """Three mixed-size problems (one with outliers), padded into one
    bucket in both packages; the port's members start from JAX's padded
    initial iterate."""
    metas = [make_measurements(np.random.default_rng(s), n=n, d=3,
                               num_lc=lc, rot_noise=0.05, trans_noise=0.05,
                               outlier_lc=o)[0]
             for s, n, lc, o in ((0, 24, 8, 0), (1, 27, 9, 2),
                                 (2, 30, 10, 0))]
    jprobs = [jrbcd.prepare_problem(m, A_BATCH, params=jp,
                                    dtype=jnp.float64, init=None,
                                    pallas_sel=False) for m in metas]
    tprobs = [_prepare(m, A_BATCH, tp) for m in metas]
    shapes = [bucket_shape_of(p, 32) for p in tprobs]
    shape = BucketShape(*[max(v) for v in zip(*shapes)])
    jpad = [jbucket.pad_problem(p, jbucket.BucketShape(*shape))
            for p in jprobs]
    tpad = [dataclasses.replace(pad_problem(p, shape),
                                X0=torch.as_tensor(np.asarray(j.X0)))
            for p, j in zip(tprobs, jpad)]
    return jpad, tpad


def _jax_async_draws(p: float, rounds: int):
    """The Bernoulli clocks every JAX member draws (identical keys:
    ``init_state``'s ``split(PRNGKey(0), A)``), round by round."""
    key = jax.random.split(jax.random.PRNGKey(0), A_BATCH)
    masks = []
    for _ in range(rounds):
        split = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        key, sub = split[:, 0], split[:, 1]
        masks.append(np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p))(sub)))
    return masks


def _replay_async(monkeypatch, case, rounds):
    if case.get("schedule") != "ASYNC":
        return
    masks = _jax_async_draws(case["async_update_prob"], rounds)

    def replay(seed, iteration, num_robots, prob, device):
        assert num_robots == A_BATCH
        return torch.as_tensor(masks[iteration], device=device)

    monkeypatch.setattr(rbcd, "_async_fired", replay)


def _assert_results(a, b, exact=False):
    assert (a.iterations, a.terminated_by) == (b.iterations, b.terminated_by)
    if exact:
        assert a.cost_history == b.cost_history
        assert a.grad_norm_history == b.grad_norm_history
    np.testing.assert_allclose(a.cost_history, b.cost_history, **TOL)
    np.testing.assert_allclose(a.grad_norm_history, b.grad_norm_history,
                               **TOL)
    for f in ("T", "X", "weights"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)), **TOL,
                                   err_msg=f)


MAX_ITERS, EVAL_EVERY, K = 12, 2, 4


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_run_bucket_member_equals_its_own_solve(case, monkeypatch):
    """The batch keeps each member to itself: every member of a mixed
    batch equals the member's own solve (``dispatch_prepared`` of its
    padded problem from the same start) at every schedule and at GNC +
    Nesterov — the exchange stays within the member, and GNC's freeze
    and mu, Nesterov's A, GREEDY's argmax, COLORED's classes and ASYNC's
    clocks stay per member."""
    _, tp = _both_params(SCHEDULES[case])
    if SCHEDULES[case].get("schedule") == "ASYNC":
        real = rbcd._async_fired
        monkeypatch.setattr(
            rbcd, "_async_fired",
            lambda s, it, a, p, dev: real(3, it, a, p, dev))
    metas = [make_measurements(np.random.default_rng(s), n=n, d=3,
                               num_lc=lc, rot_noise=0.05, trans_noise=0.05,
                               outlier_lc=o)[0]
             for s, n, lc, o in ((0, 24, 8, 0), (1, 27, 9, 2),
                                 (2, 30, 10, 0))]
    tprobs = [_prepare(m, A_BATCH, tp) for m in metas]
    shape = BucketShape(*[max(v) for v in zip(
        *[bucket_shape_of(p, 32) for p in tprobs])])
    tpad = [pad_problem(p, shape) for p in tprobs]
    res, _ = run_bucket(tpad, ExecutableCache(), max_iters=MAX_ITERS,
                        grad_norm_tol=1e-12, eval_every=EVAL_EVERY)
    for p, r in zip(tpad, res):
        own = rbcd.dispatch_prepared(
            rbcd.PreparedProblem(part=p.prob.part, graph=p.graph,
                                 meta=p.meta, params=tp,
                                 dtype=torch.float64, X0=p.X0),
            max_iters=MAX_ITERS, grad_norm_tol=1e-12,
            eval_every=EVAL_EVERY)
        assert (r.iterations, r.terminated_by) == \
            (own.iterations, own.terminated_by)
        np.testing.assert_allclose(r.cost_history, own.cost_history, **TOL)
        np.testing.assert_allclose(
            r.X.numpy(), own.X[:, :r.X.shape[1]].numpy(), **TOL)
        np.testing.assert_allclose(
            r.weights.numpy(), own.weights[:r.weights.shape[0]].numpy(),
            **TOL)


def test_stacked_graph_keeps_exchange_within_members():
    """``stack_graphs`` offsets each member's neighbor robots, global pose
    indices and measurement ids into its own block."""
    tpad = _mixed_batch(*_both_params({}))[1]
    meta, shape = tpad[0].meta, tpad[0].shape
    g = runner.stack_graphs([p.graph for p in tpad], meta, shape.n_total,
                            shape.num_meas)
    A = meta.num_robots
    for b, p in enumerate(tpad):
        rows = slice(b * A, (b + 1) * A)
        m = p.graph.nbr_mask > 0
        assert torch.equal(g.nbr_robot[rows][m], p.graph.nbr_robot[m] + b * A)
        assert torch.equal(g.global_index[rows],
                           p.graph.global_index + b * shape.n_total)
        assert torch.equal(g.meas_id[rows],
                           p.graph.meas_id + b * shape.num_meas)
        assert torch.equal(g.eidx_i[rows], p.graph.eidx_i)


def test_run_bucket_refuses_mixed_shapes():
    pa = _prepare(_problem(n=24, seed=0))
    pb = _prepare(_problem(n=24, seed=1))
    padded_a = pad_problem(pa, bucket_shape_of(pa, 32))
    padded_b = pad_problem(pb, bucket_shape_of(pb, 128))
    with pytest.raises(ValueError, match="never mix incompatible shapes"):
        run_bucket([padded_a, padded_b], ExecutableCache(), max_iters=1)


def test_run_bucket_refuses_members_at_other_rounds():
    p = _prepare(_problem(n=24, seed=0))
    padded = pad_problem(p, bucket_shape_of(p, 32))
    st = rbcd.init_state(padded.graph, padded.meta, padded.X0,
                         params=PARAMS)
    late = dataclasses.replace(padded, state0=st._replace(iteration=6))
    with pytest.raises(ValueError, match="one round index"):
        run_bucket([padded, late], ExecutableCache(), max_iters=2)


def test_padded_batched_solve_matches_sequential():
    """A batch of mixed-size problems padded into one bucket agrees with
    per-problem ``solve_rbcd`` on costs and trajectories — padding is
    masking, not new math."""
    metas = [_problem(n=24, seed=0), _problem(n=27, seed=1, num_lc=6)]
    seq = [rbcd.solve_rbcd(m, 2, params=PARAMS, max_iters=4,
                           grad_norm_tol=1e-12, eval_every=2, device="cpu")
           for m in metas]
    probs = [_prepare(m) for m in metas]
    shapes = [bucket_shape_of(p, 64) for p in probs]
    assert shapes[0] == shapes[1]
    padded = [pad_problem(p, shapes[0]) for p in probs]
    results, info = run_bucket(padded, ExecutableCache(), max_iters=4,
                               grad_norm_tol=1e-12, eval_every=2)
    assert info["size"] == 2 and info["batch"] == 2
    for a, b in zip(seq, results):
        np.testing.assert_allclose(a.cost_history, b.cost_history,
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(a.T.numpy(), b.T.numpy(), atol=1e-7)
        assert a.T.shape == b.T.shape
        np.testing.assert_allclose(a.weights.numpy(), b.weights.numpy(),
                                   atol=1e-8)


def test_run_bucket_verdict_mode_matches_legacy_and_fetch_count(
        monkeypatch):
    """The batched verdict vector reproduces the per-eval batch's
    histories, reasons and round counts — members latching at different
    evals included — with one ``[B]`` word fetch per K rounds plus the
    terminal fetch; the per-eval batch fetches one row per eval plus
    the terminal fetch."""
    metas = [_problem(n=24, seed=0), _problem(n=27, seed=1, num_lc=6)]
    padded = [pad_problem(p, bucket_shape_of(_prepare(metas[0]), 64))
              for p in (_prepare(m) for m in metas)]
    fetches = []
    real = rbcd._host_fetch
    monkeypatch.setattr(rbcd, "_host_fetch",
                        lambda x: fetches.append(1) or real(x))
    res_a, info_a = run_bucket(padded, ExecutableCache(), max_iters=8,
                               grad_norm_tol=1e-3, eval_every=2)
    assert len(fetches) == info_a["evals"] + 1
    fetches.clear()
    res_b, info_b = run_bucket(padded, ExecutableCache(), max_iters=8,
                               grad_norm_tol=1e-3, eval_every=2,
                               verdict_every=4)
    assert len(fetches) == -(-info_b["rounds"] // 4) + 1
    assert info_b["rounds"] >= info_a["rounds"]
    for a, b in zip(res_a, res_b):
        assert (a.iterations, a.terminated_by) == \
            (b.iterations, b.terminated_by)
        assert a.cost_history == b.cost_history
        assert a.grad_norm_history == b.grad_norm_history
    with pytest.raises(ValueError, match="verdict_every"):
        run_bucket(padded, ExecutableCache(), max_iters=4,
                   grad_norm_tol=1e-3, eval_every=3, verdict_every=4)


def test_forced_kernel_without_tiles_raises():
    """No fallback: a padded graph that reaches the kernel without its
    tile-major fields raises instead of running the ELL formulation."""
    params = AgentParams(d=3, r=5, num_robots=2,
                         solver=SolverParams(pallas_tcg=True))
    p = rbcd.prepare_problem(_problem(), 2, params=params, init=None,
                             dtype=torch.float32, device="cpu")
    padded = pad_problem(p, bucket_shape_of(p, 32))
    res, _ = run_bucket([padded], ExecutableCache(), max_iters=1)
    assert np.isfinite(res[0].cost_history).all()  # the plain version
    bare = dataclasses.replace(padded, graph=padded.graph._replace(
        eidx_i=None, eidx_j=None, rot_t=None, trn_t=None))
    with pytest.raises(ValueError, match="tile-major edge fields"):
        run_bucket([bare], ExecutableCache(), max_iters=1)


# ---------------------------------------------------------------------------
# Server: warm pools, batching, admission control, deadlines
# ---------------------------------------------------------------------------

def test_warm_pool_prebuilds_bucket_programs():
    with _server(max_batch=2, batch_window_s=0.005, quantum=64) as srv:
        assert srv.warm([_request(_problem(n=24, seed=3))]) == 1
        built = srv.cache.compiles
        assert built >= 3  # segment + metrics + epilogue
        res = srv.solve(_request(_problem(n=25, seed=4)), timeout=300)
        assert np.isfinite(res.cost_history[-1])
        # Same bucket, same batch width: the live request reused the
        # warmed programs — the build counter stayed flat.
        assert srv.cache.compiles == built
        assert srv.cache.hits >= 3


def test_server_concurrent_mixed_sizes_match_sequential():
    metas = [_problem(n=24 + k, seed=k) for k in range(4)]
    seq = [rbcd.solve_rbcd(m, 2, params=PARAMS, max_iters=4,
                           grad_norm_tol=1e-12, eval_every=2, device="cpu")
           for m in metas]
    with _server(max_batch=4, batch_window_s=0.05, quantum=64) as srv:
        tickets = [srv.submit(_request(m, tenant=f"t{k % 2}"))
                   for k, m in enumerate(metas)]
        results = [t.result(timeout=300) for t in tickets]
    for a, b in zip(seq, results):
        assert abs(a.cost_history[-1] - b.cost_history[-1]) <= \
            1e-8 * max(1.0, abs(a.cost_history[-1]))


def test_server_result_matches_jax_server():
    """One request through the port's server and the JAX package's: the
    same histories (rtol 1e-9), reason and trajectory."""
    from dpgo_tpu.serve import SolveRequest as JRequest
    from dpgo_tpu.serve import SolveServer as JServer

    meas = _problem(n=26, seed=5, num_lc=7)
    jp = jconfig.AgentParams(d=3, r=5, num_robots=2)
    with JServer(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        a = srv.solve(JRequest(meas=meas, num_robots=2, params=jp,
                               max_iters=6, grad_norm_tol=1e-12,
                               eval_every=2), timeout=300)
    with _server(max_batch=2, batch_window_s=0.0, quantum=64) as srv:
        b = srv.solve(_request(meas, max_iters=6), timeout=300)
    assert (a.iterations, a.terminated_by) == (b.iterations, b.terminated_by)
    np.testing.assert_allclose(b.cost_history, a.cost_history, rtol=1e-9)
    np.testing.assert_allclose(b.T.numpy(), np.asarray(a.T), rtol=1e-9,
                               atol=1e-10)


def test_admission_queue_full_and_tenant_quota(monkeypatch):
    monkeypatch.setattr(SolveServer, "_dispatch_once",
                        lambda self: time.sleep(0.01))
    srv = _server(max_batch=2, max_queue=2, tenant_quota=2,
                  batch_window_s=0.0)
    try:
        m = _problem()
        srv.submit(_request(m, tenant="a"))
        srv.submit(_request(m, tenant="b"))
        with pytest.raises(OverCapacityError) as exc:
            srv.submit(_request(m, tenant="c"))
        assert exc.value.reason == "queue"
    finally:
        srv.close()
    srv = _server(max_batch=2, max_queue=16, tenant_quota=1,
                  batch_window_s=0.0)
    try:
        t1 = srv.submit(_request(m, tenant="a"))
        with pytest.raises(OverCapacityError) as exc:
            srv.submit(_request(m, tenant="a"))
        assert exc.value.reason == "tenant_quota"
        srv.submit(_request(m, tenant="b"))  # other tenants unaffected
    finally:
        srv.close()
    with pytest.raises(OverCapacityError) as exc:
        t1.result(timeout=5)
    assert exc.value.reason == "closed"


def test_deadline_expired_request_is_shed():
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        t = srv.submit(_request(_problem(), deadline_s=0.0))
        with pytest.raises(OverCapacityError) as exc:
            t.result(timeout=30)
        assert exc.value.reason == "deadline"


def test_bad_request_reports_instead_of_killing_worker():
    with _server(max_batch=2, batch_window_s=0.0) as srv:
        t = srv.submit(SolveRequest(meas=_problem(), num_robots=0,
                                    params=PARAMS))
        with pytest.raises(Exception):
            t.result(timeout=60)
        res = srv.solve(_request(_problem(n=24, seed=9)), timeout=300)
        assert np.isfinite(res.cost_history[-1])


def test_server_on_missing_cuda_raises():
    """The server defaults to the card and does not move to the CPU on
    its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolveServer(max_batch=2)


def test_submissions_from_many_threads_are_safe():
    metas = [_problem(n=24, seed=k) for k in range(4)]
    results = [None] * 4
    with _server(max_batch=4, batch_window_s=0.05, quantum=64) as srv:
        def go(k):
            results[k] = srv.solve(_request(metas[k]), timeout=300)

        threads = [threading.Thread(target=go, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    assert all(r is not None and np.isfinite(r.cost_history[-1])
               for r in results)


def test_server_verdict_every_plumbs_to_dispatch():
    """``SolveServer(verdict_every=K)`` solves through the batched verdict
    loop and returns the per-eval server's result; a request whose
    eval_every does not divide K runs the per-eval loop."""
    meas = _problem()
    with _server(max_batch=4, verdict_every=4) as srv:
        r_v = srv.submit(_request(meas, eval_every=2)).result(timeout=60)
        r_l = srv.submit(_request(meas, eval_every=3)).result(timeout=60)
    with _server(max_batch=4) as srv:
        r_ref = srv.submit(_request(meas, eval_every=2)).result(timeout=60)
    assert r_v.cost_history == r_ref.cost_history
    assert np.isfinite(r_l.cost_history).all()


# ---------------------------------------------------------------------------
# SLO telemetry and the zero-overhead fence
# ---------------------------------------------------------------------------

def test_serving_slo_metrics_and_report_section(tmp_path):
    run_dir = str(tmp_path / "serve_run")
    with obs.run_scope(run_dir):
        with _server(max_batch=4, batch_window_s=0.05, quantum=64) as srv:
            tickets = [srv.submit(_request(_problem(n=24 + k, seed=k),
                                           tenant=f"t{k % 2}"))
                       for k in range(3)]
            for t in tickets:
                t.result(timeout=300)
            shed = srv.submit(_request(_problem(), deadline_s=0.0))
            with pytest.raises(OverCapacityError):
                shed.result(timeout=30)
    from dpgo_tpu_torch.obs.report import render_report, report_data

    text = render_report(run_dir)
    assert "serving:" in text
    assert "tenant t0" in text and "latency p50" in text
    assert "shed:" in text
    srv_stats = report_data(run_dir)["serving"]
    assert srv_stats["tenants"]["t0"]["requests"] >= 1
    assert srv_stats["tenants"]["t0"]["latency_p99_s"] is not None
    assert srv_stats["batches"]["count"] >= 1
    assert any(s["reason"] == "deadline" for s in srv_stats["shed"])
    data = report_data(run_dir)
    assert "serve_solve_latency_seconds" in data["metrics"]
    assert "serve_requests_total" in data["metrics"]


def test_telemetry_off_serving_constructs_no_obs_objects(monkeypatch,
                                                         tmp_path):
    """With no ambient run, a full submit -> batch -> result cycle
    constructs no obs objects and emits nothing: no spans, no HTTP
    sidecar (even with metrics_port set), no profiler window (even with
    profile_dir set), no SLO trackers, no first-call profiling."""
    import dpgo_tpu_torch.obs.events as events_mod
    import dpgo_tpu_torch.obs.health as health_mod
    import dpgo_tpu_torch.obs.metrics as metrics_mod
    import dpgo_tpu_torch.obs.profile as profile_mod
    import dpgo_tpu_torch.obs.run as run_mod
    import dpgo_tpu_torch.obs.trace as trace_mod
    import dpgo_tpu_torch.serve.server as server_mod
    import dpgo_tpu_torch.serve.statusz as statusz_mod

    assert obs.get_run() is None

    def boom(*a, **kw):
        raise AssertionError("obs touched with telemetry off")

    monkeypatch.setattr(events_mod.EventStream, "emit", boom)
    monkeypatch.setattr(run_mod, "materialize", boom)
    monkeypatch.setattr(obs, "materialize", boom)
    monkeypatch.setattr(run_mod.TelemetryRun, "set_fingerprint", boom)
    monkeypatch.setattr(metrics_mod.MetricsRegistry, "counter", boom)
    monkeypatch.setattr(metrics_mod.MetricsRegistry, "gauge", boom)
    monkeypatch.setattr(metrics_mod.MetricsRegistry, "histogram", boom)
    monkeypatch.setattr(metrics_mod.Counter, "inc", boom)
    monkeypatch.setattr(metrics_mod.Gauge, "set", boom)
    monkeypatch.setattr(trace_mod.Span, "__init__", boom)
    monkeypatch.setattr(trace_mod, "emit_span", boom)
    monkeypatch.setattr(health_mod.HealthMonitor, "__init__", boom)
    monkeypatch.setattr(statusz_mod.MetricsSidecar, "__init__", boom)
    monkeypatch.setattr(profile_mod.ProfiledExecutable, "__init__", boom)
    monkeypatch.setattr(profile_mod.ProfilerWindow, "__init__", boom)
    monkeypatch.setattr(profile_mod, "aot_compile_profile", boom)
    monkeypatch.setattr(server_mod._SloTracker, "__init__", boom)

    with _server(max_batch=2, batch_window_s=0.005, quantum=64,
                 metrics_port=0, profile_dir=str(tmp_path / "prof"),
                 slo=ServeSLO(latency_s=1e-9)) as srv:
        assert srv.sidecar is None
        assert srv._profiler is None
        res = srv.solve(_request(_problem(n=24, seed=11)), timeout=300)
        t = srv.submit(_request(_problem(), deadline_s=0.0))
        with pytest.raises(OverCapacityError):
            t.result(timeout=30)
        assert srv._slo_state == {}
    assert np.isfinite(res.cost_history[-1])
