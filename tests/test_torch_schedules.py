"""The port's whole RBCD round (``dpgo_tpu_torch.models.rbcd``) against the
JAX package's ``rbcd_step``, round for round, in float64 on the CPU: the
GREEDY, ASYNC and COLORED schedules, Nesterov acceleration with restart
rounds, GNC (weight updates, the freeze, no warm start) and the other
robust weights, plus fused segments and whole solves.  Both sides start
from the JAX package's state, carried across by ``dpgo_tpu_torch.interop``.

Tolerance: rtol 1e-9 (summation order differs between XLA and PyTorch;
the rounds amplify it mildly), atol 1e-12 for entries that cancel to ~0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import config as jconfig
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.utils.synthetic import make_measurements as t_make

A = 4
TOL = dict(rtol=1e-9, atol=1e-12)


def _params(schedule="JACOBI", robust=None, solver=None, **kw):
    """The same configuration in both packages."""
    def build(mod):
        rob = dict(robust or {})
        if "cost_type" in rob:
            rob["cost_type"] = mod.RobustCostType[rob["cost_type"]]
        return mod.AgentParams(d=3, r=5, num_robots=A,
                               schedule=mod.Schedule[schedule],
                               robust=mod.RobustCostParams(**rob),
                               solver=mod.SolverParams(**(solver or {})),
                               **kw)
    return build(jconfig), build(tconfig)


def _meas(seed, outliers=0, n=24, num_lc=10):
    return make_measurements(np.random.default_rng(seed), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05, outlier_lc=outliers)[0]


def _setup(jp, seed=0, outliers=0, state_seed=0):
    prob = jrbcd.prepare_problem(_meas(seed, outliers), A, params=jp,
                                 dtype=jnp.float64, pallas_sel=True)
    js = jrbcd.init_state(prob.graph, prob.meta, prob.X0, seed=state_seed,
                          params=jp)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, prob.graph),
                                     device="cpu")
    meta = interop.meta_from_numpy(prob.meta)
    return prob, js, graph, meta


def _port_state(js, seed=0):
    return interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                    device="cpu", seed=seed)


def _assert_states(ts, js):
    for f in ("X", "weights", "rel_change", "V", "gamma", "alpha", "mu",
              "X_init"):
        t, j = getattr(ts, f), getattr(js, f)
        assert (t is None) == (j is None), f
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                       err_msg=f)
    assert ts.iteration == int(js.iteration)
    assert np.array_equal(ts.ready.numpy(), np.asarray(js.ready))


def _flags(it, jp):
    """The host's schedule flags of round ``it + 1`` (no update cap)."""
    robust_on = jp.robust.cost_type != jconfig.RobustCostType.L2
    uw = robust_on and (it + 1) % jp.robust_opt_inner_iters == 0
    rs = jp.acceleration and (it + 1) % jp.restart_interval == 0
    return uw, rs


def _run_both(jp, tp, rounds, seed=0, outliers=0):
    prob, js, graph, meta = _setup(jp, seed, outliers)
    ts = _port_state(js)
    for it in range(rounds):
        uw, rs = _flags(it, jp)
        js = jrbcd.rbcd_step(js, prob.graph, prob.meta, jp,
                             update_weights=uw, restart=rs)
        ts = rbcd.rbcd_step(ts, graph, meta, tp, update_weights=uw,
                            restart=rs)
        _assert_states(ts, js)
    return ts, js


@pytest.mark.parametrize("case", [
    dict(schedule="GREEDY"),
    dict(schedule="COLORED", rel_change_tol=0.0),
    dict(acceleration=True, restart_interval=3),
    dict(schedule="COLORED", acceleration=True, restart_interval=4),
    dict(schedule="GREEDY", acceleration=True, restart_interval=3),
], ids=["greedy", "colored", "jacobi-nesterov-restart", "colored-nesterov",
        "greedy-nesterov"])
def test_schedules_and_nesterov_match_jax_round_for_round(case):
    jp, tp = _params(**case)
    _run_both(jp, tp, rounds=7)


@pytest.mark.parametrize("case", [
    dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
         robust_opt_inner_iters=2),
    dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
         robust_opt_inner_iters=2, robust_opt_warm_start=False),
    dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
         robust_opt_inner_iters=2, acceleration=True, restart_interval=5,
         schedule="COLORED"),
    dict(robust=dict(cost_type="Huber", huber_threshold=0.5),
         robust_opt_inner_iters=2),
    dict(robust=dict(cost_type="TLS", tls_threshold=5.0),
         robust_opt_inner_iters=2),
    dict(robust=dict(cost_type="GM"), robust_opt_inner_iters=2),
], ids=["gnc", "gnc-no-warm-start", "gnc-colored-nesterov", "huber", "tls",
        "gm"])
def test_robust_rounds_match_jax_round_for_round(case):
    jp, tp = _params(rel_change_tol=1e-8, **case)
    ts, _ = _run_both(jp, tp, rounds=7, seed=1, outliers=3)
    assert ts.iteration == 7


@pytest.mark.parametrize("ordinal", [2, 3])
def test_gnc_freeze_matches_jax(ordinal):
    """A flagged round with every loop-closure weight in {0, 1}: from the
    third update on it freezes (weights, mu and X as a plain round would
    leave them); before it, mu still anneals.  The ratio is read from the
    pre-update weights."""
    jp, tp = _params(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
                     robust_opt_inner_iters=5)
    prob, js, graph, meta = _setup(jp, seed=2, outliers=3)
    w_conv = jnp.where(prob.graph.edges.is_lc > 0,
                       jnp.round(prob.graph.edges.weight),
                       prob.graph.edges.weight)
    js = js._replace(weights=w_conv, mu=jnp.asarray(7.0, jnp.float64),
                     iteration=jnp.asarray(ordinal * 5 - 1, jnp.int32))
    ts = _port_state(js)
    js = jrbcd.rbcd_step(js, prob.graph, prob.meta, jp, update_weights=True)
    ts = rbcd.rbcd_step(ts, graph, meta, tp, update_weights=True)
    _assert_states(ts, js)
    assert (float(ts.mu) == 7.0) == (ordinal >= 3)


def test_async_matches_jax_with_replayed_draws(monkeypatch):
    """ASYNC against JAX with the JAX package's own Bernoulli draws,
    computed here from its key chain (``rbcd.py:1019-1020, 1063-1064``)
    and replayed through the port's one seam, ``rbcd._async_fired``."""
    seed, p, rounds = 3, 0.5, 6
    jp, tp = _params(schedule="ASYNC", async_update_prob=p,
                     rel_change_tol=0.0)
    key = jax.random.split(jax.random.PRNGKey(seed), A)
    masks = []
    for _ in range(rounds):
        split = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        key, sub = split[:, 0], split[:, 1]
        masks.append(np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p))(sub)))
    assert 0 < np.sum(masks) < rounds * A  # some fire, some do not

    def replay(seed_, iteration, num_robots, prob, device):
        assert (seed_, num_robots, prob) == (seed, A, p)
        return torch.as_tensor(np.array(masks[iteration]), device=device)

    monkeypatch.setattr(rbcd, "_async_fired", replay)
    prob, js, graph, meta = _setup(jp, state_seed=seed)
    ts = _port_state(js, seed=seed)
    for _ in range(rounds):
        js = jrbcd.rbcd_step(js, prob.graph, prob.meta, jp)
        ts = rbcd.rbcd_step(ts, graph, meta, tp)
        _assert_states(ts, js)
    assert np.array_equal(np.asarray(js.key), np.asarray(key))


def test_async_draws_are_bernoulli_and_repeat():
    fired = torch.stack([rbcd._async_fired(7, it, 8, 0.3,
                                           torch.device("cpu"))
                         for it in range(400)])
    again = rbcd._async_fired(7, 5, 8, 0.3, torch.device("cpu"))
    assert torch.equal(again, fired[5])
    assert abs(float(fired.double().mean()) - 0.3) < 0.03


def test_async_with_acceleration_raises():
    jp, tp = _params(schedule="ASYNC", acceleration=True)
    _, js, graph, meta = _setup(jp)
    with pytest.raises(ValueError, match="acceleration"):
        rbcd.rbcd_step(_port_state(js), graph, meta, tp)


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True)])
def test_fused_segment_equals_sequential_rounds(flags):
    uw, rs = flags
    jp, tp = _params(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
                     acceleration=True, restart_interval=5,
                     robust_opt_inner_iters=5)
    _, js, graph, meta = _setup(jp, outliers=2)
    s0 = _port_state(js)
    seq = rbcd.rbcd_step(s0, graph, meta, tp, update_weights=uw, restart=rs)
    for _ in range(4):
        seq = rbcd.rbcd_step(seq, graph, meta, tp)
    fused = rbcd.rbcd_segment(s0, graph, 5, meta, tp,
                              first_update_weights=uw, first_restart=rs)
    assert fused.iteration == seq.iteration == 5
    for f in ("X", "weights", "V", "gamma", "alpha", "mu", "rel_change",
              "ready", "chol"):
        assert torch.equal(getattr(fused, f), getattr(seq, f)), f


def test_dispatch_segments_follow_schedule_bounds(monkeypatch):
    """``dispatch_prepared`` dispatches one segment per stretch, each
    headed by the round the JAX package's ``schedule_bounds`` flags; the
    result equals per-round dispatch bit for bit."""
    jp, tp = _params(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
                     acceleration=True, restart_interval=6,
                     robust_opt_inner_iters=4, rel_change_tol=1e-14)
    meas = t_make(np.random.default_rng(4), n=24, d=3, num_lc=10,
                  rot_noise=0.01, trans_noise=0.01, outlier_lc=2)[0]
    prob = rbcd.prepare_problem(meas, A, tp, device="cpu")
    calls = []
    orig = rbcd.rbcd_segment

    def counting(s, g, k, m, p, first_update_weights=False,
                 first_restart=False):
        calls.append((s.iteration, k, first_update_weights, first_restart))
        return orig(s, g, k, m, p, first_update_weights, first_restart)

    monkeypatch.setattr(rbcd, "rbcd_segment", counting)
    res7 = rbcd.dispatch_prepared(prob, max_iters=25, grad_norm_tol=0.0,
                                  eval_every=7)
    expect, it, nwu = [], 0, 0
    while it < 25:
        uw, rs, end = jrbcd.schedule_bounds(
            it, nwu, max_iters=25, eval_every=7, params=jp, robust_on=True,
            accel_on=True)
        expect.append((it, end - it, uw, rs))
        nwu += int(uw)
        it = end
    assert calls == expect
    monkeypatch.setattr(rbcd, "rbcd_segment", orig)
    res1 = rbcd.dispatch_prepared(prob, max_iters=25, grad_norm_tol=0.0,
                                  eval_every=1)
    assert torch.equal(res7.X, res1.X)
    assert torch.equal(res7.weights, res1.weights)


@pytest.mark.parametrize("case", [
    dict(robust=dict(cost_type="GNC_TLS", gnc_barc=0.5),
         robust_opt_inner_iters=5, schedule="COLORED",
         solver=dict(grad_norm_tol=1e-6)),
    dict(acceleration=True, restart_interval=10),
], ids=["gnc-colored", "nesterov"])
def test_solve_rbcd_matches_jax(case):
    jp, tp = _params(rel_change_tol=1e-8, **case)
    outliers = 3 if "robust" in case else 0
    kw = dict(max_iters=40, grad_norm_tol=1e-4, eval_every=5)
    ref = jrbcd.solve_rbcd(_meas(5, outliers), A, jp, dtype=jnp.float64,
                           **kw)
    meas = t_make(np.random.default_rng(5), n=24, d=3, num_lc=10,
                  rot_noise=0.05, trans_noise=0.05, outlier_lc=outliers)[0]
    res = rbcd.solve_rbcd(meas, A, tp, dtype=torch.float64, device="cpu",
                          **kw)
    assert res.iterations == ref.iterations
    assert res.terminated_by == ref.terminated_by
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(ref.weights),
                               **TOL)
    if outliers:
        assert np.all(res.weights.numpy()[-outliers:] < 0.5)


def test_greedy_updates_one_agent_on_the_kernel_formulation(monkeypatch):
    """GREEDY through the kernel's formulation (its plain version on the
    CPU, float32): exactly the argmax agent changes, and the wrapper was
    handed that one agent's slices."""
    tp = tconfig.AgentParams(d=3, r=5, num_robots=A,
                             schedule=tconfig.Schedule.GREEDY,
                             solver=tconfig.SolverParams(pallas_tcg=True))
    meas = t_make(np.random.default_rng(6), n=24, d=3, num_lc=10,
                  rot_noise=0.05, trans_noise=0.05)[0]
    prob = rbcd.prepare_problem(meas, A, tp, dtype=torch.float32,
                                device="cpu")
    g, m = prob.graph, prob.meta
    state = rbcd.init_state(g, m, prob.X0, tp)
    seen = []
    orig = rbcd.rtr_kernel.rtr_full

    def spy(*args, **kw):
        seen.append(args[6].shape[0])
        return orig(*args, **kw)

    monkeypatch.setattr(rbcd.rtr_kernel, "rtr_full", spy)
    for _ in range(3):
        gn = rbcd.gradient_pass(state.X, g, m)[1]
        new = rbcd.rbcd_step(state, g, m, tp)
        changed = (new.X != state.X).any(dim=(1, 2, 3))
        assert changed.nonzero().flatten().tolist() == \
            [int(torch.argmax(gn))]
        state = new
    assert seen == [1, 1, 1]
