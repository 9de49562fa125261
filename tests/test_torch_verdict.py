"""The port's device-resident verdict loop (``dpgo_tpu_torch.models.rbcd``:
``run_rbcd(verdict_every=K)``, ``make_verdict_program``,
``make_terminal_epilogue``, the ``_host_fetch`` seam) on the CPU in
float64: within the port against its own per-eval loop, bit for bit, and
against the JAX package's loop and programs on the same inputs.

Tolerances: the port's two loops share one metric body, so their
histories are compared with ``==``; across packages the histories are held
at rtol 1e-9 (XLA and PyTorch sum in other orders), scripted verdict steps
exactly (they only compare, select and take minima of given rows).
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
from dpgo_tpu_torch.obs.health import HealthConfig
from dpgo_tpu_torch.utils.synthetic import make_measurements as t_make

A = 2


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meas(seed=42, n=50, noise=0.05, pkg="torch"):
    make = t_make if pkg == "torch" else make_measurements
    return make(np.random.default_rng(seed), n=n, d=3, num_lc=n // 2,
                rot_noise=noise, trans_noise=noise)[0]


def _params(mod, robust=False, **kw):
    if robust:
        kw.update(robust=mod.RobustCostParams(
            cost_type=mod.RobustCostType.GNC_TLS), robust_opt_inner_iters=4)
    return mod.AgentParams(d=3, r=5, num_robots=A, rel_change_tol=0.0, **kw)


#: (max_iters, eval_every, grad_norm_tol, verdict_every, robust) of the
#: JAX package's verdict tests (tests/test_rbcd.py): the whole run to
#: max_iters, a termination latched mid-window, GNC weight updates.
CASES = {"max_iters": (24, 2, 1e-9, 8, False),
         "latched": (200, 1, 2e-2, 8, False),
         "gnc": (20, 2, 1e-9, 4, True)}


def _solve(case, verdict, pkg="torch"):
    max_iters, eval_every, tol, K, robust = CASES[case]
    kw = dict(max_iters=max_iters, eval_every=eval_every, grad_norm_tol=tol,
              verdict_every=K if verdict else None)
    if pkg == "jax":
        return jrbcd.solve_rbcd(_meas(pkg="jax"), A, _params(jconfig, robust),
                                dtype=jnp.float64, **kw)
    return rbcd.solve_rbcd(_meas(), A, _params(tconfig, robust),
                           dtype=torch.float64, device="cpu", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_loop_matches_per_eval_loop_bitwise(case):
    """Histories, reason and round count of the verdict loop equal the
    per-eval loop's bit for bit; at max_iters (no polish rounds past the
    terminal eval) so do the iterate and the weights."""
    a = _solve(case, verdict=False)
    b = _solve(case, verdict=True)
    assert a.cost_history == b.cost_history
    assert a.grad_norm_history == b.grad_norm_history
    assert (a.iterations, a.terminated_by) == (b.iterations, b.terminated_by)
    if case == "latched":
        assert a.terminated_by == "grad_norm"
        assert a.iterations % CASES[case][3] != 0  # latched mid-window
    else:
        assert a.terminated_by == "max_iters"
        assert torch.equal(a.X, b.X)
        assert torch.equal(a.weights, b.weights)
        assert torch.equal(a.T, b.T)


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_loop_matches_jax(case):
    ref = _solve(case, verdict=True, pkg="jax")
    res = _solve(case, verdict=True)
    assert (res.iterations, res.terminated_by) == (ref.iterations,
                                                   ref.terminated_by)
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-9, atol=1e-12)


def _count_fetches(monkeypatch):
    count = [0]
    orig = rbcd._host_fetch

    def counting(x):
        count[0] += 1
        return orig(x)

    monkeypatch.setattr(rbcd, "_host_fetch", counting)
    return count


def test_verdict_loop_fetch_cadence(monkeypatch):
    """One word per K rounds plus one fused terminal epilogue, counted
    through ``_host_fetch``."""
    count = _count_fetches(monkeypatch)
    res = rbcd.solve_rbcd(_meas(), A, _params(tconfig), max_iters=32,
                          eval_every=4, grad_norm_tol=0.0,
                          dtype=torch.float64, device="cpu",
                          verdict_every=16)
    assert res.iterations == 32
    assert count[0] == 32 // 16 + 1


def test_per_eval_loop_fetches_once_per_eval(monkeypatch):
    count = _count_fetches(monkeypatch)
    res = rbcd.solve_rbcd(_meas(), A, _params(tconfig), max_iters=32,
                          eval_every=4, grad_norm_tol=0.0,
                          dtype=torch.float64, device="cpu")
    assert count[0] == len(res.cost_history) == 32 // 4


def test_verdict_every_must_divide_eval_every():
    with pytest.raises(ValueError, match="verdict_every"):
        rbcd.solve_rbcd(_meas(n=20), A, _params(tconfig), max_iters=8,
                        eval_every=3, grad_norm_tol=1e-9,
                        dtype=torch.float64, device="cpu", verdict_every=4)


def test_resilience_hooks_need_the_verdict_loop():
    prob = rbcd.prepare_problem(_meas(n=20), A, _params(tconfig),
                                device="cpu")
    state = rbcd.init_state(prob.graph, prob.meta, prob.X0, prob.params)
    with pytest.raises(ValueError, match="resilience hooks"):
        rbcd.run_rbcd(state, prob.graph, prob.meta, None, prob.part, 4,
                      start_iteration=2)


def test_verdict_word_pack_unpack_roundtrip():
    for status in (rbcd.VERDICT_RUNNING, rbcd.VERDICT_GRAD_NORM,
                   rbcd.VERDICT_CONSENSUS):
        for anom in (rbcd.ANOMALY_NONE, rbcd.ANOMALY_STALL,
                     rbcd.ANOMALY_NON_FINITE):
            for stage in (0, 3, 97):
                w = rbcd.pack_verdict(status, anom, stage)
                assert w == jrbcd.pack_verdict(status, anom, stage)
                dec = rbcd.unpack_verdict(w)
                assert dec == jrbcd.unpack_verdict(w)
                assert dec["stage"] == stage
                assert dec["status"] == rbcd._VERDICT_STATUS[status]
                assert dec["anomaly"] == rbcd._VERDICT_ANOMALY[anom]


@pytest.mark.parametrize("verdict", [False, True], ids=["per_eval",
                                                         "verdict"])
def test_rounds_enqueued_counts_the_speculation(monkeypatch, verdict):
    """``rounds_enqueued`` (the launch gates of chip_smoke.py) equals the
    rounds the segments ran, the discarded speculation included, on a run
    that stops early."""
    rounds = [0]
    orig = rbcd.rbcd_segment

    def counting(s, g, k, m, p, first_update_weights=False,
                 first_restart=False):
        rounds[0] += k
        return orig(s, g, k, m, p, first_update_weights, first_restart)

    monkeypatch.setattr(rbcd, "rbcd_segment", counting)
    params = _params(tconfig, robust=True, robust_opt_num_weight_updates=3)
    kw = dict(max_iters=200, eval_every=2, grad_norm_tol=0.2,
              verdict_every=8 if verdict else None)
    res = rbcd.solve_rbcd(_meas(), A, params, dtype=torch.float64,
                          device="cpu", **kw)
    assert res.terminated_by == "grad_norm"
    assert rounds[0] > res.iterations
    assert rounds[0] == rbcd.rounds_enqueued(res.iterations, params=params,
                                             **{k: v for k, v in kw.items()
                                                if k != "grad_norm_tol"})


# ---------------------------------------------------------------------------
# The verdict program, step by step, against the JAX package's
# ---------------------------------------------------------------------------

def _scripted_rows():
    """(cost, gradnorm, consensus, mu, rel_change) per eval, chosen so that
    every predicate fires: a cost spike, a stall over the 12-eval window,
    a gradient explosion, a non-finite row, GNC stage changes (mu steps),
    a latched gradient-norm termination, then rows after the latch."""
    rows = []
    f, g = 100.0, 1.0
    for k in range(5):  # descent in stage 0
        rows.append((f - k, g / (k + 1), 0.0, 1e-4, 0.1))
    rows.append((400.0, 0.3, 0.0, 1e-4, 0.1))  # cost spike vs stage best
    for k in range(19):  # flat cost: the stall fires at the second window
        rows.append((95.0, 0.3, 0.0, 1e-4, 0.1))
    rows.append((95.0, 1e5, 0.0, 1e-4, 0.1))  # gradient explosion
    rows.append((float("nan"), 0.2, 0.0, 1e-4, 0.1))  # non-finite
    mu = 1e-4
    for k in range(6):  # GNC anneals: a new stage per eval
        mu *= 1.4
        rows.append((90.0 - k, 0.2, 0.0, mu, 0.1))
    rows.append((80.0, 0.2, 0.0, mu, float("inf")))  # non-finite rel_change
    rows.append((79.0, 1e-3, 0.0, mu, 0.1))  # gradient norm: terminal
    rows.append((78.0, 0.5, 1.0, mu, 0.1))  # after the latch
    rows.append((77.0, 0.5, 0.0, mu * 1.4, 0.1))
    return rows


@pytest.mark.parametrize("robust", [True, False], ids=["gnc", "l2"])
def test_verdict_program_matches_jax_step_by_step(robust):
    rows = _scripted_rows()
    rp = jconfig.RobustCostParams(cost_type=jconfig.RobustCostType.GNC_TLS)
    tp = tconfig.RobustCostParams(cost_type=tconfig.RobustCostType.GNC_TLS)
    jstep = jrbcd.make_verdict_program(
        None, None, 0, 0, False, robust_params=rp if robust else None,
        metrics_body=lambda row, w, r, mu, rel: row, grad_norm_tol=1e-2,
        max_evals=len(rows))
    tstep = rbcd.make_verdict_program(
        None, None, 0, 0, False, robust_params=tp if robust else None,
        metrics_body=lambda row, w, r, mu, rel: row, grad_norm_tol=1e-2)
    js = jrbcd.init_verdict_state(len(rows), A, jnp.float64, False)
    ts = interop.verdict_state_from_numpy(jax.tree.map(np.asarray, js),
                                          device="cpu")
    anomalies, stages = set(), set()
    for k, (f, g, c, mu, rel) in enumerate(rows):
        row = np.array([f, g, c])
        it = 3 * (k + 1)
        js = jstep(jnp.asarray(row), None, None, jnp.asarray(mu),
                   jnp.full((A,), rel), jnp.asarray(it, jnp.int32), js)
        ts = tstep(torch.as_tensor(row), None, None,
                   torch.tensor(mu, dtype=torch.float64),
                   torch.full((A,), rel, dtype=torch.float64), it, ts)
        for name in rbcd.VerdictState._fields:
            t, j = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
            assert t.shape == j.shape, name
            np.testing.assert_array_equal(t, j, err_msg=f"{name} at {k}")
        dec = rbcd.unpack_verdict(int(ts.word))
        anomalies.add(dec["anomaly"])
        stages.add(dec["stage"])
    assert anomalies == {None, "cost_spike", "stall", "grad_explosion",
                         "non_finite"}
    assert int(ts.term_eval) == len(rows) - 3
    assert int(ts.term_it) == 3 * (len(rows) - 2)
    assert rbcd.unpack_verdict(int(ts.word))["status"] == "grad_norm"
    assert (len(stages) > 1) == robust


def test_verdict_program_default_health_config_is_the_jax_one():
    from dpgo_tpu.obs.health import HealthConfig as JHealthConfig

    assert HealthConfig().__dict__ == JHealthConfig().__dict__


# ---------------------------------------------------------------------------
# The metric body, the epilogue, the resilience hooks
# ---------------------------------------------------------------------------

def _shared_problem(robust=True):
    """One JAX problem and a state away from its init (moved poses, GNC
    weights, mu and relative changes drawn from a seed), and their port
    copies."""
    jp = _params(jconfig, robust)
    prob = jrbcd.prepare_problem(_meas(n=30, pkg="jax"), A, jp,
                                 dtype=jnp.float64, pallas_sel=True)
    js = jrbcd.init_state(prob.graph, prob.meta, prob.X0, params=jp)
    rng = np.random.default_rng(3)
    js = js._replace(
        X=js.X + 0.05 * rng.standard_normal(js.X.shape),
        weights=jnp.asarray(rng.uniform(0, 1, js.weights.shape)),
        mu=jnp.asarray(3e-3), rel_change=jnp.asarray(rng.uniform(0, 1, A)))
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, prob.graph),
                                     device="cpu")
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    eg_j = jrbcd.edge_set_from_measurements(prob.part.meas_global,
                                            dtype=jnp.float64)
    eg_t = rbcd.edge_set_from_measurements(prob.part.meas_global,
                                           dtype=torch.float64, device="cpu")
    return prob, js, graph, ts, eg_j, eg_t


def test_central_metrics_body_matches_jax_at_telemetry_width():
    prob, js, graph, ts, eg_j, eg_t = _shared_problem()
    n, m = prob.part.meas_global.num_poses, len(prob.part.meas_global)
    jbody = jrbcd._central_metrics_body(prob.graph, eg_j, n, m, True)
    tbody = rbcd._central_metrics_body(graph, eg_t, n, m, True)
    jrow = np.asarray(jbody(js.X, js.weights, js.ready, js.mu,
                            js.rel_change))
    trow = tbody(ts.X, ts.weights, ts.ready, ts.mu, ts.rel_change)
    assert trow.shape == (6 + A,)
    np.testing.assert_allclose(trow.numpy(), jrow, rtol=1e-10)
    narrow = rbcd._central_metrics_body(graph, eg_t, n, m, False)(
        ts.X, ts.weights, ts.ready, ts.mu, ts.rel_change)
    assert torch.equal(narrow, trow[:3])


def test_terminal_epilogue_matches_jax():
    prob, js, graph, ts, eg_j, eg_t = _shared_problem()
    n, m = prob.part.meas_global.num_poses, len(prob.part.meas_global)
    meta = interop.meta_from_numpy(prob.meta)
    jfin = jrbcd.make_terminal_epilogue(prob.graph, eg_j, n, m, prob.meta)(
        js.X, js.weights, {"tail": jnp.arange(2)})
    tfin = rbcd.make_terminal_epilogue(graph, eg_t, n, m, meta)(
        ts.X, ts.weights, {"tail": torch.arange(2)})
    np.testing.assert_allclose(tfin["T"].numpy(), np.asarray(jfin["T"]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tfin["w_glob"].numpy(),
                               np.asarray(jfin["w_glob"]), rtol=1e-12)
    assert tfin["tail"].tolist() == [0, 1]
    # With the device certificate the epilogue also carries the gathered
    # iterate and the payload, computed on the collapsed weights.
    tcert = rbcd.make_terminal_epilogue(graph, eg_t, n, m, meta,
                                        certify_mode="device")(
        ts.X, ts.weights, {})
    jcert = jrbcd.make_terminal_epilogue(prob.graph, eg_j, n, m, prob.meta,
                                         certify_mode="device")(
        js.X, js.weights, {})
    np.testing.assert_allclose(tcert["Xg"].numpy(), np.asarray(jcert["Xg"]),
                               rtol=1e-12, atol=1e-14)
    assert set(tcert["cert"]) == set(jcert["cert"])
    # wscale is deterministic; sigma comes from different probe draws.
    assert float(tcert["cert"]["wscale"]) == float(jcert["cert"]["wscale"])
    np.testing.assert_allclose(float(tcert["cert"]["sigma"]),
                               float(jcert["cert"]["sigma"]), rtol=1e-2)
    assert tcert["cert"]["direction"].shape == (n, 4)


def _run_with_hooks(pkg, start=None):
    """A GNC verdict run with boundary_cb recording (it, nwu, word,
    terminal) and the boundary states; ``start = (it, nwu, state)``
    resumes."""
    seen, states = [], {}
    kw = dict(max_iters=40, grad_norm_tol=1e-9, eval_every=2)
    if pkg == "jax":
        jp = _params(jconfig, robust=True)
        prob = jrbcd.prepare_problem(_meas(pkg="jax"), A, jp,
                                     dtype=jnp.float64)
        g, m = prob.graph, prob.meta
        state = jrbcd.init_state(g, m, prob.X0, params=jp)

        def seg(s, k, uw, rs):
            return jrbcd.rbcd_segment(s, g, k, m, jp, first_update_weights=uw,
                                      first_restart=rs)
        run = lambda st, **hk: jrbcd.run_rbcd(  # noqa: E731
            st, g, m, None, prob.part, dtype=jnp.float64, params=jp,
            segment=seg, verdict_every=8, **kw, **hk)
    else:
        tp = _params(tconfig, robust=True)
        prob = rbcd.prepare_problem(_meas(), A, tp, dtype=torch.float64,
                                    device="cpu")
        g, m = prob.graph, prob.meta
        state = rbcd.init_state(g, m, prob.X0, params=tp)

        def seg(s, k, uw, rs):
            return rbcd.rbcd_segment(s, g, k, m, tp, first_update_weights=uw,
                                     first_restart=rs)
        run = lambda st, **hk: rbcd.run_rbcd(  # noqa: E731
            st, g, m, seg, prob.part, dtype=torch.float64, params=tp,
            verdict_every=8, **kw, **hk)

    def cb(it, nwu, st, word, terminal):
        seen.append((it, nwu, word, terminal))
        states[it] = (nwu, st)

    if start is None:
        return run(state, boundary_cb=cb), seen, states
    it0, nwu0, st0 = start
    return run(st0, boundary_cb=cb, start_iteration=it0,
               start_num_weight_updates=nwu0), seen, states


def test_boundary_cb_sequence_matches_jax_and_resume_reproduces_suffix():
    jres, jseen, _ = _run_with_hooks("jax")
    res, seen, states = _run_with_hooks("torch")
    assert seen == jseen
    assert seen[-1][3] and not any(s[3] for s in seen[:-1])
    assert len(seen) == 40 // 8
    assert (res.iterations, res.terminated_by) == (jres.iterations,
                                                   jres.terminated_by)
    # Resume at the second boundary from the state it saw: the same flags
    # from the absolute round index, the uninterrupted run's suffix.
    nwu, st = states[16]
    assert nwu > 0 and st.iteration == 16
    res2, seen2, _ = _run_with_hooks("torch", start=(16, nwu, st))
    assert res2.cost_history == res.cost_history[16 // 2:]
    assert res2.grad_norm_history == res.grad_norm_history[16 // 2:]
    assert (res2.iterations, res2.terminated_by) == (res.iterations,
                                                     res.terminated_by)
    assert torch.equal(res2.X, res.X)
    assert [s[:2] for s in seen2] == [s[:2] for s in seen[2:]]
