"""The port's single-readback refinement (``dpgo_tpu_torch.models.
refine_fused``) against the JAX package's (``dpgo_tpu.models.refine_fused``)
and against the port's own host recenter, on the CPU.

Both packages start from the same float32 handoff iterate: a JAX float32
descent on a synthetic problem built from a numpy seed (the JAX test's
``_problem``).  The JAX side builds its graph without edge tiles, so its
refine rounds run its XLA formulation; the port's graph is the same graph
with edge tiles, carried across by ``interop``, and its rounds run the plain
"ell" formulation on the CPU.

Tolerances: the df32 recenter against JAX's — R at 1e-12 and f_ref at 1e-12
relative (df32 on both sides, float64 reconstruction), the float32
constants at 3e-6 of their scale (a float32 rounding of the same df32
value, or of a float32 product in another order), chol at 1e-5 relative
(float32 factorizations from the float64 graph's blocks); against the host
float64 recenter, the JAX test's bounds (``tests/test_refine_fused.py``).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.config import SolverParams as JSolverParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models import refine_fused as jfused
from dpgo_tpu.ops import df32 as jdf32
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import local_pgo, rbcd, refine, refine_fused
from dpgo_tpu_torch.ops import df32
from dpgo_tpu_torch.utils.partition import partition_contiguous

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread, not a pool spinning on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(n=40, A=3, r=5, rounds=60, seed=0):
    """The JAX test's problem: a float32 JACOBI descent of ``rounds``
    rounds from the chordal init (JAX package), and both packages' graphs
    and params."""
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=3,
                                num_lc=n // 2, rot_noise=0.02,
                                trans_noise=0.02)
    solver = dict(grad_norm_tol=1e-12, max_inner_iters=10)
    jp = JAgentParams(d=3, r=r, num_robots=A, rel_change_tol=0.0,
                      solver=JSolverParams(**solver))
    tp = AgentParams(d=3, r=r, num_robots=A, rel_change_tol=0.0,
                     solver=SolverParams(**solver))
    part = jpartition(meas, A)
    jg, jm = jrbcd.build_graph(part, r, jnp.float32, pallas_sel=True)
    jgx, _ = jrbcd.build_graph(part, r, jnp.float32, pallas_sel=False)
    X0 = jrbcd.centralized_chordal_init(part, jm, jgx, jnp.float32)
    state = jrbcd.init_state(jgx, jm, X0, params=jp)
    state = jrbcd.rbcd_steps(state, jgx, rounds, jm, jp)
    Xg32 = np.asarray(jrbcd.gather_to_global(state.X, jgx, meas.num_poses),
                      np.float32)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu")
    return SimpleNamespace(
        meas=meas, part=part, jp=jp, tp=tp, jgx=jgx, jm=jm, graph=graph,
        meta=interop.meta_from_numpy(jm), Xg32=Xg32,
        tpart=partition_contiguous(meas, A))


def _port_gp(h):
    return refine_fused.build_global_df(h.tpart.meas_global, device="cpu")


def _jax_recenter(h, target=0.0, max_rounds=64, check_every=4):
    fns = jfused.make_fused_fns(h.jm, h.jp, h.meas.num_poses,
                                max_rounds=max_rounds,
                                check_every=check_every)
    gp = jfused.build_global_df(h.part.meas_global)
    out = fns.recenter(jnp.asarray(h.Xg32), gp, h.jgx,
                       jdf32.from_f64(np.float64(target)))
    return fns, gp, out


def test_build_global_df_is_float32_and_matches_jax():
    h = _problem()
    gp = _port_gp(h)
    jgp = jfused.build_global_df(h.part.meas_global)
    for f in ("Rm", "tm", "kap", "tau"):
        ours, theirs = getattr(gp, f), getattr(jgp, f)
        assert ours.hi.dtype == ours.lo.dtype == torch.float32, f
        assert np.array_equal(ours.hi.numpy(), np.asarray(theirs.hi)), f
        assert np.array_equal(ours.lo.numpy(), np.asarray(theirs.lo)), f
    for f in ("i", "j", "w", "inc_slot", "inc_mask"):
        assert np.array_equal(getattr(gp, f).numpy(),
                              np.asarray(getattr(jgp, f))), f
    assert gp.w.dtype == gp.inc_mask.dtype == torch.float32


def test_recenter_device_matches_jax():
    h = _problem()
    _, _, (jR, jf, jc, jrho, _) = _jax_recenter(h)
    R, f_ref, consts, rho32 = refine_fused.recenter_device(
        torch.as_tensor(h.Xg32), _port_gp(h), h.graph, h.meta, h.tp,
        h.meas.num_poses)
    assert R.hi.dtype == R.lo.dtype == f_ref.hi.dtype == torch.float32
    np.testing.assert_allclose(df32.to_f64(R), jdf32.to_f64(jR),
                               rtol=0, atol=1e-12)
    assert float(df32.to_f64(f_ref)) == pytest.approx(
        float(jdf32.to_f64(jf)), rel=1e-12)
    for name in ("R", "Rz", "G_ref", "g0", "S0"):
        ours = getattr(consts, name)
        theirs = np.asarray(getattr(jc, name), np.float64)
        assert ours.dtype == torch.float32 and ours.is_contiguous(), name
        scale = max(np.abs(theirs).max(), 1e-12)
        assert np.abs(ours.double().numpy() - theirs).max() <= 3e-6 * scale
    for ours, theirs in zip(rho32, jrho):
        theirs = np.asarray(theirs, np.float64)
        assert np.abs(ours.double().numpy() - theirs).max() <= \
            3e-6 * max(np.abs(theirs).max(), 1e-12)
    np.testing.assert_allclose(consts.chol.double().numpy(),
                               np.asarray(jc.chol, np.float64), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jc.chol).max()))


def test_recenter_device_builds_every_host_field():
    """Every field the host ``refine.recenter`` builds, in its shape and
    type, so ``refine.refine_kernel_operands`` feeds B4 unchanged.  The
    layouts of the reference point, the weights and the factors agree with
    the host's from the same point; the residual tiles are the global
    residuals (``rho32``) in each agent's edge order (the host's come from
    the graph's float32 measurements, not the float64 ones, so they are
    compared with a float64 recompute in ``test_recenter_device_matches_
    host``)."""
    h = _problem()
    _, _, consts, rho32 = refine_fused.recenter_device(
        torch.as_tensor(h.Xg32), _port_gp(h), h.graph, h.meta, h.tp,
        h.meas.num_poses)
    host = refine.recenter(h.Xg32.astype(np.float64), h.graph, h.meta,
                           h.tp, refine.host_edges_f64(h.tpart.meas_global))
    for f in refine.RefineConstants._fields:
        ours, theirs = getattr(consts, f), getattr(host.consts, f)
        assert ours is not None and ours.dtype == torch.float32, f
        assert ours.shape == theirs.shape and ours.is_contiguous(), f
    for f in ("Rc", "wk_t", "wt_t", "Lc"):
        theirs = getattr(host.consts, f).double().numpy()
        scale = max(np.abs(theirs).max(), 1e-12)
        assert np.abs(getattr(consts, f).double().numpy()
                      - theirs).max() <= 3e-6 * scale, f
    A, nt, _, T = h.graph.eidx_i.shape
    E_a, mid = h.meta.e_max, h.graph.meas_id.numpy()
    mask = h.graph.edges.mask.numpy().astype(np.float32)
    for f, rho in (("rho_rot_t", rho32[0]), ("rho_trn_t", rho32[1])):
        per = rho.numpy()[mid] * mask.reshape(mask.shape + (1,) * (
            rho.dim() - 1))
        rows = int(np.prod(per.shape[2:]))
        flat = np.zeros((A, rows, nt * T), np.float32)
        flat[:, :, :E_a] = per.reshape(A, E_a, rows).transpose(0, 2, 1)
        want = flat.reshape(A, rows, nt, T).transpose(0, 2, 1, 3)
        assert np.array_equal(getattr(consts, f).numpy(), want), f
    assert consts.inc_mask_f is h.graph.inc_mask
    D = torch.zeros(consts.R.shape)
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, h.graph), h.graph)
    assert len(refine.refine_kernel_operands(D, Dz, consts, h.graph)) == 18


def test_recenter_device_matches_host():
    """The JAX test of the same name: the device df32 recenter against the
    host float64 one at the same float32 input."""
    h = _problem()
    gp = _port_gp(h)
    edges_g = refine.host_edges_f64(h.tpart.meas_global)
    R, f_ref, consts, rho32 = refine_fused.recenter_device(
        torch.as_tensor(h.Xg32), gp, h.graph, h.meta, h.tp,
        h.meas.num_poses)
    host = refine.recenter(h.Xg32.astype(np.float64), h.graph, h.meta,
                           h.tp, edges_g)
    assert np.max(np.abs(df32.to_f64(R) - host.Xg)) < 1e-9
    assert abs(float(df32.to_f64(f_ref)) - host.f_ref) / host.f_ref < 1e-9
    for name in ("R", "Rz"):
        dev = getattr(consts, name).double().numpy()
        hst = getattr(host.consts, name).double().numpy()
        assert np.max(np.abs(dev - hst)) < 3e-6 * max(np.abs(hst).max(),
                                                       1e-12), name
    # The gradient constants against a float64 global recompute from the
    # float64 edges (the host recenter uses the graph's float32 edges).
    e64 = refine.np_edges_batched(edges_g)
    G, rR64, rt64, _ = refine._np_egrad(host.Xg[None], e64,
                                        host.Xg.shape[0])
    G = G[0]
    RY = host.Xg[..., :3]
    S0 = refine._np_sym(np.swapaxes(RY, -1, -2) @ G[..., :3])
    g0 = G.copy()
    g0[..., :3] -= RY @ S0
    gi = h.graph.global_index.numpy()
    pm = h.graph.pose_mask.numpy()[..., None, None]
    for name, ref_arr in (("G_ref", G[gi] * pm), ("g0", g0[gi] * pm),
                          ("S0", S0[gi] * pm)):
        dev = getattr(consts, name).double().numpy()
        assert np.max(np.abs(dev - ref_arr)) < 3e-6 * max(
            np.abs(ref_arr).max(), 1e-12), name
    rho_R, rho_t = (x.double().numpy() for x in rho32)
    assert np.max(np.abs(rho_R - rR64[0])) < 3e-6 * np.abs(rR64).max()
    assert np.max(np.abs(rho_t - rt64[0])) < 3e-6 * np.abs(rt64).max()
    dev = consts.chol.double().numpy()
    hst = host.consts.chol.double().numpy()
    assert np.max(np.abs(dev - hst)) < 1e-4 * max(np.abs(hst).max(), 1.0)


@pytest.mark.parametrize("target_rel", [1e-5, 1e-3, 5e-8])
def test_refine_until_matches_jax_rounds(target_rel):
    """Fed JAX's constants, residuals and threshold, the port's
    ``refine_until`` stops at JAX's round, with its D.  The iterate sits
    9.5e-8 above f*, so targets 1e-5 and 1e-3 below it are never met and
    both packages spend the whole budget; 5e-8 below it is met within the
    budget, and the chunks enqueued after that are frozen: with twice the
    budget, D, the rounds and delta are the same bit for bit."""
    h = _problem(rounds=40)
    f_now = refine.global_cost(refine._np_project_manifold(
        h.Xg32.astype(np.float64), 3),
        refine.host_edges_f64(h.tpart.meas_global))
    target = f_now * (1.0 - target_rel)
    fns, _, (jR, jf, jc, jrho, jthr) = _jax_recenter(
        h, target, max_rounds=48, check_every=4)
    jD, jrounds, jdelta = fns.refine(jc, h.jgx, jfused.build_global_df(
        h.part.meas_global), jrho, jthr)
    consts = interop.refine_consts_from_numpy(
        jax.tree.map(np.asarray, jc), device="cpu")
    rho = tuple(torch.as_tensor(np.asarray(x)) for x in jrho)
    thr = torch.as_tensor(np.asarray(jthr))
    gp = _port_gp(h)
    D0 = torch.zeros(consts.R.shape)

    def run(max_rounds):
        return refine_fused.refine_until(D0, consts, h.graph, h.meta, h.tp,
                                         gp, rho, thr, h.meas.num_poses,
                                         max_rounds, 4)
    D, rounds, delta = run(48)
    assert 0 < int(rounds) == int(jrounds)
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=0,
                               atol=1e-5 * float(np.abs(jD).max()))
    assert float(delta) == pytest.approx(float(jdelta), rel=1e-3)
    met = target_rel < 1e-6
    assert (int(rounds) < 48) == met
    if met:
        Df, rounds_f, delta_f = run(96)
        assert torch.equal(Df, D) and int(rounds_f) == int(rounds)
        assert torch.equal(delta_f, delta)


def test_fused_pipeline_reaches_verified_gap():
    """Descent iterate -> two fused cycles -> one readback through
    ``rbcd._host_fetch`` -> host float64 verify at 1e-6 relative
    suboptimality; the oracle agrees with the verify to 1e-8."""
    h = _problem(rounds=80)
    res = local_pgo.solve_local(h.tpart.meas_global, rank=h.meta.rank,
                                grad_norm_tol=1e-11, max_iters=400,
                                dtype=torch.float64, device="cpu")
    f_opt = float(res.cost)
    rel_gap = 1e-6
    gp = _port_gp(h)
    edges_g = refine.host_edges_f64(h.tpart.meas_global)
    target = df32.from_f64(np.float64(f_opt * (1.0 + 0.3 * rel_gap)), "cpu")
    fns = refine_fused.make_fused_fns(h.meta, h.tp, h.meas.num_poses,
                                      max_rounds=96, check_every=4)
    out = refine_fused.run_fused_cycles(fns, torch.as_tensor(h.Xg32), gp,
                                        h.graph, target, cycles=2)
    flat = rbcd._host_fetch(refine_fused.pack_result(out))
    host = refine_fused.unpack_result_host(
        flat, h.meas.num_poses, h.meta.rank, 4, tuple(out.D.shape))
    assert host.rounds == int(out.rounds)
    X64 = refine._np_project_manifold(
        refine_fused.assemble_f64(host, h.graph), 3)
    f = refine.global_cost(X64, edges_g)
    gap = f / f_opt - 1.0
    assert gap <= rel_gap, f"verified gap {gap:.3e}"
    f_oracle = float(np.float64(host.f_ref_hi) + np.float64(host.f_ref_lo)) \
        + float(host.delta)
    assert abs(f_oracle - f) / f_opt < 1e-8


def test_oracle_exits_immediately_when_converged():
    """A cycle starting below target refines 0 rounds, and its D stays 0."""
    h = _problem(rounds=60)
    gp = _port_gp(h)
    f_now = refine.global_cost(
        refine._np_project_manifold(h.Xg32.astype(np.float64), 3),
        refine.host_edges_f64(h.tpart.meas_global))
    target = df32.from_f64(np.float64(f_now * (1.0 + 1e-3)), "cpu")
    fns = refine_fused.make_fused_fns(h.meta, h.tp, h.meas.num_poses,
                                      max_rounds=8, check_every=4)
    R, f_ref, consts, rho32, thr = fns.recenter(
        torch.as_tensor(h.Xg32), gp, h.graph, target)
    D, rounds, delta = fns.refine(consts, h.graph, gp, rho32, thr)
    assert int(rounds) == 0
    assert float(delta) <= float(thr)
    assert not bool(D.any())
    # Every chunk is enqueued and each one frozen, however many there are.
    D, rounds, delta = refine_fused.refine_until(
        torch.zeros(consts.R.shape), consts, h.graph, h.meta, h.tp, gp,
        rho32, thr, h.meas.num_poses, 32, 4)
    assert int(rounds) == 0 and not bool(D.any())


def test_pack_unpack_round_trip():
    h = _problem()
    g = h.graph
    rng = np.random.default_rng(3)
    N, r = h.meas.num_poses, h.meta.rank
    res = refine_fused.FusedCycleResult(
        *(torch.as_tensor(rng.standard_normal(s).astype(np.float32))
          for s in ((N, r, 4), (N, r, 4), (3, h.meta.n_max, r, 4))),
        torch.tensor(812.5), torch.tensor(1e-5), torch.tensor(-2e-3),
        torch.tensor(24, dtype=torch.int32))
    flat = refine_fused.pack_result(res)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    back = refine_fused.unpack_result_host(flat, N, r, 4, tuple(res.D.shape))
    for a, b in zip(res[:3], back[:3]):
        assert np.array_equal(a.numpy(), b)
    assert back.rounds == 24 and back.f_ref_hi == np.float32(812.5)
    Xn = refine_fused.next_iterate(res, g, N)
    assert Xn.dtype == torch.float32 and Xn.shape == (N, r, 4)
