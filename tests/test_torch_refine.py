"""The port's re-centered terminal refinement (``dpgo_tpu_torch.models.
refine``, and the plain version of its fused kernel in ``ops.rtr_kernel``)
against the JAX package's (``dpgo_tpu.models.refine``, with
``pallas_tcg.rtr_refine_full_call`` in interpreter mode).

Both packages start from the same float64 handoff iterate: a JAX float32
descent on a synthetic problem built from a numpy seed.  The per-agent
graph reaches the port through ``interop``; the refinement's float64 host
iterate is numpy in both.  Refinement computes in float32 on both sides
(the constants ship as float32 even under x64).
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
from dpgo_tpu.models import refine as jrefine
from dpgo_tpu.ops import pallas_tcg as ptcg
from dpgo_tpu.types import edge_set_from_measurements as jedge_set
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.config import AgentParams, ROptAlg, SolverParams
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.ops import quadratic
from dpgo_tpu_torch.ops import rtr_kernel as rk

#: The JAX refine test's bounds (``tests/test_refine.py:158-159``).
D_ATOL, GN_ATOL = 2e-6, 1e-6
KW = dict(max_iters=10, kappa=0.1, theta=1.0, initial_radius=100.0,
          max_rejections=10, grad_tol=1e-12)
ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "rho_rot", "rho_trn",
         "Rc", "Dc", "Dzc", "g0c", "Grefc", "S0c", "Lc", "inc_slot",
         "inc_mask", "n_local")


@functools.lru_cache(maxsize=None)
def _handoff(d=3, r=5, n=60, A=3, rounds=300):
    """The f32 descent's handoff iterate (JAX package, XLA formulation) and
    both packages' graphs: the JAX graph with edge tiles (kernel
    formulation), the JAX graph without (XLA formulation), the port's."""
    meas, _ = make_measurements(np.random.default_rng(0), n=n, d=d,
                                num_lc=n // 2, rot_noise=0.02,
                                trans_noise=0.02)
    solver = dict(grad_norm_tol=1e-12, max_inner_iters=10)
    jp = JAgentParams(d=d, r=r, num_robots=A, rel_change_tol=0.0,
                      solver=JSolverParams(**solver))
    tp = AgentParams(d=d, r=r, num_robots=A, rel_change_tol=0.0,
                     solver=SolverParams(**solver))
    part = jpartition(meas, A)
    jg, jm = jrbcd.build_graph(part, r, jnp.float32, pallas_sel=True)
    jgx, _ = jrbcd.build_graph(part, r, jnp.float32, pallas_sel=False)
    X0 = jrbcd.centralized_chordal_init(part, jm, jgx, jnp.float32)
    state = jrbcd.init_state(jgx, jm, X0, params=jp)
    state = jrbcd.rbcd_steps(state, jgx, rounds, jm, jp)
    Xg = np.asarray(jrbcd.gather_to_global(state.X, jgx, meas.num_poses),
                    np.float64)
    eg = jedge_set(part.meas_global, dtype=jnp.float32)
    graph = interop.graph_from_numpy(jax.tree.map(np.asarray, jg),
                                     device="cpu")
    # Down-weighted loop closures, as a converged GNC would leave them.
    wA = (np.where(np.asarray(jgx.edges.is_lc) > 0, 0.25, 1.0)
          * np.asarray(jgx.edges.mask)).astype(np.float32)
    wg = jrbcd.global_weights(jnp.asarray(wA), jgx, len(part.meas_global))
    eg_w = eg._replace(weight=wg.astype(eg.weight.dtype))
    return SimpleNamespace(
        meas=meas, jp=jp, tp=tp, jg=jg, jgx=jgx, jm=jm, graph=graph,
        meta=interop.meta_from_numpy(jm), Xg=Xg, eg=eg,
        eg_np=jax.tree.map(np.asarray, eg), wA=wA, eg_w=eg_w,
        eg_w_np=jax.tree.map(np.asarray, eg_w))


def _recentered(h):
    jr = jrefine.recenter(h.Xg, h.jg, h.jm, h.jp, h.eg)
    tr = refine.recenter(h.Xg, h.graph, h.meta, h.tp, h.eg_np)
    return jr, tr


def _d0(h, seed=1, scale=1e-4):
    """A random correction; padded poses hold none, as in refinement."""
    D = np.random.default_rng(seed).standard_normal(
        (h.meta.num_robots, h.meta.n_max, h.meta.rank, h.meta.d + 1))
    return (D * scale * h.graph.pose_mask.numpy()[:, :, None, None]) \
        .astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_recenter_matches_jax_bitwise(weighted):
    h = _handoff()
    kw = dict(weights=h.wA) if weighted else {}
    eg, eg_np = (h.eg_w, h.eg_w_np) if weighted else (h.eg, h.eg_np)
    jr = jrefine.recenter(h.Xg, h.jg, h.jm, h.jp, eg,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = refine.recenter(h.Xg, h.graph, h.meta, h.tp, eg_np,
                         **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(tr.Xg, jr.Xg, rtol=1e-12, atol=0)
    assert tr.f_ref == pytest.approx(jr.f_ref, rel=1e-12)
    # The numpy is copied, so every float32 constant is bit for bit equal;
    # the interop converter carries the JAX constants across unchanged.
    carried = interop.refine_consts_from_numpy(
        jax.tree.map(np.asarray, jr.consts), device="cpu")
    for f in jr.consts._fields:
        ours = getattr(tr.consts, f)
        assert ours.dtype == torch.float32 and ours.is_contiguous(), f
        assert np.array_equal(ours.numpy(), np.asarray(getattr(jr.consts,
                                                                f))), f
        assert torch.equal(getattr(carried, f), ours), f
    # The port's one extra field: the graph's incidence mask in float32.
    assert set(refine.RefineConstants._fields) - set(jr.consts._fields) \
        == {"inc_mask_f"}
    assert torch.equal(tr.consts.inc_mask_f, h.graph.inc_mask.float())


def test_recenter_ships_one_packed_buffer():
    h = _handoff()
    _, tr = _recentered(h)
    # Every constant but Lc (derived from chol) and the incidence mask (the
    # graph's) is a view of one buffer.
    bases = {getattr(tr.consts, f).untyped_storage().data_ptr()
             for f in refine.RefineConstants._fields
             if f not in ("Lc", "inc_mask_f")}
    assert len(bases) == 1
    # A float32 graph's mask is passed through, not copied per round.
    assert h.graph.inc_mask.dtype == torch.float32
    assert tr.consts.inc_mask_f is h.graph.inc_mask
    ops = _kernel_operands(h, tr.consts, _d0(h))
    assert ops["inc_mask"] is h.graph.inc_mask


def test_retract_d_and_delta_cost_match_jax():
    h = _handoff()
    _, tr = _recentered(h)
    rng = np.random.default_rng(2)
    shape = tr.consts.R.shape
    # float64 inputs: both formulas compute in the input's type.
    D, eta = (rng.standard_normal(shape) * 1e-3 for _ in range(2))
    R = tr.consts.R.double()
    got = refine._retract_d(torch.as_tensor(D), torch.as_tensor(eta), R)
    want = jax.vmap(jrefine._retract_d)(jnp.asarray(D), jnp.asarray(eta),
                                        jnp.asarray(R.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)

    Dz = rbcd.neighbor_buffer(rbcd.public_table(torch.as_tensor(D),
                                                h.graph), h.graph)
    e64 = h.graph.edges._replace(**{
        k: getattr(h.graph.edges, k).double()
        for k in ("R", "t", "kappa", "tau", "weight", "mask")})
    buf = torch.cat([torch.as_tensor(D), Dz], dim=1)
    Rbuf = torch.cat([R, tr.consts.Rz.double()], dim=1)
    rhoR, rhot = quadratic._edge_terms(Rbuf, e64)
    got = refine._delta_cost(buf, rhoR, rhot, e64)
    jedges = jax.tree.map(lambda t: jnp.asarray(t.numpy()), e64)
    want = jax.vmap(jrefine._delta_cost)(
        jnp.asarray(buf.numpy()), jnp.asarray(rhoR.numpy()),
        jnp.asarray(rhot.numpy()), jedges)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def _kernel_operands(h, consts, D0):
    D = torch.as_tensor(D0)
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, h.graph), h.graph)
    return dict(zip(ORDER, refine.refine_kernel_operands(D, Dz, consts,
                                                         h.graph)))


@pytest.mark.parametrize("d,r", [(3, 5), (2, 3), (3, 7), (3, 10), (2, 4),
                                 (2, 10)])
def test_rtr_refine_full_reference_matches_pallas_kernel(d, r):
    h = _handoff(d=d, r=r, n=40, rounds=30) if (d, r) != (3, 5) \
        else _handoff()
    _, tr = _recentered(h)
    ops = _kernel_operands(h, tr.consts, _d0(h))
    ref = rk.rtr_refine_full_reference(*ops.values(), r=r, d=d,
                                       e_max=h.meta.e_max, **KW)
    live = h.graph.pose_mask.numpy() > 0
    for a in range(h.meta.num_robots):
        Dc, stats = ptcg.rtr_refine_full_call(
            *[jnp.asarray(ops[k][a].numpy()) for k in ORDER[:15]], r=r, d=d,
            interpret=True, **KW)
        got = rk.comp_minor(ref.D[a], r, d + 1).numpy()[live[a]]
        want = np.asarray(ptcg.comp_minor(Dc, r, d + 1))[live[a]]
        np.testing.assert_allclose(got, want, rtol=0, atol=D_ATOL)
        st = np.asarray(stats)[0]
        assert ref.stats[a, 0].item() == st[0]  # attempts
        assert ref.stats[a, 1].item() == st[1]  # accepted
        np.testing.assert_allclose(ref.stats[a, 4].item(), st[4], rtol=0,
                                   atol=GN_ATOL)
        # df0/df are f(R + D) - f(R) in float32: absolute rounding.
        np.testing.assert_allclose(ref.stats[a, 2:4].numpy(), st[2:4],
                                   rtol=1e-4, atol=1e-9)
    # Padded poses keep their (zero) correction.
    pad = ~live
    assert not rk.comp_minor(ref.D, r, d + 1).numpy()[pad].any()


@functools.lru_cache(maxsize=None)
def _jax_round(kernel: bool):
    h = _handoff()
    jr = jrefine.recenter(h.Xg, h.jg, h.jm, h.jp, h.eg)
    if kernel:
        consts, graph = jr.consts, h.jg
    else:
        consts = jr.consts._replace(rho_rot_t=None, rho_trn_t=None, Rc=None,
                                    wk_t=None, wt_t=None)
        graph = h.jgx
    D, gn = jrefine.refine_round(jnp.asarray(_d0(h)), consts, graph, h.jm,
                                 h.jp)
    return np.asarray(D), np.asarray(gn)


@pytest.mark.parametrize("jax_form", ["kernel", "xla"])
@pytest.mark.parametrize("port_form", ["kernel", "ell"])
def test_refine_round_matches_jax(port_form, jax_form):
    h = _handoff()
    _, tr = _recentered(h)
    params = AgentParams(
        d=3, r=5, num_robots=3, rel_change_tol=0.0, solver=SolverParams(
            grad_norm_tol=1e-12, max_inner_iters=10,
            pallas_tcg=port_form == "kernel"))
    assert _refine_formulation(params, torch.device("cpu")) == port_form
    before = rk.REFINE_LAUNCHES
    D, gn = refine.refine_round(torch.as_tensor(_d0(h)), tr.consts, h.graph,
                                h.meta, params)
    assert rk.REFINE_LAUNCHES == before  # CPU tensors: the plain version
    D_jax, gn_jax = _jax_round(jax_form == "kernel")
    live = h.graph.pose_mask.numpy() > 0
    np.testing.assert_allclose(D.numpy()[live], D_jax[live], rtol=0,
                               atol=D_ATOL)
    np.testing.assert_allclose(gn.numpy(), gn_jax, rtol=0, atol=GN_ATOL)


# Refinement parity over whole cycles.  Verified costs are compared at
# rtol 1e-9.  The accelerated rounds are compared over 10-round cycles: on
# this handoff both packages' momentum sequences agree to 1e-12 for 11
# rounds, then one float32 accept/iteration decision goes the other way and
# the momentum (which grows without a restart in both packages here)
# amplifies that difference exponentially, so 50-round accelerated cycles
# end at different points (both reverted or kept by the same safeguard
# only by chance).  Plain rounds stay within 1e-12 over 50-round cycles.
@pytest.mark.parametrize("case", ["accel", "plain", "weights"])
def test_solve_refine_matches_jax(case):
    h = _handoff()
    kw = dict(f_opt=1.0, rel_gap=-1.0, max_cycles=3,
              rounds_per_cycle=10 if case != "plain" else 50,
              accel=case != "plain")
    eg, eg_np, jw, tw = h.eg, h.eg_np, {}, {}
    if case == "weights":
        eg, eg_np = h.eg_w, h.eg_w_np
        kw["max_cycles"] = 2
        jw = dict(weights=jnp.asarray(h.wA))
        tw = dict(weights=torch.as_tensor(h.wA))
    jX, jgap, jcyc, jhist = jrefine.solve_refine(h.Xg, h.jgx, h.jm, h.jp, eg,
                                                 **kw, **jw)
    verified = []
    X, gap, cyc, hist = refine.solve_refine(h.Xg, h.graph, h.meta, h.tp,
                                            eg_np, **kw, **tw,
                                            on_verify=verified.append)
    assert cyc == jcyc and len(hist) == len(jhist)
    f = 1.0 + np.array([g for g, _ in hist])  # f_opt = 1: gap = f - 1
    # ``on_verify`` saw the iterate of every verify pass, in order.
    assert len(verified) == len(hist)
    np.testing.assert_allclose([refine.global_cost(V, eg_np)
                                for V in verified], f, rtol=1e-15)
    np.testing.assert_allclose(f, 1.0 + np.array([g for g, _ in jhist]),
                               rtol=1e-9)
    # A float32 decision (an accepted step, a tCG iteration count) can go
    # the other way in one round: that moves the iterate by ~1e-7 but the
    # cost, near its minimum, only at second order.
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-6)
    assert gap == pytest.approx(jgap, rel=1e-9, abs=1e-12)
    # The port's own contract: descent, the best verified point, and an
    # iterate on the manifold to float64 tightness.
    assert refine.global_cost(X, eg_np) < f[0]
    assert gap <= min(f - 1.0) + 1e-15
    YY = X[..., :h.meta.d]
    np.testing.assert_allclose(np.swapaxes(YY, -1, -2) @ YY,
                               np.broadcast_to(np.eye(h.meta.d), (len(X),
                                               h.meta.d, h.meta.d)),
                               atol=1e-8)


@pytest.mark.parametrize("colored", [True, False])
def test_polish_matches_jax(colored):
    # 9-round cycles (3 colored sweeps), for the reason above.  The
    # gradient norm is a small difference of large terms: float64 rounding
    # of the ~1e-12 difference between the iterates moves it by ~1e-10.
    h = _handoff()
    kw = dict(cycles=2, rounds_per_cycle=9, chunk=3, colored=colored)
    jX, jhist = jrefine.polish(h.Xg, h.jgx, h.jm, h.jp, h.meas, **kw)
    X, hist = refine.polish(h.Xg, h.graph, h.meta, h.tp, h.meas, **kw)
    assert len(hist) == len(jhist) == 3
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-9)
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-10)
    assert min(hist) < hist[0]


def test_rtr_refine_full_wrapper_runs_plain_version_on_cpu():
    h = _handoff(d=2, r=3, n=40, rounds=30)
    _, tr = _recentered(h)
    ops = _kernel_operands(h, tr.consts, _d0(h))
    args = list(ops.values())
    kw = dict(r=3, d=2, e_max=h.meta.e_max, **KW)
    before = rk.REFINE_LAUNCHES
    out = rk.rtr_refine_full(*args, **kw)
    ref = rk.rtr_refine_full_reference(*args, **kw)
    assert rk.REFINE_LAUNCHES == before
    assert torch.equal(out.D, ref.D) and torch.equal(out.stats, ref.stats)
    with pytest.raises(ValueError, match="int32"):
        rk.rtr_refine_full(*args[:-1], args[-1].long(), **kw)
    with pytest.raises(ValueError, match="shape"):
        rk.rtr_refine_full(*args[:6], args[6][..., :1, :].contiguous(),
                           *args[7:], **kw)
    with pytest.raises(ValueError, match="kernel layouts"):
        refine.refine_kernel_operands(
            torch.as_tensor(_d0(h)), torch.zeros(1), tr.consts._replace(
                Rc=None), h.graph)


def test_rtr_refine_full_on_cuda_tensor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    h = _handoff(d=2, r=3, n=40, rounds=30)
    _, tr = _recentered(h)
    ops = _kernel_operands(h, tr.consts, _d0(h))
    kw = dict(r=3, d=2, e_max=h.meta.e_max, **KW)
    with pytest.raises((RuntimeError, AssertionError)):
        rk.rtr_refine_full(*(t.to("cuda") for t in ops.values()), **kw)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        rk.rtr_refine_full(*(t.to("meta") for t in ops.values()), **kw)


def _refine_formulation(params, device):
    """The rule ``refine.refine_round`` applies: B2's, for an f32 RTR round."""
    h = _handoff()
    return rbcd._formulation(h.meta, params, h.graph, torch.float32, device,
                             rtr=True)


def test_refine_formulation_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    default = AgentParams()
    assert _refine_formulation(default, cuda) == "kernel"
    assert _refine_formulation(default, cpu) == "ell"
    off = AgentParams(solver=SolverParams(pallas_tcg=False))
    assert _refine_formulation(off, cuda) == "ell"
    forced = AgentParams(solver=SolverParams(pallas_tcg=True))
    assert _refine_formulation(forced, cpu) == "kernel"
    # The descent's algorithm does not change the refine round: it is RTR.
    rgd = AgentParams(solver=SolverParams(algorithm=ROptAlg.RGD))
    assert _refine_formulation(rgd, cuda) == "kernel"
    assert rbcd._formulation(None, rgd, None, torch.float32, cuda) == "ell"


def test_with_weights_replaces_edge_weights():
    h = _handoff()
    g = rbcd.with_weights(h.graph, h.wA)
    assert g.edges.weight.dtype == h.graph.edges.weight.dtype
    assert np.array_equal(g.edges.weight.numpy(), h.wA)
    jg = jrbcd.with_weights(h.jgx, h.wA)
    assert np.array_equal(np.asarray(jg.edges.weight), g.edges.weight.numpy())
