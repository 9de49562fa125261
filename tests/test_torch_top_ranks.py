"""The port above r = 128, as the TPU runs it: B1-B4's plain versions and
``rbcd.solve_rbcd`` against the JAX package's formulations that do not go
through Pallas (its interpreter takes minutes a case at these ranks).

* B1 (``rtr_kernel.tcg_reference``) against ``dpgo_tpu.ops.solver.
  truncated_cg`` with the "ell" problem's Hessian and preconditioner, B2
  (``rtr_full_reference``) and B3 (``rtr_reference``, fed the gradient
  pass) against the "ell" ``dpgo_tpu.models.rbcd._agent_update``, all in
  float64, at (r, d) = (129, 3), the first rank past four warps a pose,
  (513, 3), the first past the cluster route's 16-warp cap (where the
  spread route folds a pose's rows), and (257, 2);
* B4 (``rtr_refine_full_reference``) against the JAX package's XLA refine
  round (``dpgo_tpu.models.refine.refine_round`` without kernel constants)
  at the same shapes, in float32 at the JAX refine test's bounds.

``test_torch_top_ranks_solve.py`` holds ``solve_rbcd`` at these ranks
against the JAX package's; the kernels themselves run only on the card
(``test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models import refine as jrefine
from dpgo_tpu.ops import manifold as jmanifold
from dpgo_tpu.ops import solver as jsolver
from dpgo_tpu.types import EdgeSet as JEdgeSet
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk

from test_torch_refine import (D_ATOL, GN_ATOL, _d0, _handoff,
                               _kernel_operands, _recentered)
from test_torch_refine import KW as REFINE_KW
from test_torch_rtr_kernel import B3_KW, KW, ORDER, RTR_KW, _j, _problem

#: (d, r) of the plain versions' checks.
SHAPES = [(3, 129), (3, 513), (2, 257)]
#: The float64 checks' bounds: both sides take the same arithmetic in
#: another order (the kernel's plain versions gather per component, the
#: JAX package over pose blocks), so they part at rounding.
RTOL, ATOL = 1e-9, 1e-12


@functools.lru_cache(maxsize=None)
def _f64_problem(d, r):
    """One RBCD round's operands at the chordal init in float64 (16 poses
    over 2 agents): B2's and B3's (the gradient pass's g and S), the edge
    tiles rebuilt in float64 (the graph's hold float32 transforms), and
    the JAX package's view of the same agents."""
    graph, meta, X0, Z, chol, ops = _problem(7, n=16, A=2, d=d, rank=r,
                                             num_lc=6, dtype=torch.float64)
    e = graph.edges
    A, nt, _, T = graph.rot_t.shape

    def tiles(rows):  # [A, e_max, c] -> [A, nt, c, T]
        pad = torch.zeros((A, nt * T, rows.shape[-1]), dtype=torch.float64)
        pad[:, :rows.shape[1]] = rows
        return pad.reshape(A, nt, T, -1).permute(0, 1, 3, 2).contiguous()

    w = e.mask * e.weight
    b2 = dict(ops, rot=tiles(e.R.reshape(A, -1, d * d)), trn=tiles(e.t),
              wk=tiles((w * e.kappa)[..., None]),
              wt=tiles((w * e.tau)[..., None]))
    g, _, S = rbcd.gradient_pass(X0, graph, meta)
    b3 = {k: b2[k] for k in ORDER[:8]}
    b3.update(Sc=S.permute(0, 2, 3, 1).reshape(A, d * d, -1).contiguous(),
              Lc=b2["Lc"], gc=rk.comp_major(g),
              **{k: b2[k] for k in ORDER[9:]})
    jax_args = (_j(X0), _j(Z),
                JEdgeSet(**{k: _j(v) for k, v in e._asdict().items()}),
                _j(chol), _j(graph.inc_slot), _j(graph.inc_mask))
    live = graph.pose_mask.numpy() > 0
    return meta, b2, b3, jax_args, live


@functools.lru_cache(maxsize=None)
def _jax_update(d, r):
    """The JAX package's "ell" local RTR step for every agent."""
    _, _, _, jax_args, _ = _f64_problem(d, r)
    params = JAgentParams(d=d, r=r, num_robots=2)
    X, gn = jax.jit(jax.vmap(
        lambda x, z, e, c, s, m: jrbcd._agent_update(x, z, e, params, c,
                                                     inc=(s, m))))(*jax_args)
    return np.asarray(X), np.asarray(gn)


@pytest.mark.parametrize("d,r", SHAPES)
def test_tcg_reference_matches_jax_truncated_cg_above_rank_128(d, r):
    meta, _, b3, jax_args, _ = _f64_problem(d, r)
    radius = np.array([0.05, 1.0])

    def one(x, z, e, c, s, m, rad):
        prob = jrbcd._agent_local_problem(z, e, c, meta.n_max, inc=(s, m))
        eg = prob.egrad(x)
        res = jsolver.truncated_cg(
            x, jmanifold.rgrad(x, eg),
            lambda V: jmanifold.ehess_to_rhess(x, eg, prob.ehess(x, V), V),
            lambda V: jmanifold.tangent_project(x, prob.precond(x, V)), rad,
            KW["max_iters"], KW["kappa"], KW["theta"])
        return res.eta, res.heta, res.iters, res.hit_boundary

    eta, heta, iters, hit = jax.jit(jax.vmap(one))(*jax_args,
                                                   jnp.asarray(radius))
    args = [b3[k] for k in ORDER[:7]] + [b3["Sc"], b3["Lc"], b3["gc"],
                                         torch.tensor(radius),
                                         b3["inc_slot"], b3["inc_mask"]]
    ref = rk.tcg_reference(*args, r=r, d=d, e_max=meta.e_max, **KW)
    np.testing.assert_allclose(rk.comp_minor(ref.eta, r, d + 1).numpy(),
                               eta, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rk.comp_minor(ref.heta, r, d + 1).numpy(),
                               heta, rtol=RTOL, atol=ATOL)
    assert ref.stats[:, 0].tolist() == np.asarray(iters).tolist()
    assert (ref.stats[:, 1] > 0).tolist() == np.asarray(hit).tolist()


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_full_reference_matches_jax_ell_update_above_rank_128(d, r):
    meta, b2, _, _, live = _f64_problem(d, r)
    X_jax, gn_jax = _jax_update(d, r)
    ref = rk.rtr_full_reference(*[b2[k] for k in ORDER], r=r, d=d,
                                e_max=meta.e_max, **RTR_KW)
    # Padded poses: the plain version leaves them; the JAX update retracts
    # them by a zero step (rounding of an orthonormal block).
    np.testing.assert_allclose(rk.comp_minor(ref.X, r, d + 1).numpy()[live],
                               X_jax[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref.stats[:, 4].numpy(), gn_jax, rtol=RTOL)
    assert bool((ref.stats[:, 1] > 0).all())


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_reference_matches_jax_ell_update_above_rank_128(d, r):
    # B3 fed the gradient pass at the chordal init takes the local step
    # (no early exit there).
    meta, _, b3, _, live = _f64_problem(d, r)
    X_jax, _ = _jax_update(d, r)
    ref = rk.rtr_reference(*b3.values(), r=r, d=d, e_max=meta.e_max,
                           **B3_KW)
    np.testing.assert_allclose(rk.comp_minor(ref.X, r, d + 1).numpy()[live],
                               X_jax[live], rtol=RTOL, atol=ATOL)
    assert bool((ref.stats[:, 1] > 0).all())


@pytest.mark.parametrize("d,r", SHAPES)
def test_rtr_refine_full_reference_matches_jax_refine_round_above_rank_128(
        d, r):
    # Recentered at the chordal init (no descent rounds), a random
    # correction; the JAX round without kernel constants is its XLA
    # formulation.  Both in float32: the JAX refine test's bounds.
    h = _handoff(d=d, r=r, n=16, A=2, rounds=0)
    jr, tr = _recentered(h)
    D0 = _d0(h)
    consts = jr.consts._replace(rho_rot_t=None, rho_trn_t=None, Rc=None,
                                wk_t=None, wt_t=None)
    D_jax, gn_jax = jrefine.refine_round(jnp.asarray(D0), consts, h.jgx,
                                         h.jm, h.jp)
    ops = _kernel_operands(h, tr.consts, D0)
    ref = rk.rtr_refine_full_reference(*ops.values(), r=r, d=d,
                                       e_max=h.meta.e_max, **REFINE_KW)
    live = h.graph.pose_mask.numpy() > 0
    np.testing.assert_allclose(
        rk.comp_minor(ref.D, r, d + 1).numpy()[live],
        np.asarray(D_jax)[live], rtol=0, atol=D_ATOL)
    np.testing.assert_allclose(ref.stats[:, 4].numpy(), gn_jax, rtol=0,
                               atol=GN_ATOL)
    assert bool((ref.stats[:, 1] > 0).all())
