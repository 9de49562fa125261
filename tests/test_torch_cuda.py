"""The port's CUDA kernels on the card, against their plain PyTorch
versions (``dpgo_tpu_torch.ops.rtr_kernel``), and the solve's launch
count.  Every test needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import manifold, quadratic
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements

pytestmark = pytest.mark.cuda


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
    chol = rbcd.precond_chol(g.edges, m.n_max, m.s_max, params)
    return prob, params, X, Z, chol


@pytest.mark.parametrize("d,r", [(3, 5), (2, 3)])
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
    assert rk.LAUNCHES - before == res.iterations > 0
    plain = AgentParams(d=3, r=5, num_robots=4,
                        solver=SolverParams(pallas_tcg=False))
    ref = rbcd.solve_rbcd(meas, 4, plain, max_iters=res.iterations,
                          grad_norm_tol=0.0)
    assert float((res.X - ref.X).abs().max()) <= 5e-4


def test_edge_payload_too_large_for_shared_memory(card):
    # One agent with ~4000 edges: the payload (64 B an edge at d = 3) does
    # not fit in one block's 227 KB and lives in the global workspace.
    prob, params, X, Z, chol = _round(card, n=2000, A=1, num_lc=2000)
    assert prob.meta.e_max * 64 > 232448
    args = rbcd.kernel_operands(X, Z, prob.graph.edges, chol, prob.graph)
    kw = rbcd.kernel_options(params, prob.meta)
    out = rk.rtr_full(*args, **kw)
    ref = rk.rtr_full_reference(*args, **kw)
    torch.cuda.synchronize()
    assert float((out.X - ref.X).abs().max()) <= 1e-4
    assert torch.equal(out.stats[:, :2], ref.stats[:, :2])
    torch.testing.assert_close(out.stats[:, 2:], ref.stats[:, 2:],
                               rtol=1e-4, atol=0)


def test_shape_without_kernel_raises_on_card(card):
    # r = 6 has no instantiation: the solve raises rather than running the
    # plain formulation on the card.
    meas = make_measurements(np.random.default_rng(5), n=40, d=3, num_lc=10,
                             rot_noise=0.05, trans_noise=0.05)[0]
    params = AgentParams(d=3, r=6, num_robots=2)
    before = rk.LAUNCHES
    with pytest.raises(ValueError, match="instantiated"):
        rbcd.solve_rbcd(meas, 2, params, max_iters=2)
    assert rk.LAUNCHES == before
