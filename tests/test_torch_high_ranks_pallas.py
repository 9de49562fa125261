"""B1-B4's plain versions (``dpgo_tpu_torch.ops.rtr_kernel``) above the
templated ranks against the Pallas kernels (``dpgo_tpu.ops.pallas_tcg``,
interpreter mode) at (r, d) = (11, 3), (17, 3) and (12, 2).  A file of its
own, apart from ``test_torch_high_ranks.py``'s route plan and solves, so
that the test runner's workers (``--dist loadfile``) take these long cases
apart from those.  The kernels run only on the card
(``test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.ops import pallas_tcg as ptcg
from dpgo_tpu_torch.ops import rtr_kernel as rk

from test_torch_refine import (D_ATOL, GN_ATOL, _d0, _handoff,
                               _kernel_operands, _recentered)
from test_torch_refine import KW as REFINE_KW
from test_torch_refine import ORDER as REFINE_ORDER
from test_torch_rtr_kernel import (B3_KW, B3_ORDER, KW, ORDER, RTR_KW,
                                   _b3_operands, _j, _problem)


#: The plain versions' shapes (d, rank, n, A, num_lc).
PARITY_SHAPES = [(3, 11, 16, 2, 6), (3, 17, 16, 2, 6), (2, 12, 16, 2, 6)]


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_tcg_reference_matches_pallas_tcg_at_high_ranks(d, rank, n, A,
                                                        num_lc):
    graph, meta, X0, Z, chol, _ = _problem(3, n=n, A=A, d=d, rank=rank,
                                           num_lc=num_lc)
    ops = _b3_operands(graph, meta, X0, Z, chol)
    args = [ops[k] for k in ORDER[:7]] + [ops["Sc"], ops["Lc"], ops["gc"],
                                          torch.ones(A), ops["inc_slot"],
                                          ops["inc_mask"]]
    ref = rk.tcg_reference(*args, r=rank, d=d, e_max=meta.e_max, **KW)
    for a in range(A):
        eta_c, heta_c, stats = ptcg.tcg_call(
            *[_j(ops[k][a]) for k in ORDER[:7]], _j(ops["Sc"][a]),
            _j(ops["Lc"][a]), _j(ops["gc"][a]),
            jnp.ones((1, 1), jnp.float32), r=rank, d=d, interpret=True,
            **KW)
        np.testing.assert_allclose(ref.eta[a].numpy(), eta_c, atol=1e-5)
        np.testing.assert_allclose(ref.heta[a].numpy(), heta_c, atol=1e-4)
        assert int(ref.stats[a, 0]) == int(stats[0, 0])
        assert bool(ref.stats[a, 1] > 0) == bool(stats[0, 1] > 0)


def _assert_step_matches(ref, a, Xo, stats):
    np.testing.assert_allclose(ref.X[a].numpy(), Xo, atol=1e-5)
    st = np.asarray(stats)[0]
    assert ref.stats[a, 0].item() == st[0]  # attempts
    assert ref.stats[a, 1].item() == st[1]  # accepted
    np.testing.assert_allclose(ref.stats[a, 2:].numpy(), st[2:], rtol=1e-5)


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_rtr_full_reference_matches_pallas_kernel_at_high_ranks(d, rank, n,
                                                                A, num_lc):
    _, meta, _, _, _, ops = _problem(5, n=n, A=A, d=d, rank=rank,
                                     num_lc=num_lc)
    ref = rk.rtr_full_reference(*[ops[k] for k in ORDER], r=rank, d=d,
                                e_max=meta.e_max, **RTR_KW)
    for a in range(A):
        Xo, stats = ptcg.rtr_full_call(
            *[_j(ops[k][a]) for k in ORDER[:9]], r=rank, d=d,
            interpret=True, **RTR_KW)
        _assert_step_matches(ref, a, Xo, stats)


@pytest.mark.parametrize("d,rank,n,A,num_lc", PARITY_SHAPES)
def test_rtr_reference_matches_pallas_kernel_at_high_ranks(d, rank, n, A,
                                                           num_lc):
    graph, meta, X0, Z, chol, _ = _problem(5, n=n, A=A, d=d, rank=rank,
                                           num_lc=num_lc)
    ops = _b3_operands(graph, meta, X0, Z, chol)
    ref = rk.rtr_reference(*ops.values(), r=rank, d=d, e_max=meta.e_max,
                           **B3_KW)
    for a in range(A):
        Xo, stats = ptcg.rtr_call(
            *[_j(ops[k][a]) for k in B3_ORDER[:11]], r=rank, d=d,
            interpret=True, **B3_KW)
        _assert_step_matches(ref, a, Xo, stats)


@pytest.mark.parametrize("d,r", [(3, 11), (3, 17), (2, 12)])
def test_rtr_refine_full_reference_matches_pallas_kernel_at_high_ranks(d, r):
    h = _handoff(d=d, r=r, n=16, A=2, rounds=20)
    _, tr = _recentered(h)
    ops = _kernel_operands(h, tr.consts, _d0(h))
    ref = rk.rtr_refine_full_reference(*ops.values(), r=r, d=d,
                                       e_max=h.meta.e_max, **REFINE_KW)
    live = h.graph.pose_mask.numpy() > 0
    for a in range(h.meta.num_robots):
        Dc, stats = ptcg.rtr_refine_full_call(
            *[jnp.asarray(ops[k][a].numpy()) for k in REFINE_ORDER[:15]],
            r=r, d=d, interpret=True, **REFINE_KW)
        got = rk.comp_minor(ref.D[a], r, d + 1).numpy()[live[a]]
        want = np.asarray(ptcg.comp_minor(Dc, r, d + 1))[live[a]]
        np.testing.assert_allclose(got, want, rtol=0, atol=D_ATOL)
        st = np.asarray(stats)[0]
        assert ref.stats[a, 0].item() == st[0]  # attempts
        assert ref.stats[a, 1].item() == st[1]  # accepted
        np.testing.assert_allclose(ref.stats[a, 4].item(), st[4], rtol=0,
                                   atol=GN_ATOL)
        np.testing.assert_allclose(ref.stats[a, 2:4].numpy(), st[2:4],
                                   rtol=1e-4, atol=1e-9)
