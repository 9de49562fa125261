"""The solve at agents above the cluster ceiling (two agents of 1,700
poses, where B2 and B4 take the spread route on the card) against the JAX
package's in float64 on the CPU.  A file of its own, apart from
``test_torch_rtr_plan.py``'s route checks, so that the test runner's
workers (``--dist loadfile``) take this long case apart from those.  The
kernels themselves run only on the card (``test_torch_cuda.py``)."""

import numpy as np
import torch

from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements as t_make


def test_solve_above_the_old_ceiling_matches_jax():
    # Two agents of 1,700 poses (no cluster holds one): build_graph and the
    # tile layout at that size, and three rounds of the solve, in float64
    # ("ell" on the CPU) against the JAX package's.
    n, num_lc = 3400, 600
    meas = make_measurements(np.random.default_rng(3), n=n, d=3,
                             num_lc=num_lc, rot_noise=0.05,
                             trans_noise=0.05)[0]
    ref = jrbcd.solve_rbcd(meas, 2, max_iters=3, grad_norm_tol=0.0)
    t_meas = t_make(np.random.default_rng(3), n=n, d=3, num_lc=num_lc,
                    rot_noise=0.05, trans_noise=0.05)[0]
    prob = rbcd.prepare_problem(t_meas, 2, device="cpu",
                                dtype=torch.float64)
    assert prob.meta.n_max == 1700
    assert rk.cluster_plan(prob.meta.n_max, prob.meta.e_max,
                           prob.graph.inc_slot.shape[-1], 5, 3,
                           agents=2).route == "spread"
    res = rbcd.solve_rbcd(t_meas, 2, max_iters=3, grad_norm_tol=0.0,
                          device="cpu", dtype=torch.float64)
    assert res.iterations == ref.iterations == 3
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), rtol=1e-9,
                               atol=1e-9)
