"""``rbcd.solve_rbcd`` above r = 128 against the JAX package's, in
float64: the smallGrid3D-size stand-in over 4 robots (125 poses and 296
edges, the size of the reference's smallGrid3D) at r = 256, where B1-B4
take clusters on the card, and r = 1636, the top rank the JAX package's
VMEM gate admits there (B1-B4 on the spread route, four rows of a pose
a lane).  A file of its own, apart
from ``test_torch_top_ranks.py``'s plain-version checks, so that the
test runner's workers (``--dist loadfile``) take the two long solves
apart from those.

The kernels themselves run only on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.utils.synthetic import make_measurements as jmake
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

#: The smallGrid3D-size stand-in: 125 poses, 296 edges.
SMALLGRID = dict(n=125, d=3, num_lc=172, rot_noise=0.01, trans_noise=0.01)


@pytest.mark.parametrize("r", [256, 1636])
def test_solve_rbcd_on_the_smallgrid3d_stand_in_matches_jax(r):
    ref = jrbcd.solve_rbcd(jmake(np.random.default_rng(0), **SMALLGRID)[0],
                           4, JAgentParams(d=3, r=r, num_robots=4),
                           max_iters=10, grad_norm_tol=0.1)
    res = rbcd.solve_rbcd(tmake(np.random.default_rng(0), **SMALLGRID)[0],
                          4, AgentParams(d=3, r=r, num_robots=4),
                          max_iters=10, grad_norm_tol=0.1, device="cpu",
                          dtype=torch.float64)
    assert res.iterations == ref.iterations > 1
    assert res.terminated_by == ref.terminated_by
    np.testing.assert_allclose(res.cost_history, ref.cost_history,
                               rtol=1e-9)
    np.testing.assert_allclose(res.grad_norm_history,
                               ref.grad_norm_history, rtol=1e-9)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-8)
    assert res.state.X.shape[-2:] == (r, 4)
