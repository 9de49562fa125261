"""The f32 sharded Gauss-Newton-CG tail (``parallel.sharded.
gn_tail_sharded`` at world 1) against the JAX package's from one float32
start: both stall at the same gradient norm, far above the host float64
tail's, so the stall is float32's and not the port's.  A file of its own,
apart from ``test_torch_gn_tail.py``'s f64 checks, so that the test
runner's workers (``--dist loadfile``) take this long case apart from
those.  ``python tests/test_torch_gn_tail_f32.py`` runs the check at the
sphere2500 stand-in's size.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.models import refine as jrefine
from dpgo_tpu.parallel import gn_tail_sharded as jgn_sharded
from dpgo_tpu.parallel import make_mesh as jmake_mesh
from dpgo_tpu.utils.partition import partition_contiguous as jpartition
from dpgo_tpu_torch import config as tconfig
from dpgo_tpu_torch.models import rbcd, refine
from dpgo_tpu_torch.parallel import gn_tail_sharded, make_mesh
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements as tmake

from test_torch_gn_tail import A, _params


def f32_floor_tails(n=200, rounds=60, max_outer=4):
    """Both packages' f32 sharded tails (world 1, a 1-device mesh) from one
    start, the port's float32 iterate after ``rounds`` rounds on a
    bench.py-like stand-in of ``n`` poses, beside the host float64 tail:
    their gradient-norm histories."""
    meas = tmake(np.random.default_rng(0), n=n, d=3,
                 num_lc=n - 51 if n > 100 else n // 2, rot_noise=0.01,
                 trans_noise=0.01)[0]
    params = _params(tconfig)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, 5, torch.float32, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float32)
    X = rbcd.rbcd_steps(rbcd.init_state(graph, meta, X0, params=params),
                        graph, rounds, meta, params).X
    cfg = dict(max_outer=max_outer, grad_norm_tol=1e-6)
    _, port = gn_tail_sharded(X, graph, meta, mesh=make_mesh(device="cpu"),
                              cfg=refine.GNTailConfig(**cfg))
    jgraph, jmeta = jrbcd.build_graph(jpartition(meas, A), 5, jnp.float32)
    _, ref = jgn_sharded(jnp.asarray(X.numpy()), jgraph, jmeta,
                         mesh=jmake_mesh(1), cfg=jrefine.GNTailConfig(**cfg))
    host = refine.gn_tail(rbcd.gather_to_global(X, graph, n).double()
                          .numpy(), refine.host_edges_f64(meas),
                          refine.GNTailConfig(**cfg))
    return (np.asarray(port.grad_norm_history),
            np.asarray(ref.grad_norm_history),
            np.asarray(host.grad_norm_history))


def test_f32_sharded_tail_stalls_at_the_floor_as_jax_does():
    # From one float32 start both packages' f32 tails stall at the same
    # gradient norm, ~1e4 above the host float64 tail's: the stall is
    # float32's, not the port's (the f64 tails match JAX at rtol 1e-9
    # above).  At the sphere2500 stand-in's size (``python
    # tests/test_torch_gn_tail_f32.py``) both stall at ~0.08.
    port, jax_, host = f32_floor_tails()
    assert 0.5 <= port[-1] / jax_[-1] <= 2.0
    assert min(port[-1], jax_[-1]) > 100 * host[-1]
    assert abs(port[0] / jax_[0] - 1) < 1e-4


if __name__ == "__main__":
    import json

    p, j, h = f32_floor_tails(n=2500, rounds=200)
    print(json.dumps({"port_f32": p.tolist(), "jax_f32": j.tolist(),
                      "host_f64": h.tolist()}))
