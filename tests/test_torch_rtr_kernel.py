"""The fused RTR kernel's plain PyTorch versions (``dpgo_tpu_torch.ops.
rtr_kernel``) against the TPU kernels they replace
(``dpgo_tpu.ops.pallas_tcg``, run in interpreter mode on the CPU) and
against the JAX package's plain "ell" agent update.

Inputs are built once with the port (its host arrays equal the JAX
package's, ``test_torch_host.py``) and handed to both sides as numpy
arrays.  The CUDA kernel cannot run here: its launch checks that do run on
the CPU are exercised; the on-card comparisons are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.config import AgentParams as JAgentParams
from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import pallas_tcg as ptcg
from dpgo_tpu.types import EdgeSet as JEdgeSet
from dpgo_tpu_torch.config import AgentParams, SolverParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import manifold, quadratic
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements

KW = dict(max_iters=10, kappa=0.1, theta=1.0)
RTR_KW = dict(KW, initial_radius=100.0, max_rejections=10, grad_tol=1e-2)
ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "Xc", "Zc", "Lc",
         "inc_slot", "inc_mask", "n_local")


def _problem(seed, n, A, d, rank, num_lc, dtype=torch.float32):
    """Per-agent kernel operands of one RBCD round at the chordal init."""
    meas, _ = make_measurements(np.random.default_rng(seed), n=n, d=d,
                                num_lc=num_lc, rot_noise=0.05,
                                trans_noise=0.05)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, rank, dtype, device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, dtype)
    Z = rbcd.neighbor_buffer(rbcd.public_table(X0, graph), graph)
    params = AgentParams(d=d, r=rank, num_robots=A)
    chol = rbcd.precond_chol(graph.edges, meta.n_max, meta.s_max, params)
    ops = dict(zip(ORDER, rbcd.kernel_operands(X0, Z, graph.edges, chol,
                                               graph)))
    if dtype == torch.float64:  # plain-version inputs in the problem type
        ops.update(Xc=rk.comp_major(X0), Zc=rk.comp_major(Z),
                   Lc=chol.permute(0, 2, 3, 1).reshape(A, -1, meta.n_max)
                   .contiguous(), inc_mask=graph.inc_mask)
    return graph, meta, X0, Z, chol, ops


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("radius", [0.05, 1.0, 100.0])
def test_tcg_reference_matches_pallas_tcg(radius):
    graph, meta, X0, Z, chol, ops = _problem(3, n=24, A=4, d=3, rank=5,
                                             num_lc=12)
    d, r = meta.d, meta.rank
    buf = torch.cat([X0, Z], dim=1)
    eg = quadratic.egrad_ell(buf, graph.edges, graph.inc_slot,
                             graph.inc_mask)
    g = rk.comp_major(manifold.rgrad(X0, eg))
    S = manifold.sym(X0[..., :d].transpose(-1, -2) @ eg[..., :d])
    Sc = S.permute(0, 2, 3, 1).reshape(meta.num_robots, d * d, -1)
    rad = torch.full((meta.num_robots,), radius)
    ref = rk.tcg_reference(
        *[ops[k] for k in ORDER[:7]], Sc, ops["Lc"], g, rad,
        ops["inc_slot"], ops["inc_mask"], r=r, d=d, e_max=meta.e_max, **KW)
    for a in range(meta.num_robots):
        eta_c, heta_c, stats = ptcg.tcg_call(
            *[_j(ops[k][a]) for k in ORDER[:7]], _j(Sc[a]), _j(ops["Lc"][a]),
            _j(g[a]), jnp.full((1, 1), radius, jnp.float32), r=r, d=d,
            interpret=True, **KW)
        np.testing.assert_allclose(ref.eta[a].numpy(), eta_c, atol=1e-5)
        np.testing.assert_allclose(ref.heta[a].numpy(), heta_c, atol=1e-4)
        assert int(ref.stats[a, 0]) == int(stats[0, 0])
        assert bool(ref.stats[a, 1] > 0) == bool(stats[0, 1] > 0)


@pytest.mark.parametrize("d,rank,n,A,num_lc", [(3, 5, 24, 4, 12),
                                               (2, 3, 16, 2, 6)])
def test_rtr_full_reference_matches_pallas_kernel(d, rank, n, A, num_lc):
    _, meta, _, _, _, ops = _problem(5, n=n, A=A, d=d, rank=rank,
                                     num_lc=num_lc)
    ref = rk.rtr_full_reference(*[ops[k] for k in ORDER], r=rank, d=d,
                                e_max=meta.e_max, **RTR_KW)
    for a in range(A):
        Xo, stats = ptcg.rtr_full_call(
            *[_j(ops[k][a]) for k in ORDER[:9]], r=rank, d=d,
            interpret=True, **RTR_KW)
        np.testing.assert_allclose(ref.X[a].numpy(), Xo, atol=1e-5)
        st = np.asarray(stats)[0]
        assert ref.stats[a, 0].item() == st[0]  # attempts
        assert ref.stats[a, 1].item() == st[1]  # accepted
        np.testing.assert_allclose(ref.stats[a, 2:].numpy(), st[2:],
                                   rtol=1e-5)


def test_rtr_full_reference_f64_matches_jax_ell_update():
    graph, meta, X0, Z, chol, ops = _problem(
        7, n=30, A=3, d=3, rank=5, num_lc=10, dtype=torch.float64)
    params = JAgentParams(d=3, r=5, num_robots=3)
    e = graph.edges
    jedges = JEdgeSet(**{k: _j(v) for k, v in e._asdict().items()})
    X_jax, gn_jax = jax.jit(jax.vmap(
        lambda x, z, e, c, s, m: jrbcd._agent_update(x, z, e, params, c,
                                                     inc=(s, m))))(
        _j(X0), _j(Z), jedges, _j(chol), _j(graph.inc_slot),
        _j(graph.inc_mask))
    # float64 edge payload: the graph's tiles hold float32 transforms.
    A, nt, _, T = graph.rot_t.shape

    def tiles(rows):  # [A, e_max, c] -> [A, nt, c, T]
        pad = torch.zeros((A, nt * T, rows.shape[-1]), dtype=torch.float64)
        pad[:, :rows.shape[1]] = rows
        return pad.reshape(A, nt, T, -1).permute(0, 1, 3, 2).contiguous()

    w = e.mask * e.weight
    f64 = dict(ops, rot=tiles(e.R.reshape(A, -1, 9)), trn=tiles(e.t),
               wk=tiles((w * e.kappa)[..., None]),
               wt=tiles((w * e.tau)[..., None]))
    ref = rk.rtr_full_reference(*[f64[k] for k in ORDER], r=5, d=3,
                                e_max=meta.e_max, **RTR_KW)
    X_ref = rk.comp_minor(ref.X, 5, 4).numpy()
    live = graph.pose_mask.numpy() > 0
    # Padded poses: the kernel leaves them untouched; the JAX update
    # retracts them by a zero step (the polar factor of an orthonormal
    # block, equal to it to rounding).
    np.testing.assert_allclose(X_ref[live], np.asarray(X_jax)[live],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ref.stats[:, 4].numpy(), gn_jax, rtol=1e-9)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    _, meta, _, _, _, ops = _problem(5, n=16, A=2, d=2, rank=3, num_lc=6)
    args = [ops[k] for k in ORDER]
    kw = dict(r=3, d=2, e_max=meta.e_max, **RTR_KW)
    before = rk.LAUNCHES
    out = rk.rtr_full(*args, **kw)
    ref = rk.rtr_full_reference(*args, **kw)
    assert rk.LAUNCHES == before  # no kernel launch on the CPU
    assert torch.equal(out.X, ref.X) and torch.equal(out.stats, ref.stats)
    with pytest.raises(ValueError, match="int32"):
        rk.rtr_full(*args[:9], args[9].long(), *args[10:], **kw)
    with pytest.raises(ValueError, match="shape"):
        rk.rtr_full(*args[:6], args[6][:1], *args[7:], **kw)
    with pytest.raises(ValueError, match="shape"):
        rk.rtr_full(*args, **dict(kw, r=7))


def _kernel_args(device):
    """Kernel operands of a one-agent, one-tile problem on ``device``."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    shapes = [((1, 1, 1, 4), i32), ((1, 1, 1, 4), i32), ((1, 1, 9, 4), f32),
              ((1, 1, 3, 4), f32), ((1, 1, 1, 4), f32), ((1, 1, 1, 4), f32),
              ((1, 20, 2), f32), ((1, 20, 1), f32), ((1, 16, 2), f32),
              ((1, 2, 1), i32), ((1, 2, 1), f32)]
    return [torch.zeros(s, **kw) for s, kw in shapes] + \
        [torch.full((1,), 2, **i32)]


def test_cuda_tensor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    with pytest.raises((RuntimeError, AssertionError)):
        rk.rtr_full(*_kernel_args("cuda"), r=5, d=3, e_max=4, **RTR_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.load()
    # A tensor on a device that is neither the CPU nor CUDA never falls
    # back to the plain version either.
    with pytest.raises(RuntimeError, match="CUDA devices"):
        rk.rtr_full(*_kernel_args("meta"), r=5, d=3, e_max=4, **RTR_KW)


def test_formulation_runs_the_kernel_for_every_float32_rtr_cuda_problem():
    # On CUDA nothing but the algorithm and the type decides: a shape the
    # kernel is not built for, or an edge payload too large for shared
    # memory, still goes to the kernel's wrapper, which launches or raises.
    meta = rbcd.GraphMeta(num_robots=1, n_max=2500, e_max=4948, s_max=0,
                          p_max=0, d=3, rank=6)
    params = AgentParams(d=3, r=6, num_robots=1)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert rbcd._formulation(meta, params, None, torch.float32,
                             cuda) == "kernel"
    assert rbcd._formulation(meta, params, None, torch.float32,
                             cpu) == "ell"
    assert rbcd._formulation(meta, params, None, torch.float64,
                             cuda) == "ell"
    off = AgentParams(d=3, r=6, num_robots=1,
                      solver=SolverParams(pallas_tcg=False))
    assert rbcd._formulation(meta, off, None, torch.float32, cuda) == "ell"
    forced = AgentParams(d=3, r=6, num_robots=1,
                         solver=SolverParams(pallas_tcg=True))
    assert rbcd._formulation(meta, forced, None, torch.float32,
                             cpu) == "kernel"
    with pytest.raises(ValueError, match="float32-only"):
        rbcd._formulation(meta, forced, None, torch.float64, cuda)
