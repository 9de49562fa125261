"""The port's round ablation (``dpgo_tpu_torch.experiments.measure_r3``)
on the CPU at a small size: its gradient pass (``rbcd.gradient_pass``)
against the JAX script's ``grad_part`` (``experiments/measure_r3.py:117-
133``) in float64, and the whole ablation running on CPU tensors without a
kernel launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.models import rbcd as jrbcd
from dpgo_tpu.ops import manifold as jmanifold
from dpgo_tpu.ops import quadratic as jquad
from dpgo_tpu.utils.partition import partition_contiguous
from dpgo_tpu.utils.synthetic import make_measurements
from dpgo_tpu_torch import interop
from dpgo_tpu_torch.experiments import measure_r3
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.ops import rtr_kernel as rk
from dpgo_tpu_torch.utils.synthetic import make_measurements as t_make


def _grad_part(X, graph, d):
    """``grad_part`` of the JAX script, verbatim but for its closure."""
    Z = jrbcd.neighbor_buffer(jrbcd.public_table(X, graph), graph)

    def one(x, z, e, s, m):
        buf = jnp.concatenate([x, z], axis=0)
        eg = jquad.egrad_ell(buf, e, s, m)
        g = jmanifold.rgrad(x, eg)
        gn0 = jmanifold.norm(g)
        Y, GY = x[..., :d], eg[..., :d]
        M = jnp.einsum("nab,nac->nbc", Y, GY)
        S = 0.5 * (M + jnp.swapaxes(M, -1, -2))
        return g, gn0, S

    return jax.vmap(one)(X, Z, graph.edges, graph.inc_slot, graph.inc_mask)


@pytest.mark.parametrize("d,rank", [(3, 5), (2, 3)])
def test_gradient_pass_matches_jax_grad_part(d, rank):
    meas = make_measurements(np.random.default_rng(8), n=30, d=d, num_lc=10,
                             rot_noise=0.05, trans_noise=0.05)[0]
    part = partition_contiguous(meas, 3)
    graph, meta = jrbcd.build_graph(part, rank, jnp.float64, pallas_sel=True)
    X0 = jrbcd.centralized_chordal_init(part, meta, graph, jnp.float64)
    X = X0 + 0.01 * jnp.asarray(np.random.default_rng(0).standard_normal(
        X0.shape))
    ref = _grad_part(X, graph, d)
    tg = interop.graph_from_numpy(jax.tree.map(np.asarray, graph),
                                  device="cpu")
    out = rbcd.gradient_pass(torch.as_tensor(np.array(X)), tg,
                             interop.meta_from_numpy(meta))
    for port, jax_out in zip(out, ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_out),
                                   rtol=1e-10, atol=1e-12)


def test_ablate_runs_on_cpu_without_launching():
    meas = t_make(np.random.default_rng(0), n=60, d=3, num_lc=20,
                  rot_noise=0.01, trans_noise=0.01)[0]
    before = rk.RTR_LAUNCHES
    out = measure_r3.ablate(meas, robots=3, rank=5, rounds=2, device="cpu")
    assert rk.RTR_LAUNCHES == before
    assert out["b3_calls"] == 1 + 2 + 1  # warm-up, timed, the stats launch
    assert len(out["b2_attempts_end"]) == len(out["b3_last_attempts"]) == 3
    stats = np.asarray(out["b3_stats"])
    assert stats.shape == (3, 4) and np.isfinite(stats).all()
    assert np.all(stats[:, 3] <= stats[:, 2])  # f never rises
    for key in ("full_ms_per_round", "grad_ms_per_round",
                "grad_b3_ms_per_round"):
        assert np.isfinite(out[key]) and out[key] > 0
    assert out["device"] == "cpu"


def test_missing_datasets(monkeypatch, tmp_path):
    monkeypatch.setattr(measure_r3, "DATA", tmp_path)
    for run, name in ((measure_r3.kitti, "kitti_00"),
                      (measure_r3.city, "city10000"),
                      (measure_r3.ais, "ais2klinik")):
        with pytest.raises(FileNotFoundError, match=name):
            run(device="cpu")
    meas, source = measure_r3.sphere_measurements()
    assert "stand-in" in source
    assert (meas.num_poses, len(meas)) == (2500, 4948)
