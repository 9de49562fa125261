"""The port's rotation / translation averaging, plain and robust
(``dpgo_tpu_torch.ops.averaging``), against the JAX package's
(``dpgo_tpu.ops.averaging``), on the same numpy inputs, on the CPU.

Each case of ``tests/test_averaging.py`` has a counterpart: the JAX test's
own assertions hold for the port, and R, t and the weights agree with
JAX's at rtol 1e-10 with equal inlier masks.  In the float32 case the
weights (exact 0s and 1s there) keep rtol 1e-10, and R and t are held at
rtol 1e-5: the projection's SVD is Jacobi in the port and LAPACK in JAX,
and in float32 the two differ by a few ulps.  The robust loops read the host once for the skip test and once per
GNC iteration; ``averaging.HOST_READS`` counts them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu.ops import averaging as javg
from dpgo_tpu.utils import lie as jlie
from dpgo_tpu_torch.ops import averaging
from dpgo_tpu_torch.utils import lie


def random_rotation(rng, d=3):
    """The JAX test's draw (the same stream, so the same inputs)."""
    return np.asarray(jlie.project_to_rotation(
        jnp.asarray(rng.standard_normal((d, d)))))


def perturbed(R, rng, angle):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    q = np.concatenate([np.sin(angle / 2) * axis, [np.cos(angle / 2)]])
    return lie.quat_to_rotation(q) @ R


def _t(x, dtype=torch.float64):
    return None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(x, dtype=jnp.float64):
    return None if x is None else jnp.asarray(np.asarray(x), dtype)


def _close(ours, theirs, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol,
                               atol=atol)


def _robust_pair(fn, *args, dtype=torch.float64, **kw):
    """The port's and JAX's robust result on the same inputs."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ours = getattr(averaging, fn)(*(_t(a, dtype) for a in args),
                                  **{k: (_t(v, dtype) if isinstance(
                                      v, np.ndarray) else v)
                                     for k, v in kw.items()})
    theirs = getattr(javg, fn)(*(_j(a, jdt) for a in args),
                               **{k: (_j(v, jdt) if isinstance(
                                   v, np.ndarray) else v)
                                  for k, v in kw.items()})
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else {}
    _close(ours.R, theirs.R, **tol)
    _close(ours.t, theirs.t, **tol)
    _close(ours.weights, theirs.weights)
    assert ours.weights.dtype == dtype
    assert ours.inlier_mask.tolist() == np.asarray(theirs.inlier_mask)\
        .tolist()
    return ours


def test_single_translation_averaging(rng):
    ts = rng.standard_normal((10, 3))
    tau = rng.uniform(0.5, 2.0, 10)
    t = averaging.single_translation_averaging(_t(ts), _t(tau))
    expected = (tau[:, None] * ts).sum(0) / tau.sum()
    assert np.allclose(t.numpy(), expected, atol=1e-12)
    _close(t, javg.single_translation_averaging(_j(ts), _j(tau)))


def test_single_rotation_averaging_trivial(rng):
    R = random_rotation(rng)
    out = averaging.single_rotation_averaging(_t(R[None]))
    assert np.allclose(out.numpy(), R, atol=1e-10)
    _close(out, javg.single_rotation_averaging(_j(R[None])))


def test_single_rotation_averaging_noisy(rng):
    R = random_rotation(rng)
    Rs = np.stack([perturbed(R, rng, rng.normal(0.0, 0.05))
                   for _ in range(50)])
    out = averaging.single_rotation_averaging(_t(Rs))
    assert np.linalg.norm(out.numpy() - R) < 0.1
    _close(out, javg.single_rotation_averaging(_j(Rs)))


def test_robust_rotation_averaging_trivial(rng):
    R = random_rotation(rng)
    res = _robust_pair("robust_single_rotation_averaging", R[None])
    assert np.allclose(res.R.numpy(), R, atol=1e-8)
    assert res.inlier_mask.tolist() == [True]


def test_robust_rotation_averaging_outliers(rng):
    R = random_rotation(rng)
    inliers = [perturbed(R, rng, rng.normal(0.0, 0.01)) for _ in range(10)]
    outliers = [random_rotation(rng) for _ in range(40)]
    Rs = np.stack(inliers + outliers)
    before = averaging.HOST_READS
    res = _robust_pair("robust_single_rotation_averaging", Rs,
                       error_threshold=lie.angular_to_chordal_so3(0.5))
    # The skip test plus one stop test per GNC iteration.
    assert averaging.HOST_READS - before >= 2
    mask = res.inlier_mask.numpy()
    assert mask[:10].all() and not mask[10:].any()
    assert np.linalg.norm(res.R.numpy() - R) < 0.05


def test_robust_pose_averaging_outliers(rng):
    R = random_rotation(rng)
    t = rng.standard_normal(3)
    kR, kt = 10, 40
    inl_R = [perturbed(R, rng, rng.normal(0.0, 0.005)) for _ in range(kR)]
    inl_t = [t + 0.01 * rng.standard_normal(3) for _ in range(kR)]
    out_R = [random_rotation(rng) for _ in range(kt)]
    out_t = [t + 5.0 * rng.standard_normal(3) for _ in range(kt)]
    res = _robust_pair("robust_single_pose_averaging",
                       np.stack(inl_R + out_R), np.stack(inl_t + out_t),
                       error_threshold=1.0)
    mask = res.inlier_mask.numpy()
    assert mask[:kR].all() and not mask[kR:].any()
    assert np.linalg.norm(res.R.numpy() - R) < 0.05
    assert np.linalg.norm(res.t.numpy() - t) < 0.05


def test_robust_averaging_float32(rng):
    """The inlier tolerance is dtype-aware: in float32 ``1 - 1e-8`` rounds
    to 1, and exact weights of 1 must still count as inliers."""
    R = random_rotation(rng)
    res = _robust_pair("robust_single_rotation_averaging",
                       np.stack([R] * 4), dtype=torch.float32)
    assert res.inlier_mask.tolist() == [True] * 4

    inliers = [perturbed(R, rng, rng.normal(0.0, 0.01)) for _ in range(8)]
    outliers = [random_rotation(rng) for _ in range(12)]
    res = _robust_pair("robust_single_rotation_averaging",
                       np.stack(inliers + outliers), dtype=torch.float32,
                       error_threshold=lie.angular_to_chordal_so3(0.5))
    mask = res.inlier_mask.numpy()
    assert mask[:8].all() and not mask[8:].any()

    ts = rng.standard_normal((4, 3)).astype(np.float32)
    res = _robust_pair("robust_single_pose_averaging", np.stack([R] * 4),
                       np.broadcast_to(ts[0], (4, 3)), dtype=torch.float32)
    assert res.inlier_mask.tolist() == [True] * 4
    assert averaging._w_tol(torch.float32) == pytest.approx(
        javg._w_tol(jnp.float32))


def test_degenerate_zero_weight_translation_is_zero_not_nan(rng):
    ts = rng.standard_normal((5, 3))
    t = averaging.single_translation_averaging(_t(ts), tau=torch.zeros(5))
    assert np.array_equal(t.numpy(), np.zeros(3))
    _close(t, javg.single_translation_averaging(_j(ts), tau=jnp.zeros(5)))
    t2 = averaging.single_translation_averaging(
        _t(ts), tau=torch.ones(5, dtype=torch.float64),
        mask=torch.zeros(5, dtype=torch.float64))
    assert np.array_equal(t2.numpy(), np.zeros(3))
    t3 = averaging.single_translation_averaging(
        _t(ts, torch.float32), tau=torch.zeros(5))
    assert t3.dtype == torch.float32 and bool(torch.isfinite(t3).all())


def test_degenerate_zero_weight_rotation_is_finite(rng):
    """The zero matrix projects to a finite, deterministic rotation (the
    identity, as LAPACK's SVD gives it in the JAX package)."""
    Rs = np.stack([random_rotation(rng) for _ in range(4)])
    z = torch.zeros(4, dtype=torch.float64)
    R = averaging.single_rotation_averaging(_t(Rs), kappa=z)
    assert bool(torch.isfinite(R).all())
    assert np.allclose(R.numpy() @ R.numpy().T, np.eye(3), atol=1e-6)
    assert torch.equal(R, averaging.single_rotation_averaging(_t(Rs),
                                                              kappa=z))
    _close(R, javg.single_rotation_averaging(_j(Rs), kappa=jnp.zeros(4)))
    ts = rng.standard_normal((4, 3))
    Rp, tp = averaging.single_pose_averaging(_t(Rs), _t(ts), kappa=z, tau=z)
    jRp, jtp = javg.single_pose_averaging(_j(Rs), _j(ts),
                                          kappa=jnp.zeros(4),
                                          tau=jnp.zeros(4))
    assert bool(torch.isfinite(Rp).all())
    assert np.array_equal(tp.numpy(), np.zeros(3))
    _close(Rp, jRp)
    _close(tp, jtp)


def test_all_outlier_robust_averaging_reports_empty_inlier_set(rng):
    Rs = np.stack([random_rotation(rng) for _ in range(6)])
    res = _robust_pair("robust_single_rotation_averaging", Rs,
                       error_threshold=lie.angular_to_chordal_so3(1e-4))
    assert not res.inlier_mask.any()
    assert bool(torch.isfinite(res.R).all())
    assert bool(torch.isfinite(res.weights).all())
    ts = 5.0 * rng.standard_normal((6, 3))
    resp = _robust_pair("robust_single_pose_averaging", Rs, ts,
                        error_threshold=1e-4)
    assert not resp.inlier_mask.any()
    assert bool(torch.isfinite(resp.R).all() & torch.isfinite(resp.t).all())


def test_robust_averaging_skip_and_mask(rng):
    """The JAX test's jit case has no counterpart (eager PyTorch); in its
    place: GNC is skipped, with one host read, when every residual is
    already small (mu0 <= 0), and masked-out candidates are never
    inliers."""
    R = random_rotation(rng)
    Rs = np.stack([perturbed(R, rng, 0.01) for _ in range(5)])
    before = averaging.HOST_READS
    res = _robust_pair("robust_single_rotation_averaging", Rs,
                       error_threshold=0.5)
    assert averaging.HOST_READS - before == 1
    assert res.inlier_mask.all()
    mask = np.array([1.0, 1.0, 0.0, 1.0, 0.0])
    res = _robust_pair("robust_single_rotation_averaging", Rs,
                       error_threshold=0.5, mask=mask)
    assert res.inlier_mask.tolist() == [True, True, False, True, False]
