"""Rotation / Stiefel / SE(d) primitives of the PyTorch port.

Counterpart of ``dpgo_tpu.utils.lie``.  The host-side helpers (quaternion
conversion, 2D rotations) are numpy; the batched projections take tensors
with any leading batch dimensions.

The lifting matrix YLift must be the same element of St(r, d) as in the JAX
package, because every lifted iterate is ``YLift @ T``.  The JAX package
draws it from ``jax.random.normal(PRNGKey(1))``; ``_jax_normal`` below
reproduces that draw in numpy (Threefry-2x32 counter hash, the
"partitionable" bit layout, 52-bit mantissa fill, ``sqrt(2) erfinv``), so the
port needs no JAX to build the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def quat_to_rotation(q: np.ndarray) -> np.ndarray:
    """Quaternion(s) [..., 4] in (x, y, z, w) order -> rotations [..., 3, 3]
    (Eigen's ``Quaterniond(w, x, y, z).toRotationMatrix()``)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotations [..., 3, 3] -> quaternions [..., 4] in (x, y, z, w), with
    Shepperd's branch selection."""
    R = np.asarray(R, dtype=np.float64)
    batch = R.shape[:-2]
    Rf = R.reshape((-1, 3, 3))
    m00, m01, m02 = Rf[:, 0, 0], Rf[:, 0, 1], Rf[:, 0, 2]
    m10, m11, m12 = Rf[:, 1, 0], Rf[:, 1, 1], Rf[:, 1, 2]
    m20, m21, m22 = Rf[:, 2, 0], Rf[:, 2, 1], Rf[:, 2, 2]
    tr = m00 + m11 + m22
    q = np.empty((Rf.shape[0], 4), dtype=np.float64)

    c0 = tr > 0
    s = np.sqrt(np.maximum(tr + 1.0, 0.0)) * 2
    q[c0, 3] = 0.25 * s[c0]
    q[c0, 0] = (m21 - m12)[c0] / s[c0]
    q[c0, 1] = (m02 - m20)[c0] / s[c0]
    q[c0, 2] = (m10 - m01)[c0] / s[c0]

    c1 = (~c0) & (m00 >= m11) & (m00 >= m22)
    s = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0.0)) * 2
    q[c1, 3] = (m21 - m12)[c1] / s[c1]
    q[c1, 0] = 0.25 * s[c1]
    q[c1, 1] = (m01 + m10)[c1] / s[c1]
    q[c1, 2] = (m02 + m20)[c1] / s[c1]

    c2 = (~c0) & (~c1) & (m11 >= m22)
    s = np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 0.0)) * 2
    q[c2, 3] = (m02 - m20)[c2] / s[c2]
    q[c2, 0] = (m01 + m10)[c2] / s[c2]
    q[c2, 1] = 0.25 * s[c2]
    q[c2, 2] = (m12 + m21)[c2] / s[c2]

    c3 = (~c0) & (~c1) & (~c2)
    s = np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 0.0)) * 2
    q[c3, 3] = (m10 - m01)[c3] / s[c3]
    q[c3, 0] = (m02 + m20)[c3] / s[c3]
    q[c3, 1] = (m12 + m21)[c3] / s[c3]
    q[c3, 2] = 0.25 * s[c3]

    return q.reshape(batch + (4,))


def rotation2d(theta) -> np.ndarray:
    """Angle(s) [...] -> SO(2) matrices [..., 2, 2]."""
    theta = np.asarray(theta, dtype=np.float64)
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c, -s, s, c], axis=-1).reshape(theta.shape + (2, 2))


def project_to_rotation(M: torch.Tensor) -> torch.Tensor:
    """Project [..., d, d] matrices onto SO(d): SVD with a determinant fix
    (reference ``projectToRotationGroup``, ``DPGO_utils.cpp:478-492``).
    The SVD is ``ops.smallmat.svd_thin`` (Jacobi, no host sync, so the
    terminal rounding can run under the sync-error debug mode); a zero
    singular value's missing left vector is completed from the others
    (d = 2, 3)."""
    from ..ops.smallmat import det_small, svd_thin

    U, s, V = svd_thin(M)
    d = M.shape[-1]
    # The zero matrix (e.g. a weighted average whose weights are all 0)
    # projects to the identity, as LAPACK's SVD (U = V = I) gives it.
    U = torch.where(s[..., :1, None] > 0, U,
                    torch.eye(d, dtype=M.dtype, device=M.device))
    if d in (2, 3):
        if d == 2:
            last = torch.stack([-U[..., 1, 0], U[..., 0, 0]], dim=-1)
        else:
            last = torch.linalg.cross(U[..., :, 0], U[..., :, 1], dim=-1)
        U = torch.cat([U[..., :-1], torch.where(
            s[..., -1:, None] > 0, U[..., -1:], last[..., None])], dim=-1)
    Vh = V.transpose(-1, -2)
    flip = det_small(U @ Vh) < 0
    signs = torch.cat([torch.ones_like(s[..., :-1]),
                       torch.where(flip, -1.0, 1.0).to(M.dtype)[..., None]],
                      dim=-1)
    return (U * signs[..., None, :]) @ Vh


def project_to_stiefel(M: torch.Tensor) -> torch.Tensor:
    """Polar factor of [..., r, d] (closest orthonormal-columns matrix), by
    the Newton-Schulz iteration of ``ops.smallmat.polar_orthonormalize``."""
    from ..ops.smallmat import polar_orthonormalize

    return polar_orthonormalize(M)


def project_to_stiefel_svd(M: torch.Tensor) -> torch.Tensor:
    """SVD form of ``project_to_stiefel`` (``U V^T`` of the thin SVD;
    robust at any conditioning; cold paths only)."""
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    return U @ Vh


def stiefel_from_gaussian(G: torch.Tensor) -> torch.Tensor:
    """The point of St(r, d) that ``random_stiefel`` makes from a Gaussian
    draw ``G`` [..., r, d]: the Q of its QR with signs fixed so diag(R) >
    0 (the factorization's unique form) — the seam that parity tests feed
    the JAX package's draws through."""
    Q, R = torch.linalg.qr(G)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s[..., None, :]


def random_stiefel(generator: torch.Generator | None, r: int, d: int,
                   batch=(), dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Uniform random point(s) on St(r, d) via QR of a Gaussian drawn from
    ``generator`` (a ``torch.Generator`` on ``device``, or None for the
    default one) — the JAX package's ``random_stiefel(key, ...)``, with
    another random stream (``stiefel_from_gaussian`` is the shared map)."""
    dev = resolve_device(device)
    G = torch.randn(tuple(batch) + (r, d), generator=generator, dtype=dtype,
                    device=dev)
    return stiefel_from_gaussian(G)


def check_rotation_matrix(R, tol: float = 1e-8):
    """Validate SO(d) membership: det +1 and orthonormal within ``tol``
    (reference ``checkRotationMatrix``, ``DPGO_utils.cpp:526-531`` — an
    assert there; a boolean here so callers choose raise vs mask).
    Batched: returns an [...] bool array for [..., d, d] input (a tensor is
    read to the host)."""
    if isinstance(R, torch.Tensor):
        R = R.detach().cpu().numpy()
    R = np.asarray(R)
    d = R.shape[-1]
    det_ok = np.abs(np.linalg.det(R) - 1.0) < tol
    eye = np.eye(d)
    orth = np.linalg.norm(
        np.swapaxes(R, -1, -2) @ R - eye, axis=(-2, -1)) < tol
    out = det_ok & orth
    return bool(out) if out.ndim == 0 else out


def se_matrix(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Homogeneous SE(d) matrices [..., d+1, d+1] from R [..., d, d], t
    [..., d] (host numpy)."""
    R = np.asarray(R)
    t = np.asarray(t)
    d = R.shape[-1]
    T = np.zeros(R.shape[:-2] + (d + 1, d + 1), dtype=R.dtype)
    T[..., :d, :d] = R
    T[..., :d, d] = t
    T[..., d, d] = 1.0
    return T


# --- The JAX package's fixed Stiefel element, reproduced in numpy ----------

_M32 = np.uint64(0xFFFFFFFF)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def _threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds), the counter hash behind ``jax.random``.
    uint32 arithmetic is carried in uint64 and masked."""
    ks = [np.uint64(k1), np.uint64(k2),
          np.uint64(k1) ^ np.uint64(k2) ^ np.uint64(0x1BD11BDA)]
    rot = [(13, 15, 26, 6), (17, 29, 16, 24)]
    x = [(x1.astype(np.uint64) + ks[0]) & _M32,
         (x2.astype(np.uint64) + ks[1]) & _M32]
    for i in range(5):
        for r in rot[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl32(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0], x[1]


def _jax_normal(seed: int, shape: tuple) -> np.ndarray:
    """float64 ``jax.random.normal(jax.random.PRNGKey(seed), shape)``."""
    from scipy.special import erfinv

    size = int(np.prod(shape))
    count = np.arange(size, dtype=np.uint64)
    hi, lo = _threefry2x32(0, seed, count >> np.uint64(32), count & _M32)
    bits = (hi << np.uint64(32)) | lo
    one = np.array(1.0).view(np.uint64)
    u = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    lo_v = np.nextafter(-1.0, 0.0)
    u = np.maximum(lo_v, u * (1.0 - lo_v) + lo_v)
    return (np.sqrt(2.0) * erfinv(u)).reshape(shape)


def fixed_stiefel(r: int, d: int) -> np.ndarray:
    """The deterministic element of St(r, d) the JAX package uses as YLift
    (QR of a fixed Gaussian draw, signs fixed so diag(R) > 0); float64."""
    G = _jax_normal(1, (r, d))
    Q, Rq = np.linalg.qr(G)
    s = np.sign(np.diagonal(Rq))
    s = np.where(s == 0, 1.0, s)
    return Q * s[None, :]


def lifting_matrix(rank: int, d: int, dtype=torch.float64,
                   device="cuda") -> torch.Tensor:
    """The shared lifting matrix YLift in St(rank, d): identity for
    rank == d, else ``fixed_stiefel`` (reference ``PGOAgent.cpp:46``)."""
    if rank < d:
        raise ValueError(f"relaxation rank {rank} must be >= d = {d}")
    Y = np.eye(d) if rank == d else fixed_stiefel(rank, d)
    return torch.as_tensor(Y, dtype=dtype, device=resolve_device(device))


def angular_to_chordal_so3(rad: float) -> float:
    """Angular distance (radians) -> chordal (Frobenius) distance on SO(3)
    (reference ``angular2ChordalSO3``, ``DPGO_utils.cpp:522-524``); a
    Python float, so it never promotes a float32 tensor."""
    return float(2.0 * np.sqrt(2.0) * np.sin(rad / 2.0))


def chi2inv(quantile: float, dof: int) -> float:
    """Chi-squared quantile (reference ``DPGO_utils.cpp:517-520``); a
    config-time host scalar from scipy."""
    from scipy.stats import chi2

    return float(chi2.ppf(quantile, dof))


def error_threshold_at_quantile(quantile: float, dof: int = 6) -> float:
    """sqrt(chi2inv(q, dof)): a GNC barc from a probabilistic quantile
    (reference ``RobustCost::computeErrorThresholdAtQuantile``)."""
    return float(np.sqrt(chi2inv(quantile, dof)))
