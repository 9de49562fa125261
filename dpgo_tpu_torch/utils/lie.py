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
    (reference ``projectToRotationGroup``, ``DPGO_utils.cpp:478-492``)."""
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    det = torch.linalg.det(U @ Vh)
    d = M.shape[-1]
    signs = torch.ones(M.shape[:-2] + (d,), dtype=M.dtype, device=M.device)
    signs[..., -1] = torch.where(det < 0, -1.0, 1.0).to(M.dtype)
    return (U * signs[..., None, :]) @ Vh


def project_to_stiefel(M: torch.Tensor) -> torch.Tensor:
    """Polar factor of [..., r, d] (closest orthonormal-columns matrix), by
    the Newton-Schulz iteration of ``ops.smallmat.polar_orthonormalize``."""
    from ..ops.smallmat import polar_orthonormalize

    return polar_orthonormalize(M)


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
