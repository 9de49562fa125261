"""The lifted SE(d) product manifold (St(r, d) x R^r)^n as batched tensor
ops (port of ``dpgo_tpu.ops.manifold``).  A point is ``X [..., n, r, d+1]``
of pose blocks ``[Y_i | p_i]``; every function treats the last three axes as
``(n, r, d+1)`` and broadcasts over leading batch axes (agents)."""

from __future__ import annotations

import torch

from ..utils.lie import project_to_stiefel


def sym(A: torch.Tensor) -> torch.Tensor:
    """Symmetric part over the last two axes."""
    return 0.5 * (A + A.transpose(-1, -2))


def split(X: torch.Tensor):
    """Pose blocks [..., r, d+1] -> (Y [..., r, d], p [..., r])."""
    return X[..., :-1], X[..., -1]


def join(Y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.cat([Y, p[..., None]], dim=-1)


def project(X: torch.Tensor) -> torch.Tensor:
    """Per-pose Stiefel projection of Y; translations untouched."""
    Y, p = split(X)
    return join(project_to_stiefel(Y), p)


def tangent_project(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``W - Y sym(Y^T W)`` on the Stiefel factor, identity on R^r."""
    Y, _ = split(X)
    W, w = split(V)
    return join(W - Y @ sym(Y.transpose(-1, -2) @ W), w)


def retract(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Polar retraction ``polar(Y + V_Y)``; plain addition on R^r."""
    Y, p = split(X)
    W, w = split(V)
    return join(project_to_stiefel(Y + W), p + w)


def retract_correction(D: torch.Tensor, eta: torch.Tensor,
                       R: torch.Tensor) -> torch.Tensor:
    """``D_new`` with ``R + D_new = retract(R + D, eta)``, computed from the
    small quantities only: with ``U = D + eta``,
    ``E = sym(R_Y^T U_Y + U_Y^T R_Y + U_Y^T U_Y)`` and the series
    ``C = -E/2 + 3/8 E^2 - 5/16 E^3 + 35/128 E^4 ~ (I + E)^(-1/2) - I``,
    ``D_new_Y = U_Y + (R_Y + U_Y) C``.  ``R`` must lie on the manifold
    (``R_Y^T R_Y = I``)."""
    d = R.shape[-1] - 1
    U = D + eta
    UY, RY = U[..., :d], R[..., :d]
    E = sym(RY.transpose(-1, -2) @ UY + UY.transpose(-1, -2) @ RY
            + UY.transpose(-1, -2) @ UY)
    E2 = E @ E
    C = -0.5 * E + 0.375 * E2 - 0.3125 * (E2 @ E) + 0.2734375 * (E2 @ E2)
    return join(UY + (RY + UY) @ C, U[..., d])


def inner(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Euclidean inner product over the trailing (n, r, d+1) axes."""
    return torch.sum(U * V, dim=(-3, -2, -1))


def norm(U: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(inner(U, U))


def ehess_to_rhess(X: torch.Tensor, egrad: torch.Tensor,
                   ehess_v: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Euclidean -> Riemannian Hessian-vector product at ``X``:
    ``P_X(EucHess[V] - [V_Y sym(Y^T G_Y) | 0])``."""
    Y, _ = split(X)
    G_Y, _ = split(egrad)
    V_Y, _ = split(V)
    corr_Y = V_Y @ sym(Y.transpose(-1, -2) @ G_Y)
    corr = join(corr_Y, torch.zeros_like(V[..., -1]))
    return tangent_project(X, ehess_v - corr)


def rgrad(X: torch.Tensor, egrad: torch.Tensor) -> torch.Tensor:
    """Riemannian gradient = tangent projection of the Euclidean one."""
    return tangent_project(X, egrad)
