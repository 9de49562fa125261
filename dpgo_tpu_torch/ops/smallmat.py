"""Closed-form batched math on the tiny fixed-size matrices of PGO (port of
``dpgo_tpu.ops.smallmat``): the polar factor by Newton-Schulz, and the
unrolled (d+1)x(d+1) Cholesky factor and solves of the block-Jacobi
preconditioner."""

from __future__ import annotations

import torch


def polar_orthonormalize(M: torch.Tensor, num_iters: int = 40) -> torch.Tensor:
    """Polar factor ``M (M^T M)^{-1/2}`` of ``M [..., r, d]`` by the coupled
    Newton-Schulz iteration on ``A / tr(A)``, ``A = M^T M``:

        T_k = (3 I - Z_k Y_k) / 2,  Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k,

    with ``Z_k -> (A / s)^{-1/2}``.  Good to condition(M) ~1e5-1e6 in float64
    with the default 40 sweeps."""
    A = M.transpose(-1, -2) @ M
    s = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    s = torch.clamp(s, min=torch.finfo(M.dtype).tiny)
    Y = A / s
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Z = eye.expand_as(Y)
    for _ in range(num_iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return M @ (Z / torch.sqrt(s))


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A [..., k, k]``, unrolled over k."""
    k = A.shape[-1]
    eps = torch.finfo(A.dtype).tiny
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s = A[..., j, j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        diag = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = diag
        for i in range(j + 1, k):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s / diag
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(k)], dim=-1)
                        for i in range(k)], dim=-2)


def cho_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` from the lower factor ``L [..., k, k]`` of ``A``;
    ``B [..., k, m]``; forward then back substitution, unrolled over k."""
    k = L.shape[-1]
    y = [None] * k
    for i in range(k):
        s = B[..., i, :]
        for p in range(i):
            s = s - L[..., i, p, None] * y[p]
        y[i] = s / L[..., i, i, None]
    x = [None] * k
    for i in reversed(range(k)):
        s = y[i]
        for p in range(i + 1, k):
            s = s - L[..., p, i, None] * x[p]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)
