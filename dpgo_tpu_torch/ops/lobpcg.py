"""Top-k eigenpairs of a symmetric operator by LOBPCG — the port's own copy
of the algorithm behind ``jax.experimental.sparse.linalg.lobpcg_standard``
(jax 0.9.0, ``jax/experimental/sparse/linalg.py:37-500``).

The same method step for step: an orthonormal basis ``[X, P, R]`` is kept
throughout (SVQB orthonormalization, ``_project_out`` with the "twice is
enough" subtraction and the final zeroing of suspicious columns), the
Rayleigh-Ritz problem on it is solved whole, the search directions come
from a QR of the Ritz vectors' off-diagonal quadrant, the initial P from
block Householder reflectors (``_extend_basis``), and an eigenpair is
converged when ``|A x - theta x| < tol * 10 * n * (theta + |A x|)`` with
``tol = eps(dtype)`` by default.

The JAX loop exits as soon as all k pairs converge.  Here every small
decomposition is sync-free (``ops.smallmat``) and the loop runs a fixed
budget of ``m`` iterations on a CUDA device, its state frozen under a mask
from the iteration at which all k pairs converged — the same result with
no host read.  On the CPU, where a read costs nothing, the loop stops
there.  ``torch.lobpcg`` is a different algorithm (another stopping rule,
``n >= 3k``, a host read per iteration) and is not used.
"""

from __future__ import annotations

import torch

from ..device import sync_free
from .smallmat import eigh_small, qr_small, svd_thin


def _colnorm(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _eigh_descending(A: torch.Tensor):
    w, V = eigh_small(A)
    return torch.flip(w, (-1,)), torch.flip(V, (-1,))


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis for the columns of ``X``: columns
    normalized, the Gram matrix diagonalized, directions below
    ``eps * max eigenvalue`` zeroed."""
    norms = _colnorm(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _colnorm(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The component of ``U`` in the complement of the orthonormal
    ``basis`` (zero columns allowed), its nonzero columns orthonormal and
    any column that kept less than 0.99 of its norm zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_colnorm(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S: torch.Tensor):
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` columns that extend the orthonormal ``X [n, k]`` to an
    orthonormal set, by block Householder reflectors."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, v = svd_thin(Xupper)
    vt = v.T
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       X.new_zeros((n - k - m, m))], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    return torch.cat([h[:k], h[k:] + other], dim=0)


def lobpcg_standard(A, X: torch.Tensor, m: int = 100,
                    tol: float | None = None):
    """The top-k eigenpairs of the symmetric operator ``A`` (a callable on
    ``[n, j]`` blocks) from the initial directions ``X [n, k]``
    (``0 < 5 k < n``).  Returns ``(theta [k] descending, U [n, k],
    iterations)``, ``iterations`` a 0-dim int tensor."""
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    frozen = sync_free(X)

    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    converged = torch.zeros((), dtype=torch.int64, device=X.device)
    i = torch.zeros((), dtype=torch.int64, device=X.device)
    for _ in range(m):
        active = converged < k
        if not frozen and not bool(active):
            break
        Rn = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, Rn], dim=1)
        th, Q = _rayleigh_ritz_orth(A, XPR)
        B = Q[:, :k]
        B = B / _colnorm(B)
        Xn = XPR @ B
        Xn = Xn / _colnorm(Xn)
        q = qr_small(Q[:k, k:].T)
        Pn = XPR @ (Q[:, k:] @ q)
        normP = _colnorm(Pn)
        Pn = Pn / torch.where(normP == 0, 1.0, normP)
        AXn = A(Xn)
        thk = th[None, :k]
        Rr = AXn - thk * Xn
        reltol = (torch.linalg.vector_norm(AXn, dim=0) + th[:k]) * n * 10
        conv = torch.sum(torch.linalg.vector_norm(Rr, dim=0) < tol * reltol)
        X = torch.where(active, Xn, X)
        P = torch.where(active, Pn, P)
        R = torch.where(active, Rr, R)
        theta = torch.where(active, thk, theta)
        converged = torch.where(active, conv, converged)
        i = i + active.to(i.dtype)
    return theta[0], X, i
