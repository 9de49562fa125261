"""Closed-form batched math on the tiny fixed-size matrices of PGO (port of
``dpgo_tpu.ops.smallmat``): the polar factor by Newton-Schulz, and the
unrolled (d+1)x(d+1) Cholesky factor and solves of the block-Jacobi
preconditioner."""

from __future__ import annotations

import functools

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


# --- Sync-free symmetric eigensolver, thin SVD and QR ----------------------
#
# ``torch.linalg.eigh``/``svd``/``qr`` read an ``info`` tensor back to the
# host on every CUDA call.  The certificate's eigensolve needs a few small
# decompositions per LOBPCG iteration, so these are plain tensor programs
# instead: cyclic Jacobi with a fixed sweep count on a CUDA device (on the
# CPU the sweeps stop once the off-diagonal is below rounding), the pairs
# of each sweep in round-robin order so that every round rotates disjoint
# pairs at once (one rotation matrix, three products).


def _round_robin(n: int) -> list:
    """The rounds of one cyclic sweep over ``n`` indices: each round a list
    of disjoint pairs ``(p, q)``, ``p < q``; every pair once per sweep."""
    players = list(range(n)) + ([None] if n % 2 else [])
    m = len(players)
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a is not None and b is not None:
                pairs.append((min(a, b), max(a, b)))
        if pairs:
            rounds.append(pairs)
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _schedule(n: int, device) -> list:
    """Per round: the flat indices of (a_pp, a_qq, a_pq) in an n x n
    matrix, and of J's (pp, qq, pq, qp) entries.  Built with device
    arithmetic (no host-to-device copy, which would sync)."""
    out = []
    for pairs in _round_robin(n):
        lo = torch.zeros(len(pairs), dtype=torch.long, device=device)
        hi = torch.zeros_like(lo)
        for k, (a, b) in enumerate(pairs):
            lo[k] = a
            hi[k] = b
        p, q = lo, hi
        out.append((torch.cat([p * n + p, q * n + q, p * n + q]),
                    torch.cat([p * n + p, q * n + q, p * n + q, q * n + p])))
    return out


def _rotation(G: torch.Tensor, gather: torch.Tensor, put: torch.Tensor,
              eye_flat: torch.Tensor) -> torch.Tensor:
    """The round's Jacobi rotation J [..., n, n] that zeroes the pairs'
    off-diagonal entries of the symmetric ``G`` under ``J^T G J``: per
    pair ``tan 2 phi = 2 g_pq / (g_qq - g_pp)``, ``|phi| <= pi / 4``,
    and ``J[p, p] = J[q, q] = cos phi``, ``J[p, q] = -J[q, p] =
    sin phi``."""
    n = G.shape[-1]
    lead = G.shape[:-2]
    app, aqq, apq = G.reshape(lead + (n * n,))[..., gather].chunk(3, dim=-1)
    phi = 0.5 * torch.nan_to_num(torch.atan(2.0 * apq / (aqq - app)),
                                 nan=0.0)
    c, s = torch.cos(phi), torch.sin(phi)
    J = eye_flat.expand(lead + (n * n,)).scatter(
        -1, put.expand(lead + put.shape), torch.cat([c, c, s, -s], dim=-1))
    return J.reshape(lead + (n, n))


def _default_sweeps(dtype: torch.dtype) -> int:
    return 10 if dtype == torch.float64 else 6


def _converged(G: torch.Tensor) -> bool:
    """On the CPU, where a read costs nothing: has the sweep left every
    off-diagonal entry of ``G`` below the rounding of its diagonal?  On a
    CUDA device never asked (the sweep count is fixed, no host sync)."""
    if G.device.type != "cpu":
        return False
    d = torch.diagonal(G, dim1=-2, dim2=-1)
    off = G - torch.diag_embed(d)
    eps = torch.finfo(G.dtype).eps
    return bool((off.abs().amax(dim=(-2, -1))
                 <= eps * d.abs().amax(dim=-1)).all())


def eigh_small(A: torch.Tensor, sweeps: int | None = None):
    """Eigen-decomposition of symmetric ``A [..., n, n]`` by cyclic Jacobi
    with a fixed number of sweeps (no host sync): ``(w [..., n] ascending,
    V [..., n, n])`` with ``A = V diag(w) V^T``."""
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    if n > 1:
        eye_flat = torch.eye(n, dtype=A.dtype, device=A.device).reshape(-1)
        sched = _schedule(n, A.device)
        for _ in range(sweeps or _default_sweeps(A.dtype)):
            for gather, put in sched:
                J = _rotation(A, gather, put, eye_flat)
                A = J.transpose(-1, -2) @ A @ J
                V = V @ J
            if _converged(A):
                break
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def svd_thin(A: torch.Tensor, sweeps: int | None = None):
    """Thin SVD of ``A [..., m, r]`` (``m >= r``) by one-sided Jacobi on
    its r columns, with a fixed number of sweeps (no host sync): column
    pairs are rotated until orthogonal, each round's rotation taken from
    the Gram matrix of the current columns, so small singular values keep
    their relative accuracy.  Returns ``(U [..., m, r], s [..., r]
    descending, V [..., r, r])`` with ``A = U diag(s) V^T``; a zero
    singular value has a zero column in U."""
    r = A.shape[-1]
    V = torch.eye(r, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (r, r)).clone()
    if r > 1:
        eye_flat = torch.eye(r, dtype=A.dtype, device=A.device).reshape(-1)
        sched = _schedule(r, A.device)
        for _ in range(sweeps or _default_sweeps(A.dtype)):
            for gather, put in sched:
                J = _rotation(A.transpose(-1, -2) @ A, gather, put, eye_flat)
                A = A @ J
                V = V @ J
            if _converged(A.transpose(-1, -2) @ A):
                break
    s = torch.linalg.vector_norm(A, dim=-2)
    s, order = torch.sort(s, dim=-1, descending=True)
    A = torch.gather(A, -1, order[..., None, :].expand(A.shape))
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    U = A / torch.where(s > 0, s, 1.0)[..., None, :]
    return U, s, V


def det_small(A: torch.Tensor) -> torch.Tensor:
    """Determinant of ``A [..., d, d]``: closed form for d <= 3 (no host
    sync), ``torch.linalg.det`` above."""
    d = A.shape[-1]
    if d == 1:
        return A[..., 0, 0]
    if d == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if d == 3:
        return torch.sum(A[..., 0, :] * torch.linalg.cross(
            A[..., 1, :], A[..., 2, :], dim=-1), dim=-1)
    return torch.linalg.det(A)


def qr_small(A: torch.Tensor) -> torch.Tensor:
    """The Q factor ``[m, k]`` of the reduced QR of ``A [m, k]`` (``m >=
    k``) by Householder reflections with LAPACK's sign convention
    (``R_jj = -sign(a_jj) |a_j|``); a column that is already zero below
    its diagonal gets the identity reflection, as in LAPACK's ``larfg``.
    No host sync."""
    m, k = A.shape
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    Q = eye
    R = A
    rows = torch.arange(m, device=A.device)
    for j in range(k):
        x = torch.where(rows >= j, R[:, j], 0.0)
        alpha = x[j]
        tail = torch.linalg.vector_norm(torch.where(rows > j, x, 0.0))
        beta = -torch.where(alpha >= 0, 1.0, -1.0) * torch.sqrt(
            alpha * alpha + tail * tail)
        u = x - beta * eye[j]
        un = torch.linalg.vector_norm(u)
        u = torch.where(tail > 0, u / torch.where(un > 0, un, 1.0), 0.0)
        H = eye - 2.0 * u[:, None] * u[None, :]
        R = H @ R
        Q = Q @ H
    return Q[:, :k]
