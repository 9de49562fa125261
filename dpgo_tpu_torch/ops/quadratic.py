"""Edge-list quadratic PGO cost f(X) = 0.5 <Q, X^T X> + <X, G> without
assembling Q or G (port of ``dpgo_tpu.ops.quadratic``).

For an SE(d) edge e = (i -> j) with measurement (R_e, t_e), precisions
(kappa_e, tau_e), weight w_e and pose blocks X_i = [Y_i | p_i]:

    rR_e = Y_j - Y_i R_e,   rt_e = p_j - p_i - Y_i t_e,
    f(X) = 0.5 sum_e w_e (kappa_e ||rR_e||^2 + tau_e ||rt_e||^2).

A local problem evaluates the sum over the buffer ``[X_local (n) | Z (s)]``.
Every function takes either one edge set (``edges.i [E]``, ``X [N, r, k]``)
or a batch of them (``edges.i [A, E]``, ``X [A, N, r, k]``).
"""

from __future__ import annotations

import math

import torch

from ..types import EdgeSet


def take(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``X [..., N, *tail]`` at ``idx [..., E]`` -> ``[..., E, *tail]``
    (per batch element when ``idx`` has leading dimensions)."""
    lead = idx.shape[:-1]
    if not lead:
        return X[idx]
    N = X.shape[len(lead)]
    tail = X.shape[len(lead) + 1:]
    B = math.prod(lead)
    off = torch.arange(B, device=idx.device).reshape(*lead, 1) * N
    flat = X.reshape((B * N,) + tuple(tail))
    rows = flat[(idx + off).reshape(-1)]
    return rows.reshape(tuple(idx.shape) + tuple(tail))


def scatter_add(N: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Sum ``vals [..., E, *tail]`` into ``[..., N, *tail]`` rows ``idx``."""
    lead = idx.shape[:-1]
    tail = vals.shape[len(lead) + 1:]
    B = math.prod(lead)
    out = torch.zeros((B * N,) + tuple(tail), dtype=vals.dtype,
                      device=vals.device)
    off = torch.arange(B, device=idx.device).reshape(*lead, 1) * N
    out.index_add_(0, (idx + off).reshape(-1),
                   vals.reshape((-1,) + tuple(tail)))
    return out.reshape(tuple(lead) + (N,) + tuple(tail))


def _edge_terms(Xbuf: torch.Tensor, edges: EdgeSet):
    """Per-edge residuals: (rR [..., E, r, d], rt [..., E, r])."""
    Xi = take(Xbuf, edges.i)
    Xj = take(Xbuf, edges.j)
    Yi, pi = Xi[..., :-1], Xi[..., -1]
    Yj, pj = Xj[..., :-1], Xj[..., -1]
    rR = Yj - Yi @ edges.R
    rt = pj - pi - (Yi @ edges.t[..., None])[..., 0]
    return rR, rt


def cost(Xbuf: torch.Tensor, edges: EdgeSet) -> torch.Tensor:
    """f = 0.5 sum_e w_e (kappa ||rR||^2 + tau ||rt||^2), per batch."""
    rR, rt = _edge_terms(Xbuf, edges)
    w = edges.mask * edges.weight
    quad = edges.kappa * torch.sum(rR * rR, dim=(-2, -1)) + \
        edges.tau * torch.sum(rt * rt, dim=-1)
    return 0.5 * torch.sum(w * quad, dim=-1)


def _edge_grad_terms(Xbuf: torch.Tensor, edges: EdgeSet):
    """Per-edge gradient contributions (gi to endpoint i, gj to endpoint j),
    each [..., E, r, d+1]."""
    rR, rt = _edge_terms(Xbuf, edges)
    w = edges.mask * edges.weight
    wk = (w * edges.kappa)[..., None, None]
    wt = (w * edges.tau)[..., None]
    gj = torch.cat([wk * rR, (wt * rt)[..., None]], dim=-1)
    giY = -(wk * rR) @ edges.R.transpose(-1, -2) \
        - (wt * rt)[..., None] * edges.t[..., None, :]
    gi = torch.cat([giY, -(wt * rt)[..., None]], dim=-1)
    return gi, gj


def egrad(Xbuf: torch.Tensor, edges: EdgeSet,
          n_out: int | None = None) -> torch.Tensor:
    """Euclidean gradient by scatter-add, kept for the first ``n_out``
    slots (the reference's ``X Q + G``, ``QuadraticProblem.cpp:62-66``)."""
    N = Xbuf.shape[-3]
    gi, gj = _edge_grad_terms(Xbuf, edges)
    out = scatter_add(N, edges.i, gi) + scatter_add(N, edges.j, gj)
    return out if n_out is None else out[..., :n_out, :, :]


def egrad_ell(Xbuf: torch.Tensor, edges: EdgeSet, inc_slot: torch.Tensor,
              inc_mask: torch.Tensor) -> torch.Tensor:
    """Euclidean gradient through the padded per-pose incidence list:
    ``inc_slot [..., n, K]`` indexes ``[gi | gj]`` (slot e for endpoint i of
    edge e, E + e for endpoint j); a gather and a masked sum, no scatter."""
    gi, gj = _edge_grad_terms(Xbuf, edges)
    g_both = torch.cat([gi, gj], dim=-3)
    n, K = inc_slot.shape[-2:]
    flat = inc_slot.reshape(inc_slot.shape[:-2] + (n * K,)).long()
    contrib = take(g_both, flat)
    contrib = contrib.reshape(inc_slot.shape + contrib.shape[-2:])
    return torch.sum(contrib * inc_mask[..., None, None], dim=-3)


def _pad_to(V: torch.Tensor, n_buf: int) -> torch.Tensor:
    pad = torch.zeros(V.shape[:-3] + (n_buf - V.shape[-3],) + V.shape[-2:],
                      dtype=V.dtype, device=V.device)
    return torch.cat([V, pad], dim=-3)


def hessvec_ell(Vlocal: torch.Tensor, edges: EdgeSet, inc_slot: torch.Tensor,
                inc_mask: torch.Tensor, n_buf: int) -> torch.Tensor:
    """Hessian-vector product on the ELL layout: the gradient map with the
    neighbor slots zeroed (neighbors are constants)."""
    return egrad_ell(_pad_to(Vlocal, n_buf), edges, inc_slot, inc_mask)


def diag_blocks(edges: EdgeSet, n_buf: int,
                n_out: int | None = None) -> torch.Tensor:
    """Diagonal (d+1)x(d+1) blocks of the connection Laplacian: block i of
    edge (i -> j) gets ``[[wk I + wt t t^T, wt t], [wt t^T, wt]]``, block j
    gets ``diag(wk, ..., wk, wt)``."""
    d = edges.t.shape[-1]
    w = edges.mask * edges.weight
    wk = w * edges.kappa
    wt = w * edges.tau
    t = edges.t
    eye = torch.eye(d, dtype=t.dtype, device=t.device)
    top = torch.cat([wk[..., None, None] * eye
                     + wt[..., None, None] * t[..., :, None] * t[..., None, :],
                     (wt[..., None] * t)[..., :, None]], dim=-1)
    bottom = torch.cat([wt[..., None] * t, wt[..., None]], dim=-1)
    Bi = torch.cat([top, bottom[..., None, :]], dim=-2)
    diag_j = torch.cat([wk[..., None].expand(wk.shape + (d,)),
                        wt[..., None]], dim=-1)
    Bj = torch.diag_embed(diag_j)
    out = scatter_add(n_buf, edges.i, Bi) + scatter_add(n_buf, edges.j, Bj)
    return out if n_out is None else out[..., :n_out, :, :]


def precond_factors(blocks: torch.Tensor, shift: float) -> torch.Tensor:
    """Cholesky factors of (B_pose + shift I), batched over poses (the
    reference's Q + 0.1 I factorization, ``QuadraticProblem.cpp:37-42``)."""
    from .smallmat import cholesky_small

    k = blocks.shape[-1]
    return cholesky_small(
        blocks + shift * torch.eye(k, dtype=blocks.dtype,
                                   device=blocks.device))


def precond_apply(chol: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``V_pose (B_pose + shift I)^{-1}`` per pose (``chol [..., n, k, k]``,
    ``V [..., n, r, k]``)."""
    from .smallmat import cho_solve_small

    return cho_solve_small(chol, V.transpose(-1, -2)).transpose(-1, -2)
