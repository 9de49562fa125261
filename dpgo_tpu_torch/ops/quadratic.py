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

import numpy as np
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


def incidence(N: int, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded (ELL) incidence of terms ``idx [..., M]`` into rows
    ``[0, N)``: ``(slot [..., N, K], mask [..., N, K])``, row v's terms in
    ascending term order; terms at ``idx >= N`` belong to no row.  Built
    once per index set on the host (one copy of ``idx`` to the host), on
    ``idx``'s device.  A sum through it (``ell_sum``) has an order fixed by
    the indices, so it repeats bit for bit on every device and run, unlike
    ``index_add_``'s CUDA atomics."""
    x = idx.detach().cpu().numpy()
    lead, M = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, M)
    counts = np.stack([np.bincount(r[r < N], minlength=N) for r in flat])
    K = max(1, int(counts.max()))
    slot = np.zeros((len(flat), N, K), np.int64)
    mask = np.zeros((len(flat), N, K), bool)
    for b, r in enumerate(flat):
        terms = np.flatnonzero(r < N)
        terms = terms[np.argsort(r[terms], kind="stable")]
        rows = r[terms]
        col = np.arange(len(terms)) - (np.cumsum(counts[b]) - counts[b])[rows]
        slot[b, rows, col] = terms
        mask[b, rows, col] = True
    return (torch.as_tensor(slot.reshape(lead + (N, K)), device=idx.device),
            torch.as_tensor(mask.reshape(lead + (N, K)), device=idx.device))


def ell_sum(vals: torch.Tensor, slot: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Sum ``vals [..., M, *tail]`` into ``[..., N, *tail]`` through the
    incidence ``slot, mask [..., N, K]``: one gather and a masked sum
    along K."""
    lead = slot.shape[:-2]
    N, K = slot.shape[-2:]
    tail = vals.shape[len(lead) + 1:]
    terms = take(vals, slot.reshape(lead + (N * K,)).long())
    terms = terms.reshape(slot.shape + tail)
    return torch.sum(terms * mask.reshape(mask.shape + (1,) * len(tail)),
                     dim=len(lead) + 1)


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


def delta_cost(Dbuf: torch.Tensor, rhoR: torch.Tensor, rhot: torch.Tensor,
               edges: EdgeSet) -> torch.Tensor:
    """``f(R + D) - f(R)`` from the correction buffer ``Dbuf`` and the
    residuals ``(rhoR, rhot)`` at the reference R, without forming the
    large ``f(R)`` terms: the cross term plus half the quadratic term of
    the increment (exact, since the cost is quadratic)."""
    LR, Lt = _edge_terms(Dbuf, edges)
    w = edges.mask * edges.weight
    cross = edges.kappa * torch.sum(rhoR * LR, dim=(-2, -1)) \
        + edges.tau * torch.sum(rhot * Lt, dim=-1)
    quad = edges.kappa * torch.sum(LR * LR, dim=(-2, -1)) \
        + edges.tau * torch.sum(Lt * Lt, dim=-1)
    return torch.sum(w * (cross + 0.5 * quad), dim=-1)


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


def egrad_ell(Xbuf: torch.Tensor, edges: EdgeSet, inc_slot: torch.Tensor,
              inc_mask: torch.Tensor) -> torch.Tensor:
    """Euclidean gradient (the reference's ``X Q + G``,
    ``QuadraticProblem.cpp:62-66``) of the first n slots through the
    padded per-pose incidence list: ``inc_slot [..., n, K]`` indexes
    ``[gi | gj]`` (slot e for endpoint i of edge e, E + e for endpoint j,
    as ``incidence(n, cat([i, j]))`` lays it out); a gather and a masked
    sum, no scatter."""
    gi, gj = _edge_grad_terms(Xbuf, edges)
    return ell_sum(torch.cat([gi, gj], dim=-3), inc_slot, inc_mask)


def edge_incidence(edges: EdgeSet, n_out: int):
    """The ``[i-side | j-side]`` incidence of ``edges`` into rows
    ``[0, n_out)`` that ``egrad_ell``, ``egrad`` and ``diag_blocks`` sum
    through (one host copy of the indices; build it once per edge set)."""
    return incidence(n_out, torch.cat([edges.i, edges.j], dim=-1))


def egrad(Xbuf: torch.Tensor, edges: EdgeSet, n_out: int | None = None,
          inc=None) -> torch.Tensor:
    """Euclidean gradient d f / d Xbuf of the first ``n_out`` slots (all by
    default): the global edge-list map of the JAX package's ``egrad``,
    summed through the incidence ``inc`` (``edge_incidence(edges,
    n_out)``, built here when not given) — an order fixed by the indices,
    not ``index_add_``.  Linear in ``Xbuf``, so probes ride the r axis
    (``V [N, k, d+1]``)."""
    if inc is None:
        inc = edge_incidence(edges, Xbuf.shape[-3] if n_out is None
                             else n_out)
    return egrad_ell(Xbuf, edges, *inc)


def hessvec(Vlocal: torch.Tensor, edges: EdgeSet, n_buf: int,
            inc=None) -> torch.Tensor:
    """``(V Q)`` restricted to the local poses: ``Vlocal [n_local, r, k]``
    zero-padded to the buffer so neighbor poses act as constants
    (``inc`` as in ``egrad``, into ``n_local`` rows)."""
    return egrad(_pad_to(Vlocal, n_buf), edges, Vlocal.shape[-3], inc)


def _pad_to(V: torch.Tensor, n_buf: int) -> torch.Tensor:
    if V.shape[-3] == n_buf:
        return V
    pad = torch.zeros(V.shape[:-3] + (n_buf - V.shape[-3],) + V.shape[-2:],
                      dtype=V.dtype, device=V.device)
    return torch.cat([V, pad], dim=-3)


def hessvec_ell(Vlocal: torch.Tensor, edges: EdgeSet, inc_slot: torch.Tensor,
                inc_mask: torch.Tensor, n_buf: int) -> torch.Tensor:
    """Hessian-vector product on the ELL layout: the gradient map with the
    neighbor slots zeroed (neighbors are constants)."""
    return egrad_ell(_pad_to(Vlocal, n_buf), edges, inc_slot, inc_mask)


def _edge_blocks(edges: EdgeSet):
    """Per-edge (d+1)x(d+1) blocks of the connection Laplacian for edge
    (i -> j) with ``T = [[R, t], [0, 1]]`` and ``Omega = diag(wk I, wt)``:
    ``(T Omega T^T, T Omega, Omega)``, each [..., E, k, k]."""
    d = edges.t.shape[-1]
    w = edges.mask * edges.weight
    wk = w * edges.kappa
    wt = w * edges.tau
    t = edges.t
    eye = torch.eye(d, dtype=t.dtype, device=t.device)
    wtt = (wt[..., None] * t)[..., :, None]
    top = torch.cat([wk[..., None, None] * eye
                     + wt[..., None, None] * t[..., :, None] * t[..., None, :],
                     wtt], dim=-1)
    bottom = torch.cat([wt[..., None] * t, wt[..., None]], dim=-1)
    Bi = torch.cat([top, bottom[..., None, :]], dim=-2)
    TOm = torch.cat([torch.cat([wk[..., None, None] * edges.R, wtt], dim=-1),
                     torch.cat([torch.zeros_like(t), wt[..., None]],
                               dim=-1)[..., None, :]], dim=-2)
    diag_j = torch.cat([wk[..., None].expand(wk.shape + (d,)),
                        wt[..., None]], dim=-1)
    return Bi, TOm, torch.diag_embed(diag_j)


def diag_blocks(edges: EdgeSet, inc_slot: torch.Tensor,
                inc_mask: torch.Tensor) -> torch.Tensor:
    """Diagonal (d+1)x(d+1) blocks of the connection Laplacian at the rows
    of the incidence into ``[i-side | j-side]`` (``egrad_ell``'s): block i
    of edge (i -> j) gets ``[[wk I + wt t t^T, wt t], [wt t^T, wt]]``,
    block j gets ``diag(wk, ..., wk, wt)``."""
    Bi, _, Bj = _edge_blocks(edges)
    return ell_sum(torch.cat([Bi, Bj], dim=-3), inc_slot, inc_mask)


def dense_q_incidence(i: np.ndarray, j: np.ndarray, n_buf: int,
                      device=None):
    """The block incidence of ``dense_q`` from the edges' buffer indices
    ``i, j [..., E]`` (host arrays): every edge adds a term to the blocks
    (i, i), (i, j), (j, i) and (j, j) of Q; ``target [..., U]`` lists each
    batch element's distinct blocks (as row * n_buf + col, the rest at the
    spare block n_buf^2) and ``(slot, mask) [..., U, K]`` their terms in
    ascending order, the order ``ell_sum`` adds them in.  It depends on
    the topology only, so it is built once with the graph
    (``MultiAgentGraph.dense_inc``) and a GNC weight update rebuilds Q
    from it without reading the host."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    lead, E = i.shape[:-1], i.shape[-1]
    pair = np.concatenate([i * n_buf + i, i * n_buf + j, j * n_buf + i,
                           j * n_buf + j], axis=-1).reshape(-1, 4 * E)
    uniq = [np.unique(p, return_inverse=True) for p in pair]
    U = max(1, max(len(u) for u, _ in uniq))
    target = np.full((len(pair), U), n_buf * n_buf, np.int64)
    uid = np.zeros((len(pair), 4 * E), np.int64)
    for b, (u, inv) in enumerate(uniq):
        target[b, :len(u)] = u
        uid[b] = inv.reshape(-1)
    slot, mask = incidence(U, torch.as_tensor(uid.reshape(lead + (4 * E,))))
    return (torch.as_tensor(target.reshape(lead + (U,)), device=device),
            slot.to(device), mask.to(device))


def dense_q(edges: EdgeSet, n_buf: int, inc=None) -> torch.Tensor:
    """The connection Laplacian Q over the pose buffer, materialized:
    [..., (d+1) n_buf, (d+1) n_buf], pose-block-major — the matrix the
    reference assembles sparse (``constructConnectionLaplacianSE``,
    ``DPGO_utils.cpp:214-286``; shared edges ``PGOAgent.cpp:744-777``).
    Per edge (i -> j):

        Q[ii] += T Omega T^T   Q[ij] -= T Omega
        Q[ji] -= Omega T^T     Q[jj] += Omega

    The terms of each block (duplicate edges included) are summed through
    the incidence ``inc`` (``dense_q_incidence``; built here, with one
    copy of the indices to the host, when not given) in a fixed order,
    never by ``index_add_``, so Q repeats bit for bit on every device and
    run; the distinct blocks are then written once each."""
    if inc is None:
        inc = dense_q_incidence(edges.i.detach().cpu().numpy(),
                                edges.j.detach().cpu().numpy(), n_buf,
                                edges.i.device)
    target, slot, mask = inc
    Bi, TOm, Bj = _edge_blocks(edges)
    blocks = ell_sum(torch.cat([Bi, -TOm, -TOm.transpose(-1, -2), Bj],
                               dim=-3), slot, mask)
    lead, k = target.shape[:-1], Bi.shape[-1]
    B = math.prod(lead)
    nb2 = n_buf * n_buf + 1  # + the spare block of padded targets
    off = torch.arange(B, device=target.device).reshape(*lead, 1) * nb2
    Q = blocks.new_zeros((B * nb2, k, k))
    Q[(target + off).reshape(-1)] = blocks.reshape(-1, k, k)
    Q = Q.reshape(lead + (nb2, k, k))[..., :-1, :, :]
    Q = Q.reshape(lead + (n_buf, n_buf, k, k)).transpose(-3, -2)
    return Q.reshape(lead + (n_buf * k, n_buf * k))


def to_mat(X: torch.Tensor) -> torch.Tensor:
    """Pose blocks [..., n, r, d+1] -> the stacked matrix [..., r, (d+1) n]
    (the reference's trajectory layout, ``PGOAgent.h:222``)."""
    n, r, k = X.shape[-3:]
    return X.transpose(-3, -2).reshape(X.shape[:-3] + (r, n * k))


def from_mat(Xm: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``to_mat``: [..., r, (d+1) n] -> [..., n, r, d+1]."""
    r = Xm.shape[-2]
    k = Xm.shape[-1] // n
    return Xm.reshape(Xm.shape[:-2] + (r, n, k)).transpose(-3, -2)


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
