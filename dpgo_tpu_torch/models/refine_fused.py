"""Single-readback certified refinement: the recenter and the gap oracle on
the device, in double-float32 — the PyTorch port of
``dpgo_tpu.models.refine_fused``.

The host path of ``models.refine`` hands the descent iterate to the host
for the float64 recenter (``refine.recenter``) and reads the refined point
back for a float64 verify every cycle.  This module keeps that work on the
card with ``ops.df32`` (double-float32, ~49 mantissa bits):

* ``_project_polar_df`` — the manifold projection (Newton-Schulz on the
  Gram matrix, unrolled d x d df32 products);
* ``recenter_device`` — the whole recenter: reference residuals, the
  Euclidean gradient through a global incidence (a pairwise df32 fold over
  each pose's slots; no scatter), ``S0``/``g0``, the reference cost
  ``f_ref``, the block-Jacobi factors and the kernel layouts of
  ``refine.RefineConstants`` — every field the host ``refine.recenter``
  builds;
* ``refine_until`` — accelerated re-centered rounds (kernel B4 on the card,
  ``refine.accel_round_carry``) stopped by an on-device gap oracle:
  f(R + D) = f_ref + delta(D), delta exact to float32 since the ambient
  cost is quadratic, checked every ``check_every`` rounds.

The JAX package stops ``refine_until`` in a ``lax.while_loop``.  Here a
loop that reads the host to stop would sync every chunk, so on the card
all ``ceil(max_rounds / check_every)`` chunks are enqueued and the carry,
``D`` and the round count freeze under the oracle's mask once it is met:
the same ``D`` and ``rounds`` as the early exit, at the price of the
rounds launched after it.  The one host round-trip left is the final
readback of ``pack_result``'s vector (through ``rbcd._host_fetch``),
followed by a host float64 verify (``refine.global_cost``), so a reported
gap never rests on device arithmetic alone.  A miss shows in that result;
the module has no fallback.

Precision budget (sphere2500 scale, f ~ 8e2, target gap 1e-6): ``f_ref``
df32 error ~1e-13 relative; ``delta``'s float32 error ~1e-7 |delta| with
|delta| <= 1e-3 f at the handoff, i.e. <= 1e-10 f; the oracle stops at
0.3x the requested gap, a ~3x margin the host verify then confirms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import AgentParams
from ..device import resolve_device
from ..ops import df32, quadratic
from ..ops.df32 import DF
from ..types import EdgeSet, edge_set_from_measurements
from . import rbcd
from .refine import RefineConstants, accel_round_carry, scatter_owned


class GlobalProblemDF(NamedTuple):
    """Global (one entry per measurement) edge data in df32 and its
    incidence, built once per problem on the host (``build_global_df``):
    E measurements, N poses, K = the largest pose degree."""

    i: torch.Tensor          # [E] int64 global endpoint i
    j: torch.Tensor          # [E] int64 global endpoint j
    Rm: DF                   # [E, d, d] measurement rotations
    tm: DF                   # [E, d]    measurement translations
    kap: DF                  # [E]
    tau: DF                  # [E]
    w: torch.Tensor          # [E] float32 weight * mask
    inc_slot: torch.Tensor   # [N, K] int64 into the [gi | gj] concatenation
    inc_mask: torch.Tensor   # [N, K] float32
    edges32: EdgeSet         # float32 global EdgeSet for the delta oracle


def build_global_df(meas_global, weights=None,
                    device="cuda") -> GlobalProblemDF:
    """Host build of the df32 global problem on ``device``: the float64
    measurement data split exactly into hi/lo pairs, and a numpy incidence
    pass over the E edges.  ``weights [M]`` folds per-measurement robust
    weights into ``w`` (the weights the refined solve ran under)."""
    dev = resolve_device(device)
    e64 = edge_set_from_measurements(meas_global, dtype=torch.float64,
                                     device="cpu")
    E = int(e64.i.shape[0])
    N = meas_global.num_poses
    i_np = e64.i.numpy()
    j_np = e64.j.numpy()

    inc: list[list[int]] = [[] for _ in range(N)]
    for e in range(E):
        inc[i_np[e]].append(e)
        inc[j_np[e]].append(E + e)
    K = max(1, max(len(s) for s in inc))
    inc_slot = np.zeros((N, K), np.int64)
    inc_mask = np.zeros((N, K), np.float32)
    for v in range(N):
        for c, slot in enumerate(inc[v]):
            inc_slot[v, c] = slot
            inc_mask[v, c] = 1.0

    w = e64.mask.numpy() * e64.weight.numpy()
    if weights is not None:
        w = w * np.asarray(weights, np.float64)

    edges32 = edge_set_from_measurements(meas_global, dtype=torch.float32,
                                         device=dev)
    edges32 = edges32._replace(
        weight=torch.as_tensor(w, dtype=torch.float32, device=dev),
        mask=torch.ones(E, dtype=torch.float32, device=dev))
    return GlobalProblemDF(
        i=torch.as_tensor(i_np, device=dev),
        j=torch.as_tensor(j_np, device=dev),
        Rm=df32.from_f64(e64.R.numpy(), dev),
        tm=df32.from_f64(e64.t.numpy(), dev),
        kap=df32.from_f64(e64.kappa.numpy(), dev),
        tau=df32.from_f64(e64.tau.numpy(), dev),
        w=torch.as_tensor(w, dtype=torch.float32, device=dev),
        inc_slot=torch.as_tensor(inc_slot, device=dev),
        inc_mask=torch.as_tensor(inc_mask, device=dev),
        edges32=edges32)


# ---------------------------------------------------------------------------
# df32 building blocks (unrolled over the small static dims r, d)
# ---------------------------------------------------------------------------

def _matvec_small(M: DF, v: DF) -> DF:
    """[..., m, k] @ [..., k] -> [..., m], unrolled over k."""
    k = M.hi.shape[-1]
    acc = None
    for t in range(k):
        term = df32.mul(DF(M.hi[..., :, t], M.lo[..., :, t]),
                        DF(v.hi[..., t, None], v.lo[..., t, None]))
        acc = term if acc is None else df32.add(acc, term)
    return acc


def _cat(parts: list[DF]) -> DF:
    """Concatenate df32 values along the last axis."""
    return DF(torch.cat([p.hi for p in parts], dim=-1),
              torch.cat([p.lo for p in parts], dim=-1))


def _project_polar_df(Xg: torch.Tensor, d: int, iters: int = 3) -> DF:
    """df32 manifold projection of a near-orthonormal float32 iterate.

    Per pose the polar factor of Y [r, d] is Y (Y^T Y)^{-1/2}; the descent
    retracts every round, so Y^T Y = I + O(f32 eps) and Newton-Schulz
    Z <- Z (3I - B Z^2) / 2 (B = Y^T Y, Z0 = I) converges quadratically: 3
    df32 iterations land at the df32 floor (~1e-13; the host's counterpart
    is the SVD of ``refine._np_project_manifold``)."""
    Y = df32.from_f32(Xg[..., :d])                           # [N, r, d]
    B = df32.matmul_small(df32.transpose(Y, (0, 2, 1)), Y)  # [N, d, d]
    eye = df32.from_f32(torch.eye(d, dtype=torch.float32, device=Xg.device)
                        .expand(B.hi.shape))
    Z = eye
    three_eye = df32.scale(eye, 3.0)
    for _ in range(iters):
        BZ2 = df32.matmul_small(B, df32.matmul_small(Z, Z))
        Z = df32.scale(df32.matmul_small(
            Z, df32.add(three_eye, df32.neg(BZ2))), 0.5)
    RY = df32.matmul_small(Y, Z)
    return _cat([RY, df32.from_f32(Xg[..., d:])])


def _edge_residuals_df(R: DF, gp: GlobalProblemDF, d: int):
    """Per-edge residuals at the df32 reference point:
    rR = Yj - Yi Rm [E, r, d], rt = pj - pi - Yi tm [E, r]."""
    Xi = df32.index(R, gp.i)          # [E, r, d+1]
    Xj = df32.index(R, gp.j)
    Yi = DF(Xi.hi[..., :d], Xi.lo[..., :d])
    Yj = DF(Xj.hi[..., :d], Xj.lo[..., :d])
    pi = DF(Xi.hi[..., d], Xi.lo[..., d])
    pj = DF(Xj.hi[..., d], Xj.lo[..., d])
    rR = df32.add(Yj, df32.neg(df32.matmul_small(Yi, gp.Rm)))
    rt = df32.add(pj, df32.neg(df32.add(pi, _matvec_small(Yi, gp.tm))))
    return rR, rt


def _sumsq_df(x: DF) -> DF:
    """Sum of squares over all trailing axes, per leading row."""
    hi = x.hi.reshape(x.hi.shape[0], -1)
    lo = x.lo.reshape(x.lo.shape[0], -1)
    return df32.fold_sum(df32.mul(DF(hi, lo), DF(hi, lo)), axis=-1)


def recenter_device(Xg: torch.Tensor, gp: GlobalProblemDF, graph, meta,
                    params: AgentParams, n_total: int):
    """The whole re-centering as device work in df32: the on-device
    equivalent of ``refine.recenter`` + ``refine.global_cost``.

    Returns ``(R, f_ref, consts, rho32)``: ``R: DF [N, r, d+1]`` the
    projected reference, ``f_ref: DF []`` the global cost at R, ``consts``
    the per-agent ``refine.RefineConstants`` (float32 hi parts — the
    truncation the host path applies when it ships them — with every
    kernel layout B4 reads), and ``rho32 = (rR, rt)`` the float32 global
    residuals of the delta oracle.  No host read."""
    d = meta.d
    r = meta.rank
    f32 = torch.float32

    R = _project_polar_df(Xg.to(f32), d)                 # [N, r, k] df32
    rR, rt = _edge_residuals_df(R, gp, d)                # [E, ...] df32

    # Per-edge gradient terms (the df32 mirror of
    # quadratic._edge_grad_terms, global layout).
    wk = df32.mul_f(gp.kap, gp.w)                        # [E]
    wt = df32.mul_f(gp.tau, gp.w)
    wkrR = df32.mul(DF(wk.hi[:, None, None], wk.lo[:, None, None]), rR)
    wtrt = df32.mul(DF(wt.hi[:, None], wt.lo[:, None]), rt)  # [E, r]
    wtrt3 = DF(wtrt.hi[..., None], wtrt.lo[..., None])
    gj = _cat([wkrR, wtrt3])
    giY = df32.add(
        df32.neg(df32.matmul_small(wkrR, df32.transpose(gp.Rm, (0, 2, 1)))),
        df32.neg(df32.mul(wtrt3, DF(gp.tm.hi[:, None, :],
                                    gp.tm.lo[:, None, :]))))
    gi = _cat([giY, df32.neg(wtrt3)])

    # The global Euclidean gradient: a gather-only incidence sum (pairwise
    # df32 fold over the K slots; a scatter cannot accumulate in df32).
    g_both = DF(torch.cat([gi.hi, gj.hi]), torch.cat([gi.lo, gj.lo]))
    contrib = df32.index(g_both, gp.inc_slot)            # [N, K, r, k]
    m = gp.inc_mask[:, :, None, None]
    contrib = DF(contrib.hi * m, contrib.lo * m)
    G = df32.fold_sum(df32.transpose(contrib, (0, 2, 3, 1)), axis=-1)

    # S0 = sym(R_Y^T G_Y), g0 = G - [R_Y S0 | 0].
    RY = DF(R.hi[..., :d], R.lo[..., :d])
    GY = DF(G.hi[..., :d], G.lo[..., :d])
    S0 = df32.sym(df32.matmul_small(df32.transpose(RY, (0, 2, 1)), GY))
    g0Y = df32.add(GY, df32.neg(df32.matmul_small(RY, S0)))
    g0 = _cat([g0Y, DF(G.hi[..., d:], G.lo[..., d:])])

    # f_ref = 0.5 sum_e w (kappa ||rR||^2 + tau ||rt||^2), df32 throughout.
    per_edge = df32.add(df32.mul(gp.kap, _sumsq_df(rR)),
                        df32.mul(gp.tau, _sumsq_df(rt)))
    per_edge = df32.mul_f(per_edge, gp.w)
    f_ref = df32.scale(df32.fold_sum(per_edge, axis=-1), 0.5)

    # ---- the per-agent layout: exact gathers of the hi parts.  R is
    # shipped unmasked (padded slots alias pose 0, as the host recenter's
    # plain gather leaves them; padded D rows stay zero); the gradient
    # constants are masked, as the host builds them into zeroed buffers.
    gi_idx = graph.global_index
    pm = graph.pose_mask.to(f32)[..., None, None]
    R_loc = R.hi[gi_idx]
    G_loc = G.hi[gi_idx] * pm
    g0_loc = g0.hi[gi_idx] * pm
    S0_loc = S0.hi[gi_idx] * pm
    Rz = rbcd.neighbor_buffer(rbcd.public_table(R_loc, graph), graph).to(f32)

    # Per-agent residual tiles from the global residuals (meas_id keeps each
    # measurement's orientation in every agent's copy).
    emask = graph.edges.mask.to(f32)
    rho_R32 = rR.hi[graph.meas_id] * emask[..., None, None]
    rho_t32 = rt.hi[graph.meas_id] * emask[..., None]

    chol = rbcd.precond_chol(graph.edges, graph, params).to(f32)
    A, nt, _, T = graph.eidx_i.shape
    E_a = graph.edges.kappa.shape[1]
    pad = nt * T - E_a
    k = d + 1

    def tile_cm(arr, rows):   # [A, E_a, ...] -> [A, nt, rows, T]
        flat = arr.reshape(A, E_a, rows).transpose(1, 2)
        flat = torch.nn.functional.pad(flat, (0, pad))
        return flat.reshape(A, rows, nt, T).transpose(1, 2)

    def wtile(vals):          # [A, E_a] -> [A, nt, 1, T]
        return torch.nn.functional.pad(vals, (0, pad)).reshape(A, nt, 1, T)

    def cm(arr):              # [A, n, r, k] -> [A, r*k, n]
        return arr.permute(0, 2, 3, 1).reshape(A, -1, meta.n_max)

    e = graph.edges
    w_a = e.mask * e.weight
    fields = dict(
        R=R_loc, Rz=Rz, G_ref=G_loc, g0=g0_loc, S0=S0_loc, chol=chol,
        rho_rot_t=tile_cm(rho_R32, r * d), rho_trn_t=tile_cm(rho_t32, r),
        Rc=cm(R_loc), wk_t=wtile((w_a * e.kappa).to(f32)),
        wt_t=wtile((w_a * e.tau).to(f32)), g0_c=cm(g0_loc),
        Gref_c=cm(G_loc),
        S0_c=S0_loc.permute(0, 2, 3, 1).reshape(A, d * d, meta.n_max),
        Lc=chol.permute(0, 2, 3, 1).reshape(A, k * k, meta.n_max),
        inc_mask_f=graph.inc_mask.to(f32))
    consts = RefineConstants(**{name: v.contiguous()
                                for name, v in fields.items()})
    return R, f_ref, consts, (rR.hi, rt.hi)


def _delta_global(D, graph, gp: GlobalProblemDF, rho32, n_total: int):
    """f(R + D) - f(R) on the global edge set, float32: the cross term
    against the reference residuals plus the exact quadratic term (the
    mirror of ``refine._delta_cost`` at global scope, so the oracle sees
    each measurement once)."""
    Dg = rbcd.gather_to_global(D.to(graph.pose_mask.dtype), graph,
                               n_total).to(torch.float32)
    e = gp.edges32
    LR, Lt = quadratic._edge_terms(Dg, e)
    rho_R, rho_t = rho32
    cross = e.kappa * torch.sum(rho_R * LR, dim=(-2, -1)) \
        + e.tau * torch.sum(rho_t * Lt, dim=-1)
    quad = e.kappa * torch.sum(LR * LR, dim=(-2, -1)) \
        + e.tau * torch.sum(Lt * Lt, dim=-1)
    return torch.sum(gp.w * (cross + 0.5 * quad))


def refine_until(D0, consts: RefineConstants, graph, meta,
                 params: AgentParams, gp: GlobalProblemDF, rho32,
                 thr: torch.Tensor, n_total: int, max_rounds: int,
                 check_every: int = 8):
    """Accelerated re-centered rounds until the on-device oracle says
    f_ref + delta(D) <= target (``thr = target - f_ref``, from df32).
    Returns ``(D, rounds_used, last_delta)``, as the JAX package's
    ``while_loop`` does.

    The momentum and its restart are ``refine.accel_round_carry``'s; the
    oracle runs after every ``check_every`` rounds.  All ``ceil(max_rounds
    / check_every)`` chunks are enqueued, and ``D``, the momentum carry and
    the round count are frozen under the oracle's mask once it is met: no
    host read, and the same ``D`` and ``rounds`` as JAX's early exit.  A
    cycle that starts at or below target (delta(0) = 0) reports 0 rounds."""
    carry = (D0, D0, torch.zeros((), dtype=D0.dtype, device=D0.device),
             torch.zeros((), dtype=torch.bool, device=D0.device))
    rounds = torch.zeros((), dtype=torch.int32, device=D0.device)
    done = torch.zeros((), dtype=torch.float32, device=D0.device) <= thr
    for _ in range(math.ceil(max_rounds / check_every)):
        new = carry
        for _ in range(check_every):
            new = accel_round_carry(new, consts, graph, meta, params)
        carry = tuple(torch.where(done, old, nxt)
                      for old, nxt in zip(carry, new))
        rounds = torch.where(done, rounds, rounds + check_every)
        done = done | (_delta_global(carry[0], graph, gp, rho32, n_total)
                       <= thr)
    D = carry[0]
    return D, rounds, _delta_global(D, graph, gp, rho32, n_total)


class FusedCycleResult(NamedTuple):
    R_hi: torch.Tensor      # [N, r, k] reference point, hi part
    R_lo: torch.Tensor      # [N, r, k] reference point, lo part
    D: torch.Tensor         # [A, n, r, k] refined correction
    f_ref_hi: torch.Tensor
    f_ref_lo: torch.Tensor
    delta: torch.Tensor     # last oracle delta (f(R + D) ~= f_ref + delta)
    rounds: torch.Tensor    # refine rounds used


def next_iterate(res: FusedCycleResult, graph, n_total: int) -> torch.Tensor:
    """The float32 global iterate R + D that chains a second fused cycle
    (its rounding moves the cost by O(eps^2 * curvature), far below the
    oracle's margin)."""
    Dg = rbcd.gather_to_global(res.D.to(graph.pose_mask.dtype), graph,
                               n_total).to(torch.float32)
    return res.R_hi + (res.R_lo + Dg)


def assemble_f64(res: FusedCycleResult, graph) -> np.ndarray:
    """Host: the exact float64 iterate R + D from a result (read back)."""
    Xg = np.asarray(res.R_hi, np.float64) + np.asarray(res.R_lo, np.float64)
    return scatter_owned(Xg, res.D, graph)


def pack_result(res: FusedCycleResult) -> torch.Tensor:
    """A cycle result as one float32 vector, so the final readback is a
    single transfer."""
    parts = [res.R_hi.reshape(-1), res.R_lo.reshape(-1), res.D.reshape(-1),
             res.f_ref_hi.reshape(1), res.f_ref_lo.reshape(1),
             res.delta.reshape(1).to(torch.float32),
             res.rounds.to(torch.float32).reshape(1)]
    return torch.cat(parts)


def unpack_result_host(flat, n_total: int, r: int, k: int,
                       d_shape) -> FusedCycleResult:
    """Host inverse of ``pack_result`` (``d_shape = (A, n, r, k)``), numpy
    fields."""
    flat = flat.numpy() if isinstance(flat, torch.Tensor) \
        else np.asarray(flat)
    nrk = n_total * r * k
    dsz = int(np.prod(d_shape))
    off = 0
    R_hi = flat[off:off + nrk].reshape(n_total, r, k)
    off += nrk
    R_lo = flat[off:off + nrk].reshape(n_total, r, k)
    off += nrk
    D = flat[off:off + dsz].reshape(d_shape)
    off += dsz
    f_ref_hi, f_ref_lo, delta, rounds = flat[off:off + 4]
    return FusedCycleResult(R_hi, R_lo, D, f_ref_hi, f_ref_lo, delta,
                            int(rounds))


class FusedFns(NamedTuple):
    """The pieces of the single-readback pipeline (the JAX package jits
    each; here they are plain functions whose work is enqueued on the
    device without a host read)."""

    recenter: object   # (Xg, gp, graph, target: DF) -> (R, f_ref, consts,
    #                     rho32, thr)
    refine: object     # (consts, graph, gp, rho32, thr) -> (D, rounds,
    #                     delta)
    nxt: object        # (res: FusedCycleResult, graph) -> Xg'
    pack: object       # (res: FusedCycleResult) -> flat float32 [L]


def make_fused_fns(meta, params: AgentParams, n_total: int,
                   max_rounds: int = 256, check_every: int = 8) -> FusedFns:
    """The pipeline's pieces for one problem and its settings."""
    def _recenter(Xg, gp, graph, target: DF):
        R, f_ref, consts, rho32 = recenter_device(Xg, gp, graph, meta,
                                                  params, n_total)
        thr = df32.add(target, df32.neg(f_ref)).hi
        return R, f_ref, consts, rho32, thr

    def _refine(consts, graph, gp, rho32, thr):
        D0 = torch.zeros(consts.R.shape, dtype=torch.float32,
                         device=consts.R.device)
        return refine_until(D0, consts, graph, meta, params, gp, rho32,
                            thr, n_total, max_rounds, check_every)

    return FusedFns(recenter=_recenter, refine=_refine,
                    nxt=lambda res, graph: next_iterate(res, graph, n_total),
                    pack=pack_result)


def run_fused_cycles(fns: FusedFns, Xg0, gp: GlobalProblemDF, graph,
                     target: DF, cycles: int = 2) -> FusedCycleResult:
    """Chain ``cycles`` recenter + refine cycles with no host round-trip:
    every call enqueues device work on device-resident values.  A cycle
    whose predecessor already met the target refines 0 rounds but still
    pays its recenter.  Returns the last cycle's result (read it back
    once, then ``assemble_f64`` + ``refine.global_cost`` for the float64
    verify)."""
    Xg = Xg0
    res = None
    for _ in range(cycles):
        R, f_ref, consts, rho32, thr = fns.recenter(Xg, gp, graph, target)
        D, rounds, delta = fns.refine(consts, graph, gp, rho32, thr)
        res = FusedCycleResult(R.hi, R.lo, D, f_ref.hi, f_ref.lo, delta,
                               rounds)
        Xg = fns.nxt(res, graph)
    return res
