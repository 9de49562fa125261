"""The fused local RTR step of RBCD: the hand-written CUDA kernels
(``csrc/rtr_cluster.cu``, ``csrc/rtr_spread.cu``, ``csrc/rtr_grid.cu``,
``csrc/rtr_full.cu``) and their plain PyTorch versions.

Port of the TPU kernels ``dpgo_tpu/ops/pallas_tcg.py``:

* ``rtr_full`` replaces ``_rtr_full_kernel`` / ``rtr_full_call`` — one
  launch solves every agent's local problem for one RBCD round (start-point
  gradient, truncated CG, retraction, cost and the accept/shrink loop);
* ``rtr`` replaces ``_rtr_kernel`` / ``rtr_call`` — one launch is the
  attempt loop of ``rtr_full`` for every agent from a precomputed gradient
  ``g`` and curvature term ``S`` (no gradient sweep, no early exit): the
  kernel of the round-ablation timing (``experiments.measure_r3``);
* ``tcg`` replaces ``_tcg_kernel`` / ``tcg_call`` — the truncated CG alone;
* ``rtr_refine_full`` replaces ``_rtr_refine_full_kernel`` /
  ``rtr_refine_full_call`` — one launch is the re-centered step of the
  terminal refinement (``models.refine``) for every agent: the correction
  ``D`` about a float64 host reference ``Rc``.

Each wrapper runs the kernel for CUDA tensors and raises when it cannot; it
takes its plain version (``rtr_full_reference`` / ``rtr_reference`` /
``tcg_reference`` / ``rtr_refine_full_reference``) only when the tensors it
was given lie on the CPU.  The kernels are compiled with ``nvcc`` for
``sm_90a`` at first use, from every ``csrc/*.cu`` of this package (each
source as its ``BUILD_PARTS`` kernel parts and a dispatch part, one
``nvcc`` each, all at once), into one library in
``dpgo_tpu_torch/_build/``, and bound through ``ctypes``.  Every kernel
runs at d in {2, 3} and every r >= d (``csrc/shapes.cuh``): the ranks the
staircase reaches by default (r <= 10) are templated shapes, and one
rank-generic instantiation per d, which reads r from the launch, takes
every r >= 11.  The cluster route lays a pose over ceil(r / 32) warps of
one CTA of at most 512 threads, so it ends at ``MAX_LANE_RANK`` (r = 512, a
pose of 16 warps); above it the spread route folds a pose's rows over the
CTA's 16 warps (``pose_folds``: ceil(r / 512) rows a lane), as far as its
shared memory fits; the workspace route walks a pose's rows one at a time
and has no rank limit, so the plan always has a route.  A launcher refuses
any other shape and the wrapper raises.

The route is chosen from the shape before the launch by ``cluster_plan``:
the **cluster** route (``rtr_cluster.cu``: one thread-block cluster of C
CTAs per agent, its loop vectors and edge payload in the cluster's shared
memory) for every agent that fits a cluster, B2 and B4 at 11 <= r <= 32
with a pose's rows folded over an aligned segment of L = 8 or 16 lanes
(ceil(r / L) rows a lane) as ``fold_rule`` picks; above that ceiling, the
**spread** route (``rtr_spread.cu``: C CTAs per agent picked so that all
agents' CTAs cover the card's SMs in one wave, lane groups walking the
CTA's poses in stripes, the CG direction and z in shared memory, the other
loop vectors and the payload in a per-agent device-memory workspace);
where no spread fits, for B2 and B4 up to r = 512, the **grid** route
(``rtr_grid.cu``: the spread route's phases with every loop vector in the
workspace, C = sms // A CTAs per agent over the whole card in one
cooperative launch, one barrier and one set of reduction slots per agent in
its workspace); and for the rest (B1 and B3 where no spread fits, ranks
above 512 where no spread fits, more agents than SMs) the **workspace**
route (``rtr_full.cu``: one CTA per agent, loop vectors in a per-agent
workspace).  The four kernels share each route's shape.  A cluster the
card refuses or cannot place, or a grid it cannot keep resident, raises;
nothing retries another route.

Inputs use the JAX package's tile-major layout (``models.rbcd.build_graph``),
batched over agents with a leading ``A``:

* ``idx_i, idx_j [A, nt, 1, T]`` int32 endpoint indices into the
  ``[n + s]`` pose buffer (``n + s`` = padding), ``rot [A, nt, d*d, T]``,
  ``trn [A, nt, d, T]``, ``wk, wt [A, nt, 1, T]`` (weighted kappa / tau);
  the first ``e_max`` positions hold the agent's edge rows;
* poses component-major: ``Xc [A, r(d+1), n]``, ``Zc [A, r(d+1), s]``;
* ``Lc [A, (d+1)^2, n]`` the block-Jacobi Cholesky factors;
* ``rtr`` and ``tcg`` only: ``Sc [A, d*d, n]`` the curvature term
  ``sym(Y^T G_Y)`` (component ``b*d + c``) and ``gc [A, r(d+1), n]`` the
  Riemannian gradient;
* ``inc_slot, inc_mask [A, n, K]`` the ELL incidence into ``[gi | gj]``;
* ``n_local [A]`` int32: the agent's own pose count; padded poses past it
  are returned unchanged;
* refine only: ``rho_rot [A, nt, r*d, T]`` / ``rho_trn [A, nt, r, T]`` the
  edge residuals at the reference, ``Rc, Dc, g0c, Grefc [A, r(d+1), n]``,
  ``Dzc [A, r(d+1), s]`` and ``S0c [A, d*d, n]`` (``models.refine.
  RefineConstants``); ``wk, wt`` are the constants' weight tiles.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..types import EdgeSet
from . import manifold, quadratic
from .smallmat import polar_orthonormalize
from .solver import _sel, refine_attempts, truncated_cg

#: Launches of the ``rtr_full`` kernel (not of its plain version).
LAUNCHES = 0
#: Launches of the ``rtr`` kernel.
RTR_LAUNCHES = 0
#: Launches of the ``tcg`` kernel.
TCG_LAUNCHES = 0
#: Launches of the ``rtr_refine_full`` kernel.
REFINE_LAUNCHES = 0
#: Launches of the cluster route's folded-layout kernels, by (wrapper name,
#: lanes a pose): ``rtr_full_cluster_fold_kernel<L, d>`` and
#: ``rtr_refine_full_cluster_fold_kernel<L, d>`` (each also counts in its
#: wrapper's count above).
FOLD_LAUNCHES: collections.Counter = collections.Counter()

#: Newton-Schulz sweeps of the retraction (fixed in the kernel source).
NS_SWEEPS = 24
#: The launchers' own error code (others are ``cudaError_t`` values).
_UNSUPPORTED_SHAPE = -1

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
#: The headers the sources include; part of the build's hash.
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Kernel translation units per source for the templated (r, d): ``nvcc``
#: runs once for each, once more for the source's rank-generic part and once
#: for its dispatch part, all at once (``csrc/shapes.cuh`` deals the
#: instantiations to the parts).  ``rtr_full.cu``, whose templated kernels
#: hold r(d+1)-float rows a thread, takes the most compiling in all;
#: ``rtr_spread.cu``, four kernels at each shape, the longest parts;
#: ``rtr_grid.cu`` two kernels a shape, in parts of their own.
BUILD_PARTS = {"rtr_cluster.cu": 3, "rtr_full.cu": 8, "rtr_spread.cu": 5,
               "rtr_grid.cu": 3}
#: Parts a source compiles after its rank-generic part: ``rtr_cluster.cu``'s
#: folded layout of B2 and B4, one part per segment width (``FOLD_LANES``).
FOLD_PARTS = {"rtr_cluster.cu": 2}
#: The cluster launcher's own error codes: the card cannot place one
#: cluster of the size asked for; more neighbor slots than its edge payload
#: can index (2**20).  The grid launcher's: the card cannot keep all A C
#: CTAs resident at once; more poses in an agent than an ELL word can index.
_UNPLACEABLE, _TOO_MANY_SLOTS = -2, -3
_NOT_RESIDENT, _TOO_MANY_POSES = -5, -6
#: cudaErrorCooperativeLaunchTooLarge: the runtime's own refusal of a
#: cooperative launch that cannot be resident.
_COOPERATIVE_TOO_LARGE = 82

#: Cluster sizes the plan picks from.  Above 8 a size is non-portable: the
#: launcher allows it only where the card can place one such cluster.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: The plan spreads an agent over more CTAs until each has at most this
#: many warps: the kernel's time per tCG iteration is each warp's chain,
#: and warps that share an SM's four schedulers stretch it (PERF.md §6,
#: the cluster sweep).
SPREAD_WARPS = 8
#: Shared memory one CTA can use on sm_90.
MAX_SMEM_BYTES = 232448
#: Threads per CTA the cluster kernels are compiled for (r lanes per pose,
#: 32 // r poses per warp; above r = 32, ceil(r / 32) warps per pose).
MAX_CLUSTER_THREADS = 512
#: The highest rank of the cluster route: one pose of 16 warps, one row a
#: lane, fills a CTA of 512 threads (``pose_fits`` of ``csrc/lanes.cuh``;
#: its launchers refuse a higher rank).  The spread route folds the rows
#: above it (``FOLD_ROWS``).
MAX_LANE_RANK = 512
#: Rows of a pose on distinct lanes at most (``kFoldRows`` of
#: ``csrc/lanes.cuh``): above, a spread lane holds ``_pose_folds(r)`` rows.
FOLD_ROWS = 512
#: Shared floats per warp for the group sums of a pose that spans warps
#: (r > 32; ``kGroupSums`` of ``csrc/lanes.cuh``).
_GROUP_SUMS = 8
#: Loop vectors of the cluster kernels held in shared memory (delta twice)
#: — ``rtr_cluster.cu``; ``rtr_refine_full`` adds D and Rc.
_CLUSTER_VECS = 10
#: Threads per CTA of the spread kernels at most (``rtr_spread.cu``'s
#: kThreads): 128 registers a thread at one CTA per SM.
SPREAD_THREADS = 512
#: Loop vectors of the spread kernels held in shared memory: the CG
#: direction (twice) and z, which the Hessian sweep reads at the other
#: endpoints.
_SPREAD_SMEM_VECS = 3
#: The kernels with a spread route: all four.
SPREAD_KERNELS = ("rtr_full", "rtr", "tcg", "rtr_refine_full")
#: The kernels with a grid route (``rtr_grid.cu``): B2 and B4, where no
#: spread holds an agent; B1 and B3 keep the workspace route there.
GRID_KERNELS = ("rtr_full", "rtr_refine_full")
#: Poses of one agent the grid route indexes at most (an ELL word's 20
#: bits).
MAX_GRID_POSES = 1 << 20
#: Floats a reduction slot holds (``kMaxSums``).
_MAX_SUMS = 4
#: The cluster route's folded layout (``rtr_cluster.cu``'s fold section):
#: the kernels that have it, its segment widths L (lanes a pose, ceil(r /
#: L) rows a lane, 32 / L poses a warp) and its ranks.
FOLD_KERNELS = ("rtr_full", "rtr_refine_full")
FOLD_LANES = (8, 16)
FOLD_RANKS = range(11, 33)
#: SMs of an H100 SXM: what the plan assumes where it is not told the card's
#: own count (``sm_count``).
H100_SMS = 132
#: The kernels, by wrapper name, as the C launchers number them
#: (``Kernel`` in ``rtr_cluster.cu``).
KERNELS = {"rtr_full": 0, "rtr": 1, "tcg": 2, "rtr_refine_full": 3}


class RTRFullOut(NamedTuple):
    X: torch.Tensor          # [A, r(d+1), n] updated poses
    stats: torch.Tensor      # [A, 5] attempts, accepted, f0, f, gn0
    tcg_iters: torch.Tensor  # [A] int32 tCG iterations over all attempts


class RTROut(NamedTuple):
    X: torch.Tensor          # [A, r(d+1), n] updated poses
    stats: torch.Tensor      # [A, 4] attempts, accepted, f0, f
    tcg_iters: torch.Tensor  # [A] int32 tCG iterations over all attempts


class RTRRefineOut(NamedTuple):
    D: torch.Tensor          # [A, r(d+1), n] updated corrections
    stats: torch.Tensor      # [A, 5] attempts, accepted, df0, df, gn0
    tcg_iters: torch.Tensor  # [A] int32 tCG iterations over all attempts


class TCGOut(NamedTuple):
    eta: torch.Tensor    # [A, r(d+1), n]
    heta: torch.Tensor   # [A, r(d+1), n]
    stats: torch.Tensor  # [A, 2] iterations, hit boundary


class ClusterPlan(NamedTuple):
    route: str       # "cluster", "spread", "grid" or "workspace"
    C: int           # CTAs per agent (0 on the workspace route)
    P: int           # poses per CTA
    threads: int     # threads per CTA
    smem_bytes: int  # shared memory per CTA
    stripes: int = 1  # poses each lane group walks (spread, grid routes)
    folds: int = 1   # rows of a pose each lane holds (spread, folded cluster)
    lanes: int = 0   # lanes a pose on the folded cluster layout (0: r lanes)


# ---------------------------------------------------------------------------
# Route plan of rtr_full, rtr, tcg and rtr_refine_full
# ---------------------------------------------------------------------------

def _vec_stride(rk: int) -> int:
    """Floats per pose of a shared vector of the cluster kernels: ``rk``
    padded to whole float4s, and to an odd count of them."""
    s = -(-rk // 4)
    return 4 * (s if s % 2 else s + 1)


def _poses_per_warp(r: int) -> int:
    """Poses a warp holds on the cluster and spread routes: r lanes each up
    to r = 32, one pose (over several warps) above."""
    return 32 // r if r <= 32 else 1


def _pose_warps(r: int) -> int:
    """Warps one pose takes, one row a lane: 1 up to r = 32, ceil(r / 32)
    above."""
    return 1 if r <= 32 else -(-r // 32)


def _pose_folds(r: int) -> int:
    """Rows of a pose each lane holds on the spread route: 1 up to r =
    ``FOLD_ROWS``, ceil(r / ``FOLD_ROWS``) above."""
    return -(-r // FOLD_ROWS)


def _group_slots(r: int, warps: int) -> int:
    """Shared floats of the group-sum slots of a CTA of ``warps`` warps:
    only a pose that spans warps (r > 32) sums through them."""
    return warps * _GROUP_SUMS if r > 32 else 0


def _kernel_id(kernel: str) -> int:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}: one of {list(KERNELS)}")
    return KERNELS[kernel]


def cluster_shape(r: int, d: int, n_max: int, kinc: int, C: int,
                  kernel: str = "rtr_full") -> ClusterPlan:
    """The shape of cluster kernel ``kernel`` for ``C`` CTAs per agent (the
    formula of ``dpgo_rtr_cluster_smem_bytes``): P = ceil(n_max / C) poses
    in each CTA, r lanes per pose (one row of its block each) and 32 // r
    poses per warp (above r = 32, ceil(r / 32) whole warps per pose); its
    shared memory holds the loop vectors ``[P, vec_stride]``, the factors L
    and curvature S, the edge payload of its poses' ELL entries ``[fields,
    Kinc, P]``, the reduction slots (two buffers of 4 floats for each warp
    of the cluster) and, above r = 32, the group-sum slots (8 floats a
    warp).  ``rtr_full``,
    ``rtr`` and ``tcg`` share one shape: 10 vectors and ``d*d + d + 3``
    payload fields.  ``rtr_refine_full`` adds two vectors (the correction D
    and the reference Rc) and, in the payload, the edge's reference
    residuals ``rho_rot`` and ``rho_trn``: ``r (d + 1)`` fields, filled at
    the entries that own their edge's cost (``cost_owner``)."""
    refine = _kernel_id(kernel) == KERNELS["rtr_refine_full"]
    P = -(-n_max // C)
    k = d + 1
    threads = -(-P // _poses_per_warp(r)) * 32 * _pose_warps(r)
    vecs = _CLUSTER_VECS + (2 if refine else 0)
    fields = d * d + d + 3 + (r * k if refine else 0)
    floats = (vecs * P * _vec_stride(r * k) + (k * k + d * d) * P
              + fields * kinc * P + 2 * C * (threads // 32) * 4
              + _group_slots(r, threads // 32))
    return ClusterPlan("cluster", C, P, threads, 4 * floats)


def cluster_fold_shape(r: int, d: int, n_max: int, kinc: int, C: int,
                       lanes: int, kernel: str = "rtr_full") -> ClusterPlan:
    """The shape of B2 or B4 on the cluster route's folded layout (the
    formula of ``rtr_cluster.cu``'s ``fold_shape``): ``lanes`` L lanes a
    pose, row q on lane q % L at fold q / L (ceil(r / L) rows a lane), 32 //
    L poses a warp; the shared arrays of ``cluster_shape`` and no group-sum
    slots."""
    if _kernel_id(kernel) not in (KERNELS[k] for k in FOLD_KERNELS):
        raise ValueError(f"{kernel} has no folded cluster layout (only "
                         f"{', '.join(FOLD_KERNELS)})")
    refine = kernel == "rtr_refine_full"
    P = -(-n_max // C)
    k = d + 1
    threads = -(-P // (32 // lanes)) * 32
    vecs = _CLUSTER_VECS + (2 if refine else 0)
    fields = d * d + d + 3 + (r * k if refine else 0)
    floats = (vecs * P * _vec_stride(r * k) + (k * k + d * d) * P
              + fields * kinc * P + 2 * C * (threads // 32) * 4)
    return ClusterPlan("cluster", C, P, threads, 4 * floats, 1,
                       -(-r // lanes), lanes)


def _fits(plan: ClusterPlan) -> bool:
    """Whether one CTA of a cluster or spread plan fits the card: its
    threads (above ``MAX_LANE_RANK`` one pose of a cluster alone needs more)
    and its shared memory."""
    cap = SPREAD_THREADS if plan.route == "spread" else MAX_CLUSTER_THREADS
    return plan.threads <= cap and plan.smem_bytes <= MAX_SMEM_BYTES


def spread_shape(r: int, d: int, n_max: int, C: int) -> ClusterPlan:
    """The shape of the spread kernels for ``C`` CTAs per agent (the
    formula of ``rtr_spread.cu``'s ``spread_shape``; B1-B4 share it):
    P = ceil(n_max / C) poses in each CTA, r lanes per pose and 32 // r
    poses per warp (above r = 32, ceil(r / 32) whole warps per pose), at
    most ``SPREAD_THREADS`` threads of whole lane groups, so each lane group
    walks ceil(P / groups) poses (its stripes); shared memory holds the
    ``_SPREAD_SMEM_VECS`` vectors ``[P, vec_stride]``, the reduction slots
    (two buffers of 4 floats for each warp of the cluster) and, above r =
    32, the group-sum slots.  Above ``FOLD_ROWS`` a pose takes all 16
    warps and each lane ``folds`` = ceil(r / 512) of its rows: one pose a
    stripe, the shared vectors holding every fold."""
    P = -(-n_max // C)
    per_warp, W = _poses_per_warp(r), _pose_warps(min(r, FOLD_ROWS))
    threads = min(SPREAD_THREADS // 32 // W * W * 32,
                  -(-P // per_warp) * 32 * W)
    stripes = -(-P // (threads // 32 // W * per_warp))
    floats = (_SPREAD_SMEM_VECS * P * _vec_stride(r * (d + 1))
              + 2 * C * (threads // 32) * 4 + _group_slots(r, threads // 32))
    return ClusterPlan("spread", C, P, threads, 4 * floats, stripes,
                       _pose_folds(r))


def _spread_plan(n_max: int, r: int, d: int, agents: int,
                 sms: int) -> ClusterPlan | None:
    """The spread route's plan: C = sms // agents CTAs per agent (all
    agents' CTAs in one wave over the card's SMs), at least 1, raised until
    one CTA fits (``_fits``), at most the largest cluster; None when no C
    fits (the shared vectors of ceil(n_max / 16) poses exceed a CTA's)."""
    C = min(max(sms // max(agents, 1), 1), CLUSTER_SIZES[-1])
    for c in range(C, CLUSTER_SIZES[-1] + 1):
        plan = spread_shape(r, d, n_max, c)
        if _fits(plan):
            return plan
    return None


def grid_shape(r: int, d: int, n_max: int, C: int) -> ClusterPlan:
    """The shape of the grid kernels (``rtr_grid.cu``'s ``grid_shape``) for
    ``C`` CTAs per agent: the spread shape's P, threads and stripes, every
    loop vector in the workspace, so shared memory holds only the block
    sums (4 floats a warp) and, above r = 32, the group-sum slots."""
    sp = spread_shape(r, d, n_max, C)
    warps = sp.threads // 32
    return ClusterPlan("grid", C, sp.P, sp.threads,
                       4 * (warps * _MAX_SUMS + _group_slots(r, warps)),
                       sp.stripes)


def _grid_plan(n_max: int, r: int, d: int, kernel: str, agents: int,
               sms: int) -> ClusterPlan | None:
    """The grid route's plan for B2 and B4 (``GRID_KERNELS``): C = sms //
    agents CTAs per agent, one CTA an SM over the whole card; None for B1
    and B3, above ``MAX_LANE_RANK`` (the fold kernels have no grid form),
    when there are more agents than SMs or an agent has more than
    ``MAX_GRID_POSES`` poses."""
    if (kernel not in GRID_KERNELS or r > MAX_LANE_RANK or agents > sms
            or n_max > MAX_GRID_POSES):
        return None
    return grid_shape(r, d, n_max, sms // max(agents, 1))


def _quad(n: int) -> int:
    """``n`` floats rounded up to whole float4s."""
    return -(-n // 4) * 4


def grid_workspace_floats(r: int, d: int, n_max: int, e_max: int,
                          kinc: int, C: int, kernel: str = "rtr_full") -> int:
    """Floats of one agent's workspace on the grid route (the launcher's
    ``dpgo_rtr_grid_workspace_floats``, ``workspace_floats`` of
    ``spread_core.cuh`` at grid): every loop vector ``[C P][vec_stride]``
    (10; B4 adds D and Rc), the factor and curvature records, each CTA's
    edge records of its poses' live ELL entries, B4's reference residuals
    and the ints (counts, words, edge numbers, slots), rounded to whole
    float4s; then the reduction buffers ``[2][C][4]`` and the arrival
    counter (4 floats)."""
    refine = _kernel_id(kernel) == KERNELS["rtr_refine_full"]
    if kernel not in GRID_KERNELS:
        raise ValueError(f"{kernel} has no grid route")
    P = -(-n_max // C)
    vecs = 12 if refine else 10
    floats = (vecs * C * P * _vec_stride(r * (d + 1))
              + (_quad((d + 1) * (d + 2) // 2) + _quad(d * d)) * C * P
              + C * kinc * P * _quad(d * d + d + 2)
              + (e_max * r * (d + 1) if refine else 0)
              + C * P * (1 + 3 * kinc))
    return _quad(floats) + 2 * C * _MAX_SUMS + 4


#: The layout of B2 and B4 at ``FOLD_RANKS``: (lanes a pose, the largest
#: cluster size taken), tried in order, each where ``layout_plan`` finds a
#: cluster of it that fits; else the spread route.  The rule, from B2 and
#: B4 timed in turns on the card at the stand-ins' agents (NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md section 6): the folded layout at L =
#: 8 where a portable cluster (C <= 8) of it fits, else at L = 16, else
#: the spread route.  ms per launch, B2 / B4, at the chordal init:
#:
#:   (r, d)   r lanes      L = 8               L = 16       spread
#:   (11, 3)  0.161/0.157  0.145/0.146 (C 8)   0.157/0.153  0.192/0.200
#:   (12, 3)  0.158/0.161  0.138/0.148 (C 8)   0.152/0.155  0.189/0.207
#:   (16, 3)  0.172/0.165  0.141 (C 8)/0.190   0.162/0.156  0.198/0.212
#:   (17, 3)  no fit       0.186 (C 8)/0.250   0.218/0.216  0.322/0.322
#:   (32, 3)  no fit       0.316/no fit        0.227/no fit 0.377/0.381
#:   (11, 2)  0.385/0.383  0.238/0.245 (C 8)   0.383/0.372  0.257/0.305
#:   (32, 2)  no fit       0.415 (C 8)/0.734   0.553/0.588  0.515/0.661
#:
#: L = 8 at C = 16 (a CTA of 5-6 warps, 3-4 rows a lane) lost to L = 16
#: every time; the row-a-lane layout (r lanes a pose) lost to the folded
#: one at every shape where it fits, and fits only where L = 16 does, so
#: B2 and B4 never take it here (B1 and B3 keep it).
FOLD_RULE = ((8, 8), (16, 16))


def fold_rule(r: int) -> tuple:
    """The (lanes, largest C) B2 and B4 try at rank ``r`` (``FOLD_RULE``,
    measured at d = 3 and d = 2 alike), in order; empty outside
    ``FOLD_RANKS``."""
    return FOLD_RULE if r in FOLD_RANKS else ()


def _pick_cluster(plans) -> ClusterPlan | None:
    """Of one layout's cluster plans (one per C of ``CLUSTER_SIZES``) those
    that fit the card (``_fits``): of the portable sizes (up to 8), the
    smallest with at most ``SPREAD_WARPS`` warps per CTA, else the largest;
    16 only when no portable size fits; None when none fits."""
    fitting = [plan for plan in plans if _fits(plan)]
    if not fitting:
        return None
    portable = [plan for plan in fitting if plan.C <= 8] or fitting
    spread = [plan for plan in portable
              if plan.threads <= 32 * SPREAD_WARPS]
    return spread[0] if spread else portable[-1]


def layout_plan(lanes: int, n_max: int, kinc: int, r: int, d: int,
                kernel: str = "rtr_full") -> ClusterPlan | None:
    """The cluster plan of one layout (``_pick_cluster`` over the cluster
    sizes): ``lanes`` 0 the row-a-lane layout (``cluster_shape``: r lanes
    a pose), 8 or 16 the folded layout (``cluster_fold_shape``, B2 and B4);
    None when no cluster of it fits."""
    if lanes:
        return _pick_cluster(cluster_fold_shape(r, d, n_max, kinc, C, lanes,
                                                kernel)
                             for C in CLUSTER_SIZES)
    return _pick_cluster(cluster_shape(r, d, n_max, kinc, C, kernel)
                         for C in CLUSTER_SIZES)


def cluster_plan(n_max: int, e_max: int, kinc: int, r: int, d: int,
                 kernel: str = "rtr_full", agents: int = 1,
                 sms: int = H100_SMS) -> ClusterPlan:
    """The route of ``kernel`` (``rtr_full``, ``rtr``, ``tcg`` or
    ``rtr_refine_full``) for ``agents`` agents of ``n_max`` poses, ``e_max``
    edges and ``kinc`` incidence entries per pose on a card of ``sms`` SMs.
    B2 and B4 at ``FOLD_RANKS`` first try the folded layouts of
    ``fold_rule`` in order, each where ``layout_plan`` finds a cluster of
    it no larger than the rule's.  Otherwise the cluster route up to
    ``MAX_LANE_RANK`` when some C of ``CLUSTER_SIZES`` fits the card (at
    most ``MAX_CLUSTER_THREADS`` threads and ``MAX_SMEM_BYTES`` of shared
    memory per CTA, by ``cluster_shape`` of this kernel): of the portable
    sizes (up to 8) that fit, the smallest with at most ``SPREAD_WARPS``
    warps per CTA, else the largest; 16 only when no portable size fits.
    Else the spread route (``_spread_plan``; above ``FOLD_ROWS`` its rows
    folded) when it fits; else, for B2 and B4 up to ``MAX_LANE_RANK``, the
    grid route over the whole card (``_grid_plan``); else the workspace
    route (one CTA of 256 threads per agent; its shared memory holds the
    edge payload when that fits), which fits any shape and any rank: B1 and
    B3 where no spread fits, ranks above 512 where no spread fits, and more
    agents than SMs."""
    _kernel_id(kernel)
    if kernel in FOLD_KERNELS:
        for lanes, c_max in fold_rule(r):
            plan = layout_plan(lanes, n_max, kinc, r, d, kernel)
            if plan is not None and plan.C <= c_max:
                return plan
    return (layout_plan(0, n_max, kinc, r, d, kernel)
            or _spread_plan(n_max, r, d, agents, sms)
            or _grid_plan(n_max, r, d, kernel, agents, sms)
            or _workspace_plan(n_max, e_max, r, d, kernel))


def _workspace_plan(n_max: int, e_max: int, r: int, d: int,
                    kernel: str) -> ClusterPlan:
    """``rtr_full.cu``'s shape: reduction slots, plus the edge payload when
    it fits in shared memory (``payload_fits_smem``; ``rtr_refine_full``'s
    carries the reference residuals too)."""
    refine = _kernel_id(kernel) == KERNELS["rtr_refine_full"]
    red = 4 * 8 * 4
    payload = 4 * e_max * (d * d + d + 4 + (r * d + r if refine else 0))
    return ClusterPlan("workspace", 0, n_max, 256,
                       red + (payload if red + payload <= MAX_SMEM_BYTES
                              else 0))


def _route(cluster: int | None, n_max: int, e_max: int, kinc: int, r: int,
           d: int, kernel: str, spread: int | None = None, agents: int = 1,
           sms: int = H100_SMS, grid: int | None = None,
           lanes: int | None = None) -> ClusterPlan:
    """``cluster_plan``, or the route a test or ``chip_smoke.py`` forces:
    ``cluster`` ``0`` the workspace route, ``C > 0`` a cluster of C CTAs;
    ``spread`` ``C`` the spread route over C CTAs per agent; ``grid`` ``C``
    the grid route over C CTAs per agent (B2 and B4); ``lanes`` a cluster
    layout (``_fold_route``).  Raises when one CTA of a forced shape cannot
    fit the card (too much shared memory, or a cluster above
    ``MAX_LANE_RANK``: a pose of more than 16 warps), or when a forced grid
    cannot be resident (more than ``sms`` CTAs in all) or has no lane
    layout or kernel for the shape."""
    _kernel_id(kernel)
    if sum(x is not None for x in (cluster, spread, grid)) > 1:
        raise ValueError("force one route: a cluster, a spread or a grid")
    if lanes is not None:
        if spread is not None or grid is not None:
            raise ValueError("a cluster layout is forced with a cluster "
                             "size or alone, not with a spread or a grid")
        return _fold_route(lanes, cluster, n_max, kinc, r, d, kernel)
    if grid is not None:
        if kernel not in GRID_KERNELS:
            raise ValueError(f"{kernel} has no grid route (only "
                             f"{', '.join(GRID_KERNELS)})")
        if grid < 1 or agents * grid > sms:
            raise ValueError(
                f"a grid of {grid} CTAs per agent over {agents} agents "
                f"cannot be resident on a card of {sms} SMs (one CTA an "
                "SM)")
        if r > MAX_LANE_RANK or n_max > MAX_GRID_POSES:
            raise ValueError(
                f"the grid route holds agents of at most {MAX_GRID_POSES} "
                f"poses at r <= {MAX_LANE_RANK}, not {n_max} at r = {r}")
        return grid_shape(r, d, n_max, grid)
    if spread is not None:
        if spread < 1:
            raise ValueError(f"spread over {spread} CTAs")
        plan = spread_shape(r, d, n_max, spread)
        if not _fits(plan):
            raise ValueError(
                f"a spread over {spread} CTAs cannot hold an agent of "
                f"{n_max} poses at r = {r}: {plan.smem_bytes} B of shared "
                f"memory per CTA (at most {MAX_SMEM_BYTES})")
        return plan
    if cluster is None:
        return cluster_plan(n_max, e_max, kinc, r, d, kernel, agents, sms)
    if cluster == 0:
        return _workspace_plan(n_max, e_max, r, d, kernel)
    if cluster < 0:
        raise ValueError(f"cluster size {cluster} is negative")
    plan = cluster_shape(r, d, n_max, kinc, cluster, kernel)
    if not _fits(plan):
        raise ValueError(
            f"a cluster of {cluster} CTAs cannot hold an agent of {n_max} "
            f"poses at r = {r}: {plan.threads} threads and "
            f"{plan.smem_bytes} B of shared memory per CTA (at most "
            f"{MAX_CLUSTER_THREADS} and {MAX_SMEM_BYTES}; a pose takes "
            f"ceil(r / 32) warps, at most 16, so r <= {MAX_LANE_RANK})")
    return plan


def _fold_route(lanes: int, cluster: int | None, n_max: int, kinc: int,
                r: int, d: int, kernel: str) -> ClusterPlan:
    """The cluster layout ``lanes`` forced (0 the row-a-lane layout, r
    lanes a pose; 8 or 16 the folded layout, B2 and B4 at ``FOLD_RANKS``
    only) at ``cluster`` CTAs, or at ``layout_plan``'s C when ``cluster``
    is None; raises, naming the shape, where the layout has no kernel or
    one CTA cannot fit the card."""
    if lanes and (lanes not in FOLD_LANES or kernel not in FOLD_KERNELS
                  or r not in FOLD_RANKS):
        raise ValueError(
            f"no folded cluster layout of {lanes} lanes for {kernel} at "
            f"(r, d) = {(r, d)}: lanes in {FOLD_LANES}, kernels "
            f"{', '.join(FOLD_KERNELS)}, ranks {FOLD_RANKS.start}.."
            f"{FOLD_RANKS.stop - 1}")
    if cluster is None:
        plan = layout_plan(lanes, n_max, kinc, r, d, kernel)
        if plan is None:
            raise ValueError(
                f"no cluster of the {lanes or 'r'}-lane layout holds an "
                f"agent of {n_max} poses at (r, d) = {(r, d)} for {kernel}")
        return plan
    if cluster < 1:
        raise ValueError(f"a cluster layout needs a cluster size, not "
                         f"{cluster}")
    plan = (cluster_fold_shape(r, d, n_max, kinc, cluster, lanes, kernel)
            if lanes else cluster_shape(r, d, n_max, kinc, cluster, kernel))
    if not _fits(plan):
        raise ValueError(
            f"a cluster of {cluster} CTAs of the {lanes or 'r'}-lane layout "
            f"cannot hold an agent of {n_max} poses at (r, d) = {(r, d)} for "
            f"{kernel}: P = {plan.P}, {plan.threads} threads and "
            f"{plan.smem_bytes} B of shared memory per CTA (at most "
            f"{MAX_CLUSTER_THREADS} and {MAX_SMEM_BYTES})")
    return plan


def cost_owner(idx_i: torch.Tensor, inc_slot: torch.Tensor,
               inc_mask: torch.Tensor, n: int, e_max: int) -> torch.Tensor:
    """Which ELL entries count their edge in the cluster kernels' cost: the
    entry of incidence slot s at pose p counts when p is the edge's i
    endpoint (s < e_max), or its j endpoint while the i endpoint is a
    neighbor slot (index >= n).  Each live edge then counts exactly once,
    at a local endpoint.  ``idx_i [A, e_max]`` (the graph's ``edges.i``),
    ``inc_slot, inc_mask [A, n, K]``; returns a bool mask ``[A, n, K]``."""
    side_j = inc_slot >= e_max
    e = torch.where(side_j, inc_slot - e_max, inc_slot).long()
    A = e.shape[0]
    ii = torch.gather(idx_i.long(), 1, e.reshape(A, -1)).reshape(e.shape)
    return inc_mask.bool() & (~side_j | (ii >= n))


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def comp_major(X: torch.Tensor) -> torch.Tensor:
    """[..., n, r, k] pose blocks -> [..., r*k, n] component-major."""
    n, r, k = X.shape[-3:]
    return X.movedim(-3, -1).reshape(X.shape[:-3] + (r * k, n)).contiguous()


def comp_minor(Xc: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """[..., r*k, n] -> [..., n, r, k]."""
    n = Xc.shape[-1]
    return Xc.reshape(Xc.shape[:-2] + (r, k, n)).movedim(-1, -3)


def edge_tiles(w: torch.Tensor, nt: int, tile: int) -> torch.Tensor:
    """Pad per-edge rows [..., E] to the tile-major [..., nt, 1, T]."""
    E = w.shape[-1]
    wp = torch.nn.functional.pad(w, (0, nt * tile - E))
    return wp.reshape(w.shape[:-1] + (nt, 1, tile)).contiguous()


def _untile(t: torch.Tensor, e_max: int) -> torch.Tensor:
    """[A, nt, c, T] tiles -> [A, e_max, c] edge rows."""
    A, nt, c, T = t.shape
    return t.permute(0, 1, 3, 2).reshape(A, nt * T, c)[:, :e_max]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

class _Local(NamedTuple):
    edges: EdgeSet
    inc_slot: torch.Tensor
    inc_mask: torch.Tensor
    chol: torch.Tensor  # [A, n, k, k]
    n: int
    n_buf: int


def _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask, *,
           d: int, e_max: int, n: int, s: int, dtype) -> _Local:
    """The kernel's inputs as an edge list over the buffer
    ``[local (n) | neighbors (s) | one zero row]``: indices past the
    neighbor slots (padding, or every non-local index when ``s = 0``) land
    on the zero row and so contribute nothing, as in the kernel."""
    A = idx_i.shape[0]
    k = d + 1
    edges = EdgeSet(
        i=_untile(idx_i, e_max)[..., 0].long().clamp(max=n + s),
        j=_untile(idx_j, e_max)[..., 0].long().clamp(max=n + s),
        R=_untile(rot, e_max).reshape(A, e_max, d, d).to(dtype),
        t=_untile(trn, e_max).to(dtype),
        kappa=_untile(wk, e_max)[..., 0].to(dtype),
        tau=_untile(wt, e_max)[..., 0].to(dtype),
        weight=torch.ones((A, e_max), dtype=dtype, device=idx_i.device),
        mask=torch.ones((A, e_max), dtype=dtype, device=idx_i.device),
        is_lc=torch.zeros((A, e_max), dtype=dtype, device=idx_i.device),
        fixed_weight=torch.zeros((A, e_max), dtype=dtype,
                                 device=idx_i.device))
    chol = Lc.to(dtype).reshape(A, k, k, n).permute(0, 3, 1, 2)
    return _Local(edges, inc_slot.long(), inc_mask.to(dtype), chol, n,
                  n + s + 1)


def _buffer(V: torch.Tensor, Z: torch.Tensor | None, n_buf: int):
    parts = [V] if Z is None else [V, Z]
    used = sum(p.shape[-3] for p in parts)
    parts.append(torch.zeros(V.shape[:-3] + (n_buf - used,) + V.shape[-2:],
                             dtype=V.dtype, device=V.device))
    return torch.cat(parts, dim=-3)


def _rhess(loc: _Local, X, S, V):
    """P_X(EucHess[V] - [V_Y S | 0]) with neighbors held constant."""
    Hd = quadratic.egrad_ell(_buffer(V, None, loc.n_buf), loc.edges,
                             loc.inc_slot, loc.inc_mask)
    corr = manifold.join(V[..., :-1] @ S, torch.zeros_like(V[..., -1]))
    return manifold.tangent_project(X, Hd - corr)


def _precond(loc: _Local, X, V):
    return manifold.tangent_project(X, quadratic.precond_apply(loc.chol, V))


def tcg_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Sc, Lc, gc, radius,
                  inc_slot, inc_mask, *, r: int, d: int, e_max: int,
                  max_iters: int, kappa: float, theta: float) -> TCGOut:
    """Plain version of ``tcg``: Steihaug-Toint truncated CG at ``Xc`` from
    the curvature term ``Sc [A, d*d, n]`` and gradient ``gc``, per agent
    radius ``radius [A]``; computes in ``Xc.dtype``."""
    dtype = Xc.dtype
    k = d + 1
    A, _, n = Xc.shape
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=0, dtype=dtype)
    X = comp_minor(Xc, r, k)
    S = Sc.to(dtype).reshape(A, d, d, n).permute(0, 3, 1, 2)
    g = comp_minor(gc.to(dtype), r, k)
    res = truncated_cg(X, g, lambda V: _rhess(loc, X, S, V),
                       lambda V: _precond(loc, X, V), radius.to(dtype),
                       max_iters, kappa, theta)
    stats = torch.stack([res.iters.to(dtype), res.hit_boundary.to(dtype)],
                        dim=-1)
    return TCGOut(comp_major(res.eta), comp_major(res.heta), stats)


def _attempts(loc: _Local, X, Z, g, S, f0, k_att, n_local, *,
              max_iters: int, kappa: float, theta: float,
              initial_radius: float, max_rejections: int):
    """The attempt loop shared by ``rtr_full`` and ``rtr``: from ``k_att``
    attempts already spent, {tCG at the radius, 24-sweep Newton-Schulz
    retraction, cost; accept when rho > 0.1 and f did not rise, else
    radius / 4}, batched over agents (each agent's loop stops on its own).
    Returns (X, attempts, accepted, f, tCG iterations)."""
    A, n = X.shape[0], X.shape[-3]

    def cost(V):
        return quadratic.cost(_buffer(V, Z, loc.n_buf), loc.edges)

    live = (torch.arange(n, device=X.device)[None, :]
            < n_local.to(X.device)[:, None])
    radius = torch.full_like(f0, initial_radius)
    X_best, f_best = X, f0
    accepted = torch.zeros(A, dtype=torch.bool, device=X.device)
    iters = torch.zeros(A, dtype=torch.int32, device=X.device)
    while True:
        active = (k_att < max_rejections) & ~accepted
        if not bool(active.any()):
            break
        res = truncated_cg(X, g, lambda V: _rhess(loc, X, S, V),
                           lambda V: _precond(loc, X, V), radius, max_iters,
                           kappa, theta)
        M = X[..., :-1] + res.eta[..., :-1]
        X_prop = manifold.join(polar_orthonormalize(M, NS_SWEEPS),
                               X[..., -1] + res.eta[..., -1])
        X_prop = _sel(live, X_prop, X)
        f_prop = cost(X_prop)
        mdec = -(manifold.inner(g, res.eta)
                 + 0.5 * manifold.inner(res.eta, res.heta))
        rho = (f0 - f_prop) / torch.clamp(mdec, min=1e-30)
        ok = (rho > 0.1) & (f_prop <= f0) & active
        X_best = _sel(ok, X_prop, X_best)
        f_best = torch.where(ok, f_prop, f_best)
        radius = torch.where(active & ~ok, radius / 4.0, radius)
        k_att = torch.where(active, k_att + 1.0, k_att)
        iters = torch.where(active, iters + res.iters, iters)
        accepted = accepted | ok
    return X_best, k_att, accepted, f_best, iters


def rtr_full_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc, inc_slot,
                       inc_mask, n_local, *, r: int, d: int, e_max: int,
                       max_iters: int, kappa: float, theta: float,
                       initial_radius: float, max_rejections: int,
                       grad_tol: float) -> RTRFullOut:
    """Plain version of ``rtr_full``, computing in ``Xc.dtype``: the
    gradient, S and gn0 at ``X``, the early exit below ``grad_tol``, then
    the attempts of ``rtr_reference``."""
    dtype = Xc.dtype
    k = d + 1
    n = Xc.shape[-1]
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=Zc.shape[-1], dtype=dtype)
    X = comp_minor(Xc, r, k)
    Z = comp_minor(Zc.to(dtype), r, k)
    G = quadratic.egrad_ell(_buffer(X, Z, loc.n_buf), loc.edges,
                            loc.inc_slot, loc.inc_mask)
    S = manifold.sym(X[..., :-1].transpose(-1, -2) @ G[..., :-1])
    g = manifold.tangent_project(X, G)
    gn0 = manifold.norm(g)
    f0 = quadratic.cost(_buffer(X, Z, loc.n_buf), loc.edges)
    k_att = torch.where(gn0 < grad_tol, float(max_rejections), 0.0)
    X_out, k_att, accepted, f, iters = _attempts(
        loc, X, Z, g, S, f0, k_att, n_local, max_iters=max_iters,
        kappa=kappa, theta=theta, initial_radius=initial_radius,
        max_rejections=max_rejections)
    stats = torch.stack([k_att.to(dtype), accepted.to(dtype), f0, f, gn0],
                        dim=-1)
    return RTRFullOut(comp_major(X_out), stats, iters)


def rtr_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Sc, Lc, gc,
                  inc_slot, inc_mask, n_local, *, r: int, d: int, e_max: int,
                  max_iters: int, kappa: float, theta: float,
                  initial_radius: float, max_rejections: int) -> RTROut:
    """Plain version of ``rtr``, computing in ``Xc.dtype``: the attempts of
    ``rtr_full_reference`` from the given ``Sc`` and ``gc``, always (no
    early exit)."""
    dtype = Xc.dtype
    k = d + 1
    A, _, n = Xc.shape
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=Zc.shape[-1], dtype=dtype)
    X = comp_minor(Xc, r, k)
    Z = comp_minor(Zc.to(dtype), r, k)
    S = Sc.to(dtype).reshape(A, d, d, n).permute(0, 3, 1, 2)
    g = comp_minor(gc.to(dtype), r, k)
    f0 = quadratic.cost(_buffer(X, Z, loc.n_buf), loc.edges)
    X_out, k_att, accepted, f, iters = _attempts(
        loc, X, Z, g, S, f0, torch.zeros_like(f0), n_local,
        max_iters=max_iters, kappa=kappa, theta=theta,
        initial_radius=initial_radius, max_rejections=max_rejections)
    stats = torch.stack([k_att, accepted.to(dtype), f0, f], dim=-1)
    return RTROut(comp_major(X_out), stats, iters)


def rtr_refine_full_reference(idx_i, idx_j, rot, trn, wk, wt, rho_rot,
                              rho_trn, Rc, Dc, Dzc, g0c, Grefc, S0c, Lc,
                              inc_slot, inc_mask, n_local, *, r: int, d: int,
                              e_max: int, max_iters: int, kappa: float,
                              theta: float, initial_radius: float,
                              max_rejections: int,
                              grad_tol: float) -> RTRRefineOut:
    """Plain version of ``rtr_refine_full``, computing in ``Dc.dtype`` and
    batched over agents: the increment gradient at ``[D | Dz]``, the
    re-centered gradient and curvature term at ``Y = Rc + D``, the initial
    radius ``min(initial_radius, 10 |precond(g)|)``, and the attempts with
    the cost increment and the polar-correction retraction."""
    dtype = Dc.dtype
    k = d + 1
    A, _, n = Dc.shape
    s = Dzc.shape[-1]
    loc = _local(idx_i, idx_j, rot, trn, wk, wt, Lc, inc_slot, inc_mask,
                 d=d, e_max=e_max, n=n, s=s, dtype=dtype)

    def blocks(c):
        return comp_minor(c.to(dtype), r, k)

    D, Dz, R, g0, Gref = (blocks(c) for c in (Dc, Dzc, Rc, g0c, Grefc))
    S0 = S0c.to(dtype).reshape(A, d, d, n).permute(0, 3, 1, 2)
    rhoR = _untile(rho_rot, e_max).reshape(A, e_max, r, d).to(dtype)
    rhot = _untile(rho_trn, e_max).to(dtype)

    dG = quadratic.egrad_ell(_buffer(D, Dz, loc.n_buf), loc.edges,
                             loc.inc_slot, loc.inc_mask)
    Y = R + D
    S1 = manifold.sym(D[..., :-1].transpose(-1, -2) @ Gref[..., :-1]
                      + Y[..., :-1].transpose(-1, -2) @ dG[..., :-1])
    S = S0 + S1
    g = g0 + dG
    g = manifold.join(g[..., :-1] - R[..., :-1] @ S1 - D[..., :-1] @ S,
                      g[..., -1])
    radius0 = torch.clamp(10.0 * manifold.norm(_precond(loc, Y, g)),
                          max=initial_radius)
    live = (torch.arange(n, device=D.device)[None, :]
            < n_local.to(D.device)[:, None])

    def dcost(V):
        return quadratic.delta_cost(_buffer(V, Dz, loc.n_buf), rhoR, rhot,
                                    loc.edges)

    def retract(eta):
        return _sel(live, manifold.retract_correction(D, eta, R), D)

    out = refine_attempts(
        Y, D, g, radius0, lambda V: _rhess(loc, Y, S, V),
        lambda V: _precond(loc, Y, V), dcost, retract, max_iters=max_iters,
        kappa=kappa, theta=theta, max_rejections=max_rejections,
        grad_tol=grad_tol)
    stats = torch.stack([out.attempts, out.accepted.to(dtype), out.df0,
                         out.df, out.grad_norm], dim=-1)
    return RTRRefineOut(comp_major(out.D), stats, out.iters)


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------

_lib = None
BUILD_LOG = ""
#: Seconds from the start of the last build to the end of each of its
#: ``nvcc`` runs, by ``source:part``.
BUILD_SECONDS: dict = {}
#: Builds of this process that ran ``nvcc`` (a build that finds its
#: library in ``BUILD_DIR`` runs none).
NVCC_RUNS = 0
#: The C entry points ``load``/``bind`` declare: a library lacking one is
#: not this build's.
SYMBOLS = ("dpgo_rtr_workspace_floats", "dpgo_rtr_full_launch",
           "dpgo_rtr_launch", "dpgo_tcg_launch",
           "dpgo_rtr_refine_full_launch", "dpgo_rtr_cluster_smem_bytes",
           "dpgo_rtr_cluster_max_clusters", "dpgo_rtr_full_cluster_launch",
           "dpgo_rtr_cluster_launch", "dpgo_tcg_cluster_launch",
           "dpgo_rtr_refine_full_cluster_launch", "dpgo_rtr_spread_shape",
           "dpgo_rtr_spread_workspace_floats", "dpgo_rtr_spread_max_clusters",
           "dpgo_rtr_full_spread_launch", "dpgo_rtr_spread_launch",
           "dpgo_tcg_spread_launch", "dpgo_rtr_refine_full_spread_launch",
           "dpgo_rtr_grid_shape", "dpgo_rtr_grid_workspace_floats",
           "dpgo_rtr_grid_max_ctas", "dpgo_rtr_full_grid_launch",
           "dpgo_rtr_refine_full_grid_launch",
           "dpgo_rtr_cluster_fold_smem_bytes",
           "dpgo_rtr_cluster_fold_max_clusters",
           "dpgo_rtr_full_cluster_fold_launch",
           "dpgo_rtr_refine_full_cluster_fold_launch")
#: Serializes ``build`` and ``load``: the agents' optimization threads
#: (``agent.PGOAgent.start_optimization_loop``) may make the first launch
#: from several threads of one process at once.
_BUILD_LOCK = threading.RLock()
#: Serializes the launch counters' read-modify-write across those threads.
_COUNT_LOCK = threading.Lock()


def _unique_suffix() -> str:
    """A file-name tag no other build in flight shares: the process id and
    the thread id (threads of one process share the pid)."""
    return f"{os.getpid()}.{threading.get_ident()}"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (toolkit / "bin" / "nvcc").exists():
        nvcc = str(toolkit / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "csrc/*.cu at first use")
    return nvcc


def source_digest() -> str:
    """The library's source identity: sha256 over ``NVCC_FLAGS``,
    ``BUILD_PARTS``, ``FOLD_PARTS`` and every source and header (name and
    bytes)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                            + f" parts={sorted(BUILD_PARTS.items())}"
                            f" fold={sorted(FOLD_PARTS.items())}"
                            .encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return digest.hexdigest()


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str | None:
    """``nvcc --version``'s output, or None where there is no nvcc."""
    try:
        nvcc = _nvcc()
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def toolchain() -> dict:
    """What besides the sources makes the built library: ``nvcc
    --version``, torch and the CUDA version torch was built for."""
    return {"nvcc": nvcc_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def library_path() -> Path:
    """Where ``build`` puts the library: named by the sources and the
    toolchain, so a library another nvcc or torch built from the same
    sources is never taken for this one."""
    digest = hashlib.sha256(source_digest().encode())
    digest.update(json.dumps(toolchain(), sort_keys=True).encode())
    return BUILD_DIR / f"libdpgo_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (its ``BUILD_PARTS`` kernel parts, its
    rank-generic part and its dispatch part, one ``nvcc`` each, all started
    together) and
    link them into one shared library, unless this toolchain built these
    sources already; return the library's path.  Sets
    ``BUILD_LOG`` to nvcc's output (the ptxas register and spill report)
    and counts the build in ``NVCC_RUNS`` when nvcc ran.  One build at a
    time per process (``_BUILD_LOCK``); its object and temporary files are
    named per process and thread, and the library appears by an atomic
    rename, so concurrent processes never read a half-written file."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Path:
    global NVCC_RUNS
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    NVCC_RUNS += 1
    _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    """Run nvcc: every part of every source to an object (the dispatch part
    ``-1``, the source's kernel parts ``0 .. BUILD_PARTS[name] - 1``, its
    rank-generic part ``BUILD_PARTS[name]`` and its ``FOLD_PARTS[name]``
    parts after it), all at once, then the link to ``lib`` by an atomic
    rename."""
    global BUILD_LOG
    nvcc, tag_u = _nvcc(), _unique_suffix()
    tag = lib.stem.rsplit("_", 1)[-1]
    units = [(src, part) for src in SOURCES
             for part in range(-1, BUILD_PARTS[src.name] + 1
                               + FOLD_PARTS.get(src.name, 0))]
    objs = [BUILD_DIR / f"{src.stem}_{part + 1}_{tag}.{tag_u}.o"
            for src, part in units]
    logs = [o.with_suffix(".log") for o in objs]
    procs = []
    start = time.perf_counter()
    for (src, part), obj, log in zip(units, objs, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-DDPGO_PARTS={BUILD_PARTS[src.name]}",
                 f"-DDPGO_PART={part}", "-c", "-o", str(obj), str(src)],
                stdout=out, stderr=subprocess.STDOUT))
    BUILD_SECONDS.clear()
    pending = dict(zip(units, procs))
    while pending:
        for (src, part), proc in list(pending.items()):
            if proc.poll() is not None:
                BUILD_SECONDS[f"{src.name}:{part}"] = \
                    time.perf_counter() - start
                del pending[(src, part)]
        time.sleep(0.05)
    codes = [proc.returncode for proc in procs]
    BUILD_LOG = "".join(log.read_text() for log in logs)
    for log in logs:
        log.unlink()
    failed = [f"{src.name} (part {part})"
              for (src, part), code in zip(units, codes) if code != 0]
    if failed:
        raise RuntimeError(f"nvcc failed to build {', '.join(failed)}:\n"
                           f"{BUILD_LOG}")
    tmp = lib.with_name(lib.name + f".{tag_u}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    BUILD_LOG += proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib.name}:\n{BUILD_LOG}")
    os.replace(tmp, lib)


def load():
    """The bound kernel library; raises when there is no CUDA device or the
    build fails."""
    if _lib is not None:
        return _lib
    with _BUILD_LOCK:
        return _load()


def _load():
    if _lib is not None:
        return _lib
    _need_cuda()
    return _bind(build())


def bind(path):
    """Bind the kernel library at ``path`` (a copy of this build's library,
    as the serving plane's artifact tier keeps one) unless a library is
    bound already; returns the bound library.  Raises when there is no
    CUDA device."""
    with _BUILD_LOCK:
        if _lib is not None:
            return _lib
        _need_cuda()
        return _bind(path)


def bound() -> bool:
    """Whether this process has bound the kernel library."""
    return _lib is not None


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's kernels need a CUDA device and "
                           "none is available")


def _bind(path):
    global _lib
    lib = ctypes.CDLL(str(path))
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.dpgo_rtr_workspace_floats.argtypes = [I, I, I, I, I]
    lib.dpgo_rtr_workspace_floats.restype = LL
    lib.dpgo_rtr_full_launch.argtypes = (
        [I] * 9 + [P] * 16 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_launch.restype = I
    lib.dpgo_rtr_launch.argtypes = (
        [I] * 9 + [P] * 18 + [LL, I, F, F, F, I, P])
    lib.dpgo_rtr_launch.restype = I
    lib.dpgo_tcg_launch.argtypes = (
        [I] * 8 + [P] * 18 + [LL, I, F, F, P])
    lib.dpgo_tcg_launch.restype = I
    lib.dpgo_rtr_refine_full_launch.argtypes = (
        [I] * 9 + [P] * 22 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_refine_full_launch.restype = I
    lib.dpgo_rtr_cluster_smem_bytes.argtypes = [I] * 6
    lib.dpgo_rtr_cluster_smem_bytes.restype = LL
    lib.dpgo_rtr_cluster_max_clusters.argtypes = [I] * 6 + [P]
    lib.dpgo_rtr_cluster_max_clusters.restype = I
    lib.dpgo_rtr_full_cluster_launch.argtypes = (
        [I] * 10 + [P] * 15 + [I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_cluster_launch.restype = I
    lib.dpgo_rtr_cluster_launch.argtypes = (
        [I] * 10 + [P] * 17 + [I, F, F, F, I, P])
    lib.dpgo_rtr_cluster_launch.restype = I
    lib.dpgo_tcg_cluster_launch.argtypes = (
        [I] * 9 + [P] * 17 + [I, F, F, P])
    lib.dpgo_tcg_cluster_launch.restype = I
    lib.dpgo_rtr_refine_full_cluster_launch.argtypes = (
        [I] * 10 + [P] * 21 + [I, F, F, F, I, F, P])
    lib.dpgo_rtr_refine_full_cluster_launch.restype = I
    lib.dpgo_rtr_spread_shape.argtypes = [I] * 5 + [P]
    lib.dpgo_rtr_spread_shape.restype = LL
    lib.dpgo_rtr_spread_workspace_floats.argtypes = [I] * 7
    lib.dpgo_rtr_spread_workspace_floats.restype = LL
    lib.dpgo_rtr_spread_max_clusters.argtypes = [I] * 5 + [P]
    lib.dpgo_rtr_spread_max_clusters.restype = I
    lib.dpgo_rtr_full_spread_launch.argtypes = (
        [I] * 10 + [P] * 16 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_spread_launch.restype = I
    lib.dpgo_rtr_spread_launch.argtypes = (
        [I] * 10 + [P] * 18 + [LL, I, F, F, F, I, P])
    lib.dpgo_rtr_spread_launch.restype = I
    lib.dpgo_tcg_spread_launch.argtypes = (
        [I] * 9 + [P] * 18 + [LL, I, F, F, P])
    lib.dpgo_tcg_spread_launch.restype = I
    lib.dpgo_rtr_refine_full_spread_launch.argtypes = (
        [I] * 10 + [P] * 22 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_refine_full_spread_launch.restype = I
    lib.dpgo_rtr_grid_shape.argtypes = [I] * 4 + [P]
    lib.dpgo_rtr_grid_shape.restype = LL
    lib.dpgo_rtr_grid_workspace_floats.argtypes = [I] * 7
    lib.dpgo_rtr_grid_workspace_floats.restype = LL
    lib.dpgo_rtr_grid_max_ctas.argtypes = [I] * 5 + [P]
    lib.dpgo_rtr_grid_max_ctas.restype = I
    lib.dpgo_rtr_full_grid_launch.argtypes = (
        [I] * 10 + [P] * 16 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_grid_launch.restype = I
    lib.dpgo_rtr_refine_full_grid_launch.argtypes = (
        [I] * 10 + [P] * 22 + [LL, I, F, F, F, I, F, P])
    lib.dpgo_rtr_refine_full_grid_launch.restype = I
    lib.dpgo_rtr_cluster_fold_smem_bytes.argtypes = [I] * 7
    lib.dpgo_rtr_cluster_fold_smem_bytes.restype = LL
    lib.dpgo_rtr_cluster_fold_max_clusters.argtypes = [I] * 7 + [P]
    lib.dpgo_rtr_cluster_fold_max_clusters.restype = I
    lib.dpgo_rtr_full_cluster_fold_launch.argtypes = (
        [I] * 11 + [P] * 15 + [I, F, F, F, I, F, P])
    lib.dpgo_rtr_full_cluster_fold_launch.restype = I
    lib.dpgo_rtr_refine_full_cluster_fold_launch.argtypes = (
        [I] * 11 + [P] * 21 + [I, F, F, F, I, F, P])
    lib.dpgo_rtr_refine_full_cluster_fold_launch.restype = I
    _lib = lib
    return lib


def cluster_capacity(r: int, d: int, n_max: int, kinc: int, C: int,
                     kernel: str = "rtr_full", lanes: int = 0) -> int:
    """How many clusters of ``C`` CTAs of cluster kernel ``kernel`` (at
    ``lanes`` > 0 on the folded layout) the card can hold at once for
    agents of this shape (``cudaOccupancyMaxActiveClusters``); 0 when it
    cannot place one."""
    count = ctypes.c_int(0)
    if lanes:
        err = load().dpgo_rtr_cluster_fold_max_clusters(
            lanes, r, d, n_max, kinc, C, _kernel_id(kernel),
            ctypes.byref(count))
    else:
        err = load().dpgo_rtr_cluster_max_clusters(r, d, n_max, kinc, C,
                                                   _kernel_id(kernel),
                                                   ctypes.byref(count))
    _raise_on("cluster_capacity", err, r, d)
    return count.value


def spread_capacity(r: int, d: int, n_max: int, C: int,
                    kernel: str = "rtr_full") -> int:
    """How many clusters of ``C`` CTAs of spread kernel ``kernel`` the card
    can hold at once for agents of ``n_max`` poses
    (``cudaOccupancyMaxActiveClusters``); 0 when it cannot place one."""
    count = ctypes.c_int(0)
    err = load().dpgo_rtr_spread_max_clusters(r, d, n_max, C,
                                              _kernel_id(kernel),
                                              ctypes.byref(count))
    _raise_on("spread_capacity", err, r, d)
    return count.value


def grid_capacity(r: int, d: int, n_max: int, C: int,
                  kernel: str = "rtr_full") -> int:
    """How many CTAs of grid kernel ``kernel`` (C per agent, ``n_max``
    poses an agent) the card keeps resident at once (blocks per SM times
    SMs): a cooperative launch of more is refused."""
    count = ctypes.c_int(0)
    err = load().dpgo_rtr_grid_max_ctas(r, d, n_max, C, _kernel_id(kernel),
                                        ctypes.byref(count))
    _raise_on("grid_capacity", err, r, d)
    return count.value


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The SMs of ``dev``'s card, which the spread route's plan covers;
    ``H100_SMS`` for a device that is not CUDA."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return H100_SMS
    return _card_sms(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def _plan(dev, cluster: int | None, n_max: int, e_max: int, kinc: int,
          r: int, d: int, kernel: str, spread: int | None = None,
          agents: int = 1, grid: int | None = None,
          lanes: int | None = None) -> ClusterPlan | None:
    """The route a wrapper launches on a CUDA ``dev`` (``_route`` on its
    card's SMs).  On the CPU the plain version runs at any rank: there only
    a forced route is planned, so that a shape the card cannot hold raises
    there as well, and None is returned otherwise."""
    if dev.type == "cpu" and cluster is None and spread is None \
            and grid is None and lanes is None:
        return None
    return _route(cluster, n_max, e_max, kinc, r, d, kernel, spread, agents,
                  sm_count(dev), grid, lanes)


def _check(name: str, dev, tensors: dict, shapes: dict) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    the kernel's launcher checks the shape (r, d) itself."""
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{dev} like the poses")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = shapes[key]
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    for key in ("idx_i", "idx_j", "inc_slot", "n_local"):
        if key in tensors and tensors[key].dtype != torch.int32:
            raise ValueError(f"{name}: {key} must be int32")
    if dev.type != "cpu":
        for key, t in tensors.items():
            if t.is_floating_point() and t.dtype != torch.float32:
                raise ValueError(f"{name}: the kernel is float32-only; "
                                 f"{key} is {t.dtype}")
        if dev.type != "cuda":
            raise RuntimeError(f"{name}: tensors on {dev}; the kernel runs "
                               "on CUDA devices and the plain version on "
                               "the CPU")


def _raise_on(name: str, err: int, r: int, d: int, C: int = 0,
              shape: str = "") -> None:
    """Turn a launcher's non-zero return into an exception (``shape``
    describes a grid launch)."""
    if err == _UNSUPPORTED_SHAPE:
        raise ValueError(f"{name}: (r, d) = {(r, d)} is not a shape this "
                         "route takes (csrc/shapes.cuh: d in {2, 3} and "
                         "r >= d; the cluster route ends at "
                         f"r = {MAX_LANE_RANK}, a pose of 16 warps)")
    if err == _UNPLACEABLE:
        raise RuntimeError(f"{name}: the card cannot place a cluster of "
                           f"{C} CTAs of this shape"
                           + (f" ({shape})" if shape else ""))
    if err == _TOO_MANY_SLOTS:
        raise ValueError(f"{name}: more than 2**20 neighbor slots per agent "
                         "on the cluster, spread and grid routes")
    if err in (_NOT_RESIDENT, _COOPERATIVE_TOO_LARGE):
        raise RuntimeError(f"{name}: the card cannot keep every CTA of the "
                           f"grid route resident at once ({shape}); the "
                           "cooperative launch is refused")
    if err == _TOO_MANY_POSES:
        raise ValueError(f"{name}: more than 2**20 poses per agent on the "
                         f"grid route ({shape})")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t "
                           f"{err})")


def _grid_shape_note(plan: ClusterPlan, A: int, r: int, d: int,
                     n: int) -> str:
    """The launch's shape, for a refused grid or cluster launch's error."""
    layout = f", {plan.lanes} lanes a pose" if plan.lanes else ""
    return (f"{A} agents x {plan.C} CTAs of {plan.threads} threads, "
            f"{plan.smem_bytes} B of shared memory{layout}, "
            f"{n} poses an agent at (r, d) = {(r, d)}")


def _shapes(idx_i, r, d, n, s, K, A):
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    rk, k = r * (d + 1), d + 1
    return dict(idx_i=(A, nt, 1, T), idx_j=(A, nt, 1, T),
                rot=(A, nt, d * d, T), trn=(A, nt, d, T),
                wk=(A, nt, 1, T), wt=(A, nt, 1, T),
                Xc=(A, rk, n), Zc=(A, rk, s), Lc=(A, k * k, n),
                Sc=(A, d * d, n), gc=(A, rk, n), radius=(A,),
                inc_slot=(A, n, K), inc_mask=(A, n, K), n_local=(A,),
                rho_rot=(A, nt, r * d, T), rho_trn=(A, nt, r, T),
                Rc=(A, rk, n), Dc=(A, rk, n), Dzc=(A, rk, s),
                g0c=(A, rk, n), Grefc=(A, rk, n), S0c=(A, d * d, n))


def rtr_full(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc, inc_slot, inc_mask,
             n_local, *, r: int, d: int, e_max: int, max_iters: int,
             kappa: float, theta: float, initial_radius: float,
             max_rejections: int, grad_tol: float,
             _cluster: int | None = None,
             _spread: int | None = None,
             _grid: int | None = None,
             _lanes: int | None = None) -> RTRFullOut:
    """One local RTR step for every agent (see the module docstring for the
    layouts).  CUDA tensors launch the kernel of the route ``cluster_plan``
    picks on the current stream, once for all agents; CPU tensors run
    ``rtr_full_reference``.  ``_cluster``, ``_spread`` and ``_grid`` force
    a route, for the card tests and ``chip_smoke.py`` only: ``_cluster=0``
    the workspace route, ``_cluster=C`` a cluster of C CTAs, ``_spread=C``
    the spread route over C CTAs per agent, ``_grid=C`` the grid route over
    C CTAs per agent (one cooperative launch of A C CTAs, which raises when
    the card cannot keep them all resident); ``_lanes`` a cluster layout
    (0 the row-a-lane layout, r lanes a pose; 8 or 16 the folded layout,
    ``FOLD_RANKS`` only), at ``_cluster`` CTAs or at the layout's own
    cluster size."""
    global LAUNCHES
    A, _, n = Xc.shape
    s, K = Zc.shape[-1], inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   Xc=Xc, Zc=Zc, Lc=Lc, inc_slot=inc_slot,
                   inc_mask=inc_mask, n_local=n_local)
    _check("rtr_full", Xc.device, tensors, _shapes(idx_i, r, d, n, s, K, A))
    plan = _plan(Xc.device, _cluster, n, e_max, K, r, d, "rtr_full",
                 _spread, A, _grid, _lanes)
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta, initial_radius=initial_radius,
              max_rejections=max_rejections, grad_tol=grad_tol)
    if Xc.device.type == "cpu":
        return rtr_full_reference(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Lc,
                                  inc_slot, inc_mask, n_local, **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Xc.device
    X_out = torch.empty_like(Xc)
    stats = torch.empty((A, 5), dtype=torch.float32, device=dev)
    iters = torch.empty((A,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (idx_i, idx_j, rot, trn, wk, wt, Xc, Zc,
                                   Lc, inc_slot, inc_mask, n_local, X_out,
                                   stats, iters)]
    if plan.route == "cluster" and plan.lanes:
        err = lib.dpgo_rtr_full_cluster_fold_launch(
            plan.lanes, r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs,
            max_iters, kappa, theta, initial_radius, max_rejections,
            grad_tol, stream)
    elif plan.route == "cluster":
        err = lib.dpgo_rtr_full_cluster_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, max_iters,
            kappa, theta, initial_radius, max_rejections, grad_tol, stream)
    elif plan.route == "spread":
        ws_floats = lib.dpgo_rtr_spread_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["rtr_full"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_full_spread_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    elif plan.route == "grid":
        ws_floats = lib.dpgo_rtr_grid_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["rtr_full"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_full_grid_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    else:
        ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max, 0)
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_full_launch(
            r, d, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    if err:
        _raise_on("rtr_full", err, r, d, plan.C,
                  _grid_shape_note(plan, A, r, d, n))
    with _COUNT_LOCK:
        LAUNCHES += 1
        if plan.lanes:
            FOLD_LAUNCHES["rtr_full", plan.lanes] += 1
    return RTRFullOut(X_out, stats, iters)


def rtr(idx_i, idx_j, rot, trn, wk, wt, Xc, Zc, Sc, Lc, gc, inc_slot,
        inc_mask, n_local, *, r: int, d: int, e_max: int, max_iters: int,
        kappa: float, theta: float, initial_radius: float,
        max_rejections: int, _cluster: int | None = None,
        _spread: int | None = None) -> RTROut:
    """The attempt loop for every agent from the given ``Sc`` and ``gc``
    (see the module docstring for the layouts).  CUDA tensors launch the
    kernel of the route ``cluster_plan`` picks on the current stream, once
    for all agents; CPU tensors run ``rtr_reference``.  ``_cluster`` and
    ``_spread`` as in ``rtr_full``."""
    global RTR_LAUNCHES
    A, _, n = Xc.shape
    s, K = Zc.shape[-1], inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   Xc=Xc, Zc=Zc, Sc=Sc, Lc=Lc, gc=gc, inc_slot=inc_slot,
                   inc_mask=inc_mask, n_local=n_local)
    _check("rtr", Xc.device, tensors, _shapes(idx_i, r, d, n, s, K, A))
    plan = _plan(Xc.device, _cluster, n, e_max, K, r, d, "rtr", _spread, A)
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta, initial_radius=initial_radius,
              max_rejections=max_rejections)
    if Xc.device.type == "cpu":
        return rtr_reference(*tensors.values(), **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Xc.device
    X_out = torch.empty_like(Xc)
    stats = torch.empty((A, 4), dtype=torch.float32, device=dev)
    iters = torch.empty((A,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*tensors.values(), X_out, stats, iters)]
    if plan.route == "cluster":
        err = lib.dpgo_rtr_cluster_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, max_iters,
            kappa, theta, initial_radius, max_rejections, stream)
    elif plan.route == "spread":
        ws_floats = lib.dpgo_rtr_spread_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["rtr"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_spread_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, stream)
    else:
        ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max, 0)
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_launch(
            r, d, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, stream)
    _raise_on("rtr", err, r, d, plan.C)
    with _COUNT_LOCK:
        RTR_LAUNCHES += 1
    return RTROut(X_out, stats, iters)


def tcg(idx_i, idx_j, rot, trn, wk, wt, Xc, Sc, Lc, gc, radius, inc_slot,
        inc_mask, *, r: int, d: int, e_max: int, max_iters: int,
        kappa: float, theta: float, _cluster: int | None = None,
        _spread: int | None = None) -> TCGOut:
    """Truncated CG for every agent from ``Sc`` and ``gc`` at per-agent
    ``radius [A]``, every pose live.  CUDA tensors launch the kernel of the
    route ``cluster_plan`` picks on the current stream, once for all
    agents; CPU tensors run ``tcg_reference``.  ``_cluster`` and
    ``_spread`` as in ``rtr_full``."""
    global TCG_LAUNCHES
    A, _, n = Xc.shape
    K = inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   Xc=Xc, Sc=Sc, Lc=Lc, gc=gc, radius=radius,
                   inc_slot=inc_slot, inc_mask=inc_mask)
    _check("tcg", Xc.device, tensors, _shapes(idx_i, r, d, n, 0, K, A))
    plan = _plan(Xc.device, _cluster, n, e_max, K, r, d, "tcg", _spread, A)
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta)
    if Xc.device.type == "cpu":
        return tcg_reference(*tensors.values(), **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Xc.device
    n_local = torch.full((A,), n, dtype=torch.int32, device=dev)
    eta = torch.empty_like(Xc)
    heta = torch.empty_like(Xc)
    stats = torch.empty((A, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*tensors.values(), n_local, eta, heta,
                                   stats)]
    if plan.route == "cluster":
        err = lib.dpgo_tcg_cluster_launch(
            r, d, plan.C, A, n, nt * T, T, e_max, K, *ptrs, max_iters, kappa,
            theta, stream)
    elif plan.route == "spread":
        ws_floats = lib.dpgo_rtr_spread_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["tcg"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_tcg_spread_launch(
            r, d, plan.C, A, n, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, stream)
    else:
        ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max, 0)
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_tcg_launch(
            r, d, A, n, nt * T, T, e_max, K, *ptrs, ws.data_ptr(), ws_floats,
            max_iters, kappa, theta, stream)
    _raise_on("tcg", err, r, d, plan.C)
    with _COUNT_LOCK:
        TCG_LAUNCHES += 1
    return TCGOut(eta, heta, stats)


def rtr_refine_full(idx_i, idx_j, rot, trn, wk, wt, rho_rot, rho_trn, Rc,
                    Dc, Dzc, g0c, Grefc, S0c, Lc, inc_slot, inc_mask,
                    n_local, *, r: int, d: int, e_max: int, max_iters: int,
                    kappa: float, theta: float, initial_radius: float,
                    max_rejections: int, grad_tol: float,
                    _cluster: int | None = None,
                    _spread: int | None = None,
                    _grid: int | None = None,
                    _lanes: int | None = None) -> RTRRefineOut:
    """One re-centered RTR step on the corrections ``Dc`` for every agent
    (see the module docstring for the layouts).  CUDA tensors launch the
    kernel of the route ``cluster_plan`` picks on the current stream, once
    for all agents; CPU tensors run ``rtr_refine_full_reference``.
    ``_cluster``, ``_spread``, ``_grid`` and ``_lanes`` as in
    ``rtr_full``."""
    global REFINE_LAUNCHES
    A, _, n = Dc.shape
    s, K = Dzc.shape[-1], inc_slot.shape[-1]
    tensors = dict(idx_i=idx_i, idx_j=idx_j, rot=rot, trn=trn, wk=wk, wt=wt,
                   rho_rot=rho_rot, rho_trn=rho_trn, Rc=Rc, Dc=Dc, Dzc=Dzc,
                   g0c=g0c, Grefc=Grefc, S0c=S0c, Lc=Lc, inc_slot=inc_slot,
                   inc_mask=inc_mask, n_local=n_local)
    _check("rtr_refine_full", Dc.device, tensors,
           _shapes(idx_i, r, d, n, s, K, A))
    plan = _plan(Dc.device, _cluster, n, e_max, K, r, d, "rtr_refine_full",
                 _spread, A, _grid, _lanes)
    kw = dict(r=r, d=d, e_max=e_max, max_iters=max_iters, kappa=kappa,
              theta=theta, initial_radius=initial_radius,
              max_rejections=max_rejections, grad_tol=grad_tol)
    if Dc.device.type == "cpu":
        return rtr_refine_full_reference(*tensors.values(), **kw)
    lib = load()
    nt, T = idx_i.shape[1], idx_i.shape[-1]
    dev = Dc.device
    D_out = torch.empty_like(Dc)
    stats = torch.empty((A, 5), dtype=torch.float32, device=dev)
    iters = torch.empty((A,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*tensors.values(), D_out, stats, iters)]
    if plan.route == "cluster" and plan.lanes:
        err = lib.dpgo_rtr_refine_full_cluster_fold_launch(
            plan.lanes, r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs,
            max_iters, kappa, theta, initial_radius, max_rejections,
            grad_tol, stream)
    elif plan.route == "cluster":
        err = lib.dpgo_rtr_refine_full_cluster_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, max_iters,
            kappa, theta, initial_radius, max_rejections, grad_tol, stream)
    elif plan.route == "spread":
        ws_floats = lib.dpgo_rtr_spread_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["rtr_refine_full"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_refine_full_spread_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    elif plan.route == "grid":
        ws_floats = lib.dpgo_rtr_grid_workspace_floats(
            r, d, n, e_max, K, plan.C, KERNELS["rtr_refine_full"])
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_refine_full_grid_launch(
            r, d, plan.C, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    else:
        ws_floats = lib.dpgo_rtr_workspace_floats(r, d, n, e_max, 1)
        ws = torch.empty((A, ws_floats), dtype=torch.float32, device=dev)
        err = lib.dpgo_rtr_refine_full_launch(
            r, d, A, n, s, nt * T, T, e_max, K, *ptrs, ws.data_ptr(),
            ws_floats, max_iters, kappa, theta, initial_radius,
            max_rejections, grad_tol, stream)
    if err:
        _raise_on("rtr_refine_full", err, r, d, plan.C,
                  _grid_shape_note(plan, A, r, d, n))
    with _COUNT_LOCK:
        REFINE_LAUNCHES += 1
        if plan.lanes:
            FOLD_LAUNCHES["rtr_refine_full", plan.lanes] += 1
    return RTRRefineOut(D_out, stats, iters)
