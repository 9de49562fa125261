"""Shape bucketing: pad prepared problems so compatible requests stack
(port of ``dpgo_tpu.serve.bucketing``).

A batched solve (``runner.run_bucket``) steps every problem of a batch in
one round, which requires every problem to share its padded array shapes
exactly.  Requests rarely arrive shape-identical, so each prepared problem
is *padded up* to a bucket shape — every padded dimension rounded to a
quantum — and problems land in the same bucket iff all rounded dimensions
(and the solver config) agree.

Padding is pure masking, not new math: padded poses carry
``pose_mask = 0`` and no edges, padded edges carry ``mask = 0``, so every
operation of the round already ignores them — the same mechanism that
handles agents shorter than ``n_max`` in any unpadded graph.  Indices are
remapped: edge endpoints in the neighbor-slot range ``[n_max, n_max +
s_max)`` shift with the local-pose range they sit behind, and ELL
incidence slots in the ``j``-endpoint half ``[e_max, 2 e_max)`` shift with
the edge count.

Unlike the JAX package, which drops the kernel's edge-tile fields and runs
the batch on its ELL formulation, ``pad_problem`` rebuilds the tile-major
fields (``rbcd.edge_tile_layout``, pad index ``n_max + s_max`` of the
bucket) and the dense-Q incidence at the bucket shape: on a CUDA device
every float32 round of a served batch is one launch of the fused RTR
kernel over all its agents.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import Schedule
from ..models import rbcd
from ..ops import quadratic
from ..types import EdgeSet, edge_set_from_measurements


class BucketShape(NamedTuple):
    """Padded array dimensions of one shape bucket (all ints)."""

    n_max: int
    e_max: int
    s_max: int
    p_max: int
    k_inc: int
    n_total: int
    num_meas: int


@dataclasses.dataclass(frozen=True)
class PaddedProblem:
    """A prepared problem padded to its bucket shape, ready to stack."""

    prob: rbcd.PreparedProblem  # the original (unpadded) problem
    graph: rbcd.MultiAgentGraph
    meta: rbcd.GraphMeta
    edges_g: EdgeSet  # padded global edge set (metrics + init)
    X0: torch.Tensor
    shape: BucketShape
    #: Exact solver state to resume from instead of ``init_state(X0)`` —
    #: the crash-recovery path (``serve.session``) re-admits a died-mid-
    #: batch request with its last snapshot here.  Shapes must match the
    #: bucket; carried factors are refreshed by the runner when absent.
    state0: "rbcd.RBCDState | None" = None


def _round_up(x: int, q: int) -> int:
    return max(q, -(-int(x) // q) * q)


def bucket_shape_of(prob: rbcd.PreparedProblem, quantum: int = 32,
                    small_quantum: int = 8) -> BucketShape:
    """The bucket this problem pads into: large dimensions (pose/edge
    counts) round to ``quantum``, small per-agent tables (neighbor slots,
    public poses, ELL degree) to ``small_quantum``.  Problems whose raw
    sizes differ by less than a quantum coalesce; the config fields that
    must also agree live in the cache key (``cache.problem_fingerprint``),
    not here."""
    m = prob.meta
    return BucketShape(
        n_max=_round_up(m.n_max, quantum),
        e_max=_round_up(m.e_max, quantum),
        s_max=_round_up(m.s_max, small_quantum),
        p_max=_round_up(m.p_max, small_quantum),
        k_inc=_round_up(prob.graph.inc_slot.shape[-1], small_quantum),
        n_total=_round_up(prob.n_total, quantum),
        num_meas=_round_up(prob.num_meas, quantum),
    )


def padded_meta(prob: rbcd.PreparedProblem,
                shape: BucketShape) -> rbcd.GraphMeta:
    """GraphMeta at the bucket shape.  ``num_colors`` is normalized to 1
    for every schedule but COLORED (the only consumer), so two problems
    whose greedy colorings happen to differ still share a bucket."""
    m = prob.meta
    colors = m.num_colors if prob.params.schedule == Schedule.COLORED else 1
    return rbcd.GraphMeta(
        num_robots=m.num_robots, n_max=shape.n_max, e_max=shape.e_max,
        s_max=shape.s_max, p_max=shape.p_max, d=m.d, rank=m.rank,
        num_colors=colors)


def _pad_tail(a: np.ndarray, axis: int, target: int, fill=0) -> np.ndarray:
    grow = target - a.shape[axis]
    if grow == 0:
        return a
    width = [(0, 0)] * a.ndim
    width[axis] = (0, grow)
    return np.pad(a, width, constant_values=fill)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def padded_graph(arrays: dict, shape: BucketShape, n: torch.Tensor,
                 pose_mask: torch.Tensor, global_index: torch.Tensor,
                 color: torch.Tensor, dtype: torch.dtype,
                 device) -> rbcd.MultiAgentGraph:
    """The device graph of a padded problem from its host arrays
    (``arrays``: ``ei, ej, R, t, kappa, tau, weight, mask, is_lc, fixed,
    meas_id, pub_idx, pub_mask, nbr_robot, nbr_pub, nbr_mask, inc_slot,
    inc_mask`` at the bucket shape) and the fields padding leaves as they
    are, with the kernel's tile-major fields and the dense-Q incidence
    built for these rows — the one assembly of ``pad_problem`` and of
    ``models.incremental.LiveProblem``'s delta upload."""
    a = arrays

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=device)

    edges = EdgeSet(i=i64(a["ei"]), j=i64(a["ej"]), R=f(a["R"]),
                    t=f(a["t"]), kappa=f(a["kappa"]), tau=f(a["tau"]),
                    weight=f(a["weight"]), mask=f(a["mask"]),
                    is_lc=f(a["is_lc"]), fixed_weight=f(a["fixed"]))
    return rbcd.MultiAgentGraph(
        edges=edges,
        meas_id=i64(a["meas_id"]),
        n=n,
        pose_mask=pose_mask,
        pub_idx=i64(a["pub_idx"]),
        pub_mask=f(a["pub_mask"]),
        nbr_robot=i64(a["nbr_robot"]),
        nbr_pub=i64(a["nbr_pub"]),
        nbr_mask=f(a["nbr_mask"]),
        global_index=global_index,
        inc_slot=i32(a["inc_slot"]),
        inc_mask=f(a["inc_mask"]),
        **rbcd.edge_tile_layout(a["ei"], a["ej"], a["R"], a["t"],
                                np.asarray(a["mask"]) > 0, shape.n_max,
                                shape.s_max, device),
        color=color,
        dense_inc=quadratic.dense_q_incidence(
            a["ei"], a["ej"], shape.n_max + shape.s_max, device))


def pad_problem(prob: rbcd.PreparedProblem, shape: BucketShape,
                init: str = "chordal") -> PaddedProblem:
    """Pad a prepared problem to ``shape`` on its device and (if it
    carries no ``X0``) initialize it on the *padded* problem, as the JAX
    package does."""
    g, m = prob.graph, prob.meta
    dn = shape.n_max - m.n_max
    de = shape.e_max - m.e_max
    ds = shape.s_max - m.s_max
    dp = shape.p_max - m.p_max
    k_old = g.inc_slot.shape[-1]
    dk = shape.k_inc - k_old
    if min(dn, de, ds, dp, dk, shape.n_total - prob.n_total,
           shape.num_meas - prob.num_meas) < 0:
        raise ValueError(f"bucket shape {shape} smaller than problem "
                         f"({m}, K={k_old}, n_total={prob.n_total}, "
                         f"m={prob.num_meas})")
    A, d = m.num_robots, m.d
    dev = g.edges.R.device
    e = g.edges
    E = shape.e_max

    # Endpoint indices: the neighbor-slot range moves with n_max.
    ei = _host(e.i)
    ej = _host(e.j)
    ei = np.where(ei >= m.n_max, ei + dn, ei)
    ej = np.where(ej >= m.n_max, ej + dn, ej)
    R = _host(e.R)
    eye = np.broadcast_to(np.eye(d, dtype=R.dtype), (A, de, d, d))
    # ELL incidence: the j-endpoint half [e_max, 2 e_max) moves with e_max.
    inc = _host(g.inc_slot)
    inc = np.where(inc >= m.e_max, inc + de, inc)
    arrays = {
        "ei": _pad_tail(ei, 1, E), "ej": _pad_tail(ej, 1, E),
        "R": np.concatenate([R, eye], axis=1),
        "t": _pad_tail(_host(e.t), 1, E),
        "kappa": _pad_tail(_host(e.kappa), 1, E),
        "tau": _pad_tail(_host(e.tau), 1, E),
        "weight": _pad_tail(_host(e.weight), 1, E, fill=1.0),
        "mask": _pad_tail(_host(e.mask), 1, E),
        "is_lc": _pad_tail(_host(e.is_lc), 1, E),
        "fixed": _pad_tail(_host(e.fixed_weight), 1, E),
        "meas_id": _pad_tail(_host(g.meas_id), 1, E),
        "pub_idx": _pad_tail(_host(g.pub_idx), 1, shape.p_max),
        "pub_mask": _pad_tail(_host(g.pub_mask), 1, shape.p_max),
        "nbr_robot": _pad_tail(_host(g.nbr_robot), 1, shape.s_max),
        "nbr_pub": _pad_tail(_host(g.nbr_pub), 1, shape.s_max),
        "nbr_mask": _pad_tail(_host(g.nbr_mask), 1, shape.s_max),
        "inc_slot": _pad_tail(_pad_tail(inc, 2, shape.k_inc), 1,
                              shape.n_max),
        "inc_mask": _pad_tail(_pad_tail(_host(g.inc_mask), 2, shape.k_inc),
                              1, shape.n_max),
    }
    graph = padded_graph(
        arrays, shape, n=g.n,
        pose_mask=torch.as_tensor(
            _pad_tail(_host(g.pose_mask), 1, shape.n_max), device=dev),
        # Padded rows point at global pose 0 — masked out of the global
        # gather, and resolving to a valid Stiefel block on scatter (the
        # same convention build_graph uses for agents shorter than n_max).
        global_index=torch.as_tensor(
            _pad_tail(_host(g.global_index), 1, shape.n_max), device=dev),
        color=g.color, dtype=e.R.dtype, device=dev)
    meta = padded_meta(prob, shape)
    edges_g = edge_set_from_measurements(
        prob.part.meas_global, pad_to=shape.num_meas, dtype=prob.dtype,
        device=dev)

    if prob.X0 is not None:
        X0 = prob.X0
        X0 = torch.cat([X0, X0[:, :1].expand((A, dn) + X0.shape[2:])],
                       dim=1)
    else:
        X0 = rbcd.lifted_init(edges_g, graph, meta, shape.n_total, init)
    return PaddedProblem(prob=prob, graph=graph, meta=meta,
                         edges_g=edges_g, X0=X0, shape=shape)
