"""Multi-agent topology planning (port of the Python planner of
``dpgo_tpu.utils.graph_plan``; the native C++ planner is not part of the
port).  Same scan and insertion orders, so the arrays are bit-identical to
the JAX package's."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TopologyPlan(NamedTuple):
    e_max: int
    s_max: int
    p_max: int
    k_max: int
    ei: np.ndarray        # [A, e_max] int32, index into [n_max + s_max]
    ej: np.ndarray        # [A, e_max] int32
    meas_id: np.ndarray   # [A, e_max] int64 global measurement id
    emask: np.ndarray     # [A, e_max] bool
    pub_idx: np.ndarray   # [A, p_max] int64 local indices of public poses
    pub_mask: np.ndarray  # [A, p_max] bool
    nbr_robot: np.ndarray  # [A, s_max] int32
    nbr_pub: np.ndarray    # [A, s_max] int32 position in that robot's table
    nbr_mask: np.ndarray   # [A, s_max] bool
    inc_slot: np.ndarray   # [A, n_max, k_max] int32 into [gi | gj]
    inc_mask: np.ndarray   # [A, n_max, k_max] bool


def plan_python(r1, p1, r2, p2, num_robots: int, n_max: int) -> TopologyPlan:
    """Per-agent edge rows with remote endpoints redirected to neighbor
    slots, public-pose tables, neighbor-slot tables and the ELL incidence
    (the double bookkeeping of ``PGOAgent::addSharedLoopClosure``,
    ``PGOAgent.cpp:228-248``)."""
    A = num_robots
    M = len(r1)
    r = np.concatenate([np.asarray(r1), np.asarray(r2)])
    p = np.concatenate([np.asarray(p1), np.asarray(p2)])
    if M and ((r < 0).any() or (r >= A).any()):
        raise ValueError(f"edge references robot out of range [0, {A})")
    if M and ((p < 0).any() or (p >= n_max).any()):
        raise ValueError(f"edge pose index out of range [0, {n_max})")

    pub: list[dict[int, int]] = [dict() for _ in range(A)]
    for k in range(M):
        a, b = int(r1[k]), int(r2[k])
        if a != b:
            pub[a].setdefault(int(p1[k]), len(pub[a]))
            pub[b].setdefault(int(p2[k]), len(pub[b]))

    nbr: list[dict[tuple[int, int], int]] = [dict() for _ in range(A)]
    edge_rows: list[list[tuple]] = [[] for _ in range(A)]
    for k in range(M):
        a, b = int(r1[k]), int(r2[k])
        pi, qi = int(p1[k]), int(p2[k])
        if a == b:
            edge_rows[a].append((pi, qi, k))
        else:
            sa = nbr[a].setdefault((b, qi), len(nbr[a]))
            edge_rows[a].append((pi, n_max + sa, k))
            sb = nbr[b].setdefault((a, pi), len(nbr[b]))
            edge_rows[b].append((n_max + sb, qi, k))

    e_max = max(1, max(len(x) for x in edge_rows))
    s_max = max(1, max(len(x) for x in nbr))
    p_max = max(1, max(len(x) for x in pub))

    ei = np.zeros((A, e_max), np.int32)
    ej = np.zeros((A, e_max), np.int32)
    meas_id = np.zeros((A, e_max), np.int64)
    emask = np.zeros((A, e_max), bool)
    for a in range(A):
        for idx, (i, j, k) in enumerate(edge_rows[a]):
            ei[a, idx] = i
            ej[a, idx] = j
            meas_id[a, idx] = k
            emask[a, idx] = True

    pub_idx = np.zeros((A, p_max), np.int64)
    pub_mask = np.zeros((A, p_max), bool)
    for a in range(A):
        for q, pos in pub[a].items():
            pub_idx[a, pos] = q
            pub_mask[a, pos] = True

    nbr_robot = np.zeros((A, s_max), np.int32)
    nbr_pub = np.zeros((A, s_max), np.int32)
    nbr_mask = np.zeros((A, s_max), bool)
    for a in range(A):
        for (b, q), slot in nbr[a].items():
            nbr_robot[a, slot] = b
            nbr_pub[a, slot] = pub[b][q]
            nbr_mask[a, slot] = True

    inc: list[list[list[int]]] = [[[] for _ in range(n_max)]
                                  for _ in range(A)]
    for a in range(A):
        for idx, (i, j, _k) in enumerate(edge_rows[a]):
            if i < n_max:
                inc[a][i].append(idx)
            if j < n_max:
                inc[a][j].append(e_max + idx)
    k_max = max(1, max((len(s) for rows in inc for s in rows), default=1))
    inc_slot = np.zeros((A, n_max, k_max), np.int32)
    inc_mask = np.zeros((A, n_max, k_max), bool)
    for a in range(A):
        for v in range(n_max):
            for c, slot in enumerate(inc[a][v]):
                inc_slot[a, v, c] = slot
                inc_mask[a, v, c] = True

    return TopologyPlan(e_max=e_max, s_max=s_max, p_max=p_max, k_max=k_max,
                        ei=ei, ej=ej, meas_id=meas_id, emask=emask,
                        pub_idx=pub_idx, pub_mask=pub_mask,
                        nbr_robot=nbr_robot, nbr_pub=nbr_pub,
                        nbr_mask=nbr_mask, inc_slot=inc_slot,
                        inc_mask=inc_mask)


def color_agents(nbr_robot: np.ndarray, nbr_mask: np.ndarray,
                 num_robots: int) -> tuple[np.ndarray, int]:
    """Greedy largest-degree-first coloring of the agent-adjacency graph:
    ``(color [A] int32, num_colors)``, no two adjacent agents share a
    color."""
    adj = [set() for _ in range(num_robots)]
    nr = np.asarray(nbr_robot)
    nm = np.asarray(nbr_mask) > 0
    for a in range(num_robots):
        for b in np.unique(nr[a][nm[a]]):
            b = int(b)
            if b != a:
                adj[a].add(b)
                adj[b].add(a)
    order = sorted(range(num_robots), key=lambda a: -len(adj[a]))
    color = np.full(num_robots, -1, np.int32)
    for a in order:
        used = {color[b] for b in adj[a] if color[b] >= 0}
        c = 0
        while c in used:
            c += 1
        color[a] = c
    return color, int(color.max()) + 1 if num_robots else 1
