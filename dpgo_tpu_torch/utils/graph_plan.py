"""Multi-agent topology planning (port of ``dpgo_tpu.utils.graph_plan``).

Computes the padded index structure of the batched RBCD layout from edge
endpoints: per-agent edge rows with remote endpoints redirected to
neighbor slots, public-pose tables, neighbor-slot tables and the ELL
incidence.  Two backends with bit-identical output (same scan and
insertion orders, and bit-identical to the JAX package's):

* **native** — ``native/graph_builder.cpp`` through ctypes, in the library
  the port builds itself (``utils.native_io``);
* **python** — the dict-based planner.

``plan_topology`` dispatches (``backend="auto" | "native" | "python"``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from . import native_io


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


class _DpgoGraphPlan(ctypes.Structure):
    _fields_ = [
        ("A", ctypes.c_int32),
        ("n_max", ctypes.c_int32),
        ("e_max", ctypes.c_int32),
        ("s_max", ctypes.c_int32),
        ("p_max", ctypes.c_int32),
        ("k_max", ctypes.c_int32),
        ("ei", ctypes.POINTER(ctypes.c_int32)),
        ("ej", ctypes.POINTER(ctypes.c_int32)),
        ("meas_id", ctypes.POINTER(ctypes.c_int64)),
        ("emask", ctypes.POINTER(ctypes.c_uint8)),
        ("pub_idx", ctypes.POINTER(ctypes.c_int64)),
        ("pub_mask", ctypes.POINTER(ctypes.c_uint8)),
        ("nbr_robot", ctypes.POINTER(ctypes.c_int32)),
        ("nbr_pub", ctypes.POINTER(ctypes.c_int32)),
        ("nbr_mask", ctypes.POINTER(ctypes.c_uint8)),
        ("inc_slot", ctypes.POINTER(ctypes.c_int32)),
        ("inc_mask", ctypes.POINTER(ctypes.c_uint8)),
        ("error", ctypes.c_char * 256),
    ]


_registered = False


def _graph_lib():
    """The native library with the planner's symbols registered, or None
    when it cannot be built."""
    global _registered
    lib = native_io.load_library()
    if lib is None:
        return None
    with native_io._lock:
        if not _registered:
            lib.dpgo_graph_plan.argtypes = [
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(_DpgoGraphPlan),
            ]
            lib.dpgo_graph_plan.restype = ctypes.c_int
            lib.dpgo_graph_free.argtypes = [ctypes.POINTER(_DpgoGraphPlan)]
            lib.dpgo_graph_free.restype = None
            _registered = True
    return lib


def plan_native(r1, p1, r2, p2, num_robots: int, n_max: int) -> TopologyPlan:
    """``plan_python``'s arrays from the native planner; raises
    ``RuntimeError`` when the library cannot be built and ``ValueError``
    on invalid indices (as ``plan_python``)."""
    lib = _graph_lib()
    if lib is None:
        raise RuntimeError("native graph planner unavailable: "
                           f"{native_io.load_error()}")
    r1 = np.ascontiguousarray(r1, np.int32)
    p1 = np.ascontiguousarray(p1, np.int64)
    r2 = np.ascontiguousarray(r2, np.int32)
    p2 = np.ascontiguousarray(p2, np.int64)
    M = len(r1)
    out = _DpgoGraphPlan()
    rc = lib.dpgo_graph_plan(M, r1, p1, r2, p2, num_robots, n_max,
                             ctypes.byref(out))
    if rc != 0:
        err = out.error.decode(errors="replace")
        raise ValueError(f"native graph plan failed: {err}")
    try:
        A = num_robots
        e, s, p, k = out.e_max, out.s_max, out.p_max, out.k_max
        as_np = np.ctypeslib.as_array
        plan = TopologyPlan(
            e_max=int(e), s_max=int(s), p_max=int(p), k_max=int(k),
            ei=as_np(out.ei, (A, e)).copy(),
            ej=as_np(out.ej, (A, e)).copy(),
            meas_id=as_np(out.meas_id, (A, e)).copy(),
            emask=as_np(out.emask, (A, e)).astype(bool),
            pub_idx=as_np(out.pub_idx, (A, p)).copy(),
            pub_mask=as_np(out.pub_mask, (A, p)).astype(bool),
            nbr_robot=as_np(out.nbr_robot, (A, s)).copy(),
            nbr_pub=as_np(out.nbr_pub, (A, s)).copy(),
            nbr_mask=as_np(out.nbr_mask, (A, s)).astype(bool),
            inc_slot=as_np(out.inc_slot, (A, n_max, k)).copy(),
            inc_mask=as_np(out.inc_mask, (A, n_max, k)).astype(bool),
        )
    finally:
        lib.dpgo_graph_free(ctypes.byref(out))
    return plan


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


def plan_topology(r1, p1, r2, p2, num_robots: int, n_max: int,
                  backend: str = "auto") -> TopologyPlan:
    """Dispatch: ``"native"`` (raise when unavailable), ``"python"``, or
    ``"auto"`` (native when the library builds, else Python)."""
    if backend == "native":
        return plan_native(r1, p1, r2, p2, num_robots, n_max)
    if backend == "python":
        return plan_python(r1, p1, r2, p2, num_robots, n_max)
    if backend != "auto":
        raise ValueError(f"unknown planner backend {backend!r}")
    if _graph_lib() is not None:
        return plan_native(r1, p1, r2, p2, num_robots, n_max)
    return plan_python(r1, p1, r2, p2, num_robots, n_max)


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
