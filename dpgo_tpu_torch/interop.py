"""Carry a problem and its solver state across from the JAX package.

DPGO has no model weights: its parameters are the problem (the per-agent
graph) and the solver state.  ``graph_from_numpy`` and ``state_from_numpy``
turn the JAX package's ``MultiAgentGraph`` / ``RBCDState`` — given as
mappings or NamedTuples whose leaves are numpy arrays, e.g.
``jax.tree.map(np.asarray, graph)`` — into this package's, so both packages
can be fed identical inputs.  This module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .models.rbcd import GraphMeta, MultiAgentGraph, RBCDState
from .types import EdgeSet


def _fields(obj) -> dict:
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}
    return dict(obj)


def meta_from_numpy(meta) -> GraphMeta:
    """A ``GraphMeta`` from the JAX package's (a dataclass or a mapping)."""
    f = _fields(meta)
    return GraphMeta(**{k.name: int(f[k.name])
                        for k in dataclasses.fields(GraphMeta)
                        if k.name in f})


def graph_from_numpy(arrays, dtype: torch.dtype | None = None,
                     device="cuda") -> MultiAgentGraph:
    """A ``MultiAgentGraph`` from the JAX package's arrays.  Float fields
    take ``dtype`` (default: the type of the edge rotations); indices
    become int64 where they index tensors and int32 where the kernel reads
    them.  The graph must carry the kernel's edge tiles
    (``build_graph(pallas_sel=True)`` on the JAX side)."""
    device = resolve_device(device)
    a = _fields(arrays)
    e = _fields(a["edges"])
    if a.get("eidx_i") is None:
        raise ValueError("the graph carries no edge tiles: build it with "
                         "build_graph(..., pallas_sel=True)")
    if dtype is None:
        dtype = torch.float64 if np.asarray(e["R"]).dtype == np.float64 \
            else torch.float32

    def f(x):
        return torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                               device=device)

    def i64(x):
        return torch.as_tensor(np.array(x, np.int64), device=device)

    def i32(x):
        return torch.as_tensor(np.array(x, np.int32),
                               device=device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32),
                               device=device)

    edges = EdgeSet(i=i64(e["i"]), j=i64(e["j"]),
                    **{k: f(e[k]) for k in ("R", "t", "kappa", "tau",
                                            "weight", "mask", "is_lc",
                                            "fixed_weight")})
    return MultiAgentGraph(
        edges=edges, meas_id=i64(a["meas_id"]), n=i32(a["n"]),
        pose_mask=f(a["pose_mask"]), pub_idx=i64(a["pub_idx"]),
        pub_mask=f(a["pub_mask"]), nbr_robot=i64(a["nbr_robot"]),
        nbr_pub=i64(a["nbr_pub"]), nbr_mask=f(a["nbr_mask"]),
        global_index=i64(a["global_index"]), inc_slot=i32(a["inc_slot"]),
        inc_mask=f(a["inc_mask"]), eidx_i=i32(a["eidx_i"]),
        eidx_j=i32(a["eidx_j"]), rot_t=f32(a["rot_t"]),
        trn_t=f32(a["trn_t"]), color=i32(a["color"]))


def state_from_numpy(arrays, dtype: torch.dtype | None = None,
                     device="cuda") -> RBCDState:
    """An ``RBCDState`` from the JAX package's.  The Nesterov, warm-start
    and dense-Q fields are not ported and must be absent (None); the GNC
    ``mu`` and the ASYNC keys are not carried."""
    device = resolve_device(device)
    a = _fields(arrays)
    for key in ("V", "X_init", "Qbuf"):
        if a.get(key) is not None:
            raise NotImplementedError(
                f"state field {key!r} belongs to a part of the solver that "
                "is not ported yet (ROADMAP.md Queue A)")
    X = np.asarray(a["X"])
    if dtype is None:
        dtype = torch.float64 if X.dtype == np.float64 else torch.float32

    def f(x):
        return torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                               device=device)

    chol = a.get("chol")
    return RBCDState(
        X=f(X), weights=f(a["weights"]), iteration=int(a["iteration"]),
        rel_change=f(a["rel_change"]),
        ready=torch.as_tensor(np.array(a["ready"], bool), device=device),
        chol=None if chol is None else f(chol))
