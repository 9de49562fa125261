"""Carry a problem and its solver state across from the JAX package.

DPGO has no model weights: its parameters are the problem (the per-agent
graph) and the solver state.  ``graph_from_numpy``, ``state_from_numpy``
and ``refine_consts_from_numpy`` turn the JAX package's
``MultiAgentGraph`` / ``RBCDState`` / ``refine.RefineConstants`` (and
``verdict_state_from_numpy`` its ``VerdictState``) — given
as mappings or NamedTuples whose leaves are numpy arrays, e.g.
``jax.tree.map(np.asarray, graph)`` — into this package's, so both
packages can be fed identical inputs.  The refinement's float64 host
iterate (``RefineRef.Xg``) is numpy in both.  For the certificate,
``payload_to_numpy`` and ``certificate_to_numpy`` bring either package's
payload dict or ``CertificateResult`` to numpy, and ``fixed_probe_draws``
makes a replacement for ``certify._probe_draws`` that returns given draws
(e.g. JAX's ``PRNGKey(seed)`` / ``fold_in(key, 1)`` normals).
``agent_state_to_numpy`` reads a deployment agent's state (either
package's ``PGOAgent``) as numpy arrays, and ``agent_state_from_numpy``
loads such a state into a port ``PGOAgent``, so both packages can continue
from one mid-run state.  This module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .models.rbcd import GraphMeta, MultiAgentGraph, RBCDState, VerdictState
from .models.refine import RefineConstants
from .ops import quadratic
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
    n_buf = np.shape(a["pose_mask"])[-1] + np.shape(a["nbr_mask"])[-1]
    return MultiAgentGraph(
        edges=edges, meas_id=i64(a["meas_id"]), n=i32(a["n"]),
        pose_mask=f(a["pose_mask"]), pub_idx=i64(a["pub_idx"]),
        pub_mask=f(a["pub_mask"]), nbr_robot=i64(a["nbr_robot"]),
        nbr_pub=i64(a["nbr_pub"]), nbr_mask=f(a["nbr_mask"]),
        global_index=i64(a["global_index"]), inc_slot=i32(a["inc_slot"]),
        inc_mask=f(a["inc_mask"]), eidx_i=i32(a["eidx_i"]),
        eidx_j=i32(a["eidx_j"]), rot_t=f32(a["rot_t"]),
        trn_t=f32(a["trn_t"]), color=i32(a["color"]),
        dense_inc=quadratic.dense_q_incidence(e["i"], e["j"], n_buf, device))


def state_from_numpy(arrays, dtype: torch.dtype | None = None,
                     device="cuda", seed: int = 0) -> RBCDState:
    """An ``RBCDState`` from the JAX package's, with its Nesterov (``V``,
    ``gamma``, ``alpha``), GNC (``mu``, ``X_init``) and factor fields
    (``chol``, and the dense-Q buffer ``Qbuf`` where it has one).  JAX's
    ASYNC key chain does not carry over: the port's clocks draw from
    ``seed`` (``models.rbcd._async_fired``)."""
    device = resolve_device(device)
    a = _fields(arrays)
    X = np.asarray(a["X"])
    if dtype is None:
        dtype = torch.float64 if X.dtype == np.float64 else torch.float32

    def f(x):
        return None if x is None else torch.as_tensor(
            np.array(x, np.float64), dtype=dtype, device=device)

    return RBCDState(
        X=f(X), weights=f(a["weights"]), iteration=int(a["iteration"]),
        rel_change=f(a["rel_change"]),
        ready=torch.as_tensor(np.array(a["ready"], bool), device=device),
        chol=f(a.get("chol")), V=f(a.get("V")), gamma=f(a.get("gamma")),
        alpha=f(a.get("alpha")), mu=f(a.get("mu")),
        X_init=f(a.get("X_init")), seed=seed, Qbuf=f(a.get("Qbuf")))


def refine_consts_from_numpy(arrays, device="cuda") -> RefineConstants:
    """A ``RefineConstants`` from the JAX package's (float32 leaves).  The
    kernel layouts stay None where the JAX side built none (a graph
    without edge tiles); such constants serve the "ell" formulation
    only."""
    device = resolve_device(device)
    a = _fields(arrays)
    return RefineConstants(**{
        k: None if a.get(k) is None else torch.as_tensor(
            np.array(a[k], np.float32), device=device)
        for k in RefineConstants._fields})


def verdict_state_from_numpy(arrays, dtype: torch.dtype | None = None,
                             device="cuda") -> VerdictState:
    """A ``VerdictState`` from the JAX package's: the counters and word as
    int32, the stall latch as bool, the costs and the history in ``dtype``
    (default: the history's type)."""
    device = resolve_device(device)
    a = _fields(arrays)
    if dtype is None:
        dtype = torch.float64 if np.asarray(a["hist"]).dtype == np.float64 \
            else torch.float32
    ints = ("word", "eval_idx", "term_eval", "term_it", "stage", "stall_len")
    out = {}
    for k in VerdictState._fields:
        x = np.array(a[k])
        if k in ints:
            out[k] = torch.as_tensor(x.astype(np.int32), device=device)
        elif k == "stall_fired":
            out[k] = torch.as_tensor(x.astype(bool), device=device)
        else:
            out[k] = torch.as_tensor(x.astype(np.float64), dtype=dtype,
                                     device=device)
    return VerdictState(**out)


def payload_to_numpy(payload: dict) -> dict:
    """A device certificate payload (either package's) as numpy: 0-dim
    entries become floats, the direction an array."""
    out = {}
    for k, v in payload.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        out[k] = float(a) if a.ndim == 0 else a
    return out


def certificate_to_numpy(cert) -> dict:
    """A ``CertificateResult`` (either package's) as a dict of plain
    values, the direction as a numpy array."""
    out = _fields(cert)
    d = out["direction"]
    out["direction"] = d.detach().cpu().numpy() \
        if isinstance(d, torch.Tensor) else np.asarray(d)
    return out


def fixed_probe_draws(draws: dict):
    """A stand-in for ``certify._probe_draws`` that returns the given
    draws: ``draws[seed] = (v0 [n, 1, d+1], V0 [n (d+1), k])`` as arrays,
    cast to the requested dtype and device."""
    def probe_draws(seed, n, dh, num_probe, dtype, device):
        v0, V0 = draws[int(seed)]
        v0 = torch.as_tensor(np.array(v0, np.float64), dtype=dtype,
                             device=device)
        V0 = torch.as_tensor(np.array(V0, np.float64), dtype=dtype,
                             device=device)
        if v0.shape != (n, 1, dh) or V0.shape != (n * dh, num_probe):
            raise ValueError(
                f"draws for seed {seed} have shapes {tuple(v0.shape)}, "
                f"{tuple(V0.shape)}; expected {(n, 1, dh)}, "
                f"{(n * dh, num_probe)}")
        return v0, V0
    return probe_draws


#: The ``PGOAgent`` attributes an agent state carries across.
_AGENT_ARRAYS = ("_V", "_Y", "_X_init", "_weights", "_nbr_vals",
                 "_nbr_have", "_aux_vals", "_aux_have", "_ylift",
                 "_T_local", "_global_anchor")
_AGENT_SCALARS = ("_mu", "_gamma", "_alpha", "_num_weight_updates",
                  "num_robots")


def _host_array(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def agent_state_to_numpy(agent) -> dict:
    """A ``PGOAgent``'s state as numpy arrays and plain values — the
    iterate and its Nesterov sequences, the weights and ``mu``, the
    neighbor caches and their sequence numbers, the status, the neighbor
    statuses, the lost neighbors and the lifting matrix.  Works on the JAX
    package's agent and on the port's (a read of the port's device
    tensors)."""
    out = {k: _host_array(getattr(agent, k)) for k in _AGENT_ARRAYS}
    # The port's iterate is read directly (its ``X`` property would go
    # through the agent's counted host-read seam).
    x_dev = getattr(agent, "_X_dev", None)
    out["X"] = _host_array(x_dev if isinstance(x_dev, torch.Tensor)
                           else agent.X)
    out.update({k: getattr(agent, k) for k in _AGENT_SCALARS})
    st = agent._status
    out["status"] = (st.state.value, st.instance_number,
                     st.iteration_number, bool(st.ready_to_terminate),
                     float(st.relative_change))
    out["neighbor_status"] = {
        rid: (s.state.value, s.instance_number, s.iteration_number,
              bool(s.ready_to_terminate), float(s.relative_change))
        for rid, s in agent._neighbor_status.items()}
    out["nbr_pose_seq"] = dict(agent._nbr_pose_seq)
    out["nbr_aux_seq"] = dict(agent._nbr_aux_seq)
    out["lost_neighbors"] = sorted(agent._lost_neighbors)
    return out


def agent_state_from_numpy(agent, arrays: dict) -> None:
    """Load ``agent_state_to_numpy``'s state into a port ``PGOAgent`` that
    ingested the same measurements (``set_pose_graph``: the same slots and
    edges), on its device and in its dtype; the step's operands are built
    when the state is INITIALIZED."""
    from .agent import AgentState, PGOAgentStatus

    a = dict(arrays)
    with agent._lock:
        nb = len(agent._slot_pose)
        if np.asarray(a["_nbr_vals"]).shape[0] != nb:
            raise ValueError("the state's neighbor slots do not match this "
                             "agent's problem: ingest the same "
                             "measurements first")

        def dev(x):
            return None if x is None else torch.as_tensor(
                np.asarray(x, np.float64), dtype=agent.dtype,
                device=agent.device)

        agent.set_lifting_matrix(a["_ylift"])
        agent.X = dev(a["X"])
        agent._V, agent._Y = dev(a["_V"]), dev(a["_Y"])
        agent._X_init = dev(a["_X_init"])
        agent._weights = np.asarray(a["_weights"], np.float64).copy()
        agent._weights_dev = None
        agent._chol = None
        for k in ("_nbr_vals", "_aux_vals"):
            setattr(agent, k, np.asarray(a[k], np.float64).copy())
        for k in ("_nbr_have", "_aux_have"):
            setattr(agent, k, np.asarray(a[k], bool).copy())
        agent._nbr_ver += 1
        agent._aux_ver += 1
        if a.get("_T_local") is not None:
            agent._T_local = np.asarray(a["_T_local"], np.float64).copy()
        anchor = a.get("_global_anchor")
        agent._global_anchor = None if anchor is None else \
            np.asarray(anchor, np.float64).copy()
        agent._mu = float(a["_mu"])
        agent._gamma = float(a["_gamma"])
        agent._alpha = float(a["_alpha"])
        agent._num_weight_updates = int(a["_num_weight_updates"])
        agent.num_robots = int(a["num_robots"])
        state, inst, it, ready, rel = a["status"]
        agent._status.state = AgentState(int(state))
        agent._status.instance_number = int(inst)
        agent._status.iteration_number = int(it)
        agent._status.ready_to_terminate = bool(ready)
        agent._status.relative_change = float(rel)
        agent._neighbor_status = {
            int(rid): PGOAgentStatus(
                robot_id=int(rid), state=AgentState(int(s[0])),
                instance_number=int(s[1]), iteration_number=int(s[2]),
                ready_to_terminate=bool(s[3]), relative_change=float(s[4]))
            for rid, s in a["neighbor_status"].items()}
        agent._nbr_pose_seq = {int(k): int(v)
                               for k, v in a["nbr_pose_seq"].items()}
        agent._nbr_aux_seq = {int(k): int(v)
                              for k, v in a["nbr_aux_seq"].items()}
        agent._lost_neighbors = {int(x) for x in a["lost_neighbors"]}
        if agent._status.state == AgentState.INITIALIZED:
            agent._build_step()
