"""Live sessions: streaming edges and warm restarts over a fixed pose set
(port of ``dpgo_tpu.models.incremental``).

A new measurement would otherwise mean rebuilding the problem
(``prepare_problem``) and re-initializing from the centralized chordal
solve.  The RBCD formulation makes that unnecessary — new edges only ADD
rows to the connection Laplacian ``Q`` and the linear term ``G`` (T-RO
2021, eq. 14: both are sums over edges), and the async-RBCD theory (RA-L
2020) tolerates resuming descent from any feasible iterate.
``LiveProblem`` exploits both:

* **Delta apply** (``apply_edges``): a streamed edge batch lands as pure
  masked appends into the *padded* per-agent layout of the serving plane
  (``serve.bucketing``): new edge rows occupy previously-masked rows of the
  padded ``EdgeSet``, new neighbor slots / public poses occupy masked rows
  of their tables, and the ELL incidence rows of the endpoint poses grow in
  place.  Every padded dimension is unchanged, so the bucket shape — and
  with it the config fingerprint and every cached program keyed on it — is
  REUSED.  When an append would overflow the padding, the problem re-pads
  (same bucket) or re-buckets (grown shape), explicitly reported in the
  returned ``EdgeDelta``.  After every delta the kernel's tile-major edge
  fields are rebuilt from the new rows (``serve.bucketing.padded_graph``):
  the CPU path reads edges through the ELL incidence, the card's kernel
  through the tiles, so stale tiles would be wrong on the card only.

* **Warm restart** (``warm_dispatch``): resume ``dispatch_prepared`` from
  an exact ``RBCDState`` snapshot — the terminal state of the previous
  solve (``RBCDResult.state``), a flight-recorder snapshot, or a serving
  session snapshot (``serve.session``) — instead of the chordal init.  The
  carried GNC weights are remapped onto the (possibly reordered) edge rows
  through the global measurement ids, the convergence bookkeeping
  (``ready``/``rel_change``) resets because the problem changed, and the
  preconditioner factors are recomputed from the live weights
  (``refresh_problem``).

The pose set is FIXED for the life of a ``LiveProblem``: streaming
measurements between existing poses (loop closures, re-observations,
cross-robot matches) is the supported surface; a measurement referencing a
new pose raises, because ``partition_contiguous`` re-derives the
pose-to-robot map from the total count and a grown count would silently
reassign every pose.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..config import AgentParams, Schedule
from ..device import default_dtype, resolve_device
from ..types import EdgeSet, Measurements
from ..utils.partition import partition_contiguous
from .rbcd import (PreparedProblem, RBCDResult, RBCDState, dispatch_prepared,
                   prepare_problem, refresh_problem)


class EdgeDelta(NamedTuple):
    """Outcome of one ``apply_edges`` call.

    ``mode`` is ``"delta"`` (masked appends in place — cached programs
    reused), ``"repad"`` (rebuilt, but re-padded to the SAME bucket shape)
    or ``"rebucket"`` (the padding overflowed: the bucket grew)."""

    mode: str
    num_edges: int
    shape: "tuple"
    recompiles: bool


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


class LiveProblem:
    """A prepared problem that absorbs streamed edges and warm restarts.

    Holds the accumulated measurement set, the current padded problem at
    its bucket shape, and numpy mirrors of the padded per-agent arrays the
    delta path appends into.  ``prob`` exposes the dispatch view (a
    ``PreparedProblem`` whose graph/meta are the PADDED ones).  Runs on
    ``device`` (the card unless ``"cpu"`` is asked for); ``dtype``
    defaults to float32 on CUDA and float64 on the CPU.
    """

    def __init__(self, meas: Measurements, num_robots: int,
                 params: AgentParams | None = None, dtype=None,
                 quantum: int = 32, init: str = "chordal",
                 headroom: int = 1, device="cuda"):
        self.num_robots = int(num_robots)
        self.params = params or AgentParams(d=meas.d, r=5,
                                            num_robots=num_robots)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.quantum = int(quantum)
        self.init_policy = init
        #: Extra quanta of padding reserved in every streamable dimension
        #: (edges, slots, public poses, ELL degree, measurement count) so a
        #: stream has room to append before its first forced re-bucket.
        #: 0 = the serving plane's exact bucket.
        self.headroom = int(headroom)
        self._meas = meas
        self.deltas_applied = 0
        #: The most recent ``apply_edges`` outcome (None before the first).
        self.last_delta: EdgeDelta | None = None
        self._rebuild(meas, prefer_shape=None)

    # -- dispatch views ------------------------------------------------------

    @property
    def prob(self) -> PreparedProblem:
        """Dispatch-ready view at the padded bucket shape."""
        p = self.padded
        return PreparedProblem(part=self.part, graph=p.graph, meta=p.meta,
                               params=self.params, dtype=self.dtype,
                               X0=p.X0)

    @property
    def num_meas(self) -> int:
        return len(self._meas)

    @property
    def meas(self) -> Measurements:
        return self._meas

    def solve(self, **dispatch_kw) -> RBCDResult:
        """Cold dispatch of the current problem (chordal-initialized).  The
        returned result's ``.state`` is the warm-restart handle for the
        next ``warm_dispatch``."""
        return dispatch_prepared(self.prob, **dispatch_kw)

    # -- rebuild path --------------------------------------------------------

    def _rebuild(self, meas: Measurements, prefer_shape) -> str:
        """Full rebuild: re-prepare, re-pad (to ``prefer_shape`` when the
        new problem still fits it), reload mirrors."""
        from ..serve.bucketing import bucket_shape_of, pad_problem

        part = partition_contiguous(meas, self.num_robots)
        raw = prepare_problem(meas, self.num_robots, params=self.params,
                              dtype=self.dtype, part=part, init=None,
                              device=self.device)
        want = bucket_shape_of(raw, quantum=self.quantum)
        if self.headroom > 0:
            # The pose set is fixed (n_max/n_total never grow); every
            # edge-driven dimension reserves stream room.
            q, sq = self.headroom * self.quantum, self.headroom * 8
            want = want._replace(
                e_max=want.e_max + q, s_max=want.s_max + sq,
                p_max=want.p_max + sq, k_inc=want.k_inc + sq,
                num_meas=want.num_meas + q)
        if prefer_shape is not None and all(
                w <= s for w, s in zip(want, prefer_shape)):
            shape, mode = prefer_shape, "repad"
        else:
            shape, mode = want, "rebucket"
        self.padded = pad_problem(raw, shape, init=self.init_policy)
        self.shape = shape
        self.part = part
        self._meas = meas
        self._load_mirrors()
        return mode

    def _load_mirrors(self) -> None:
        """Host-side numpy mirrors of the padded arrays the delta path
        mutates, plus the occupancy bookkeeping (valid counts per padded
        table) and the key->row dictionaries the append staging needs."""
        g = self.padded.graph
        e = g.edges
        m = self.padded.meta
        self._np = {
            "ei": _host(e.i), "ej": _host(e.j), "R": _host(e.R),
            "t": _host(e.t), "kappa": _host(e.kappa), "tau": _host(e.tau),
            "weight": _host(e.weight), "mask": _host(e.mask),
            "is_lc": _host(e.is_lc), "fixed": _host(e.fixed_weight),
            "meas_id": _host(g.meas_id),
            "pub_idx": _host(g.pub_idx), "pub_mask": _host(g.pub_mask),
            "nbr_robot": _host(g.nbr_robot), "nbr_pub": _host(g.nbr_pub),
            "nbr_mask": _host(g.nbr_mask),
            "inc_slot": _host(g.inc_slot), "inc_mask": _host(g.inc_mask),
        }
        eg = self.padded.edges_g
        self._g = {f: _host(getattr(eg, f))
                   for f in ("i", "j", "R", "t", "kappa", "tau", "weight",
                             "mask", "is_lc", "fixed_weight")}
        A = m.num_robots
        self._e_used = self._np["mask"].sum(axis=1).astype(int)
        self._p_used = self._np["pub_mask"].sum(axis=1).astype(int)
        self._s_used = self._np["nbr_mask"].sum(axis=1).astype(int)
        self._inc_used = self._np["inc_mask"].sum(axis=2).astype(int)
        # (local pose -> pub row) per agent, and ((robot, pose) -> slot).
        self._pub_row = [
            {int(self._np["pub_idx"][a, r]): r
             for r in range(self._p_used[a])} for a in range(A)]
        self._slot_of = []
        for a in range(A):
            d = {}
            for s in range(self._s_used[a]):
                b = int(self._np["nbr_robot"][a, s])
                q = int(self._np["pub_idx"][b, int(self._np["nbr_pub"][a, s])])
                d[(b, q)] = s
            self._slot_of.append(d)

    # -- the delta path ------------------------------------------------------

    def _robot_of(self, p: np.ndarray):
        """The contiguous partition's pose->robot map (must agree with
        ``partition_contiguous`` exactly — same arithmetic)."""
        npr = self._meas.num_poses // self.num_robots
        robot = np.minimum(p // npr, self.num_robots - 1)
        return robot.astype(np.int64), (p - robot * npr).astype(np.int64)

    def apply_edges(self, new_meas: Measurements) -> EdgeDelta:
        """Absorb a batch of streamed measurements between EXISTING poses.

        Fast path: stage masked appends against copies of the occupancy
        counters; commit only when every padded table has room.  Any
        overflow (or the COLORED schedule, whose agent coloring a new
        shared edge can invalidate) falls back to a full rebuild —
        re-padded to the same bucket when it still fits (``"repad"``),
        else grown (``"rebucket"``)."""
        if new_meas.d != self._meas.d:
            raise ValueError(f"dimension mismatch: d={new_meas.d} vs "
                             f"{self._meas.d}")
        if len(new_meas) == 0:
            return EdgeDelta("delta", 0, tuple(self.shape), False)
        if np.any(np.asarray(new_meas.r1) != 0) or \
                np.any(np.asarray(new_meas.r2) != 0):
            raise ValueError("apply_edges expects globally-indexed "
                             "measurements (r1 == r2 == 0)")
        p1 = np.asarray(new_meas.p1, np.int64)
        p2 = np.asarray(new_meas.p2, np.int64)
        n_total = self._meas.num_poses
        if new_meas.num_poses > n_total or max(p1.max(), p2.max()) >= n_total:
            raise ValueError(
                "streamed measurements reference poses beyond the live "
                "problem's fixed pose set — streaming NEW poses is not "
                "supported (the contiguous partition would reassign every "
                "pose); build a fresh LiveProblem instead")

        cat = Measurements.concatenate([self._meas, new_meas])
        mode = None
        if self.params.schedule != Schedule.COLORED:
            mode = self._try_delta(new_meas, cat)
        if mode is None:
            mode = self._rebuild(cat, prefer_shape=self.shape)
        self.deltas_applied += 1
        delta = EdgeDelta(mode, len(new_meas), tuple(self.shape),
                          mode == "rebucket")
        self.last_delta = delta
        run = obs.get_run()
        if run is not None:
            run.event("live_delta", phase="live", mode=mode,
                      num_edges=len(new_meas),
                      num_meas=len(self._meas),
                      delta_index=self.deltas_applied)
            run.counter("live_edges_streamed_total",
                        "measurements absorbed by live deltas").inc(
                len(new_meas), mode=mode)
        return delta

    def _try_delta(self, new_meas: Measurements, cat: Measurements):
        """Stage + commit the masked appends; None when any table lacks
        room (the caller rebuilds)."""
        shape = self.shape
        m = self.padded.meta
        n_pad = m.n_max
        e_pad = m.e_max
        m_used = len(self._meas)
        if m_used + len(new_meas) > shape.num_meas:
            return None

        p1 = np.asarray(new_meas.p1, np.int64)
        p2 = np.asarray(new_meas.p2, np.int64)
        ra, la = self._robot_of(p1)
        rb, lb = self._robot_of(p2)

        # Staged copies: committed only if everything fits.
        e_used = self._e_used.copy()
        p_used = self._p_used.copy()
        s_used = self._s_used.copy()
        inc_used = self._inc_used.copy()
        pub_row = [dict(d) for d in self._pub_row]
        slot_of = [dict(d) for d in self._slot_of]
        new_pub: list[tuple[int, int, int]] = []    # (agent, pose, row)
        new_slot: list[tuple[int, int, int, int]] = []  # (agent, s, robot, row)
        # (agent, row, ti, hi, k) per edge copy; k indexes new_meas.
        rows: list[tuple[int, int, int, int, int]] = []

        def ensure_pub(a: int, pose: int):
            r = pub_row[a].get(pose)
            if r is not None:
                return r
            if p_used[a] >= shape.p_max:
                return None
            r = int(p_used[a])
            p_used[a] += 1
            pub_row[a][pose] = r
            new_pub.append((a, pose, r))
            return r

        def ensure_slot(a: int, b: int, q: int):
            s = slot_of[a].get((b, q))
            if s is not None:
                return s
            r = ensure_pub(b, q)
            if r is None or s_used[a] >= shape.s_max:
                return None
            s = int(s_used[a])
            s_used[a] += 1
            slot_of[a][(b, q)] = s
            new_slot.append((a, s, b, r))
            return s

        stage_inc: list[tuple[int, int, int]] = []

        def stage_row(a: int, ti: int, hi: int, k: int) -> bool:
            if e_used[a] >= e_pad:
                return False
            row = int(e_used[a])
            # ELL incidence for local endpoints: slot ``row`` for the tail
            # half, ``e_pad + row`` for the head half (the [gi | gj]
            # concatenation egrad_ell gathers).  Slot endpoints get no
            # incidence entry — gradients only accumulate on local poses.
            if ti < n_pad and inc_used[a, ti] >= shape.k_inc:
                return False
            if hi < n_pad and inc_used[a, hi] >= shape.k_inc:
                return False
            e_used[a] += 1
            if ti < n_pad:
                stage_inc.append((a, ti, row))
                inc_used[a, ti] += 1
            if hi < n_pad:
                stage_inc.append((a, hi, e_pad + row))
                inc_used[a, hi] += 1
            rows.append((a, row, ti, hi, k))
            return True

        for k in range(len(new_meas)):
            a, b = int(ra[k]), int(rb[k])
            pa, pb = int(la[k]), int(lb[k])
            if a == b:
                if not stage_row(a, pa, pb, k):
                    return None
            else:
                # Both endpoint poses become public on their owners; each
                # owner holds a copy with the remote endpoint in a slot.
                if ensure_pub(a, pa) is None or ensure_pub(b, pb) is None:
                    return None
                sa = ensure_slot(a, b, pb)
                sb = ensure_slot(b, a, pa)
                if sa is None or sb is None:
                    return None
                if not stage_row(a, pa, n_pad + sa, k):
                    return None
                if not stage_row(b, n_pad + sb, pb, k):
                    return None

        # -- commit ----------------------------------------------------------
        npd = self._np
        for a, pose, r in new_pub:
            npd["pub_idx"][a, r] = pose
            npd["pub_mask"][a, r] = 1.0
        for a, s, b, r in new_slot:
            npd["nbr_robot"][a, s] = b
            npd["nbr_pub"][a, s] = r
            npd["nbr_mask"][a, s] = 1.0
        for a, pose, slot_val in stage_inc:
            col = int(self._inc_used[a, pose])
            # staged additions to one pose arrive in order; track the fill
            while col < shape.k_inc and npd["inc_mask"][a, pose, col] > 0:
                col += 1
            npd["inc_slot"][a, pose, col] = slot_val
            npd["inc_mask"][a, pose, col] = 1.0
        is_lc_f = (~((ra == rb) & (p1 + 1 == p2))).astype(np.float64)
        fixed_f = np.asarray(new_meas.is_known_inlier,
                             bool).astype(np.float64)
        R_new = np.asarray(new_meas.R)
        t_new = np.asarray(new_meas.t)
        for a, row, ti, hi, k in rows:
            npd["ei"][a, row] = ti
            npd["ej"][a, row] = hi
            npd["R"][a, row] = R_new[k]
            npd["t"][a, row] = t_new[k]
            npd["kappa"][a, row] = new_meas.kappa[k]
            npd["tau"][a, row] = new_meas.tau[k]
            npd["weight"][a, row] = new_meas.weight[k]
            npd["mask"][a, row] = 1.0
            npd["is_lc"][a, row] = is_lc_f[k]
            npd["fixed"][a, row] = fixed_f[k]
            npd["meas_id"][a, row] = m_used + k
        gm = self._g
        gids = m_used + np.arange(len(new_meas))
        gm["i"][gids] = p1
        gm["j"][gids] = p2
        gm["R"][gids] = R_new
        gm["t"][gids] = t_new
        gm["kappa"][gids] = new_meas.kappa
        gm["tau"][gids] = new_meas.tau
        gm["weight"][gids] = new_meas.weight
        gm["mask"][gids] = 1.0
        gm["is_lc"][gids] = is_lc_f
        gm["fixed_weight"][gids] = fixed_f

        self._e_used = e_used
        self._p_used = p_used
        self._s_used = s_used
        self._inc_used = self._np["inc_mask"].sum(axis=2).astype(int)
        self._pub_row = pub_row
        self._slot_of = slot_of
        self._meas = cat
        self.part = partition_contiguous(cat, self.num_robots)
        self._upload()
        return "delta"

    def _upload(self) -> None:
        """Rebuild the device-side padded graph (its tile-major edge fields
        and dense-Q incidence included) and the global edge set from the
        mirrors; array shapes are unchanged."""
        from ..serve.bucketing import padded_graph

        g_old = self.padded.graph
        dev = g_old.edges.R.device
        graph = padded_graph(self._np, self.shape, n=g_old.n,
                             pose_mask=g_old.pose_mask,
                             global_index=g_old.global_index,
                             color=g_old.color, dtype=self.dtype,
                             device=dev)
        gm = self._g

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=self.dtype, device=dev)

        edges_g = EdgeSet(
            i=torch.as_tensor(gm["i"], device=dev),
            j=torch.as_tensor(gm["j"], device=dev),
            R=f(gm["R"]), t=f(gm["t"]), kappa=f(gm["kappa"]),
            tau=f(gm["tau"]), weight=f(gm["weight"]), mask=f(gm["mask"]),
            is_lc=f(gm["is_lc"]), fixed_weight=f(gm["fixed_weight"]))
        prob_new = dataclasses.replace(self.padded.prob, part=self.part)
        self.padded = dataclasses.replace(self.padded, prob=prob_new,
                                          graph=graph, edges_g=edges_g)

    # -- warm restarts -------------------------------------------------------

    def warm_dispatch(self, state: "RBCDState | RBCDResult",
                      new_edges: Measurements | None = None,
                      max_iters: int | None = None,
                      grad_norm_tol: float = 0.1, eval_every: int = 1,
                      verdict_every: int | None = None) -> RBCDResult:
        """Resume solving from an exact snapshot after (optionally)
        absorbing ``new_edges``.

        ``state`` must correspond to the problem as it was BEFORE
        ``new_edges`` (a prior solve's ``RBCDResult`` — its ``.state`` is
        used — a ``serve.session`` snapshot, or a flight-recorder
        snapshot); the carried GNC weights are remapped to the new edge
        rows through the global measurement ids, so the delta path's
        in-place appends and a full rebuild's reordered rows resume
        identically."""
        if isinstance(state, RBCDResult):
            if state.state is None:
                raise ValueError("result carries no terminal state to "
                                 "resume from")
            state = state.state
        old_map = (self._np["meas_id"].copy(), self._np["mask"].copy(),
                   len(self._meas))
        if new_edges is not None and len(new_edges):
            self.apply_edges(new_edges)
        state = self._adapt_state(state, old_map)
        return dispatch_prepared(self.prob, max_iters=max_iters,
                                 grad_norm_tol=grad_norm_tol,
                                 eval_every=eval_every, state=state,
                                 verdict_every=verdict_every)

    def _adapt_state(self, state: RBCDState, old_map) -> RBCDState:
        """Map a snapshot onto the CURRENT padded layout: pad the iterate
        to a grown bucket, remap weights by measurement id, reset the
        convergence bookkeeping, and refresh the carried factors."""
        meta = self.padded.meta
        dev = self.padded.graph.edges.R.device
        old_meas_id, old_mask, m_old = old_map
        X = state.X.to(dev)
        A, n_old = X.shape[0], X.shape[1]
        if A != meta.num_robots:
            raise ValueError(f"snapshot has {A} agents, problem has "
                             f"{meta.num_robots}")
        dn = meta.n_max - n_old
        if dn < 0:
            raise ValueError("snapshot is wider than the live problem — "
                             "buckets only grow")

        def pad_poses(a):
            a = a.to(dev)
            if dn == 0:
                return a
            return torch.cat([a, a[:, :1].expand((A, dn) + a.shape[2:])],
                             dim=1)

        # Weights: collapse the OLD per-agent rows to per-measurement
        # (shared copies are identical — masked mean is exact), then
        # scatter onto the new rows; rows for streamed measurements take
        # the build-time weight.
        w_old = state.weights.detach().cpu().numpy()
        ids = old_meas_id.reshape(-1)
        msk = old_mask.reshape(-1)
        if w_old.size != ids.size:
            raise ValueError(
                "snapshot weights do not match the pre-delta edge layout — "
                "pass the state captured before these edges were applied")
        num = np.zeros(m_old)
        den = np.zeros(m_old)
        np.add.at(num, ids, w_old.reshape(-1) * msk)
        np.add.at(den, ids, msk)
        w_glob = np.where(den > 0, num / np.maximum(den, 1.0), 1.0)
        new_id = self._np["meas_id"]
        new_mask = self._np["mask"] > 0
        carried = new_mask & (new_id < m_old)
        w_new = self._np["weight"].copy()
        w_new[carried] = w_glob[new_id[carried]]

        dt = X.dtype
        accel = state.V is not None
        Xp = pad_poses(X)
        state = RBCDState(
            X=Xp,
            weights=torch.as_tensor(w_new, dtype=state.weights.dtype,
                                    device=dev),
            iteration=0,
            rel_change=torch.full((A,), float("inf"), dtype=dt, device=dev),
            ready=torch.zeros((A,), dtype=torch.bool, device=dev),
            # A changed problem restarts the Nesterov sequences (the same
            # collapse a weight-update round performs).
            V=Xp if accel else None,
            gamma=torch.zeros((A,), dtype=dt, device=dev),
            alpha=torch.zeros((A,), dtype=dt, device=dev),
            mu=state.mu.to(dev),
            X_init=pad_poses(state.X_init)
            if state.X_init is not None else None,
            seed=state.seed, chol=None, Qbuf=None)
        return refresh_problem(state, self.padded.graph, meta, self.params)


def state_from_arrays(arrays: dict, device="cuda") -> RBCDState:
    """Rebuild an ``RBCDState`` on ``device`` from the array dict the
    snapshot codecs persist (the flight recorder's ``snap*_`` fields,
    ``serve.session`` files; either package's).  The ASYNC seed is the
    last word of ``key`` (the port writes ``[0, seed]``).  Factors
    (``chol``/``Qbuf``) recompute via ``refresh_problem``."""
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=dev)

    return RBCDState(
        X=t("X"), weights=t("weights"),
        iteration=int(np.asarray(arrays.get("iteration", 0))),
        rel_change=t("rel_change"), ready=t("ready").to(torch.bool),
        V=t("V") if "V" in arrays else None,
        gamma=t("gamma"), alpha=t("alpha"), mu=t("mu"),
        X_init=t("X_init") if "X_init" in arrays else None,
        seed=int(np.asarray(arrays["key"]).reshape(-1)[-1]),
        chol=None, Qbuf=None)


def state_to_arrays(state: RBCDState) -> dict:
    """The inverse codec: every persistable ``RBCDState`` field as host
    arrays, in the JAX package's names and types (``iteration`` int32,
    ``key = [0, seed]`` uint32); the recomputable factors are dropped —
    ``refresh_problem`` restores them bit for bit from the weights."""
    out = {"iteration": np.asarray(int(state.iteration), np.int32),
           "key": np.asarray([0, int(state.seed)], np.uint32)}
    for f in ("X", "weights", "rel_change", "ready", "gamma", "alpha", "mu",
              "V", "X_init"):
        v = getattr(state, f)
        if v is None:
            continue
        out[f] = v.detach().cpu().numpy()
    return out
