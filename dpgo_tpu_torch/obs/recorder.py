"""Solver flight recorder: bounded in-memory black box + deterministic replay.

A ``FlightRecorder`` rides a ``TelemetryRun`` (attach with
``FlightRecorder.attach(run)``) and records, at every ``run_rbcd`` eval
boundary, the scalars the driver already read back (cost, gradient norm,
GNC mu, inlier fraction, per-agent relative change) into a bounded ring
buffer, plus a time-down-sampled **exact** solver-state snapshot every
``snapshot_every`` evals (X, GNC weights, RNG keys, Nesterov aux state,
mu — everything ``RBCDState`` carries except the recomputable
preconditioner factors).  On an anomaly (``obs.health`` dump policy) or a
crash (``run_rbcd``'s driver loop) the recorder dumps:

* ``blackbox.npz`` — the replayable payload: ring columns, the retained
  snapshots, and (when the solve registered its problem) the full global
  measurement set, so the black box is self-contained;
* ``blackbox.jsonl`` — one context line (config fingerprint, encoded
  ``AgentParams``, RNG/seed bookkeeping, dump reason, snapshot index)
  followed by one line per retained ring record — greppable without numpy.

``python -m dpgo_tpu_torch.obs.recorder --replay <blackbox.npz>
[--device cpu]`` rebuilds the problem from the stored measurements,
resumes from the last *healthy* snapshot, re-runs the exact same schedule
segments (``models.rbcd.schedule_bounds`` + ``rbcd_segment``, the
programs the original driver dispatched; on the card in float32 every
local step is one launch of the B2 kernel), re-applies any recorded fault
injection (``inject_nan``), and checks the recomputed eval trajectory
against the recorded one bit-for-bit (NaNs compare positionally).  The
port's rounds are deterministic on the CPU and on the card, so a replay
on the device the box was recorded on reproduces it exactly; exit code
0 = reproduced, 1 = diverged, 2 = not replayable.

Zero-overhead fence: a recorder only ever exists attached to a live run
(telemetry off ⇒ ``run_rbcd`` never resolves one), and every device value
it persists goes through ``obs.materialize`` — the telemetry-off test
patches both ``FlightRecorder.__init__`` and ``materialize`` to throw.

The PyTorch port of ``dpgo_tpu.obs.recorder``, with the same npz/jsonl
layout: a black box the JAX package wrote replays here.  The port's
``RBCDState`` carries an ASYNC ``seed`` where the JAX package carries a
PRNG key; the snapshot stores it in the ``key`` slot as ``[0, seed]``
(``PRNGKey(seed)``'s layout), and a replay reads the seed back from the
key's last word.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import math
import os
import sys
import time
from collections import deque

import numpy as np

from .events import _jsonable, restore_nonfinite
from .run import get_run, materialize

BLACKBOX_NPZ = "blackbox.npz"
BLACKBOX_JSONL = "blackbox.jsonl"

#: Measurement array fields persisted into / restored from the npz.
_MEAS_FIELDS = ("r1", "p1", "r2", "p2", "R", "t", "kappa", "tau",
                "weight", "is_known_inlier")
#: RBCDState array fields captured per snapshot (None-able ones optional).
_STATE_FIELDS = ("X", "weights", "rel_change", "ready",
                 "gamma", "alpha", "mu")
_STATE_OPTIONAL = ("V", "X_init")


# ---------------------------------------------------------------------------
# Config (AgentParams) <-> JSON: generic frozen-dataclass / enum codec
# ---------------------------------------------------------------------------

def encode_config(obj):
    """JSON-encode a config object (nested frozen dataclasses + enums +
    scalars) so the black box can rebuild the exact ``AgentParams``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                "fields": {f.name: encode_config(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, enum.Enum):
        return {"__enum__": type(obj).__name__, "name": obj.name}
    if isinstance(obj, tuple):
        return {"__tuple__": [encode_config(x) for x in obj]}
    if isinstance(obj, list):
        return [encode_config(x) for x in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot encode config value of type {type(obj).__name__}")


def decode_config(data):
    """Inverse of ``encode_config``; resolves types from the port's
    ``config`` (the same dataclasses and enums as ``dpgo_tpu.config``)."""
    from .. import config as config_mod

    if isinstance(data, dict) and "__dataclass__" in data:
        cls = getattr(config_mod, data["__dataclass__"])
        return cls(**{k: decode_config(v)
                      for k, v in data["fields"].items()})
    if isinstance(data, dict) and "__enum__" in data:
        return getattr(config_mod, data["__enum__"])[data["name"]]
    if isinstance(data, dict) and "__tuple__" in data:
        return tuple(decode_config(x) for x in data["__tuple__"])
    if isinstance(data, list):
        return [decode_config(x) for x in data]
    return data


def dtype_name(dtype) -> str:
    """``"float64"`` for ``torch.float64`` (numpy's spelling, which the JAX
    package records)."""
    return str(dtype).replace("torch.", "")


def inject_nan(state, agent: int, pose: int):
    """The canonical NaN fault: corrupt one agent's pose block (the frame
    its neighbors consume on the next exchange).  Shared by the seeded
    fault-injection tests and ``replay`` so a recorded fault re-applies
    identically."""
    X = state.X.clone()
    X[int(agent), int(pose)] = float("nan")
    return state._replace(X=X)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded black box for one telemetry run (attach before solving)."""

    def __init__(self, run, capacity: int = 512, snapshot_every: int = 4,
                 max_snapshots: int = 4):
        self.run = run
        self.capacity = int(capacity)
        self.snapshot_every = max(int(snapshot_every), 1)
        self.ring: deque = deque(maxlen=self.capacity)
        self.snapshots: deque = deque(maxlen=max(int(max_snapshots), 1))
        self.context: dict = {}
        self._evals_since_snap: int | None = None  # None = no snapshot yet
        self._problem: dict | None = None
        self._dumped: str | None = None

    @classmethod
    def attach(cls, run=None, **kwargs) -> "FlightRecorder | None":
        """Create a recorder and install it as ``run.recorder`` (the handle
        ``run_rbcd`` and the health dump policy resolve).  Returns None with
        telemetry off."""
        run = get_run() if run is None else run
        if run is None:
            return None
        rec = cls(run, **kwargs)
        run.recorder = rec
        return rec

    # -- context / problem registration -------------------------------------

    def set_context(self, **fields) -> None:
        """Merge free-form context (fault specs, dataset names, seeds) into
        the black box's context line."""
        self.context.update({k: _jsonable(v) for k, v in fields.items()})

    def set_problem(self, part, meta, params, dtype, eval_every: int,
                    grad_norm_tol: float, max_iters: int) -> None:
        """Register the solve's problem so the dump is self-contained and
        replayable.  Called by ``run_rbcd`` when a recorder is attached;
        requires explicit ``params`` (a param-less solve is recorded but
        not replayable)."""
        meas = part.meas_global
        arrays = {f"meas_{f}": np.asarray(getattr(meas, f))
                  for f in _MEAS_FIELDS}
        arrays["part_n"] = np.asarray(part.n)
        self._problem = {
            "arrays": arrays,
            "meta": {
                "d": int(meas.d), "num_poses": int(meas.num_poses),
                "num_robots": int(part.num_robots),
                "dtype": dtype_name(dtype),
                "eval_every": int(eval_every),
                "grad_norm_tol": float(grad_norm_tol),
                "max_iters": int(max_iters),
                "params": encode_config(params) if params is not None else None,
                "replayable": params is not None,
            },
        }

    # -- recording -----------------------------------------------------------

    def record_eval(self, iteration: int, scalars: dict, state=None,
                    num_weight_updates: int = 0) -> None:
        """Append one eval-boundary record; snapshot the state on cadence.
        ``scalars`` values must already be host-side (the solve loop's
        existing readback) — only the optional state snapshot touches the
        device, through the ``materialize`` fence."""
        healthy = True
        rec = {"iteration": int(iteration)}
        for k, v in scalars.items():
            a = np.asarray(v)
            rec[k] = a if a.ndim else (float(a) if a.dtype.kind == "f"
                                       else a.item())
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                healthy = False
        rec["healthy"] = healthy
        self.ring.append(rec)
        if state is None:
            return
        if self._evals_since_snap is None \
                or self._evals_since_snap + 1 >= self.snapshot_every:
            self._snapshot(iteration, state, num_weight_updates, healthy)
            self._evals_since_snap = 0
        else:
            self._evals_since_snap += 1

    def snapshot_state(self, iteration: int, state, num_weight_updates: int,
                       healthy: bool = True) -> None:
        """Take one exact-state snapshot outside ``record_eval``'s
        cadence — the verdict-loop driver (``models.rbcd``'s
        ``verdict_every`` mode) snapshots at its K-round fetch boundaries,
        where the live state is on hand, while the per-eval scalar rows
        arrive separately through ``record_eval(state=None)`` from the
        lazily-fetched device history.  ``iteration`` must be an eval
        boundary present in the ring for the replay to align."""
        self._snapshot(iteration, state, num_weight_updates, bool(healthy))
        self._evals_since_snap = 0

    def _snapshot(self, iteration: int, state, num_weight_updates: int,
                  healthy: bool) -> None:
        arrays = {}
        for f in _STATE_FIELDS + _STATE_OPTIONAL:
            v = getattr(state, f)
            if v is None:
                continue
            arrays[f] = materialize(v)
        arrays["key"] = np.asarray([0, int(state.seed)], np.uint32)
        self.snapshots.append({
            "iteration": int(iteration),
            "num_weight_updates": int(num_weight_updates),
            "healthy": bool(healthy),
            "arrays": arrays,
        })

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, force: bool = False) -> str | None:
        """Write ``blackbox.npz`` + ``blackbox.jsonl`` under the run dir.
        First dump wins (an anomaly dump is not overwritten by the
        subsequent crash dump) unless ``force``."""
        if self._dumped is not None and not force:
            return os.path.join(self.run.run_dir, BLACKBOX_NPZ)
        arrays: dict = {}
        ring = list(self.ring)
        if ring:
            keys = sorted({k for r in ring for k in r} - {"healthy"})
            for k in keys:
                col = [r.get(k, np.nan) for r in ring]
                try:
                    arrays[f"ring_{k}"] = np.asarray(col)
                except ValueError:  # ragged (shape changed mid-run): skip
                    pass
            arrays["ring_healthy"] = np.asarray(
                [r["healthy"] for r in ring], bool)
        snap_meta = []
        for i, snap in enumerate(self.snapshots):
            snap_meta.append({k: snap[k] for k in
                              ("iteration", "num_weight_updates", "healthy")})
            for f, v in snap["arrays"].items():
                arrays[f"snap{i}_{f}"] = v
        problem_meta = None
        if self._problem is not None:
            arrays.update(self._problem["arrays"])
            problem_meta = self._problem["meta"]
        context = dict(self.context)
        context.update({
            "kind": "context",
            "run": self.run.run_id,
            "reason": str(reason),
            "t_wall": time.time(),
            "fingerprint": getattr(self.run, "fingerprint", {}),
            "snapshots": snap_meta,
            "problem": problem_meta,
            "replayable": bool(problem_meta and problem_meta["replayable"]),
        })
        npz_path = os.path.join(self.run.run_dir, BLACKBOX_NPZ)
        jsonl_path = os.path.join(self.run.run_dir, BLACKBOX_JSONL)
        with open(npz_path, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        with open(jsonl_path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(_jsonable(context)) + "\n")
            for r in ring:
                fh.write(json.dumps(_jsonable(
                    dict(r, kind="round"))) + "\n")
        self._dumped = str(reason)
        self.run.event("blackbox_dump", phase="health", reason=str(reason),
                       path=npz_path,
                       rounds_recorded=len(ring),
                       snapshots=len(snap_meta))
        return npz_path


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    snapshot_iteration: int
    iterations: list
    cost: list
    grad_norm: list
    recorded_cost: list
    recorded_grad_norm: list
    match: bool
    mismatches: list


def load_blackbox(npz_path: str) -> tuple[dict, dict]:
    """``(context, arrays)`` for a dumped black box.  The context comes
    from the sibling ``blackbox.jsonl`` (non-finite strings restored to
    floats)."""
    arrays = dict(np.load(npz_path, allow_pickle=False))
    jsonl = os.path.join(os.path.dirname(os.path.abspath(npz_path)),
                         BLACKBOX_JSONL)
    context = {}
    if os.path.exists(jsonl):
        with open(jsonl, encoding="utf-8") as fh:
            first = fh.readline().strip()
        if first:
            context = restore_nonfinite(json.loads(first))
    return context, arrays


def _bits_equal(a: float, b: float) -> bool:
    return (a == b) or (math.isnan(a) and math.isnan(b))


def replay(npz_path: str, snapshot: int | None = None, log=None,
           device="cuda") -> ReplayResult:
    """Resume from the black box's last healthy snapshot on ``device`` and
    recompute the recorded eval trajectory with the original schedule
    segments.

    Raises ``ValueError`` when the black box is not replayable (no problem
    registered / custom partition / missing snapshot)."""
    import torch

    from ..config import RobustCostType
    from ..device import resolve_device
    from ..models import rbcd
    from ..models.rbcd import RBCDState, build_graph, refresh_problem
    from ..types import Measurements, edge_set_from_measurements
    from ..utils.partition import partition_contiguous

    context, arrays = load_blackbox(npz_path)
    if not context.get("replayable"):
        raise ValueError(
            f"{npz_path} is not replayable: the recorded solve did not "
            "register its problem (run with an attached FlightRecorder and "
            "explicit AgentParams)")
    prob = context["problem"]
    dtype = getattr(torch, prob["dtype"])
    dev = resolve_device(device)

    params = decode_config(prob["params"])
    meas = Measurements(
        d=prob["d"], num_poses=prob["num_poses"],
        **{f: arrays[f"meas_{f}"] for f in _MEAS_FIELDS})
    part = partition_contiguous(meas, prob["num_robots"])
    if not np.array_equal(np.asarray(part.n), arrays["part_n"]):
        raise ValueError(
            "recorded partition does not match partition_contiguous — "
            "custom partitions are not replayable")
    graph, meta = build_graph(part, params.r, dtype, device=dev)

    snaps = context.get("snapshots") or []
    if not snaps:
        raise ValueError("black box holds no state snapshot")
    ring_it_all = arrays.get("ring_iteration")
    last_eval = int(np.asarray(ring_it_all).max()) \
        if ring_it_all is not None and np.asarray(ring_it_all).size else -1
    if snapshot is None:
        # Last GOOD snapshot that still has recorded evals after it — the
        # one the failure replays from.
        healthy = [i for i, s in enumerate(snaps)
                   if s["healthy"] and s["iteration"] < last_eval]
        snapshot = healthy[-1] if healthy else 0
    snap_meta = snaps[snapshot]
    sd = {f: arrays[f"snap{snapshot}_{f}"]
          for f in _STATE_FIELDS + _STATE_OPTIONAL + ("key",)
          if f"snap{snapshot}_{f}" in arrays}
    it0 = int(snap_meta["iteration"])
    nwu = int(snap_meta["num_weight_updates"])

    def t(name):
        if name not in sd:
            return None
        a = torch.from_numpy(np.array(sd[name]))
        return a.to(dev, dtype) if a.is_floating_point() else a.to(dev)

    state = RBCDState(
        X=t("X"), weights=t("weights"), iteration=it0,
        rel_change=t("rel_change"), ready=t("ready"), V=t("V"),
        gamma=t("gamma"), alpha=t("alpha"), mu=t("mu"),
        X_init=t("X_init"),
        seed=int(np.asarray(sd["key"]).reshape(-1)[-1]) if "key" in sd
        else 0)
    # Factors recompute exactly: the carried Cholesky is always the factor
    # of the live weights at the last refresh, which are the snapshot's
    # weights (see models.rbcd._rbcd_round's refresh schedule).
    state = refresh_problem(state, graph, meta, params)

    n_total = part.meas_global.num_poses
    num_meas = len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global, dtype=dtype,
                                         device=dev)
    central = rbcd._central_metrics_body(graph, edges_g, n_total, num_meas,
                                         telemetry=True)

    robust_on = params.robust.cost_type != RobustCostType.L2
    fault = context.get("fault")
    fault_applied = False
    targets_i, rec_cost, rec_gn = [], [], []
    ring_it = arrays.get("ring_iteration")
    if ring_it is not None:
        for j, ri in enumerate(np.asarray(ring_it).tolist()):
            if ri > it0:
                targets_i.append(int(ri))
                rec_cost.append(float(arrays["ring_cost"][j]))
                rec_gn.append(float(arrays["ring_grad_norm"][j]))
    if not targets_i:
        raise ValueError(
            f"no recorded evals after snapshot iteration {it0} to replay")

    it = it0
    out_cost, out_gn, mismatches = [], [], []
    for target, rc, rg in zip(targets_i, rec_cost, rec_gn):
        while it < target:
            uw, rs, end = rbcd.schedule_bounds(
                it, nwu, max_iters=prob["max_iters"],
                eval_every=prob["eval_every"], params=params,
                robust_on=robust_on, accel_on=params.acceleration)
            nwu += int(uw)
            state = rbcd.rbcd_segment(state, graph, end - it, meta, params,
                                      first_update_weights=uw,
                                      first_restart=rs)
            it = end
            if fault is not None and not fault_applied \
                    and it >= int(fault["iteration"]):
                state = inject_nan(state, fault["agent"], fault["pose"])
                fault_applied = True
        vec = rbcd._host_fetch(central(state.X, state.weights, state.ready,
                                       state.mu, state.rel_change))
        f, gn = float(vec[0]), float(vec[1])
        out_cost.append(f)
        out_gn.append(gn)
        if not (_bits_equal(f, rc) and _bits_equal(gn, rg)):
            mismatches.append({"iteration": it, "cost": f,
                               "recorded_cost": rc, "grad_norm": gn,
                               "recorded_grad_norm": rg})
        if log is not None:
            log(f"  iter {it}: cost {f!r} (recorded {rc!r}) "
                f"gn {gn!r} (recorded {rg!r})")
    return ReplayResult(
        snapshot_iteration=it0, iterations=targets_i,
        cost=out_cost, grad_norm=out_gn,
        recorded_cost=rec_cost, recorded_grad_norm=rec_gn,
        match=not mismatches, mismatches=mismatches)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.obs.recorder",
        description="Replay a solver black box (blackbox.npz) from its "
                    "last healthy snapshot and verify the recorded "
                    "trajectory reproduces bit-for-bit.")
    ap.add_argument("--replay", metavar="BLACKBOX_NPZ", required=True,
                    help="path to a dumped blackbox.npz (blackbox.jsonl "
                         "must sit beside it)")
    ap.add_argument("--snapshot", type=int, default=None,
                    help="snapshot index to resume from (default: last "
                         "healthy)")
    ap.add_argument("--device", default="cuda",
                    help="device to replay on (default cuda; the box "
                         "reproduces bit for bit on the device it was "
                         "recorded on)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable result")
    args = ap.parse_args(argv)
    try:
        res = replay(args.replay, snapshot=args.snapshot,
                     device=args.device,
                     log=None if args.json else
                     (lambda m: print(m, file=sys.stderr)))
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        print(f"replay failed: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(_jsonable(dataclasses.asdict(res))))
    else:
        verdict = "REPRODUCED bit-for-bit" if res.match else "DIVERGED"
        print(f"replay of {len(res.iterations)} evals from snapshot at "
              f"iteration {res.snapshot_iteration}: {verdict}")
        for m in res.mismatches[:5]:
            print(f"  iter {m['iteration']}: cost {m['cost']!r} != "
                  f"recorded {m['recorded_cost']!r}")
    return 0 if res.match else 1


if __name__ == "__main__":
    sys.exit(main())
