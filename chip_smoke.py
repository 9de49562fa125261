#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``dpgo_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA device (exits non-zero without one).  Builds the port's
CUDA kernels from ``dpgo_tpu_torch/csrc`` with ``nvcc``, holds each kernel
against its plain PyTorch version on the card, drives the two paths on the
synthetic stand-in for sphere2500 (2500 poses, 4948 edges, 8 robots, rank
5, float32) and times the kernels:

* ``solve`` — the single-device JACOBI RBCD solve
  (``models.rbcd.prepare_problem`` + ``dispatch_prepared``), kernel B2;
* ``refine`` — a float32 JACOBI descent to a fixed round count, then the
  re-centered terminal refinement (``models.refine.solve_refine``,
  accelerated, 3 cycles of 50 rounds towards an unreachable target) from
  the float64 handoff iterate, kernel B4 once per refine round.

Each phase prints one JSON line; any failure raises.  The line before the
last is the kernel table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile`` adds phases that trace
one more solve and one more refine cycle with ``torch.profiler`` (device
busy share and the kernels by device time).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from dpgo_tpu_torch.config import AgentParams, SolverParams  # noqa: E402
from dpgo_tpu_torch.models import rbcd, refine  # noqa: E402
from dpgo_tpu_torch.ops import manifold, quadratic  # noqa: E402
from dpgo_tpu_torch.ops import rtr_kernel as rk  # noqa: E402
from dpgo_tpu_torch.utils import partition  # noqa: E402
from dpgo_tpu_torch.utils.synthetic import make_measurements  # noqa: E402

#: The main path's problem: bench.py's synthetic sphere2500 stand-in.
N_POSES, NUM_LC, ROBOTS, RANK = 2500, 2449, 8, 5
MAX_ITERS, GRAD_TOL = 200, 0.1
#: The refine path (bench_convergence.py's settings: tight local solves,
#: no consensus stop): descent rounds, then cycles of refine rounds.
DESCENT_ROUNDS, REFINE_CYCLES, ROUNDS_PER_CYCLE = 300, 3, 50
#: Parity bounds on the card (float32; summation order differs between
#: the kernel and the plain version).
X_ATOL, STAT_RTOL, TRAJ_ATOL = 1e-4, 1e-4, 5e-4
#: Card-side chordal inits whose B2 trajectory readings are recorded.
TRAJ_CARD_STARTS = 3
#: B4 parity: the correction's change relative to the step's own size, and
#: the cost increments relative to their largest magnitude (both are small
#: differences of float32 sums taken in another order).
D_STEP_RTOL, DF_RTOL, D_TRAJ_RTOL = 1e-3, 1e-3, 1e-2
#: Published H100 SXM peaks (dense FP32 outside the tensor cores; HBM3).
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int = 1, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()``: the median over ``reps`` runs of
    ``inner`` back-to-back calls between two CUDA events, divided by
    ``inner`` (back to back, the host's launch work overlaps the device's
    execution instead of adding to it)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def profile_run(fn) -> dict:
    """Device busy share of ``fn()`` and its kernels by device time, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rounds = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"rounds": rounds, "wall_s": wall,
            "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "device_kernels": len(rows),
            "top": [{"name": k[:60], "device_ms": t / 1e3, "calls": c}
                    for k, t, c in rows[:8]]}


# ---------------------------------------------------------------------------
# Work of one launch, for the bound: each input read once, each output
# written once, and the arithmetic these inputs need (the tCG iterations
# and attempts this run's data took).  Operations count a multiply and an
# add each.
# ---------------------------------------------------------------------------

def _unit_ops(r: int, d: int) -> dict:
    k, rk_ = d + 1, r * (d + 1)
    tproj = 4 * r * d * d + d * d
    precond = 2 * r * k * k + tproj
    edge_res = r * (2 * d * d + 2 * d + 2)
    return dict(
        sweep_edge=edge_res + r * (2 * d * d + 4 * d + 3),
        cost_edge=edge_res + 2 * r * k + 4,
        hess_pose=2 * r * d * d + tproj + 8 * rk_,
        update_pose=12 * rk_ + precond,
        init_pose=precond + 4 * rk_,
        retract_pose=4 * r * d * d + 2 * r + 24 * (6 * d ** 3 + 2 * d * d),
        start_pose=2 * r * d * d + d * d + tproj + 2 * rk_,
        mdec_pose=4 * rk_, rk=rk_,
        # The refine kernel: the re-centered start (S1, S, g, |g|^2, Y),
        # the radius' preconditioner pass, the cost increment (cross and
        # quadratic terms) and the polar-correction series.
        refine_start_pose=8 * r * d * d + 2 * d * d + 5 * rk_,
        refine_radius_pose=precond + 2 * rk_,
        refine_cost_edge=edge_res + 4 * r * k + 6,
        refine_retract_pose=rk_ + 8 * r * d * d + r * d + d * d
        + 6 * d ** 3 + 7 * d * d)


#: Operands and outputs by what their padded slots hold: per-edge rows
#: (``[A, nt, c, T]``), pose columns (``[A, c, n_max]``), neighbor-slot
#: columns (``[A, c, s_max]``) and the ELL incidence (``[A, n_max, K]``).
EDGE_KEYS = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "rho_rot",
             "rho_trn")
POSE_KEYS = ("Xc", "Rc", "Dc", "g0c", "Grefc", "S0c", "Lc", "Sc", "gc", "X",
             "D", "eta", "heta")
SLOT_KEYS = ("Zc", "Dzc")
INC_KEYS = ("inc_slot", "inc_mask")


def live_bytes(tensors: dict, graph) -> int:
    """Bytes of ``tensors`` the function must move: edge rows at the live
    edges, pose columns at the agents' own poses, slot columns at the live
    neighbor slots, the incidence at its live entries; per-agent values
    (counts, radii, stats) whole.  Padding is no data."""
    live = {EDGE_KEYS: graph.edges.mask.sum(), POSE_KEYS: graph.n.sum(),
            SLOT_KEYS: graph.nbr_mask.sum(), INC_KEYS: graph.inc_mask.sum()}
    total = 0
    for key, t in tensors.items():
        group = next((g for g in live if key in g), None)
        if group is None:
            total += t.numel() * t.element_size()
        else:
            rows = 1 if group is INC_KEYS else t.shape[-2]
            total += int(live[group].item()) * rows * t.element_size()
    return total


def rtr_full_work(ops: dict, out, graph, meta) -> tuple[int, int]:
    u = _unit_ops(meta.rank, meta.d)
    E = graph.edges.mask.sum(1).double()
    inc = graph.inc_mask.sum((1, 2)).double()
    n = graph.n.double()
    iters = out.tcg_iters.double()
    att = out.stats[:, 0].double()
    sweep = E * u["sweep_edge"] + inc * u["rk"]
    flops = (sweep + n * u["start_pose"] + E * u["cost_edge"]
             + att * (n * (u["init_pose"] + u["retract_pose"]
                           + u["mdec_pose"]) + E * u["cost_edge"])
             + iters * (sweep + n * (u["hess_pose"] + u["update_pose"])))
    return (live_bytes(ops, graph) + live_bytes(out._asdict(), graph),
            int(flops.sum().item()))


def tcg_work(ops: dict, out, graph, meta) -> tuple[int, int]:
    u = _unit_ops(meta.rank, meta.d)
    E = graph.edges.mask.sum(1).double()
    inc = graph.inc_mask.sum((1, 2)).double()
    n = graph.n.double()
    iters = out.stats[:, 0].double()
    sweep = E * u["sweep_edge"] + inc * u["rk"]
    flops = n * u["init_pose"] + iters * (
        sweep + n * (u["hess_pose"] + u["update_pose"]))
    return (live_bytes(ops, graph) + live_bytes(out._asdict(), graph),
            int(flops.sum().item()))


def rtr_refine_full_work(ops: dict, out, graph, meta) -> tuple[int, int]:
    u = _unit_ops(meta.rank, meta.d)
    E = graph.edges.mask.sum(1).double()
    inc = graph.inc_mask.sum((1, 2)).double()
    n = graph.n.double()
    iters = out.tcg_iters.double()
    att = out.stats[:, 0].double()
    sweep = E * u["sweep_edge"] + inc * u["rk"]
    flops = (sweep + n * (u["refine_start_pose"] + u["refine_radius_pose"])
             + E * u["refine_cost_edge"]
             + att * (n * (u["init_pose"] + u["refine_retract_pose"]
                           + u["mdec_pose"]) + E * u["refine_cost_edge"])
             + iters * (sweep + n * (u["hess_pose"] + u["update_pose"])))
    return (live_bytes(ops, graph) + live_bytes(out._asdict(), graph),
            int(flops.sum().item()))


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------

def round_operands(prob, params):
    """One round's kernel operands at the chordal init (the first round of
    the main path), plus the tCG operands S and g at the same point."""
    graph, meta, X = prob.graph, prob.meta, prob.X0
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    chol = rbcd.precond_chol(graph.edges, meta.n_max, meta.s_max, params)
    args = rbcd.kernel_operands(X, Z, graph.edges, chol, graph)
    ops = dict(zip(("idx_i", "idx_j", "rot", "trn", "wk", "wt", "Xc", "Zc",
                    "Lc", "inc_slot", "inc_mask", "n_local"), args))
    eg = quadratic.egrad_ell(torch.cat([X, Z], dim=1), graph.edges,
                             graph.inc_slot, graph.inc_mask)
    d = meta.d
    S = manifold.sym(X[..., :d].transpose(-1, -2) @ eg[..., :d])
    tcg_ops = dict((k, ops[k]) for k in ("idx_i", "idx_j", "rot", "trn",
                                         "wk", "wt", "Xc"))
    tcg_ops.update(
        Sc=S.permute(0, 2, 3, 1).reshape(meta.num_robots, d * d, -1)
        .contiguous(), Lc=ops["Lc"],
        gc=rk.comp_major(manifold.rgrad(X, eg)),
        radius=torch.ones(meta.num_robots, device=X.device),
        inc_slot=ops["inc_slot"], inc_mask=ops["inc_mask"])
    return ops, tcg_ops


def trajectory_gap(X0, graph, meta, params, plain, chol=None,
                   rounds: int = 10) -> float:
    """Max |ΔX| after ``rounds`` JACOBI rounds from ``X0`` through the
    kernel (``params``) and through the "ell" formulation (``plain``);
    ``chol`` replaces the preconditioner factors ``init_state`` makes."""
    sk = rbcd.init_state(graph, meta, X0, params)
    sp = rbcd.init_state(graph, meta, X0, plain)
    if chol is not None:
        sk, sp = sk._replace(chol=chol), sp._replace(chol=chol)
    for _ in range(rounds):
        sk = rbcd.rbcd_step(sk, graph, meta, params)
        sp = rbcd.rbcd_step(sp, graph, meta, plain)
    return float((sk.X - sp.X).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


REFINE_ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "rho_rot",
                "rho_trn", "Rc", "Dc", "Dzc", "g0c", "Grefc", "S0c", "Lc",
                "inc_slot", "inc_mask", "n_local")


def refine_operands(D, consts, graph) -> dict:
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, graph), graph)
    return dict(zip(REFINE_ORDER,
                    refine.refine_kernel_operands(D, Dz, consts, graph)))


def refine_parity(ops: dict, kw: dict) -> tuple[dict, object]:
    """B4 against its plain version on one refine round's operands."""
    out = rk.rtr_refine_full(*ops.values(), **kw)
    ref = rk.rtr_refine_full_reference(*ops.values(), **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.D).all() and torch.isfinite(out.stats)
               .all()), "rtr_refine_full returned non-finite values")
    step = float((ref.D - ops["Dc"]).abs().max())
    err_d = float((out.D - ref.D).abs().max())
    df = ref.stats[:, 2:4]
    row = {"max_abs_dD": err_d, "max_abs_step": step,
           "rel_dD": err_d / max(step, 1e-30),
           "stat_flips": int((out.stats[:, :2] != ref.stats[:, :2]).any(1)
                             .sum()),
           "rel_d_df0_df": float((out.stats[:, 2:4] - df).abs().max()
                                 / df.abs().max().clamp(min=1e-30)),
           "rel_d_gn0": rel_err(out.stats[:, 4], ref.stats[:, 4]),
           "attempts": out.stats[:, 0].tolist(),
           "tcg_iters": out.tcg_iters.tolist()}
    check(row["stat_flips"] == 0 and row["rel_dD"] <= D_STEP_RTOL
          and row["rel_d_df0_df"] <= DF_RTOL
          and row["rel_d_gn0"] <= STAT_RTOL,
          "rtr_refine_full kernel disagrees with its plain version")
    return row, out


def gradnorm64(X64: np.ndarray, e64) -> float:
    """The f64 central gradient norm of a projected global iterate."""
    return refine.central_gradnorm64(X64, e64, len(X64), 3)


def refine_phase(prob, meas, card: str, profile: bool) -> list:
    """The refine path, counted, its parity checks on the card, B4's
    timing, and (``profile``) one traced refine cycle.  Returns B4's row
    of the kernel table."""
    dev = prob.graph.global_index.device
    rparams = AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                          rel_change_tol=0.0,
                          solver=SolverParams(grad_norm_tol=1e-9))
    rprob = dataclasses.replace(prob, params=rparams)
    graph, meta = rprob.graph, rprob.meta
    edges64 = refine.host_edges_f64(meas)
    e64 = refine.np_edges_batched(edges64)

    # --- the path, counted: descent, handoff, refinement ------------------
    rk.LAUNCHES = 0
    rk.REFINE_LAUNCHES = 0
    refine.ROUNDS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.dispatch_prepared(rprob, max_iters=DESCENT_ROUNDS,
                                 grad_norm_tol=0.0,
                                 eval_every=DESCENT_ROUNDS)
    t1 = time.perf_counter()
    Xg64 = rbcd.gather_to_global(res.X, graph, N_POSES).double().cpu() \
        .numpy()
    f_hand = refine.global_cost(refine._np_project_manifold(Xg64, 3),
                                edges64)
    verified = []  # the iterate of every verify pass, handoff first
    t2 = time.perf_counter()
    X64, gap, cycles, hist = refine.solve_refine(
        Xg64, graph, meta, rparams, edges64, f_opt=f_hand, rel_gap=-1.0,
        rounds_per_cycle=ROUNDS_PER_CYCLE, max_cycles=REFINE_CYCLES,
        accel=True, on_verify=verified.append)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"rtr_full": rk.LAUNCHES, "rtr_refine_full":
                rk.REFINE_LAUNCHES}
    rounds = refine.ROUNDS
    f_final = refine.global_cost(X64, edges64)
    check(len(verified) == len(hist),
          "solve_refine did not report every verify pass")
    YY = X64[..., :3]
    orth = float(np.abs(np.swapaxes(YY, -1, -2) @ YY - np.eye(3)).max())
    emit({"phase": "refine", "poses": N_POSES, "robots": ROBOTS,
          "rank": RANK, "dtype": "float32",
          "descent_rounds": res.iterations, "refine_cycles": cycles,
          "refine_rounds": rounds, "launches": launches,
          "f64_cost_handoff": f_hand, "f64_cost_final": f_final,
          "f64_cost_per_verify": [refine.global_cost(V, edges64)
                                  for V in verified],
          "central_gradnorm64_per_verify": [gradnorm64(V, e64)
                                            for V in verified],
          "rel_drop": (f_hand - f_final) / f_hand, "max_orth_err": orth,
          "descent_s": t1 - t0, "setup_s": t2 - t1, "refine_s": t3 - t2,
          "s_per_refine_round": (t3 - t2) / max(rounds, 1)})
    check(res.iterations == DESCENT_ROUNDS
          and launches["rtr_full"] == DESCENT_ROUNDS,
          "the descent did not launch B2 once per round")
    check(rounds > 0 and rounds % ROUNDS_PER_CYCLE == 0,
          "the refinement did not run whole cycles")
    check(launches["rtr_refine_full"] == rounds > 0,
          "the refinement did not launch B4 once per refine round")
    check(bool(np.isfinite(X64).all()) and X64.shape == (N_POSES, RANK, 4),
          "the refined iterate is malformed")
    check(f_final < f_hand, "refinement did not lower the f64 cost")
    check(orth <= 1e-8, "the refined iterate left the manifold")

    # --- parity on the card -----------------------------------------------
    kw = rbcd.kernel_options(rparams, meta)
    ref = refine.recenter(Xg64, graph, meta, rparams, edges64)
    D0 = torch.zeros_like(ref.consts.R)
    D = refine.refine_rounds(D0, ref.consts, graph, meta, rparams, 3)
    ops = refine_operands(D, ref.consts, graph)
    row, out = refine_parity(ops, kw)
    emit({"phase": "parity", "kernel": "rtr_refine_full", "agents": ROBOTS,
          **row})
    err_d = row["max_abs_dD"]

    part1 = partition.partition_contiguous(meas, 1)
    g1, m1 = rbcd.build_graph(part1, RANK, torch.float32, dev)
    ref1 = refine.recenter(Xg64, g1, m1, rparams, edges64)
    ops1 = refine_operands(torch.zeros_like(ref1.consts.R), ref1.consts, g1)
    row1, _ = refine_parity(ops1, rbcd.kernel_options(rparams, m1))
    emit({"phase": "parity", "kernel": "rtr_refine_full", "agents": 1,
          "e_max": m1.e_max, "payload_bytes": m1.e_max * 144, **row1})

    plain = dataclasses.replace(rparams, solver=dataclasses.replace(
        rparams.solver, pallas_tcg=False))
    Dk, De = D0, D0
    for _ in range(10):
        Dk = refine.refine_round(Dk, ref.consts, graph, meta, rparams)[0]
        De = refine.refine_round(De, ref.consts, graph, meta, plain)[0]
    traj = float((Dk - De).abs().max())
    scale = float(De.abs().max())
    emit({"phase": "parity", "kernel": "rtr_refine_full", "rounds": 10,
          "formulations": ["kernel", "ell"], "max_abs_dD": traj,
          "max_abs_D": scale})
    check(traj <= D_TRAJ_RTOL * scale,
          "the refine kernel's rounds leave the plain formulation's")

    # --- timing at the slice shape -----------------------------------------
    ms = cuda_ms(lambda: rk.rtr_refine_full(*ops.values(), **kw), reps=20,
                 inner=10)
    plain_ms = cuda_ms(
        lambda: rk.rtr_refine_full_reference(*ops.values(), **kw), reps=5,
        warmup=1)
    nbytes, flops = rtr_refine_full_work(ops, out, graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    emit({"phase": "timing", "card": card, "kernel": "rtr_refine_full",
          "ms": ms, "plain_ms": plain_ms, "ctas": ROBOTS})
    if profile:
        def cycle():
            refine.refine_rounds_accel(D0, ref.consts, graph, meta, rparams,
                                       ROUNDS_PER_CYCLE)
            return ROUNDS_PER_CYCLE
        emit({"phase": "profile", "path": "refine", "card": card,
              **profile_run(cycle)})
    return {"name": "rtr_refine_full", "route": "cuda",
            "source": "dpgo_tpu_torch/csrc/rtr_full.cu",
            "replaces": "dpgo_tpu/ops/pallas_tcg.py:715",
            "launches": launches["rtr_refine_full"], "max_abs_err": err_d,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "bytes": nbytes,
            "flops": flops}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib_path = rk.build()
    rk.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "library": lib_path.name,
          "ptxas": [ln.strip() for ln in rk.BUILD_LOG.splitlines()
                    if "registers" in ln or "spill" in ln]})
    emit({"phase": "kernels", "kernels": [
        {"name": "rtr_full", "replaces": "pallas_tcg._rtr_full_kernel"},
        {"name": "tcg", "replaces": "pallas_tcg._tcg_kernel"},
        {"name": "rtr_refine_full",
         "replaces": "pallas_tcg._rtr_refine_full_kernel"}]})

    # --- parity: each kernel against its plain version, same inputs ----
    meas = make_measurements(np.random.default_rng(0), n=N_POSES, d=3,
                             num_lc=NUM_LC, rot_noise=0.01,
                             trans_noise=0.01)[0]
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS)
    prob = rbcd.prepare_problem(meas, ROBOTS, params, device=dev)
    graph, meta = prob.graph, prob.meta
    ops, tcg_ops = round_operands(prob, params)
    kw = rbcd.kernel_options(params, meta)
    out = rk.rtr_full(*ops.values(), **kw)
    ref = rk.rtr_full_reference(*ops.values(), **kw)
    torch.cuda.synchronize()
    err_x = float((out.X - ref.X).abs().max())
    flips = int((out.stats[:, :2] != ref.stats[:, :2]).any(1).sum())
    err_stats = rel_err(out.stats[:, 2:], ref.stats[:, 2:])
    iter_flips = int((out.tcg_iters != ref.tcg_iters).sum())
    emit({"phase": "parity", "kernel": "rtr_full", "max_abs_dX": err_x,
          "stat_flips": flips, "tcg_iter_flips": iter_flips,
          "max_rel_d_f0_f_gn0": err_stats,
          "attempts": out.stats[:, 0].tolist(),
          "tcg_iters": out.tcg_iters.tolist()})
    check(bool(torch.isfinite(out.X).all() and torch.isfinite(out.stats)
               .all()), "rtr_full kernel returned non-finite values")
    check(err_x <= X_ATOL and flips == 0 and err_stats <= STAT_RTOL,
          "rtr_full kernel disagrees with its plain version")

    tkw = dict(r=meta.rank, d=meta.d, e_max=meta.e_max,
               max_iters=params.solver.max_inner_iters,
               kappa=params.solver.tcg_kappa, theta=params.solver.tcg_theta)
    tcg_err = 0.0
    for radius in (0.05, 1.0, 100.0):
        tcg_ops["radius"] = torch.full((ROBOTS,), radius, device=dev)
        tout = rk.tcg(*tcg_ops.values(), **tkw)
        tref = rk.tcg_reference(*tcg_ops.values(), **tkw)
        torch.cuda.synchronize()
        e_eta = float((tout.eta - tref.eta).abs().max())
        # Heta carries the Hessian's scale (edge precisions summed over a
        # pose's degree): its float32 summation-order error is relative.
        e_heta = float((tout.heta - tref.heta).abs().max()
                       / tref.heta.abs().max().clamp(min=1e-30))
        tflips = int((tout.stats != tref.stats).any(1).sum())
        tcg_err = max(tcg_err, e_eta)
        emit({"phase": "parity", "kernel": "tcg", "radius": radius,
              "max_abs_d_eta": e_eta, "max_rel_d_heta": e_heta,
              "stat_flips": tflips, "iters": tout.stats[:, 0].tolist()})
        check(e_eta <= X_ATOL and e_heta <= STAT_RTOL and tflips == 0,
              "tcg kernel disagrees with its plain version")

    # 10 rounds through B2 against the "ell" formulation.  The check starts
    # from the chordal init and the preconditioner factors computed on the
    # host, which are the same in every run, so its reading repeats.  The
    # card's own chordal init and factors, summed by index_add_, differ
    # from run to run (ROADMAP Queue C): the readings from a few of those
    # starts are recorded beside their distance from the host's.
    plain = AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                        solver=SolverParams(pallas_tcg=False))
    host = rbcd.prepare_problem(meas, ROBOTS, params, dtype=torch.float32,
                                device="cpu")
    X0_host = host.X0.to(dev)
    chol_host = rbcd.precond_chol(host.graph.edges, meta.n_max, meta.s_max,
                                  params).to(dev)
    traj = [trajectory_gap(X0_host, graph, meta, params, plain, chol_host)
            for _ in range(2)]
    card_starts = []
    for _ in range(TRAJ_CARD_STARTS):
        X0c = rbcd.centralized_chordal_init(prob.part, meta, graph,
                                            torch.float32)
        card_starts.append({
            "max_abs_dX0": float((X0c - X0_host).abs().max()),
            "max_abs_dX": trajectory_gap(X0c, graph, meta, params, plain)})
    emit({"phase": "parity", "kernel": "rtr_full", "rounds": 10,
          "formulations": ["kernel", "ell"], "start": "host chordal init",
          "max_abs_dX": traj[0], "repeat_max_abs_dX": traj[1],
          "card_starts": card_starts})
    check(max(traj) <= TRAJ_ATOL, "kernel trajectory leaves the plain one")

    # --- the main path, counted ------------------------------------------
    rk.LAUNCHES = 0
    rk.TCG_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob = rbcd.prepare_problem(meas, ROBOTS, params, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                 grad_norm_tol=GRAD_TOL)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"rtr_full": rk.LAUNCHES, "tcg": rk.TCG_LAUNCHES}
    costs = res.cost_history
    emit({"phase": "solve", "poses": N_POSES, "edges": len(meas),
          "robots": ROBOTS, "rank": RANK, "dtype": "float32",
          "iterations": res.iterations, "terminated_by": res.terminated_by,
          "cost_first": costs[0], "cost_final": costs[-1],
          "grad_norm_final": res.grad_norm_history[-1],
          "setup_s": t1 - t0, "solve_s": t2 - t1,
          "rounds_per_s": res.iterations / (t2 - t1),
          "launches": launches})
    check(res.T.shape == (N_POSES, 3, 4) and bool(torch.isfinite(res.T)
                                                   .all()),
          "the rounded trajectory is malformed")
    check(bool(np.isfinite(costs).all()
               and np.isfinite(res.grad_norm_history).all()),
          "non-finite cost or gradient norm")
    check(costs[-1] <= costs[0] and costs[-1] <= costs[-2] * (1 + 1e-6),
          "cost rose at the end")
    check(launches["rtr_full"] == res.iterations > 0,
          "the solve did not launch the kernel once per round")

    # --- timing at the slice shape ---------------------------------------
    out = rk.rtr_full(*ops.values(), **kw)
    rows = []
    ms = cuda_ms(lambda: rk.rtr_full(*ops.values(), **kw), reps=20,
                 inner=10)
    plain_ms = cuda_ms(lambda: rk.rtr_full_reference(*ops.values(), **kw),
                       reps=5, warmup=1)
    nbytes, flops = rtr_full_work(ops, out, graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    rows.append({"name": "rtr_full", "route": "cuda",
                 "source": "dpgo_tpu_torch/csrc/rtr_full.cu",
                 "replaces": "dpgo_tpu/ops/pallas_tcg.py:662",
                 "launches": launches["rtr_full"], "max_abs_err": err_x,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "bytes": nbytes, "flops": flops})
    tcg_ops["radius"] = torch.ones(ROBOTS, device=dev)
    tout = rk.tcg(*tcg_ops.values(), **tkw)
    t_ms = cuda_ms(lambda: rk.tcg(*tcg_ops.values(), **tkw), reps=20,
                   inner=10)
    t_plain = cuda_ms(lambda: rk.tcg_reference(*tcg_ops.values(), **tkw),
                      reps=5, warmup=1)
    nbytes, flops = tcg_work(tcg_ops, tout, graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    rows.append({"name": "tcg", "route": "cuda",
                 "source": "dpgo_tpu_torch/csrc/rtr_full.cu",
                 "replaces": "dpgo_tpu/ops/pallas_tcg.py:599",
                 "launches": launches["tcg"], "max_abs_err": tcg_err,
                 "ms": t_ms, "plain_ms": t_plain, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "bytes": nbytes, "flops": flops})
    emit({"phase": "timing", "card": card, "agents": ROBOTS,
          "n_max": meta.n_max, "e_max": meta.e_max,
          "rtr_full_ms": ms, "rtr_full_plain_ms": plain_ms,
          "tcg_ms": t_ms, "tcg_plain_ms": t_plain,
          "ctas": ROBOTS, "sms": torch.cuda.get_device_properties(0)
          .multi_processor_count})

    profile = "--profile" in sys.argv[1:]
    if profile:
        def solve():
            return rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                          grad_norm_tol=GRAD_TOL).iterations
        emit({"phase": "profile", "path": "solve", "card": card,
              **profile_run(solve)})

    rows.append(refine_phase(prob, meas, card, profile))

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
