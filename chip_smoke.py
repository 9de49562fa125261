#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``dpgo_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA device (exits non-zero without one).  Builds the port's
CUDA kernel from ``dpgo_tpu_torch/csrc`` with ``nvcc``, holds each kernel
against its plain PyTorch version on the card, drives the main path — the
single-device JACOBI RBCD solve (``models.rbcd.prepare_problem`` +
``dispatch_prepared``) on the synthetic stand-in for sphere2500 (2500
poses, 4948 edges, 8 robots, rank 5, float32) — and times the kernels.

Each phase prints one JSON line; any failure raises.  The line before the
last is the kernel table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile`` adds a phase that
traces one more solve with ``torch.profiler`` (device busy share and the
kernels by device time).
"""

from __future__ import annotations

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
from dpgo_tpu_torch.models import rbcd  # noqa: E402
from dpgo_tpu_torch.ops import manifold, quadratic  # noqa: E402
from dpgo_tpu_torch.ops import rtr_kernel as rk  # noqa: E402
from dpgo_tpu_torch.utils.synthetic import make_measurements  # noqa: E402

#: The main path's problem: bench.py's synthetic sphere2500 stand-in.
N_POSES, NUM_LC, ROBOTS, RANK = 2500, 2449, 8, 5
MAX_ITERS, GRAD_TOL = 200, 0.1
#: Parity bounds on the card (float32; summation order differs between
#: the kernel and the plain version).
X_ATOL, STAT_RTOL, TRAJ_ATOL = 1e-4, 1e-4, 5e-4
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


def profile_solve(prob) -> dict:
    """Device busy share of one solve and its kernels by device time, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                     grad_norm_tol=GRAD_TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"rounds": res.iterations, "wall_s": wall,
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
        mdec_pose=4 * rk_, rk=rk_)


def _inputs_bytes(ops: dict, e_max: int, A: int) -> int:
    """Bytes of the edge payload rows the kernel reads (e_max per agent)
    plus every other operand, read once."""
    d = ops["trn"].shape[2]
    edge_bytes = A * e_max * 4 * (2 + d * d + d + 2)
    rest = sum(t.numel() * t.element_size() for key, t in ops.items()
               if key not in ("idx_i", "idx_j", "rot", "trn", "wk", "wt"))
    return edge_bytes + rest


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
    out_bytes = sum(t.numel() * t.element_size() for t in out)
    return (_inputs_bytes(ops, meta.e_max, meta.num_robots) + out_bytes,
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
    out_bytes = sum(t.numel() * t.element_size() for t in out)
    return (_inputs_bytes(ops, meta.e_max, meta.num_robots) + out_bytes,
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


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


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
        {"name": "tcg", "replaces": "pallas_tcg._tcg_kernel"}]})

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

    plain = AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                        solver=SolverParams(pallas_tcg=False))
    sk = rbcd.init_state(graph, meta, prob.X0, params)
    sp = rbcd.init_state(graph, meta, prob.X0, plain)
    for _ in range(10):
        sk = rbcd.rbcd_step(sk, graph, meta, params)
        sp = rbcd.rbcd_step(sp, graph, meta, plain)
    traj = float((sk.X - sp.X).abs().max())
    emit({"phase": "parity", "kernel": "rtr_full", "rounds": 10,
          "formulations": ["kernel", "ell"], "max_abs_dX": traj})
    check(traj <= TRAJ_ATOL, "kernel trajectory leaves the plain one")

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

    if "--profile" in sys.argv[1:]:
        emit({"phase": "profile", "card": card, **profile_solve(prob)})

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
