"""Round calibration of the port (counterpart of ``experiments/measure_r3.py``):
the throughput of fused RBCD rounds per benchmark configuration, and the
ablation of one sphere2500 round into the exchange plus gradient pass and
kernel B3 (``ops.rtr_kernel.rtr``).

    python -m dpgo_tpu_torch.experiments.measure_r3 [--device cpu] \\
        [sphere ablate 100k kitti city ais]

Each name prints one JSON line (default: ``sphere ablate``).  The datasets
are read from ``$DPGO_DATA`` (default: ``data/`` in the checkout).  Without
``sphere2500.g2o`` there, ``sphere`` and ``ablate`` run the synthetic
stand-in of ``bench.py:77-84`` (2500 poses, 4948 edges) and say so in
their ``source`` field; ``kitti``, ``city`` and ``ais`` raise
``FileNotFoundError`` naming the missing file.  Runs on CUDA unless
``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import AgentParams, Schedule
from ..device import resolve_device
from ..models import rbcd
from ..ops import quadratic
from ..ops import rtr_kernel as rk
from ..types import edge_set_from_measurements
from ..utils.g2o import read_g2o
from ..utils.partition import partition_contiguous
from ..utils.synthetic import make_measurements

DATA = Path(os.environ.get("DPGO_DATA",
                           Path(__file__).resolve().parents[2] / "data"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dataset(name: str):
    """The measurements of ``$DPGO_DATA/<name>.g2o``."""
    path = DATA / f"{name}.g2o"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing (set DPGO_DATA to the "
                                "directory of the g2o datasets)")
    return read_g2o(str(path))


def sphere_measurements():
    """sphere2500 when its file exists, else ``bench.py``'s synthetic
    stand-in of the same order; returns ``(meas, source)``."""
    try:
        return dataset("sphere2500"), "sphere2500.g2o"
    except FileNotFoundError:
        meas, _ = make_measurements(np.random.default_rng(0), n=2500, d=3,
                                    num_lc=2449, rot_noise=0.01,
                                    trans_noise=0.01)
        return meas, "synthetic stand-in (bench.py:77-84)"


def build(meas, A: int, r: int, dtype=torch.float32,
          schedule: str | None = None, device="cuda"):
    """The solver state, graph, metadata and params of one configuration
    at the chordal init."""
    dev = resolve_device(device)
    params = AgentParams(d=meas.d, r=r, num_robots=A,
                         schedule=Schedule[schedule] if schedule
                         else Schedule.JACOBI)
    part = partition_contiguous(meas, A)
    graph, meta = rbcd.build_graph(part, r, dtype, dev)
    X0 = rbcd.centralized_chordal_init(part, meta, graph, dtype)
    return rbcd.init_state(graph, meta, X0, params), graph, meta, params


def time_config(name: str, meas, A: int, r: int, rounds: int,
                schedule: str | None = None, trials: int = 3,
                device="cuda") -> dict:
    """Rounds per second of ``rounds`` fused rounds (``rbcd_steps``) from
    the chordal init, ``trials`` times, in float32."""
    state, graph, meta, params = build(meas, A, r, schedule=schedule,
                                       device=device)
    dev = state.X.device
    form = rbcd._formulation(meta, params, graph, state.X.dtype, dev)
    t0 = time.perf_counter()
    st = rbcd.rbcd_steps(state, graph, 1, meta, params)
    _sync(dev)
    first_s = time.perf_counter() - t0
    rbcd.rbcd_steps(st, graph, min(20, rounds), meta, params)  # warm
    _sync(dev)
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        rbcd.rbcd_steps(state, graph, rounds, meta, params)
        _sync(dev)
        rates.append(rounds / (time.perf_counter() - t0))
        log(f"[{name}] {rates[-1]:.1f} rounds/s")
    return {"config": name, "form": form, "n_max": meta.n_max,
            "e_max": meta.e_max, "s_max": meta.s_max, "first_round_s": first_s,
            "rounds": rounds, "rounds_per_s": rates,
            "median_rounds_per_s": float(np.median(rates))}


def sphere(device="cuda") -> dict:
    meas, source = sphere_measurements()
    return dict(time_config("sphere2500/8 r5", meas, 8, 5, 200,
                            device=device), source=source)


def kitti(device="cuda") -> dict:
    return time_config("kitti00/16 r3 async", dataset("kitti_00"), 16, 3,
                       200, schedule="ASYNC", device=device)


def city(device="cuda") -> dict:
    return time_config("city10000/32 r3", dataset("city10000"), 32, 3, 100,
                       device=device)


def synth100k(device="cuda") -> dict:
    """The 100k-pose synthetic configuration.  The JAX script's second
    line (bf16 selection) has no counterpart: the port's gathers are exact
    float32 loads."""
    meas, _ = make_measurements(np.random.default_rng(0), n=100000, d=3,
                                num_lc=20000, rot_noise=0.01,
                                trans_noise=0.01)
    return time_config("100k/64 r5", meas, 64, 5, 20, device=device)


def ais(device="cuda") -> dict:
    """ais2klinik, COLORED: throughput, then 50 colored sweeps and the
    number of sweeps that raised the cost (f32-relative tolerance)."""
    meas = dataset("ais2klinik")
    out = time_config("ais2klinik/32 r3 colored", meas, 32, 3, 200,
                      schedule="COLORED", device=device)
    state, graph, meta, params = build(meas, 32, 3, schedule="COLORED",
                                       device=device)
    part = partition_contiguous(meas, 32)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float32,
                                         device=state.X.device)
    costs = []
    for _ in range(50):
        state = rbcd.rbcd_steps(state, graph, meta.num_colors, meta, params)
        costs.append(float(quadratic.cost(
            rbcd.gather_to_global(state.X, graph, meas.num_poses), edges_g)))
    out.update(colors=meta.num_colors, cost_first=costs[0],
               cost_last=costs[-1],
               increases=sum(1 for a, b in zip(costs, costs[1:])
                             if b > a + 1e-6 * max(abs(a), 1.0)))
    return out


def ablate(meas=None, robots: int = 8, rank: int = 5, rounds: int = 200,
           device="cuda") -> dict:
    """One sphere2500 round taken apart (``experiments/measure_r3.py:102-
    222``), in float32: ms per round of ``rounds`` fused rounds
    (``rbcd_steps``); of the exchange plus the gradient pass alone
    (``rbcd.gradient_pass``); of one gradient pass plus ``rounds`` B3
    launches; and B3's per-agent stats from one launch at the start.

    The B3 launches are a timing ablation, not a solve: every launch gets
    the same g, S and neighbor buffers while X advances, as in the JAX
    script.  To read the times, the result also carries B2's attempts and
    tCG iterations per agent at the start and at the end of the fused
    rounds, and B3's attempts at its last launch.  ``b3_calls`` counts the
    calls of B3's wrapper (launches on CUDA, its plain version on CPU
    tensors)."""
    source = "caller"
    if meas is None:
        meas, source = sphere_measurements()
    state, graph, meta, params = build(meas, robots, rank, device=device)
    dev = state.X.device
    kw = rbcd.kernel_options(params, meta)
    kw.pop("grad_tol")  # B3 has no early exit
    X = state.X

    def timed(fn, n):
        fn(min(n, 1))  # warm
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(n)
        _sync(dev)
        return (time.perf_counter() - t0) / n * 1e3, out

    def b2_step(st):
        Z = rbcd.neighbor_buffer(rbcd.public_table(st.X, graph), graph)
        out = rk.rtr_full(*rbcd.kernel_operands(st.X, Z, graph.edges,
                                                st.chol, graph),
                          **rbcd.kernel_options(params, meta))
        return out.stats[:, 0].tolist(), out.tcg_iters.tolist()

    full_ms, end = timed(lambda n: rbcd.rbcd_steps(state, graph, n, meta,
                                                   params), rounds)

    def grad_rounds(n):
        x = X
        for _ in range(n):
            g, _, _ = rbcd.gradient_pass(x, graph, meta)
            x = x + 0.0 * g  # keep the dependency
        return x

    grad_ms, _ = timed(grad_rounds, rounds)
    b3_calls = 0

    def kernel_rounds(n):
        nonlocal b3_calls
        g, _, S = rbcd.gradient_pass(X, graph, meta)
        Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
        ops = list(rbcd.b3_operands(X, Z, g, S, graph.edges, state.chol,
                                    graph))
        for _ in range(n):
            out = rk.rtr(*ops, **kw)
            ops[6] = out.X
            b3_calls += 1
        return out

    kern_ms, last = timed(kernel_rounds, rounds)
    g, gn0, S = rbcd.gradient_pass(X, graph, meta)
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    res = rk.rtr(*rbcd.b3_operands(X, Z, g, S, graph.edges, state.chol,
                                   graph), **kw)
    b3_calls += 1
    (att0, it0), (att1, it1) = b2_step(state), b2_step(end)
    _sync(dev)
    log(f"[ablate] full {full_ms:.3f} ms/round, exchange+grad "
        f"{grad_ms:.3f}, grad+B3 {kern_ms:.3f}")
    return {"source": source, "device": str(dev), "poses": meas.num_poses,
            "edges": len(meas), "robots": robots, "rank": rank,
            "rounds": rounds, "full_ms_per_round": full_ms,
            "grad_ms_per_round": grad_ms,
            "grad_b3_ms_per_round": kern_ms,
            "b3_stats": res.stats.tolist(),
            "b3_tcg_iters": res.tcg_iters.tolist(),
            "b3_last_attempts": last.stats[:, 0].tolist(),
            "b2_attempts_start": att0, "b2_tcg_iters_start": it0,
            "b2_attempts_end": att1, "b2_tcg_iters_end": it1,
            "gn0": gn0.tolist(), "b3_calls": b3_calls}


RUNS = {"sphere": sphere, "kitti": kitti, "city": city, "100k": synth100k,
        "ablate": ablate, "ais": ais}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("runs", nargs="*", choices=sorted(RUNS),
                    default=["sphere", "ablate"])
    args = ap.parse_args(argv)
    for name in args.runs:
        print(json.dumps(RUNS[name](device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
