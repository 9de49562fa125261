"""Kernel B2 at BASELINE.md config #5 on the card, timed whole and taken
apart by the kernel's own bounds, beside the workspace route.

    python -m dpgo_tpu_torch.experiments.spread_timing
    python -m dpgo_tpu_torch.experiments.spread_timing --copies A B

Config #5 is 100,000 poses over 64 robots (``make_measurements_vectorized``,
seed 11, noise 0.05, 20,000 loop closures, rank 5, float32): agents of
1,594 poses, above the cluster ceiling, so B2 takes the spread route
(``csrc/rtr_spread.cu``).  The run solves 12 rounds from the odometry init
through ``rbcd.solve_rbcd`` (verdict loop, K = 4), then at the terminal
iterate prints one JSON line: B2 against its plain version (max |ΔX|, tCG
iterations and accept decisions equal), and ms per launch between CUDA
events of B2 as planned (``b2_ms``), with ``grad_tol`` 1e30 (the setup and
the start sweep alone, ``b2_exit_ms``), with one attempt of at most 1, 3
and 10 tCG iterations (``b2_iters<m>_rej1_ms``: the slope is the time of a
tCG iteration, the rest one attempt's fixed part), and on the workspace
route (``b2_ws_ms``).

``--copies`` times other copies of the package in turns (A, B, B, A), each
in its own process with its own kernel build: each argument is a
directory holding a ``dpgo_tpu_torch`` package (a checkout, or a copy with
another ``csrc/rtr_spread.cu``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

#: BASELINE.md config #5, and the rounds and K of the solve before the
#: measurement.
POSES, ROBOTS, SEED, NOISE, LC_SHARE, RANK = 100_000, 64, 11, 0.05, 0.2, 5
ROUNDS, K = 12, 4


def cuda_ms(fn, reps: int = 7, inner: int = 5, warmup: int = 2) -> float:
    """Median ms per call of ``fn()`` over ``reps`` runs of ``inner``
    back-to-back calls between two CUDA events."""
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


def measure() -> dict:
    """The JSON row of this process's package (see the module
    docstring)."""
    from dpgo_tpu_torch.config import AgentParams
    from dpgo_tpu_torch.models import rbcd
    from dpgo_tpu_torch.ops import rtr_kernel as rk
    from dpgo_tpu_torch.utils.partition import partition_contiguous
    from dpgo_tpu_torch.utils.synthetic import make_measurements_vectorized

    if not torch.cuda.is_available():
        raise RuntimeError("spread_timing measures the card; no CUDA device")
    dev = torch.device("cuda")
    meas = make_measurements_vectorized(
        np.random.default_rng(SEED), POSES, d=3, num_lc=int(LC_SHARE * POSES),
        rot_noise=NOISE, trans_noise=NOISE)[0]
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0)
    part = partition_contiguous(meas, ROBOTS)
    res = rbcd.solve_rbcd(meas, ROBOTS, params, max_iters=ROUNDS,
                          grad_norm_tol=0.0, part=part, init="odometry",
                          verdict_every=K, device=dev)
    prob = rbcd.prepare_problem(meas, ROBOTS, params, dtype=torch.float32,
                                part=part, init=None, device=dev)
    g, m, X = prob.graph, prob.meta, res.state.X
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
    ops = rbcd.kernel_operands(X, Z, g.edges, res.state.chol, g)
    kw = rbcd.kernel_options(params, m)
    out = rk.rtr_full(*ops, **kw)
    ref = rk.rtr_full_reference(*ops, **kw)
    torch.cuda.synchronize()
    row = {"device": torch.cuda.get_device_name(0),
           "plan": rk._route(None, m.n_max, m.e_max, ops[9].shape[-1],
                             RANK, 3, "rtr_full", agents=ROBOTS,
                             sms=rk.sm_count(dev))._asdict(),
           "dX": float((out.X - ref.X).abs().max()),
           "iters_equal": bool(torch.equal(out.tcg_iters, ref.tcg_iters)),
           "stats_equal": bool(torch.equal(out.stats[:, :2],
                                           ref.stats[:, :2]))}

    def ms(**opts):
        return cuda_ms(lambda: rk.rtr_full(*ops, **{**kw, **opts}))

    row["b2_ms"] = ms()
    row["b2_exit_ms"] = ms(grad_tol=1e30)
    for iters in (1, 3, 10):
        row[f"b2_iters{iters}_rej1_ms"] = ms(max_iters=iters,
                                             max_rejections=1)
    row["b2_ws_ms"] = ms(_cluster=0)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copies", nargs="+", metavar="DIR",
                    help="directories holding a dpgo_tpu_torch package, "
                         "timed in turns (A, B, B, A)")
    args = ap.parse_args(argv)
    if not args.copies:
        print(json.dumps(measure()), flush=True)
        return 0
    for copy in args.copies + args.copies[::-1]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(copy))
        out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(json.dumps({"copy": copy, "failed": out.stderr[-2000:]}),
                  flush=True)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"copy": copy, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
