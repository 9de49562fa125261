"""The certificate of bench_convergence.py's f* on the sphere2500 stand-in,
written out so another eigensolver can be held against the port's on the
same iterate and the same probe draws.

    python -m dpgo_tpu_torch.experiments.cert_witness OUT.npz \\
        [--draws DRAWS.npz] [--lobpcg-iters M] [--device cpu]

Solves ``local_pgo.solve_local`` (rank 5, gradient norm 1e-9, at most 1000
iterations, float64) on the stand-in of ``bench.py:77-84`` (2500 poses,
4948 edges), then runs ``certify.certify_solution`` and
``certify.device_certificate_payload`` at seed 0 with ``M`` LOBPCG
iterations (default 300, the package's).  With ``--draws`` the
probe draws ``v0``, ``V0`` of that file are fed through
``certify._probe_draws`` in place of the port's own.  Writes the iterate
and the eigensolves' outputs to ``OUT.npz`` and one JSON line to stdout.
Runs on CUDA unless ``--device cpu`` is asked for.

``python tests/test_torch_certify.py draws DRAWS.npz`` writes the JAX
package's draws, and ``python tests/test_torch_certify.py witness
OUT.npz`` runs the JAX package's eigensolves on the written iterate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import interop
from ..device import resolve_device
from ..models import certify, local_pgo
from ..types import edge_set_from_measurements
from ..utils.synthetic import make_measurements

RANK, GRAD_TOL, MAX_ITERS, SEED = 5, 1e-9, 1000, 0


def standin():
    """bench.py's synthetic stand-in for sphere2500 (seed 0)."""
    return make_measurements(np.random.default_rng(0), n=2500, d=3,
                             num_lc=2449, rot_noise=0.01,
                             trans_noise=0.01)[0]


def rayleigh(X, edges, v) -> float:
    """The Rayleigh quotient of the direction ``v [n, d+1]`` on S."""
    lam = certify.dual_blocks(X, edges)
    Sv = certify.certificate_matvec(v[:, None, :], edges, lam)[:, 0]
    return float(torch.sum(v * Sv) / torch.sum(v * v))


def run(out: str, draws: str | None = None, lobpcg_iters: int = 300,
        device="cuda") -> dict:
    dev = resolve_device(device)
    meas = standin()
    t0 = time.perf_counter()
    res = local_pgo.solve_local(meas, rank=RANK, grad_norm_tol=GRAD_TOL,
                                max_iters=MAX_ITERS, device=dev)
    solve_s = time.perf_counter() - t0
    edges = edge_set_from_measurements(meas, dtype=torch.float64,
                                       device=dev)
    orig = certify._probe_draws
    if draws is not None:
        z = np.load(draws)
        certify._probe_draws = interop.fixed_probe_draws(
            {SEED: (z["v0"], z["V0"])})
    try:
        t1 = time.perf_counter()
        cert = certify.certify_solution(res.X, edges, seed=SEED,
                                        lobpcg_iters=lobpcg_iters)
        t2 = time.perf_counter()
        pay = certify.device_certificate_payload(
            res.X, edges, SEED, lobpcg_iters=lobpcg_iters)
        float(pay["rq"])
        t3 = time.perf_counter()
    finally:
        certify._probe_draws = orig
    row = {"device": str(dev), "draws": "given" if draws else "port",
           "lobpcg_iters": lobpcg_iters,
           "iterations": res.iters, "f_star": res.cost,
           "grad_norm": res.grad_norm, "solve_s": solve_s,
           "lambda_min": cert.lambda_min, "sigma": cert.sigma,
           "stationarity_gap": cert.stationarity_gap,
           "rq": rayleigh(res.X, edges, cert.direction.to(dev)),
           "payload_lam_min": float(pay["lam_min"]),
           "payload_sigma": float(pay["sigma"]),
           "payload_rq": float(pay["rq"]),
           "payload_defl_resid": float(pay["defl_resid"]),
           "certify_s": t2 - t1, "payload_s": t3 - t2}
    np.savez(out, X=res.X.cpu().numpy(),
             direction=cert.direction.cpu().numpy(),
             **{k: np.float64(v) for k, v in row.items()
                if isinstance(v, (int, float))})
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--draws")
    ap.add_argument("--lobpcg-iters", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.out, args.draws, args.lobpcg_iters,
                         args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
