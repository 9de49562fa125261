"""Where the seconds of a multi-rank gloo world go: the worlds of the two
4-rank CPU tests, ``tests/test_torch_gn_tail.py``'s sharded GN tail
(``parallel.world:gn_tail_job``) and ``tests/test_torch_dist_certify.py``'s
two sharded certificates (``parallel.world:multi_job`` of two
``certify_job``s), on their problems.  Each world is timed from the
parent's ``spawn_world`` call to its return, and split per rank into the
start (the spawn to the job's first line: the interpreter, ``import
torch``, the rendezvous), the job, and the job's collectives (calls and
seconds, each waiting on the slowest rank); the rest of the job is the
rank's own compute.

    python -m dpgo_tpu_torch.experiments.world_timing [--ranks 4]

prints one JSON line per world.  Run it beside other load (a test run) to
see how the world stretches."""

from __future__ import annotations

import argparse
import importlib
import json
import tempfile
import time

import numpy as np

#: This module's import name (``__name__`` is ``__main__`` under ``-m``):
#: the ranks import ``timed_job`` from it.
_MODULE = "dpgo_tpu_torch.experiments.world_timing"
#: The collectives of ``torch.distributed`` the sharded plane calls.
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
               "broadcast", "barrier")


def timed_job(target: str, **kwargs) -> dict:
    """``target`` (``"module:function"``) on this rank with every
    collective counted and timed; the job's wall-clock start and end."""
    import torch.distributed as dist

    start = time.time()
    stats = {}

    def timed(name, orig):
        def call(*a, **k):
            t = time.perf_counter()
            out = orig(*a, **k)
            calls, seconds = stats.get(name, (0, 0.0))
            stats[name] = (calls + 1, seconds + time.perf_counter() - t)
            return out
        return call

    for name in COLLECTIVES:
        setattr(dist, name, timed(name, getattr(dist, name)))
    mod, fn = target.split(":")
    getattr(importlib.import_module(mod), fn)(**kwargs)
    return {"start": start, "end": time.time(), "collectives": stats}


def _worlds() -> dict:
    """The two tests' worlds: (target, kwargs) by name."""
    import torch

    from ..config import AgentParams
    from ..models import rbcd, refine
    from ..utils.partition import partition_contiguous
    from ..utils.synthetic import make_measurements

    robots = 8
    meas = make_measurements(np.random.default_rng(42), n=48, d=3,
                             num_lc=24, rot_noise=0.01, trans_noise=0.01)[0]
    params = AgentParams(d=3, r=5, num_robots=robots)
    part = partition_contiguous(meas, robots)
    graph, _ = rbcd.build_graph(part, 5, torch.float64, "cpu")
    wg = 0.3 + 0.7 * np.random.default_rng(7).random(len(part.meas_global))
    weights = wg[graph.meas_id.numpy()] * graph.edges.mask.numpy()
    common = dict(meas=meas, num_robots=robots, params=params)
    return {
        "gn_tail": ("dpgo_tpu_torch.parallel.world:gn_tail_job",
                    dict(common, rounds=12, cfg=refine.GNTailConfig(
                        max_outer=3, grad_norm_tol=1e-7))),
        "certify": ("dpgo_tpu_torch.parallel.world:multi_job",
                    dict(jobs=[("dpgo_tpu_torch.parallel.world:certify_job",
                                dict(common, rounds=150, weights=w))
                               for w in (None, weights)]))}


def main(argv=None) -> int:
    from ..parallel.world import spawn_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    for name, (target, kwargs) in _worlds().items():
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            out = spawn_world(args.ranks, f"{_MODULE}:timed_job",
                              kwargs=dict(target=target, **kwargs),
                              workdir=tmp, timeout_s=args.timeout)
            t1 = time.time()
        print(json.dumps({
            "world": name, "ranks": args.ranks, "seconds": t1 - t0,
            "start_s": [r["start"] - t0 for r in out],
            "job_s": [r["end"] - r["start"] for r in out],
            "after_job_s": t1 - max(r["end"] for r in out),
            "collectives": [r["collectives"] for r in out]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
