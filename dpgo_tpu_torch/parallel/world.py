"""Small multi-rank worlds on one host: ``spawn_world`` starts
``world_size`` fresh interpreters (``python -m
dpgo_tpu_torch.parallel.world``), joins them into one process group through
a ``FileStore`` under the caller's directory (no port to pick, so parallel
callers never collide), runs one job function on every rank (SPMD) and
returns each rank's picklable result.  The CPU parity tests run the
sharded plane over gloo worlds of 1, 2, 4 and 8 ranks this way; the jobs
below are the ones they use.

The worlds are gloo groups on the CPU.  Every rank sets
``torch.set_num_threads(1)`` (eager ops on tiny tensors, several ranks on a
shared host), and the group is initialized with a timeout of
``timeout_s``; the whole world is killed
when it outlives ``timeout_s``, so a hung rank fails its caller instead of
hanging it.

Usage::

    from dpgo_tpu_torch.parallel.world import spawn_world
    out = spawn_world(4, "dpgo_tpu_torch.parallel.world:solve_job",
                      kwargs=dict(meas=meas, num_robots=8, max_iters=10),
                      workdir=tmp_dir)
    out[0]["cost_history"]
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]


def spawn_world(world_size: int, target: str, args: tuple = (),
                kwargs: dict | None = None, *, workdir,
                timeout_s: float = 60.0) -> list:
    """Run ``target`` (``"module:function"``) with ``args``/``kwargs`` on
    every rank of a new ``world_size``-rank world; returns the ranks'
    results in rank order.  Raises ``TimeoutError`` (after killing every
    rank) when the world outlives ``timeout_s``, ``RuntimeError`` with the
    failing rank's log tail when a rank exits with an error."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tag = f"w{world_size}-{os.getpid()}-{time.monotonic_ns()}"
    job = workdir / f"{tag}.job.pkl"
    store = workdir / f"{tag}.store"
    with open(job, "wb") as fh:
        pickle.dump((target, tuple(args), dict(kwargs or {})), fh)
    penv = dict(os.environ)
    penv["PYTHONPATH"] = str(_REPO_ROOT) + (
        os.pathsep + penv["PYTHONPATH"] if penv.get("PYTHONPATH") else "")
    procs, outs, logs = [], [], []
    for rank in range(world_size):
        out = workdir / f"{tag}.r{rank}.out.pkl"
        log = workdir / f"{tag}.r{rank}.log"
        outs.append(out)
        logs.append(log)
        with open(log, "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dpgo_tpu_torch.parallel.world",
                 str(job), str(rank), str(world_size), str(store), str(out),
                 str(timeout_s)],
                env=penv, stdout=lf, stderr=subprocess.STDOUT,
                cwd=str(_REPO_ROOT)))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(
            f"world of {world_size} ranks running {target} exceeded "
            f"{timeout_s:g}s: {_tails(logs)}") from None
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"rank(s) {bad} of a {world_size}-rank world running {target} "
            f"failed: {_tails([logs[r] for r in bad])}")
    results = []
    for out in outs:
        with open(out, "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _tails(logs, n: int = 3000) -> str:
    parts = []
    for log in logs:
        try:
            text = Path(log).read_text()[-n:]
        except OSError:
            text = "<no log>"
        parts.append(f"\n--- {Path(log).name} ---\n{text}")
    return "".join(parts)


def _rank_main(argv) -> int:
    job, rank, world_size, store_path, out, timeout_s = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world_size = int(rank), int(world_size)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    with open(job, "rb") as fh:
        target, args, kwargs = pickle.load(fh)
    mod, fn = target.split(":")
    result = getattr(importlib.import_module(mod), fn)(*args, **kwargs)
    with open(out + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(out + ".tmp", out)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# Jobs (run on every rank; results are plain numpy / Python values)
# ---------------------------------------------------------------------------

def replay_async(draws) -> None:
    """Replace ASYNC's clocks (``rbcd._async_fired``) by ``draws[it]``
    (``[rounds, A]`` booleans, e.g. the JAX package's key chain's)."""
    import torch

    from ..models import rbcd

    table = np.asarray(draws, bool)

    def fired(seed, iteration, num_robots, prob, device):
        return torch.as_tensor(table[iteration], device=device)

    rbcd._async_fired = fired


def result_summary(res) -> dict:
    """A solve result as plain values: histories, iterations, reason, the
    trajectory, iterate, weights and the resilience summary."""
    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    return {"cost_history": list(res.cost_history),
            "grad_norm_history": list(res.grad_norm_history),
            "iterations": int(res.iterations),
            "terminated_by": res.terminated_by,
            "T": arr(res.T), "X": arr(res.X), "weights": arr(res.weights),
            "recovered": bool(res.recovered),
            "resilience": res.resilience}


def solve_job(meas, num_robots: int, async_draws=None, mesh_size=None,
              resilience: dict | None = None, fault=None,
              count_fetches: bool = False, telemetry_dir: str | None = None,
              **kw) -> dict:
    """``solve_rbcd_sharded(meas, num_robots, device="cpu", **kw)`` on this
    rank's world (or its first ``mesh_size`` ranks).  ``async_draws``
    replays ASYNC's clocks; ``resilience`` are ``ResilienceConfig``
    keywords and ``fault`` ``(MeshFaultSpec, seed)`` for its injector;
    ``count_fetches`` adds the number of ``rbcd._host_fetch`` calls;
    ``telemetry_dir`` runs the solve under an obs run in its
    ``rank<r>`` subdirectory."""
    import contextlib

    import torch.distributed as dist

    from .. import obs
    from ..models import rbcd
    from . import resilience as res_mod
    from .sharded import make_mesh, solve_rbcd_sharded

    if async_draws is not None:
        replay_async(async_draws)
    if resilience is not None:
        inj = None
        if fault is not None:
            inj = res_mod.CollectiveFaultInjector(fault[0], seed=fault[1])
        kw["resilience"] = res_mod.ResilienceConfig(injector=inj,
                                                    **resilience)
    fetches = [0]
    if count_fetches:
        orig = rbcd._host_fetch

        def counting(x):
            fetches[0] += 1
            return orig(x)

        rbcd._host_fetch = counting
    mesh = make_mesh(mesh_size, device="cpu")
    scope = obs.run_scope(os.path.join(
        telemetry_dir, f"rank{dist.get_rank()}")) if telemetry_dir \
        else contextlib.nullcontext()
    with scope:
        res = solve_rbcd_sharded(meas, num_robots, mesh=mesh, device="cpu",
                                 **kw)
    out = result_summary(res)
    out["fetches"] = fetches[0]
    return out


def multi_job(jobs) -> list:
    """Several jobs in one world, in order: ``jobs`` is a list of
    ``("module:function", kwargs)``; returns their results."""
    out = []
    for target, kwargs in jobs:
        mod, fn = target.split(":")
        out.append(getattr(importlib.import_module(mod), fn)(**kwargs))
    return out


def _problem(meas, num_robots: int, params, rounds: int):
    """The whole problem on the CPU in float64 after ``rounds`` plain
    single-device rounds from the chordal init (the same on every rank)."""
    import torch

    from ..models import rbcd
    from ..utils.partition import partition_contiguous

    part = partition_contiguous(meas, num_robots)
    graph, meta = rbcd.build_graph(part, params.r, torch.float64, "cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    state = rbcd.init_state(graph, meta, X0, params=params)
    state = rbcd.rbcd_steps(state, graph, rounds, meta, params)
    return part, graph, meta, state


def gn_tail_job(meas, num_robots: int, params, rounds: int, cfg) -> dict:
    """``gn_tail_sharded`` on the world from the iterate after ``rounds``
    single-device rounds; the result record, the polished iterate and the
    number of ``rbcd._host_fetch`` calls."""
    from ..models import rbcd
    from .sharded import gn_tail_sharded, make_mesh

    _, graph, meta, state = _problem(meas, num_robots, params, rounds)
    fetches = [0]
    orig = rbcd._host_fetch

    def counting(x):
        fetches[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    try:
        Xa, res = gn_tail_sharded(state.X, graph, meta,
                                  mesh=make_mesh(device="cpu"), cfg=cfg)
    finally:
        rbcd._host_fetch = orig
    return {"cost_history": res.cost_history,
            "grad_norm_history": res.grad_norm_history,
            "cg_iterations": res.cg_iterations,
            "outer_iterations": res.outer_iterations,
            "terminated_by": res.terminated_by, "X": res.X,
            "Xa": Xa.numpy(), "fetches": fetches[0]}


def certify_job(meas, num_robots: int, params, rounds: int, weights=None,
                **kw) -> dict:
    """``certify_sharded`` on the world at the iterate after ``rounds``
    single-device rounds."""
    import torch

    from .certify import certify_sharded
    from .sharded import make_mesh

    _, graph, meta, state = _problem(meas, num_robots, params, rounds)
    c = certify_sharded(state.X, graph, mesh=make_mesh(device="cpu"),
                        weights=None if weights is None
                        else torch.as_tensor(weights), **kw)
    return {"lambda_min": c.lambda_min, "sigma": c.sigma,
            "stationarity_gap": c.stationarity_gap,
            "certified": c.certified, "direction": c.direction.numpy()}


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
