"""Multi-process execution: one solve, N OS processes, kill -9 recovery —
the port of ``dpgo_tpu.parallel.multihost``.

* **World membership** (``MultihostWorld``) — a ``torch.distributed.
  TCPStore`` owned by the launcher is the coordination service: its
  key-value store carries the verdict words, and a named barrier is
  ``store.add`` plus ``store.wait`` on the key the last arriving rank
  sets.

* **Lockstep compute** — as in the JAX package, each rank runs the
  identical deterministic sharded solve on its own local mesh, and the
  world proves lockstep where the driver already surfaces to the host:
  the ONE int32 verdict word per K rounds.  At each verdict boundary
  every rank publishes ``iteration:word``, crosses a named barrier and
  checks its word against the controller's (rank 0).  No new device
  syncs: ``host_syncs_per_100_rounds == 100/K`` holds unchanged.  The
  local mesh is one device — a world of size 1 initialized from the
  process's own ``HashStore`` (``sharded.make_mesh``) — so
  ``launch_world(mesh_size > 1)`` is refused.

* **Failure recovery** — a SIGKILLed peer never reaches its barrier, so
  the survivors' wait times out, surfaced as ``MeshFaultError(phase=
  "verdict_sync", kind="process_lost")``; a diverged word is
  ``kind="desync"``.  ``CheckpointSupervisor.recover`` re-raises world
  faults, the worker writes a structured fault record and exits
  ``EXIT_PROCESS_LOST`` / ``EXIT_DESYNC``, and the generation launcher
  (``launch_world``) respawns the survivors as generation g+1 on a
  shrunken world (``shrink_world``) with ``solve_rbcd_sharded(resume=
  True)``: the supervisor restores the newest checkpoint from the shared
  ``SessionStore`` and the solve continues at the exact absolute round
  index.  Only rank 0 persists checkpoints; every rank reads them.

Barrier timeouts are two-tier: the first boundary lands after each rank
has started (kernel loads, first dispatches), so it gets
``first_barrier_timeout_s``; steady-state boundaries get the tight
``barrier_timeout_s``, which is also the fault-detection latency.

CLI::

    python -m dpgo_tpu_torch.parallel.multihost --procs 2 [--device cpu]
    python -m dpgo_tpu_torch.parallel.multihost --procs 2 --kill-rank 1 \\
        --kill-at-boundary 3   # kill -9 a worker mid-solve, watch recovery
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import obs
from ..comms.protocol import ORIGIN_FLEET_PARENT, mh_rank_actor
from ..obs.trace import emit_span
from .resilience import MeshFaultError, shrink_mesh_size

#: Worker exit codes the launcher classifies (anything else is a crash).
EXIT_PROCESS_LOST = 17  # a peer died: barrier timed out at a boundary
EXIT_DESYNC = 18        # lockstep broken: verdict words diverged


def shrink_world(cur: int, num_robots: int, min_size: int = 1) -> int:
    """The next smaller world size after losing a process: the largest
    count strictly below ``cur`` that still divides the agent count —
    the same divisibility planning as a mesh shrink, because each rank's
    local mesh must go on dividing ``num_robots``."""
    return shrink_mesh_size(cur, num_robots, min_size)


# ---------------------------------------------------------------------------
# World membership + verdict lockstep
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorldConfig:
    """One rank's view of the world (`--worker` CLI args, test kwargs)."""

    coordinator: str
    world_size: int
    rank: int
    generation: int = 0
    #: Steady-state barrier deadline == fault-detection latency.
    barrier_timeout_s: float = 20.0
    #: First-boundary deadline: absorbs cross-rank start-up skew.
    first_barrier_timeout_s: float = 600.0
    init_timeout_s: float = 300.0

    def __post_init__(self):
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got "
                             f"{self.world_size}")
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside world of "
                             f"{self.world_size}")
        if self.barrier_timeout_s <= 0 or self.first_barrier_timeout_s <= 0:
            raise ValueError("barrier timeouts must be > 0")


def _decode(raw) -> str:
    return raw.decode("utf-8", "replace") if isinstance(raw, bytes) \
        else str(raw)


class MultihostWorld:
    """Verdict-boundary lockstep across the ranks of one generation.

    ``boundary_cb`` plugs into ``solve_rbcd_sharded(boundary_cb=...)``:
    at every verdict boundary it publishes this rank's ``iteration:word``
    to the coordination-service KV store, crosses a generation-scoped
    named barrier, and cross-checks against the controller's word.  A
    barrier deadline means a peer never arrived —
    ``MeshFaultError(kind="process_lost")``; a word mismatch means
    replicated lockstep broke — ``MeshFaultError(kind="desync")``.

    ``client`` is a store with ``set``, ``get``, ``add`` and ``wait(keys,
    timedelta)`` — a ``torch.distributed.TCPStore`` connected to the
    launcher's (:meth:`join`), or a ``HashStore`` in tests.
    """

    def __init__(self, cfg: WorldConfig, client=None):
        self.cfg = cfg
        self.rank = cfg.rank
        self.world_size = cfg.world_size
        self.generation = cfg.generation
        self.client = client
        self.boundaries = 0  # completed lockstep syncs
        self.desync_checks = 0

    @classmethod
    def join(cls, cfg: WorldConfig) -> "MultihostWorld":
        """Connect this rank to the coordinator's ``TCPStore``
        (``host:port``) and return the joined world."""
        import torch.distributed as dist

        host, port = cfg.coordinator.rsplit(":", 1)
        store = dist.TCPStore(
            host, int(port), is_master=False,
            timeout=datetime.timedelta(seconds=cfg.init_timeout_s))
        return cls(cfg, client=store)

    # -- key naming ---------------------------------------------------------

    def _word_key(self, seq: int, rank: int) -> str:
        return f"dpgo/mh/g{self.generation}/s{seq}/r{rank}"

    def _stamp_key(self, seq: int, rank: int) -> str:
        # Telemetry-only clock stamps ride their own key family: with
        # telemetry off these keys are never written and the KV/barrier
        # traffic is byte-identical to the uninstrumented protocol.
        return f"dpgo/mh/g{self.generation}/c{seq}/r{rank}"

    def _barrier_id(self, seq: int) -> str:
        return f"dpgo/mh/g{self.generation}/b{seq}"

    # -- the lockstep protocol ----------------------------------------------

    def verdict_sync(self, it: int, word: int) -> None:
        """One boundary's cross-process agreement: publish, barrier,
        cross-check.  Raises the structured world faults above."""
        if self.world_size == 1:
            self.boundaries += 1
            return
        seq = self.boundaries
        payload = f"{int(it)}:{int(word)}"
        timeout_s = self.cfg.first_barrier_timeout_s if seq == 0 \
            else self.cfg.barrier_timeout_s
        run = obs.get_run()
        actor = mh_rank_actor(self.rank) if run is not None else None
        if run is not None:
            # The verdict_publish event is this rank's own durable copy
            # of what it pushed to the KV store — the launcher's
            # postmortem harvester decodes a SIGKILLed rank's last word
            # from here.  The clock stamp key (c-family) pairs the
            # barrier round-trip into clock_sample samples below.
            run.event("verdict_publish", phase="comms", robot=actor,
                      seq_boundary=seq, iteration=int(it),
                      word=int(word),
                      key=self._word_key(seq, self.rank))
            self.client.set(self._stamp_key(seq, self.rank),
                            f"{time.monotonic()}:{time.time()}")
        self.client.set(self._word_key(seq, self.rank), payload)
        t0_mono, t0_wall = time.monotonic(), time.time()
        try:
            self._barrier(self._barrier_id(seq), timeout_s)
        except Exception as e:
            raise MeshFaultError(
                f"rank {self.rank}: peer lost at verdict boundary {seq} "
                f"(iteration {it}): barrier {self._barrier_id(seq)!r} "
                f"timed out after {timeout_s:g}s",
                phase="verdict_sync", kind="process_lost") from e
        if run is not None:
            emit_span(run, "barrier_wait", t0_mono, t0_wall,
                      time.monotonic() - t0_mono, phase="comms",
                      robot=actor, seq_boundary=seq,
                      generation=self.generation)
            # Post-barrier every telemetry-on peer's stamp exists: the
            # controller samples every rank's clock and every rank
            # samples the controller's — bidirectional pairs for the
            # merged-timeline offset solve.  Fail-open (short timeout)
            # so a telemetry-off peer can't stall a telemetry-on one.
            peers = [r for r in range(self.world_size) if r != self.rank] \
                if self.rank == 0 else [0]
            for r in peers:
                try:
                    key = self._stamp_key(seq, r)
                    self.client.wait([key], datetime.timedelta(seconds=2))
                    mono_s, wall_s = _decode(self.client.get(key)).split(":")
                    run.event("clock_sample", phase="comms",
                              src=mh_rank_actor(r), dst=actor,
                              channel="coord_kv", kind="barrier",
                              seq_boundary=seq,
                              t_send_mono=float(mono_s),
                              t_send_wall=float(wall_s))
                except Exception:
                    pass
        if self.rank != 0:
            # The barrier just proved rank 0 published; the get is a
            # KV read of an existing key, not a second wait.
            ref = _decode(self.client.get(self._word_key(seq, 0)))
            self.desync_checks += 1
            if ref != payload:
                raise MeshFaultError(
                    f"rank {self.rank}: verdict desync at boundary {seq}: "
                    f"controller says {ref!r}, this rank computed "
                    f"{payload!r} — replicated lockstep broken",
                    phase="verdict_sync", kind="desync")
        self.boundaries += 1
        run = obs.get_run()
        if run is not None:
            run.counter("multihost_boundary_syncs_total",
                        "verdict-boundary lockstep syncs").inc()

    def _barrier(self, barrier_id: str, timeout_s: float) -> None:
        """Every rank of the generation passes ``barrier_id`` together:
        each adds one to its counter, the last sets its ``/done`` key, all
        wait for that key — a timeout means a rank never arrived."""
        if int(self.client.add(barrier_id, 1)) == self.world_size:
            self.client.set(barrier_id + "/done", "1")
        self.client.wait([barrier_id + "/done"],
                         datetime.timedelta(seconds=timeout_s))

    def boundary_cb(self, it, nwu, state, word, terminal) -> None:
        """The ``solve_rbcd_sharded(boundary_cb=...)`` adapter; ``state``
        stays on device — lockstep rides the already-fetched word."""
        self.verdict_sync(int(it), int(word))


# ---------------------------------------------------------------------------
# Worker: one rank of one generation (its own OS process)
# ---------------------------------------------------------------------------

def _write_json(path, record: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(record, indent=2, sort_keys=True))
    os.replace(tmp, p)


def _read_json(path) -> dict | None:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None


def _solve_problem(args):
    """The deterministic demo problem every rank rebuilds identically
    (seeded synthetic odometry chain + loop closures)."""
    from ..utils.synthetic import make_measurements

    rng = np.random.default_rng(args.seed)
    meas, _ = make_measurements(rng, n=args.n, d=3, num_lc=args.num_lc,
                                rot_noise=args.noise,
                                trans_noise=args.noise)
    return meas


def run_worker(args) -> int:
    """``--worker`` entry: join the world, run the lockstep solve, write
    a result (or structured fault) record, exit with a classifiable rc.

    With ``--telemetry-dir`` (threaded by the launcher) the whole worker
    runs inside its own generation-scoped ``TelemetryRun`` — the per-rank
    stream the launcher harvests and merges after the generation ends,
    SIGKILL or not (events.jsonl is flushed per line; the harvest is
    tail-tolerant)."""
    import torch

    torch.set_num_threads(1)
    boot = (time.monotonic(), time.time())
    if getattr(args, "telemetry_dir", ""):
        with obs.run_scope(args.telemetry_dir):
            return _worker_main(args, boot)
    return _worker_main(args, boot)


def _worker_main(args, boot) -> int:
    import torch

    cfg = WorldConfig(coordinator=args.coordinator, world_size=args.world,
                      rank=args.rank, generation=args.generation,
                      barrier_timeout_s=args.barrier_timeout,
                      first_barrier_timeout_s=args.first_barrier_timeout,
                      init_timeout_s=args.init_timeout)
    world = MultihostWorld.join(cfg)

    run = obs.get_run()
    if run is not None:
        actor = mh_rank_actor(world.rank)
        run.set_fingerprint(plane="multihost", rank=world.rank,
                            generation=world.generation,
                            world_size=world.world_size)
        # Pair the launcher's spawn stamp with this (receive-side) event:
        # the forward leg of the launcher<->rank clock sample; the
        # harvester emits the reverse leg off the result record's stamp.
        if getattr(args, "launch_stamp", ""):
            try:
                mono_s, wall_s = args.launch_stamp.split(",")
                run.event("clock_sample", phase="comms",
                          src=ORIGIN_FLEET_PARENT, dst=actor,
                          channel="spawn", kind="launch",
                          t_send_mono=float(mono_s),
                          t_send_wall=float(wall_s))
            except (ValueError, IndexError):
                pass
        # The boot span anchors this stream's home to the rank's actor
        # id even for a 1-rank world that never crosses a barrier.
        emit_span(run, "worker_boot", boot[0], boot[1],
                  time.monotonic() - boot[0], phase="comms", robot=actor,
                  rank=world.rank, generation=world.generation)

    from ..config import AgentParams
    from ..models import rbcd
    from ..serve.session import SessionStore
    from .resilience import ResilienceConfig
    from .sharded import make_mesh, solve_rbcd_sharded

    meas = _solve_problem(args)
    params = AgentParams(d=3, r=5, num_robots=args.robots,
                         rel_change_tol=0.0)
    rcfg = ResilienceConfig(
        checkpoint_dir=args.checkpoint_dir, session_id=args.session,
        checkpoint_every=1, keep=4,
        checkpoint_writer=(world.rank == 0))

    resume = args.generation > 0
    resume_iteration = 0
    if resume:
        snap = SessionStore(args.checkpoint_dir,
                            device="cpu").load_newest(args.session)
        if snap is not None:
            resume_iteration = int(snap.iteration)

    chaos_cb = world.boundary_cb
    if args.kill_at_boundary >= 0 and args.kill_rank == world.rank \
            and args.generation == 0:
        def chaos_cb(it, nwu, state, word, terminal):
            if world.boundaries == args.kill_at_boundary:
                sys.stdout.flush()
                # A REAL kill -9 of this worker, mid-solve: uncatchable,
                # no cleanup, no flush — exactly what the survivors must
                # detect and recover from.
                os.kill(os.getpid(), signal.SIGKILL)
            world.boundary_cb(it, nwu, state, word, terminal)

    # Count driver-loop host syncs through the sanctioned seam, the same
    # shim as tests/test_mesh_resilience.py: the lockstep must not add
    # any (it rides words already fetched).  The coordination-rate metric
    # counts ONLY the packed verdict words (the scalar readbacks) — the
    # telemetry plane's recurring lazy-history fetch is the single-host
    # telemetry cost the solver's own gauge already accounts for, so
    # ``host_syncs_per_100_rounds`` stays pinned at 100/K whether the
    # rank runs instrumented (harvested) or dark.
    fetches = [0, 0]  # [total, scalar verdict words]
    orig_fetch = rbcd._host_fetch

    def counting_fetch(x):
        fetches[0] += 1
        host = x.host if isinstance(x, rbcd._Pending) else x
        if isinstance(host, torch.Tensor) and host.dim() == 0:
            fetches[1] += 1
        return orig_fetch(x)

    # The rank's mesh is its own world of one device (an in-process store,
    # ``make_mesh``): each rank hosts the replicated solve, the lockstep
    # design.
    mesh = make_mesh(args.mesh_size, device=args.device)

    t0 = time.monotonic()
    rbcd._host_fetch = counting_fetch
    try:
        res = solve_rbcd_sharded(
            meas, args.robots, mesh=mesh,
            params=params, max_iters=args.rounds,
            verdict_every=args.verdict_every,
            eval_every=args.verdict_every, grad_norm_tol=0.0,
            resilience=rcfg, resume=resume, boundary_cb=chaos_cb)
    except MeshFaultError as e:
        _write_json(args.out, {
            "ok": False, "kind": e.kind, "phase": e.phase,
            "rank": world.rank, "generation": world.generation,
            "world_size": world.world_size,
            "boundaries": world.boundaries, "error": str(e),
            "t_record_mono": time.monotonic(),
            "t_record_wall": time.time()})
        if run is not None and getattr(args, "telemetry_dir", ""):
            # os._exit skips the run_scope teardown; finalize this
            # rank's run artifacts so the harvest sees a closed stream.
            try:
                obs.end_run()
            except Exception:
                pass
        sys.stdout.flush()
        sys.stderr.flush()
        # A peer is gone: exit hard with the classifiable code, skipping
        # the process group's teardown.
        os._exit(EXIT_PROCESS_LOST if e.kind == "process_lost"
                 else EXIT_DESYNC)
    finally:
        rbcd._host_fetch = orig_fetch

    rounds = args.rounds - resume_iteration
    # The sync-rate metric counts the scalar verdict-word fetches only
    # (one per K-round boundary; the terminal epilogue and the
    # telemetry-on lazy-history legs are pytree transfers, so they never
    # land in the word tally) — rbcd._emit_sync_rate's convention for
    # the raw total still governs the solver's own gauge.
    loop_fetches = fetches[1]
    _write_json(args.out, {
        "ok": True, "rank": world.rank, "generation": world.generation,
        "world_size": world.world_size, "mesh_size": args.mesh_size,
        "boundaries": world.boundaries,
        "desync_checks": world.desync_checks,
        "resumed": resume, "resume_iteration": resume_iteration,
        "iterations": int(res.iterations),
        "terminated_by": res.terminated_by,
        "final_cost": float(res.cost_history[-1]),
        "cost_history": [float(c) for c in res.cost_history],
        "grad_norm_history": [float(g) for g in res.grad_norm_history],
        "recovered": bool(res.recovered),
        "resilience": res.resilience,
        "host_fetches": int(fetches[0]),
        "rounds_executed": int(rounds),
        "host_syncs_per_100_rounds":
            100.0 * loop_fetches / max(rounds, 1),
        "wall_s": round(time.monotonic() - t0, 3),
        "device": str(mesh.device),
        "b2_launches": int(_b2_launches()),
        "t_record_mono": time.monotonic(),
        "t_record_wall": time.time()})
    return 0


def _b2_launches() -> int:
    from ..ops import rtr_kernel

    return int(rtr_kernel.LAUNCHES)


# ---------------------------------------------------------------------------
# Launcher: generations of worker processes
# ---------------------------------------------------------------------------

def _coordinator():
    """A fresh ``TCPStore`` server on a free local port (the generation's
    coordination service, owned by the launcher)."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False)


def _classify(rc: int) -> str:
    if rc == 0:
        return "ok"
    if rc == EXIT_PROCESS_LOST:
        return "process_lost"
    if rc == EXIT_DESYNC:
        return "desync"
    if rc < 0:
        try:
            return f"signal:{signal.Signals(-rc).name}"
        except ValueError:
            return f"signal:{-rc}"
    return f"crash:{rc}"


def launch_world(procs: int = 2, *, robots: int = 8, mesh_size: int = 1,
                 n: int = 64, num_lc: int = 12, noise: float = 0.05,
                 seed: int = 7, rounds: int = 24, verdict_every: int = 4,
                 workdir: str | None = None,
                 barrier_timeout_s: float = 20.0,
                 first_barrier_timeout_s: float = 600.0,
                 init_timeout_s: float = 300.0,
                 kill_rank: int | None = None,
                 kill_at_boundary: int | None = None,
                 kill_after_s: float | None = None,
                 max_generations: int = 3,
                 worker_timeout_s: float = 1800.0,
                 session: str = "multihost-solve",
                 telemetry_dir: str | None = None,
                 device: str = "cuda") -> dict:
    """Run one multihost solve to completion, across generations.

    Spawns ``procs`` worker processes (``python -m
    dpgo_tpu_torch.parallel.multihost --worker``, each on ``device``: the
    card unless ``"cpu"`` is asked for; float32 on CUDA, float64 on the
    CPU; one torch thread each) joined through the launcher's ``TCPStore``;
    if a generation loses a process (the two chaos levers: a worker
    SIGKILLs itself at a named verdict boundary, or the launcher
    ``kill -9``\\ s a rank after a wall-clock delay), the surviving ranks
    exit with structured fault records and the next generation respawns
    them on the shrunken world with ``resume=True`` — the supervisor
    restores the newest v2 checkpoint from the shared store and the
    solve continues.  Returns the final generation's controller record
    plus the per-generation fault ledger.

    With ``telemetry_dir`` the launcher opens its own run there (unless
    one is already ambient), hands every rank a generation-scoped run
    directory, harvests every rank's stream after each generation
    (``generation_postmortem`` + ``process_lost`` forensics — the
    SIGKILLed rank's tail survives it), and merges launcher + all ranks
    into ONE validated Chrome trace (``summary["telemetry"]``).

    One deviation from the JAX package: each rank's local mesh is one
    device (the JAX package gives each rank ``mesh_size`` virtual CPU
    devices), so ``mesh_size`` other than 1 raises."""
    from ..device import resolve_device

    if mesh_size != 1:
        raise ValueError(
            f"mesh_size={mesh_size}: each multihost rank of the PyTorch "
            "port runs its solve on a local mesh of ONE device (a world of "
            "size 1 from the rank's own store), where the JAX package "
            "gives each rank a mesh of virtual CPU devices; pass "
            "mesh_size=1")
    dev = resolve_device(device)
    if robots % mesh_size != 0:
        raise ValueError(f"mesh_size {mesh_size} must divide robots "
                         f"{robots}")
    if dev.type == "cuda":
        # Build the kernel library once, before the ranks start (nvcc
        # only — no CUDA context here).
        from ..ops import rtr_kernel

        rtr_kernel.build()
    workdir = Path(workdir or tempfile.mkdtemp(prefix="dpgo-multihost-"))
    workdir.mkdir(parents=True, exist_ok=True)
    checkpoint_dir = workdir / "checkpoints"
    repo_root = Path(__file__).resolve().parents[2]

    from ..obs import fleetobs

    tel_root = Path(telemetry_dir).resolve() if telemetry_dir else None
    if tel_root is not None:
        tel_root.mkdir(parents=True, exist_ok=True)
    rank_dirs_all: list = []   # every generation's per-rank run dirs
    summary: dict | None = None

    with contextlib.ExitStack() as stack:
        run = obs.get_run()
        launcher_dir = None
        if tel_root is not None and run is None:
            launcher_dir = tel_root / "launcher"
            run = stack.enter_context(obs.run_scope(str(launcher_dir)))
        elif run is not None:
            launcher_dir = Path(run.run_dir)
        if run is not None:
            run.set_fingerprint(plane="multihost", role="launcher",
                                procs=int(procs))

        world = int(procs)
        generations = []
        gen = 0
        while True:
            coord = _coordinator()
            outs, log_files, procs_list = [], [], []
            gen_rank_dirs: dict = {}
            if run is not None:
                run.event("generation_start", phase="fleet",
                          generation=gen, world_size=world)
            for rank in range(world):
                out = workdir / f"g{gen}-r{rank}.json"
                log = workdir / f"g{gen}-r{rank}.log"
                outs.append(out)
                cmd = [sys.executable, "-m",
                       "dpgo_tpu_torch.parallel.multihost",
                       "--worker", "--rank", str(rank),
                       "--world", str(world),
                       "--coordinator", f"127.0.0.1:{coord.port}",
                       "--device", str(device),
                       "--generation", str(gen),
                       "--robots", str(robots),
                       "--mesh-size", str(mesh_size),
                       "--n", str(n), "--num-lc", str(num_lc),
                       "--noise", str(noise), "--seed", str(seed),
                       "--rounds", str(rounds),
                       "--verdict-every", str(verdict_every),
                       "--checkpoint-dir", str(checkpoint_dir),
                       "--session", session, "--out", str(out),
                       "--barrier-timeout", str(barrier_timeout_s),
                       "--first-barrier-timeout",
                       str(first_barrier_timeout_s),
                       "--init-timeout", str(init_timeout_s)]
                if gen == 0 and kill_rank is not None \
                        and kill_at_boundary is not None:
                    cmd += ["--kill-rank", str(kill_rank),
                            "--kill-at-boundary", str(kill_at_boundary)]
                if tel_root is not None:
                    rank_dir = fleetobs.generation_run_dir(
                        tel_root, gen, rank)
                    gen_rank_dirs[rank] = rank_dir
                    # Stamped immediately before the spawn: the forward
                    # leg of the launcher<->rank clock pairing.
                    cmd += ["--telemetry-dir", rank_dir,
                            "--launch-stamp",
                            f"{time.monotonic()},{time.time()}"]
                env = dict(os.environ)
                env["PYTHONPATH"] = str(repo_root) + (
                    os.pathsep + env["PYTHONPATH"]
                    if env.get("PYTHONPATH") else "")
                lf = open(log, "w")
                log_files.append(lf)
                procs_list.append(subprocess.Popen(
                    cmd, env=env, stdout=lf, stderr=subprocess.STDOUT,
                    cwd=str(repo_root)))

            if gen == 0 and kill_rank is not None \
                    and kill_after_s is not None \
                    and kill_at_boundary is None:
                time.sleep(kill_after_s)
                if procs_list[kill_rank].poll() is None:
                    procs_list[kill_rank].send_signal(signal.SIGKILL)

            deadline = time.monotonic() + worker_timeout_s
            rcs = []
            for p in procs_list:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                rcs.append(p.returncode)
            for lf in log_files:
                lf.close()
            del coord  # the generation's coordination service ends here

            records = [_read_json(o) for o in outs]
            faults = [r for r in records
                      if r is not None and not r.get("ok", False)]
            outcomes = [_classify(rc) for rc in rcs]
            gen_entry = {"generation": gen, "world_size": world,
                         "rcs": list(rcs), "outcomes": outcomes,
                         "faults": faults}
            generations.append(gen_entry)
            if run is not None:
                run.event("generation_end", phase="fleet",
                          generation=gen, world_size=world,
                          outcomes=outcomes)
                # Fail-open forensics: every rank's stream harvested,
                # the victim's tail + last published verdict included.
                fleetobs.harvest_generation(
                    run, gen, gen_rank_dirs,
                    outcomes={r: outcomes[r] for r in gen_rank_dirs},
                    records={r: records[r] for r in gen_rank_dirs
                             if r < len(records)},
                    plane="multihost", lost_actor=mh_rank_actor)
                rank_dirs_all.extend(gen_rank_dirs.values())

            if all(rc == 0 for rc in rcs):
                result = records[0]
                if result is None or not result.get("ok"):
                    raise RuntimeError(
                        f"generation {gen}: all ranks exited 0 but the "
                        f"controller record at {outs[0]} is "
                        f"missing/faulted")
                summary = {"result": result, "generations": generations,
                           "world_sizes": [g["world_size"]
                                           for g in generations],
                           "recovered": gen > 0,
                           "workdir": str(workdir)}
                break

            if gen + 1 >= max_generations:
                raise RuntimeError(
                    f"multihost solve failed after {gen + 1} "
                    f"generations: "
                    f"{[g['outcomes'] for g in generations]}")
            world = shrink_world(world, robots) if world > 1 else world
            gen += 1

    # The launcher run (if this call opened one) is finalized here; the
    # merged generation timeline spans launcher + every rank of every
    # generation — the kill shows up as a process_lost instant on the
    # victim's own track.
    if tel_root is not None and launcher_dir is not None:
        try:
            trace_info = fleetobs.write_fleet_trace(
                [str(launcher_dir)] + [str(d) for d in rank_dirs_all],
                str(tel_root / "fleet_trace.json"))
            summary["telemetry"] = {"dir": str(tel_root), **trace_info}
        except Exception as e:
            summary["telemetry"] = {"dir": str(tel_root),
                                    "error": f"{type(e).__name__}: {e}"}
    return summary


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.parallel.multihost",
        description="Multi-process mesh solve with kill -9 recovery",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "worker exit codes (the launcher classifies these per rank "
            "in the final outcome line):\n"
            f"  {EXIT_PROCESS_LOST}  process_lost: a peer died — the "
            "verdict-boundary barrier timed out\n"
            f"  {EXIT_DESYNC}  desync: replicated lockstep broke — "
            "verdict words diverged from rank 0\n"
            "  -N  signal:<name>: the worker was killed by signal N "
            "(e.g. the kill -9 chaos levers)\n\n"
            "on success the launcher prints ONE machine-readable JSON "
            "line: world sizes, recovery,\nper-rank outcome "
            "classifications per generation, solve result fields, and "
            "(with\n--telemetry-dir) the merged-trace location."))
    p.add_argument("--procs", type=int, default=2,
                   help="world size (worker processes) for generation 0")
    p.add_argument("--robots", type=int, default=8)
    p.add_argument("--mesh-size", type=int, default=1,
                   help="local device-mesh size per rank (one device in "
                        "this package)")
    p.add_argument("--device", default="cuda",
                   help="each rank's device: cuda (default) or cpu")
    p.add_argument("--n", type=int, default=64,
                   help="poses in the synthetic demo problem")
    p.add_argument("--num-lc", type=int, default=12)
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--verdict-every", type=int, default=4)
    p.add_argument("--workdir", default=None)
    p.add_argument("--telemetry-dir", default="",
                   help="enable fleet telemetry rooted here: launcher "
                        "run + per-rank generation-scoped runs, "
                        "post-generation harvest, and ONE merged Chrome "
                        "trace at <dir>/fleet_trace.json (in worker "
                        "mode: this rank's own run directory)")
    p.add_argument("--session", default="multihost-solve")
    p.add_argument("--barrier-timeout", type=float, default=20.0)
    p.add_argument("--first-barrier-timeout", type=float, default=600.0)
    p.add_argument("--init-timeout", type=float, default=300.0)
    p.add_argument("--max-generations", type=int, default=3)
    p.add_argument("--kill-rank", type=int, default=-1,
                   help="chaos: the rank to kill -9 in generation 0")
    p.add_argument("--kill-at-boundary", type=int, default=-1,
                   help="chaos: the victim SIGKILLs itself at this "
                        "verdict boundary (deterministic)")
    p.add_argument("--kill-after", type=float, default=None,
                   help="chaos: the launcher kill -9s --kill-rank after "
                        "this many seconds (wall-clock)")
    # Hidden worker-mode flags (the launcher spawns these).
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    p.add_argument("--generation", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint-dir", default="", help=argparse.SUPPRESS)
    p.add_argument("--out", default="", help=argparse.SUPPRESS)
    p.add_argument("--launch-stamp", default="", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.worker:
        return run_worker(args)
    kill_rank = args.kill_rank if args.kill_rank >= 0 else None
    kill_at = args.kill_at_boundary if args.kill_at_boundary >= 0 else None
    summary = launch_world(
        args.procs, robots=args.robots, mesh_size=args.mesh_size,
        n=args.n, num_lc=args.num_lc, noise=args.noise, seed=args.seed,
        rounds=args.rounds, verdict_every=args.verdict_every,
        workdir=args.workdir, barrier_timeout_s=args.barrier_timeout,
        first_barrier_timeout_s=args.first_barrier_timeout,
        init_timeout_s=args.init_timeout,
        kill_rank=kill_rank, kill_at_boundary=kill_at,
        kill_after_s=args.kill_after,
        max_generations=args.max_generations, session=args.session,
        telemetry_dir=args.telemetry_dir or None, device=args.device)
    res = summary["result"]
    # ONE machine-readable line (json.loads-able whether callers read
    # the whole file or the last line) — the scripting/CI contract.
    outcome = {
        "world_sizes": summary["world_sizes"],
        "recovered": summary["recovered"],
        "generations": [{"generation": g["generation"],
                         "world_size": g["world_size"],
                         "outcomes": g["outcomes"]}
                        for g in summary["generations"]],
        "resume_iteration": res["resume_iteration"],
        "final_cost": res["final_cost"],
        "iterations": res["iterations"],
        "host_syncs_per_100_rounds": res["host_syncs_per_100_rounds"],
        "boundaries": res["boundaries"],
        "workdir": summary["workdir"]}
    if "telemetry" in summary:
        tel = summary["telemetry"]
        outcome["telemetry"] = {
            k: tel[k] for k in ("dir", "trace", "streams", "spans",
                                "flows", "pids", "error") if k in tel}
    print(json.dumps(outcome, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
