#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``dpgo_tpu_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA device (exits non-zero without one).  Builds the port's
CUDA kernels from ``dpgo_tpu_torch/csrc`` with ``nvcc``, holds each kernel
against its plain PyTorch version on the card, drives the two paths on the
synthetic stand-in for sphere2500 (2500 poses, 4948 edges, 8 robots, rank
5, float32) and times the kernels:

* ``solve`` — the single-device JACOBI RBCD solve
  (``models.rbcd.prepare_problem`` + ``dispatch_prepared``), kernel B2:
  the process's first dispatch, timed, then the counted one;
* ``refine`` — a float32 JACOBI descent to a fixed round count, then the
  re-centered terminal refinement (``models.refine.solve_refine``,
  accelerated, 3 cycles of 50 rounds towards an unreachable target) from
  the float64 handoff iterate, kernel B4 once per refine round;
* ``ablate`` — the round ablation of ``experiments.measure_r3``: fused
  rounds, the exchange plus gradient pass, and the gradient pass plus
  kernel B3 launches, with B3's per-agent stats;
* ``schedules`` — ``dispatch_prepared`` with GREEDY, ASYNC, COLORED,
  JACOBI + Nesterov and COLORED + GNC_TLS (on a stand-in with gross
  loop-closure outliers), kernel B2 once per round; one segment of each
  runs under ``torch.cuda.set_sync_debug_mode("error")``; GNC's final
  weights are held against the plain "ell" formulation's, and the run is
  continued for as many rounds again;
* ``verdict`` — the device-resident verdict loop (``run_rbcd`` with
  ``verdict_every``): the ``solve`` configuration with K = 8 against the
  per-eval run, bit for bit; one K-round window of segments and verdict
  steps under the sync-error debug mode, and the word's pinned copy read
  while the stream is still busy; the production arm (2048 rounds,
  K = eval_every = 512, no tolerance that stops it), warm then counted,
  with its host syncs per 100 rounds counted through ``rbcd._host_fetch``;
* ``odometry_init`` — the card's lifted odometry init against the host's
  float64 one, and ``solve_rbcd(init="odometry", verdict_every=8)``;
* ``robust_iterated`` — ``solve_rbcd_robust_iterated`` (2 passes, chordal
  init, K = 50) on the GNC stand-in, with the GNC row's gates and the
  plain "ell" formulation's ``kept`` mask beside the kernel's;
* ``certify`` — (a) bench_convergence.py's f* protocol in float64 on the
  card (``local_pgo.solve_local`` at rank 5 to gradient norm 1e-9, then
  ``certify.certify_solution``) and the deflated device payload on the
  same iterate, each eigensolve held against ``torch.linalg.eigvalsh`` of
  the assembled S on the card (an oracle only) and reported, the host
  float64 eigensolve (``certify.lambda_min_f64_shift_invert``) gated
  against it and every verdict gated for soundness against that; (b) the slice's main path, ``solve`` with
  ``certify_mode="device"`` through the verdict loop (K = 8), kernel B2
  once per round and the certificate payload in the one terminal fetch
  (fetches = words + 1), the certified epilogue run again under the
  sync-error debug mode and timed, a 20-iteration payload traced with
  ``torch.profiler`` and the small eigensolves timed, its verdict
  checked for soundness
  against the host float64 eigensolve on the fetched iterate, and one
  ``certify_mode="host"`` run through the per-eval loop; (c)
  ``certify.solve_staircase`` in float64 on the stand-in from rank 4,
  its verdict held for soundness against the host float64 eigensolve,
  and the staircase's loop from the wound critical point of
  ``make_stitched_winding`` (fails at rank 2, escapes, certifies).  (a)
  and (c) launch no kernel of the library (float64): they run first, on
  the card while ``nvcc`` builds the library at nice NVCC_NICE;
* ``dense`` — the dense-Q formulation (``dense_quadratic=True``): 10
  rounds from the host's chordal init against the "ell" formulation's,
  within B2's 10-round bound, with no kernel launched; Q built twice bit
  for bit; one K-round verdict window under the sync-error debug mode;
  its time per round beside B2's (a record), and one dense round traced
  by ``torch.profiler`` (the device busy share);
* ``dist_init`` — ``models.dist_init.distributed_initialization`` on the
  card in float32 (the alignment in float64) against the float64 CPU
  run: the same inlier sets, X0 within 1e-4 of max |X0|; its host syncs
  and seconds; ``solve_rbcd(init="distributed", verdict_every=8)`` beside
  the chordal-init solve; the init on the GNC stand-in, with the outlier
  shared-edge candidates the alignment rejected;
* ``fused_refine`` — bench_convergence.py's fused arm: 110 descent rounds
  (B2), ``models.refine_fused``'s df32 recenter on the card (held against
  the host float64 ``refine.recenter``) and ``refine_until`` (B4 every
  round, the oracle every 8, 192 rounds enqueued), sync-free up to the
  one fetch (``_host_fetch``), then the host float64 verify: the gap to
  the certify phase's f* at most 1e-6, the oracle within 1e-8 of f*;
* ``agents`` — the per-robot deployment runtime (``agent.PGOAgent`` over
  ``comms``; after ``verdict``, whose production arm's final cost it
  gates against): the native g2o loader and topology planner against the
  Python ones on the stand-in's g2o file; eight robots over
  ``comms.loopback_fleet`` in lockstep to consensus (at most 300
  rounds), the team cost within 1% of the production arm's, B2 launches
  equal to the stepped iterates and host reads (``agent._host_read``)
  equal to one per stepped iterate plus one per publish; B2 at A=1 on
  agent 3's operands at its first and last iterate against its plain
  version, and timed; 10 in-process rounds of the fleet through B2
  against an "ell" fleet, within twice that fleet's divergence from
  starts moved by one ulp; ``status_fetch_every=8`` reading 1/8 per
  iterate, and one off-cadence iterate under the sync-error mode; a
  chaos arm (10% drop, 25% delay, 5% reorder, robot 7 killed at round
  40) within 1% of a fault-free arm; the async Poisson-clock loop at
  50 Hz with overlapped bus clients for 5 s, every thread joined, one
  second traced;
* ``telemetry`` — the solve paths with an ``obs`` run on (after
  ``verdict``): the production arm with telemetry off and on in this
  process (rounds/s of both; host syncs per 100 rounds 2 x 100/K on, by
  the run's own ``host_syncs_per_100_rounds`` and through
  ``_host_fetch``, 100/K off), its ``solver_cost`` events equal to the
  returned history and ``report.render_report`` of the run; a
  ``FlightRecorder`` black box taken in the verdict loop (K = 16, 64
  rounds) replayed on the card from its first snapshot, bit for bit; a
  ``devprof.DeviceTraceWindow`` over 20 fused rounds, B2's device time in
  the ``torch.profiler`` trace within 10% of the same launches between
  CUDA events (less an empty event pair per launch), and the window's
  device busy share;
* ``tcp`` — ``python -m dpgo_tpu_torch.examples.tcp_deployment_example``
  with eight robot processes on the card over localhost TCP (after
  ``agents``): lockstep with ``--telemetry`` for 60 rounds under the
  chaos arm's round deadline (consensus reached, the team cost within 1%
  of the production arm's, the merged fleet timeline with spans and flow
  edges) as the fault-free arm of a chaos arm (``agents``' fault spec
  over TCP, robot 7 killed at round 40, the survivors within 1% of the
  fault-free arm), and the async loop at 50 Hz for 250 rounds with
  staleness 1 (iterates per robot, the device busy share as
  the robots' summed CUDA-event step time over the wall); every robot
  process's B2 launches equal its stepped iterates;
* ``serve`` — the serving plane (``dpgo_tpu_torch.serve``; after
  ``tcp``): eight requests (the stand-in at 2500, 2480, 2460 and 2440
  poses, seeds 0 and 1) prepared and padded to their buckets (prepare ms,
  the chordal init's host syncs); the eight padded to one shape, B2 on
  each padded member against B2 on its unpadded problem, and solved as
  one batch by ``run_bucket`` (B2 once per round over 64 agents),
  per-eval and verdict (K = 8) bit for bit, host fetches one per eval
  (word) plus one, each member within 1e-5 of its own sequential solve's
  final cost, its ten batch rounds equal to its padded problem's alone
  and held to the 10-round trajectory rule where "ell" itself meets the
  rule's cap, B2's step at each of "ell"'s ten iterates against the
  plain version on every member, B2 timed at 64 agents; the serving
  paths' B2 launches counted by agents per launch; a
  ``SolveServer`` with a telemetry run and its warm pool serving four
  copies of two stand-in requests from each of two tenants (copies bit
  for bit equal, every batch a cache hit, ``serve_request`` events, a
  ``/metrics`` scrape); ``python -m dpgo_tpu_torch.serve --port 0`` on the
  card answering ``solve_g2o`` within 1e-6 of the in-process front-end;
  bench_streaming.py's protocol (+5% loop closures: the delta path, its
  tiles equal to a fresh pad bit for bit, the warm arm within 1e-5 of the
  cold arm with B2 once per round, the warm/cold wall ratio);
* ``fleet`` — the serving fleet (``dpgo_tpu_torch.serve.fleet``; after
  ``serve``, on its eight requests, 20 rounds each, the long sessions
  300): eight session-tagged requests, twice each, through a
  ``FleetRouter`` over two in-process replicas on the card, each on its
  rendezvous replica both times and within 1e-5 of a lone
  ``SolveServer``'s cost; a drain migration (``migrate_from``) resumed
  from its snapshot bit for bit against the uninterrupted solve;
  ``kill_replica`` with three sessions in flight (none lost, the
  in-flight one resumed, the pool respawned) and the autoscaler at a
  zero queue-wait SLO, then ``scale_down``; two child replicas
  (``ProcServer``, each its own process and CUDA context) behind the
  router on an empty artifact tier: the cold one stores the kernel
  library, the warm one binds it from the tier (no nvcc, no compile
  seconds, the cold one's result bit for bit), then the cold one is
  ``SIGKILL``ed with two sessions in flight (dead within the heartbeat
  budget, the sessions finished on the other from the shared store);
  a third child on a corrupted entry quarantines it and still serves;
  B2 launches equal rounds for each in-process replica and each child
  (its telemetry's dispatch spans); requests/s of one and two replicas
  (a record: they share the card).

* ``config5`` — BASELINE.md config #5 (100,000 poses, 64 robots, seed
  11, noise 0.05, 20,000 loop closures, rank 5, float32; made once and
  shared with ``sharded``) through the main path, ``rbcd.solve_rbcd``
  with the odometry init and the verdict loop (12 rounds, K = 4): B2 once
  per enqueued round on the spread route (``csrc/rtr_spread.cu``; the
  ``solve`` line carries the four kernels' plan at this shape: B1, B2, B3
  and B4 spread); B2, and B3 and B1 fed the gradient pass there, at the
  terminal iterate against their plain versions (max |ΔX|, or |Δeta|, on
  live rows at most 1e-4 of the largest live entry, ROADMAP's
  accept-flip rule for B2 and B3), against themselves bit for bit with
  the same tCG iterations, and timed in turns with the workspace route
  (spread, workspace, workspace, spread) beside their bounds; B3 against
  one B2 launch at the same point (live rows, the flip rule); B2 at ranks 7
  and 10 (the staircase's default top; C = 4 there) at the odometry init
  of config #5's graph, held and timed, and B4 at rank 10 recentered
  there, held on the spread and workspace routes and timed; B4 at this
  shape (constants recentered at the terminal iterate, three refine
  rounds in) against its plain version on the spread and workspace
  routes, timed on both;
* ``big_agents`` — config #5's measurements (``config5``'s, made once)
  over 4 robots, 25,000 poses an agent, where no spread holds an agent
  and B2 and B4 take the grid route (``csrc/rtr_grid.cu``: 33 CTAs an
  agent over the whole card): ``rbcd.solve_rbcd`` (odometry init, 8
  rounds at K = 4), its plan printed, B2 once per enqueued round, costs
  finite and falling, the run equal bit for bit to ``dispatch_prepared``
  from the same problem, and its iterate within ``trajectory_gap``'s
  limit of the "ell" formulation's (twice that formulation's own
  divergence from starts moved by one ulp, at most 1e-3); B2 at the
  terminal iterate against its plain version (``config5``'s gates),
  against itself bit for bit and timed in turns with the workspace route
  (few runs there: it takes tens of milliseconds); B4 recentered at the
  terminal iterate, three refine rounds in (B4 once a round), held on
  the grid and workspace routes, bit for bit, timed on both; and B2 on the
  whole graph as one agent (132 CTAs; the ``PGOAgent`` case) at the
  odometry init, held and timed alone;
* ``ranks`` — every (r, d) the kernel library holds, which must be the
  staircase's d = 3 with 3 <= r <= 10 and d = 2 with 2 <= r <= 10
  (``csrc/shapes.cuh``): B1-B4 on the planned (cluster) route and on the
  workspace route at the card's chordal init (B4 recentered there), d = 3
  on the stand-in and d = 2 on the SE(2) stand-in (BASELINE.md config
  #4's size: 10,000 poses, 20,687 edges, 32 robots), each against its
  plain version and against itself bit for bit, timed in turns, its plan,
  plain time and bound on one line per shape;
* ``staircase`` — ``parallel.certify.solve_staircase_sharded`` in float32
  at world size 1 on the stand-in from rank 6 to rank 7: B2 once per
  round, B4 once per polish round, every rank's verdict held for
  soundness against the host float64 eigensolve on its iterate, seconds
  per rank;
* ``se2`` — SE(2) end to end on its stand-in: ``solve_rbcd`` over 32
  robots at rank 3 with GNC through the verdict loop (B2 once per
  enqueued round), then the f32 distributed staircase from rank 4 to
  rank 5 (500 Nesterov-accelerated rounds a rank, eta 0.1), held as
  ``staircase``;
* ``high_ranks`` — B1-B4 of the rank-generic instantiation (every r >=
  11) on every route each reaches, against its plain version and itself,
  timed: on the stand-in and the SE(2) stand-in up to the JAX gate's top
  ranks there (73, 78; up to r = 32 B2 and B4 on every cluster layout, r
  lanes a pose or folded over 8 and 16 lanes, and the spread route, in
  turns: ``fold_layouts``), and on the smallGrid3D-size stand-in (125 poses,
  296 edges, 4 robots) at r = 129, 256 (clusters), 512 (a spread of
  16-warp poses, the lane cap), 513 and 1636 (the gate's top; the
  spread route's folded rows), and at the gate's top ranks on 16-pose
  agents (3360 at d = 3, 4482 at d = 2); wherever B3 plans the spread
  route, B3 against one B2 launch at the same point; the round ablation
  at r = 11 (cluster) and 73 (spread), and an f32 staircase from r = 11;
* ``top_ranks`` — ``solve_rbcd``'s path on the smallGrid3D-size stand-in
  at r = 256 and 1636, 10 float32 rounds (B2 once a round) held to the
  port's float64 run on the host, then 3 refine rounds at r = 1636 (B4
  once a round) against the "ell" formulation's;
* ``orbax`` — the Orbax checkpoint pair (``utils.logger``, its own zstd
  decoder and OCDBT reader, no ``orbax`` package): the committed
  checkpoint the JAX package wrote (``tests/torch_data/orbax_seed0``)
  loaded bit for bit; 25 rounds on the stand-in (B2 once a round),
  saved, loaded and resumed on a fresh state through
  ``refresh_problem``, 15 rounds more, held against the uninterrupted 40
  by ``trajectory_gap``'s limit; save and load timed at config #5's
  shapes, with the bytes written; and no ``jax``, ``orbax``,
  ``tensorstore`` or ``zstandard`` in ``sys.modules``;

Every launch gate is exact: the rounds each run enqueued, the per-eval
loop's discarded speculative segment and the verdict loop's polish and
speculative windows included (``rbcd.rounds_enqueued``).

Before the paths: B2 and B3 against their plain versions at the chordal
init and at the float32 floor (200 fused rounds), for all agents and for
agent 0 alone; B2's 10 rounds against the "ell" formulation's, gated by
that formulation's own divergence from starts moved by one ulp; and
``determinism``: the card's chordal init and preconditioner factors
repeat bit for bit, and B2's 10-round check from the card's own start
repeats; B1 against its plain version at three radii on both routes.
After the solve, B2 and B3 are timed on the cluster route and on the
workspace route (``_cluster=0``) at both operand sets, B1 on both routes,
and B2 at every cluster size the card can place (``cluster_sweep``); in
the refine phase B4 is held against its plain version on both routes and
timed on both and at every cluster size, and at one agent of the whole
stand-in (2500 poses) on the spread and workspace routes.  The ``plan``
line gives the route of all four kernels at the slice shape.  The kernel
table lists each kernel's routes, and the spread route of each kernel as
a row of its own (``rtr_full_spread``, ``rtr_spread``, ``tcg_spread``,
``rtr_refine_full_spread``, timed at config #5).

Each phase prints JSON lines, each with ``elapsed_s`` since the start,
and a ``seconds`` line when it ends; any failure raises.  The line before the
last is the kernel table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--profile`` traces the first
dispatch, one more solve and one more refine cycle with ``torch.profiler``
(device busy share, the kernels by device time, the host ops by host
time; per refine round for the cycle).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from dpgo_tpu_torch import agent as agent_mod  # noqa: E402
from dpgo_tpu_torch import comms, interop, robust  # noqa: E402
from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,  # noqa: E402
                                   RobustCostType, Schedule, SolverParams)
from dpgo_tpu_torch.experiments import measure_r3  # noqa: E402
from dpgo_tpu_torch.models import (certify, dist_init,  # noqa: E402
                                   local_pgo, rbcd, refine, refine_fused)
from dpgo_tpu_torch.ops import averaging, df32, quadratic, solver  # noqa
from dpgo_tpu_torch.ops import rtr_kernel as rk  # noqa: E402
from dpgo_tpu_torch.utils import g2o, graph_plan, logger  # noqa: E402
from dpgo_tpu_torch.utils import native_io  # noqa: E402
from dpgo_tpu_torch.utils import partition  # noqa: E402
from dpgo_tpu_torch.types import edge_set_from_measurements  # noqa: E402
from dpgo_tpu_torch.utils.synthetic import (  # noqa: E402
    make_measurements, make_stitched_winding, rejection_scores)

#: The main path's problem: bench.py's synthetic sphere2500 stand-in.
N_POSES, NUM_LC, ROBOTS, RANK = 2500, 2449, 8, 5
MAX_ITERS, GRAD_TOL = 200, 0.1
#: The refine path (bench_convergence.py's settings: tight local solves,
#: no consensus stop): descent rounds, then cycles of refine rounds.
DESCENT_ROUNDS, REFINE_CYCLES, ROUNDS_PER_CYCLE = 300, 3, 50
#: Parity bounds on the card (float32; summation order differs between
#: the kernel and the plain version).
X_ATOL, STAT_RTOL = 1e-4, 1e-4
#: B2's 10 rounds against the "ell" formulation's from the host's start:
#: at most TRAJ_SPREAD times the largest divergence of "ell" itself from
#: the PERTURBED_STARTS starts moved by one ulp, and never above TRAJ_MAX.
TRAJ_SPREAD, TRAJ_MAX = 2.0, 1e-3
#: The orbax phase: the checkpoint the JAX package's Orbax pair wrote from
#: ``np.random.default_rng(0)`` (``tests/test_torch_orbax.py`` gives the
#: snippet), the rounds before the save and after the resume, and config
#: #5's checkpoint shapes (64 agents of n_max 1594 at r = 5, d = 3; 2236
#: edge slots an agent).
ORBAX_FIXTURE = ROOT / "tests" / "torch_data" / "orbax_seed0"
ORBAX_ROUNDS = (25, 15)
C5_CHECKPOINT = {"X": (64, 1594, 5, 4), "weights": (64, 2236)}
#: Modules the port must never load (``orbax`` phase, check (d)).
FOREIGN_MODULES = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard",
                   "dpgo_tpu")
#: Fused JACOBI rounds from the chordal init to the float32 floor, where
#: B2 rejects every attempt on most agents (B2's and B3's second operand
#: set).  An accept decision there that differs from the plain version's
#: must have moved f by at most FLOOR_DF_RTOL of f0 (float32 rounding of
#: a sum of ~1e3 terms).
FLOOR_ROUNDS, FLOOR_DF_RTOL = 200, 1e-5
#: B4 parity: the correction's change relative to the step's own size, and
#: the cost increments relative to their largest magnitude (both are small
#: differences of float32 sums taken in another order).
D_STEP_RTOL, DF_RTOL, D_TRAJ_RTOL = 1e-3, 1e-3, 1e-2
#: The schedules phase: eval cadence, round cap, and the GNC stand-in's
#: gross loop-closure outliers (appended last by make_measurements).
SCHED_EVAL_EVERY, SCHED_MAX_ITERS, SCHED_OUTLIERS = 10, 200, 50
#: GNC on the card: at most this share of the inliers may end below weight
#: 0.5 (a weight update that rejects every loop closure gives 1), and the
#: "ell" formulation's final weights may sort at most this share of the
#: measurements to the other side of 0.5.
GNC_INLIER_REJECT_MAX, GNC_ELL_FLIP_MAX = 0.2, 0.01
#: Starts moved by about one ulp for the spread of B2's 10-round check.
PERTURBED_STARTS = 4
#: Rounds of the ablation's timed loops (the JAX script's N).
ABLATE_ROUNDS = 200
#: The verdict loop: K of the parity run against the per-eval ``solve``
#: run; the production arm of bench.py (rounds, K = eval_every); K of the
#: odometry-init solve and of each iterated-GNC pass.
VERDICT_K, PROD_ROUNDS, PROD_K = 8, 2048, 512
ODO_K, ITER_PASSES, ITER_K = 8, 2, 50
#: The odometry init on the card against the host's float64 one, relative
#: to the largest lifted translation entry (float32 compositions over a
#: 2500-pose chain).
ODO_RTOL = 1e-4
#: GPU cycles the card spins (``torch.cuda._sleep``) after the word's copy
#: starts, so a fetch that waited on the stream would be seen waiting.
SPIN_CYCLES = 200_000_000
#: The certify phase: bench_convergence.py's f* solve (rank, gradient
#: tolerance, iteration cap; float64); K of the certified solve; the
#: agreement of an eigenvalue with the dense oracle's, relative to
#: max(1, |lambda|); the staircase's lowest rank on
#: the stand-in, its top rank, and the wound instance (cycles, length).
CERT_RANK, CERT_GTOL, CERT_MAX_ITERS, CERT_K = 5, 1e-9, 1000, 8
CERT_LAM_TOL = 1e-6
STAIR_R_MIN, STAIR_R_MAX, WIND_CYCLES, WIND_LEN = 4, 6, 8, 16
#: LOBPCG iterations of the wound instance's certificates: at the failing
#: rank its escape direction only (an eigenvalue near -5.86, far below
#: -tol); at the rank that certifies, 384 dimensions, where 100 iterations
#: converge (300, ``certify_solution``'s default, until the rank
#: staircase's phases needed the script's time).
WIND_ESCAPE_LOBPCG = 100
#: LOBPCG iterations of the f* iterate's two launch-bound eigensolves
#: (``certify_solution`` and the deflated device payload, ~18 s each at
#: 300): every gate on them is a soundness gate against the host float64
#: eigensolve and the dense oracle, which holds at any iteration count,
#: and their agreement with the oracle, reported only, is not met at 300
#: either (10,000 dimensions).
FSTAR_LOBPCG = 100
#: The nice value of the kernels' build, which runs beside the certify
#: phase's float64 parts (``build_beside``): the compilers yield the cores
#: to the script's own thread.
NVCC_NICE = 19
#: The fused refinement (bench_convergence.py's fused arm): descent rounds
#: before the handoff, the tCG budget, the refine rounds' cap and the
#: oracle's cadence, and the gap to reach (the oracle stops at 0.3 of it).
FIRST_SEGMENT, FUSED_INNER, FUSED_MAX_ROUNDS, FUSED_CHECK = 110, 6, 192, 8
FUSED_GAP = 1e-6
#: Published H100 SXM peaks (dense FP32 outside the tensor cores; HBM3).
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
#: The serve phase: the requests (stand-in poses x seeds), the bucket
#: quantum, the batch's rounds and K, the copies of each stand-in request
#: per tenant at the server; a member's final cost against its sequential
#: solve (and a served ticket's against its batch member), the TCP cost
#: against the in-process one, the warm streaming cost against the cold
#: one; bench_streaming.py's streamed fraction, round cap and tolerance.
SERVE_SIZES, SERVE_SEEDS = (2500, 2480, 2460, 2440), (0, 1)
SERVE_QUANTUM, SERVE_ROUNDS, SERVE_K, SERVE_TENANT_COPIES = 32, 100, 8, 4
SERVE_COST_RTOL, TCP_COST_RTOL, STREAM_COST_RTOL = 1e-5, 1e-6, 1e-5
#: The batch and the server run every one of their SERVE_ROUNDS rounds
#: (``rel_change_tol`` 0, this gradient tolerance), so final costs compare
#: at one round count.
SERVE_GTOL = 1e-9
STREAM_FRAC, STREAM_ITERS, STREAM_GTOL = 0.05, 400, 1e-9
#: The fleet phase (the serve phase's requests): rounds of a request and
#: its eval cadence (a session snapshot every eval), and rounds of the
#: sessions a drain or a kill stops mid-flight.
FLEET_ROUNDS, FLEET_EVAL, FLEET_LONG_ROUNDS = 20, 10, 300
#: The sharded phase (``parallel``, world size 1 over NCCL): rounds and K
#: of the stand-in's equivalence runs; rounds before the GN tail and its
#: outer steps; the resilience run's K, rounds, NaN-halo round and
#: device-loss round (four K-windows apart, so the NaN's anomaly word is
#: fetched and rewound before the loss fails a later fetch); the
#: multihost demo (processes, robots, rounds, K,
#: the victim's boundary, and the kill arm's steady-state barrier timeout,
#: its fault-detection latency: a boundary of K rounds here takes
#: milliseconds); BASELINE.md config #5 (poses, robots, seed,
#: noise, loop-closure share, rounds, K).
SHARD_ROUNDS, SHARD_K, SHARD_TAIL_ROUNDS, SHARD_TAIL_OUTER = 64, 8, 200, 4
RES_K, RES_ROUNDS, RES_NAN, RES_LOSS = 4, 48, 13, 29
MH_PROCS, MH_ROBOTS, MH_ROUNDS, MH_K, MH_KILL_AT = 2, 8, 24, 4, 3
MH_BARRIER_S = 3.0
SCALE_POSES, SCALE_ROBOTS, SCALE_SEED, SCALE_NOISE, SCALE_LC = \
    100_000, 64, 11, 0.05, 0.2
SCALE_ROUNDS, SCALE_K, SCALE_OUTER = 8, 4, 4
#: The config5 phase (config #5 through ``solve_rbcd``): rounds, K, and
#: the ranks above the solve's where B2 is held once more (r = 7, the
#: staircase's default top, and r = 18, the top rank the JAX package's
#: VMEM gate admits at config #5's agents); B4 is held too at r = 10 (the
#: templated top shape) and r = 18 (the rank-generic instantiation).
C5_ROUNDS, C5_K, C5_TOP_RANKS = 12, 4, (7, 10, 18)
#: The big_agents phase (config #5's measurements over few robots, where
#: B2 and B4 take the grid route): robots, rounds, K, and the workspace
#: route's timing runs (runs, launches a run; it takes tens of ms).
BIG_ROBOTS, BIG_ROUNDS, BIG_K = 4, 8, 4
BIG_WS_REPS = (2, 2)
#: The rank staircase's default top (``certify.solve_staircase``,
#: ``parallel.certify.solve_staircase_sharded``): the kernels hold every
#: (r, d) with d in (2, 3) and d <= r <= RANK_TOP as templated shapes.
RANK_TOP = 10
#: The ranks phase's timing: CUDA-event runs and launches per run of each
#: kernel, in turns with the workspace route; the shapes PERF.md tabulates.
RANK_REPS, RANK_INNER = 3, 5
PERF_SHAPES = ((7, 3), (10, 3), (4, 2), (10, 2))
#: The lane cap (``csrc/lanes.cuh``): one rank-generic instantiation per d
#: serves every r >= 11, and the cluster route lays a pose over ceil(r /
#: 32) warps of one CTA, up to r = LANE_CAP (16 warps); above it B1-B4
#: take the spread route with a pose's rows folded over 16 warps (the
#: ``*_fold_kernel``s of ``csrc/rtr_spread.cu``) wherever its shared
#: memory fits, else the workspace route.  The high_ranks
#: phase holds the generic instantiation at HIGH_RANKS[d]: a pose of r
#: lanes (one or two a warp), of one whole warp, and of two and three
#: warps, up to the top rank the JAX package's VMEM gate admits at each
#: stand-in's agents (73 on the sphere2500 stand-in, 78 on the SE(2)
#: stand-in), and at TOP_RANKS on the smallGrid3D-size stand-in over
#: TOP_ROBOTS (125 poses and 296 edges, the size of the reference's
#: smallGrid3D, 125 and 297; n_max 32): a cluster of five- and eight-warp
#: poses (129, 256), a spread of 16-warp poses (512), the first rank past
#: the cap (513) and the gate's top there (1636), and at the gate's top
#: ranks at 16-pose agents (SMALL_AGENT_TOP_RANKS); launches per timed run
#: (the workspace route takes milliseconds a launch; above LANE_CAP, tens
#: of milliseconds, it is timed in one run between two of the spread
#: route's).  B3's path there: the round ablation at each rank of
#: HIGH_ABLATE_RANKS, with the route B3 plans there (a cluster at 11; the
#: spread route at 73, the JAX gate's top on the stand-in), its rounds.
#: The f32 distributed staircase from rank 11 on the stand-in.
LANE_CAP = rk.MAX_LANE_RANK
HIGH_RANKS = {3: (11, 12, 16, 17, 32, 33, 73), 2: (11, 32, 33, 78)}
HIGH_INNER = 3
#: The cluster route's layouts of B2 and B4 at the high ranks up to 32
#: (``rk.FOLD_RANKS``), timed in turns (each layout once, then in reverse
#: order) at runs and launches a run: the row-a-lane layout (r lanes a
#: pose), the folded layout at 8 and 16 lanes a pose, and the spread route,
#: each where it fits.  ``rk.FOLD_RULE`` is written from these times.
LAYOUT_REPS, LAYOUT_INNER = 5, 5
SMALLGRID_POSES, SMALLGRID_LC, TOP_ROBOTS = 125, 172, 4
TOP_RANKS = (129, 256, 512, 513, 1636)
#: The JAX gate's top ranks at 16-pose agents (n_max 16, s_max 12, e_max
#: 24), by d: the highest ranks the TPU runs (B1-B4 spread, seven and
#: nine rows a lane), on 2 robots of a 32-pose graph (s_max 6, e_max 25 and
#: 26: admitted there).
SMALL_AGENT_TOP_RANKS = {3: 3360, 2: 4482}
#: The main path at the top ranks: ``solve_rbcd`` on the smallGrid3D-size
#: stand-in in float32 for TOP_ROUNDS rounds (no tolerance stops it) at
#: each of TOP_PATH_RANKS (a cluster at 256, at 1636, the gate's top, the
#: spread route with four rows a lane), held to the port's float64 run on
#: the host; then TOP_REFINE_ROUNDS refine rounds (B4, spread) at the top
#: one.
TOP_PATH_RANKS, TOP_ROUNDS, TOP_REFINE_ROUNDS = (256, 1636), 10, 3
HIGH_ABLATE_RANKS = {11: "cluster", 73: "spread"}
HIGH_ABLATE_ROUNDS = 20
#: The SE(2) stand-in at BASELINE.md config #4's size (city10000: 10,000
#: poses, 20,687 edges), its robots and rank.
SE2_POSES, SE2_LC, SE2_ROBOTS, SE2_RANK = 10000, 10688, 32, 3
#: The sharded certificate against the device payload (both float32 on
#: the card): the PSD tolerance eta, the smallest round value at which a
#: float32 eigensolve decides on the stand-in (decidable needs the error
#: band 10 eps sigma <= tol / 2 = eta * wscale / 2: eta >= 6.5e-3 at sigma
#: 2.73e5, wscale 100), and the lambda gap allowed, in float32 ulps of
#: sigma (the error band itself).
SHARD_CERT_ETA, SHARD_CERT_ULPS = 1e-2, 10
#: The f32 distributed staircase on each stand-in: its ranks, rounds per
#: rank and PSD tolerance eta, the smallest round value at which its
#: float32 eigensolve decides (the error band 10 eps sigma <= tol / 2 =
#: eta * wscale / 2, wscale 100): SHARD_CERT_ETA at the stand-in's sigma
#: (2.73e5), 0.1 at the SE(2) stand-in's (~2.5e6).  Below it a verdict
#: falls to the host's float64 LOBPCG, which at the SE(2) stand-in's
#: 30,000 dimensions takes minutes.  The SE(2) stand-in's long chains take
#: Nesterov-accelerated rounds (the JAX package's at-scale configuration
#: of the staircase) and more of them.
STAIR_SPHERE = dict(r_min=6, r_max=7, rounds_per_rank=300, accel=False,
                    eta=SHARD_CERT_ETA)
STAIR_SE2 = dict(r_min=4, r_max=5, rounds_per_rank=500, accel=True,
                 eta=0.1)
STAIR_HIGH = dict(r_min=11, r_max=12, rounds_per_rank=300, accel=False,
                  eta=SHARD_CERT_ETA)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


#: The script's start, and the end of the last phase ``lap`` timed.
T_START = time.perf_counter()
_LAP = [T_START]


def emit(obj) -> None:
    """Print one JSON line; a phase line also gets ``elapsed_s``, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def lap(phase: str) -> None:
    """The phase's line of ``seconds``: the wall since the last lap."""
    now = time.perf_counter()
    emit({"phase": phase, "check": "seconds", "seconds": now - _LAP[0]})
    _LAP[0] = now


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


def ptxas_report(log: str) -> list:
    """One line per compiled kernel: its name and (r, d), then what ptxas
    said of its registers and spills."""
    rows, name = [], None
    for ln in log.splitlines():
        # <R,D> of a templated or R = 0 kernel; <r,D> of the workspace
        # route's rank-generic kernels (``*_rt<D>``).
        m = re.search(r"\d([a-z][a-z_]*_kernel(?:_rt)?)I(?:Li(\d+)E)?Li(\d+)E",
                      ln)
        if "Compiling entry function" in ln and m:
            name = f"{m[1]}<{m[2] or 'r'},{m[3]}>"
            rows.append(name)
        elif name and ("registers" in ln or "spill" in ln):
            rows[-1] += " | " + ln.split(":", 1)[-1].strip()
    return rows


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
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [(e.key, e.self_cpu_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    device_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return {"rounds": rounds, "wall_s": wall,
            "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "device_kernels": len(rows),
            "device_kernel_calls": sum(r[2] for r in rows),
            "top": [{"name": k[:60], "device_ms": t / 1e3, "calls": c}
                    for k, t, c in rows[:8]],
            "top_host": [{"name": k[:60], "host_ms": t / 1e3, "calls": c}
                         for k, t, c in host[:8]]}


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


def rtr_work(ops: dict, out, graph, meta) -> tuple[int, int]:
    """B3: B2's work without the gradient sweep and the start point."""
    u = _unit_ops(meta.rank, meta.d)
    E = graph.edges.mask.sum(1).double()
    inc = graph.inc_mask.sum((1, 2)).double()
    n = graph.n.double()
    iters = out.tcg_iters.double()
    att = out.stats[:, 0].double()
    sweep = E * u["sweep_edge"] + inc * u["rk"]
    flops = (E * u["cost_edge"]
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

def tcg_operands(b3_ops: dict) -> dict:
    """B1's operands at B3's point: its S and g, radius 1."""
    tcg_ops = {k: b3_ops[k] for k in ("idx_i", "idx_j", "rot", "trn", "wk",
                                      "wt", "Xc", "Sc", "Lc", "gc")}
    tcg_ops.update(radius=torch.ones(b3_ops["Xc"].shape[0],
                                     device=b3_ops["Xc"].device),
                   inc_slot=b3_ops["inc_slot"], inc_mask=b3_ops["inc_mask"])
    return tcg_ops


def rounds_from(X0, graph, meta, params, chol=None):
    """X after 10 JACOBI rounds from ``X0`` in the formulation ``params``
    picks; ``chol`` replaces the preconditioner factors ``init_state``
    makes."""
    st = rbcd.init_state(graph, meta, X0, params)
    if chol is not None:
        st = st._replace(chol=chol)
    for _ in range(10):
        st = rbcd.rbcd_step(st, graph, meta, params)
    return st.X


def trajectory_gap(X0, graph, meta, params, plain) -> float:
    """Max |ΔX| after 10 JACOBI rounds from ``X0`` through the kernel
    (``params``) and through the "ell" formulation (``plain``)."""
    return float((rounds_from(X0, graph, meta, params)
                  - rounds_from(X0, graph, meta, plain)).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


REFINE_ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "rho_rot",
                "rho_trn", "Rc", "Dc", "Dzc", "g0c", "Grefc", "S0c", "Lc",
                "inc_slot", "inc_mask", "n_local")


def refine_operands(D, consts, graph) -> dict:
    Dz = rbcd.neighbor_buffer(rbcd.public_table(D, graph), graph)
    return dict(zip(REFINE_ORDER,
                    refine.refine_kernel_operands(D, Dz, consts, graph)))


def refine_parity(ops: dict, kw: dict,
                  cluster: int | None = None) -> tuple[dict, object]:
    """B4 on its planned route (``cluster=None``) or a forced one against
    its plain version on one refine round's operands."""
    out = rk.rtr_refine_full(*ops.values(), _cluster=cluster, **kw)
    ref = rk.rtr_refine_full_reference(*ops.values(), **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.D).all() and torch.isfinite(out.stats)
               .all()), "rtr_refine_full returned non-finite values")
    step = float((ref.D - ops["Dc"]).abs().max())
    err_d = float((out.D - ref.D).abs().max())
    df = ref.stats[:, 2:4]
    route = plan_of(ops, kw, "rtr_refine_full", cluster)
    row = {"cuda_route": route.route, "cluster": route.C,
           "max_abs_dD": err_d, "max_abs_step": step,
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
          f"rtr_refine_full kernel disagrees with its plain version "
          f"({route.route} route)")
    return row, out


def gradnorm64(X64: np.ndarray, e64) -> float:
    """The f64 central gradient norm of a projected global iterate."""
    return refine.central_gradnorm64(X64, e64, len(X64), 3)


def refine_phase(prob, meas, card: str, profile: bool) -> list:
    """The refine path, counted, its parity checks on the card, B4's
    timing, and (``profile``) one traced refine cycle.  Returns B4's row
    of the kernel table and the descent's B2 launches."""
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
    # Both routes at 8 agents: the plan's (a cluster per agent) and the
    # workspace route on the same operands.
    row, out = refine_parity(ops, kw)
    emit({"phase": "parity", "kernel": "rtr_refine_full", "agents": ROBOTS,
          **row})
    check(row["cuda_route"] == "cluster" and row["cluster"] > 1,
          "B4 does not take clusters of several CTAs at the slice shape")
    err_d = row["max_abs_dD"]
    row_ws, _ = refine_parity(ops, kw, cluster=0)
    emit({"phase": "parity", "kernel": "rtr_refine_full", "agents": ROBOTS,
          **row_ws})

    # One agent of 2500 poses: no cluster holds it (the spread route), and
    # the workspace route on the same operands.
    part1 = partition.partition_contiguous(meas, 1)
    g1, m1 = rbcd.build_graph(part1, RANK, torch.float32, dev)
    ref1 = refine.recenter(Xg64, g1, m1, rparams, edges64)
    ops1 = refine_operands(torch.zeros_like(ref1.consts.R), ref1.consts, g1)
    kw1 = rbcd.kernel_options(rparams, m1)
    for cluster in (None, 0):
        row1, _ = refine_parity(ops1, kw1, cluster)
        emit({"phase": "parity", "kernel": "rtr_refine_full", "agents": 1,
              "e_max": m1.e_max, "payload_bytes": m1.e_max * 144, **row1})
    check(plan_of(ops1, kw1, "rtr_refine_full").route == "spread",
          "one agent of the whole problem left the spread route")

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

    # --- timing at the slice shape: both routes, every cluster size ------
    b4_t = route_timing(rk.rtr_refine_full, ops, kw, out)
    plain_ms = cuda_ms(
        lambda: rk.rtr_refine_full_reference(*ops.values(), **kw), reps=5,
        warmup=1)
    nbytes, flops = rtr_refine_full_work(ops, out, graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    emit({"phase": "timing", "card": card, "kernel": "rtr_refine_full",
          **b4_t, "plain_ms": plain_ms})
    emit({"phase": "cluster_sweep", "card": card, "kernel": "rtr_refine_full",
          "n_max": meta.n_max, "kinc": ops["inc_slot"].shape[-1],
          "rows": cluster_sweep(rk.rtr_refine_full, {"refine_round": ops},
                                kw)})
    if profile:
        def cycle():
            refine.refine_rounds_accel(D0, ref.consts, graph, meta, rparams,
                                       ROUNDS_PER_CYCLE)
            return ROUNDS_PER_CYCLE
        prof = profile_run(cycle)
        emit({"phase": "profile", "path": "refine", "card": card, **prof,
              "wall_ms_per_refine_round": 1e3 * prof["wall_s"]
              / ROUNDS_PER_CYCLE,
              "device_busy_ms_per_refine_round": 1e3 * prof["device_busy_s"]
              / ROUNDS_PER_CYCLE})
    return {"name": "rtr_refine_full", "route": "cuda",
            "source": "dpgo_tpu_torch/csrc/rtr_cluster.cu",
            "replaces": "dpgo_tpu/ops/pallas_tcg.py:715",
            "launches_by_path": {"refine": launches["rtr_refine_full"]},
            "max_abs_err": err_d, **one_set_columns(b4_t),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "bytes": nbytes, "flops": flops}, \
        launches["rtr_full"]


B2_ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "Xc", "Zc", "Lc",
            "inc_slot", "inc_mask", "n_local")
B3_ORDER = ("idx_i", "idx_j", "rot", "trn", "wk", "wt", "Xc", "Zc", "Sc",
            "Lc", "gc", "inc_slot", "inc_mask", "n_local")


def operand_sets(prob, params, X) -> tuple[dict, dict]:
    """B2's and B3's operands at ``X`` (B3 fed the gradient pass's g and
    S), with the factors ``init_state`` makes."""
    graph, meta = prob.graph, prob.meta
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    chol = rbcd.precond_chol(graph.edges, graph, params)
    g, _, S = rbcd.gradient_pass(X, graph, meta)
    return (dict(zip(B2_ORDER, rbcd.kernel_operands(X, Z, graph.edges, chol,
                                                    graph))),
            dict(zip(B3_ORDER, rbcd.b3_operands(X, Z, g, S, graph.edges,
                                                chol, graph))))


def first_agent(ops: dict) -> dict:
    """The operands of agent 0 alone: one cluster, as GREEDY launches."""
    return {k: v[:1].contiguous() for k, v in ops.items()}


def plan_of(ops: dict, kw: dict, kernel: str = "rtr_full",
            cluster: int | None = None, spread: int | None = None,
            lanes: int | None = None):
    """The route ``kernel`` takes on ``ops``: the plan's for this many
    agents on this card, or the one ``cluster``, ``spread`` or ``lanes``
    forces (as the wrappers' ``_cluster``, ``_spread`` and ``_lanes``)."""
    A, n, K = ops["inc_slot"].shape
    return rk._route(cluster, n, kw["e_max"], K, kw["r"], kw["d"], kernel,
                     spread, agents=A,
                     sms=rk.sm_count(ops["inc_slot"].device), lanes=lanes)


def kernel_parity(fn, ref_fn, ops: dict, kw: dict, where: str,
                  floor: bool = False):
    """B2 (``fn = rk.rtr_full``) or B3 (``rk.rtr``) on its planned route
    against its plain version on the same operands: max |ΔX| <= X_ATOL, no
    flip of attempts or accepted, f0 / f (/ gn0) at STAT_RTOL.  tCG
    iteration counts are reported, not gated.

    ``floor``: at the float32 floor the accept test (rho > 0.1 and f not
    rising) compares f(xp) and f(x) that differ by float32 rounding, so two
    sum orders may decide an attempt differently, and gn0 is a norm of
    cancelling terms.  There the gate is f0 at STAT_RTOL, X and f at the
    strict bounds on every agent whose attempts and accepted agree, every
    flip decided within FLOOR_DF_RTOL of f0, and gn0 no further from the
    float64 plain version than twice the float32 plain version is; the
    workspace route's flips on the same operands are reported beside.
    Returns the row and the kernel's output."""
    name = fn.__name__
    out = fn(*ops.values(), **kw)
    ref = ref_fn(*ops.values(), **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.X).all() and torch.isfinite(out.stats)
               .all()), f"{name} kernel returned non-finite values")
    plan = plan_of(ops, kw)
    flips = (out.stats[:, :2] != ref.stats[:, :2]).any(1)
    row = {"phase": "parity", "kernel": name, "operands": where,
           "agents": ops["Xc"].shape[0], "cuda_route": plan.route,
           "cluster": plan.C,
           "max_abs_dX": float((out.X - ref.X).abs().max()),
           "stat_flips": int(flips.sum()),
           "tcg_iter_flips": int((out.tcg_iters != ref.tcg_iters).sum()),
           "max_rel_d_stats": rel_err(out.stats[:, 2:], ref.stats[:, 2:]),
           "attempts": out.stats[:, 0].tolist(),
           "accepted": out.stats[:, 1].tolist(),
           "plain_attempts": ref.stats[:, 0].tolist(),
           "plain_accepted": ref.stats[:, 1].tolist(),
           "tcg_iters": out.tcg_iters.tolist()}
    if not floor:
        emit(row)
        check(row["max_abs_dX"] <= X_ATOL and row["stat_flips"] == 0
              and row["max_rel_d_stats"] <= STAT_RTOL,
              f"{name} kernel disagrees with its plain version ({where})")
        return row, out
    ws = fn(*ops.values(), _cluster=0, **kw)
    row.update(flip_rule(out, ref),
               single_cta_stat_flips=int((ws.stats[:, :2]
                                          != ref.stats[:, :2])
                                         .any(1).sum()))
    ok = (row["max_rel_d_f0"] <= STAT_RTOL
          and row["max_abs_dX_agreeing"] <= X_ATOL
          and row["max_rel_d_f_agreeing"] <= STAT_RTOL
          and all(x <= FLOOR_DF_RTOL for x in row["flipped_rel_df"]))
    if name == "rtr_full":
        ref64 = ref_fn(*(t.double() if t.is_floating_point() else t
                         for t in ops.values()), **kw)
        gn64 = ref64.stats[:, 4]
        row.update(gn0_rel_err_vs_f64=rel_err(out.stats[:, 4].double(), gn64),
                   plain_gn0_rel_err_vs_f64=rel_err(ref.stats[:, 4].double(),
                                                    gn64))
        ok = ok and (row["gn0_rel_err_vs_f64"]
                     <= 2 * row["plain_gn0_rel_err_vs_f64"] + STAT_RTOL)
    emit(row)
    check(ok, f"{name} kernel disagrees with its plain version ({where})")
    return row, out


def flip_rule(out, ref) -> dict:
    """The floor rule's terms for one B2/B3 launch against its plain
    version: X and f on the agents whose attempts and accepted agree, f0
    on all, and for each flipped agent the change in f that the side which
    accepted made, relative to f0 (at most rounding when both are
    right)."""
    flips = (out.stats[:, :2] != ref.stats[:, :2]).any(1)
    agree = ~flips
    some = bool(agree.any())
    f0, f0_ref = out.stats[:, 2], ref.stats[:, 2]
    df = torch.where(out.stats[:, 1] > 0, (out.stats[:, 3] - f0).abs(),
                     (ref.stats[:, 3] - f0_ref).abs()) / f0_ref.abs()
    return {"agents_agreeing": int(agree.sum()),
            "max_abs_dX_agreeing": float((out.X - ref.X)[agree].abs().max())
            if some else 0.0,
            "max_rel_d_f_agreeing": rel_err(out.stats[agree, 3],
                                            ref.stats[agree, 3])
            if some else 0.0,
            "max_rel_d_f0": rel_err(f0, f0_ref),
            "flipped_rel_df": df[flips].tolist()}


def b3_against_b2(b3_ops: dict, b3_kw: dict, b3_out, b2_ops: dict,
                  kw: dict, graph=None, where: str = "") -> dict:
    """B3 fed the gradient pass against one B2 launch at the same point,
    each on its planned route: the same step, on every agent B2 does not
    exit early (max |ΔX| <= X_ATOL, no accept flip).  With ``graph`` (config
    #5's scale): max |ΔX| on the live rows of the agents whose accept
    decisions agree at most X_ATOL of the largest live entry, and every
    flip within FLOOR_DF_RTOL of f0 (ROADMAP's accept-flip rule)."""
    b2 = rk.rtr_full(*b2_ops.values(), **kw)
    torch.cuda.synchronize()
    moving = b2.stats[:, 4] >= kw["grad_tol"]
    flipped = (b3_out.stats[:, :2] != b2.stats[:, :2]).any(1) & moving
    row = {"phase": "parity", "kernel": "rtr", "against": "rtr_full",
           "operands": where, "r": kw["r"], "d": kw["d"],
           "cuda_route": plan_of(b3_ops, b3_kw, "rtr").route,
           "b2_route": plan_of(b2_ops, kw).route,
           "agents_compared": int(moving.sum()),
           "stat_flips": int(flipped.sum()),
           "max_rel_d_f0_f": rel_err(b3_out.stats[moving, 2:4],
                                     b2.stats[moving, 2:4])}
    if graph is None:
        err = float((b3_out.X - b2.X)[moving].abs().max())
        row["max_abs_dX"] = err
        ok = err <= X_ATOL and row["stat_flips"] == 0
    else:
        err, scale = live_rel_dX(b3_out.X, b2.X, graph, moving & ~flipped)
        f0 = b2.stats[:, 2].abs()
        df = torch.where(b3_out.stats[:, 1] > 0,
                         (b3_out.stats[:, 3] - b3_out.stats[:, 2]).abs(),
                         (b2.stats[:, 3] - b2.stats[:, 2]).abs()) / f0
        row.update(max_abs_dX_live=err, max_abs_X_live=scale,
                   rel_dX_live=err / max(scale, 1e-30),
                   flipped_rel_df=df[flipped].tolist())
        ok = (err <= X_ATOL * scale
              and all(x <= FLOOR_DF_RTOL for x in row["flipped_rel_df"]))
    emit(row)
    check(int(moving.sum()) > 0 and ok,
          f"rtr kernel fed the gradient pass disagrees with rtr_full "
          f"({where}, r = {kw['r']}): {row}")
    return row


def tcg_iters_of(out) -> torch.Tensor:
    """tCG iterations per agent of a kernel's output (B1 reports them in
    its stats)."""
    return out.tcg_iters if hasattr(out, "tcg_iters") else out.stats[:, 0]


def route_timing(fn, ops: dict, kw: dict, out,
                 ws_reps: tuple[int, int] = (10, 10)) -> dict:
    """ms per launch of ``fn`` on its planned route and on the workspace
    route (``_cluster=0``, the single-CTA kernel), back to back in turns
    (planned, workspace, workspace, planned), and per tCG iteration of the
    agent that ran the most (``out``'s).  The planned route's runs are 10
    of 10 launches, the workspace route's ``ws_reps`` (runs, launches)."""
    def run(cluster=None, reps=(10, 10)):
        return cuda_ms(lambda: fn(*ops.values(), _cluster=cluster, **kw),
                       reps=reps[0], inner=reps[1])
    c1, w1, w2, c2 = run(), run(0, ws_reps), run(0, ws_reps), run()
    ms, ms_ws = (c1 + c2) / 2, (w1 + w2) / 2
    iters = max(int(tcg_iters_of(out).max()), 1)
    plan = plan_of(ops, kw, fn.__name__)
    row = {"ms": ms, "ms_single_cta": ms_ws, "ms_runs": [c1, c2],
           "ms_single_cta_runs": [w1, w2], "speedup": ms_ws / ms,
           "max_tcg_iters": iters, "ms_per_tcg_iter": ms / iters,
           "ms_per_tcg_iter_single_cta": ms_ws / iters,
           "cuda_route": plan.route, "cluster": plan.C,
           "ctas": ops["inc_slot"].shape[0] * max(plan.C, 1),
           "stripes": plan.stripes, "smem_bytes_per_cta": plan.smem_bytes}
    if hasattr(out, "tcg_iters"):
        row["attempts"] = out.stats[:, 0].tolist()
    return row


def one_set_columns(t: dict) -> dict:
    """A kernel-table row's route and times from one ``route_timing``."""
    return {"cuda_route": t["cuda_route"], "cluster": t["cluster"],
            "ctas": t["ctas"], "ms": t["ms"],
            "ms_single_cta": t["ms_single_cta"], "speedup": t["speedup"],
            "us_per_tcg_iter": 1e3 * t["ms_per_tcg_iter"],
            "us_per_tcg_iter_single_cta":
            1e3 * t["ms_per_tcg_iter_single_cta"]}


def route_columns(timing: dict) -> dict:
    """A kernel-table row's route and times from ``route_timing`` at both
    operand sets (``route`` stays the contract's "cuda"; ``cuda_route``
    names the route the plan took)."""
    init, floor = timing["chordal_init"], timing["float32_floor"]
    return {**one_set_columns(init), "ms_floor": floor["ms"],
            "ms_single_cta_floor": floor["ms_single_cta"],
            "us_per_tcg_iter_floor": 1e3 * floor["ms_per_tcg_iter"]}


def cluster_sweep(fn, sets: dict, kw: dict) -> list:
    """``fn``'s (B2's or B4's) ms per launch at each cluster size the card
    can place, at each operand set of ``sets``."""
    kernel = fn.__name__
    _, n, K = next(iter(sets.values()))["inc_slot"].shape
    rows = []
    for C in rk.CLUSTER_SIZES:
        shape = rk.cluster_shape(kw["r"], kw["d"], n, K, C, kernel)
        held = (rk.cluster_capacity(kw["r"], kw["d"], n, K, C, kernel)
                if rk._fits(shape) else 0)
        row = {"C": C, "P": shape.P, "threads": shape.threads,
               "smem_bytes": shape.smem_bytes, "max_active_clusters": held}
        if held >= 1:
            for where, o in sets.items():
                row[f"ms_{where}"] = cuda_ms(
                    lambda: fn(*o.values(), _cluster=C, **kw),
                    reps=10, inner=10)
        rows.append(row)
    return rows


def determinism(prob, params, plain, X0_host) -> None:
    """The card's chordal init and preconditioner factors, three times
    each, must be equal bit for bit; B2's 10-round check from the card's
    own start must read the same twice."""
    graph, meta = prob.graph, prob.meta
    X0s = [prob.X0] + [rbcd.centralized_chordal_init(prob.part, meta, graph,
                                                     torch.float32)
                       for _ in range(2)]
    chols = [rbcd.precond_chol(graph.edges, graph, params)
             for _ in range(3)]
    same_x0 = all(torch.equal(X0s[0], x) for x in X0s[1:])
    same_chol = all(torch.equal(chols[0], c) for c in chols[1:])
    traj = [trajectory_gap(X0s[0], graph, meta, params, plain)
            for _ in range(2)]
    emit({"phase": "determinism", "chordal_inits_bitwise_equal": same_x0,
          "precond_chol_bitwise_equal": same_chol,
          "max_abs_dX0_card_vs_host": float((X0s[0] - X0_host).abs().max()),
          "card_start_10_rounds_max_abs_dX": traj})
    check(same_x0 and same_chol,
          "the card's chordal init or factors differ between calls")
    check(traj[0] == traj[1], "B2's check from the card start did not repeat")


def ablate_phase(dev, card: str) -> dict:
    """The round ablation on the stand-in, counted; returns its launches."""
    rk.LAUNCHES = 0
    rk.RTR_LAUNCHES = 0
    torch.cuda.synchronize()
    out = measure_r3.ablate(rounds=ABLATE_ROUNDS, device=dev)
    launches = {"rtr": rk.RTR_LAUNCHES, "rtr_full": rk.LAUNCHES}
    emit({"phase": "ablate", "card": card, **out, "launches": launches})
    nums = [out["full_ms_per_round"], out["grad_ms_per_round"],
            out["grad_b3_ms_per_round"]]
    check(bool(np.isfinite(nums).all() and np.isfinite(out["b3_stats"])
               .all() and np.isfinite(out["gn0"]).all()),
          "the ablation returned non-finite values")
    check(launches["rtr"] == out["b3_calls"] > 0,
          "the ablation did not launch B3 once per call")
    return launches


def schedule_configs():
    gnc = dict(schedule=Schedule.COLORED,
               robust=RobustCostParams(cost_type=RobustCostType.GNC_TLS,
                                       gnc_barc=0.5),
               robust_opt_inner_iters=10, rel_change_tol=1e-8,
               solver=SolverParams(grad_norm_tol=1e-6))
    # rel_change_tol 0: the L2 runs stop at grad_norm_tol or the round cap,
    # not by consensus after a few rounds.
    return [("GREEDY", dict(schedule=Schedule.GREEDY, rel_change_tol=0.0)),
            ("ASYNC", dict(schedule=Schedule.ASYNC, async_update_prob=0.5,
                           rel_change_tol=0.0)),
            ("COLORED", dict(schedule=Schedule.COLORED, rel_change_tol=0.0)),
            ("JACOBI+nesterov", dict(acceleration=True, restart_interval=30,
                                     rel_change_tol=0.0)),
            ("COLORED+GNC_TLS", gnc)]


def below_half(w: torch.Tensor) -> dict:
    """Injected outliers (appended last) and inliers with weight < 0.5."""
    return {"outliers_below_half": int((w[-SCHED_OUTLIERS:] < 0.5).sum()),
            "inliers_below_half": int((w[:-SCHED_OUTLIERS] < 0.5).sum())}


def gnc_check(p, params, res) -> tuple[dict, int]:
    """The GNC run's final weights; the same configuration through the
    "ell" formulation on the card, its weights against the kernel's; and
    ``SCHED_MAX_ITERS`` more rounds (weight updates) from the counted
    run's state, to see whether the weights were still annealing.
    Returns the row's fields and the continued run's B2 launches."""
    plain = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, pallas_tcg=False))
    run = dict(max_iters=SCHED_MAX_ITERS, grad_norm_tol=GRAD_TOL,
               eval_every=SCHED_EVAL_EVERY)
    t0 = time.perf_counter()
    ell = rbcd.dispatch_prepared(dataclasses.replace(p, params=plain), **run)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rk.LAUNCHES = 0
    more = rbcd.dispatch_prepared(p, state=res.state, **run)
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(more.iterations, params=params,
                                    max_iters=SCHED_MAX_ITERS,
                                    eval_every=SCHED_EVAL_EVERY)
    flips = int(((ell.weights < 0.5) != (res.weights < 0.5)).sum())
    return {"outliers": SCHED_OUTLIERS,
            "inliers": len(res.weights) - SCHED_OUTLIERS,
            "mu": float(res.state.mu),
            "gnc_stage": robust.gnc_stage_index(res.state.mu, params.robust),
            **below_half(res.weights),
            "ell": {"iterations": ell.iterations,
                    "terminated_by": ell.terminated_by,
                    "solve_s": t1 - t0, "mu": float(ell.state.mu),
                    "max_abs_dw": float((ell.weights - res.weights).abs()
                                        .max()),
                    "flips_at_half": flips, **below_half(ell.weights)},
            "continued": {"iterations": more.iterations,
                          "terminated_by": more.terminated_by,
                          "mu": float(more.state.mu),
                          "gnc_stage": robust.gnc_stage_index(
                              more.state.mu, params.robust),
                          "cost_final": more.cost_history[-1],
                          "grad_norm_final": more.grad_norm_history[-1],
                          "launches": launches,
                          "rounds_enqueued": enqueued,
                          **below_half(more.weights)}}, launches


def gnc_standin():
    """The stand-in with ``SCHED_OUTLIERS`` gross loop-closure outliers,
    appended last."""
    return make_measurements(np.random.default_rng(0), n=N_POSES, d=3,
                             num_lc=NUM_LC, rot_noise=0.01, trans_noise=0.01,
                             outlier_lc=SCHED_OUTLIERS)[0]


def gnc_params() -> AgentParams:
    return AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                       **dict(schedule_configs())["COLORED+GNC_TLS"])


def schedules_phase(prob, dev, card: str) -> int:
    """``dispatch_prepared`` with each schedule, counted, and one segment of
    each under the sync-error debug mode.  Returns the B2 launches."""
    meas_out = gnc_standin()
    prob_out = rbcd.prepare_problem(meas_out, ROBOTS, prob.params,
                                    device=dev)
    total = 0
    for name, kw in schedule_configs():
        params = AgentParams(d=3, r=RANK, num_robots=ROBOTS, **kw)
        robust_on = params.robust.cost_type != RobustCostType.L2
        p = dataclasses.replace(prob_out if robust_on else prob, params=params)
        rk.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rbcd.dispatch_prepared(p, max_iters=SCHED_MAX_ITERS,
                                     grad_norm_tol=GRAD_TOL,
                                     eval_every=SCHED_EVAL_EVERY)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = rk.LAUNCHES
        enqueued = rbcd.rounds_enqueued(res.iterations, params=params,
                                        max_iters=SCHED_MAX_ITERS,
                                        eval_every=SCHED_EVAL_EVERY)
        costs = res.cost_history
        row = {"phase": "schedules", "schedule": name, "card": card,
               "poses": p.part.meas_global.num_poses,
               "edges": len(p.part.meas_global),
               "iterations": res.iterations,
               "terminated_by": res.terminated_by, "cost_first": costs[0],
               "cost_final": costs[-1],
               "grad_norm_final": res.grad_norm_history[-1],
               "solve_s": t1 - t0, "rounds_per_s": res.iterations / (t1 - t0),
               "launches": {"rtr_full": launches},
               "rounds_enqueued": enqueued}
        if robust_on:
            gnc, more_launches = gnc_check(p, params, res)
            row.update(gnc)
            total += more_launches
        # One segment from the start, flagged as its schedule allows,
        # with every host sync an error.
        flags = (robust_on, params.acceleration)
        state = rbcd.init_state(p.graph, p.meta, p.X0, params)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            seg = rbcd.rbcd_segment(state, p.graph, SCHED_EVAL_EVERY, p.meta,
                                    params, *flags)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        row.update(sync_free_segment={"rounds": seg.iteration,
                                      "update_weights": flags[0],
                                      "restart": flags[1]})
        emit(row)
        check(bool(np.isfinite(costs).all()
                   and np.isfinite(res.grad_norm_history).all()
                   and torch.isfinite(seg.X).all()),
              f"{name}: non-finite cost, gradient norm or iterate")
        check(launches == enqueued and res.iterations > 0,
              f"{name}: B2 did not launch once per enqueued round")
        check(seg.iteration == SCHED_EVAL_EVERY, f"{name}: segment length")
        if robust_on:
            check(row["outliers_below_half"] >= 0.9 * SCHED_OUTLIERS,
                  f"{name}: GNC kept injected outliers")
            check(row["inliers_below_half"]
                  <= GNC_INLIER_REJECT_MAX * row["inliers"],
                  f"{name}: GNC rejected too many inliers")
            check(row["ell"]["flips_at_half"]
                  <= GNC_ELL_FLIP_MAX * row["edges"],
                  f"{name}: the kernel's weights leave the plain ones")
            cont = row["continued"]
            check(bool(np.isfinite(cont["cost_final"]))
                  and cont["launches"] == cont["rounds_enqueued"]
                  and cont["iterations"] > 0,
                  f"{name}: the continued run is malformed")
        else:
            check(costs[-1] <= costs[0], f"{name}: the cost rose")
        total += launches
    return total


def verdict_parity(prob, ref, card: str) -> tuple[dict, int]:
    """The ``solve`` configuration through the verdict loop (K =
    ``VERDICT_K``) against the per-eval run ``ref``, counted."""
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                 grad_norm_tol=GRAD_TOL,
                                 verdict_every=VERDICT_K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=MAX_ITERS,
                                    eval_every=1, verdict_every=VERDICT_K)
    same = {"iterations": res.iterations == ref.iterations,
            "terminated_by": res.terminated_by == ref.terminated_by,
            "cost_history": res.cost_history == ref.cost_history,
            "grad_norm_history":
            res.grad_norm_history == ref.grad_norm_history}
    row = {"phase": "verdict", "check": "parity", "card": card,
           "verdict_every": VERDICT_K, "iterations": res.iterations,
           "terminated_by": res.terminated_by,
           "per_eval_iterations": ref.iterations, "bitwise_equal": same,
           "solve_s": t1 - t0, "rounds_per_s": res.iterations / (t1 - t0),
           "launches": {"rtr_full": launches},
           "rounds_enqueued": enqueued}
    emit(row)
    check(all(same.values()),
          "the verdict loop's run differs from the per-eval loop's")
    check(launches == enqueued and res.iterations > 0,
          "the verdict loop did not launch B2 once per enqueued round")
    check(res.T.shape == (N_POSES, 3, 4) and bool(torch.isfinite(res.T)
                                                   .all()),
          "the verdict loop's trajectory is malformed")
    return row, launches


def verdict_window(prob, params, dev, card: str) -> dict:
    """One K-round window of the verdict loop (segments and verdict steps)
    and the start of the word's copy, with every host sync an error; then
    the word is read while the card spins on work enqueued after the copy,
    which a fetch that drained the stream would have waited for."""
    graph, meta, part = prob.graph, prob.meta, prob.part
    edges_g = rbcd.edge_set_from_measurements(part.meas_global,
                                              dtype=torch.float32,
                                              device=dev)
    step = rbcd.make_verdict_program(
        graph, edges_g, part.meas_global.num_poses, len(part.meas_global),
        False, grad_norm_tol=GRAD_TOL)
    vs = rbcd.init_verdict_state(VERDICT_K, ROBOTS, torch.float32, False,
                                 device=dev)
    st = rbcd.init_state(graph, meta, prob.X0, params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(VERDICT_K):
            st = rbcd.rbcd_segment(st, graph, 1, meta, params)
            vs = step(st.X, st.weights, st.ready, st.mu, st.rel_change,
                      st.iteration, vs)
        copy = rbcd._start_fetch(vs.word)
        torch.cuda._sleep(SPIN_CYCLES)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    word = int(rbcd._host_fetch(copy))
    fetch_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    row = {"phase": "verdict", "check": "sync_free_window", "card": card,
           "rounds": st.iteration, "evals": int(vs.eval_idx),
           "word": rbcd.unpack_verdict(word),
           "word_matches_device": word == int(vs.word),
           "fetch_s": fetch_s, "stream_busy_after_fetch": busy,
           "spin_drain_s": drain_s}
    emit(row)
    check(st.iteration == VERDICT_K and row["evals"] == VERDICT_K,
          "the verdict window is malformed")
    check(row["word_matches_device"], "the word's pinned copy is wrong")
    check(busy, "the word fetch waited on the stream, not on its copy")
    return row


def counted_drive(drive) -> tuple:
    """``drive()`` with its ``_host_fetch`` calls counted: (result, fetches,
    seconds)."""
    fetches = [0]
    orig = rbcd._host_fetch

    def counting(x):
        fetches[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drive()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        rbcd._host_fetch = orig
    return res, fetches[0], dt


def production_arm(prob, params, card: str, profile: bool) -> tuple[dict,
                                                                    int]:
    """bench.py's production arm: ``PROD_ROUNDS`` rounds of the verdict
    loop with K = eval_every = ``PROD_K``, one warm run then a counted
    one; host syncs counted through ``_host_fetch``, the terminal epilogue
    excluded as bench.py excludes it.  The tolerances never stop it, as
    bench.py intends: the relative-change tolerance is negative, because
    at the float32 floor every agent rejects every attempt, its change is
    exactly 0, and a tolerance of 0 stops the run by consensus."""
    pp = dataclasses.replace(prob, params=dataclasses.replace(
        params, rel_change_tol=-1.0))

    def drive():
        return rbcd.dispatch_prepared(pp, max_iters=PROD_ROUNDS,
                                      grad_norm_tol=0.0, eval_every=PROD_K,
                                      verdict_every=PROD_K)
    drive()
    rk.LAUNCHES = 0
    res, fetches, dt = counted_drive(drive)
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=PROD_ROUNDS,
                                    eval_every=PROD_K, verdict_every=PROD_K)
    syncs = 100.0 * (fetches - 1) / res.iterations
    row = {"phase": "verdict", "check": "production_arm", "card": card,
           "rounds": res.iterations, "rounds_enqueued": enqueued,
           "verdict_every": PROD_K, "eval_every": PROD_K,
           "terminated_by": res.terminated_by, "solve_s": dt,
           "rounds_per_s": enqueued / dt, "ms_per_round": 1e3 * dt / enqueued,
           "host_fetches": fetches,
           "host_syncs_per_100_rounds": syncs,
           "cost_history": res.cost_history,
           "launches": {"rtr_full": launches}}
    if profile:
        prof = profile_run(lambda: drive().iterations)
        row["profile"] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "device_busy_share", "top")}
    emit(row)
    check(res.iterations == PROD_ROUNDS and res.terminated_by == "max_iters",
          "the production arm did not run its rounds")
    check(syncs == 100.0 / PROD_K,
          "the production arm did not read one word per K rounds")
    check(launches == enqueued,
          "the production arm did not launch B2 once per enqueued round")
    check(bool(np.isfinite(res.cost_history).all()),
          "non-finite cost in the production arm")
    return row, launches


def odometry_phase(prob, meas, params, dev, card: str) -> int:
    """The card's lifted odometry init against the host's float64 one, and
    a verdict-loop solve from it.  Returns the solve's B2 launches."""
    X0 = rbcd.centralized_odometry_init(prob.part, prob.meta, prob.graph,
                                        torch.float32)
    host = rbcd.prepare_problem(meas, ROBOTS, params, dtype=torch.float64,
                                device="cpu", init="odometry")
    err = float((X0.double().cpu() - host.X0).abs().max())
    scale = float(host.X0[..., -1].abs().max())
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.solve_rbcd(meas, ROBOTS, params, max_iters=MAX_ITERS,
                          grad_norm_tol=GRAD_TOL, init="odometry",
                          verdict_every=ODO_K, dtype=torch.float32,
                          device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=MAX_ITERS,
                                    eval_every=1, verdict_every=ODO_K)
    costs = res.cost_history
    emit({"phase": "odometry_init", "card": card,
          "max_abs_dX0_card_vs_host_f64": err, "max_abs_translation": scale,
          "limit": ODO_RTOL * scale, "verdict_every": ODO_K,
          "iterations": res.iterations, "terminated_by": res.terminated_by,
          "cost_first": costs[0], "cost_final": costs[-1],
          "grad_norm_final": res.grad_norm_history[-1], "solve_s": t1 - t0,
          "launches": {"rtr_full": launches}, "rounds_enqueued": enqueued})
    check(err <= ODO_RTOL * scale,
          "the card's odometry init leaves the host's float64 one")
    check(bool(np.isfinite(costs).all()) and costs[-1] < costs[0],
          "the solve from the odometry init did not lower the cost")
    check(launches == enqueued and res.iterations > 0,
          "the odometry-init solve did not launch B2 once per round")
    return launches


def robust_iterated_phase(dev, card: str) -> int:
    """``solve_rbcd_robust_iterated`` on the GNC stand-in through the
    kernel and through the plain "ell" formulation, with the per-pass
    round counts (recorded at ``rbcd.solve_rbcd``).  Returns the kernel
    run's B2 launches."""
    meas = gnc_standin()
    params = gnc_params()
    plain = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, pallas_tcg=False))
    kw = dict(passes=ITER_PASSES, init="chordal", max_iters=SCHED_MAX_ITERS,
              eval_every=SCHED_EVAL_EVERY, verdict_every=ITER_K,
              grad_norm_tol=GRAD_TOL, dtype=torch.float32, device=dev)
    passes = []
    orig = rbcd.solve_rbcd

    def recording(*a, **k):
        r = orig(*a, **k)
        passes.append({"iterations": r.iterations,
                       "terminated_by": r.terminated_by})
        return r

    rbcd.solve_rbcd = recording
    try:
        rk.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, w, kept = rbcd.solve_rbcd_robust_iterated(meas, ROBOTS, params,
                                                       **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = rk.LAUNCHES
        kernel_passes = list(passes)
        passes.clear()
        _, w_ell, kept_ell = rbcd.solve_rbcd_robust_iterated(
            meas, ROBOTS, plain, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        rbcd.solve_rbcd = orig
    enqueued = sum(rbcd.rounds_enqueued(
        p["iterations"], max_iters=SCHED_MAX_ITERS,
        eval_every=SCHED_EVAL_EVERY, verdict_every=ITER_K)
        for p in kernel_passes)
    outlier_idx = np.arange(len(meas) - SCHED_OUTLIERS, len(meas))
    prec, rec, n_rej = rejection_scores(w, meas, outlier_idx)
    row = {"phase": "robust_iterated", "card": card,
           "measurements": len(meas), "outliers": SCHED_OUTLIERS,
           "passes": kernel_passes, "iterations": res.iterations,
           "verdict_every": ITER_K, "solve_s": t1 - t0,
           "precision": prec, "recall": rec, "rejected": n_rej,
           "kept": int(kept.sum()),
           "outliers_below_half": int((w[-SCHED_OUTLIERS:] < 0.5).sum()),
           "inliers_below_half": int((w[:-SCHED_OUTLIERS] < 0.5).sum()),
           "ell": {"passes": passes, "solve_s": t2 - t1,
                   "kept": int(kept_ell.sum()),
                   "kept_flips": int((kept != kept_ell).sum()),
                   "precision_recall": rejection_scores(
                       w_ell, meas, outlier_idx)[:2]},
           "launches": {"rtr_full": launches}, "rounds_enqueued": enqueued}
    emit(row)
    check(bool(np.isfinite(w).all()) and res.iterations > 0,
          "the iterated solve is malformed")
    check(row["outliers_below_half"] >= 0.9 * SCHED_OUTLIERS,
          "iterated GNC kept injected outliers")
    check(row["inliers_below_half"]
          <= GNC_INLIER_REJECT_MAX * (len(meas) - SCHED_OUTLIERS),
          "iterated GNC rejected too many inliers")
    check(row["ell"]["kept_flips"] <= GNC_ELL_FLIP_MAX * len(meas),
          "the kernel's kept mask leaves the plain formulation's")
    check(launches == enqueued,
          "the iterated solve did not launch B2 once per enqueued round")
    return launches


# ---------------------------------------------------------------------------
# The certify phase
# ---------------------------------------------------------------------------

def dense_spectrum(X64: np.ndarray, edges, dev, k: int) -> list[float]:
    """The oracle (a check only, never the path): the ``k`` smallest
    eigenvalues of the assembled S (``certify.sparse_certificate``,
    float64), ascending, by ``torch.linalg.eigvalsh`` on the card."""
    S = certify.sparse_certificate(X64, edges).tocsr()
    St = torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr, dtype=torch.int64),
        torch.as_tensor(S.indices, dtype=torch.int64),
        torch.as_tensor(S.data), size=S.shape).to(dev).to_dense()
    lam = torch.linalg.eigvalsh(St)[:k].cpu().tolist()
    del St
    torch.cuda.empty_cache()
    return lam


def kept_gauge_directions(X64: np.ndarray) -> int:
    """How many left-singular directions of X's rows the deflated payload
    keeps (``sv > max(sv) sqrt(eps)``, ``device_certificate_payload``),
    by numpy's SVD."""
    n, r, dh = X64.shape
    sv = np.linalg.svd(X64.transpose(1, 0, 2).reshape(r, n * dh),
                       compute_uv=False)
    return int(np.sum(sv > sv.max() * np.sqrt(np.finfo(np.float64).eps)))


def host_lambda_min(X64: np.ndarray, edges, tol: float,
                    warm) -> tuple[float, float]:
    """The host float64 tier on ``X64``: ``certify.
    lambda_min_f64_shift_invert`` (scipy; the route ``lambda_min_f64``
    takes from 50k dimensions — at the stand-in's 10,000 its plain LOBPCG
    does not converge), warm-started from the card's direction:
    (lambda_min, residual)."""
    lam, _, resid = certify.lambda_min_f64_shift_invert(
        X64, edges, tol, warm=None if warm is None else np.asarray(warm))
    return lam, resid


def lam_agrees(a: float, b: float) -> bool:
    return abs(a - b) <= CERT_LAM_TOL * max(1.0, abs(b))


def rtr_host_reads(edges, n: int, dev, iters: int = 10) -> dict:
    """Host reads of ``solver.rtr_solve`` per outer iteration on the card:
    ``iters`` iterations from the lifted chordal init with every
    synchronizing operation a warning (counted), the tCG iterations each
    took recorded on the device and read afterwards."""
    import warnings

    from dpgo_tpu_torch.utils.lie import lifting_matrix

    problem = local_pgo.make_problem(edges, n)
    X0 = local_pgo.lift(local_pgo.initial_poses(edges, n, "chordal"),
                        lifting_matrix(CERT_RANK, 3, edges.R.dtype, dev))
    params = SolverParams(initial_radius=1e1, max_inner_iters=50)
    tcg_iters = []
    orig = solver.truncated_cg

    def recording(*a, **k):
        out = orig(*a, **k)
        tcg_iters.append(out.iters)
        return out

    solver.truncated_cg = recording
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                solver.rtr_solve(problem, X0, params, max_iters=iters,
                                 grad_norm_tol=0.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        solver.truncated_cg = orig
    reads = sum("synchronizing" in str(w.message) for w in seen)
    tcg = sum(int(t) for t in tcg_iters)
    return {"outer_iterations": iters, "host_reads": reads,
            "host_reads_per_outer_iteration": reads / iters,
            "tcg_iterations_per_outer_iteration": tcg / iters,
            "reads_predicted": 2 * iters + tcg}


def certificate_profile(Xg, edges, inc, card: str) -> dict:
    """Where the certificate stage's time goes: a payload with 10 LOBPCG
    iterations traced by ``torch.profiler`` (device busy share, kernel
    launches), and the small eigensolves of LOBPCG timed alone."""
    from dpgo_tpu_torch.ops import smallmat

    iters = 10
    prof = profile_run(lambda: certify.device_certificate_payload(
        Xg, edges, 0, lobpcg_iters=iters, inc=inc) and iters)
    g = torch.Generator(device=Xg.device).manual_seed(0)
    eigh_ms = {}
    for n in (4, 12):
        B = torch.randn(n, n, generator=g, device=Xg.device,
                        dtype=Xg.dtype)
        eigh_ms[f"{n}x{n}"] = cuda_ms(
            lambda: smallmat.eigh_small(B + B.T), reps=5)
    row = {"phase": "certify", "check": "profile", "card": card,
           "dtype": str(Xg.dtype), "lobpcg_iters": iters,
           "wall_s": prof["wall_s"], "device_busy_s": prof["device_busy_s"],
           "device_busy_share": prof["device_busy_share"],
           "kernel_calls": prof["device_kernel_calls"],
           "top_host": prof["top_host"][:4], "eigh_small_ms": eigh_ms}
    emit(row)
    return row


def certify_fstar(meas, dev, card: str) -> dict:
    """(a) bench_convergence.py's f* protocol on the card in float64:
    ``solve_local`` then ``certify_solution`` (the JAX package's
    non-deflated LOBPCG); beside it the gauge-deflated device payload on
    the same iterate.  Each eigensolve is held against the dense oracle's
    spectrum: ``certify_solution``'s lambda_min against its smallest
    eigenvalue, the deflated solve's unclamped Ritz value against the
    first eigenvalue past the kept gauge directions.  The gates are the
    host float64 eigensolve's agreement with the oracle and the soundness
    of every verdict against it; the two LOBPCG agreements are reported
    (``lobpcg_agreement_met``), not gated: at 10,000 dimensions the
    reference's 300 LOBPCG iterations stop short of them (PERF.md), and
    both run FSTAR_LOBPCG."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = local_pgo.solve_local(meas, rank=CERT_RANK,
                                grad_norm_tol=CERT_GTOL,
                                max_iters=CERT_MAX_ITERS, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e64 = edge_set_from_measurements(meas, dtype=torch.float64, device=dev)
    cert = certify.certify_solution(res.X, e64, lobpcg_iters=FSTAR_LOBPCG)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pay = certify.device_certificate_payload(res.X, e64, 0,
                                             lobpcg_iters=FSTAR_LOBPCG)
    dcert = certify.decide_device_certificate(
        pay, 1e-5, float(torch.finfo(torch.float64).eps))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    e_host = edge_set_from_measurements(meas, dtype=torch.float64,
                                        device="cpu")
    X64 = res.X.cpu().numpy()
    lam_host, resid = host_lambda_min(X64, e_host, dcert.tol,
                                      dcert.direction.cpu().numpy())
    t4 = time.perf_counter()
    keep = kept_gauge_directions(X64)
    spec = dense_spectrum(X64, e_host, dev, keep + 2)
    # The deflated solve's Ritz value sigma - theta[0], unclamped: its
    # direction lies in the range of the projector, so it equals the
    # direction's Rayleigh quotient on S, the payload's ``rq``.
    defl = float(pay["rq"])
    agrees = {"certify_solution": lam_agrees(cert.lambda_min, spec[0]),
              "deflated": lam_agrees(defl, spec[keep]),
              "host_f64": lam_agrees(lam_host, spec[0])}
    tol = cert.tol
    host_certified = lam_host >= -tol
    reads = rtr_host_reads(e64, meas.num_poses, dev)
    row = {"phase": "certify", "check": "fstar", "card": card,
           "dtype": "float64", "rank": CERT_RANK, "iterations": res.iters,
           "f_star": res.cost, "grad_norm": res.grad_norm,
           "lambda_min": cert.lambda_min, "certified": cert.certified,
           "decidable": cert.decidable, "tol": tol,
           "sigma": cert.sigma, "stationarity_gap": cert.stationarity_gap,
           "lobpcg_iters": FSTAR_LOBPCG,
           "deflated": {"verdict": certify.CERT_STATUS[dcert.device_verdict],
                        "lam": dcert.lambda_min, "ritz_unclamped": defl,
                        "defl_resid": float(pay["defl_resid"]),
                        "kept_gauge_directions": keep},
           "lambda_min_host_f64": lam_host, "host_f64_resid": resid,
           "host_f64_certified": host_certified, "dense_spectrum": spec,
           "agrees": agrees, "lobpcg_agreement_met":
           agrees["certify_solution"] and agrees["deflated"],
           "solve_s": t1 - t0, "certify_s": t2 - t1, "deflated_s": t3 - t2,
           "host_f64_s": t4 - t3, "rtr_solve_host_reads": reads}
    emit(row)
    check(agrees["host_f64"], "the host float64 eigensolve disagrees with "
          "the dense oracle")
    check(host_certified, "f* at rank 5 is not certified by the host "
          "float64 eigensolve")
    check(not cert.certified or host_certified,
          "certify_solution certified, but lambda_min_f64 < -tol")
    check(dcert.device_verdict != certify.CERT_ACCEPT or host_certified,
          "the deflated payload accepted, but lambda_min_f64 < -tol")
    check(dcert.device_verdict != certify.CERT_FAIL or not host_certified,
          "the deflated payload failed, but lambda_min_f64 >= -tol")
    # Rayleigh quotients of S: never below its smallest eigenvalue.
    lo = spec[0] - CERT_LAM_TOL * max(1.0, abs(spec[0]))
    check(cert.lambda_min >= lo and defl >= lo,
          "an eigensolve of the card went below the dense oracle's minimum")
    return row


def certify_main_path(meas, params, dev, card: str) -> tuple[dict, int,
                                                              float]:
    """(b) The slice's main path: the certified solve through the verdict
    loop, counted; the certified epilogue under the sync-error mode and
    timed; the verdict's soundness against the dense oracle; one
    ``certify_mode="host"`` run.  Returns the row, the B2 launches and the
    host-mode run's seconds."""
    cparams = dataclasses.replace(params, certify_mode="device")
    prob = rbcd.prepare_problem(meas, ROBOTS, cparams, device=dev)
    fetches = [0]
    orig = rbcd._host_fetch

    def counting(x):
        fetches[0] += 1
        return orig(x)

    rk.LAUNCHES = 0
    rbcd._host_fetch = counting
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                     grad_norm_tol=GRAD_TOL,
                                     verdict_every=CERT_K)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        rbcd._host_fetch = orig
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=MAX_ITERS,
                                    eval_every=1, verdict_every=CERT_K)
    it_pre = min(-(-res.iterations // CERT_K) * CERT_K, MAX_ITERS)
    words = -(-it_pre // CERT_K)
    cert = res.certificate

    # The certified epilogue again, every host sync an error, timed
    # between CUDA events; and the epilogue without the certificate.
    part, graph, meta = prob.part, prob.graph, prob.meta
    n, m = part.meas_global.num_poses, len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=prob.dtype, device=dev)
    epi = rbcd.make_terminal_epilogue(graph, edges_g, n, m, meta,
                                      certify_mode="device")
    epi_off = rbcd.make_terminal_epilogue(graph, edges_g, n, m, meta)
    Xa, w = res.state.X, res.state.weights
    off_ms = cuda_ms(lambda: epi_off(Xa, w, {}), reps=3, warmup=1)
    fin_off = epi_off(Xa, w, {})
    eg = edges_g._replace(weight=fin_off["w_glob"])
    certificate_profile(rbcd.gather_to_global(Xa, graph, n), eg,
                        quadratic.edge_incidence(eg, n), card)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = time.perf_counter()
        ev[0].record()
        fin = epi(Xa, w, {})
        ev[1].record()
        enqueue_s = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev[1].synchronize()
    epi_ms = ev[0].elapsed_time(ev[1])
    wall_s = time.perf_counter() - t1
    pay = {k: (float(v) if v.dim() == 0 else None)
           for k, v in fin["cert"].items()}

    # Soundness against the dense oracle on the iterate (float64 on the
    # card; the host float64 tier is held against it in (a)).
    X64 = fin["Xg"].double().cpu().numpy()
    e_host = edge_set_from_measurements(part.meas_global,
                                        dtype=torch.float64, device="cpu")
    e_host = e_host._replace(weight=res.weights.double().cpu())
    tol = cert.tol
    lam_dense = dense_spectrum(X64, e_host, dev, 1)[0]
    verdict = certify.CERT_STATUS[cert.device_verdict]
    row = {"phase": "certify", "check": "main_path", "card": card,
           "dtype": str(prob.dtype), "verdict_every": CERT_K,
           "iterations": res.iterations, "terminated_by": res.terminated_by,
           "rounds_enqueued": enqueued, "launches": {"rtr_full": launches},
           "host_fetches": fetches, "verdict_words": words,
           "verdict": verdict, "certified": cert.certified,
           "decidable": cert.decidable, "lam": cert.lambda_min,
           "sigma": cert.sigma, "defl_resid": pay["defl_resid"],
           "rq": pay["rq"], "tol": tol, "wscale": cert.weight_scale,
           "stationarity_gap": cert.stationarity_gap,
           "lambda_min_f64_fallback": cert.lambda_min_f64,
           "lambda_min_dense": lam_dense,
           "epilogue_certified_ms": epi_ms,
           "epilogue_off_ms": off_ms,
           "certificate_stage_ms": epi_ms - off_ms,
           "epilogue_enqueue_s": enqueue_s, "epilogue_wall_s": wall_s,
           "sync_free_epilogue": True, "solve_s": solve_s,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    check(launches == enqueued and res.iterations > 0,
          "the certified solve did not launch B2 once per enqueued round")
    check(fetches[0] == words + 1,
          "the certificate did not ride the one terminal fetch")
    check(pay["lam_min"] == cert.lambda_min and pay["sigma"] == cert.sigma,
          "the certified epilogue does not repeat the driver's payload")
    if cert.device_verdict == certify.CERT_ACCEPT:
        check(lam_dense >= -tol, "ACCEPT, but the dense lambda_min < -tol")
    elif cert.device_verdict == certify.CERT_FAIL:
        check(lam_dense < -tol or pay["rq"] < -tol,
              "FAIL, but neither the dense lambda_min nor the RQ is below "
              "-tol")
    else:
        check(cert.device_verdict == certify.CERT_REFUSE
              and cert.lambda_min_f64 is not None,
              "a REFUSE did not end in the host decision")
        if cert.certified:
            check(lam_dense >= -tol, "the host decision certified, but "
                  "the dense lambda_min < -tol")

    # The post-hoc host mode once, through the per-eval loop, at the
    # sharded check's eta, where the float32 eigensolve decides alone (the
    # host float64 pass it would take at 1e-5 is the main path's REFUSE
    # fallback above).
    hparams = dataclasses.replace(params, certify_mode="host",
                                  certify_eta=SHARD_CERT_ETA)
    hprob = dataclasses.replace(prob, params=hparams)
    rk.LAUNCHES = 0
    t2 = time.perf_counter()
    hres = rbcd.dispatch_prepared(hprob, max_iters=MAX_ITERS,
                                  grad_norm_tol=GRAD_TOL)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t2
    h_launches = rk.LAUNCHES
    h_enqueued = rbcd.rounds_enqueued(hres.iterations, params=hparams,
                                      max_iters=MAX_ITERS, eval_every=1)
    hc = hres.certificate
    emit({"phase": "certify", "check": "host_mode", "card": card,
          "iterations": hres.iterations, "launches": {"rtr_full":
                                                      h_launches},
          "rounds_enqueued": h_enqueued, "certified": hc.certified,
          "decidable": hc.decidable, "lambda_min": hc.lambda_min,
          "lambda_min_f64": hc.lambda_min_f64, "tol": hc.tol,
          "eta": SHARD_CERT_ETA, "sigma": hc.sigma, "device_verdict":
          certify.CERT_STATUS[hc.device_verdict], "solve_s": host_s})
    check(h_launches == h_enqueued,
          "the host-mode solve did not launch B2 once per enqueued round")
    check(hc.device_verdict == certify.CERT_NONE,
          "the host mode ran a device eigensolve")
    check(hc.decidable and hc.lambda_min_f64 is None,
          "the host mode's float32 eigensolve did not decide alone")
    check(bool(torch.isfinite(hres.T).all()),
          "the host-mode trajectory is malformed")
    return row, launches + h_launches, time.perf_counter() - t2


def staircase_from(meas, X, r_max: int, dev) -> tuple[list, object]:
    """``solve_staircase``'s loop from a given iterate ``X`` (float64):
    solve at the rank of X, certify, escape to the next rank on failure.
    The rank of X must fail (the caller's gate); every rank's eigensolve
    runs WIND_ESCAPE_LOBPCG iterations.  Returns the rank history and the
    last certificate."""
    edges = edge_set_from_measurements(meas, dtype=torch.float64,
                                       device=dev)
    params = SolverParams(initial_radius=1e1, max_inner_iters=50)
    problem = local_pgo.make_problem(edges, meas.num_poses,
                                     params.precond_shift)
    X = torch.as_tensor(X, dtype=torch.float64).to(dev)
    history = []
    for r in range(X.shape[1], r_max + 1):
        out = solver.rtr_solve(problem, X, params, max_iters=300,
                               grad_norm_tol=1e-6)
        X = out.X
        cert = certify.certify_solution(X, edges, seed=r,
                                        lobpcg_iters=WIND_ESCAPE_LOBPCG)
        history.append((r, float(out.f), cert.lambda_min))
        if cert.certified or r == r_max:
            return history, cert
        X = certify.escape_rank(X, cert.direction, edges)
    raise AssertionError("unreachable")


def certify_staircase(meas, dev, card: str) -> dict:
    """(c) The staircase in float64 on the card: ``solve_staircase`` on
    the stand-in from rank ``STAIR_R_MIN``, its verdict held for soundness
    against the dense oracle; and the staircase's loop from the wound
    critical point of ``make_stitched_winding`` (fails at rank 2, escapes,
    certifies)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = certify.solve_staircase(meas, r_min=STAIR_R_MIN, r_max=STAIR_R_MAX,
                                 device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e_host = edge_set_from_measurements(meas, dtype=torch.float64,
                                        device="cpu")
    lam_dense = dense_spectrum(st.X.cpu().numpy(), e_host, dev, 1)[0]
    t2 = time.perf_counter()
    wmeas, Xw = make_stitched_winding(WIND_CYCLES, WIND_LEN)
    w_hist, w_cert = staircase_from(wmeas, Xw, STAIR_R_MAX, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    row = {"phase": "certify", "check": "staircase", "card": card,
           "dtype": "float64",
           "standin": {"history": st.history, "rank": st.rank,
                       "certified": st.certificate.certified,
                       "lambda_min_dense": lam_dense,
                       "seconds": t1 - t0, "dense_s": t2 - t1},
           "winding": {"poses": wmeas.num_poses, "edges": len(wmeas),
                       "history": w_hist, "rank": w_hist[-1][0],
                       "certified": w_cert.certified,
                       "escape_lobpcg_iters": WIND_ESCAPE_LOBPCG,
                       "seconds": t3 - t2}}
    emit(row)
    check(not st.certificate.certified
          or lam_dense >= -st.certificate.tol, "the stand-in's staircase "
          "certified, but the dense lambda_min < -tol")
    check(len(w_hist) >= 2 and w_hist[0][0] == 2
          and w_hist[0][2] < -w_cert.tol,
          "the wound instance did not fail at rank 2")
    check(w_cert.certified and w_hist[-1][0] >= 3
          and w_hist[-1][1] < 1e-3 * w_hist[0][1],
          "the wound instance did not certify after escaping")
    return row


def certify_f64(meas, dev, card: str) -> tuple[float, dict]:
    """The certify phase's float64 parts, (a) and (c), which launch no
    kernel of the library (the kernels take float32 only): they run on the
    card while ``nvcc`` builds it (``build_beside``).  Returns (a)'s f* and
    the parts' seconds."""
    t0 = time.perf_counter()
    fstar = certify_fstar(meas, dev, card)
    t1 = time.perf_counter()
    certify_staircase(meas, dev, card)
    return fstar["f_star"], {"fstar": t1 - t0,
                             "staircase": time.perf_counter() - t1}


def certify_phase(meas, params, dev, card: str, f64_parts: dict) -> int:
    """(b), the certify phase's main path, and the seconds of all three
    parts (``f64_parts``: ``certify_f64``'s); returns (b)'s B2
    launches."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls run in TF32: an f32 certificate would be "
          "unsound")
    parts = dict(f64_parts)
    t0 = time.perf_counter()
    _, launches, parts["host_mode"] = certify_main_path(meas, params, dev,
                                                        card)
    parts["main_path"] = time.perf_counter() - t0 - parts["host_mode"]
    emit({"phase": "certify", "check": "parts", "card": card,
          "seconds": parts, "beside_build": sorted(f64_parts)})
    return launches


def build_beside(work):
    """``rk.build()`` in a thread while ``work()`` runs in this one:
    returns the library's path, ``work()``'s result and the build's
    seconds.  The build thread lowers its own priority to nice NVCC_NICE
    before it starts ``nvcc`` (on Linux a nice value is a thread's, and a
    child process inherits its parent thread's), so the compilers take
    the cores the work leaves idle and the work keeps its own.  The build
    is joined, and its error raised, before ``work()``'s."""
    out = {}

    def run():
        try:
            os.nice(NVCC_NICE)
            out["lib"] = rk.build()
        except BaseException as exc:  # re-raised in the caller's thread
            out["error"] = exc
        out["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="nvcc build")
    thread.start()
    try:
        result = work()
    finally:
        thread.join()
        if "error" in out:
            raise out["error"]
    return out["lib"], result, out["seconds"]


# ---------------------------------------------------------------------------
# The distributed init, the dense-Q formulation and the fused refinement
# ---------------------------------------------------------------------------

def alignment_log(run):
    """``run()`` with every frame alignment of ``models.dist_init``
    recorded: per call the robot aligned, its neighbor, the measurement of
    each candidate and the rotation averaging's inlier mask."""
    calls = []
    orig_cand = dist_init._alignment_candidates
    orig_avg = averaging.robust_single_rotation_averaging

    def cand(part, T_local, T_global, b, a):
        r1, r2 = np.asarray(part.meas.r1), np.asarray(part.meas.r2)
        ks = np.nonzero(((r1 == a) & (r2 == b)) | ((r1 == b) & (r2 == a)))[0]
        calls.append({"robot": b, "neighbor": a, "meas": ks})
        return orig_cand(part, T_local, T_global, b, a)

    def avg(*a, **k):
        res = orig_avg(*a, **k)
        calls[-1]["inliers"] = res.inlier_mask.cpu().numpy()
        return res

    dist_init._alignment_candidates = cand
    averaging.robust_single_rotation_averaging = avg
    try:
        out = run()
    finally:
        dist_init._alignment_candidates = orig_cand
        averaging.robust_single_rotation_averaging = orig_avg
    return out, calls


def inlier_counts(calls) -> dict:
    """The inlier count each robot's alignment settled on (its best)."""
    best = {}
    for c in calls:
        n = int(c["inliers"].sum()) if "inliers" in c else 0
        best[c["robot"]] = max(best.get(c["robot"], -1), n)
    return {str(b): n for b, n in sorted(best.items())}


def rotation_gap(Xa, Xb, graph, meta) -> tuple[float, float]:
    """Max and mean chordal distance ||R_a - R_b||_F between two lifted
    states, each rounded in the gauge of pose 0."""
    ylift = rbcd.lifting_matrix(meta, torch.float64, Xa.device)
    Ta, Tb = (rbcd.round_global(rbcd.gather_to_global(X.double(), graph,
                                                      N_POSES), ylift)
              for X in (Xa, Xb))
    d = torch.linalg.matrix_norm(Ta[..., :3] - Tb[..., :3])
    return float(d.max()), float(d.mean())


def dist_init_phase(prob, meas, params, dev, card: str) -> int:
    """The distributed init on the card in float32 (the alignment in
    float64 on the candidates) against the port's float64 CPU run, its
    solve through the verdict loop beside the chordal-init solve, and the
    init on the GNC stand-in.  Returns the B2 launches of the two
    distributed-init solves and, apart, of the chordal-init solve (a run
    of the verdict path)."""
    graph, meta, part = prob.graph, prob.meta, prob.part
    host = rbcd.prepare_problem(meas, ROBOTS, params, dtype=torch.float64,
                                device="cpu", init=None)
    X_host, host_calls = alignment_log(lambda: dist_init.
                                       distributed_initialization(
                                           host.part, host.meta, host.graph,
                                           params, torch.float64))
    reads0 = averaging.HOST_READS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            (X0, calls) = alignment_log(lambda: dist_init.
                                        distributed_initialization(
                                            part, meta, graph, params,
                                            torch.float32))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_syncs = sum("synchroniz" in str(w.message) for w in syncs)
    gnc_reads = averaging.HOST_READS - reads0
    err = float((X0.double().cpu() - X_host).abs().max())
    scale = float(X_host.abs().max())
    rot_max, rot_mean = rotation_gap(X0, prob.X0, graph, meta)

    out, launches = {}, {}
    for init in ("distributed", "chordal"):
        rk.LAUNCHES = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = rbcd.solve_rbcd(meas, ROBOTS, params, max_iters=MAX_ITERS,
                              grad_norm_tol=GRAD_TOL, init=init,
                              verdict_every=VERDICT_K, dtype=torch.float32,
                              device=dev)
        torch.cuda.synchronize()
        out[init] = {"iterations": res.iterations,
                     "terminated_by": res.terminated_by,
                     "cost_first": res.cost_history[0],
                     "cost_final": res.cost_history[-1],
                     "grad_norm_final": res.grad_norm_history[-1],
                     "solve_s": time.perf_counter() - t1,
                     "launches": {"rtr_full": rk.LAUNCHES},
                     "rounds_enqueued": rbcd.rounds_enqueued(
                         res.iterations, max_iters=MAX_ITERS, eval_every=1,
                         verdict_every=VERDICT_K)}
        check(rk.LAUNCHES == out[init]["rounds_enqueued"]
              and res.iterations > 0, f"the {init}-init solve did not "
              "launch B2 once per enqueued round")
        check(bool(torch.isfinite(res.T).all()),
              f"the {init}-init trajectory is malformed")
        launches[init] = rk.LAUNCHES

    # The GNC stand-in: odometry local inits, outlier shared edges.
    gmeas = gnc_standin()
    gparams = gnc_params()
    gprob = rbcd.prepare_problem(gmeas, ROBOTS, gparams, device=dev,
                                 init=None)
    _, gcalls = alignment_log(lambda: dist_init.distributed_initialization(
        gprob.part, gprob.meta, gprob.graph, gparams, torch.float32))
    outliers = set(range(len(gmeas) - SCHED_OUTLIERS, len(gmeas)))
    cand_out = [bool(c["inliers"][i]) for c in gcalls
                for i, k in enumerate(c["meas"]) if int(k) in outliers]
    rk.LAUNCHES = 0
    gres = rbcd.solve_rbcd(gmeas, ROBOTS, gparams, max_iters=SCHED_MAX_ITERS,
                           grad_norm_tol=GRAD_TOL, init="distributed",
                           verdict_every=VERDICT_K, dtype=torch.float32,
                           device=dev)
    g_launches = rk.LAUNCHES
    g_enqueued = rbcd.rounds_enqueued(gres.iterations,
                                      max_iters=SCHED_MAX_ITERS,
                                      eval_every=1, verdict_every=VERDICT_K)
    row = {"phase": "dist_init", "card": card, "dtype": "float32",
           "alignment_dtype": "float64",
           "inliers_per_robot": inlier_counts(calls),
           "inliers_per_robot_cpu_f64": inlier_counts(host_calls),
           "alignment_order": [c["robot"] for c in calls],
           "init_s": init_s, "init_host_syncs": host_syncs,
           "gnc_host_reads": gnc_reads,
           "max_abs_dX0_card_vs_cpu_f64": err, "max_abs_X0": scale,
           "limit": 1e-4 * scale,
           "rotation_gap_to_chordal_init": {"max": rot_max,
                                            "mean": rot_mean},
           "solves": out,
           "gnc_standin": {
               "outlier_shared_candidates": len(cand_out),
               "outlier_candidates_rejected": cand_out.count(False),
               "inliers_per_robot": inlier_counts(gcalls),
               "iterations": gres.iterations,
               "terminated_by": gres.terminated_by,
               "cost_final": gres.cost_history[-1],
               "outliers_below_half": int((gres.weights[-SCHED_OUTLIERS:]
                                           < 0.5).sum()),
               "launches": {"rtr_full": g_launches},
               "rounds_enqueued": g_enqueued}}
    emit(row)
    check(row["inliers_per_robot"] == row["inliers_per_robot_cpu_f64"],
          "the card's alignment found other inlier sets than the CPU's")
    check(err <= 1e-4 * scale, "the card's distributed init leaves the "
          "CPU float64 one")
    check(g_launches == g_enqueued and gres.iterations > 0,
          "the GNC distributed-init solve did not launch B2 once per round")
    return launches["distributed"] + g_launches, launches["chordal"]


def dense_phase(prob, params, X0_host, chol_host, ell, traj_limit, dev,
                card: str) -> dict:
    """The dense-Q formulation on the card: 10 rounds from the host's
    chordal init against the "ell" formulation's (B2's 10-round bound), no
    kernel launch, Q built twice bit for bit, one K-round verdict window
    under the sync-error mode, rounds/s beside the kernel's, and one dense
    round traced (the device busy share)."""
    graph, meta, part = prob.graph, prob.meta, prob.part
    dparams = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, dense_quadratic=True))
    form = rbcd._formulation(meta, dparams, graph, torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Q1 = rbcd.dense_q_all(graph.edges, meta, graph.dense_inc)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    Q2 = rbcd.dense_q_all(graph.edges, meta, graph.dense_inc)
    q_equal = torch.equal(Q1, Q2)
    q_bytes = Q1.numel() * Q1.element_size()
    del Q1, Q2
    rk.LAUNCHES = 0
    dense = rounds_from(X0_host, graph, meta, dparams, chol_host)
    dense_launches = rk.LAUNCHES
    gap = float((dense - ell).abs().max())

    edges_g = rbcd.edge_set_from_measurements(part.meas_global,
                                              dtype=torch.float32,
                                              device=dev)
    step = rbcd.make_verdict_program(
        graph, edges_g, part.meas_global.num_poses, len(part.meas_global),
        False, grad_norm_tol=GRAD_TOL)
    vs = rbcd.init_verdict_state(VERDICT_K, ROBOTS, torch.float32, False,
                                 device=dev)
    st = rbcd.init_state(graph, meta, prob.X0, dparams)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev[0].record()
        for _ in range(VERDICT_K):
            st = rbcd.rbcd_segment(st, graph, 1, meta, dparams)
            vs = step(st.X, st.weights, st.ready, st.mu, st.rel_change,
                      st.iteration, vs)
        ev[1].record()
        copy = rbcd._start_fetch(vs.word)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    word = int(rbcd._host_fetch(copy))
    ev[1].synchronize()
    dense_ms = ev[0].elapsed_time(ev[1]) / VERDICT_K

    def window(p, k=VERDICT_K):
        s = rbcd.init_state(graph, meta, prob.X0, p)
        for _ in range(k):
            s = rbcd.rbcd_segment(s, graph, 1, meta, p)
        return k
    kernel_ms = cuda_ms(lambda: window(params), reps=3, warmup=1) \
        / VERDICT_K
    # Where a dense round's time goes: one round (and the Q build of
    # ``init_state``) traced.
    prof = profile_run(lambda: window(dparams, 1))
    row = {"phase": "dense", "card": card, "formulation": form,
           "qbuf_bytes": q_bytes, "qbuf_build_s": build_s,
           "qbuf_builds_bitwise_equal": q_equal,
           "rounds": 10, "max_abs_dX_dense_vs_ell": gap,
           "limit": traj_limit, "launches": {"rtr_full": dense_launches},
           "window_rounds": st.iteration, "window_word":
           rbcd.unpack_verdict(word), "sync_free_window": True,
           "dense_ms_per_round": dense_ms,
           "kernel_ms_per_round": kernel_ms,
           "rounds_per_s": {"dense": 1e3 / dense_ms,
                            "kernel": 1e3 / kernel_ms},
           "traced_window": {k: prof[k] for k in (
               "rounds", "wall_s", "device_busy_s", "device_busy_share",
               "device_kernel_calls", "top", "top_host")},
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(row)
    check(form == "dense", "the stand-in's dense Q does not fit the budget")
    check(q_equal, "two builds of the dense Q differ")
    check(dense_launches == 0, "the dense formulation launched a kernel")
    check(gap <= traj_limit, "the dense rounds leave the \"ell\" "
          "formulation's by more than B2's 10-round bound")
    check(word == int(vs.word) and st.iteration == VERDICT_K,
          "the dense verdict window is malformed")
    return row


def fused_refine_phase(meas, f_star: float, dev, card: str) -> tuple[int,
                                                                     int]:
    """bench_convergence.py's fused arm on the card: ``FIRST_SEGMENT``
    descent rounds, one cycle of the on-device df32 recenter and the
    oracle-stopped refinement, one readback and the host float64 verify
    against the certify phase's f*.  Returns the counted run's B2 and B4
    launches."""
    rparams = AgentParams(d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0,
                          solver=SolverParams(grad_norm_tol=1e-9,
                                              max_inner_iters=FUSED_INNER))
    prob = rbcd.prepare_problem(meas, ROBOTS, rparams, dtype=torch.float32,
                                device=dev)
    graph, meta, part = prob.graph, prob.meta, prob.part
    edges64 = refine.host_edges_f64(part.meas_global)
    gp = refine_fused.build_global_df(part.meas_global, device=dev)
    target = df32.from_f64(np.float64(f_star * (1.0 + 0.3 * FUSED_GAP)),
                           dev)
    fns = refine_fused.make_fused_fns(meta, rparams, N_POSES,
                                      max_rounds=FUSED_MAX_ROUNDS,
                                      check_every=FUSED_CHECK)
    state0 = rbcd.init_state(graph, meta, prob.X0, rparams)
    d_shape = tuple(prob.X0.shape)

    def pipeline():
        """Descent, recenter, refine; events between the pieces."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        st = rbcd.rbcd_steps(state0, graph, FIRST_SEGMENT, meta, rparams)
        Xg = rbcd.gather_to_global(st.X, graph, N_POSES)
        ev[1].record()
        R, f_ref, consts, rho32, thr = fns.recenter(Xg, gp, graph, target)
        ev[2].record()
        D, rounds, delta = fns.refine(consts, graph, gp, rho32, thr)
        ev[3].record()
        res = refine_fused.FusedCycleResult(R.hi, R.lo, D, f_ref.hi,
                                            f_ref.lo, delta, rounds)
        return Xg, res, ev

    def readback(res):
        flat = rbcd._host_fetch(fns.pack(res))
        host = refine_fused.unpack_result_host(flat, N_POSES, RANK, 4,
                                               d_shape)
        X64 = refine._np_project_manifold(
            refine_fused.assemble_f64(host, graph), 3)
        return host, refine.global_cost(X64, edges64)

    readback(pipeline()[1])  # warm: the first calls of every op
    fetches = [0]
    orig = rbcd._host_fetch

    def counting(x):
        fetches[0] += 1
        return orig(x)

    rk.LAUNCHES = 0
    rk.REFINE_LAUNCHES = 0
    rbcd._host_fetch = counting
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            Xg, res, ev = pipeline()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        host, f = readback(res)
        t2 = time.perf_counter()
    finally:
        rbcd._host_fetch = orig
    b2, b4 = rk.LAUNCHES, rk.REFINE_LAUNCHES
    gap = f / f_star - 1.0
    f_oracle = float(np.float64(host.f_ref_hi) + np.float64(host.f_ref_lo)
                     + np.float64(host.delta))
    launched = -(-FUSED_MAX_ROUNDS // FUSED_CHECK) * FUSED_CHECK

    # The device recenter against the host's float64 one at the handoff.
    R, f_ref, consts, rho32 = refine_fused.recenter_device(
        Xg, gp, graph, meta, rparams, N_POSES)
    Xg64 = Xg.double().cpu().numpy()
    href = refine.recenter(Xg64, graph, meta, rparams, edges64)
    e64 = refine.np_edges_batched(edges64)
    G, rR64, rt64, _ = refine._np_egrad(href.Xg[None], e64, N_POSES)
    G = G[0]
    S0 = refine._np_sym(np.swapaxes(href.Xg[..., :3], -1, -2) @ G[..., :3])
    g0 = G.copy()
    g0[..., :3] -= href.Xg[..., :3] @ S0
    gi = graph.global_index.cpu().numpy()
    pm = graph.pose_mask.cpu().numpy()[..., None, None]

    def rel_max(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
    errs = {"R_abs": float(np.abs(df32.to_f64(R) - href.Xg).max()),
            "f_ref_rel": abs(float(df32.to_f64(f_ref)) - href.f_ref)
            / href.f_ref}
    for name, want in (("R", href.consts.R.cpu().numpy()),
                       ("Rz", href.consts.Rz.cpu().numpy()),
                       ("G_ref", G[gi] * pm), ("g0", g0[gi] * pm),
                       ("S0", S0[gi] * pm), ("rho_rot", rR64[0]),
                       ("rho_trn", rt64[0])):
        got = {"rho_rot": rho32[0], "rho_trn": rho32[1]}.get(
            name, getattr(consts, name, None))
        errs[name] = rel_max(got.double().cpu().numpy(), want)
    errs["chol"] = float(np.abs(consts.chol.double().cpu().numpy()
                                - href.consts.chol.double().cpu().numpy())
                         .max() / max(float(href.consts.chol.abs().max()),
                                      1.0))
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    row = {"phase": "fused_refine", "card": card, "dtype": "float32",
           "first_segment": FIRST_SEGMENT, "max_inner_iters": FUSED_INNER,
           "cycles": 1, "max_rounds": FUSED_MAX_ROUNDS,
           "check_every": FUSED_CHECK, "f_star": f_star,
           "target_rel_gap": 0.3 * FUSED_GAP,
           "refine_rounds_used": host.rounds,
           "refine_rounds_launched": b4, "launches": {
               "rtr_full": b2, "rtr_refine_full": b4},
           "verified_rel_gap": gap, "oracle_rel_gap": f_oracle / f_star
           - 1.0, "oracle_vs_verify": abs(f_oracle - f) / f_star,
           "host_fetches": fetches, "sync_free_until_readback": True,
           "descent_ms": ms[0], "recenter_ms": ms[1], "refine_ms": ms[2],
           "enqueue_s": t1 - t0, "readback_verify_s": t2 - t1,
           "total_s": t2 - t0, "recenter_vs_host": errs}
    emit(row)
    check(b2 == FIRST_SEGMENT, "the descent did not launch B2 once per round")
    check(b4 == launched and 0 <= host.rounds <= launched,
          "refine_until did not launch B4 once per enqueued round")
    check(fetches[0] == 1, "the fused pipeline read the device more than "
          "once")
    check(errs["R_abs"] <= 1e-9 and errs["f_ref_rel"] <= 1e-9
          and max(errs[k] for k in ("R", "Rz", "G_ref", "g0", "S0",
                                    "rho_rot", "rho_trn")) <= 3e-6
          and errs["chol"] <= 1e-4,
          "the card's df32 recenter leaves the host float64 one")
    check(row["oracle_vs_verify"] <= 1e-8,
          "the on-device oracle disagrees with the host verify")
    check(gap <= FUSED_GAP, "the fused pipeline missed the 1e-6 gap")
    return b2, b4


# ---------------------------------------------------------------------------
# The agents phase: the per-robot deployment runtime on the card
# ---------------------------------------------------------------------------

#: The agents phase: the lockstep fleet's round cap; the chaos arm's
#: rounds, killed robot and round, and round pacing (``tests/
#: test_chaos.py``'s schedule); the async arm's rate and seconds; the
#: fetch cadence of the latched arm and its rounds; the lockstep team
#: cost's limit against the production arm's final cost.
AGENT_MAX_ROUNDS, CHAOS_ROUNDS, CHAOS_KILL, CHAOS_PACE = 300, 60, (7, 40), \
    0.004
ASYNC_HZ, ASYNC_S, FETCH_K, FETCH_ROUNDS = 50.0, 5.0, 8, 16
TEAM_COST_RTOL, CHAOS_RTOL = 0.01, 0.01


def agent_fleet(part, params, dev) -> list:
    """One ``PGOAgent`` per robot on the card: robot 0's lifting matrix
    broadcast, each robot's ``setPoseGraph`` split ingested."""
    agents = [agent_mod.PGOAgent(rid, params, device=dev)
              for rid in range(part.num_robots)]
    for ag in agents[1:]:
        ag.set_lifting_matrix(agents[0].get_lifting_matrix())
    for ag in agents:
        ag.set_pose_graph(*partition.agent_measurements(part, ag.robot_id))
    return agents


def bus_lockstep(agents, rounds: int, *, until_consensus: bool,
                 injector=None, kill=None, pace: float = 0.0,
                 before_iterate=None, after_round=None) -> dict:
    """Lockstep rounds over ``comms.loopback_fleet`` (``tests/
    test_chaos.py``'s ``_run_fleet`` at staleness 0): every live robot
    publishes its frame (no anchor), the bus relays, every live robot
    ingests its peers' frames and iterates.  Returns the run's counts."""
    A = len(agents)
    policy = comms.RetryPolicy(max_attempts=2, base_delay_s=0.002,
                               max_delay_s=0.01, send_timeout_s=0.5,
                               recv_timeout_s=0.5)
    bus, clients = comms.loopback_fleet(
        A, injector=injector, policy=policy, round_timeout_s=0.15,
        miss_limit=5, liveness_timeout_s=2.0)
    for c in clients.values():
        c.channel.start_heartbeat(0.05)
    dead: set[int] = set()
    st = {"rounds": 0, "stepped": 0, "iterates": 0, "publishes": 0,
          "iterate_s": 0.0, "consensus": False}
    t0 = time.perf_counter()
    try:
        for it in range(rounds):
            if kill is not None and it == kill[1]:
                dead.add(kill[0])
                clients[kill[0]].close()
            live = [ag for ag in agents if ag.robot_id not in dead]
            for ag in live:
                st["publishes"] += ag._X_dev is not None
                clients[ag.robot_id].publish(comms.pack_agent_frame(ag),
                                             timeout=0.5)
            bus.round()
            for ag in live:
                c = clients[ag.robot_id]
                merged = c.collect(timeout=0.3)
                if merged is not None:
                    for peer, pf in c.peer_frames(merged).items():
                        comms.apply_peer_frame(ag, peer, pf)
                    for lost in c.lost:
                        ag.mark_neighbor_lost(lost)
                if before_iterate is not None:
                    before_iterate(ag)
                t1 = time.perf_counter()
                st["stepped"] += ag.iterate(True)
                st["iterate_s"] += time.perf_counter() - t1
                st["iterates"] += 1
            st["rounds"] = it + 1
            if after_round is not None:
                after_round(agents)
            if until_consensus and all(ag.should_terminate() for ag in live):
                st["consensus"] = True
                break
            if pace:
                time.sleep(pace)
        torch.cuda.synchronize()
        st["wall_s"] = time.perf_counter() - t0
    finally:
        bus.close()
        for rid, c in clients.items():
            if rid not in dead:
                c.close()
    st["lost"] = sorted(bus.lost)
    return st


def inproc_rounds(agents, rounds: int) -> int:
    """Lockstep rounds with the exchange in process (packed arrays and
    status gossip, no transport): the 10-round and latched arms."""
    stepped = 0
    for _ in range(rounds):
        pubs = [ag.get_public_pose_arrays() for ag in agents]
        sts = [ag.get_status() for ag in agents]
        for dst in agents:
            for src, pub in enumerate(pubs):
                if src != dst.robot_id:
                    dst.set_neighbor_status(sts[src])
                    if pub is not None:
                        dst.update_neighbor_poses_packed(src, *pub)
        for ag in agents:
            stepped += ag.iterate(True)
    return stepped


def lifted_cost(agents, part, meas, robots) -> float:
    """The relaxed cost of the assembled lifted iterate over the edges
    whose both endpoints belong to ``robots``: float64, on the host."""
    N = meas.num_poses
    Xg = np.zeros((N, RANK, meas.d + 1))
    for rid in robots:
        ids = part.global_index[rid][part.global_index[rid] >= 0]
        Xg[ids] = np.asarray(agents[rid].X, np.float64)
    keep = np.isin(part.meas.r1, robots) & np.isin(part.meas.r2, robots)
    edges = edge_set_from_measurements(part.meas_global.select(keep),
                                       device="cpu")
    return float(quadratic.cost(torch.tensor(Xg), edges))


def native_paths(meas) -> dict:
    """The native host paths against the Python ones on the stand-in: the
    g2o file written and read back both ways, the topology both ways
    (the library was built in the ``build`` phase)."""
    with tempfile.TemporaryDirectory(dir=native_io.BUILD_DIR) as tmp:
        path = str(Path(tmp) / "standin.g2o")
        g2o.write_g2o(meas, path)
        t0 = time.perf_counter()
        nat = g2o.read_g2o(path, backend="native")
        t1 = time.perf_counter()
        py = g2o.read_g2o_python(path)
        t2 = time.perf_counter()
    same = {f: bool(np.array_equal(getattr(nat, f), getattr(py, f)))
            for f in ("r1", "p1", "r2", "p2", "R", "t", "kappa", "tau",
                      "weight", "is_known_inlier")}
    ulps = {f: float(np.max(np.abs(getattr(nat, f) - getattr(py, f))
                            / np.spacing(np.abs(getattr(py, f)))))
            for f in ("R", "t", "kappa", "tau")}
    part = partition.partition_contiguous(py, ROBOTS)
    m = part.meas
    t3 = time.perf_counter()
    pn = graph_plan.plan_topology(m.r1, m.p1, m.r2, m.p2, ROBOTS,
                                  part.n_max, backend="native")
    t4 = time.perf_counter()
    pp = graph_plan.plan_topology(m.r1, m.p1, m.r2, m.p2, ROBOTS,
                                  part.n_max, backend="python")
    t5 = time.perf_counter()
    plan_same = all(np.array_equal(np.asarray(getattr(pn, f)),
                                   np.asarray(getattr(pp, f)))
                    and np.asarray(getattr(pn, f)).dtype
                    == np.asarray(getattr(pp, f)).dtype
                    for f in pn._fields)
    row = {"phase": "agents", "check": "native_paths",
           "library": native_io.library_path().name, "edges": len(nat),
           "read_native_s": t1 - t0, "read_python_s": t2 - t1,
           "fields_bitwise": same, "max_ulps": ulps,
           "plan_native_s": t4 - t3, "plan_python_s": t5 - t4,
           "plan_bitwise": plan_same}
    emit(row)
    # tau of SE(3): the C++ loader takes tr(inv(I)) through cofactors, the
    # Python parser through LAPACK; they may differ by one ulp (the JAX
    # package's loaders likewise).  Every other field is bitwise.
    check(all(v for k, v in same.items() if k != "tau")
          and ulps["tau"] <= 1.0,
          "the native g2o loader leaves the Python parse")
    check(plan_same, "the native planner leaves the Python planner")
    return row


def agents_phase(meas, prod_cost: float, dev, card: str) -> int:
    """The per-robot runtime (``agent.PGOAgent`` over ``comms``) on the
    card: the native host paths; the lockstep fleet over the loopback bus
    to consensus, with its launch and host-read counts; B2 at A=1 on agent
    3's operands at its first and last stepped iterate; 10 in-process
    rounds through B2 against the "ell" fleet; the latched fetch cadence
    and one sync-free iterate; the chaos arm; the async arm.  Returns B2's
    launches on the counted arms."""
    native_paths(meas)
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS)
    part = partition.partition_contiguous(meas, ROBOTS)

    # -- the lockstep fleet, counted ---------------------------------------
    agents = agent_fleet(part, params, dev)
    ops3, snap = {}, []

    def before_iterate(ag):
        if ag.robot_id == 3 and ag._graph is not None and \
                ag._neighbor_buffer() is not None:
            ops = dict(zip(B2_ORDER, (t.clone() for t in
                                      rbcd.kernel_operands(
                                          ag._X_device()[None],
                                          ag._neighbor_buffer(),
                                          ag._edges_weighted(),
                                          ag._chol_device(), ag._graph))))
            ops3.setdefault("first", ops)
            ops3["last"] = ops

    def after_round(ags):
        if not snap and all(ag._graph is not None and
                            ag._neighbor_buffer() is not None for ag in ags):
            snap.extend(interop.agent_state_to_numpy(ag) for ag in ags)

    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    agent_mod.HOST_READS.clear()
    st = bus_lockstep(agents, AGENT_MAX_ROUNDS, until_consensus=True,
                      before_iterate=before_iterate, after_round=after_round)
    launches = rk.LAUNCHES
    reads = dict(agent_mod.HOST_READS)
    b2_total = launches
    team = lifted_cost(agents, part, meas, list(range(ROBOTS)))
    ag3 = agents[3]
    X3, z3 = ag3._X_device(), ag3._neighbor_buffer()
    step_ms = cuda_ms(lambda: ag3._step(X3, z3), reps=10, inner=10)
    row = {"phase": "agents", "check": "lockstep", "card": card,
           "robots": ROBOTS, "rounds": st["rounds"],
           "consensus": st["consensus"], "wall_s": st["wall_s"],
           "iterates": st["iterates"], "stepped": st["stepped"],
           "iterates_per_s": st["iterates"] / st["wall_s"],
           "host_ms_per_iterate": 1e3 * st["iterate_s"] / st["iterates"],
           "device_ms_per_step": step_ms,
           "publishes": st["publishes"], "host_reads": reads,
           "launches": {"rtr_full": launches},
           "team_cost": team, "production_arm_cost": prod_cost,
           "team_cost_ratio": team / prod_cost,
           "formulation": "kernel" if ag3._kernel else "ell"}
    emit(row)
    check(all(ag._kernel for ag in agents),
          "a robot's step does not run kernel B2 on the card")
    check(all(ag.get_status().state == agent_mod.AgentState.INITIALIZED
              for ag in agents), "a robot never initialized")
    check(team <= (1 + TEAM_COST_RTOL) * prod_cost,
          "the lockstep fleet's cost is above 1.01 x the production arm's")
    check(launches == st["stepped"] > 0,
          "the fleet did not launch B2 once per stepped iterate")
    check(reads.get("rel_change", 0) == st["stepped"]
          and reads.get("publish", 0) == st["publishes"]
          and set(reads) <= {"rel_change", "publish", "align"},
          "the fleet's host reads are not one per stepped iterate plus "
          "one per publish")

    # -- B2 at A=1 on agent 3's operands ------------------------------------
    kw = rbcd.kernel_options(params, ag3._meta)
    p_first, _ = kernel_parity(rk.rtr_full, rk.rtr_full_reference,
                               ops3["first"], kw, "agent 3, first iterate")
    p_last, _ = kernel_parity(rk.rtr_full, rk.rtr_full_reference,
                              ops3["last"], kw, "agent 3, last iterate",
                              floor=True)
    a1_err = max(p_first["max_abs_dX"],
                 p_last.get("max_abs_dX_agreeing", p_last["max_abs_dX"]))
    a1 = ops3["first"]
    emit({"phase": "timing", "card": card, "kernel": "rtr_full",
          "agents": 1, "operands": "agent 3, first iterate",
          "n": ag3.n, "edges": ag3._meta.e_max,
          "route": plan_of(a1, kw).route, "cluster": plan_of(a1, kw).C,
          "ms": cuda_ms(lambda: rk.rtr_full(*a1.values(), **kw), reps=10,
                        inner=10),
          "plain_ms": cuda_ms(lambda: rk.rtr_full_reference(*a1.values(),
                                                            **kw),
                              reps=5, warmup=1)})

    # -- 10 in-process rounds through B2 against the "ell" fleet -------------
    plain = AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                        solver=SolverParams(pallas_tcg=False))
    ell = agent_fleet(part, plain, dev)

    def ten_rounds(fleet, moved_seed=None):
        for ag, s in zip(fleet, snap):
            s = dict(s)
            if moved_seed is not None:
                gen = np.random.default_rng(moved_seed * 100 + ag.robot_id)
                u = gen.integers(-1, 2, s["X"].shape)
                s["X"] = (s["X"].astype(np.float32)
                          * (1 + u * 2.0 ** -23).astype(np.float32))
            interop.agent_state_from_numpy(ag, s)
        inproc_rounds(fleet, 10)
        return [ag._X_device().double() for ag in fleet]

    def gap(xa, xb):
        return max(float((a - b).abs().max()) for a, b in zip(xa, xb))

    xk = ten_rounds(agents)
    xe = ten_rounds(ell)
    check(not any(ag._kernel for ag in ell), "the ell fleet ran a kernel")
    spread = [gap(ten_rounds(ell, seed), xe)
              for seed in range(PERTURBED_STARTS)]
    limit = min(TRAJ_SPREAD * max(spread), TRAJ_MAX)
    traj = gap(xk, xe)
    emit({"phase": "agents", "check": "ten_rounds_kernel_vs_ell",
          "robots": ROBOTS, "max_abs_dX": traj,
          "ell_ulp_moved_starts_max_abs_dX": spread, "limit": limit,
          "a1_parity_max_abs_dX": a1_err})
    check(traj <= limit, "the fleet's 10 rounds through B2 leave the ell "
          "fleet's by more than its own one-ulp divergence allows")

    # -- the latched fetch cadence and a sync-free iterate -------------------
    for ag, s in zip(agents, snap):
        ag.params = dataclasses.replace(params, status_fetch_every=FETCH_K)
        interop.agent_state_from_numpy(ag, s)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    agent_mod.HOST_READS.clear()
    stepped = inproc_rounds(agents, FETCH_ROUNDS)
    fetch_launches = rk.LAUNCHES
    fetch_reads = dict(agent_mod.HOST_READS)
    b2_total += fetch_launches
    pubs = [ag.get_public_pose_arrays() for ag in agents]
    for src, pub in enumerate(pubs):
        if src != 3:
            ag3.update_neighbor_poses_packed(src, *pub)
    if (ag3.get_status().iteration_number + 1) % FETCH_K == 0:
        inproc_rounds(agents, 1)
    ag3._neighbor_buffer()
    torch.cuda.synchronize()
    before, reads0 = rk.LAUNCHES, dict(agent_mod.HOST_READS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sync_free = ag3.iterate(True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sync_free_ok = sync_free and rk.LAUNCHES == before + 1 and \
        dict(agent_mod.HOST_READS) == reads0
    emit({"phase": "agents", "check": "fetch_every", "k": FETCH_K,
          "rounds": FETCH_ROUNDS, "stepped": stepped,
          "rel_change_reads": fetch_reads.get("rel_change", 0),
          "reads_per_iterate": fetch_reads.get("rel_change", 0) / stepped,
          "launches": {"rtr_full": fetch_launches},
          "sync_free_iterate": sync_free_ok})
    check(stepped == ROBOTS * FETCH_ROUNDS and fetch_launches == stepped
          and fetch_reads.get("rel_change", 0) * FETCH_K == stepped,
          "status_fetch_every=8 did not read 1/8 per iterate")
    check(sync_free_ok, "an iterate off the fetch cadence synced the host")

    # -- the chaos arm --------------------------------------------------------
    survivors = [r for r in range(ROBOTS) if r != CHAOS_KILL[0]]
    costs, chaos = {}, {}
    for arm in ("fault_free", "chaos"):
        fleet = agent_fleet(part, params, dev)
        inj = comms.FaultInjector(comms.FaultSpec(
            drop=0.10, delay=0.25, delay_s=(CHAOS_PACE, 3 * CHAOS_PACE),
            reorder=0.05), seed=7) if arm == "chaos" else None
        torch.cuda.synchronize()
        rk.LAUNCHES = 0
        agent_mod.HOST_READS.clear()
        t0 = time.perf_counter()
        chaos[arm] = bus_lockstep(
            fleet, CHAOS_ROUNDS, until_consensus=False, injector=inj,
            kill=CHAOS_KILL if arm == "chaos" else None, pace=CHAOS_PACE)
        chaos[arm]["seconds"] = time.perf_counter() - t0
        chaos[arm]["launches"] = rk.LAUNCHES
        b2_total += rk.LAUNCHES
        check(rk.LAUNCHES == chaos[arm]["stepped"],
              f"the {arm} arm did not launch B2 once per stepped iterate")
        costs[arm] = lifted_cost(fleet, part, meas, survivors)
        if inj is not None:
            chaos[arm]["faults"] = dict(inj.stats)
            chaos[arm]["survivors_lost"] = [fleet[r].lost_neighbors
                                            for r in survivors]
    rel = abs(costs["chaos"] - costs["fault_free"]) / costs["fault_free"]
    emit({"phase": "agents", "check": "chaos", "card": card,
          "rounds": CHAOS_ROUNDS, "kill": list(CHAOS_KILL),
          "survivor_cost": costs, "rel_diff": rel,
          **{arm: {k: v for k, v in s.items()} for arm, s in chaos.items()}})
    check(chaos["chaos"]["lost"] == [CHAOS_KILL[0]]
          and all(lost == [CHAOS_KILL[0]]
                  for lost in chaos["chaos"]["survivors_lost"]),
          "the chaos arm did not learn of the killed robot")
    check(chaos["fault_free"]["lost"] == [], "the fault-free arm lost a robot")
    check(rel <= CHAOS_RTOL, "the chaos arm's survivors left the fault-free "
          "cost by more than 1%")

    # -- the async arm --------------------------------------------------------
    b2_total += async_arm(part, params, dev, card)
    return b2_total


def async_arm(part, params, dev, card: str) -> int:
    """``start_optimization_loop(rate_hz=50)`` on every robot with the
    overlapped bus clients (staleness 1) for ``ASYNC_S`` seconds: a relay
    thread, one exchange thread and one Poisson-clock iterate thread per
    robot; one second traced.  Returns B2's launches."""
    from torch.profiler import ProfilerActivity, profile

    agents = agent_fleet(part, params, dev)
    policy = comms.RetryPolicy(max_attempts=2, base_delay_s=0.002,
                               max_delay_s=0.01, send_timeout_s=0.5,
                               recv_timeout_s=0.5)
    bus, clients = comms.loopback_fleet(
        ROBOTS, policy=policy, round_timeout_s=0.15, miss_limit=100,
        liveness_timeout_s=10.0)
    for c in clients.values():
        c.channel.start_heartbeat(0.05)
    errors, counts, lock = [], {r: [0, 0] for r in range(ROBOTS)}, \
        threading.Lock()
    stop_relay, stop_exchange = threading.Event(), threading.Event()
    old_hook = threading.excepthook

    def hook(args):
        errors.append(f"{args.thread.name}: " + "".join(
            traceback.format_exception(args.exc_type, args.exc_value,
                                       args.exc_traceback)))
    threading.excepthook = hook

    for ag in agents:
        real = ag.iterate

        def counting(do_optimization=True, _real=real, _rid=ag.robot_id):
            stepped = _real(do_optimization)
            with lock:
                counts[_rid][0] += 1
                counts[_rid][1] += stepped
            return stepped
        ag.iterate = counting

    def relay():
        while not stop_relay.is_set():
            bus.round()

    def exchanger(ag):
        c = clients[ag.robot_id]
        c.start_overlap(1, timeout=1.0)
        while not stop_exchange.is_set():
            merged = c.exchange(comms.pack_agent_frame(ag), timeout=1.0)
            if merged is not None:
                for peer, pf in c.peer_frames(merged).items():
                    comms.apply_peer_frame(ag, peer, pf)
            time.sleep(1.0 / ASYNC_HZ)
        c.drain_overlap(timeout=10.0)

    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    agent_mod.HOST_READS.clear()
    relay_t = threading.Thread(target=relay, name="relay", daemon=True)
    ex_ts = [threading.Thread(target=exchanger, args=(ag,),
                              name=f"exchange-{ag.robot_id}", daemon=True)
             for ag in agents]
    t0 = time.perf_counter()
    relay_t.start()
    for t in ex_ts:
        t.start()
    for ag in agents:
        ag.start_optimization_loop(rate_hz=ASYNC_HZ)
    time.sleep(ASYNC_S / 2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        time.sleep(1.0)
        traced_s = time.perf_counter() - t1
    traced_at = time.perf_counter() - t0
    time.sleep(max(0.0, ASYNC_S - (time.perf_counter() - t0)))
    run_s = time.perf_counter() - t0
    for ag in agents:
        ag.end_optimization_loop()
    loops_joined = not any(ag.is_optimization_running() for ag in agents)
    t_loops = time.perf_counter() - t0
    stop_exchange.set()
    for t in ex_ts:
        t.join(timeout=30.0)
    t_exchange = time.perf_counter() - t0
    consensus = all(ag.should_terminate() for ag in agents)
    stop_relay.set()
    relay_t.join(timeout=30.0)
    joined = loops_joined and not any(t.is_alive() for t in [relay_t, *ex_ts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.LAUNCHES
    reads = dict(agent_mod.HOST_READS)
    bus.close()
    for c in clients.values():
        c.close()
    threading.excepthook = old_hook
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    stepped = sum(s for _, s in counts.values())
    emit({"phase": "agents", "check": "async", "card": card,
          "rate_hz": ASYNC_HZ, "seconds": wall, "run_s": run_s,
          "profile_exit_s": traced_at, "loops_joined_s": t_loops,
          "exchange_joined_s": t_exchange, "staleness": 1,
          "iterates_per_robot": [counts[r][0] for r in range(ROBOTS)],
          "stepped_per_robot": [counts[r][1] for r in range(ROBOTS)],
          "launches": {"rtr_full": launches}, "host_reads": reads,
          "threads_joined": joined, "errors": errors,
          "consensus": consensus, "lost": sorted(bus.lost),
          "traced_s": traced_s, "device_busy_s": dev_us / 1e6,
          "device_busy_share": dev_us / 1e6 / traced_s})
    check(joined, "an async thread did not join")
    check(not errors, "an async thread raised: " + "; ".join(errors))
    check(launches == stepped > 0,
          "the async arm did not launch B2 once per stepped iterate")
    return launches


# ---------------------------------------------------------------------------
# Telemetry on the solve paths
# ---------------------------------------------------------------------------

#: The telemetry phase: K and rounds of the flight-recorder run, the fused
#: rounds of the device trace window, and the window's agreement with the
#: same launches timed between CUDA events (less an empty pair's overhead
#: per launch).
REC_K, REC_EVAL, REC_ROUNDS, WINDOW_ROUNDS, WINDOW_RTOL = 16, 4, 64, 20, 0.10
#: Captures of a trace window at most: the profiler now and then drops the
#: device records of a window's first launches (their launch records are
#: in the trace; the device records of the rest are), and such a capture
#: is taken again rather than read.
WINDOW_CAPTURES = 3
#: GPU cycles of the spin ahead of each timed B2 launch (~0.5 ms).
SPIN_BEFORE_B2 = 1_000_000


def launches_without_device_record(events: list) -> int:
    """Kernel launches a trace's runtime records hold whose device record
    the trace lacks (matched by correlation id): records the profiler
    dropped."""
    def corr(e):
        return (e.get("args") or {}).get("correlation")

    kernels = {corr(e) for e in events if e.get("cat") == "kernel"}
    launched = {corr(e) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in str(e.get("name", ""))}
    return len(launched - kernels - {None})


def telemetry_phase(prob, params, dev, card: str, tmp: Path) -> int:
    """Telemetry on the solve paths (``obs`` run on): the production arm
    with telemetry off and on in this process, its host syncs per 100
    rounds (2 x 100/K on, 100/K off) and its event stream against the
    returned history, the run's report; a flight-recorder black box taken
    in the verdict loop, replayed on the card bit for bit; a
    ``devprof.DeviceTraceWindow`` over fused rounds, B2's device time in
    it against the same launches between CUDA events, less the overhead
    of an empty event pair per launch.  Returns B2's launches."""
    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.obs import devprof, recorder
    from dpgo_tpu_torch.obs.report import render_report

    pp = dataclasses.replace(prob, params=dataclasses.replace(
        params, rel_change_tol=-1.0))

    def drive():
        return rbcd.dispatch_prepared(pp, max_iters=PROD_ROUNDS,
                                      grad_norm_tol=0.0, eval_every=PROD_K,
                                      verdict_every=PROD_K)

    b2 = 0
    arms = {}
    for arm in ("off", "on"):
        run_dir = tmp / f"prod_{arm}"
        rk.LAUNCHES = 0
        if arm == "on":
            with obs.run_scope(str(run_dir)) as run:
                res, fetches, dt = counted_drive(drive)
                metric = run.registry.snapshot()[
                    "host_syncs_per_100_rounds"]["series"][0]["value"]
        else:
            res, fetches, dt = counted_drive(drive)
            metric = None
        b2 += rk.LAUNCHES
        enqueued = rbcd.rounds_enqueued(
            res.iterations, max_iters=PROD_ROUNDS, eval_every=PROD_K,
            verdict_every=PROD_K)
        arms[arm] = {"rounds": res.iterations, "solve_s": dt,
                     "rounds_per_s": enqueued / dt, "host_fetches": fetches,
                     "fetches_per_100_rounds": 100.0 * fetches
                     / res.iterations,
                     "host_syncs_per_100_rounds_metric": metric,
                     "launches": {"rtr_full": rk.LAUNCHES},
                     "rounds_enqueued": enqueued,
                     "cost_history": res.cost_history}
    on = arms["on"]
    evs = obs.read_events(str(tmp / "prod_on" / "events.jsonl"))
    eval_costs = [e["value"] for e in evs if e.get("metric") == "solver_cost"
                  and e.get("phase") == "eval"]
    report = render_report(str(tmp / "prod_on"))
    emit({"phase": "telemetry", "check": "production_arm", "card": card,
          "verdict_every": PROD_K, **{f"telemetry_{k}": v
                                      for k, v in arms.items()},
          "events": len(evs), "eval_costs": eval_costs,
          "report_lines": len(report.splitlines())})
    check(on["host_syncs_per_100_rounds_metric"] == 2 * 100.0 / PROD_K
          and on["fetches_per_100_rounds"] == 2 * 100.0 / PROD_K,
          "telemetry on does not read 2 x 100/K per 100 rounds")
    check(arms["off"]["host_fetches"] - 1 == PROD_ROUNDS // PROD_K,
          "telemetry off does not read one word per K rounds")
    check(all(a["launches"]["rtr_full"] == a["rounds_enqueued"]
              for a in arms.values()),
          "a production arm did not launch B2 once per enqueued round")
    check(eval_costs == on["cost_history"] and
          on["cost_history"] == arms["off"]["cost_history"],
          "the event stream's costs are not the returned history")
    check("solver_cost" in report and "host_syncs_per_100_rounds" in report,
          "the report does not render the run")

    # -- the flight recorder: a verdict-loop box replayed on the card --------
    rec_dir = tmp / "recorder"
    rk.LAUNCHES = 0
    with obs.run_scope(str(rec_dir)) as run:
        rec = recorder.FlightRecorder.attach(run)
        res = rbcd.dispatch_prepared(pp, max_iters=REC_ROUNDS,
                                     grad_norm_tol=0.0, eval_every=REC_EVAL,
                                     verdict_every=REC_K)
        path = rec.dump("chip_smoke")
    b2 += rk.LAUNCHES
    ctx, _ = recorder.load_blackbox(path)
    rk.LAUNCHES = 0
    rep = recorder.replay(path, snapshot=0, device=dev)
    replay_b2 = rk.LAUNCHES
    emit({"phase": "telemetry", "check": "flight_recorder", "card": card,
          "rounds": res.iterations, "verdict_every": REC_K,
          "eval_every": REC_EVAL,
          "snapshots": [s["iteration"] for s in ctx["snapshots"]],
          "replay_from": rep.snapshot_iteration,
          "replayed_evals": len(rep.iterations), "match": rep.match,
          "mismatches": rep.mismatches[:3],
          "replay_launches": {"rtr_full": replay_b2}})
    check(rep.match and len(rep.iterations) >= 2 * REC_K // REC_EVAL,
          "the black box does not replay on the card bit for bit")
    check(replay_b2 == REC_ROUNDS - rep.snapshot_iteration,
          "the replay did not launch B2 once per round")

    # -- device trace windows over fused rounds -------------------------------
    # The first window gives the rounds' device busy share.  In the second,
    # a spin kernel ahead of each B2 launch keeps the stream busy while
    # the host records the events and launches, so the events bracket the
    # kernel alone (on a starved stream they would also hold the host's
    # launch latency); B2's slices in the trace are held against them.  An
    # event pair adds its own few microseconds to what it brackets (5-11%
    # of a ~0.08 ms launch near the start): an empty pair recorded behind
    # the same spin, just ahead of each bracketed launch, measures that
    # overhead, and the empty pairs' sum is taken off the brackets' before
    # the comparison.
    state = rbcd.rbcd_steps(rbcd.init_state(prob.graph, prob.meta, prob.X0,
                                            params),
                            prob.graph, 2, prob.meta, params)
    spans, empty = [], []
    real = rk.rtr_full

    def timed(*a, **kw):
        torch.cuda._sleep(SPIN_BEFORE_B2)
        c0, c1, e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(4))
        c0.record()
        c1.record()
        e0.record()
        out = real(*a, **kw)
        e1.record()
        empty.append((c0, c1))
        spans.append((e0, e1))
        return out

    windows, dropped = {}, {}
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    with obs.run_scope(str(tmp / "window_run")):
        for name in ("plain", "events"):
            dropped[name] = []
            for attempt in range(WINDOW_CAPTURES):
                spans.clear()
                empty.clear()
                where = str(tmp / f"win_{name}_{attempt}")
                rk.rtr_full = timed if name == "events" else real
                try:
                    win = devprof.DeviceTraceWindow(where,
                                                    plane="solve").start()
                    state = rbcd.rbcd_steps(state, prob.graph,
                                            WINDOW_ROUNDS, prob.meta, params)
                    att = win.stop(num_rounds=WINDOW_ROUNDS, label=name)
                finally:
                    rk.rtr_full = real
                events = []
                for f in devprof.find_trace_files(where):
                    events += devprof.load_trace_events(f)
                dropped[name].append(launches_without_device_record(events))
                if not dropped[name][-1]:
                    break
            check(att is not None and att["window_s"] > 0,
                  "a device trace window holds no device event")
            windows[name] = (att, *devprof.op_device_seconds(events,
                                                             "rtr_full"))
    b2 += rk.LAUNCHES
    torch.cuda.synchronize()
    event_s = sum(e0.elapsed_time(e1) for e0, e1 in spans) * 1e-3
    empty_s = sum(c0.elapsed_time(c1) for c0, c1 in empty) * 1e-3
    net_s = event_s - empty_s
    att, _, _ = windows["plain"]
    _, trace_s, trace_n = windows["events"]
    emit({"phase": "telemetry", "check": "device_trace_window",
          "card": card, "rounds": WINDOW_ROUNDS,
          "window_s": att["window_s"], "lanes": att["lanes"],
          "device_busy_share": (att["compute_s"] + att["collective_s"])
          / att["window_s"],
          "b2_plain_window_s": windows["plain"][1],
          "b2_plain_window_launches": windows["plain"][2],
          "b2_trace_s": trace_s, "b2_trace_launches": trace_n,
          "b2_cuda_event_s": event_s, "b2_cuda_event_launches": len(spans),
          "launches_without_device_record_per_capture": dropped,
          "empty_event_pairs_s": empty_s,
          "b2_cuda_event_net_s": net_s,
          "rel_diff_raw": abs(trace_s - event_s) / max(event_s, 1e-12),
          "rel_diff": abs(trace_s - net_s) / max(net_s, 1e-12),
          "top_ops": [{"op": t["op"][:80], "total_s": t["total_s"],
                       "count": t["count"]} for t in att["top_ops"][:5]]})
    check(trace_n == len(spans) == WINDOW_ROUNDS
          and windows["plain"][2] == WINDOW_ROUNDS,
          "a trace window does not hold one B2 slice per round")
    check(net_s > 0 and abs(trace_s - net_s) <= WINDOW_RTOL * net_s,
          "the trace's B2 device time is not within 10% of CUDA events "
          "(less the empty event pairs)")
    return b2


# ---------------------------------------------------------------------------
# The multi-process TCP deployment on the card
# ---------------------------------------------------------------------------

#: The chaos arm's round deadline (the fault-free arm, which is also the
#: lockstep arm with telemetry, runs under it too), and the async arm's
#: rounds at 50 Hz (about 5 s).
TCP_CHAOS_TIMEOUT, TCP_ASYNC_ROUNDS = 0.5, 250


def tcp_launch(data: str, out_dir: Path, *flags) -> tuple[dict, dict, float]:
    """One run of the port's TCP launcher with eight robot processes on the
    card: (its result line, each robot's npz, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "dpgo_tpu_torch.examples.tcp_deployment_example", data,
         "--robots", str(ROBOTS), "--rank", str(RANK), "--device", "cuda",
         "--out-dir", str(out_dir), *flags],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, "the TCP launcher failed:\n"
          + proc.stderr[-4000:])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    outs = {}
    for r in range(ROBOTS):
        p = out_dir / f"robot{r}.npz"
        if p.exists():
            outs[r] = dict(np.load(p))
    return res, outs, dt


def robot_counts(outs: dict) -> dict:
    """The robots' launch, step and read counts and step times."""
    reads: dict = {}
    for o in outs.values():
        for k, v in json.loads(str(o["host_reads"])).items():
            reads[k] = reads.get(k, 0) + v
    return {"b2_launches": {r: int(o["b2_launches"]) for r, o in outs.items()},
            "stepped": {r: int(o["stepped"]) for r, o in outs.items()},
            "iterates": {r: int(o["iterates"]) for r, o in outs.items()},
            "host_reads": reads,
            "step_device_s": sum(float(o["step_device_s"])
                                 for o in outs.values()),
            "solve_wall_s": max(float(o["solve_wall_s"])
                                for o in outs.values())}


def consensus_round(tdir: Path) -> int | None:
    """The first round at which every robot's ``agent_iterate`` event says
    ready, from the robots' telemetry streams."""
    from dpgo_tpu_torch import obs

    ready: dict = {}
    for r in range(ROBOTS):
        for e in obs.read_events(str(tdir / f"robot{r}" / "events.jsonl")):
            if e.get("event") == "agent_iterate":
                ready.setdefault(e["iteration"], {})[r] = e["ready"]
    for it in sorted(ready):
        if len(ready[it]) == ROBOTS and all(ready[it].values()):
            return it
    return None


def tcp_phase(meas, prod_cost: float, card: str, tmp: Path) -> int:
    """``python -m dpgo_tpu_torch.examples.tcp_deployment_example`` with
    eight robot processes on the card over localhost TCP, each iterate one
    B2 launch at A=1: a fault-free lockstep arm with telemetry (team cost
    against the production arm's, launches against stepped iterates, the
    merged fleet timeline) that is also the reference of a chaos arm
    (robot 7 killed at round 40), and the async loop at 50 Hz with
    staleness 1.  Returns B2's launches in the robot processes."""
    from dpgo_tpu_torch.examples import tcp_deployment_example as tcp
    from dpgo_tpu_torch.obs import timeline

    t_phase = time.perf_counter()
    data = str(tmp / "standin.g2o")
    g2o.write_g2o(meas, data)
    b2 = 0

    def launches_ok(outs, arm):
        c = robot_counts(outs)
        check(all(c["b2_launches"][r] == c["stepped"][r] > 0 for r in outs),
              f"a robot process of the {arm} arm did not launch B2 once "
              "per stepped iterate")
        return c

    # -- lockstep with telemetry: the fault-free arm ---------------------------
    survivors = [r for r in range(ROBOTS) if r != CHAOS_KILL[0]]
    common = ["--rounds", str(CHAOS_ROUNDS), "--round-timeout",
              str(TCP_CHAOS_TIMEOUT)]
    res, outs, dt = tcp_launch(data, tmp / "lockstep", *common,
                               "--telemetry")
    c = launches_ok(outs, "lockstep")
    b2 += sum(c["b2_launches"].values())
    trace_path = tmp / "lockstep" / "trace.json"
    counts = timeline.validate_chrome_trace(str(trace_path))
    cons = consensus_round(tmp / "lockstep" / "telemetry")
    emit({"phase": "tcp", "check": "lockstep", "card": card,
          "robots": ROBOTS, "rounds": CHAOS_ROUNDS, "seconds": dt,
          "consensus_round": cons, "team_cost": res["cost"],
          "production_arm_cost": prod_cost,
          "team_cost_ratio": res["cost"] / prod_cost,
          "states": res["states"], "iterations": res["iterations"],
          "bytes_sent": res["bytes_sent"], "timeline": counts,
          "device_busy_share": c["step_device_s"] / c["solve_wall_s"], **c})
    check(res["states"] == [2] * ROBOTS and res["lost"] == [],
          "a lockstep robot did not finish initialized")
    check(cons is not None, "the lockstep team did not reach consensus")
    check(res["cost"] <= (1 + TEAM_COST_RTOL) * prod_cost,
          "the TCP team's cost is above 1.01 x the production arm's")
    check(counts["spans"] > 0 and counts["flows"] > 0,
          "the merged fleet timeline has no spans or no flow edges")
    arms = {"fault_free": {"result": res, "seconds": dt,
                           "survivor_cost": tcp.survivor_cost(
                               data, ROBOTS, {r: outs[r] for r in survivors
                                              if r in outs}), **c}}

    # -- chaos ----------------------------------------------------------------
    chaos_flags = ["--fault-drop", "0.10", "--fault-delay", "0.25",
                   "--fault-delay-s", str(CHAOS_PACE), str(3 * CHAOS_PACE),
                   "--fault-reorder", "0.05", "--fault-seed", "7",
                   "--kill-robot", str(CHAOS_KILL[0]),
                   "--kill-round", str(CHAOS_KILL[1])]
    res, outs, dt = tcp_launch(data, tmp / "chaos", *common, *chaos_flags)
    c = launches_ok(outs, "chaos")
    b2 += sum(c["b2_launches"].values())
    arms["chaos"] = {"result": res, "seconds": dt,
                     "survivor_cost": tcp.survivor_cost(
                         data, ROBOTS, {r: outs[r] for r in survivors
                                        if r in outs}), **c}
    rel = abs(arms["chaos"]["survivor_cost"]
              - arms["fault_free"]["survivor_cost"]) \
        / arms["fault_free"]["survivor_cost"]
    emit({"phase": "tcp", "check": "chaos", "card": card,
          "rounds": CHAOS_ROUNDS, "kill": list(CHAOS_KILL),
          "round_timeout_s": TCP_CHAOS_TIMEOUT, "rel_diff": rel, **arms})
    check(arms["chaos"]["result"]["lost"] == [CHAOS_KILL[0]],
          "the chaos arm did not lose exactly the killed robot")
    check(arms["fault_free"]["result"]["lost"] == [],
          "the fault-free arm lost a robot")
    check(rel <= CHAOS_RTOL, "the chaos arm's survivors left the "
          "fault-free cost by more than 1%")

    # -- async ----------------------------------------------------------------
    res, outs, dt = tcp_launch(data, tmp / "async", "--mode", "async",
                               "--async-rate", str(ASYNC_HZ),
                               "--staleness", "1", "--rounds",
                               str(TCP_ASYNC_ROUNDS))
    c = launches_ok(outs, "async")
    b2 += sum(c["b2_launches"].values())
    its = [c["iterates"][r] / float(outs[r]["solve_wall_s"])
           for r in sorted(outs)]
    emit({"phase": "tcp", "check": "async", "card": card,
          "rate_hz": ASYNC_HZ, "staleness": 1, "seconds": dt,
          "states": res["states"], "lost": res["lost"],
          "iterates_per_robot": [c["iterates"][r] for r in sorted(outs)],
          "iterates_per_s_per_robot": its,
          "team_cost": res["cost"],
          "device_busy_share": c["step_device_s"] / c["solve_wall_s"], **c})
    check(res["lost"] == [] and len(outs) == ROBOTS,
          "an async robot process did not finish")
    emit({"phase": "tcp", "check": "time", "seconds":
          time.perf_counter() - t_phase})
    return b2


# ---------------------------------------------------------------------------
# The serving plane: bucketing, the batched runner, the server, TCP,
# streaming
# ---------------------------------------------------------------------------

def serve_requests() -> list:
    """The serve phase's requests: the stand-in at SERVE_SIZES poses (loop
    closures n - 51, as the stand-in) and SERVE_SEEDS, as ((n, seed),
    measurements)."""
    return [((n, seed), make_measurements(
        np.random.default_rng(seed), n=n, d=3, num_lc=n - 51,
        rot_noise=0.01, trans_noise=0.01)[0])
        for n in SERVE_SIZES for seed in SERVE_SEEDS]


@contextlib.contextmanager
def host_syncs():
    """Record the host syncs of a block: the warnings of the sync-warn
    debug mode (count them with ``count_syncs``)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            yield syncs
    finally:
        torch.cuda.set_sync_debug_mode("default")


def count_syncs(syncs) -> int:
    return sum("synchroniz" in str(w.message) for w in syncs)


def serve_prepare(reqs, params, dev, card: str) -> list:
    """Each request prepared on the card and padded to its own bucket
    (``SERVE_QUANTUM``), as the server does: its bucket, prepare ms and
    the host syncs of the chordal init on the padded problem."""
    from dpgo_tpu_torch.serve import bucket_shape_of, pad_problem

    real_init, init_syncs = rbcd.lifted_init, {}
    out = []
    for key, meas in reqs:
        with host_syncs() as syncs:
            def counted_init(*a, **k):
                n0 = len(syncs)
                X0 = real_init(*a, **k)
                init_syncs[key] = count_syncs(syncs[n0:])
                return X0

            rbcd.lifted_init = counted_init
            try:
                t0 = time.perf_counter()
                prob = rbcd.prepare_problem(meas, ROBOTS, params, init=None,
                                            device=dev)
                shape = bucket_shape_of(prob, SERVE_QUANTUM)
                padded = pad_problem(prob, shape)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                rbcd.lifted_init = real_init
        n_sync = count_syncs(syncs)
        out.append(padded)
        emit({"phase": "serve", "check": "prepare", "card": card,
              "poses": key[0], "seed": key[1], "bucket": list(shape),
              "n_max": prob.meta.n_max, "e_max": prob.meta.e_max,
              "s_max": prob.meta.s_max, "prepare_ms": ms,
              "prepare_host_syncs": n_sync,
              "chordal_init_host_syncs": init_syncs[key]})
    return out


def unpadded(p, params):
    """A padded member's own problem at its own shape, from the padded
    member's initial iterate."""
    return rbcd.PreparedProblem(part=p.prob.part, graph=p.prob.graph,
                                meta=p.prob.meta, params=params,
                                dtype=p.prob.dtype,
                                X0=p.X0[:, :p.prob.meta.n_max].contiguous())


def b2_once(X, graph, meta, params):
    """One B2 launch at ``X`` on ``graph`` (factors as ``init_state``
    makes them), as the round calls it."""
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    chol = rbcd.precond_chol(graph.edges, graph, params)
    out = rk.rtr_full(*rbcd.kernel_operands(X, Z, graph.edges, chol, graph),
                      **rbcd.kernel_options(params, meta))
    return rk.comp_minor(out.X, meta.rank, meta.d + 1)


def padded_member_parity(batch, params, card: str) -> None:
    """B2 on each padded member against B2 on its unpadded problem, from
    the same start, one launch each: equal on the live rows (X_ATOL), the
    padded rows left as they were."""
    errs, untouched = [], []
    for p in batch:
        u = unpadded(p, params)
        n = u.meta.n_max
        X = b2_once(u.X0, u.graph, u.meta, params)
        Xp = b2_once(p.X0, p.graph, p.meta, params)
        live = u.graph.pose_mask > 0
        errs.append(float((X[live] - Xp[:, :n][live]).abs().max()))
        untouched.append(bool(torch.equal(Xp[:, n:], p.X0[:, n:].float())))
    emit({"phase": "parity", "kernel": "rtr_full", "where": "serve padded "
          "members vs their unpadded problems", "card": card,
          "n_max": [[unpadded(p, params).meta.n_max, p.meta.n_max]
                    for p in batch],
          "max_abs_dX_live": errs, "padded_rows_untouched": untouched})
    check(max(errs) <= X_ATOL and all(untouched),
          "B2 on a padded member leaves its unpadded problem's result")


@contextlib.contextmanager
def served(by: collections.Counter):
    """Tally the B2 launches of a block of the serving path into ``by``,
    keyed by agents per launch: the increments of the wrapper's own count
    across each call."""
    real = rk.rtr_full

    def tally(*a, **kw):
        n0 = rk.LAUNCHES
        out = real(*a, **kw)
        by[int(a[0].shape[0])] += rk.LAUNCHES - n0
        return out

    rk.rtr_full = tally
    try:
        yield by
    finally:
        rk.rtr_full = real


def step_parity(p, params, plain) -> dict:
    """B2 at each of the "ell" formulation's ten JACOBI iterates from the
    member's start against its plain version on the same operands, held
    by ``kernel_parity``'s floor rule (``flip_rule``): X (X_ATOL) and f
    (STAT_RTOL) on every agent whose attempts and accepted agree, f0
    (STAT_RTOL) on all, every flipped decision within FLOOR_DF_RTOL of
    f0.  Returns the worst of each over the ten rounds."""
    kw = rbcd.kernel_options(params, p.meta)
    chol = rbcd.precond_chol(p.graph.edges, p.graph, params)
    st = rbcd.init_state(p.graph, p.meta, p.X0, plain)
    worst = {"max_abs_dX_agreeing": 0.0, "max_rel_d_f_agreeing": 0.0,
             "max_rel_d_f0": 0.0, "flipped_rel_df": 0.0, "stat_flips": 0}
    for _ in range(10):
        Z = rbcd.neighbor_buffer(rbcd.public_table(st.X, p.graph), p.graph)
        ops = rbcd.kernel_operands(st.X, Z, p.graph.edges, chol, p.graph)
        row = flip_rule(rk.rtr_full(*ops, **kw),
                        rk.rtr_full_reference(*ops, **kw))
        flipped = row["flipped_rel_df"]
        row.update(flipped_rel_df=max(flipped, default=0.0),
                   stat_flips=worst["stat_flips"] + len(flipped))
        del row["agents_agreeing"]
        worst = {k: max(worst[k], row[k]) for k in worst}
        st = rbcd.rbcd_step(st, p.graph, p.meta, plain)
    worst["ok"] = (worst["max_abs_dX_agreeing"] <= X_ATOL
                   and worst["max_rel_d_f_agreeing"] <= STAT_RTOL
                   and worst["max_rel_d_f0"] <= STAT_RTOL
                   and worst["flipped_rel_df"] <= FLOOR_DF_RTOL)
    return worst


def counted_fetches():
    """Count ``rbcd._host_fetch`` calls: (counter list, restore)."""
    real, calls = rbcd._host_fetch, []

    def fetch(x):
        calls.append(1)
        return real(x)

    rbcd._host_fetch = fetch

    def restore():
        rbcd._host_fetch = real
    return calls, restore


def serve_batch(batch, params, card: str, by) -> tuple:
    """``run_bucket`` over all eight requests padded to one shape (B = 8,
    A = 64 agents per B2 launch), SERVE_ROUNDS rounds each at most
    (``rel_change_tol`` 0, SERVE_GTOL): per-eval and verdict (K = SERVE_K)
    runs, each member's final cost against its own sequential
    ``dispatch_prepared``, the 10-round trajectory rule per member, and B2
    timed at A = 64.  ``run_bucket``'s launches are tallied into ``by``
    (``served``); the sequential solves, the reference replays and the
    timing are not.  Returns (the per-eval results, the timing row)."""
    from types import SimpleNamespace

    from dpgo_tpu_torch.serve import ExecutableCache, run_bucket, runner

    meta, shape = batch[0].meta, batch[0].shape
    A = meta.num_robots
    cache = ExecutableCache()
    with served(by):
        run_bucket(batch, cache, max_iters=2, grad_norm_tol=SERVE_GTOL)
    runs = {}
    for ve in (None, SERVE_K):
        calls, restore = counted_fetches()
        rk.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with served(by):
                res, info = run_bucket(batch, cache, max_iters=SERVE_ROUNDS,
                                       grad_norm_tol=SERVE_GTOL,
                                       eval_every=1, verdict_every=ve)
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rk.LAUNCHES
        words = -(-info["rounds"] // SERVE_K) if ve else info["evals"]
        runs[ve] = (res, info, wall)
        emit({"phase": "serve", "check": "run_bucket", "card": card,
              "verdict_every": ve, "batch": info["batch"],
              "agents_per_launch": info["batch"] * A,
              "rounds": info["rounds"], "evals": info["evals"],
              "b2_launches": launches, "host_fetches": len(calls),
              "seconds": wall, "rounds_per_s": info["rounds"] / wall,
              "requests_per_s": len(batch) / wall,
              "iterations": [r.iterations for r in res],
              "terminated_by": [r.terminated_by for r in res],
              "cost_final": [r.cost_history[-1] for r in res]})
        check(launches == info["rounds"],
              "the batch did not launch B2 once per round for all members")
        check(len(calls) == words + 1, "the batch's host fetches are not "
              "one per eval (or word) plus the terminal fetch")
    for a, b in zip(runs[None][0], runs[SERVE_K][0]):
        check(a.cost_history == b.cost_history
              and a.grad_norm_history == b.grad_norm_history
              and (a.iterations, a.terminated_by)
              == (b.iterations, b.terminated_by),
              "the verdict batch differs from the per-eval batch")

    # Each member against its own sequential solve on the card.
    seq, seq_wall, rel = [], 0.0, []
    for p, r in zip(batch, runs[None][0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = rbcd.dispatch_prepared(unpadded(p, params),
                                   max_iters=SERVE_ROUNDS,
                                   grad_norm_tol=SERVE_GTOL)
        torch.cuda.synchronize()
        seq_wall += time.perf_counter() - t0
        seq.append(s)
        rel.append(abs(r.cost_history[-1] - s.cost_history[-1])
                   / abs(s.cost_history[-1]))
    seq_rounds = sum(s.iterations for s in seq)
    wall = runs[None][2]

    # Ten rounds of the batch against each member's own.  The batch's rows
    # equal each member's padded problem alone bit for bit (one shape), so
    # each padded problem is held to the main phase's rule against "ell"
    # on that same problem: at most TRAJ_SPREAD times ell's own divergence
    # from starts moved by one ulp, capped at TRAJ_MAX.  Where ell itself
    # leaves TRAJ_MAX from a start moved by one ulp, it fails that rule
    # against itself, and ten rounds cannot tell B2's error from float32's;
    # every member is also held round by round (``step_parity``), and
    # those members by that alone.  The unpadded problem's own ten rounds
    # (a plan at n_max 305-316 against 320) are a record.
    st_b = runner.stack_states([rbcd.init_state(p.graph, meta, p.X0,
                                                params) for p in batch])
    g_b = runner.stack_graphs([p.graph for p in batch], meta,
                              shape.n_total, shape.num_meas)
    X10 = rbcd.rbcd_steps(st_b, g_b, 10, meta, params).X
    plain = dataclasses.replace(
        params, solver=dataclasses.replace(params.solver, pallas_tcg=False))
    alone, gaps, spreads, limits, ruled, steps, unpad = ([] for _ in range(7))
    for b, p in enumerate(batch):
        rows = slice(b * A, (b + 1) * A)
        live = p.graph.pose_mask > 0
        own = rounds_from(p.X0, p.graph, meta, params)
        alone.append(float((X10[rows] - own).abs().max()))
        ell = rounds_from(p.X0, p.graph, meta, plain)
        gaps.append(float((own - ell)[live].abs().max()))
        spread = 0.0
        for seed in range(PERTURBED_STARTS):
            gen = torch.Generator(device=p.X0.device).manual_seed(seed)
            step = torch.randint(-1, 2, p.X0.shape, generator=gen,
                                 device=p.X0.device)
            X0m = p.X0 * (1 + step * 2.0 ** -23)
            spread = max(spread, float(
                (rounds_from(X0m, p.graph, meta, plain) - ell)[live]
                .abs().max()))
        spreads.append(spread)
        limits.append(min(TRAJ_SPREAD * spread, TRAJ_MAX))
        ruled.append(spread <= TRAJ_MAX)
        steps.append(step_parity(p, params, plain))
        u = unpadded(p, params)
        ulive = u.graph.pose_mask > 0
        unpad.append(float((X10[rows, :u.meta.n_max][ulive] - rounds_from(
            u.X0, u.graph, u.meta, params)[ulive]).abs().max()))
    emit({"phase": "serve", "check": "batch_vs_sequential", "card": card,
          "final_cost_rel_err": rel,
          "traj_10_vs_padded_alone_max_abs_dX": alone,
          "traj_10_kernel_vs_ell_max_abs_dX": gaps,
          "ell_ulp_moved_starts_max_abs_dX": spreads,
          "traj_limits": limits, "ell_within_cap": ruled,
          "within_traj_rule": [g <= lim for g, lim in zip(gaps, limits)],
          "per_round_parity": steps,
          "record_traj_10_vs_unpadded_max_abs_dX": unpad,
          "batch_seconds": wall,
          "sequential_seconds": seq_wall,
          "batch_rounds_per_s": runs[None][1]["rounds"] / wall,
          "sequential_rounds_per_s": seq_rounds / seq_wall,
          "batch_requests_per_s": len(batch) / wall,
          "sequential_requests_per_s": len(batch) / seq_wall,
          "sequential_iterations": [s.iterations for s in seq]})
    check(max(rel) <= SERVE_COST_RTOL, "a batch member's final cost leaves "
          "its sequential solve's by more than 1e-5")
    check(max(alone) == 0.0, "a batch member's 10 rounds differ from its "
          "padded problem's own")
    check(all(g <= lim for g, lim, r in zip(gaps, limits, ruled) if r),
          "a batch member's 10 rounds leave the plain formulation's by more "
          "than its own one-ulp divergence allows")
    check(all(st["ok"] for st in steps), "B2 at a batch member's ten "
          "reference iterates disagrees with its plain version")

    # B2 at A = 64: the batch's operands at the batch start.
    ops, _ = operand_sets(SimpleNamespace(graph=g_b, meta=meta), params,
                          st_b.X)
    kw = rbcd.kernel_options(params, meta)
    out = rk.rtr_full(*ops.values(), **kw)
    ref = rk.rtr_full_reference(*ops.values(), **kw)
    torch.cuda.synchronize()
    err = float((out.X - ref.X).abs().max())
    timing = route_timing(rk.rtr_full, ops, kw, out)
    nbytes, flops = rtr_full_work(ops, out, g_b, meta)
    b_ms, b_by = bound(nbytes, flops)
    row = {"phase": "timing", "card": card, "kernel": "rtr_full",
           "agents": len(batch) * A, "n_max": meta.n_max,
           "e_max": meta.e_max, "max_abs_err": err, **timing,
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    check(err <= X_ATOL, "B2 at A = 64 disagrees with its plain version")
    return runs[None][0], row


def serve_server(reqs, batch_res, params, dev, card: str, tmp: Path,
                 by) -> None:
    """``SolveServer`` in process with a telemetry run: a warm pool, then
    SERVE_TENANT_COPIES copies of two stand-in requests from each of two
    tenants submitted from threads (``max_batch`` 8): every ticket equal to
    its batch twins bit for bit and within SERVE_COST_RTOL of its
    ``run_bucket`` member, every real batch a cache hit, ``serve_request``
    events and a ``/metrics`` scrape.  The warm pool's and the batches'
    launches are tallied into ``by`` (``served``)."""
    import urllib.request

    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.serve import SolveRequest, SolveServer

    picks = list(range(len(SERVE_SEEDS)))  # the full-size stand-ins
    per = SERVE_TENANT_COPIES

    def requests(tenant):
        return [SolveRequest(meas=reqs[i][1], num_robots=ROBOTS,
                             params=params, tenant=tenant,
                             max_iters=SERVE_ROUNDS,
                             grad_norm_tol=SERVE_GTOL)
                for i in picks for _ in range(per)]

    run_dir = tmp / "serve_run"
    with obs.run_scope(str(run_dir)), served(by):
        with SolveServer(max_batch=8, quantum=SERVE_QUANTUM,
                         batch_window_s=0.5, metrics_port=0,
                         device=dev) as srv:
            t0 = time.perf_counter()
            warmed = srv.warm(requests("t0") + requests("t1"))
            warm_s = time.perf_counter() - t0
            built = srv.cache.compiles
            tickets = {}
            gate = threading.Barrier(2)

            def submit(tenant):
                gate.wait()
                tickets[tenant] = [srv.submit(r) for r in requests(tenant)]

            t0 = time.perf_counter()
            threads = [threading.Thread(target=submit, args=(t,))
                       for t in ("t0", "t1")]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            results = {t: [k.result(timeout=600) for k in ts]
                       for t, ts in tickets.items()}
            serve_s = time.perf_counter() - t0
            status = srv.status()
            base = f"http://{srv.sidecar.host}:{srv.sidecar.port}"
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                prom = r.read().decode("utf-8")
    events = obs.read_events(str(run_dir / "events.jsonl"))
    requested = [e for e in events if e.get("event") == "serve_request"]
    batches = [e for e in events if e.get("event") == "serve_batch"]
    rel, twins = [], True
    for i in picks:
        group = [results[t][j] for t in ("t0", "t1")
                 for j in range(i * per, (i + 1) * per)]
        twins &= all(g.cost_history == group[0].cost_history
                     and torch.equal(g.T, group[0].T) for g in group)
        ref = batch_res[i].cost_history[-1]
        rel += [abs(g.cost_history[-1] - ref) / abs(ref) for g in group]
    emit({"phase": "serve", "check": "server", "card": card,
          "requests": 2 * len(picks) * per, "buckets_warmed": warmed,
          "warm_s": warm_s, "serve_s": serve_s,
          "requests_per_s": 2 * len(picks) * per / serve_s,
          "batches": [{"size": e["size"], "batch": e["batch"],
                       "rounds": e["rounds"]} for e in batches],
          "cache": status["cache"], "cache_builds_after_warm":
          status["cache"]["compiles"] - built,
          "serve_request_events": len(requested),
          "metrics_bytes": len(prom), "twins_bitwise_equal": twins,
          "cost_rel_to_run_bucket_member": rel})
    check(twins, "copies of one request in one batch differ")
    check(max(rel) <= SERVE_COST_RTOL, "a served ticket leaves its "
          "run_bucket member's cost by more than 1e-5")
    check(status["cache"]["compiles"] == built,
          "a real batch missed the warm pool's programs")
    check(len(requested) == 2 * len(picks) * per,
          "not every request emitted a serve_request event")
    check("serve_requests_total" in prom
          and "serve_cache_requests_total" in prom,
          "the /metrics scrape lacks the serving counters")


def serve_tcp(meas, dev, card: str, tmp: Path, by) -> None:
    """``python -m dpgo_tpu_torch.serve --port 0`` as a process on the
    card, and ``solve_g2o`` of the stand-in written as g2o: its cost
    equals the in-process front-end's on the same bytes (1e-6).  The
    in-process front-end's launches are tallied into ``by``."""
    from dpgo_tpu_torch.serve import SolveServer
    from dpgo_tpu_torch.serve.frontend import handle_request, solve_g2o

    path = tmp / "serve_standin.g2o"
    g2o.write_g2o(meas, str(path))
    raw = path.read_bytes()
    kw = dict(num_robots=ROBOTS, max_iters=SERVE_ROUNDS,
              grad_norm_tol=GRAD_TOL, eval_every=1)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpgo_tpu_torch.serve", "--port", "0",
         "--device", dev.type],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        check(line.startswith("listening on "),
              f"the serve process did not listen: {line!r}")
        host, port = line.split()[-1].rsplit(":", 1)
        out = solve_g2o(host, int(port), raw, timeout=600, **kw)
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        stderr = proc.stderr.read()
        proc.stderr.close()
    tcp_s = time.perf_counter() - t0
    check(out["ok"], f"the TCP solve failed: {out}\n{stderr[-3000:]}")
    frame = {"op": np.frombuffer(b"solve", np.uint8),
             "g2o": np.frombuffer(raw, np.uint8),
             "num_robots": np.int32(ROBOTS),
             "max_iters": np.int32(SERVE_ROUNDS),
             "grad_norm_tol": np.float64(GRAD_TOL),
             "eval_every": np.int32(1)}
    rk.LAUNCHES = 0
    with served(by), SolveServer(max_batch=8, batch_window_s=0.0,
                                 device=dev) as srv:
        reply = handle_request(srv, frame)
    launches = rk.LAUNCHES
    check(int(reply["ok"]) == 1, "the in-process front-end failed")
    a = float(out["cost_history"][-1])
    b = float(np.asarray(reply["cost_history"])[-1])
    rel = abs(a - b) / abs(b)
    emit({"phase": "serve", "check": "tcp", "card": card, "seconds": tcp_s,
          "iterations": out["iterations"],
          "terminated_by": out["terminated_by"], "cost_tcp": a,
          "cost_in_process": b, "rel_diff": rel,
          "in_process_b2_launches": launches, "returncode": proc.returncode})
    check(out["T"].shape == (N_POSES, 3, 4) and np.isfinite(out["T"]).all(),
          "the TCP reply's trajectory is malformed")
    check(rel <= TCP_COST_RTOL, "the TCP solve's cost leaves the "
          "in-process one's by more than 1e-6")


def serve_streaming(params, dev, card: str, by) -> None:
    """bench_streaming.py's protocol on the stand-in (+5% of the
    measurements streamed as the newest loop closures): ``apply_edges``
    takes the delta path, the delta-applied tiles equal a fresh pad
    bitwise, the warm arm reaches the cold arm's cost (1e-5) with B2
    launches equal to its rounds enqueued, and the warm/cold wall ratio
    (a record).  The warm dispatch's launches are tallied into ``by``; the
    base solve and the cold arm are the protocol's references."""
    import dataclasses

    from dpgo_tpu_torch.models.incremental import LiveProblem
    from dpgo_tpu_torch.serve import pad_problem
    from dpgo_tpu_torch.types import loop_closure_mask

    meas = make_measurements(np.random.default_rng(0), n=N_POSES, d=3,
                             num_lc=NUM_LC, rot_noise=0.01,
                             trans_noise=0.01)[0]
    lc = np.nonzero(loop_closure_mask(meas))[0]
    n_extra = max(1, int(round(STREAM_FRAC * len(meas))))
    keep = np.ones(len(meas), bool)
    keep[lc[-n_extra:]] = False
    base = dataclasses.replace(meas.select(keep), num_poses=meas.num_poses)
    extra = dataclasses.replace(meas.select(~keep), num_poses=meas.num_poses)
    sp = dataclasses.replace(params, rel_change_tol=0.0)
    kw = dict(max_iters=STREAM_ITERS, grad_norm_tol=STREAM_GTOL,
              eval_every=2)
    # Room for the stream: one quantum more than the streamed rows (the
    # default of one quantum fits bench_streaming.py's three edges, not
    # 247).
    headroom = -(-len(extra) // SERVE_QUANTUM) + 1
    live = LiveProblem(base, ROBOTS, params=sp, headroom=headroom,
                       device=dev)
    res0 = live.solve(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = rbcd.solve_rbcd(meas, ROBOTS, sp, device=dev, **kw)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    rk.LAUNCHES = 0
    t0 = time.perf_counter()
    with served(by):
        warm = live.warm_dispatch(res0, new_edges=extra, **kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_b2 = rk.LAUNCHES
    mode = live.last_delta.mode
    fresh = pad_problem(rbcd.prepare_problem(live.meas, ROBOTS, sp,
                                             init=None, device=dev),
                        live.shape)
    tiles = all(torch.equal(getattr(live.padded.graph, f),
                            getattr(fresh.graph, f))
                for f in ("eidx_i", "eidx_j", "rot_t", "trn_t"))
    rel = abs(warm.cost_history[-1] - cold.cost_history[-1]) \
        / abs(cold.cost_history[-1])
    enq = rbcd.rounds_enqueued(warm.iterations, max_iters=STREAM_ITERS,
                               eval_every=2, params=sp)
    emit({"phase": "serve", "check": "streaming", "card": card,
          "edges_base": len(base), "edges_streamed": len(extra),
          "headroom_quanta": headroom, "mode": mode,
          "bucket": list(live.shape),
          "tiles_equal_fresh_pad": tiles, "rounds_base": res0.iterations,
          "rounds_cold": cold.iterations, "rounds_warm": warm.iterations,
          "cost_cold": cold.cost_history[-1],
          "cost_warm": warm.cost_history[-1], "rel_diff": rel,
          "t_cold_s": t_cold, "t_warm_s": t_warm,
          "warm_cold_wall_ratio": t_warm / t_cold,
          "warm_b2_launches": warm_b2, "warm_rounds_enqueued": enq})
    check(mode == "delta", "the streamed edges did not take the delta path")
    check(tiles, "the delta-applied tiles differ from a fresh pad")
    check(rel <= STREAM_COST_RTOL, "the warm arm's cost leaves the cold "
          "arm's by more than 1e-5")
    check(warm_b2 == enq, "the warm arm did not launch B2 once per round")


def _same_solve(a, b) -> bool:
    """Histories, iterations, reason and trajectory bit for bit."""
    return (a.cost_history == b.cost_history
            and a.grad_norm_history == b.grad_norm_history
            and (a.iterations, a.terminated_by)
            == (b.iterations, b.terminated_by)
            and torch.equal(a.T.cpu(), b.T.cpu()))


def sharded_standin(meas, mesh, dev, card: str, tmp: Path):
    """The stand-in through ``solve_rbcd_sharded`` at world size 1, per
    eval and with the verdict loop (K = SHARD_K), with every exchange and
    overlap mode, against ``rbcd.solve_rbcd`` bit for bit, B2 launches =
    ``rounds_enqueued``; then the verdict loop's host syncs per 100 rounds
    and one K-round window of the sharded programs under the sync-error
    mode.  Returns (B2 launches, the verdict solve's result, the
    problem)."""
    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.obs.events import read_events
    from dpgo_tpu_torch.parallel import sharded

    b2 = 0
    # No consensus stop: the runs go on until the gradient gate latches
    # (or SHARD_ROUNDS).
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0)
    kw = dict(max_iters=SHARD_ROUNDS, grad_norm_tol=GRAD_TOL)
    rows, verdict_res = [], None
    for K in (None, SHARD_K):
        ref = rbcd.solve_rbcd(meas, ROBOTS, params, device=dev,
                              verdict_every=K, **kw)
        for extra in ({}, {"exchange": "ppermute"}, {"overlap": False},
                      {"overlap": True}, {"overlap": "auto"}):
            run_dir = tmp / f"sharded_auto_{K}"
            scope = obs.run_scope(str(run_dir)) if extra.get(
                "overlap") == "auto" else contextlib.nullcontext()
            torch.cuda.synchronize()
            rk.LAUNCHES = 0
            with scope:
                got = sharded.solve_rbcd_sharded(
                    meas, ROBOTS, mesh=mesh, params=params, verdict_every=K,
                    **kw, **extra)
            torch.cuda.synchronize()
            launches = rk.LAUNCHES
            b2 += launches
            enq = rbcd.rounds_enqueued(got.iterations, params=params,
                                       max_iters=SHARD_ROUNDS, eval_every=1,
                                       verdict_every=K)
            row = {"verdict_every": K, **extra, "iterations": got.iterations,
                   "terminated_by": got.terminated_by,
                   "bitwise": _same_solve(got, ref), "b2_launches": launches,
                   "rounds_enqueued": enq}
            if extra.get("overlap") == "auto":
                (dec,) = [e for e in read_events(str(run_dir / "events.jsonl"))
                          if e.get("event") == "overlap_decision"]
                row["overlap_decision"] = dec.get("reason")
                check(dec.get("reason") == "single_device_mesh",
                      "overlap='auto' did not record single_device_mesh")
            rows.append(row)
            check(row["bitwise"], f"solve_rbcd_sharded({extra}, K={K}) is "
                  "not solve_rbcd bit for bit at world size 1")
            check(launches == enq, "a sharded solve did not launch B2 once "
                  "per enqueued round")
            if K is not None and not extra:
                verdict_res = got

    # Host syncs per 100 rounds of the sharded verdict loop: words only.
    fetches = [0]
    orig = rbcd._host_fetch

    def counting(x):
        fetches[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    try:
        rk.LAUNCHES = 0
        full = sharded.solve_rbcd_sharded(
            meas, ROBOTS, mesh=mesh, params=AgentParams(
                d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0),
            max_iters=SHARD_ROUNDS, grad_norm_tol=0.0,
            verdict_every=SHARD_K)
        torch.cuda.synchronize()
        b2 += rk.LAUNCHES
    finally:
        rbcd._host_fetch = orig
    syncs = 100.0 * (fetches[0] - 1) / full.iterations
    check(full.iterations == SHARD_ROUNDS
          and syncs == 100.0 / SHARD_K,
          f"the sharded verdict loop's host syncs per 100 rounds are not "
          f"100/K ({fetches[0]} fetches in {full.iterations} rounds)")

    # One K-round window of the sharded segment and verdict program with
    # every host sync an error.
    prob = rbcd.prepare_problem(meas, ROBOTS, params, device=dev)
    part = prob.part
    st, g = sharded.shard_problem(mesh, rbcd.init_state(
        prob.graph, prob.meta, prob.X0, params), prob.graph)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float32, device=dev)
    n, M = part.meas_global.num_poses, len(part.meas_global)
    seg = sharded.make_sharded_segment(mesh, prob.meta, params)
    step = rbcd.make_verdict_program(
        g, edges_g, n, M, False, grad_norm_tol=GRAD_TOL,
        metrics_body=sharded.make_sharded_metrics_body(mesh, g, edges_g, n,
                                                       M, False))
    vs = rbcd.init_verdict_state(SHARD_K, ROBOTS, torch.float32, False,
                                 device=dev)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SHARD_K):
            st = seg(st, g, 1)
            vs = step(st.X, st.weights, st.ready, st.mu, st.rel_change,
                      st.iteration, vs)
        copy = rbcd._start_fetch(vs.word)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    word = int(rbcd._host_fetch(copy))
    torch.cuda.synchronize()
    b2 += rk.LAUNCHES
    check(rk.LAUNCHES == SHARD_K and word == int(vs.word),
          "the sharded sync-free window is malformed")
    emit({"phase": "sharded", "check": "standin", "card": card,
          "b2_launches": b2, "world_size": mesh.size, "backend": str(
              torch.distributed.get_backend()), "runs": rows,
          "verdict_host_syncs_per_100_rounds": syncs,
          "sync_free_window": {"rounds": SHARD_K,
                               "word": rbcd.unpack_verdict(word)}})
    return b2, verdict_res, prob


def sharded_tail_and_certificate(meas, params, prob, res, mesh, dev,
                                 card: str) -> int:
    """``gn_tail_sharded`` (SHARD_TAIL_OUTER outer steps, two host reads
    each and the final gate) from the iterate after SHARD_TAIL_ROUNDS
    rounds, beside the host float64 ``refine.gn_tail`` from the same
    start; ``certify_sharded`` on the verdict solve's terminal iterate
    beside ``certify.device_certificate_payload``.  Returns B2 launches."""
    from dpgo_tpu_torch.parallel import certify as pcert
    from dpgo_tpu_torch.parallel import sharded

    meta = prob.meta
    st, graph = sharded.shard_problem(mesh, rbcd.init_state(
        prob.graph, meta, prob.X0, params), prob.graph)
    seg = sharded.make_sharded_segment(mesh, meta, params)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    st = seg(st, graph, SHARD_TAIL_ROUNDS)
    torch.cuda.synchronize()
    b2 = rk.LAUNCHES
    check(b2 == SHARD_TAIL_ROUNDS, "the sharded rounds before the GN tail "
          "did not launch B2 once a round")
    cfg = refine.GNTailConfig(max_outer=SHARD_TAIL_OUTER,
                              grad_norm_tol=1e-6)
    reads = [0]
    orig = rbcd._host_fetch

    def counting(x):
        reads[0] += 1
        return orig(x)

    rbcd._host_fetch = counting
    t0 = time.perf_counter()
    try:
        Xa, tail = sharded.gn_tail_sharded(st.X, graph, meta, mesh=mesh,
                                           cfg=cfg)
    finally:
        rbcd._host_fetch = orig
    tail_s = time.perf_counter() - t0
    n = prob.n_total
    Xg64 = rbcd.gather_to_global(st.X, graph, n).double().cpu().numpy()
    e64 = edge_set_from_measurements(prob.part.meas_global,
                                     dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    host = refine.gn_tail(Xg64, e64, cfg)
    host_s = time.perf_counter() - t0
    emit({"phase": "sharded", "check": "gn_tail", "card": card,
          "start_rounds": SHARD_TAIL_ROUNDS, "b2_launches": b2,
          "max_outer": SHARD_TAIL_OUTER,
          "sharded": {"cost": tail.cost_history,
                      "grad_norm": tail.grad_norm_history,
                      "cg_iterations": tail.cg_iterations,
                      "terminated_by": tail.terminated_by,
                      "host_reads": reads[0], "seconds": tail_s},
          "host_f64": {"cost": host.cost_history,
                       "grad_norm": host.grad_norm_history,
                       "cg_iterations": host.cg_iterations,
                       "terminated_by": host.terminated_by,
                       "seconds": host_s}})
    # Two reads per outer step, and the final gate unless a step found no
    # decrease (then the loop stops before it).
    check(reads[0] == 2 * tail.outer_iterations
          + (tail.terminated_by != "no_decrease"),
          "the sharded GN tail did not read the host exactly twice per "
          "outer step")
    check(bool(np.isfinite(tail.cost_history).all())
          and tail.cost_history[-1] <= tail.cost_history[0],
          "the sharded GN tail did not decrease the cost")

    # The certificate of the verdict solve's terminal iterate, both ways.
    X = res.X.to(dev)
    edges_g = edge_set_from_measurements(prob.part.meas_global,
                                         dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    cs = pcert.certify_sharded(X, graph, mesh=mesh, eta=SHARD_CERT_ETA,
                               weights=res.state.weights.to(dev)
                               if mesh.size == 1 else None)
    cs_s = time.perf_counter() - t0
    Xg = rbcd.gather_to_global(X, graph, n)
    t0 = time.perf_counter()
    pay = certify.device_certificate_payload(
        Xg, edges_g._replace(weight=res.weights.to(dev)), 0)
    pay = rbcd._host_fetch(pay)
    cp = certify.decide_device_certificate(
        pay, SHARD_CERT_ETA, float(torch.finfo(torch.float32).eps))
    cp_s = time.perf_counter() - t0
    gap = abs(cs.lambda_min - cp.lambda_min)
    limit = SHARD_CERT_ULPS * float(torch.finfo(torch.float32).eps) \
        * cp.sigma
    emit({"phase": "sharded", "check": "certificate", "card": card,
          "eta": SHARD_CERT_ETA,
          "certify_sharded": {"lambda_min": cs.lambda_min,
                              "sigma": cs.sigma, "tol": cs.tol,
                              "certified": cs.certified,
                              "decidable": cs.decidable, "seconds": cs_s},
          "device_payload": {"lambda_min": cp.lambda_min,
                             "sigma": cp.sigma, "tol": cp.tol,
                             "defl_resid": float(pay["defl_resid"]),
                             "certified": cp.certified,
                             "decidable": cp.decidable, "seconds": cp_s},
          "lambda_gap": gap, "limit": limit})
    check(cs.decidable and cp.decidable,
          "a certificate of the stand-in is not decidable in float32")
    check(cs.certified == cp.certified,
          "certify_sharded and the device payload give other verdicts")
    check(np.isfinite(cs.lambda_min) and np.isfinite(cp.lambda_min)
          and gap <= limit,
          "certify_sharded and the device payload disagree on lambda_min")
    return b2


def sharded_resilience(meas, mesh, card: str, tmp: Path) -> int:
    """K = RES_K: a NaN halo at dispatch round RES_NAN and a device
    loss at RES_LOSS; at world size 1 the loss recovers on the same
    size.  The final cost within 1e-6 of the fault-free run's.  Returns
    B2 launches."""
    from dpgo_tpu_torch.parallel import resilience as pres
    from dpgo_tpu_torch.parallel import sharded

    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0)
    kw = dict(mesh=mesh, params=params, max_iters=RES_ROUNDS,
              verdict_every=RES_K, eval_every=RES_K, grad_norm_tol=0.0)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    clean = sharded.solve_rbcd_sharded(meas, ROBOTS, **kw)
    inj = pres.CollectiveFaultInjector(pres.MeshFaultSpec(
        nan_halo_rounds=(RES_NAN,), device_loss_rounds=(RES_LOSS,)),
        seed=7)
    chaos = sharded.solve_rbcd_sharded(
        meas, ROBOTS, resilience=pres.ResilienceConfig(
            checkpoint_dir=str(tmp / "chaos_ck"), injector=inj,
            fetch_deadline_s=120.0), **kw)
    torch.cuda.synchronize()
    b2 = rk.LAUNCHES
    rz = chaos.resilience
    rel = abs(chaos.cost_history[-1] - clean.cost_history[-1]) \
        / abs(clean.cost_history[-1])
    emit({"phase": "sharded", "check": "resilience", "card": card,
          "b2_launches": b2, "rounds": [clean.iterations, chaos.iterations],
          "recovered": chaos.recovered, "resilience": rz,
          "final_cost": chaos.cost_history[-1],
          "fault_free_cost": clean.cost_history[-1], "rel_diff": rel})
    # Both faults fire, each caught by its own word: the NaN by the
    # verdict's anomaly latch, the loss by the fetch it fails; one rewind
    # each, on the same size.
    check(chaos.recovered and rz["injector"]["halo_nan"] == 1
          and rz["injector"]["device_loss"] == 1
          and rz["recoveries"] == 2
          and any(k.startswith("anomaly") for k in rz["fault_kinds"])
          and "device_loss" in rz["fault_kinds"]
          and rz["mesh_sizes"] == [1, 1, 1],
          "the resilience run did not recover from each of its faults")
    check(rel <= 1e-6, "the recovered run's final cost is not the "
          "fault-free one's")
    return b2


def sharded_multihost(card: str, tmp: Path) -> int:
    """``launch_world(procs=2, mesh_size=1)`` with both processes on the
    card, fault-free and with ``kill -9`` of rank 1 at boundary
    MH_KILL_AT.  Returns B2 launches in the worker processes."""
    from dpgo_tpu_torch.parallel import multihost

    kw = dict(robots=MH_ROBOTS, mesh_size=1, rounds=MH_ROUNDS,
              verdict_every=MH_K, device="cuda")
    t0 = time.perf_counter()
    clean = multihost.launch_world(MH_PROCS, workdir=str(tmp / "mh_clean"),
                                   **kw)
    t1 = time.perf_counter()
    chaos = multihost.launch_world(MH_PROCS, workdir=str(tmp / "mh_kill"),
                                   kill_rank=1, kill_at_boundary=MH_KILL_AT,
                                   barrier_timeout_s=MH_BARRIER_S, **kw)
    t2 = time.perf_counter()
    b2, per_rank = 0, {}
    for arm in ("mh_clean", "mh_kill"):
        for f in sorted((tmp / arm).glob("g*-r*.json")):
            rec = json.loads(f.read_text())
            if rec.get("ok"):
                b2 += rec["b2_launches"]
                per_rank[f"{arm}/{f.stem}"] = (rec["b2_launches"],
                                               rec["rounds_executed"])
    res, ref = chaos["result"], clean["result"]
    rel = abs(res["final_cost"] - ref["final_cost"]) / abs(ref["final_cost"])
    emit({"phase": "sharded", "check": "multihost", "card": card,
          "clean": {"world_sizes": clean["world_sizes"],
                    "final_cost": ref["final_cost"],
                    "host_syncs_per_100_rounds":
                        ref["host_syncs_per_100_rounds"],
                    "device": ref["device"], "seconds": t1 - t0},
          "kill": {"world_sizes": chaos["world_sizes"],
                   "outcomes": [g["outcomes"]
                                for g in chaos["generations"]],
                   "resume_iteration": res["resume_iteration"],
                   "final_cost": res["final_cost"], "seconds": t2 - t1},
          "rel_diff": rel, "b2_launches_vs_rounds": per_rank})
    check(clean["world_sizes"] == [MH_PROCS] and not clean["recovered"],
          "the fault-free multihost world did not finish in one generation")
    check(chaos["recovered"] and chaos["world_sizes"] == [MH_PROCS, 1]
          and sorted(chaos["generations"][0]["outcomes"])
          == ["process_lost", "signal:SIGKILL"]
          and res["resume_iteration"] == MH_KILL_AT * MH_K,
          "the killed multihost world did not resume in generation 2")
    check(rel <= 1e-6, "the resumed multihost cost is not the fault-free "
          "world's")
    check(all(a == b for a, b in per_rank.values()),
          "a multihost worker did not launch B2 once per round")
    return b2


# ---------------------------------------------------------------------------
# Every rank of the staircase: the kernels at each (r, d), the f32
# distributed staircase on both stand-ins, SE(2) end to end
# ---------------------------------------------------------------------------

def se2_standin():
    """The SE(2) stand-in at BASELINE.md config #4's size: 10,000 poses,
    20,687 edges (city10000's counts)."""
    return make_measurements(np.random.default_rng(0), n=SE2_POSES, d=2,
                             num_lc=SE2_LC, rot_noise=0.01,
                             trans_noise=0.01)[0]


def instantiated_shapes() -> list:
    """Every (r, d), d in (3, 2) and d <= r <= LANE_CAP + 1, that the
    cluster route's launchers take: they refuse any other
    (``cluster_capacity`` raises), and above LANE_CAP a pose that does not
    fit a CTA."""
    found = []
    for d in (3, 2):
        for r in range(d, LANE_CAP + 2):
            try:  # one pose: one CTA holds it up to the lane cap
                rk.cluster_capacity(r, d, 1, 2, 1)
            except ValueError:
                continue
            found.append((r, d))
    return found


#: Each kernel's wrapper, plain version and work (for the bound).
KERNEL_FNS = {
    "rtr_full": (rk.rtr_full, rk.rtr_full_reference, rtr_full_work),
    "rtr": (rk.rtr, rk.rtr_reference, rtr_work),
    "tcg": (rk.tcg, rk.tcg_reference, tcg_work),
    "rtr_refine_full": (rk.rtr_refine_full, rk.rtr_refine_full_reference,
                        rtr_refine_full_work)}


def rank_operands(meas, robots: int, r: int, edges64, dev) -> tuple:
    """The four kernels' operands and options at rank ``r`` on ``meas``
    over ``robots`` agents, at the card's chordal init (B4: recentered
    there in float64, a zero correction), and the graph and meta."""
    d = meas.d
    params = AgentParams(d=d, r=r, num_robots=robots)
    prob = rbcd.prepare_problem(meas, robots, params, device=dev)
    graph, meta = prob.graph, prob.meta
    b2, b3 = operand_sets(prob, params, prob.X0)
    kw = rbcd.kernel_options(params, meta)
    b3_kw = {k: v for k, v in kw.items() if k != "grad_tol"}
    tkw = {k: kw[k] for k in ("r", "d", "e_max", "max_iters", "kappa",
                              "theta")}
    rparams = dataclasses.replace(params, rel_change_tol=0.0,
                                  solver=dataclasses.replace(
                                      params.solver, grad_norm_tol=1e-9))
    Xg64 = rbcd.gather_to_global(prob.X0, graph, meas.num_poses).double() \
        .cpu().numpy()
    ref = refine.recenter(Xg64, graph, meta, rparams, edges64)
    b4 = refine_operands(torch.zeros_like(ref.consts.R), ref.consts, graph)
    return ({"rtr_full": (b2, kw), "rtr": (b3, b3_kw),
             "tcg": (tcg_operands(b3), tkw),
             "rtr_refine_full": (b4, rbcd.kernel_options(rparams, meta))},
            graph, meta)


def route_opts(cluster: int | None, spread: int | None = None,
               lanes: int | None = None) -> dict:
    """The wrappers' route-forcing keywords."""
    if lanes is not None:
        return {"_lanes": lanes}
    return ({"_spread": spread} if spread is not None
            else {"_cluster": cluster})


def shape_parity(kernel: str, ops: dict, kw: dict, ref,
                 cluster: int | None,
                 spread: int | None = None,
                 lanes: int | None = None) -> tuple[dict, object]:
    """``kernel`` on its planned route (``cluster=None``), the workspace
    route (``0``), a spread over ``spread`` CTAs or the cluster layout
    ``lanes`` against its plain version's output ``ref``, with the gates of
    the slice shape's checks (B2/B3 ``kernel_parity``, B1 the tcg radii, B4
    ``refine_parity``), and a second launch bit for bit."""
    fn = KERNEL_FNS[kernel][0]
    opts = route_opts(cluster, spread, lanes)
    out = fn(*ops.values(), **opts, **kw)
    again = fn(*ops.values(), **opts, **kw)
    torch.cuda.synchronize()
    route = plan_of(ops, kw, kernel, cluster, spread, lanes)
    flips = int((out.stats != ref.stats).any(1).sum()) if kernel == "tcg" \
        else int((out.stats[:, :2] != ref.stats[:, :2]).any(1).sum())
    row = {"route": route.route, "C": route.C, "lanes": route.lanes,
           "stat_flips": flips,
           "repeat_bitwise": all(torch.equal(a, b)
                                 for a, b in zip(out, again))}
    if kernel == "tcg":
        row["err"] = float((out.eta - ref.eta).abs().max())
        row["rel_d_heta"] = float((out.heta - ref.heta).abs().max()
                                  / ref.heta.abs().max().clamp(min=1e-30))
        ok = row["err"] <= X_ATOL and row["rel_d_heta"] <= STAT_RTOL
    elif kernel == "rtr_refine_full":
        step = float((ref.D - ops["Dc"]).abs().max())
        row["err"] = float((out.D - ref.D).abs().max())
        df = ref.stats[:, 2:4]
        row.update(rel_dD=row["err"] / max(step, 1e-30),
                   rel_d_df0_df=float((out.stats[:, 2:4] - df).abs().max()
                                      / df.abs().max().clamp(min=1e-30)),
                   rel_d_gn0=rel_err(out.stats[:, 4], ref.stats[:, 4]))
        ok = (row["rel_dD"] <= D_STEP_RTOL and row["rel_d_df0_df"] <= DF_RTOL
              and row["rel_d_gn0"] <= STAT_RTOL)
    else:
        row["err"] = float((out.X - ref.X).abs().max())
        row["max_rel_d_stats"] = rel_err(out.stats[:, 2:], ref.stats[:, 2:])
        ok = row["err"] <= X_ATOL and row["max_rel_d_stats"] <= STAT_RTOL
    finite = all(bool(torch.isfinite(t).all()) for t in out
                 if t.is_floating_point())
    check(finite and ok and flips == 0 and row["repeat_bitwise"],
          f"{kernel} at (r, d) = ({kw['r']}, {kw['d']}) disagrees with its "
          f"plain version or itself ({route.route} route): {row}")
    return row, out


def shape_turns(fn, ops: dict, kw: dict) -> dict:
    """ms per launch of ``fn`` on its planned route and on the workspace
    route, in turns (planned, workspace, workspace, planned)."""
    def run(cluster=None):
        return cuda_ms(lambda: fn(*ops.values(), _cluster=cluster, **kw),
                       reps=RANK_REPS, inner=RANK_INNER, warmup=1)
    c1, w1, w2, c2 = run(), run(0), run(0), run()
    return {"ms": (c1 + c2) / 2, "ms_workspace": (w1 + w2) / 2,
            "ms_runs": [c1, c2], "ms_workspace_runs": [w1, w2]}


def ranks_phase(stand_ins: dict, dev, card: str) -> dict:
    """B1-B4 at every (r, d) the library holds (it must hold d = 3 with
    3 <= r <= RANK_TOP and d = 2 with 2 <= r <= RANK_TOP), d = 3 on the
    sphere2500 stand-in and d = 2 on the SE(2) stand-in (``stand_ins[d]``:
    measurements, robots, host float64 edges): each kernel on its planned
    route (a cluster at these shapes) and on the workspace route against
    its plain version and itself, timed in turns, beside its plain
    version's time and its bound; the plan of each.  Returns, per kernel,
    the shapes each route ran at, the largest error, and the PERF_SHAPES
    rows."""
    held = instantiated_shapes()
    want = [(r, d) for d in (3, 2) for r in range(d, LANE_CAP + 1)]
    emit({"phase": "ranks", "check": "shapes", "instantiated_up_to":
          {d: max(r for r, dd in held if dd == d) for d in (3, 2)}})
    check(held == want, "the cluster route does not take exactly the "
          f"ranks d <= r <= {LANE_CAP}, d in (2, 3)")
    shapes = [(r, d) for r, d in held if r <= RANK_TOP]
    ran = {k: {"cluster": [], "workspace": []} for k in rk.KERNELS}
    worst = dict.fromkeys(rk.KERNELS, 0.0)
    perf = {}
    for r, d in shapes:
        t0 = time.perf_counter()
        meas, robots, edges64 = stand_ins[d]
        sets, graph, meta = rank_operands(meas, robots, r, edges64, dev)
        row = {"phase": "ranks", "card": card, "r": r, "d": d,
               "agents": robots, "n_max": meta.n_max, "e_max": meta.e_max,
               "kinc": graph.inc_slot.shape[-1], "kernels": {}}
        for kernel, (ops, kw) in sets.items():
            fn, ref_fn, work = KERNEL_FNS[kernel]
            plan = plan_of(ops, kw, kernel)
            check(plan.route == "cluster", f"{kernel} at (r, d) = ({r}, "
                  f"{d}) does not take a cluster on the stand-in")
            ref = ref_fn(*ops.values(), **kw)
            c_row, out = shape_parity(kernel, ops, kw, ref, None)
            w_row, _ = shape_parity(kernel, ops, kw, ref, 0)
            nbytes, flops = work(ops, out, graph, meta)
            b_ms, b_by = bound(nbytes, flops)
            k_row = {"plan": plan._asdict(), "cluster": c_row,
                     "workspace": w_row, **shape_turns(fn, ops, kw),
                     "plain_ms": cuda_ms(lambda: ref_fn(*ops.values(), **kw),
                                         reps=1, warmup=0),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_tcg_iters": int(tcg_iters_of(out).max())}
            row["kernels"][kernel] = k_row
            for route in ("cluster", "workspace"):
                ran[kernel][route].append([r, d])
            worst[kernel] = max(worst[kernel], c_row["err"], w_row["err"])
            if (r, d) in PERF_SHAPES:
                perf.setdefault(f"{r},{d}", {})[kernel] = {
                    k: k_row[k] for k in ("ms", "ms_workspace", "plain_ms",
                                          "bound_ms", "bound_by")}
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        del sets, graph
    return {"shapes": ran, "max_abs_err": worst, "perf_shapes": perf}


#: Each kernel's TPU body (``dpgo_tpu/ops/pallas_tcg.py``).
REPLACES = {"tcg": "dpgo_tpu/ops/pallas_tcg.py:599",
            "rtr_full": "dpgo_tpu/ops/pallas_tcg.py:662",
            "rtr": "dpgo_tpu/ops/pallas_tcg.py:614",
            "rtr_refine_full": "dpgo_tpu/ops/pallas_tcg.py:715"}
ROUTE_SOURCES = {"cluster": "dpgo_tpu_torch/csrc/rtr_cluster.cu",
                 "spread": "dpgo_tpu_torch/csrc/rtr_spread.cu",
                 "workspace": "dpgo_tpu_torch/csrc/rtr_full.cu"}


def generic_rows(high: dict, launches: dict) -> list:
    """The kernel-table rows of the rank-generic instantiation: per kernel,
    its launches on the paths above the templated ranks (``launches``: of
    B2 and B4, those the folded cluster layout did not take), its time,
    plain time and bound at the stand-in's rank 11 (the path's shape; B2's
    and B4's on the row-a-lane layout, timed in turns with the others),
    every (r, d) it ran at by route, and its largest error."""
    out = []
    for kernel, paths in launches.items():
        at11 = high["rows"][kernel]["11,3"]
        route, ms, C = at11["route"], at11[f"ms_{at11['route']}"], at11["C"]
        lay11 = high["layouts"].get(kernel, {}).get("11,3")
        if lay11 is not None:
            pr17 = lay11["layouts"]["lanes_r"]
            route, ms, C = "cluster", pr17["ms"], pr17["C"]
        out.append({
            "name": f"{kernel}_generic", "route": "cuda",
            "source": ROUTE_SOURCES[route],
            "replaces": REPLACES[kernel], "launches_by_path": paths,
            "max_abs_err": high["max_abs_err"][kernel],
            "cuda_route": route, "cluster": C,
            "ms": ms, "plain_ms": at11["plain_ms"],
            "bound_ms": at11["bound_ms"], "bound_by": at11["bound_by"],
            "library_ms": None,
            "routes": {route: ROUTE_SOURCES[route]
                       for route in high["shapes"][kernel]},
            "shapes": high["shapes"][kernel],
            "by_rank": high["rows"][kernel]})
        folded = [[int(x) for x in rd.split(",")]
                  for rd, row in high["rows"][kernel].items()
                  if row["route"] == "spread" and row["folds"] > 1]
        if folded:
            out[-1]["spread_fold"] = {
                "kernel": f"{kernel}_fold_kernel",
                "source": ROUTE_SOURCES["spread"], "shapes": folded}
    return out


def cluster_fold_rows(high: dict, launches: dict) -> list:
    """The kernel-table rows of the cluster route's folded layout (B2's
    ``rtr_full_cluster_fold_kernel<L, d>``, B4's
    ``rtr_refine_full_cluster_fold_kernel<L, d>``): per kernel its launches
    by path (``launches``), its largest error over every folded launch of
    ``fold_layouts``, and its time at the stand-in's rank 11 on the layout
    the plan takes there (else the faster folded one) beside the plain
    version's and the bound; every shape's layouts in ``by_shape``."""
    out = []
    for kernel, paths in launches.items():
        lays = high["layouts"][kernel]
        lay11 = lays["11,3"]
        folds = {k: v for k, v in lay11["layouts"].items() if v["lanes"]}
        pick = (lay11["planned_layout"] if lay11["planned_layout"] in folds
                else min(folds, key=lambda k: folds[k]["ms"]))
        out.append({
            "name": f"{kernel}_cluster_fold", "route": "cuda",
            "source": ROUTE_SOURCES["cluster"], "replaces": REPLACES[kernel],
            "kernel": f"{kernel}_cluster_fold_kernel<L, d>",
            "launches_by_path": paths,
            "max_abs_err": max(v["err"] for lay in lays.values()
                               for v in lay["layouts"].values()
                               if v["lanes"]),
            "lanes": folds[pick]["lanes"], "cluster": folds[pick]["C"],
            "ms": folds[pick]["ms"], "plain_ms": lay11["plain_ms"],
            "bound_ms": lay11["bound_ms"], "bound_by": lay11["bound_by"],
            "library_ms": None,
            "by_shape": {rd: {"planned": lay["planned_layout"],
                              **{k: {f: v[f] for f in (
                                  "ms", "us_per_tcg_iter", "max_tcg_iters",
                                  "C", "P", "threads", "smem_bytes")}
                                 for k, v in lay["layouts"].items()}}
                         for rd, lay in lays.items()}})
    return out


def high_rank_routes(kernel: str, ops: dict, kw: dict) -> dict:
    """Every route ``kernel`` reaches at this shape, as (cluster, spread)
    forcing arguments: the planned one, the workspace route, and the
    spread route the plan would take above the cluster ceiling."""
    plan = plan_of(ops, kw, kernel)
    routes = {plan.route: (None, None)}
    if plan.route != "workspace":
        routes["workspace"] = (0, None)
    if plan.route != "spread":
        A, n, _ = ops["inc_slot"].shape
        spread = rk._spread_plan(n, kw["r"], kw["d"], A,
                                 rk.sm_count(ops["inc_slot"].device))
        if spread is not None:
            routes["spread"] = (None, spread.C)
    return routes


def layout_options(kernel: str, ops: dict, kw: dict) -> dict:
    """The layouts ``kernel`` (B2 or B4) can take at this shape up to r =
    32, as ``shape_parity``'s forcing arguments (cluster, spread, lanes):
    the row-a-lane layout ("lanes_r"), the folded layout ("lanes_8",
    "lanes_16"), each at its own cluster size where one fits, and the
    spread route."""
    A, n, K = ops["inc_slot"].shape
    r, d = kw["r"], kw["d"]
    options = {}
    for lanes in (0, *rk.FOLD_LANES):
        if rk.layout_plan(lanes, n, K, r, d, kernel) is not None:
            options[f"lanes_{lanes or 'r'}"] = (None, None, lanes)
    spread = rk._spread_plan(n, r, d, A, rk.sm_count(ops["inc_slot"].device))
    if spread is not None:
        options["spread"] = (None, spread.C, None)
    return options


def fold_layouts(kernel: str, ops: dict, kw: dict, ref, graph, meta,
                 where: str, card: str) -> dict:
    """B2 or B4 at a rank of ``rk.FOLD_RANKS`` on every layout of
    ``layout_options``: each against its plain version's output ``ref`` and
    itself (``shape_parity``), then timed in turns (every layout, then the
    same in reverse order, LAYOUT_REPS runs of LAYOUT_INNER launches each):
    ms per launch, µs per tCG iteration over the agent's most iterations,
    those iterations, the plan (C, P, threads, bytes), beside the plain
    version's time and the launch's bound.  Emits one line; returns it."""
    fn, ref_fn, work = KERNEL_FNS[kernel]
    options = layout_options(kernel, ops, kw)
    row = {"phase": "high_ranks", "check": "fold_layouts", "card": card,
           "where": where, "kernel": kernel, "r": kw["r"], "d": kw["d"],
           "plan": plan_of(ops, kw, kernel)._asdict(), "layouts": {}}
    outs = {}
    for name, (c, sp, lanes) in options.items():
        p_row, outs[name] = shape_parity(kernel, ops, kw, ref, c, sp, lanes)
        plan = plan_of(ops, kw, kernel, c, sp, lanes)
        iters = max(int(tcg_iters_of(outs[name]).max()), 1)
        row["layouts"][name] = {**p_row, "max_tcg_iters": iters,
                                "C": plan.C, "P": plan.P,
                                "threads": plan.threads,
                                "smem_bytes": plan.smem_bytes,
                                "ms_runs": []}
    for name in [*options, *reversed(options)]:
        opts = route_opts(*options[name])
        row["layouts"][name]["ms_runs"].append(cuda_ms(
            lambda: fn(*ops.values(), **opts, **kw), reps=LAYOUT_REPS,
            inner=LAYOUT_INNER, warmup=1))
    for lay in row["layouts"].values():
        lay["ms"] = statistics.mean(lay["ms_runs"])
        lay["us_per_tcg_iter"] = 1e3 * lay["ms"] / lay["max_tcg_iters"]
    planned = row["plan"]
    row["planned_layout"] = next(
        (name for name, (c, sp, lanes) in options.items()
         if plan_of(ops, kw, kernel, c, sp, lanes)._asdict() == planned),
        None)
    check(row["planned_layout"] is not None, f"{kernel} at (r, d) = "
          f"({kw['r']}, {kw['d']}) is planned on none of its layouts")
    nbytes, flops = work(ops, outs[row["planned_layout"]], graph, meta)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    row["plain_ms"] = cuda_ms(lambda: ref_fn(*ops.values(), **kw), reps=1,
                              warmup=0)
    row["fastest"] = min(row["layouts"], key=lambda k: row["layouts"][k]["ms"])
    emit(row)
    return row


def high_ranks_phase(runs: list, dev, card: str) -> dict:
    """B1-B4 of the rank-generic instantiation (``csrc/shapes.cuh``, every
    r >= 11) at each run's ranks: ``runs`` holds (where, measurements,
    robots, host float64 edges, ranks), at HIGH_RANKS[d] on the sphere2500
    stand-in (d = 3) and the SE(2) stand-in (d = 2), at TOP_RANKS on the
    smallGrid3D-size stand-in and at SMALL_AGENT_TOP_RANKS on 16-pose
    agents; at the card's chordal init (B4
    recentered there): each kernel on every route it reaches
    (``high_rank_routes``) against its plain version and itself, each
    route's ms per launch (above LANE_CAP in turns: the planned route, one
    run of the workspace route, the planned route again), the plain
    version's time and the launch's bound; above LANE_CAP every kernel
    must plan the spread route wherever ``_spread_plan`` fits, else the
    workspace route; wherever B3 plans the spread route, B3 against one B2
    launch at the same point (``b3_against_b2``).  Returns, per kernel,
    the shapes each route ran at, the largest error, and the rows by
    (r, d)."""
    ran = {k: {} for k in rk.KERNELS}
    worst = dict.fromkeys(rk.KERNELS, 0.0)
    rows = {k: {} for k in rk.KERNELS}
    layouts = {k: {} for k in rk.FOLD_KERNELS}
    for where, meas, robots, edges64, ranks in runs:
        d = meas.d
        for r in ranks:
            t0 = time.perf_counter()
            sets, graph, meta = rank_operands(meas, robots, r, edges64, dev)
            row = {"phase": "high_ranks", "card": card, "where": where,
                   "r": r, "d": d, "agents": robots, "n_max": meta.n_max,
                   "e_max": meta.e_max, "kinc": graph.inc_slot.shape[-1],
                   "kernels": {}}
            for kernel, (ops, kw) in sets.items():
                fn, ref_fn, work = KERNEL_FNS[kernel]
                plan = plan_of(ops, kw, kernel)
                ref = ref_fn(*ops.values(), **kw)
                k_row = {"plan": plan._asdict(), "routes": {}}
                out_planned = None
                routes = high_rank_routes(kernel, ops, kw)
                for route, (c, sp) in routes.items():
                    p_row, out = shape_parity(kernel, ops, kw, ref, c, sp)
                    p_row["ms_runs"] = []
                    k_row["routes"][route] = p_row
                    ran[kernel].setdefault(route, []).append([r, d])
                    worst[kernel] = max(worst[kernel], p_row["err"])
                    if c is None and sp is None:
                        out_planned = out
                # Past the lane cap the spread route's folded rows are
                # timed in two runs around one run of the workspace route
                # (tens of milliseconds a launch); below it every route
                # once.
                turns = [*routes, plan.route] \
                    if r > LANE_CAP and len(routes) > 1 else [*routes]
                for route in turns:
                    opts = route_opts(*routes[route])
                    once = r > LANE_CAP and route == "workspace"
                    k_row["routes"][route]["ms_runs"].append(cuda_ms(
                        lambda: fn(*ops.values(), **opts, **kw),
                        reps=1 if once else RANK_REPS, inner=HIGH_INNER,
                        warmup=1))
                for p_row in k_row["routes"].values():
                    p_row["ms"] = statistics.mean(p_row["ms_runs"])
                nbytes, flops = work(ops, out_planned, graph, meta)
                b_ms, b_by = bound(nbytes, flops)
                k_row.update(
                    ms=k_row["routes"][plan.route]["ms"],
                    plain_ms=cuda_ms(lambda: ref_fn(*ops.values(), **kw),
                                     reps=1, warmup=0),
                    bound_ms=b_ms, bound_by=b_by,
                    max_tcg_iters=int(tcg_iters_of(out_planned).max()))
                row["kernels"][kernel] = k_row
                if kernel in rk.FOLD_KERNELS and r in rk.FOLD_RANKS:
                    lay = fold_layouts(kernel, ops, kw, ref, graph, meta,
                                       where, card)
                    layouts[kernel][f"{r},{d}"] = lay
                if kernel == "rtr" and plan.route == "spread":
                    b2_ops, b2_kw = sets["rtr_full"]
                    k_row["against_rtr_full"] = b3_against_b2(
                        ops, kw, out_planned, b2_ops, b2_kw, where=where)
                if r > LANE_CAP:
                    spread = rk._spread_plan(meta.n_max, r, d, robots,
                                             rk.sm_count(dev))
                    check(plan == (spread or rk._workspace_plan(
                        meta.n_max, meta.e_max, r, d, kernel)),
                          f"{kernel} at (r, d) = ({r}, {d}), past the lane "
                          f"cap, is planned on the {plan.route} route")
                rows[kernel][f"{r},{d}"] = {
                    "route": plan.route, "C": plan.C, "folds": plan.folds,
                    **{f"ms_{route}": v["ms"]
                       for route, v in k_row["routes"].items()},
                    **{k: k_row[k] for k in ("plain_ms", "bound_ms",
                                             "bound_by", "max_tcg_iters")}}
            row["seconds"] = time.perf_counter() - t0
            emit(row)
            del sets, graph
    return {"shapes": ran, "max_abs_err": worst, "rows": rows,
            "layouts": layouts}


def smallgrid_standin():
    """The smallGrid3D-size stand-in: 125 poses and 296 edges, the size of
    the reference's smallGrid3D (125 poses, 297 edges)."""
    return make_measurements(np.random.default_rng(0), n=SMALLGRID_POSES,
                             d=3, num_lc=SMALLGRID_LC, rot_noise=0.01,
                             trans_noise=0.01)[0]


def small_agents_standin(d: int):
    """A 32-pose graph that 2 robots split into 16-pose agents, where the
    JAX package's VMEM gate admits its highest ranks."""
    return make_measurements(np.random.default_rng(5), n=32, d=d,
                             num_lc=10, rot_noise=0.05,
                             trans_noise=0.05)[0]


def top_path_rank(meas, r: int, dev, card: str) -> tuple[int, object]:
    """``rbcd.dispatch_prepared`` on ``meas`` over TOP_ROBOTS at rank ``r``
    for TOP_ROUNDS float32 rounds from the host's float64 chordal init,
    counted (B2 = the rounds); the iterate held to the port's float64 run
    on the host from the same start: within TRAJ_SPREAD times the largest
    divergence from that run of the "ell" formulation (float32, on the
    card) from PERTURBED_STARTS starts moved by one ulp, at most TRAJ_MAX,
    and every round's cost within FLOOR_DF_RTOL of f0 of the float64 run's
    (an accept decision that flips on rounding moves f by no more).
    Returns the B2 launches and the kernel run's result, problem and
    parameters."""
    params = AgentParams(d=3, r=r, num_robots=TOP_ROBOTS,
                         rel_change_tol=0.0)
    host = rbcd.prepare_problem(meas, TOP_ROBOTS, params,
                                dtype=torch.float64, device="cpu")
    prob = dataclasses.replace(
        rbcd.prepare_problem(meas, TOP_ROBOTS, params, dtype=torch.float32,
                             init=None, device=dev),
        X0=host.X0.float().to(dev))
    m = prob.meta
    plan = rk.cluster_plan(m.n_max, m.e_max, prob.graph.inc_slot.shape[-1],
                           r, 3, agents=TOP_ROBOTS, sms=rk.sm_count(dev))
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.dispatch_prepared(prob, max_iters=TOP_ROUNDS,
                                 grad_norm_tol=0.0)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    b2 = rk.LAUNCHES
    t1 = time.perf_counter()
    res64 = rbcd.dispatch_prepared(host, max_iters=TOP_ROUNDS,
                                   grad_norm_tol=0.0)
    host_s = time.perf_counter() - t1
    X64 = res64.state.X.to(dev)
    plain = dataclasses.replace(prob, params=dataclasses.replace(
        params, solver=dataclasses.replace(params.solver,
                                           pallas_tcg=False)))
    spread = []
    for seed in range(PERTURBED_STARTS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.randint(-1, 2, prob.X0.shape, generator=gen, device=dev)
        ell = rbcd.dispatch_prepared(
            dataclasses.replace(plain, X0=prob.X0 * (1 + u * 2.0 ** -23)),
            max_iters=TOP_ROUNDS, grad_norm_tol=0.0)
        spread.append(float((ell.state.X.double() - X64).abs().max()))
    limit = min(TRAJ_SPREAD * max(spread), TRAJ_MAX)
    traj = float((res.state.X.double() - X64).abs().max())
    f0 = abs(res64.cost_history[0])
    df = [abs(a - b) / f0 for a, b in zip(res.cost_history,
                                           res64.cost_history)]
    emit({"phase": "top_ranks", "check": "solve", "card": card, "rank": r,
          "robots": TOP_ROBOTS, "poses": meas.num_poses, "edges": len(meas),
          "n_max": m.n_max, "e_max": m.e_max, "plan": plan._asdict(),
          "iterations": res.iterations, "b2_launches": b2,
          "cost": [res.cost_history[0], res.cost_history[-1]],
          "max_abs_dX_vs_f64": traj, "ell_ulp_moved_starts_max_abs_dX":
          spread, "limit": limit, "max_rel_df_vs_f64": max(df),
          "solve_s": solve_s, "ms_per_round": 1e3 * solve_s / TOP_ROUNDS,
          "host_f64_s": host_s})
    check(res.iterations == TOP_ROUNDS and b2 == rbcd.rounds_enqueued(
        res.iterations, params=params, max_iters=TOP_ROUNDS, eval_every=1)
        == TOP_ROUNDS, f"the solve at rank {r} did not launch B2 once a "
          "round")
    check(r <= LANE_CAP or (plan.route, plan.folds) == ("spread",
                                                        -(-r // 512)),
          f"B2 at rank {r} is planned on the {plan.route} route, not the "
          "spread route's folded rows")
    check(bool(torch.isfinite(res.state.X).all() and torch.isfinite(res.T)
               .all()) and res.cost_history[-1] < res.cost_history[0],
          f"the solve at rank {r} is not finite or its cost did not fall")
    check(traj <= limit and max(df) <= FLOOR_DF_RTOL,
          f"the solve at rank {r} leaves the float64 run by more than the "
          "ell formulation's one-ulp divergence allows")
    return b2, (res, prob, params)


def top_ranks_path(meas, dev, card: str) -> dict:
    """The main path at the top ranks (``top_path_rank`` at each of
    TOP_PATH_RANKS), then TOP_REFINE_ROUNDS refine rounds at the last one,
    recentered in float64 at its final iterate (``refine.refine_round``,
    B4 once a round, counted), against as many rounds of the "ell"
    formulation within D_TRAJ_RTOL of its largest correction.  Returns the
    launches by path."""
    b2 = {}
    for r in TOP_PATH_RANKS:
        b2[f"solve_r{r}"], last = top_path_rank(meas, r, dev, card)
    res, prob, params = last
    r = TOP_PATH_RANKS[-1]
    rparams = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, grad_norm_tol=1e-9))
    plain = dataclasses.replace(rparams, solver=dataclasses.replace(
        rparams.solver, pallas_tcg=False))
    graph, meta = prob.graph, prob.meta
    Xg64 = rbcd.gather_to_global(res.state.X, graph, meas.num_poses) \
        .double().cpu().numpy()
    ref = refine.recenter(Xg64, graph, meta, rparams,
                          refine.host_edges_f64(meas))
    plan = rk.cluster_plan(meta.n_max, meta.e_max,
                           graph.inc_slot.shape[-1], r, 3, "rtr_refine_full",
                           agents=TOP_ROBOTS, sms=rk.sm_count(dev))
    check(plan.route == "spread", f"B4 at rank {r} is planned on the "
          f"{plan.route} route, not the spread route")
    Dk = De = torch.zeros_like(ref.consts.R)
    rk.REFINE_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOP_REFINE_ROUNDS):
        Dk, gn = refine.refine_round(Dk, ref.consts, graph, meta, rparams)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    b4 = rk.REFINE_LAUNCHES
    for _ in range(TOP_REFINE_ROUNDS):
        De = refine.refine_round(De, ref.consts, graph, meta, plain)[0]
    traj = float((Dk - De).abs().max())
    scale = float(De.abs().max())
    emit({"phase": "top_ranks", "check": "refine", "card": card, "rank": r,
          "rounds": TOP_REFINE_ROUNDS, "b4_launches": b4,
          "plan": plan._asdict(), "ms_per_round": 1e3 * refine_s
          / TOP_REFINE_ROUNDS,
          "max_abs_dD_vs_ell": traj, "max_abs_D": scale,
          "gradnorm": gn.tolist(), "seconds": refine_s})
    check(b4 == TOP_REFINE_ROUNDS, "the refine rounds at rank "
          f"{r} did not launch B4 once each")
    check(bool(torch.isfinite(Dk).all()) and traj <= D_TRAJ_RTOL * scale,
          f"the refine rounds at rank {r} leave the ell formulation's")
    return {"rtr_full": b2, "rtr_refine_full": {f"refine_r{r}": b4}}


def ablate_high(high: dict, dev, card: str) -> dict:
    """The round ablation at each rank of HIGH_ABLATE_RANKS on the
    stand-in (B3's path above the templated ranks), counted, B3 on the
    route given there (``high``'s plan of B3 at that rank); returns its
    launches by kernel and rank."""
    launches = {"rtr": {}, "rtr_full": {}, "rtr_full_cluster_fold": {}}
    for rank, want in HIGH_ABLATE_RANKS.items():
        route = high["rows"]["rtr"][f"{rank},3"]["route"]
        rk.LAUNCHES = 0
        rk.RTR_LAUNCHES = 0
        rk.FOLD_LAUNCHES.clear()
        torch.cuda.synchronize()
        out = measure_r3.ablate(rank=rank, rounds=HIGH_ABLATE_ROUNDS,
                                device=dev)
        fold = sum(n for (k, _), n in rk.FOLD_LAUNCHES.items()
                   if k == "rtr_full")
        counts = {"rtr": rk.RTR_LAUNCHES, "rtr_full": rk.LAUNCHES - fold,
                  "rtr_full_cluster_fold": fold}
        emit({"phase": "high_ranks", "check": "ablate", "card": card,
              "rank": rank, "b3_route": route, **out, "launches": counts})
        check(route == want,
              f"B3 at rank {rank} on the stand-in is planned on the {route} "
              "route")
        check(bool(np.isfinite(out["b3_stats"]).all()
                   and np.isfinite(out["gn0"]).all()),
              f"the ablation at rank {rank} returned non-finite values")
        check(counts["rtr"] == out["b3_calls"] > 0
              and counts["rtr_full"] + fold > 0,
              f"the ablation at rank {rank} did not launch B3 once per call")
        b2_plan = high["layouts"]["rtr_full"].get(f"{rank},3")
        folded = b2_plan is not None and b2_plan["plan"]["lanes"] > 0
        check((fold > 0) == folded and (counts["rtr_full"] > 0) != folded,
              f"the ablation at rank {rank} did not launch B2 on its planned "
              f"layout ({b2_plan and b2_plan['planned_layout']}): {counts}")
        for kernel, n in counts.items():
            launches[kernel][f"ablate_r{rank}"] = n
    return launches


def psd_shifted(X64: np.ndarray, edges, tol: float, dev) -> bool:
    """Whether S + tol I is positive definite, S the certificate operator
    at ``X64`` (``certify.sparse_certificate``, float64): a Cholesky
    factorization of the assembled matrix in float64 on the card (an
    oracle only, never the path).  A certificate at tolerance ``tol`` (it
    claims lambda_min(S) >= -tol) is sound only where it is."""
    S = certify.sparse_certificate(X64, edges).tocsr()
    St = torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr, dtype=torch.int64),
        torch.as_tensor(S.indices, dtype=torch.int64),
        torch.as_tensor(S.data), size=S.shape).to(dev).to_dense()
    St.diagonal().add_(tol)
    info = int(torch.linalg.cholesky_ex(St)[1])
    del St
    torch.cuda.empty_cache()
    return info == 0


def staircase_f32(where: str, meas, robots: int, run: dict, dev,
                  card: str) -> tuple[int, int]:
    """``parallel.certify.solve_staircase_sharded`` in float32 at world
    size 1 with ``run``'s ranks, rounds per rank, acceleration and
    tolerance, counted: B2 once per round, B4 once per polish round
    (``refine.ROUNDS``).  Every rank's verdict is held for soundness on
    the iterate it certified against the float64 Cholesky of S + tol I on
    the card (``psd_shifted``); a certificate it refutes fails the phase.
    Returns the B2 and B4 launches (the folded cluster layout's, by
    kernel and lanes, stay in ``rk.FOLD_LAUNCHES`` until the next count).
    """
    from dpgo_tpu_torch.parallel import certify as pcert
    from dpgo_tpu_torch.parallel import sharded

    check(not torch.distributed.is_initialized(), "a process group is left "
          "over from an earlier phase")
    mesh = sharded.make_mesh(device=dev)
    verdicts = []
    orig = pcert.certify_sharded

    def recording(Xa, graph, **k):
        cert = orig(Xa, graph, **k)
        Xg64, edges_g = k["global_ctx"]
        verdicts.append((Xg64, edges_g, cert))
        return cert

    pcert.certify_sharded = recording
    try:
        rk.LAUNCHES = 0
        rk.REFINE_LAUNCHES = 0
        rk.FOLD_LAUNCHES.clear()
        refine.ROUNDS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, Xa, rank, cert, hist = pcert.solve_staircase_sharded(
            meas, robots, mesh=mesh, dtype=torch.float32, device=dev, **run)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        b2, b4, polish = rk.LAUNCHES, rk.REFINE_LAUNCHES, refine.ROUNDS
    finally:
        pcert.certify_sharded = orig
        torch.distributed.destroy_process_group()
    ranks = []
    t1 = time.perf_counter()
    for Xg64, edges_g, c in verdicts:
        X64 = np.asarray(Xg64, dtype=np.float64)
        ranks.append({"rank": X64.shape[1], "certified": c.certified,
                      "decidable": c.decidable, "lambda_min": c.lambda_min,
                      "tol": c.tol, "psd_shifted_f64": psd_shifted(
                          X64, edges_g, c.tol, dev)})
    check_s = time.perf_counter() - t1
    emit({"phase": "staircase", "where": where, "card": card,
          "dtype": "float32", "poses": meas.num_poses, "edges": len(meas),
          "d": meas.d, "robots": robots, **run,
          "rank": rank, "certified": cert.certified,
          "history": [{"rank": h[0], "cost": h[1], "lambda_min": h[2],
                       "seconds": h[3]} for h in hist],
          "verdicts": ranks, "b2_launches": b2,
          "rounds": run["rounds_per_rank"] * len(hist), "b4_launches": b4,
          "polish_rounds": polish, "solve_s": solve_s,
          "f64_check_s": check_s})
    check(T.shape == (meas.num_poses, meas.d, meas.d + 1)
          and bool(torch.isfinite(T).all()), f"{where}: the staircase's "
          "trajectory is malformed")
    check([h[0] for h in hist] == list(range(run["r_min"], rank + 1))
          and [v["rank"] for v in ranks] == [h[0] for h in hist],
          f"{where}: the staircase skipped a rank or a certificate")
    check(all(np.isfinite(h[1]) for h in hist), f"{where}: a staircase "
          "rank's cost is not finite")
    check(b2 == run["rounds_per_rank"] * len(hist), f"{where}: B2 did not "
          "launch once per staircase round")
    check(b4 == polish > 0, f"{where}: B4 did not launch once per polish "
          "round")
    check(all(v["psd_shifted_f64"] or not v["certified"] for v in ranks),
          f"{where}: a rank certified that the float64 Cholesky of S + tol "
          "I refutes")
    return b2, b4


def se2_phase(meas, dev, card: str) -> dict:
    """SE(2) end to end on its stand-in: ``solve_rbcd`` over SE2_ROBOTS
    robots at rank SE2_RANK with GNC (the schedules phase's COLORED +
    GNC_TLS configuration), through the verdict loop, counted (B2 =
    enqueued rounds); then the f32 distributed staircase of STAIR_SE2
    (``staircase_f32``).  Returns the B2
    launches of each and the staircase's B4 launches."""
    params = AgentParams(d=2, r=SE2_RANK, num_robots=SE2_ROBOTS,
                         **dict(schedule_configs())["COLORED+GNC_TLS"])
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.solve_rbcd(meas, SE2_ROBOTS, params,
                          max_iters=SCHED_MAX_ITERS,
                          eval_every=SCHED_EVAL_EVERY, verdict_every=ITER_K,
                          grad_norm_tol=GRAD_TOL, dtype=torch.float32,
                          device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, params=params,
                                    max_iters=SCHED_MAX_ITERS,
                                    eval_every=SCHED_EVAL_EVERY,
                                    verdict_every=ITER_K)
    costs = res.cost_history
    w = res.weights
    row = {"phase": "se2", "check": "gnc_solve", "card": card,
           "poses": meas.num_poses, "edges": len(meas), "robots": SE2_ROBOTS,
           "rank": SE2_RANK, "dtype": "float32",
           "iterations": res.iterations, "terminated_by": res.terminated_by,
           "cost_first": costs[0], "cost_final": costs[-1],
           "grad_norm_final": res.grad_norm_history[-1],
           "mu": float(res.state.mu), "below_half": int((w < 0.5).sum()),
           "verdict_every": ITER_K, "solve_s": solve_s,
           "b2_launches": launches, "rounds_enqueued": enqueued}
    emit(row)
    check(res.T.shape == (meas.num_poses, 2, 3)
          and bool(torch.isfinite(res.T).all())
          and bool(np.isfinite(costs).all()) and costs[-1] < costs[0],
          "the SE(2) GNC solve is malformed or its cost did not fall")
    check(row["below_half"] <= GNC_INLIER_REJECT_MAX * len(meas),
          "GNC rejected too many of the SE(2) stand-in's inliers")
    check(launches == enqueued and res.iterations > 0,
          "the SE(2) solve did not launch B2 once per enqueued round")
    b2, b4 = staircase_f32("se2", meas, SE2_ROBOTS, STAIR_SE2, dev, card)
    return {"gnc": launches, "staircase_b2": b2, "staircase_b4": b4}


def config5_instance() -> tuple:
    """BASELINE.md config #5 (SCALE_POSES poses, SCALE_ROBOTS robots,
    ``make_measurements_vectorized``): its measurements, contiguous
    partition and parameters, made once for the config5 and sharded
    phases."""
    from dpgo_tpu_torch.utils.synthetic import make_measurements_vectorized

    meas = make_measurements_vectorized(
        np.random.default_rng(SCALE_SEED), SCALE_POSES, d=3,
        num_lc=int(SCALE_LC * SCALE_POSES), rot_noise=SCALE_NOISE,
        trans_noise=SCALE_NOISE)[0]
    params = AgentParams(d=3, r=RANK, num_robots=SCALE_ROBOTS,
                         rel_change_tol=0.0)
    return meas, partition.partition_contiguous(meas, SCALE_ROBOTS), params


def live_rel_dX(a: torch.Tensor, b: torch.Tensor, graph,
                agents: torch.Tensor) -> tuple[float, float]:
    """Max |a - b| over the live pose columns of ``agents`` (a bool mask)
    of component-major iterates ``[A, rk, n]``, and the largest |b| there
    (padded poses are no data)."""
    n = a.shape[-1]
    live = (torch.arange(n, device=a.device)[None, :]
            < graph.n[:, None]) & agents[:, None]
    live = live[:, None, :].expand_as(a)
    if not bool(live.any()):
        return 0.0, 0.0
    return (float((a - b).abs()[live].max()), float(b.abs()[live].max()))


#: The config5 phase's line of each kernel it holds.
C5_CHECKS = {"rtr_full": "b2", "rtr": "b3", "tcg": "b1"}


def config5_held(kernel: str, ops: dict, kw: dict, graph, meta,
                 where: str, workspace: bool, phase: str = "config5",
                 route: str = "spread",
                 ws_reps: tuple[int, int] = (10, 10)) -> tuple[dict, object]:
    """``kernel`` (B2, B3 or B1) on its planned route at config #5's shape
    against its plain version: B2 and B3 max |ΔX| on live rows of the
    agents whose accept decisions agree at most X_ATOL of the largest live
    entry, f0 and f at STAT_RTOL, every flip within FLOOR_DF_RTOL of f0
    (ROADMAP's accept-flip rule); B1 max |Δeta| on live rows at most X_ATOL
    of the largest live entry, Heta at STAT_RTOL of its largest entry, no
    flip of iterations or boundary hits.  A second launch equal bit for
    bit, with the same tCG iterations; then timed in turns (planned,
    workspace, workspace, planned) where ``workspace`` (the workspace
    route has no r = 7; its runs ``ws_reps``), else alone, with the plain
    version's time and the launch's bound.  The plan must be ``route``;
    the row is ``phase``'s."""
    fn, ref_fn, work = KERNEL_FNS[kernel]
    out = fn(*ops.values(), **kw)
    again = fn(*ops.values(), **kw)
    ref = ref_fn(*ops.values(), **kw)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in out
              if t.is_floating_point()),
          f"{kernel} returned non-finite values at config #5")
    plan = plan_of(ops, kw, kernel)
    bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
    iters, ref_iters = tcg_iters_of(out), tcg_iters_of(ref)
    row = {"phase": phase, "check": C5_CHECKS[kernel], "operands": where,
           "rank": kw["r"], "agents": ops["Xc"].shape[0],
           "n_max": meta.n_max, "plan": plan._asdict(),
           "repeat_bitwise": bitwise,
           "tcg_iters": iters.tolist(), "plain_tcg_iters": ref_iters.tolist(),
           "tcg_iter_flips": int((iters != ref_iters).sum())}
    if kernel == "tcg":
        every = torch.ones(ops["Xc"].shape[0], dtype=torch.bool,
                           device=ops["Xc"].device)
        err, scale = live_rel_dX(out.eta, ref.eta, graph, every)
        herr, hscale = live_rel_dX(out.heta, ref.heta, graph, every)
        flips = int((out.stats != ref.stats).any(1).sum())
        row.update(max_abs_d_eta_live=err, max_abs_eta_live=scale,
                   rel_d_eta_live=err / max(scale, 1e-30),
                   rel_d_heta_live=herr / max(hscale, 1e-30),
                   stat_flips=flips)
        ok = (err <= X_ATOL * scale and herr <= STAT_RTOL * hscale
              and flips == 0)
    else:
        rule = flip_rule(out, ref)
        agree = ~(out.stats[:, :2] != ref.stats[:, :2]).any(1)
        err, scale = live_rel_dX(out.X, ref.X, graph, agree)
        row.update(max_abs_dX_live=err, max_abs_X_live=scale,
                   rel_dX_live=err / max(scale, 1e-30), **rule,
                   attempts=out.stats[:, 0].tolist(),
                   plain_attempts=ref.stats[:, 0].tolist())
        ok = (err <= X_ATOL * scale and rule["max_rel_d_f0"] <= STAT_RTOL
              and rule["max_rel_d_f_agreeing"] <= STAT_RTOL
              and all(x <= FLOOR_DF_RTOL for x in rule["flipped_rel_df"]))
    check(plan.route == route, f"{kernel} at config #5 ({where}) is not "
          f"on the {route} route")
    check(ok, f"{kernel} at config #5 ({where}) disagrees with its plain "
          f"version: {row}")
    check(bitwise and torch.equal(iters, tcg_iters_of(again)),
          f"{kernel} at config #5 ({where}) does not repeat bit for bit")
    if workspace:
        row["timing"] = route_timing(fn, ops, kw, out, ws_reps)
    else:
        ms = cuda_ms(lambda: fn(*ops.values(), **kw), reps=10, inner=10)
        top = max(int(iters.max()), 1)
        row["timing"] = {"ms": ms, "max_tcg_iters": top,
                         "ms_per_tcg_iter": ms / top,
                         "cuda_route": plan.route, "cluster": plan.C,
                         "ctas": ops["Xc"].shape[0] * plan.C,
                         "stripes": plan.stripes,
                         "smem_bytes_per_cta": plan.smem_bytes}
    row["plain_ms"] = cuda_ms(lambda: ref_fn(*ops.values(), **kw), reps=3,
                              warmup=1)
    row["bytes"], row["flops"] = work(ops, out, graph, meta)
    row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
    emit(row)
    return row, out


def config5_rank(part, params, rank: int, meas, dev, card: str) -> dict:
    """B2 at ``rank`` on config #5's graph at the odometry init against its
    plain version (``config5_held``: the spread route, its plan printed) and,
    at the templated top RANK_TOP and the top of C5_TOP_RANKS, B4
    recentered there against its plain version on the spread and workspace
    routes and timed on the spread route."""
    params_r = dataclasses.replace(params, r=rank)
    g, m = rbcd.build_graph(part, rank, torch.float32, dev)
    X = rbcd.initial_state_for("odometry", part, m, g, params_r,
                               torch.float32)
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, g), g)
    ops = dict(zip(B2_ORDER, rbcd.kernel_operands(
        X, Z, g.edges, rbcd.precond_chol(g.edges, g, params_r), g)))
    b2, _ = config5_held("rtr_full", ops, rbcd.kernel_options(params_r, m),
                         g, m, "odometry init", False)
    out = {"b2": b2}
    if rank in (RANK_TOP, C5_TOP_RANKS[-1]):
        rparams = dataclasses.replace(params_r, solver=dataclasses.replace(
            params_r.solver, grad_norm_tol=1e-9))
        Xg64 = rbcd.gather_to_global(X, g, SCALE_POSES).double().cpu() \
            .numpy()
        ref = refine.recenter(Xg64, g, m, rparams,
                              refine.host_edges_f64(meas))
        ops4 = refine_operands(torch.zeros_like(ref.consts.R), ref.consts,
                               g)
        kw4 = rbcd.kernel_options(rparams, m)
        row4, out4 = refine_parity(ops4, kw4)
        row4_ws, _ = refine_parity(ops4, kw4, cluster=0)
        plan4 = plan_of(ops4, kw4, "rtr_refine_full")
        check(plan4.route == "spread", f"B4 at config #5, rank {rank}, is "
              "not on the spread route")
        ms = cuda_ms(lambda: rk.rtr_refine_full(*ops4.values(), **kw4),
                     reps=5, inner=5)
        nbytes, flops = rtr_refine_full_work(ops4, out4, g, m)
        b_ms, b_by = bound(nbytes, flops)
        out["b4"] = {"spread": row4, "workspace": row4_ws, "ms": ms,
                     "cluster": plan4.C, "ctas": m.num_robots * plan4.C,
                     "stripes": plan4.stripes,
                     "plain_ms": cuda_ms(lambda: rk.rtr_refine_full_reference(
                         *ops4.values(), **kw4), reps=1, warmup=0),
                     "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "config5", "check": "b4", "card": card,
              "rank": rank, "plan": plan4._asdict(),
              **{k: v for k, v in out["b4"].items()
                 if k not in ("spread", "workspace")},
              "parity": {"spread": row4, "workspace": row4_ws}})
    return out


def config5_phase(inst, dev, card: str) -> dict:
    """BASELINE.md config #5 through the main path: ``solve_rbcd``
    (odometry init, the verdict loop, C5_ROUNDS rounds at K = C5_K), B2
    once per enqueued round on the spread route; the four kernels' plan
    at this shape; B2 at the terminal iterate against its plain version,
    bit for bit against itself and timed in turns with the workspace
    route; B2 at each rank of C5_TOP_RANKS at the odometry init and B4 at
    RANK_TOP and the top one (``config5_rank``); B4 at this shape (constants recentered
    at the terminal iterate, three refine rounds in) against its plain
    version on the spread and workspace routes and timed on both.  Returns
    the spread route's rows of the kernel table."""
    meas, part, params = inst
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.solve_rbcd(meas, SCALE_ROBOTS, params, max_iters=C5_ROUNDS,
                          grad_norm_tol=0.0, part=part, init="odometry",
                          verdict_every=C5_K, device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=C5_ROUNDS,
                                    eval_every=1, params=params,
                                    verdict_every=C5_K)
    prob = rbcd.prepare_problem(meas, SCALE_ROBOTS, params,
                                dtype=torch.float32, part=part, init=None,
                                device=dev)
    graph, meta = prob.graph, prob.meta
    X = res.state.X
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    ops = dict(zip(B2_ORDER, rbcd.kernel_operands(
        X, Z, graph.edges, res.state.chol, graph)))
    kw = rbcd.kernel_options(params, meta)
    plans = {k: plan_of(ops, kw, k)._asdict() for k in rk.KERNELS}
    emit({"phase": "config5", "check": "solve", "card": card,
          "poses": SCALE_POSES, "robots": SCALE_ROBOTS,
          "edges": len(meas), "n_max": meta.n_max, "e_max": meta.e_max,
          "s_max": meta.s_max, "kinc": ops["inc_slot"].shape[-1],
          "sms": rk.sm_count(dev), "plan": plans,
          "iterations": res.iterations, "terminated_by": res.terminated_by,
          "cost": [res.cost_history[0], res.cost_history[-1]],
          "b2_launches": launches, "rounds_enqueued": enqueued,
          "solve_s": solve_s})
    check(all(p["route"] == "spread" for p in plans.values()),
          "config #5's plan is not B1-B4 spread")
    check(res.iterations == C5_ROUNDS and launches == enqueued
          and bool(np.isfinite(res.cost_history).all())
          and res.cost_history[-1] < res.cost_history[0],
          "config #5's solve did not launch B2 once per enqueued round "
          "with finite, falling costs")

    b2, out = config5_held("rtr_full", ops, kw, graph, meta,
                           "terminal iterate", True)
    # B3 and B1 at the same point, fed the gradient pass's g and S (as the
    # ablation feeds B3), and B3 against the B2 launch there.
    g, _, S = rbcd.gradient_pass(X, graph, meta)
    b3_ops = dict(zip(B3_ORDER, rbcd.b3_operands(X, Z, g, S, graph.edges,
                                                 res.state.chol, graph)))
    b3_kw = {k: v for k, v in kw.items() if k != "grad_tol"}
    b3, b3_out = config5_held("rtr", b3_ops, b3_kw, graph, meta,
                              "terminal iterate", True)
    b3_vs_b2 = b3_against_b2(b3_ops, b3_kw, b3_out, ops, kw, graph,
                             "config #5, terminal iterate")
    tkw = {k: kw[k] for k in ("r", "d", "e_max", "max_iters", "kappa",
                              "theta")}
    b1, _ = config5_held("tcg", tcg_operands(b3_ops), tkw, graph, meta,
                         "terminal iterate, radius 1", True)
    # Higher ranks at the odometry init of config #5's graph.
    tops = {rank: config5_rank(part, params, rank, meas, dev, card)
            for rank in C5_TOP_RANKS}

    # B4 at this shape, from the terminal iterate.
    rparams = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, grad_norm_tol=1e-9))
    edges64 = refine.host_edges_f64(meas)
    Xg64 = rbcd.gather_to_global(X, graph, SCALE_POSES).double().cpu() \
        .numpy()
    ref = refine.recenter(Xg64, graph, meta, rparams, edges64)
    rk.REFINE_LAUNCHES = 0
    D = refine.refine_rounds(torch.zeros_like(ref.consts.R), ref.consts,
                             graph, meta, rparams, 3)
    b4_launches = rk.REFINE_LAUNCHES
    ops4 = refine_operands(D, ref.consts, graph)
    kw4 = rbcd.kernel_options(rparams, meta)
    row4, out4 = refine_parity(ops4, kw4)
    row4_ws, _ = refine_parity(ops4, kw4, cluster=0)
    check(row4["cuda_route"] == "spread", "B4 at config #5 is not on the "
          "spread route")
    b4_t = route_timing(rk.rtr_refine_full, ops4, kw4, out4)
    b4_plain = cuda_ms(lambda: rk.rtr_refine_full_reference(
        *ops4.values(), **kw4), reps=3, warmup=1)
    b4_bytes, b4_flops = rtr_refine_full_work(ops4, out4, graph, meta)
    b4_bound, b4_by = bound(b4_bytes, b4_flops)
    emit({"phase": "config5", "check": "b4", "card": card,
          "spread": row4, "workspace": row4_ws, "timing": b4_t,
          "plain_ms": b4_plain, "bound_ms": b4_bound, "bound_by": b4_by,
          "bytes": b4_bytes, "flops": b4_flops,
          "refine_round_launches": b4_launches})
    check(b4_launches == 3, "the refine rounds did not launch B4 once each")

    t = b2["timing"]
    spread_b2 = {
        "name": "rtr_full_spread", "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/rtr_spread.cu",
        "replaces": "dpgo_tpu/ops/pallas_tcg.py:662",
        "launches_by_path": {"config5": launches},
        "max_abs_err": max([b2["max_abs_dX_live"]]
                           + [t["b2"]["max_abs_dX_live"]
                              for t in tops.values()]),
        "floor_accept_flips": len(b2["flipped_rel_df"])
        + sum(len(t["b2"]["flipped_rel_df"]) for t in tops.values()),
        "cuda_route": "spread", "cluster": t["cluster"], "ctas": t["ctas"],
        "stripes": t["stripes"], "ms": t["ms"],
        "ms_single_cta": t["ms_single_cta"], "speedup": t["speedup"],
        "us_per_tcg_iter": 1e3 * t["ms_per_tcg_iter"],
        "us_per_tcg_iter_single_cta": 1e3 * t["ms_per_tcg_iter_single_cta"],
        "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"], "library_ms": None,
        "bytes": b2["bytes"], "flops": b2["flops"],
        "by_rank": {rank: {k: t["b2"]["timing"][k] for k in (
            "ms", "cluster", "ctas", "stripes", "ms_per_tcg_iter")}
            | {k: t["b2"][k] for k in ("plain_ms", "bound_ms", "bound_by",
                                       "max_abs_dX_live", "rel_dX_live")}
            for rank, t in tops.items()}}
    spread_b4 = {
        "name": "rtr_refine_full_spread", "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/rtr_spread.cu",
        "replaces": "dpgo_tpu/ops/pallas_tcg.py:715",
        "launches_by_path": {"config5": b4_launches},
        "max_abs_err": max([row4["max_abs_dD"]]
                           + [t["b4"]["spread"]["max_abs_dD"]
                              for t in tops.values() if "b4" in t]),
        "cuda_route": "spread",
        "cluster": b4_t["cluster"], "ctas": b4_t["ctas"],
        "stripes": b4_t["stripes"], "ms": b4_t["ms"],
        "ms_single_cta": b4_t["ms_single_cta"], "speedup": b4_t["speedup"],
        "us_per_tcg_iter": 1e3 * b4_t["ms_per_tcg_iter"],
        "us_per_tcg_iter_single_cta":
        1e3 * b4_t["ms_per_tcg_iter_single_cta"],
        "plain_ms": b4_plain, "bound_ms": b4_bound, "bound_by": b4_by,
        "library_ms": None, "bytes": b4_bytes, "flops": b4_flops,
        "by_rank": {rank: {k: t["b4"][k] for k in (
            "ms", "cluster", "ctas", "stripes", "plain_ms", "bound_ms",
            "bound_by")} for rank, t in tops.items() if "b4" in t}}
    # B3's and B1's spread rows: their launches on the paths (B3's in the
    # ablation at r = 73; B1 is on none) join in main.
    spread_b31 = [{
        "name": f"{kernel}_spread", "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/rtr_spread.cu",
        "replaces": REPLACES[kernel], "launches_by_path": {},
        "max_abs_err": row.get("max_abs_dX_live",
                               row.get("max_abs_d_eta_live")),
        **one_set_columns(row["timing"]), "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "bytes": row["bytes"], "flops": row["flops"],
        "stripes": row["timing"]["stripes"]}
        for kernel, row in (("rtr", b3), ("tcg", b1))]
    spread_b31[0]["against_rtr_full"] = {
        k: b3_vs_b2[k] for k in ("agents_compared", "stat_flips",
                                 "rel_dX_live")}
    return {"rows": [spread_b2, spread_b4, *spread_b31]}


def big_agents_phase(inst, dev, card: str) -> dict:
    """Config #5's measurements over BIG_ROBOTS robots through the main
    path: ``solve_rbcd`` (odometry init, BIG_ROUNDS rounds at K = BIG_K),
    B2 once per enqueued round on the grid route, the run bit for bit
    with ``dispatch_prepared`` on the same problem and within
    ``trajectory_gap``'s limit of the "ell" formulation's; B2 at the
    terminal iterate and at the odometry init of the whole graph as one
    agent, and B4 three refine rounds in, each against its plain version
    and itself, timed.  Returns the grid route's rows of the kernel
    table."""
    meas = inst[0]
    params = AgentParams(d=3, r=RANK, num_robots=BIG_ROBOTS,
                         rel_change_tol=0.0)
    part = partition.partition_contiguous(meas, BIG_ROBOTS)
    solve_kw = dict(max_iters=BIG_ROUNDS, grad_norm_tol=0.0,
                    verdict_every=BIG_K)
    prob = rbcd.prepare_problem(meas, BIG_ROBOTS, params,
                                dtype=torch.float32, part=part,
                                init="odometry", device=dev)
    graph, meta = prob.graph, prob.meta
    kinc = graph.inc_slot.shape[-1]
    plans = {k: rk.cluster_plan(meta.n_max, meta.e_max, kinc, RANK, 3, k,
                                agents=BIG_ROBOTS, sms=rk.sm_count(dev))
             for k in rk.KERNELS}
    rk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rbcd.solve_rbcd(meas, BIG_ROBOTS, params, part=part,
                          init="odometry", device=dev, **solve_kw)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = rk.LAUNCHES
    enqueued = rbcd.rounds_enqueued(res.iterations, max_iters=BIG_ROUNDS,
                                    eval_every=1, params=params,
                                    verdict_every=BIG_K)
    X = res.state.X.to(dev)
    again = rbcd.dispatch_prepared(prob, **solve_kw).state.X.to(dev)
    # The "ell" formulation from the same start, and from starts moved by
    # about one ulp: its own divergence sets the trajectory's limit.
    plain = dataclasses.replace(prob, params=dataclasses.replace(
        params, solver=dataclasses.replace(params.solver,
                                           pallas_tcg=False)))

    def ell_from(X0):
        return rbcd.dispatch_prepared(dataclasses.replace(plain, X0=X0),
                                      **solve_kw).state.X.to(dev)
    ell = ell_from(prob.X0)
    spread = []
    for seed in range(PERTURBED_STARTS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.randint(-1, 2, prob.X0.shape, generator=gen, device=dev)
        spread.append(float((ell_from(prob.X0 * (1 + u * 2.0 ** -23))
                             - ell).abs().max()))
    limit = min(TRAJ_SPREAD * max(spread), TRAJ_MAX)
    gap = float((X - ell).abs().max())
    costs = res.cost_history
    b2_plan = plans["rtr_full"]
    emit({"phase": "big_agents", "check": "solve", "card": card,
          "poses": SCALE_POSES, "robots": BIG_ROBOTS, "edges": len(meas),
          "n_max": meta.n_max, "e_max": meta.e_max, "s_max": meta.s_max,
          "kinc": kinc, "sms": rk.sm_count(dev),
          "plan": {k: p._asdict() for k, p in plans.items()},
          "ctas": BIG_ROBOTS * b2_plan.C,
          "workspace_bytes_per_agent": 4 * rk.grid_workspace_floats(
              RANK, 3, meta.n_max, meta.e_max, kinc, b2_plan.C),
          "iterations": res.iterations, "cost": [costs[0], costs[-1]],
          "b2_launches": launches, "rounds_enqueued": enqueued,
          "dispatch_prepared_bitwise": torch.equal(X, again),
          "max_abs_dX_vs_ell": gap, "ell_ulp_moved_starts_max_abs_dX":
          spread, "limit": limit, "solve_s": solve_s,
          "ms_per_round": 1e3 * solve_s / max(res.iterations, 1)})
    check(all(plans[k].route == "grid" for k in rk.GRID_KERNELS)
          and all(plans[k].route == "workspace" for k in ("rtr", "tcg")),
          "config #5 over few robots is not B2 and B4 on the grid route")
    check(res.iterations == BIG_ROUNDS and launches == enqueued
          and bool(np.isfinite(costs).all()) and costs[-1] < costs[0],
          "the solve over few robots did not launch B2 once per enqueued "
          "round with finite, falling costs")
    check(torch.equal(X, again), "solve_rbcd and dispatch_prepared on the "
          "same problem differ")
    check(gap <= limit, "the grid route's solve leaves the \"ell\" "
          "formulation's by more than its own one-ulp divergence allows")

    # B2 at the terminal iterate.
    Z = rbcd.neighbor_buffer(rbcd.public_table(X, graph), graph)
    ops = dict(zip(B2_ORDER, rbcd.kernel_operands(
        X, Z, graph.edges, res.state.chol.to(dev), graph)))
    kw = rbcd.kernel_options(params, meta)
    b2, _ = config5_held("rtr_full", ops, kw, graph, meta,
                         "terminal iterate", True, phase="big_agents",
                         route="grid", ws_reps=BIG_WS_REPS)

    # B4 recentered at the terminal iterate, three refine rounds in.
    rparams = dataclasses.replace(params, solver=dataclasses.replace(
        params.solver, grad_norm_tol=1e-9))
    Xg64 = rbcd.gather_to_global(X, graph, SCALE_POSES).double().cpu() \
        .numpy()
    ref = refine.recenter(Xg64, graph, meta, rparams,
                          refine.host_edges_f64(meas))
    rk.REFINE_LAUNCHES = 0
    D = refine.refine_rounds(torch.zeros_like(ref.consts.R), ref.consts,
                             graph, meta, rparams, 3)
    b4_launches = rk.REFINE_LAUNCHES
    ops4 = refine_operands(D, ref.consts, graph)
    kw4 = rbcd.kernel_options(rparams, meta)
    row4, out4 = refine_parity(ops4, kw4)
    row4_ws, _ = refine_parity(ops4, kw4, cluster=0)
    again4 = rk.rtr_refine_full(*ops4.values(), **kw4)
    torch.cuda.synchronize()
    b4_bitwise = all(torch.equal(a, b) for a, b in zip(out4, again4))
    b4_t = route_timing(rk.rtr_refine_full, ops4, kw4, out4, BIG_WS_REPS)
    b4_plain = cuda_ms(lambda: rk.rtr_refine_full_reference(
        *ops4.values(), **kw4), reps=3, warmup=1)
    b4_bytes, b4_flops = rtr_refine_full_work(ops4, out4, graph, meta)
    b4_bound, b4_by = bound(b4_bytes, b4_flops)
    emit({"phase": "big_agents", "check": "b4", "card": card,
          "grid": row4, "workspace": row4_ws, "repeat_bitwise": b4_bitwise,
          "timing": b4_t, "plain_ms": b4_plain, "bound_ms": b4_bound,
          "bound_by": b4_by, "bytes": b4_bytes, "flops": b4_flops,
          "refine_round_launches": b4_launches})
    check(row4["cuda_route"] == "grid", "B4 over few robots is not on the "
          "grid route")
    check(b4_launches == 3, "the refine rounds did not launch B4 once each")
    check(b4_bitwise, "B4 on the grid route does not repeat bit for bit")

    # B2 on the whole graph as one agent (the PGOAgent case), alone.
    p1 = AgentParams(d=3, r=RANK, num_robots=1, rel_change_tol=0.0)
    part1 = partition.partition_contiguous(meas, 1)
    g1, m1 = rbcd.build_graph(part1, RANK, torch.float32, dev)
    X1 = rbcd.initial_state_for("odometry", part1, m1, g1, p1, torch.float32)
    Z1 = rbcd.neighbor_buffer(rbcd.public_table(X1, g1), g1)
    ops1 = dict(zip(B2_ORDER, rbcd.kernel_operands(
        X1, Z1, g1.edges, rbcd.precond_chol(g1.edges, g1, p1), g1)))
    one, _ = config5_held("rtr_full", ops1, rbcd.kernel_options(p1, m1), g1,
                          m1, "odometry init, one agent", False,
                          phase="big_agents", route="grid")

    t = b2["timing"]
    grid_b2 = {
        "name": "rtr_full_grid", "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/rtr_grid.cu",
        "replaces": "dpgo_tpu/ops/pallas_tcg.py:662",
        "launches_by_path": {"big_agents": launches},
        "max_abs_err": max(b2["max_abs_dX_live"], one["max_abs_dX_live"]),
        "floor_accept_flips": len(b2["flipped_rel_df"])
        + len(one["flipped_rel_df"]),
        "cuda_route": "grid", "cluster": t["cluster"], "ctas": t["ctas"],
        "stripes": t["stripes"], "ms": t["ms"],
        "ms_single_cta": t["ms_single_cta"], "speedup": t["speedup"],
        "us_per_tcg_iter": 1e3 * t["ms_per_tcg_iter"],
        "us_per_tcg_iter_single_cta": 1e3 * t["ms_per_tcg_iter_single_cta"],
        "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"], "library_ms": None,
        "bytes": b2["bytes"], "flops": b2["flops"],
        "shapes": {"grid": [[RANK, 3]]},
        "one_agent": {k: one["timing"][k] for k in (
            "ms", "cluster", "ctas", "stripes", "ms_per_tcg_iter")}
        | {k: one[k] for k in ("plain_ms", "bound_ms", "bound_by",
                               "max_abs_dX_live", "rel_dX_live")}}
    grid_b4 = {
        "name": "rtr_refine_full_grid", "route": "cuda",
        "source": "dpgo_tpu_torch/csrc/rtr_grid.cu",
        "replaces": "dpgo_tpu/ops/pallas_tcg.py:715",
        "launches_by_path": {"big_agents": b4_launches},
        "max_abs_err": row4["max_abs_dD"], "cuda_route": "grid",
        "cluster": b4_t["cluster"], "ctas": b4_t["ctas"],
        "stripes": b4_t["stripes"], "ms": b4_t["ms"],
        "ms_single_cta": b4_t["ms_single_cta"], "speedup": b4_t["speedup"],
        "us_per_tcg_iter": 1e3 * b4_t["ms_per_tcg_iter"],
        "us_per_tcg_iter_single_cta":
        1e3 * b4_t["ms_per_tcg_iter_single_cta"],
        "plain_ms": b4_plain, "bound_ms": b4_bound, "bound_by": b4_by,
        "library_ms": None, "bytes": b4_bytes, "flops": b4_flops,
        "shapes": {"grid": [[RANK, 3]]}}
    return {"rows": [grid_b2, grid_b4]}


def sharded_scale(mesh, dev, card: str, inst) -> tuple[int, dict]:
    """BASELINE.md config #5 at world size 1 (``config5_instance``: odometry
    init), SCALE_ROUNDS rounds through the sharded verdict loop, then
    ``gn_tail_sharded`` and the fused device certificate.  Returns B2
    launches and the config's B2 row (ms per launch, route)."""
    from dpgo_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    meas, part, params = inst
    graph_h, meta = rbcd.build_graph(part, RANK, torch.float32, dev)
    X0 = rbcd.initial_state_for("odometry", part, meta, graph_h, params,
                                torch.float32)
    state, g = sharded.shard_problem(mesh, rbcd.init_state(
        graph_h, meta, X0, params), graph_h)
    n, M = part.meas_global.num_poses, len(part.meas_global)
    edges_g = edge_set_from_measurements(part.meas_global,
                                         dtype=torch.float32, device=dev)
    seg = sharded.make_sharded_segment(mesh, meta, params)
    assemble = sharded._global_assembly(mesh, g, n, M)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rk.LAUNCHES = 0
    t0 = time.perf_counter()
    res = rbcd.run_rbcd(
        state, g, meta,
        lambda s, k, uw, rs: seg(s, g, k, update_weights=uw, restart=rs),
        part, SCALE_ROUNDS, 0.0, SCALE_K,
        torch.float32, params=params, verdict_every=SCALE_K,
        metrics_body_factory=lambda tel: sharded.make_sharded_metrics_body(
            mesh, g, edges_g, n, M, tel), assemble=assemble)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    b2 = rk.LAUNCHES
    check(res.iterations == SCALE_ROUNDS and b2 == SCALE_ROUNDS
          and bool(np.isfinite(res.cost_history).all()),
          "config #5 did not run its rounds with finite costs")
    # The GN-CG tail and the fused device certificate (one fetch).
    t0 = time.perf_counter()
    Xa, tail = sharded.gn_tail_sharded(
        res.state.X, g, meta, mesh=mesh,
        cfg=refine.GNTailConfig(max_outer=SCALE_OUTER),
        weights=res.state.weights)
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epilogue = rbcd.make_terminal_epilogue(g, edges_g, n, M, meta,
                                           certify_mode="device",
                                           assemble=assemble)
    fin = rbcd._host_fetch(epilogue(Xa, res.state.weights, {}))
    cert = certify.decide_device_certificate(
        fin["cert"], SHARD_CERT_ETA, float(torch.finfo(torch.float32).eps))
    cert_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # B2 alone at this shape: one launch on the terminal iterate.
    Z = rbcd.neighbor_buffer(rbcd.public_table(res.state.X, g), g)
    ops = dict(zip(B2_ORDER, rbcd.kernel_operands(
        res.state.X, Z, g.edges, res.state.chol, g)))
    kw = rbcd.kernel_options(params, meta)
    route = plan_of(ops, kw)
    b2_ms = cuda_ms(lambda: rk.rtr_full(*ops.values(), **kw), reps=5,
                    warmup=1)
    # Its bound at the live extent, from this launch's own attempts and
    # tCG iterations.
    b2_bytes, b2_flops = rtr_full_work(ops, rk.rtr_full(*ops.values(),
                                                        **kw), g, meta)
    b2_bound_ms, b2_bound_by = bound(b2_bytes, b2_flops)
    # A plain round once the loop is running: SCALE_K sharded rounds from
    # the terminal state, back to back (loop_s above holds run_rbcd's
    # one-time epilogue build and its terminal fetch).
    round_ms = cuda_ms(lambda: seg(res.state, g, SCALE_K), reps=3,
                       warmup=1) / SCALE_K
    row = {"poses": SCALE_POSES, "robots": SCALE_ROBOTS,
           "edges": len(meas), "n_max": meta.n_max, "e_max": meta.e_max,
           "s_max": meta.s_max, "rounds": res.iterations,
           "verdict_every": SCALE_K, "build_s": build_s,
           "loop_s": loop_s, "ms_per_round": round_ms,
           "b2_ms_per_launch": b2_ms, "b2_route": route.route,
           "b2_cluster": route.C, "b2_bound_ms": b2_bound_ms,
           "b2_bound_by": b2_bound_by, "b2_bytes": b2_bytes,
           "b2_flops": b2_flops, "peak_memory_bytes": peak,
           "comm_bytes_per_round": {
               str(k): sharded.comm_bytes_per_round(meta, k)
               for k in (1, 2, 4, 8)},
           "cost": [res.cost_history[0], res.cost_history[-1]],
           "gn_tail": {"cost": tail.cost_history,
                       "grad_norm": tail.grad_norm_history,
                       "cg_iterations": tail.cg_iterations,
                       "terminated_by": tail.terminated_by,
                       "seconds": tail_s},
           "certificate": {"lambda_min": cert.lambda_min,
                           "sigma": cert.sigma,
                           "certified": cert.certified,
                           "decidable": cert.decidable,
                           "seconds": cert_s}}
    emit({"phase": "sharded", "check": "config5", "card": card, **row})
    check(bool(np.isfinite(tail.cost_history).all()),
          "config #5's GN tail is not finite")
    return b2, row


def sharded_phase(meas, params, dev, card: str, tmp: Path,
                  inst) -> tuple[int, int, dict]:
    """The sharded plane (``dpgo_tpu_torch.parallel``) at world size 1 over
    NCCL: the stand-in equivalence, the verdict loop, the GN tail, the
    certificate, resilience, multihost and config #5.  Returns B2
    launches in this process and in the multihost workers, and config
    #5's row."""
    from dpgo_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    mesh = sharded.make_mesh(device=dev)
    check(mesh.size == 1 and "nccl" in str(
        torch.distributed.get_backend()).lower(),
          "the card's mesh is not an NCCL world of size 1")
    b2, res, prob = sharded_standin(meas, mesh, dev, card, tmp)
    b2 += sharded_tail_and_certificate(meas, params, prob, res, mesh, dev,
                                       card)
    b2 += sharded_resilience(meas, mesh, card, tmp)
    scale_b2, scale_row = sharded_scale(mesh, dev, card, inst)
    b2 += scale_b2
    torch.distributed.destroy_process_group()
    workers_b2 = sharded_multihost(card, tmp)
    emit({"phase": "sharded", "check": "seconds", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return b2, workers_b2, scale_row


def serve_phase(dev, card: str, tmp: Path) -> tuple[dict, dict]:
    """The serving plane on the card (``dpgo_tpu_torch.serve``): the
    requests' buckets, one batch of all eight (B2 once per round over
    B*A = 64 agents), the in-process server, the TCP front-end, and
    streaming.  Returns B2's launches on the serving path by agents per
    launch (``run_bucket``, ``SolveServer``, the in-process front-end,
    ``LiveProblem.warm_dispatch``) and B2's timing row at 64 agents."""
    t0 = time.perf_counter()
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS, rel_change_tol=0.0)
    reqs = serve_requests()
    padded = serve_prepare(reqs, params, dev, card)
    emit({"phase": "serve", "check": "buckets", "card": card,
          "requests": len(reqs),
          "distinct_buckets": len({p.shape for p in padded})})

    from dpgo_tpu_torch.serve import BucketShape, pad_problem

    common = BucketShape(*[max(v) for v in zip(*[p.shape for p in padded])])
    batch = [pad_problem(unpadded(p, params), common) for p in padded]
    padded_member_parity(batch, params, card)
    by = collections.Counter()
    batch_res, timing = serve_batch(batch, params, card, by)
    serve_server(reqs, batch_res, params, dev, card, tmp, by)
    serve_tcp(reqs[0][1], dev, card, tmp, by)
    serve_streaming(params, dev, card, by)
    by = {str(k): v for k, v in sorted(by.items())}
    emit({"phase": "serve", "check": "time", "card": card,
          "seconds": time.perf_counter() - t0,
          "b2_launches": sum(by.values()), "b2_launches_by_agents": by,
          "b2_ms_at_64_agents": timing["ms"]})
    return by, timing


# ---------------------------------------------------------------------------
# The serving fleet: router, replica manager, child replicas, artifact tier
# ---------------------------------------------------------------------------

def fleet_request(meas, sid=None, rounds=None):
    """A stand-in request of the fleet phase: it runs all its rounds
    (consensus unreachable, ``rel_change_tol`` < 0, and SERVE_GTOL), eval
    every FLEET_EVAL rounds."""
    from dpgo_tpu_torch.serve import SolveRequest

    return SolveRequest(
        meas=meas, num_robots=ROBOTS,
        params=AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                           rel_change_tol=-1.0),
        max_iters=FLEET_ROUNDS if rounds is None else rounds,
        grad_norm_tol=SERVE_GTOL, eval_every=FLEET_EVAL, session_id=sid)


@contextlib.contextmanager
def fleet_tally():
    """B2 launches (``rk.rtr_full`` calls on the card, each one launch) and
    rounds (``run_bucket``'s ``info``) of in-process replicas' batches, by
    replica id (``SolveServer._run_batch``'s ``replica_id``; None for a
    lone server); also the launch counter's growth over the block."""
    from dpgo_tpu_torch.serve import server as server_mod

    tls = threading.local()
    lock = threading.Lock()
    out = {"launches": collections.Counter(), "rounds": collections.Counter(),
           "counter": rk.LAUNCHES}
    real_b2, real_rb = rk.rtr_full, server_mod.run_bucket
    real_batch = server_mod.SolveServer._run_batch

    def b2(*a, **kw):
        res = real_b2(*a, **kw)
        with lock:
            out["launches"][getattr(tls, "rid", "?")] += 1
        return res

    def run_bucket(*a, **kw):
        res, info = real_rb(*a, **kw)
        with lock:
            out["rounds"][getattr(tls, "rid", "?")] += info["rounds"]
        return res, info

    def run_batch(self, tickets):
        tls.rid = self.replica_id
        return real_batch(self, tickets)

    rk.rtr_full, server_mod.run_bucket = b2, run_bucket
    server_mod.SolveServer._run_batch = run_batch
    try:
        yield out
    finally:
        rk.rtr_full, server_mod.run_bucket = real_b2, real_rb
        server_mod.SolveServer._run_batch = real_batch
        out["counter"] = rk.LAUNCHES - out["counter"]


def wait_for(pred, timeout: float, what: str, every: float = 0.005):
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, what)
        time.sleep(every)


def snapshot_of(store: Path, sid: str) -> bool:
    """Whether ``sid`` has a finished snapshot in ``store`` (its
    ``snap-<iteration>.npz``, renamed into place; not the ``.tmp`` file
    the store writes first)."""
    d = store / sid
    return d.is_dir() and any(re.fullmatch(r"snap-\d{8}\.npz", f.name)
                              for f in d.iterdir())


def inproc_fleet(n: int, dev, store: Path | None = None, **mgr_kw):
    """A FleetRouter over ``n`` in-process replicas on ``dev`` (one
    ``SolveServer`` each; with ``store`` a shared session store and
    resumed migrations)."""
    from dpgo_tpu_torch.serve import (FleetRouter, ReplicaManager,
                                      SolveServer)

    def make_server(rid):
        return SolveServer(max_batch=8, quantum=SERVE_QUANTUM,
                           batch_window_s=0.0, replica_id=rid, device=dev,
                           session_store=None if store is None
                           else str(store),
                           session_every=1, resume_sessions=store is not None)

    mgr_kw.setdefault("monitor_interval_s", 0.05)
    return FleetRouter(ReplicaManager(make_server, min_replicas=n, **mgr_kw))


def settle(tickets: dict) -> tuple[dict, list]:
    """Each ticket's result, and the sessions lost (their ticket raised)."""
    res, lost = {}, []
    for sid, t in tickets.items():
        try:
            res[sid] = t.result(timeout=600)
        except Exception:
            lost.append(sid)
    return res, lost


def same_result(a, b) -> bool:
    return (a.cost_history == b.cost_history
            and a.grad_norm_history == b.grad_norm_history
            and a.iterations == b.iterations
            and torch.equal(a.T.cpu(), b.T.cpu()))


def fleet_affinity(reqs, dev, card: str, tmp: Path) -> dict:
    """Gate 1: eight session-tagged stand-in requests, twice each, through
    a 2-replica fleet: each lands on its rendezvous replica both times, and
    each result is within SERVE_COST_RTOL of the same request on a lone
    ``SolveServer``.  Also requests/s of 1 and 2 replicas over the eight
    requests, each arm twice (a record, not a throughput benchmark)."""
    from dpgo_tpu_torch.serve import SolveServer
    from dpgo_tpu_torch.serve.fleet import router as router_mod

    sids = [f"fleet-{n}-{seed}" for (n, seed), _ in reqs]
    with SolveServer(max_batch=8, quantum=SERVE_QUANTUM, batch_window_s=0.0,
                     device=dev) as lone:
        ref = [lone.solve(fleet_request(m), timeout=600) for _, m in reqs]
    placed, rel, twins = [], [], True
    with inproc_fleet(2, dev, tmp / "affinity_sessions") as router:
        ids = [r.replica_id for r in router.manager.replicas()]
        for rep in range(2):
            tickets = [router.submit(fleet_request(m, sid=s))
                       for s, (_, m) in zip(sids, reqs)]
            res = [t.result(timeout=600) for t in tickets]
            placed.append([t._replica.replica_id for t in tickets])
            rel += [abs(r.cost_history[-1] - f.cost_history[-1])
                    / abs(f.cost_history[-1]) for r, f in zip(res, ref)]
            if rep == 0:
                first = res
            else:
                twins &= all(same_result(a, b) for a, b in zip(first, res))
        st = router.status()
    want = [max(ids, key=lambda r: router_mod._hrw_weight(f"s|{s}", r))
            for s in sids]
    # Requests/s of 1 and 2 replicas, a record only: every replica warmed
    # by one request first, the arms in both orders.
    rps = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        with inproc_fleet(n, dev) as router:
            for rep_ in router.manager.replicas():
                rep_.server.solve(fleet_request(reqs[0][1]), timeout=600)
            t0 = time.perf_counter()
            tickets = [router.submit(fleet_request(m)) for _, m in reqs]
            for t in tickets:
                t.result(timeout=600)
            rps[n].append(len(reqs) / (time.perf_counter() - t0))
    emit({"phase": "fleet", "check": "affinity", "card": card,
          "sessions": len(sids), "replicas": ids, "placed": placed,
          "rendezvous": want, "requests_routed": st["requests_routed"],
          "cost_rel_to_lone_server": rel, "repeats_bitwise_equal": twins,
          "requests_per_s": {str(k): v for k, v in rps.items()},
          "requests_per_s_window": len(reqs)})
    check(placed[0] == placed[1] == want,
          "a session left its rendezvous replica")
    check(len(set(want)) == 2, "the eight sessions hashed onto one replica")
    check(max(rel) <= SERVE_COST_RTOL, "a fleet result leaves the lone "
          "server's cost by more than 1e-5")
    return rps


def fleet_drain(meas, dev, card: str, tmp: Path) -> None:
    """Gate 2: a long session-tagged solve stopped mid-flight by
    ``router.migrate_from`` resumes from its boundary snapshot on the other
    replica and ends bit for bit where the uninterrupted solve does."""
    from dpgo_tpu_torch.serve import SolveServer

    req = fleet_request(meas, sid="fleet-drain", rounds=FLEET_LONG_ROUNDS)
    with SolveServer(max_batch=8, quantum=SERVE_QUANTUM, batch_window_s=0.0,
                     device=dev, session_store=str(tmp / "drain_base"),
                     session_every=1) as lone:
        base = lone.solve(req, timeout=600)
    store = tmp / "drain_sessions"
    with inproc_fleet(2, dev, store) as router:
        t = router.submit(req)
        wait_for(lambda: snapshot_of(store, "fleet-drain"), 120,
                 "no boundary snapshot before the drain")
        src = t._replica
        moved = router.migrate_from(src)
        res = t.result(timeout=600)
        dst = t._replica
    m = len(res.cost_history)
    suffix = (res.cost_history == base.cost_history[-m:]
              and res.grad_norm_history == base.grad_norm_history[-m:])
    bitwise = suffix and torch.equal(res.T.cpu(), base.T.cpu())
    emit({"phase": "fleet", "check": "drain_migration", "card": card,
          "rounds": FLEET_LONG_ROUNDS, "moved": moved,
          "from": src.replica_id, "to": dst.replica_id,
          "resumed_evals": m, "base_evals": len(base.cost_history),
          "recovered": res.recovered, "bitwise_equal": bitwise,
          "cost": res.cost_history[-1]})
    check(moved == 1 and t.migrations == 1 and dst is not src,
          "the drain did not migrate the session")
    check(res.recovered and 0 < m < len(base.cost_history),
          "the migrated session did not resume from a snapshot")
    check(bitwise, "the migrated session leaves the uninterrupted solve")


def fleet_kill_and_scale(reqs, dev, card: str, tmp: Path) -> None:
    """Gate 3: ``kill_replica`` with sessions in flight loses none and the
    pool respawns to ``min_replicas``; a zero queue-wait SLO scales the
    pool up, and ``scale_down()`` returns it to its minimum."""
    store = tmp / "kill_sessions"
    with inproc_fleet(2, dev, store) as router:
        mgr = router.manager
        tickets = {f"fleet-kill-{i}": router.submit(fleet_request(
            m, sid=f"fleet-kill-{i}", rounds=FLEET_LONG_ROUNDS))
            for i, (_, m) in enumerate(reqs[:3])}
        first = next(iter(tickets))
        wait_for(lambda: snapshot_of(store, first), 120,
                 "no snapshot before the kill")
        victim = tickets[first]._replica
        mgr.kill_replica(victim.replica_id)
        res, lost = settle(tickets)
        migrations = router.status()["migrations"]
        wait_for(lambda: len(mgr.replicas()) == 2, 120,
                 "the pool did not respawn")
        kill_st = mgr.status()
    router = inproc_fleet(1, dev, max_replicas=2, queue_wait_slo_s=0.0,
                          min_scale_observations=2, scale_cooldown_s=0.2,
                          scale_window_s=60.0)
    mgr = router.manager
    try:
        n = 0
        deadline = time.monotonic() + 120
        while mgr.status()["scale_ups"] < 1:
            router.solve(fleet_request(reqs[0][1], rounds=FLEET_EVAL),
                         timeout=600)
            n += 1
            check(time.monotonic() < deadline, "the autoscaler never "
                  "scaled up under a zero queue-wait SLO")
        up = len(mgr.replicas())
        down = mgr.scale_down()
        scale_st = mgr.status()
    finally:
        router.close()
    emit({"phase": "fleet", "check": "kill_and_scale", "card": card,
          "victim": victim.replica_id, "sessions": len(tickets),
          "lost": lost, "migrations": migrations,
          "terminated_by": {s: r.terminated_by for s, r in res.items()},
          "recovered": [s for s, r in res.items() if r.recovered],
          "respawns": kill_st["respawns"], "pool": kill_st["pool"],
          "requests_to_scale_up": n, "pool_after_scale_up": up,
          "scale_down": down, "scale": {k: scale_st[k] for k in (
              "scale_ups", "scale_downs", "pool")}})
    check(lost == [] and migrations >= 1 and res[first].recovered,
          "a session was lost, or none migrated, or the in-flight one did "
          "not resume from its snapshot, when its replica died")
    check(kill_st["respawns"] >= 1 and victim.replica_id
          not in kill_st["pool"], "the pool did not respawn after the kill")
    check(up == 2 and down and len(scale_st["pool"]) == 1,
          "the autoscaler did not scale up and back down")


def child_b2(tdir: Path) -> tuple[int, int]:
    """A child replica's B2 launches and rounds, from its telemetry: the
    ``device_dispatch`` spans of its batches (a killed child's up to its
    last finished dispatch window)."""
    from dpgo_tpu_torch import obs

    spans = [e for e in obs.read_events(str(tdir / "events.jsonl"))
             if e.get("event") == "span"
             and e.get("name") == "device_dispatch"]
    return (sum(int(e.get("b2_launches", 0)) for e in spans),
            sum(int(e.get("rounds", 0)) for e in spans))


def child_compile_seconds(tdir: Path) -> float:
    """``serve_compile_seconds_total`` from a closed child's metrics."""
    with open(tdir / "metrics.json") as fh:
        fam = json.load(fh)["metrics"].get("serve_compile_seconds_total")
    return sum(float(s["value"]) for s in fam["series"]) if fam else 0.0


def child_compiles(tdir: Path) -> list:
    """A child's artifact-tier ``compile_profile`` events: how its kernel
    library was bound (a disk hit and its load seconds, or a build and
    whether nvcc ran).  The programs' first-call records share the event
    name and carry no ``disk_hit``."""
    from dpgo_tpu_torch import obs

    return [{k: e[k] for k in ("label", "disk_hit", "nvcc", "load_s",
                               "build_s") if k in e}
            for e in obs.read_events(str(tdir / "events.jsonl"))
            if e.get("event") == "compile_profile" and "disk_hit" in e]


def proc_server(rid: str, dev, tmp: Path, aot: Path, **kw):
    from dpgo_tpu_torch.serve.fleet import ProcServer

    return ProcServer(replica_id=rid, max_batch=8, batch_window_s=0.0,
                      device=str(dev), aot_cache_dir=str(aot),
                      telemetry_dir=str(tmp / f"child-{rid}"),
                      workdir=str(tmp), **kw)


def first_solve(submit, req) -> tuple:
    """``submit(req)``'s ticket, its result and its wall."""
    t0 = time.perf_counter()
    t = submit(req)
    res = t.result(timeout=600)
    return t, res, time.perf_counter() - t0


def fleet_children(meas, dev, card: str, tmp: Path) -> int:
    """Gates 4 and 5: child replicas on the card.  Two children behind the
    router share an empty ``aot_cache_dir`` and a session store: the cold
    one's first solve finds the library in ``_build/`` and stores it, the
    warm one's binds it from the tier (no nvcc run,
    ``serve_compile_seconds_total`` 0, the cold one's result bit for bit),
    both over the TCP front-end; the cold one is then killed with
    ``SIGKILL`` with two sessions in flight (dead within the heartbeat
    budget, its sessions finished on the warm one from the shared store).
    A third child finding a corrupted entry quarantines it and still
    serves.  Every child's B2 launches (from its telemetry) equal its
    rounds.  Returns the children's B2 launches."""
    import signal

    from dpgo_tpu_torch.serve import FleetRouter, ReplicaManager

    aot, store = tmp / "aot", tmp / "child_sessions"

    def make_server(rid):
        return proc_server(rid, dev, tmp, aot, session_store=str(store),
                           session_every=1, resume_sessions=True)

    router = FleetRouter(ReplicaManager(make_server, min_replicas=2,
                                        monitor_interval_s=0.2,
                                        respawn=False))
    try:
        cold, warm = router.manager.replicas()
        # Session ids by the child they hash onto.
        cands = [f"child-{i}" for i in range(64)]
        on = {r: [s for s in cands if router._pick(
            fleet_request(meas, sid=s), set()) is r] for r in (cold, warm)}
        check(len(on[cold]) >= 3 and len(on[warm]) >= 2,
              "too few session ids hash onto a child")
        t, cold_res, cold_s = first_solve(
            router.submit, fleet_request(meas, sid=on[cold][0]))
        check(t._replica is cold, "the cold request left its child")
        cold_disk = cold.server._beat_once()["cache"]["disk"]
        t, warm_res, warm_s = first_solve(
            router.submit, fleet_request(meas, sid=on[warm][0]))
        check(t._replica is warm, "the warm request left its child")
        sids = on[cold][1:3] + on[warm][1:2]
        tickets = {s: router.submit(fleet_request(
            meas, sid=s, rounds=FLEET_LONG_ROUNDS)) for s in sids}
        wait_for(lambda: snapshot_of(store, sids[0]), 300,
                 "no child snapshot before the kill", every=0.02)
        budget = cold.server.heartbeat_s * cold.server.heartbeat_misses
        cold.server.proc.send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        wait_for(lambda: not cold.alive(), budget,
                 "the killed child did not read as dead within the "
                 "heartbeat budget", every=0.001)
        dead_s = time.perf_counter() - t_kill
        res, lost = settle(tickets)
        warm_disk = warm.server._beat_once()["cache"]["disk"]
        migrations = router.status()["migrations"]
    finally:
        router.close()

    entries = sorted(aot.glob("lib-*.so"))
    check(len(entries) == 1, f"the tier holds {len(entries)} entries")
    for entry in entries:
        blob = bytearray(entry.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        entry.write_bytes(bytes(blob))
    bad = proc_server("corrupt", dev, tmp, aot)
    try:
        _, bad_res, _ = first_solve(bad.submit, fleet_request(meas))
        bad_disk = bad._beat_once()["cache"]["disk"]
    finally:
        bad.close()

    rids = [cold.replica_id, warm.replica_id, "corrupt"]
    b2 = {rid: child_b2(tmp / f"child-{rid}") for rid in rids}
    compiles = {rid: child_compiles(tmp / f"child-{rid}") for rid in rids}
    warm_compile_s = child_compile_seconds(tmp / f"child-{warm.replica_id}")
    emit({"phase": "fleet", "check": "children", "card": card,
          "cold": cold.replica_id, "warm": warm.replica_id,
          "cold_first_solve_s": cold_s, "warm_first_solve_s": warm_s,
          "cold_disk": cold_disk, "warm_disk": warm_disk,
          "compile_profile": compiles,
          "warm_compile_seconds_total": warm_compile_s,
          "warm_equals_cold_bitwise": same_result(warm_res, cold_res),
          "killed_sessions": sids[:2], "dead_after_s": dead_s,
          "heartbeat_budget_s": budget, "lost": lost,
          "migrations": migrations,
          "terminated_by": {s: r.terminated_by for s, r in res.items()},
          "recovered": [s for s, r in res.items() if r.recovered],
          "corrupt_disk": bad_disk,
          "corrupt_equals_cold_bitwise": same_result(bad_res, cold_res),
          "b2_launches_and_rounds": b2})
    check(cold_disk["disk_misses"] == 1 and cold_disk["stores"] == 1
          and not any(e.get("nvcc") for e in compiles[cold.replica_id]),
          "the cold child did not find the built library and store it")
    check(warm_disk["disk_hits"] >= 1 and warm_disk["disk_misses"] == 0
          and any(e.get("disk_hit") for e in compiles[warm.replica_id])
          and not any(e.get("nvcc") for e in compiles[warm.replica_id]),
          "the warm child did not bind the library from the disk tier")
    check(warm_compile_s == 0.0,
          "the warm child's serve_compile_seconds_total is not 0")
    check(same_result(warm_res, cold_res),
          "the warm child's result differs from the cold child's")
    check(lost == [] and migrations >= 1,
          "a child's session was lost, or none migrated, after kill -9")
    check(res[sids[0]].recovered, "the killed child's in-flight session "
          "did not resume from the shared session store")
    check(bad_disk["quarantined"] == 1 and bad_disk["stores"] == 1
          and same_result(bad_res, cold_res),
          "the corrupted entry was not quarantined, or the child did not "
          "serve")
    for rid, (n, rounds) in b2.items():
        check(n == rounds and n > 0, f"child {rid} launched B2 {n} times "
              f"in {rounds} rounds")
    return sum(n for n, _ in b2.values())


def fleet_phase(dev, card: str, tmp: Path) -> int:
    """The serving fleet on the card (``dpgo_tpu_torch.serve.fleet``; after
    ``serve``), on the serve phase's stand-in requests.  Returns B2's
    launches on the fleet's paths (the replicas in process and in the
    children) and those of its lone reference servers (the serve path)."""
    t0 = time.perf_counter()
    reqs = serve_requests()
    tmp = tmp / "fleet"
    tmp.mkdir()
    with fleet_tally() as tally:
        rps = fleet_affinity(reqs, dev, card, tmp)
        fleet_drain(reqs[0][1], dev, card, tmp)
        fleet_kill_and_scale(reqs, dev, card, tmp)
    per = {str(k): (tally["launches"][k], tally["rounds"][k])
           for k in sorted(set(tally["launches"]) | set(tally["rounds"]),
                           key=str)}
    # The lone reference servers (replica id None) are the serve path.
    lone = per.pop("None", (0, 0))
    emit({"phase": "fleet", "check": "in_process_b2", "card": card,
          "b2_launches_and_rounds_by_replica": per,
          "lone_server_b2_launches_and_rounds": lone,
          "launch_counter": tally["counter"]})
    check(all(n == r for n, r in [*per.values(), lone])
          and sum(n for n, _ in per.values()) + lone[0] == tally["counter"],
          "an in-process replica's B2 launches are not its rounds")
    check(all(per[r][0] > 0 for r in ("r0", "r1")),
          "an in-process replica launched no B2")
    children = fleet_children(reqs[0][1], dev, card, tmp)
    inproc = sum(n for n, _ in per.values())
    emit({"phase": "fleet", "check": "time", "card": card,
          "seconds": time.perf_counter() - t0,
          "b2_launches": inproc + children, "b2_in_process": inproc,
          "b2_children": children, "b2_lone_servers": lone[0],
          "requests_per_s": {str(k): v for k, v in rps.items()}})
    return inproc + children, lone[0]


def orbax_phase(prob, params, traj_limit: float, dev, card: str,
                tmp: Path) -> int:
    """The Orbax checkpoint pair on the card's machine, which has no
    ``orbax``, ``tensorstore`` or ``zstandard``: (a) the committed
    checkpoint the JAX package wrote loads bit for bit; (b) a solve
    checkpointed after 25 rounds resumes on a fresh state and, 15 rounds
    on, is within ``traj_limit`` of the uninterrupted 40; (c) save and
    load at config #5's shapes, timed; (d) no foreign module loaded.
    Returns (b)'s B2 launches."""
    t0 = time.perf_counter()
    got = logger.load_checkpoint_orbax(str(ORBAX_FIXTURE))
    fixture_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    want_X = rng.standard_normal((2, 40, 5, 4)).astype(np.float32)
    want_w = rng.uniform(size=(2, 50))
    exact = (got.X.dtype == want_X.dtype and got.X.tobytes()
             == want_X.tobytes() and got.weights.dtype == want_w.dtype
             and got.weights.tobytes() == want_w.tobytes()
             and got.mu == 0.25 and got.iteration == 17)
    emit({"phase": "orbax", "check": "jax_fixture", "card": card,
          "X": [list(got.X.shape), str(got.X.dtype)],
          "weights": [list(got.weights.shape), str(got.weights.dtype)],
          "bit_for_bit": exact, "load_s": fixture_s})
    check(exact, "the JAX package's Orbax checkpoint does not load bit for "
          "bit")

    graph, meta = prob.graph, prob.meta
    first, then = ORBAX_ROUNDS
    where = tmp / "orbax_resume"
    rk.LAUNCHES = 0
    st = rbcd.rbcd_steps(rbcd.init_state(graph, meta, prob.X0, params),
                         graph, first, meta, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logger.save_checkpoint_orbax(logger.Checkpoint(
        X=st.X, weights=st.weights, mu=float(st.mu),
        iteration=st.iteration), str(where))
    save_s = time.perf_counter() - t0
    full = rbcd.rbcd_steps(st, graph, then, meta, params)
    fresh = rbcd.init_state(graph, meta, prob.X0, params)
    t0 = time.perf_counter()
    ck = logger.load_checkpoint_orbax(str(where), like=logger.Checkpoint(
        X=fresh.X, weights=fresh.weights, mu=0.0, iteration=0))
    resumed = fresh._replace(
        X=torch.from_numpy(ck.X).to(dev),
        weights=torch.from_numpy(ck.weights).to(dev),
        mu=torch.tensor(ck.mu, dtype=fresh.mu.dtype, device=dev),
        iteration=ck.iteration)
    resumed = rbcd.refresh_problem(resumed, graph, meta, params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed = rbcd.rbcd_steps(resumed, graph, first + then - ck.iteration,
                              meta, params)
    torch.cuda.synchronize()
    launches = rk.LAUNCHES
    gap = float((resumed.X - full.X).abs().max())
    emit({"phase": "orbax", "check": "resume", "card": card,
          "rounds": [first, then], "iteration_saved": ck.iteration,
          "iteration_final": [resumed.iteration, full.iteration],
          "max_abs_dX": gap, "limit": traj_limit,
          "bit_for_bit": bool(torch.equal(resumed.X, full.X)),
          "save_s": save_s, "load_resume_s": load_s,
          "launches": {"rtr_full": launches},
          "rounds_enqueued": 2 * (first + then) - ck.iteration})
    check(resumed.iteration == full.iteration == first + then
          and gap <= traj_limit and bool(torch.isfinite(resumed.X).all()),
          "the resumed solve leaves the uninterrupted one")
    # the 25 rounds, the uninterrupted 15 and the resumed 15
    check(launches == 2 * (first + then) - ck.iteration,
          "the checkpointed solve did not launch B2 once per round")

    gen = torch.Generator(device=dev).manual_seed(5)
    X5 = torch.randn(C5_CHECKPOINT["X"], generator=gen, device=dev)
    w5 = torch.rand(C5_CHECKPOINT["weights"], generator=gen, device=dev,
                    dtype=torch.float64)
    where = tmp / "orbax_config5"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logger.save_checkpoint_orbax(logger.Checkpoint(
        X=X5, weights=w5, mu=1e-3, iteration=2048), str(where))
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in where.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    ck = logger.load_checkpoint_orbax(str(where), like=logger.Checkpoint(
        X=X5, weights=w5, mu=0.0, iteration=0))
    X_back = torch.from_numpy(ck.X).to(dev)
    w_back = torch.from_numpy(ck.weights).to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    exact = torch.equal(X_back, X5) and torch.equal(w_back, w5) \
        and ck.iteration == 2048
    emit({"phase": "orbax", "check": "config5_shapes", "card": card,
          "X": [list(X5.shape), "float32"],
          "weights": [list(w5.shape), "float64"], "bytes_written": nbytes,
          "array_bytes": X5.numel() * 4 + w5.numel() * 8,
          "save_s": save_s, "load_to_device_s": load_s,
          "bit_for_bit": exact})
    check(exact, "a config #5-size checkpoint does not round-trip")
    del X5, w5, X_back, w_back

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in FOREIGN_MODULES)
    emit({"phase": "orbax", "check": "modules", "card": card,
          "absent": list(FOREIGN_MODULES), "loaded": foreign})
    check(not foreign, f"the port loaded {foreign}")
    return launches


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

    # The stand-in, and the certify phase's float64 parts on the card (they
    # launch no kernel of the library) while nvcc builds it.
    meas = make_measurements(np.random.default_rng(0), n=N_POSES, d=3,
                             num_lc=NUM_LC, rot_noise=0.01,
                             trans_noise=0.01)[0]
    t0 = time.perf_counter()
    lib_path, (f_star, cert_f64_s), build_s = build_beside(
        lambda: certify_f64(meas, dev, card))
    emit({"phase": "build", "check": "beside", "work": "certify_f64",
          "work_seconds": cert_f64_s, "build_seconds": build_s,
          "nvcc_nice": NVCC_NICE, "seconds": time.perf_counter() - t0})
    rk.load()
    # The native g2o loader and planner (host code, g++), built here
    # before the first problem build plans its topology through it.
    t0 = time.perf_counter()
    native_lib = native_io.build()
    native_s = time.perf_counter() - t0
    emit({"phase": "build", "check": "cold_build", "seconds": build_s,
          "nvcc_ran": rk.NVCC_RUNS > 0, "cpu_count": os.cpu_count(),
          "parts_per_source": rk.BUILD_PARTS,
          "unit_seconds": rk.BUILD_SECONDS})
    emit({"phase": "build", "seconds": build_s, "library": lib_path.name,
          "native_seconds": native_s, "native_library": native_lib.name,
          "ptxas": ptxas_report(rk.BUILD_LOG)})
    lap("build")
    emit({"phase": "kernels", "kernels": [
        {"name": "rtr_full", "replaces": "pallas_tcg._rtr_full_kernel"},
        {"name": "tcg", "replaces": "pallas_tcg._tcg_kernel"},
        {"name": "rtr", "replaces": "pallas_tcg._rtr_kernel"},
        {"name": "rtr_refine_full",
         "replaces": "pallas_tcg._rtr_refine_full_kernel"}]})

    # --- parity: each kernel against its plain version, same inputs ----
    params = AgentParams(d=3, r=RANK, num_robots=ROBOTS)
    prob = rbcd.prepare_problem(meas, ROBOTS, params, device=dev)
    graph, meta = prob.graph, prob.meta
    kw = rbcd.kernel_options(params, meta)
    b3_kw = {k: v for k, v in kw.items() if k != "grad_tol"}
    # B2 and B3 at two operand sets: the chordal init (the main path's
    # first round) and the float32 floor.
    floor = rbcd.rbcd_steps(rbcd.init_state(graph, meta, prob.X0, params),
                            graph, FLOOR_ROUNDS, meta, params)
    sets = {"chordal_init": operand_sets(prob, params, prob.X0),
            "float32_floor": operand_sets(prob, params, floor.X)}
    ops, b3_ops = sets["chordal_init"]
    tcg_ops = tcg_operands(b3_ops)
    plans = {k: plan_of(ops, kw, k) for k in rk.KERNELS}
    emit({"phase": "plan", "n_max": meta.n_max, "e_max": meta.e_max,
          "kinc": ops["inc_slot"].shape[-1],
          "kernels": {k: {**p._asdict(), "ctas": ROBOTS * max(p.C, 1)}
                      for k, p in plans.items()}})
    check(all(p.route == "cluster" and p.C > 1 for p in plans.values()),
          "a kernel does not take clusters of several CTAs at the slice "
          "shape")
    errs, outs = {"rtr_full": 0.0, "rtr": 0.0}, {}
    flips = {"rtr_full": 0, "rtr": 0}
    for where, (o2, o3) in sets.items():
        for tag, p2, p3 in ((where, o2, o3),
                            (f"{where}, agent 0", first_agent(o2),
                             first_agent(o3))):
            floor_set = where == "float32_floor"
            row2, out2 = kernel_parity(rk.rtr_full, rk.rtr_full_reference,
                                       p2, kw, tag, floor_set)
            row3, out3 = kernel_parity(rk.rtr, rk.rtr_reference, p3, b3_kw,
                                       tag, floor_set)
            # At the floor an agent whose accept decision flipped on
            # rounding ends at another iterate; the error is the agreeing
            # agents' and the flips are counted beside it.
            for name, row in (("rtr_full", row2), ("rtr", row3)):
                errs[name] = max(errs[name], row.get("max_abs_dX_agreeing",
                                                     row["max_abs_dX"]))
                flips[name] += row["stat_flips"]
            outs[tag] = (out2, out3)
    b3_against_b2(b3_ops, b3_kw, outs["chordal_init"][1], ops, kw)

    tkw = dict(r=meta.rank, d=meta.d, e_max=meta.e_max,
               max_iters=params.solver.max_inner_iters,
               kappa=params.solver.tcg_kappa, theta=params.solver.tcg_theta)
    tcg_err = 0.0
    for radius in (0.05, 1.0, 100.0):
        tcg_ops["radius"] = torch.full((ROBOTS,), radius, device=dev)
        tref = rk.tcg_reference(*tcg_ops.values(), **tkw)
        # The planned (cluster) route, then the workspace route.
        for cluster in (None, 0):
            tout = rk.tcg(*tcg_ops.values(), _cluster=cluster, **tkw)
            torch.cuda.synchronize()
            e_eta = float((tout.eta - tref.eta).abs().max())
            # Heta carries the Hessian's scale (edge precisions summed over
            # a pose's degree): its float32 summation-order error is
            # relative.
            e_heta = float((tout.heta - tref.heta).abs().max()
                           / tref.heta.abs().max().clamp(min=1e-30))
            tflips = int((tout.stats != tref.stats).any(1).sum())
            route = plan_of(tcg_ops, tkw, "tcg", cluster)
            if cluster is None:
                tcg_err = max(tcg_err, e_eta)
            emit({"phase": "parity", "kernel": "tcg", "radius": radius,
                  "cuda_route": route.route, "cluster": route.C,
                  "max_abs_d_eta": e_eta, "max_rel_d_heta": e_heta,
                  "stat_flips": tflips, "iters": tout.stats[:, 0].tolist()})
            check(e_eta <= X_ATOL and e_heta <= STAT_RTOL and tflips == 0,
                  f"tcg kernel disagrees with its plain version "
                  f"({route.route} route)")

    # 10 rounds through B2 against the "ell" formulation from the chordal
    # init and preconditioner factors computed on the host.  Two float32
    # trajectories part on their own: the gate is the "ell" formulation's
    # own divergence from starts moved by about one ulp (the kernel's gate
    # is the single-launch parity above).  Then the card's own start
    # (determinism).
    plain = AgentParams(d=3, r=RANK, num_robots=ROBOTS,
                        solver=SolverParams(pallas_tcg=False))
    host = rbcd.prepare_problem(meas, ROBOTS, params, dtype=torch.float32,
                                device="cpu")
    X0_host = host.X0.to(dev)
    chol_host = rbcd.precond_chol(host.graph.edges, host.graph,
                                  params).to(dev)
    ell = rounds_from(X0_host, graph, meta, plain, chol_host)
    traj = [float((rounds_from(X0_host, graph, meta, params, chol_host)
                   - ell).abs().max()) for _ in range(2)]
    ell_spread, moved = [], []
    for seed in range(PERTURBED_STARTS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.randint(-1, 2, X0_host.shape, generator=gen, device=dev)
        X0m = X0_host * (1 + u * 2.0 ** -23)
        ell_m = rounds_from(X0m, graph, meta, plain, chol_host)
        ell_spread.append(float((ell_m - ell).abs().max()))
        moved.append(float((rounds_from(X0m, graph, meta, params, chol_host)
                            - ell_m).abs().max()))
    traj_limit = min(TRAJ_SPREAD * max(ell_spread), TRAJ_MAX)
    emit({"phase": "parity", "kernel": "rtr_full", "rounds": 10,
          "formulations": ["kernel", "ell"], "start": "host chordal init",
          "max_abs_dX": traj[0], "repeat_max_abs_dX": traj[1],
          "ell_ulp_moved_starts_max_abs_dX": ell_spread,
          "limit": traj_limit,
          "kernel_vs_ell_from_moved_starts_max_abs_dX": moved})
    check(max(traj) <= traj_limit,
          "the kernel's 10 rounds leave the plain formulation's by more "
          "than its own one-ulp divergence allows")
    determinism(prob, params, plain, X0_host)
    lap("parity")
    dense_phase(prob, params, X0_host, chol_host, ell, traj_limit, dev, card)
    lap("dense")

    # --- the main path: a first dispatch in the process, then the counted
    # one; under --profile the first one is traced -------------------------
    profile = "--profile" in sys.argv[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob = rbcd.prepare_problem(meas, ROBOTS, params, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    def solve():
        return rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                      grad_norm_tol=GRAD_TOL).iterations
    if profile:
        first = profile_run(solve)
        emit({"phase": "profile", "path": "solve_first", "card": card,
              **first})
        first_s = first["wall_s"]
    else:
        solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
    rk.LAUNCHES = 0
    rk.TCG_LAUNCHES = 0
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = rbcd.dispatch_prepared(prob, max_iters=MAX_ITERS,
                                 grad_norm_tol=GRAD_TOL)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"rtr_full": rk.LAUNCHES, "tcg": rk.TCG_LAUNCHES}
    enqueued = rbcd.rounds_enqueued(res.iterations, params=params,
                                    max_iters=MAX_ITERS, eval_every=1)
    costs = res.cost_history
    emit({"phase": "solve", "poses": N_POSES, "edges": len(meas),
          "robots": ROBOTS, "rank": RANK, "dtype": "float32",
          "iterations": res.iterations, "terminated_by": res.terminated_by,
          "cost_first": costs[0], "cost_final": costs[-1],
          "grad_norm_final": res.grad_norm_history[-1],
          "setup_s": t1 - t0, "first_solve_s": first_s,
          "first_traced": profile, "solve_s": t3 - t2,
          "rounds_per_s": res.iterations / (t3 - t2),
          "launches": launches, "rounds_enqueued": enqueued})
    check(res.T.shape == (N_POSES, 3, 4) and bool(torch.isfinite(res.T)
                                                   .all()),
          "the rounded trajectory is malformed")
    check(bool(np.isfinite(costs).all()
               and np.isfinite(res.grad_norm_history).all()),
          "non-finite cost or gradient norm")
    check(costs[-1] <= costs[0] and costs[-1] <= costs[-2] * (1 + 1e-6),
          "cost rose at the end")
    check(launches["rtr_full"] == enqueued and res.iterations > 0,
          "the solve did not launch the kernel once per enqueued round")

    # --- timing at the slice shape: B2 on the cluster route and on the
    # workspace route, at both operand sets, and at every cluster size ----
    rows = []
    b2_t = {where: route_timing(rk.rtr_full, o2, kw, outs[where][0])
            for where, (o2, _) in sets.items()}
    emit({"phase": "timing", "card": card, "kernel": "rtr_full", **b2_t})
    emit({"phase": "cluster_sweep", "card": card, "kernel": "rtr_full",
          "n_max": meta.n_max, "kinc": ops["inc_slot"].shape[-1],
          "rows": cluster_sweep(rk.rtr_full,
                                {w: o2 for w, (o2, _) in sets.items()},
                                kw)})
    plain_ms = cuda_ms(lambda: rk.rtr_full_reference(*ops.values(), **kw),
                       reps=5, warmup=1)
    nbytes, flops = rtr_full_work(ops, outs["chordal_init"][0], graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    b2_row = {"name": "rtr_full", "route": "cuda",
              "source": "dpgo_tpu_torch/csrc/rtr_cluster.cu",
              "replaces": "dpgo_tpu/ops/pallas_tcg.py:662",
              "launches_by_path": {"solve": launches["rtr_full"]},
              "max_abs_err": errs["rtr_full"],
              "floor_accept_flips": flips["rtr_full"],
              **route_columns(b2_t), "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "bytes": nbytes, "flops": flops}
    rows.append(b2_row)
    tcg_ops["radius"] = torch.ones(ROBOTS, device=dev)
    tout = rk.tcg(*tcg_ops.values(), **tkw)
    b1_t = route_timing(rk.tcg, tcg_ops, tkw, tout)
    t_plain = cuda_ms(lambda: rk.tcg_reference(*tcg_ops.values(), **tkw),
                      reps=5, warmup=1)
    nbytes, flops = tcg_work(tcg_ops, tout, graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    rows.append({"name": "tcg", "route": "cuda",
                 "source": "dpgo_tpu_torch/csrc/rtr_cluster.cu",
                 "replaces": "dpgo_tpu/ops/pallas_tcg.py:599",
                 "launches_by_path": {"solve": launches["tcg"]},
                 "max_abs_err": tcg_err, **one_set_columns(b1_t),
                 "plain_ms": t_plain, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "bytes": nbytes, "flops": flops})
    emit({"phase": "timing", "card": card, "kernel": "tcg", "radius": 1.0,
          **b1_t, "plain_ms": t_plain})
    emit({"phase": "timing", "card": card, "agents": ROBOTS,
          "n_max": meta.n_max, "e_max": meta.e_max,
          "rtr_full_plain_ms": plain_ms,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    if profile:
        emit({"phase": "profile", "path": "solve", "card": card,
              **profile_run(solve)})
    lap("solve")

    # --- the verdict loop: parity with the per-eval run above, a sync-free
    # window, the production arm ---------------------------------------------
    _, verdict_b2 = verdict_parity(prob, res, card)
    verdict_window(prob, params, dev, card)
    prod_row, prod_b2 = production_arm(prob, params, card, profile)
    lap("verdict")
    with tempfile.TemporaryDirectory(dir=native_io.BUILD_DIR) as tmp:
        # --- telemetry on the solve paths (obs run, recorder, devprof) ------
        telemetry_b2 = telemetry_phase(prob, params, dev, card, Path(tmp))
        lap("telemetry")
        # --- the per-robot runtime: each robot's iterate is B2 at A=1 -------
        agents_b2 = agents_phase(meas, prod_row["cost_history"][-1], dev,
                                 card)
        lap("agents")
        # --- the same robots as eight processes over localhost TCP ----------
        tcp_b2 = tcp_phase(meas, prod_row["cost_history"][-1], card,
                           Path(tmp))
        lap("tcp")
        # --- the serving plane: a served batch is one B2 launch per round -
        serve_by, serve_t = serve_phase(dev, card, Path(tmp))
        lap("serve")
        # --- the fleet: replicas in process and as child processes ----------
        fleet_b2, fleet_lone_b2 = fleet_phase(dev, card, Path(tmp))
        lap("fleet")
        # --- config #5 through the main path: B2 and B4 spread --------------
        inst = config5_instance()
        c5 = config5_phase(inst, dev, card)
        lap("config5")
        # --- config #5 over few robots: B2 and B4 on the grid route ---------
        big = big_agents_phase(inst, dev, card)
        lap("big_agents")
        # --- the sharded plane at world size 1 over NCCL --------------------
        sharded_b2, mh_b2, scale_row = sharded_phase(meas, params, dev,
                                                     card, Path(tmp), inst)
        del inst
        lap("sharded")

    # --- the ablation: B3's path ------------------------------------------
    ab = ablate_phase(dev, card)
    b3_t = {where: route_timing(rk.rtr, o3, b3_kw, outs[where][1])
            for where, (_, o3) in sets.items()}
    plain_ms = cuda_ms(lambda: rk.rtr_reference(*b3_ops.values(), **b3_kw),
                       reps=5, warmup=1)
    nbytes, flops = rtr_work(b3_ops, outs["chordal_init"][1], graph, meta)
    b_ms, b_by = bound(nbytes, flops)
    emit({"phase": "timing", "card": card, "kernel": "rtr", **b3_t,
          "plain_ms": plain_ms})
    rows.append({"name": "rtr", "route": "cuda",
                 "source": "dpgo_tpu_torch/csrc/rtr_cluster.cu",
                 "replaces": "dpgo_tpu/ops/pallas_tcg.py:614",
                 "launches_by_path": {"ablate": ab["rtr"]},
                 "max_abs_err": errs["rtr"],
                 "floor_accept_flips": flips["rtr"], **route_columns(b3_t),
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, "bytes": nbytes, "flops": flops})
    lap("ablate")

    # --- the rest of the round: every schedule, Nesterov, GNC --------------
    sched_b2 = schedules_phase(prob, dev, card)
    lap("schedules")
    odo_b2 = odometry_phase(prob, meas, params, dev, card)
    lap("odometry_init")
    iter_b2 = robust_iterated_phase(dev, card)
    lap("robust_iterated")
    dist_b2, chordal_b2 = dist_init_phase(prob, meas, params, dev, card)
    lap("dist_init")

    b4_row, descent_b2 = refine_phase(prob, meas, card, profile)
    rows.append(b4_row)
    lap("refine")
    cert_b2 = certify_phase(meas, params, dev, card, cert_f64_s)
    lap("certify")
    fused_b2, fused_b4 = fused_refine_phase(meas, f_star, dev, card)
    lap("fused_refine")

    # --- every rank of the staircase: B1-B4 at each (r, d) -----------------
    se2 = se2_standin()
    ranks = ranks_phase({3: (meas, ROBOTS, refine.host_edges_f64(meas)),
                         2: (se2, SE2_ROBOTS, refine.host_edges_f64(se2))},
                        dev, card)
    lap("ranks")
    # --- the f32 distributed staircase above rank 5 --------------------------
    stair_b2, stair_b4 = staircase_f32("sphere", meas, ROBOTS, STAIR_SPHERE,
                                       dev, card)
    lap("staircase")
    # --- SE(2) end to end: the GNC solve, then the f32 staircase ------------
    se2_l = se2_phase(se2, dev, card)
    lap("se2")
    # --- above the templated ranks: the rank-generic instantiation --------
    grid = smallgrid_standin()
    high = high_ranks_phase(
        [("sphere2500", meas, ROBOTS, refine.host_edges_f64(meas),
          HIGH_RANKS[3]),
         ("se2", se2, SE2_ROBOTS, refine.host_edges_f64(se2), HIGH_RANKS[2]),
         ("smallgrid3d", grid, TOP_ROBOTS, refine.host_edges_f64(grid),
          TOP_RANKS)]
        + [(f"16_pose_agents_d{d}", m, 2, refine.host_edges_f64(m), (r,))
           for d, r in SMALL_AGENT_TOP_RANKS.items()
           for m in [small_agents_standin(d)]], dev, card)
    ab_high = ablate_high(high, dev, card)
    high_b2, high_b4 = staircase_f32("sphere_r11", meas, ROBOTS,
                                     STAIR_HIGH, dev, card)
    stair_fold = {k: sum(n for (kk, _), n in rk.FOLD_LAUNCHES.items()
                         if kk == k) for k in rk.FOLD_KERNELS}
    for kernel, n in stair_fold.items():
        folded = high["layouts"][kernel]["11,3"]["plan"]["lanes"] > 0
        check((n > 0) == folded, f"the staircase from r = 11 launched "
              f"{kernel}'s folded cluster layout {n} times, where the plan "
              f"at (11, 3) is {high['layouts'][kernel]['11,3']['plan']}")
    lap("high_ranks")
    # --- the main path at the top ranks: r = 256 and the gate's 1636 -------
    top = top_ranks_path(grid, dev, card)
    lap("top_ranks")
    # --- the Orbax checkpoint pair: the JAX package's layout, no orbax -----
    with tempfile.TemporaryDirectory(dir=native_io.BUILD_DIR) as tmp:
        orbax_b2 = orbax_phase(prob, params, traj_limit, dev, card,
                               Path(tmp))
    lap("orbax")
    b4_row["launches_by_path"].update(fused_refine=fused_b4,
                                      staircase=stair_b4,
                                      se2=se2_l["staircase_b4"])
    b2_row["launches_by_path"].update(
        ablate=ab["rtr_full"], schedules=sched_b2, refine=descent_b2,
        verdict=verdict_b2 + prod_b2 + chordal_b2, odometry_init=odo_b2,
        robust_iterated=iter_b2, certify=cert_b2, dist_init=dist_b2,
        dense=0, fused_refine=fused_b2, agents=agents_b2,
        telemetry=telemetry_b2, tcp=tcp_b2, serve=sum(serve_by.values()) + fleet_lone_b2,
        fleet=fleet_b2, sharded=sharded_b2, sharded_multihost=mh_b2,
        staircase=stair_b2, se2=se2_l["gnc"] + se2_l["staircase_b2"],
        orbax=orbax_b2)
    b2_row["serve_launches_by_agents"] = serve_by
    b2_row["sharded_config5"] = {k: scale_row[k] for k in (
        "b2_ms_per_launch", "b2_route", "b2_cluster", "b2_bound_ms",
        "b2_bound_by", "ms_per_round", "n_max", "peak_memory_bytes")}
    b2_row["serve_64_agents"] = {k: serve_t[k] for k in (
        "ms", "ms_single_cta", "bound_ms", "bound_by", "cluster", "ctas")}
    for row in rows:
        row["routes"] = {k: ROUTE_SOURCES[k] for k in ("cluster",
                                                       "workspace")}
        row["routes"]["spread"] = f"{row['name']}_spread"
        # The (r, d) each route ran at in this script (the ranks phase),
        # and its largest error there (X, eta or D, as the row's kernel).
        row["shapes"] = ranks["shapes"][row["name"]]
        row["max_abs_err_ranks"] = ranks["max_abs_err"][row["name"]]
        row["perf_shapes"] = {k: v[row["name"]]
                              for k, v in ranks["perf_shapes"].items()}
    for row in c5["rows"]:
        kernel = row["name"].removesuffix("_spread")
        if "by_rank" in row:
            row["shapes"] = {"spread": [[RANK, 3]] + [
                [r, 3] for r in row["by_rank"]]}
        else:
            # B3 and B1: config #5, and every (r, d) of high_ranks where
            # the plan took the spread route; B3's launches on its path.
            row["shapes"] = {"spread": [[RANK, 3]] + [
                [int(x) for x in rd.split(",")]
                for rd, hr in high["rows"][kernel].items()
                if hr["route"] == "spread"]}
            row["launches_by_path"] = {
                k: n for k, n in ab_high.get(kernel, {}).items()
                if HIGH_ABLATE_RANKS[int(k.removeprefix("ablate_r"))]
                == "spread"}
    rows.extend(c5["rows"])
    rows.extend(big["rows"])
    rows.extend(generic_rows(high, {
        "tcg": {}, "rtr": ab_high["rtr"],
        "rtr_full": {**ab_high["rtr_full"],
                     "staircase_r11": high_b2 - stair_fold["rtr_full"],
                     **top["rtr_full"]},
        "rtr_refine_full": {
            "staircase_r11": high_b4 - stair_fold["rtr_refine_full"],
            **top["rtr_refine_full"]}}))
    rows.extend(cluster_fold_rows(high, {
        "rtr_full": {**ab_high["rtr_full_cluster_fold"],
                     "staircase_r11": stair_fold["rtr_full"]},
        "rtr_refine_full": {
            "staircase_r11": stair_fold["rtr_refine_full"]}}))
    for row in rows:
        row["launches"] = sum(row["launches_by_path"].values())
    rows.sort(key=lambda r: (r["replaces"], r["name"]))

    emit({"phase": "time", "seconds": time.perf_counter() - T_START})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
