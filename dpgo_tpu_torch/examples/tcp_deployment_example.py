"""N-process TCP deployment of the PyTorch port (the counterpart of the
JAX package's ``examples/tcp_deployment_example.py``).

Each robot is its own OS process holding one ``agent.PGOAgent``; the
deployment message set — packed public-pose sets, status gossip, GNC
weight publication, the lifting matrix and the global anchor — travels
over localhost TCP as the ``comms`` package's length-prefixed frames
(byte-identical to the JAX package's, so a JAX robot and a port robot can
share one bus).  The launcher doubles as the message bus.  ``--staleness
1`` overlaps each robot's step with its round's exchange; the default 0
keeps the deterministic lockstep schedule.

Every robot runs on ``--device`` (default ``cuda``): on one card the N
processes share it, each with its own CUDA context, and each robot's
iterate is one launch of the B2 kernel at A=1 (``rbcd._agent_update``).
The launcher builds the kernel library and the native g2o library before
it spawns the robots (they only load them) and touches no CUDA itself.
Tests pass ``--device cpu``.

Fault tolerance rides ``comms``: per-message deadlines, bounded retry,
sequence numbers, heartbeat liveness, and graceful degradation — a robot
that dies mid-solve is detected by the bus, announced to the survivors
(``_lost``), excluded from their termination quorum, and the remaining
team finishes.

Modes:

* ``--mode sync`` (default): each robot takes one ``iterate()`` per bus
  round (deterministic with no faults injected).
* ``--mode async``: each robot runs its Poisson-clock optimization thread
  (``start_optimization_loop``) while the main thread exchanges poses at
  the bus cadence.

Usage (the launcher spawns all robot processes and assembles the result):
    python -m dpgo_tpu_torch.examples.tcp_deployment_example DATA.g2o \\
        [--robots 2] [--rank 5] [--rounds 120] [--mode sync|async] \\
        [--robust] [--port 0] [--out-dir DIR] [--telemetry] \\
        [--device cuda|cpu]

The last line of standard output is one JSON object: ``cost`` (the
survivors' SE(d) cost in float64), ``states``, ``iterations``,
``bytes_sent``, ``lost`` and ``out_dir``.  Each robot also writes
``OUT_DIR/robot<id>.npz`` with its trajectory and its counts:
``b2_launches`` (``ops.rtr_kernel.LAUNCHES``), ``iterates`` and
``stepped`` (``iterate()`` calls and those that took a step),
``host_reads`` (``agent.HOST_READS``, JSON), ``step_device_s`` (on CUDA,
the CUDA-event time of its steps) and ``solve_wall_s``.

Internal per-robot entry (what the launcher spawns; the launcher binds the
listener first and passes the resolved port down):
    ... --robot ID --port P
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

#: The checkout holding the ``dpgo_tpu_torch`` package (the robots run it
#: with ``python -m``).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_injector(args, seed_offset: int):
    """Build the (initially disabled) per-process fault injector, or None
    when no fault flag is set.  The lifting-matrix broadcast and the final
    anchor sync always run clean; faults cover only solve rounds."""
    from dpgo_tpu_torch.comms import FaultInjector, FaultSpec

    spec = FaultSpec(drop=args.fault_drop, delay=args.fault_delay,
                     delay_s=tuple(args.fault_delay_s),
                     reorder=args.fault_reorder, corrupt=args.fault_corrupt)
    if not spec.any_active():
        return None
    inj = FaultInjector(spec, seed=args.fault_seed + seed_offset)
    inj.enabled = False
    return inj


# ---------------------------------------------------------------------------
# One robot process
# ---------------------------------------------------------------------------

class _StepCounts:
    """Counts a robot's ``iterate()`` calls and steps, and on CUDA the
    device time of each step between CUDA events (read once the step has
    finished, so the timing adds no host sync)."""

    def __init__(self, agent, on_cuda: bool):
        import torch

        self.iterates = self.stepped = 0
        self._events: list = []
        self._lock = threading.Lock()
        real_iterate, real_step = agent.iterate, agent._step

        def iterate(do_optimization=True):
            stepped = real_iterate(do_optimization)
            with self._lock:
                self.iterates += 1
                self.stepped += int(stepped)
            return stepped

        def step(X, z):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real_step(X, z)
            e1.record()
            with self._lock:
                self._events.append((e0, e1))
            return out

        agent.iterate = iterate
        if on_cuda:
            agent._step = step

    def device_seconds(self) -> float:
        """The summed step time (waits for the last steps to finish)."""
        with self._lock:
            events = list(self._events)
        if events:
            events[-1][1].synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in events) * 1e-3


def run_robot(args) -> None:
    import torch

    from dpgo_tpu_torch import agent as agent_mod
    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.comms import (BusClient, ReliableChannel,
                                      RetryPolicy, TcpTransport,
                                      TransportClosed, apply_peer_frame,
                                      connect_tcp, pack_agent_frame)
    from dpgo_tpu_torch.config import (AgentParams, RobustCostParams,
                                       RobustCostType)
    from dpgo_tpu_torch.device import resolve_device
    from dpgo_tpu_torch.ops import rtr_kernel
    from dpgo_tpu_torch.utils.g2o import read_g2o
    from dpgo_tpu_torch.utils.partition import (agent_measurements,
                                                partition_contiguous)

    # N robot processes share the host's cores.
    torch.set_num_threads(1)
    rid, rounds, mode, robust = args.robot, args.rounds, args.mode, args.robust
    out_dir = args.out_dir
    dev = resolve_device(args.device)

    # Each robot process scopes its own telemetry run (one run dir per
    # robot, the reference's one-logDirectory-per-process layout).
    run = obs.start_run(
        os.path.join(out_dir, "telemetry", f"robot{rid}")) \
        if args.telemetry else None
    if run is not None:
        run.set_fingerprint(dataset=args.dataset, num_robots=args.robots,
                            rank=args.rank, robust=robust)

    meas = read_g2o(args.dataset)
    rp = RobustCostParams(cost_type=RobustCostType.GNC_TLS) if robust \
        else RobustCostParams()
    params = AgentParams(d=meas.d, r=args.rank, num_robots=args.robots,
                         robust=rp)
    part = partition_contiguous(meas, args.robots)
    agent = agent_mod.PGOAgent(rid, params, device=dev)
    counts = _StepCounts(agent, on_cuda=dev.type == "cuda")

    injector = make_injector(args, seed_offset=rid)
    sock = connect_tcp("127.0.0.1", args.port)
    wire_v2 = args.wire == "v2"
    transport = TcpTransport(sock, src=f"robot{rid}", dst="bus",
                             injector=injector,
                             wire_format="packed" if wire_v2 else "npz")
    policy = RetryPolicy(send_timeout_s=args.round_timeout,
                         recv_timeout_s=args.round_timeout)
    client = BusClient(ReliableChannel(transport, f"robot{rid}->bus",
                                       policy), rid)
    client.hello(timeout=30.0)
    client.channel.start_heartbeat(args.heartbeat_s)

    # Lifting-matrix broadcast (robot 0 self-generates; reference
    # MultiRobotExample.cpp:139-146) — rides the first bus round, clean.
    first = {"ylift": agent.get_lifting_matrix()} if rid == 0 else {}
    merged = client.exchange(first, timeout=60.0)
    for _ in range(3):
        if rid == 0 or (merged is not None and "r0|ylift" in merged):
            break
        merged = client.collect(timeout=60.0)
    if rid != 0:
        if merged is None or "r0|ylift" not in merged:
            raise ConnectionError(f"robot {rid}: lifting matrix never "
                                  "arrived")
        agent.set_lifting_matrix(merged["r0|ylift"])
    agent.set_pose_graph(*agent_measurements(part, rid))

    t_solve = time.perf_counter()
    if mode == "async":
        agent.start_optimization_loop(rate_hz=args.async_rate)

    if injector is not None:
        injector.enabled = True
    # Compute/comm overlap: with --staleness >= 1 a background thread
    # publishes round k's poses and prefetches the broadcast while round
    # k's step runs; --staleness 0 keeps the deterministic lockstep.
    if args.staleness > 0:
        client.start_overlap(args.staleness, timeout=args.round_timeout)
    bus_gone = False
    for it in range(rounds):
        if args.die_at_round is not None and it == args.die_at_round:
            # Simulated mid-solve crash: drop the connection, write no
            # result.  The bus detects the closed transport, announces us
            # in `_lost`, and the survivors finish without us.
            if mode == "async":
                agent.end_optimization_loop()
            client.close()
            return
        frame = pack_agent_frame(agent, robust=robust,
                                 include_anchor=(rid == 0),
                                 wire_dtype=args.wire_dtype,
                                 packed=wire_v2)
        try:
            merged = client.exchange(frame, timeout=args.round_timeout)
        except TransportClosed:
            bus_gone = True  # keep the local result; stop exchanging
            break
        if merged is not None:
            for peer, pf in client.peer_frames(merged).items():
                apply_peer_frame(agent, peer, pf, robust=robust,
                                 accept_anchor=(rid != 0 and peer == 0))
            for lost in client.lost:
                agent.mark_neighbor_lost(lost)
        if mode == "sync":
            agent.iterate(do_optimization=True)
        else:
            time.sleep(1.0 / args.async_rate)
    try:
        client.drain_overlap(timeout=60.0)
    except TransportClosed:
        bus_gone = True
    client.stop_overlap()
    if injector is not None:
        injector.enabled = False

    if mode == "async":
        agent.end_optimization_loop()
    step_device_s = counts.device_seconds()
    solve_wall_s = time.perf_counter() - t_solve

    # Final anchor sync (clean) so all trajectories share one frame; a
    # survivor of a dead robot 0 falls back to the last anchor it cached.
    if not bus_gone:
        try:
            final = {"anchor": np.asarray(agent.get_global_anchor())} \
                if rid == 0 else {}
            merged = client.exchange(final, timeout=60.0)
            if rid != 0 and merged is not None and "r0|anchor" in merged:
                agent.set_global_anchor(merged["r0|anchor"])
        except TransportClosed:
            pass
    client.close()  # emits the comms run_summary into the ambient run

    st = agent.get_status()
    np.savez(os.path.join(out_dir, f"robot{rid}.npz"),
             T=agent.trajectory_in_global_frame(),
             state=np.asarray(st.state.value),
             iterations=np.asarray(st.iteration_number),
             bytes_sent=np.asarray(client.channel.totals.bytes_sent),
             lost=np.asarray(sorted(client.lost), np.int64),
             b2_launches=np.asarray(rtr_kernel.LAUNCHES),
             iterates=np.asarray(counts.iterates),
             stepped=np.asarray(counts.stepped),
             host_reads=np.asarray(json.dumps(dict(agent_mod.HOST_READS))),
             step_device_s=np.asarray(step_device_s),
             solve_wall_s=np.asarray(solve_wall_s),
             device=np.asarray(str(dev)))
    if run is not None:
        t = client.channel.totals
        run.metric("tcp_bytes_sent", t.bytes_sent, "bytes", phase="report",
                   robot=rid, rounds=rounds, mode=mode)
        run.metric("agent_final_iterations", st.iteration_number,
                   phase="report", robot=rid)
        obs.end_run()


# ---------------------------------------------------------------------------
# Launcher: bind the bus, spawn robots, relay rounds, assemble, report
# ---------------------------------------------------------------------------

def prebuild(device: str) -> None:
    """Build the libraries every robot loads, once, before the robots
    start: the kernel library for a CUDA run (``nvcc`` only — no CUDA
    context) and the native g2o library (``g++``; a robot without it reads
    through the Python parser, as the launcher would)."""
    from dpgo_tpu_torch.utils import native_io

    if device.startswith("cuda"):
        from dpgo_tpu_torch.ops import rtr_kernel

        rtr_kernel.build()
    try:
        native_io.build()
    except (OSError, RuntimeError):
        pass


def robot_command(args, rid: int, port: int) -> list:
    """The command line of robot ``rid``'s process."""
    cmd = [sys.executable, "-m", "dpgo_tpu_torch.examples."
           "tcp_deployment_example", args.dataset,
           "--robot", str(rid), "--robots", str(args.robots),
           "--port", str(port), "--rank", str(args.rank),
           "--rounds", str(args.rounds), "--mode", args.mode,
           "--async-rate", str(args.async_rate), "--out-dir", args.out_dir,
           "--round-timeout", str(args.round_timeout),
           "--heartbeat-s", str(args.heartbeat_s),
           "--staleness", str(args.staleness),
           "--wire", args.wire, "--wire-dtype", args.wire_dtype,
           "--fault-drop", str(args.fault_drop),
           "--fault-delay", str(args.fault_delay),
           "--fault-delay-s", str(args.fault_delay_s[0]),
           str(args.fault_delay_s[1]),
           "--fault-reorder", str(args.fault_reorder),
           "--fault-corrupt", str(args.fault_corrupt),
           "--fault-seed", str(args.fault_seed),
           "--device", args.device]
    if args.robust:
        cmd.append("--robust")
    if args.telemetry:
        cmd.append("--telemetry")
    if args.kill_robot is not None and rid == args.kill_robot:
        cmd += ["--die-at-round", str(args.kill_round)]
    return cmd


def survivor_cost(dataset: str, num_robots: int, outs: dict) -> float:
    """The SE(d) cost, in float64 on the host, of the trajectory assembled
    from the robots that wrote a result, over the edges whose both
    endpoints belong to them (a killed robot's block never made it to
    disk)."""
    import torch

    from dpgo_tpu_torch.ops import quadratic
    from dpgo_tpu_torch.types import edge_set_from_measurements
    from dpgo_tpu_torch.utils.g2o import read_g2o
    from dpgo_tpu_torch.utils.partition import partition_contiguous

    meas = read_g2o(dataset)
    part = partition_contiguous(meas, num_robots)
    survivors = sorted(outs)
    d = meas.d
    T = np.zeros((meas.num_poses, d, d + 1))
    for r, o in outs.items():
        ids = part.global_index[r][part.global_index[r] >= 0]
        T[ids] = o["T"]
    # Robot ownership lives in the robot-local view (meas_global keeps
    # r1 == r2 == 0 by construction); the two share row order.
    pm = part.meas
    keep = np.isin(np.asarray(pm.r1), survivors) & \
        np.isin(np.asarray(pm.r2), survivors)
    edges_g = edge_set_from_measurements(part.meas_global.select(keep),
                                         dtype=torch.float64, device="cpu")
    return float(quadratic.cost(torch.from_numpy(T), edges_g))


def launch(args) -> int:
    import subprocess

    from dpgo_tpu_torch import obs
    from dpgo_tpu_torch.comms import RetryPolicy, RoundBus, listen_tcp
    from dpgo_tpu_torch.comms.bus import accept_robots

    args.out_dir = args.out_dir or tempfile.mkdtemp(prefix="dpgo_tcp_")
    os.makedirs(args.out_dir, exist_ok=True)
    out_dir = args.out_dir
    prebuild(args.device)

    # Bind FIRST (port 0 = OS-assigned), then pass the RESOLVED port down
    # on each robot's command line — no ephemeral-port race, no port file.
    srv = listen_tcp(port=args.port)
    port = srv.getsockname()[1]

    run = obs.start_run(os.path.join(out_dir, "telemetry", "bus")) \
        if args.telemetry else None

    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(robot_command(args, rid, port), env=child_env)
             for rid in range(args.robots)]

    injector = make_injector(args, seed_offset=1000)
    channels = accept_robots(
        srv, args.robots, injector=injector,
        policy=RetryPolicy(send_timeout_s=args.round_timeout,
                           recv_timeout_s=args.round_timeout),
        wire_format="packed" if args.wire == "v2" else "npz")
    bus = RoundBus(channels, round_timeout_s=args.round_timeout,
                   miss_limit=3,
                   liveness_timeout_s=max(1.0, 8 * args.heartbeat_s))

    def serve():
        bus.round()                     # lifting-matrix round (clean)
        if injector is not None:
            injector.enabled = True
        bus.serve(args.rounds)          # solve rounds (faults live)
        if injector is not None:
            injector.enabled = False
        bus.round()                     # final anchor round (clean)
        bus.close()                     # aggregated comms run_summary

    bus_thread = threading.Thread(target=serve, daemon=True)
    bus_thread.start()

    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        # A hung/killed robot must not orphan its siblings.
        for p in procs:
            if p.poll() is None:
                p.kill()
    bus_thread.join(timeout=60)
    srv.close()
    if run is not None:
        obs.end_run()
    if any(rcs):
        print(f"robot processes failed: {rcs}", file=sys.stderr)
        return 1

    outs = {}
    for r in range(args.robots):
        path = os.path.join(out_dir, f"robot{r}.npz")
        if os.path.exists(path):
            outs[r] = dict(np.load(path))
    result = {
        "cost": survivor_cost(args.dataset, args.robots, outs),
        "states": [int(outs[r]["state"]) if r in outs else None
                   for r in range(args.robots)],
        "iterations": [int(outs[r]["iterations"]) if r in outs else None
                       for r in range(args.robots)],
        "bytes_sent": [int(outs[r]["bytes_sent"]) if r in outs else None
                       for r in range(args.robots)],
        "lost": sorted(set(range(args.robots)) - set(outs)),
        "out_dir": out_dir,
    }
    print(json.dumps(result))
    if args.telemetry:
        report_telemetry(out_dir, args.robots)
    return 0


def report_telemetry(out_dir: str, num_robots: int) -> None:
    """Render every process's run report and merge the fleet timeline
    (``obs.timeline``: per-process clock offsets estimated from the stamps
    riding heartbeats and traced frames, one Perfetto-loadable trace with
    cross-robot flow arrows) to standard error and ``OUT_DIR/trace.json``."""
    from dpgo_tpu_torch.obs import timeline
    from dpgo_tpu_torch.obs.report import render_report

    tdir = os.path.join(out_dir, "telemetry")
    run_dirs = []
    for sub in ["bus"] + [f"robot{r}" for r in range(num_robots)]:
        rd = os.path.join(tdir, sub)
        if os.path.isdir(rd):
            run_dirs.append(rd)
            print(file=sys.stderr)
            print(render_report(rd), file=sys.stderr)
    try:
        tl = timeline.merge(run_dirs)
        trace_path = timeline.write_chrome_trace(
            os.path.join(out_dir, "trace.json"), tl)
        counts = timeline.validate_chrome_trace(trace_path)
        print(f"\nFleet timeline: {trace_path} "
              f"({counts['spans']} spans, {counts['flows']} flow "
              f"edges) — open in https://ui.perfetto.dev",
              file=sys.stderr)
        for s in tl.offsets["streams"]:
            unc = ("?" if s["uncertainty_s"] is None
                   else f"±{s['uncertainty_s'] * 1e3:.2f}ms")
            print(f"  clock {os.path.basename(s['path'])}: "
                  f"offset {s['offset_s'] * 1e3:+.2f}ms {unc}",
                  file=sys.stderr)
    except ValueError as e:
        print(f"\nFleet timeline export failed: {e}", file=sys.stderr)
    print(f"\nPer-robot telemetry under {tdir} — re-render with: "
          f"python -m dpgo_tpu_torch.obs.report {tdir}/robot<id>; "
          f"re-merge with: python -m dpgo_tpu_torch.obs.timeline {tdir}/*",
          file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m dpgo_tpu_torch.examples.tcp_deployment_example",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--mode", choices=("sync", "async"), default="sync")
    ap.add_argument("--robust", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of every robot process (default cuda: "
                         "the robots share the card; cpu for tests)")
    ap.add_argument("--telemetry", action="store_true",
                    help="telemetry runs (dpgo_tpu_torch.obs) under "
                         "OUT_DIR/telemetry/{bus,robot<id>}, reported "
                         "after the solve")
    ap.add_argument("--async-rate", type=float, default=20.0,
                    help="async mode: per-robot Poisson iterate rate (Hz) "
                         "and the bus exchange cadence")
    ap.add_argument("--round-timeout", type=float, default=120.0,
                    help="per-message send/recv deadline (s).  The large "
                         "default preserves deterministic lockstep on "
                         "fault-free runs; chaos runs should drop it to "
                         "~2s")
    ap.add_argument("--heartbeat-s", type=float, default=0.25,
                    help="robot->bus heartbeat interval (liveness)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="compute/comm overlap bound: >=1 double-buffers "
                         "the exchange; 0 keeps the deterministic lockstep "
                         "schedule")
    ap.add_argument("--wire", choices=("v2", "v1"), default="v2",
                    help="wire format: v2 = packed columnar frames, v1 = "
                         "per-pose npz (old-peer interop)")
    ap.add_argument("--wire-dtype", choices=("f64", "f32", "bf16"),
                    default="f64",
                    help="pose payload dtype on the wire (v2)")
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-delay", type=float, default=0.0)
    ap.add_argument("--fault-delay-s", type=float, nargs=2,
                    default=[0.05, 0.2], metavar=("MIN", "MAX"))
    ap.add_argument("--fault-reorder", type=float, default=0.0)
    ap.add_argument("--fault-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--kill-robot", type=int, default=None,
                    help="launcher: tell this robot to crash mid-solve")
    ap.add_argument("--kill-round", type=int, default=None,
                    help="round at which --kill-robot dies")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--robot", type=int, default=None,
                    help="internal: run as this robot instead of launching")
    ap.add_argument("--die-at-round", type=int, default=None,
                    help="internal: simulate a crash at this round")
    args = ap.parse_args(argv)
    if args.kill_robot is not None and args.kill_round is None:
        ap.error("--kill-robot requires --kill-round")
    if args.robot is None:
        sys.exit(launch(args))
    run_robot(args)


if __name__ == "__main__":
    main()
