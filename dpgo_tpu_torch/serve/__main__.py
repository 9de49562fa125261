"""Serving CLI: ``python -m dpgo_tpu_torch.serve`` starts a TCP solve
server (port of ``python -m dpgo_tpu.serve``) on the card, unless
``--device cpu`` is given.

::

    python -m dpgo_tpu_torch.serve --port 9100 --max-batch 8 \
        --max-frame-mb 64 --telemetry /tmp/serve_run

Prints ``listening on HOST:PORT`` once bound (``--port 0`` = OS-assigned,
so scripts can parse the resolved port), serves until interrupted, and —
with ``--telemetry`` — writes a run directory the report CLI renders with
the per-tenant "serving" SLO section::

    python -m dpgo_tpu_torch.obs.report /tmp/serve_run
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import obs
from .frontend import ServeFrontend
from .server import ServeSLO, SolveServer


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dpgo_tpu_torch.serve",
                                 description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device the server prepares and solves on "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = OS-assigned, printed once bound)")
    ap.add_argument("--max-frame-mb", type=float, default=64.0,
                    help="transport frame-size cap in MiB (both directions; "
                         "oversize frames raise a clean ProtocolError)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="max problems per batched device dispatch")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded admission queue length")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="coalescing window before forming a batch")
    ap.add_argument("--quantum", type=int, default=32,
                    help="shape-bucket rounding quantum (pose/edge counts)")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="max in-flight requests per tenant")
    ap.add_argument("--wire", choices=("packed", "npz"), default="packed",
                    help="outgoing wire format (receives auto-detect)")
    ap.add_argument("--telemetry", metavar="DIR", default=None,
                    help="write a telemetry run (SLO metrics/events) here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live /metrics, /healthz, and /statusz on "
                         "this port (0 = OS-assigned, printed once bound; "
                         "requires --telemetry — there is no registry to "
                         "scrape without a run)")
    ap.add_argument("--slo-latency-s", type=float, default=None,
                    help="per-request latency objective: enables burn-rate "
                         "SLO alerting for every tenant")
    ap.add_argument("--profile-dir", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the first "
                         "--profile-batches batched dispatches here")
    ap.add_argument("--profile-batches", type=int, default=3)
    ap.add_argument("--session-dir", metavar="DIR", default=None,
                    help="crash-recovery session store root: session-tagged "
                         "requests snapshot their solver state on solve "
                         "boundaries and are re-admitted from the last "
                         "snapshot (reply flags recovered=1) when a worker "
                         "dies mid-batch")
    ap.add_argument("--replica-id", default=None,
                    help="identity this server reports in status()/healthz "
                         "replica blocks (fleet deployments name each "
                         "member; defaults to an anonymous singleton)")
    ap.add_argument("--aot-cache-dir", metavar="DIR", default=None,
                    help="artifact tier root (shared across replicas and "
                         "restarts): the kernel library is persisted here "
                         "and bound from it without nvcc, so a warm "
                         "restart's first solve builds nothing")
    ap.add_argument("--resume-sessions", action="store_true",
                    help="with --session-dir: resume session-tagged "
                         "requests from their newest snapshot at ADMISSION "
                         "(not just after a crash) — the receiving end of "
                         "fleet live-migration")
    ap.add_argument("--drain", action="store_true",
                    help="on SIGINT, drain instead of hard-close: stop "
                         "admission with structured sheds, finish the "
                         "in-flight batch (/healthz reports draining)")
    args = ap.parse_args(argv)

    slo = ServeSLO(latency_s=args.slo_latency_s) \
        if args.slo_latency_s is not None else None
    scope = obs.run_scope(args.telemetry) if args.telemetry else None
    run = scope.__enter__() if scope else None
    try:
        server = SolveServer(max_batch=args.max_batch,
                             max_queue=args.max_queue,
                             batch_window_s=args.batch_window_ms / 1e3,
                             tenant_quota=args.tenant_quota,
                             quantum=args.quantum, slo=slo,
                             metrics_port=args.metrics_port,
                             profile_dir=args.profile_dir,
                             profile_batches=args.profile_batches,
                             session_store=args.session_dir,
                             replica_id=args.replica_id,
                             device=args.device,
                             resume_sessions=args.resume_sessions,
                             aot_cache_dir=args.aot_cache_dir)
        try:
            with ServeFrontend(
                    server, host=args.host, port=args.port,
                    max_frame_bytes=int(args.max_frame_mb * 2 ** 20),
                    wire_format=args.wire) as fe:
                print(f"listening on {fe.host}:{fe.port}", flush=True)
                if server.sidecar is not None:
                    print(f"metrics on {server.sidecar.host}:"
                          f"{server.sidecar.port}", flush=True)
                elif args.metrics_port is not None:
                    print("metrics sidecar DISABLED (no --telemetry run "
                          "to scrape)", flush=True)
                if run is not None:
                    run.event("serve_listen", phase="serve", host=fe.host,
                              port=fe.port,
                              max_frame_bytes=fe.max_frame_bytes,
                              metrics_port=server.sidecar.port
                              if server.sidecar else None)
                try:
                    while True:
                        time.sleep(1.0)
                except KeyboardInterrupt:
                    print("draining" if args.drain else "shutting down",
                          flush=True)
                    # Drain while the connections are still up, so queued
                    # requests get their structured shed replies instead
                    # of a dropped socket; the frontend closes after.
                    server.close(drain=args.drain)
        finally:
            server.close(drain=args.drain)  # idempotent
    finally:
        if scope:
            scope.__exit__(None, None, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
