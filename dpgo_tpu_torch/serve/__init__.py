"""PGO-as-a-service: the multi-tenant batched solve front-end (port of
``dpgo_tpu.serve``).

* ``bucketing`` — pads prepared problems (``models.rbcd.PreparedProblem``)
  into shape buckets so compatible requests stack into one batch, with
  the kernel's tile-major edge fields rebuilt at the bucket shape.
* ``cache`` — the bucket-program cache, keyed by the canonical config
  fingerprint (the JAX package's fingerprint JSON).
* ``runner`` — the batched dispatch: a batch of ``B`` problems of ``A``
  agents steps as one graph of ``B*A`` agents, each float32 round on the
  card one launch of the fused RTR kernel.
* ``server`` — the request plane: bounded queue, per-tenant quotas,
  deadline-aware shedding, warm pools, crash recovery, drain, and
  per-tenant SLO metrics through ``dpgo_tpu_torch.obs``.
* ``frontend`` — the TCP front-end over ``comms.transport.TcpTransport``
  (frames byte-identical to the JAX package's).
* ``statusz`` — ``/metrics``, ``/healthz``, ``/statusz`` while a
  telemetry run is live.
* ``session`` — the crash-recovery session store (the JAX package's
  snapshot format).
* ``fleet`` — the scale-out layer: ``ReplicaManager`` runs N replicas
  (spawn/monitor/respawn/autoscale, in process or as child processes),
  ``FleetRouter`` rendezvous-hashes sessions onto them and live-migrates
  tickets across drains and deaths, and ``AOTDiskCache`` persists the
  kernel library so replica restarts bind it without ``nvcc``.

Quickstart (in-process)::

    from dpgo_tpu_torch.serve import SolveServer, SolveRequest
    with SolveServer(max_batch=8) as srv:   # device="cuda"
        tickets = [srv.submit(SolveRequest(meas, num_robots=2))
                   for meas in problems]
        results = [t.result() for t in tickets]

TCP: ``python -m dpgo_tpu_torch.serve --port 0`` then
``serve.frontend.solve_g2o(host, port, g2o_bytes, num_robots=2)``.
"""

from .bucketing import BucketShape, bucket_shape_of, pad_problem
from .cache import ExecutableCache, problem_fingerprint
from .fleet import AOTDiskCache, FleetRouter, Replica, ReplicaManager
from .runner import run_bucket
from .server import (OverCapacityError, ServeSLO, SolveRequest, SolveServer,
                     SolveTicket)
from .session import SessionSnapshot, SessionStore

__all__ = [
    "BucketShape",
    "bucket_shape_of",
    "pad_problem",
    "ExecutableCache",
    "problem_fingerprint",
    "run_bucket",
    "OverCapacityError",
    "ServeSLO",
    "SolveRequest",
    "SolveServer",
    "SolveTicket",
    "SessionSnapshot",
    "SessionStore",
    "AOTDiskCache",
    "FleetRouter",
    "Replica",
    "ReplicaManager",
]
