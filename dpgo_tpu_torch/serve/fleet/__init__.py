"""Fleet layer: replicated solve service with session affinity (port of
``dpgo_tpu.serve.fleet``).

Composes these pieces on top of the single-replica ``SolveServer``:

* ``manager.ReplicaManager`` — spawns/monitors/respawns/autoscales a
  pool of ``Replica``\\ s (each one ``SolveServer`` on the device its
  factory gives it; on one card the replicas share it);
* ``router.FleetRouter`` — rendezvous-hashes session ids (and a bucket
  proxy for untagged traffic) onto the pool, and live-migrates tickets
  across drains and deaths so a replica retirement loses zero sessions;
* ``aotcache.AOTDiskCache`` / ``resolve_kernel_library`` — the artifact tier
  replicas share: the kernel library ``nvcc`` builds, persisted and
  validated, so a restarted or spawned replica binds it without
  rebuilding (the JAX package persists XLA executables here);
* ``procs.ProcServer`` — the out-of-process replica: the same server
  surface backed by a CHILD PROCESS (its own CUDA context) speaking the
  packed-v2 TCP front-end, with heartbeat liveness and real ``kill -9``
  semantics.
"""

from .aotcache import AOT_CACHE_SCHEMA_VERSION  # noqa: F401
from .aotcache import AOTDiskCache, entry_identity  # noqa: F401
from .aotcache import resolve_kernel_library  # noqa: F401
from .manager import Replica, ReplicaManager  # noqa: F401
from .procs import ProcServer, ProcTicket  # noqa: F401
from .router import FleetRouter, RouterTicket  # noqa: F401
