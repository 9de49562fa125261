"""Distributed execution over ``torch.distributed`` process groups — see
``sharded.py`` (the port of ``dpgo_tpu.parallel``).

``resilience.py`` adds mesh-elastic verdict-boundary checkpoints, a
deterministic collective fault injector, and the anomaly-triggered rewind
supervisor behind ``solve_rbcd_sharded(resilience=...)``; ``certify.py``
the distributed dual certificate and staircase; ``multihost.py`` the same
verdict-loop solve across OS processes with verdict-boundary lockstep over
a ``TCPStore`` and ``kill -9`` recovery by generation respawn and
checkpoint resume; ``world.py`` spawns small multi-rank worlds.
"""

from .resilience import (WORLD_FAULT_KINDS, CollectiveFaultInjector,
                         DeviceLostError, MeshFaultError, MeshFaultSpec,
                         ResilienceConfig, Watchdog, shrink_mesh_size)
from .sharded import (AXIS, Mesh, comm_bytes_per_round, gn_tail_sharded,
                      make_mesh, make_multislice_mesh,
                      make_sharded_metrics_body,
                      make_sharded_multi_step, make_sharded_segment,
                      make_sharded_step, shard_problem, solve_rbcd_sharded)

__all__ = ["AXIS", "CollectiveFaultInjector", "DeviceLostError",
           "EXIT_DESYNC", "EXIT_PROCESS_LOST", "Mesh", "MeshFaultError",
           "MeshFaultSpec", "MultihostWorld", "ResilienceConfig",
           "WORLD_FAULT_KINDS", "Watchdog", "WorldConfig",
           "comm_bytes_per_round", "gn_tail_sharded", "launch_world",
           "make_mesh", "make_multislice_mesh",
           "make_sharded_metrics_body", "make_sharded_multi_step",
           "make_sharded_segment", "make_sharded_step", "shard_problem",
           "shrink_mesh_size", "shrink_world", "solve_rbcd_sharded"]

#: Lazily re-exported from ``.multihost``: importing it eagerly would
#: re-execute the module when invoked as ``python -m dpgo_tpu_torch
#: .parallel.multihost`` (the worker/launcher CLI), tripping runpy's
#: found-in-sys.modules warning in every worker log.
_MULTIHOST_EXPORTS = frozenset({
    "EXIT_DESYNC", "EXIT_PROCESS_LOST", "MultihostWorld", "WorldConfig",
    "launch_world", "shrink_world"})


def __getattr__(name):
    if name in _MULTIHOST_EXPORTS:
        from . import multihost

        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
