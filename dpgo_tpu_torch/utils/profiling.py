"""Profiling / tracing hooks (port of ``dpgo_tpu.utils.profiling``).

* ``trace(logdir)`` — context manager around ``torch.profiler`` capturing
  the host and (on CUDA) the device timeline: CPU ops, CUDA kernels,
  memcpys.  Writes one Chrome-format ``*.trace.json`` into ``logdir``,
  viewable in Perfetto and read by ``obs.devprof``.
* ``annotate(name)`` — a named region on that timeline
  (``torch.profiler.record_function``); use around driver phases.
* ``RoundTimer`` — host-side per-phase wall-clock accumulator for driver
  loops: ``stop`` optionally fences on a device value first.  For a torch
  tensor the fence synchronizes the tensor's device's current stream (the
  JAX package's ``block_until_ready``); anything else is materialized
  through ``np.asarray``.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch profile into ``logdir`` (one
    ``<host>.<pid>.<ms>.trace.json``).

    Usage::

        with profiling.trace("/tmp/dpgo-trace"):
            state = rbcd.rbcd_steps(state, graph, 100, meta, params)
            torch.cuda.synchronize()   # close the device work inside
    """
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(
            logdir, f"{socket.gethostname()}.{os.getpid()}."
                    f"{int(time.time() * 1e3)}.trace.json")
        prof.export_chrome_trace(path)


def annotate(name: str):
    """Named timeline region: ``with profiling.annotate("exchange"): ...``"""
    from torch.profiler import record_function

    return record_function(name)


def _fence(x) -> None:
    """Wait for ``x``: a torch tensor on CUDA synchronizes its device's
    current stream; a CPU tensor is ready; anything else goes through
    ``np.asarray``."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
        return
    np.asarray(x)


class RoundTimer:
    """Host-side per-phase wall-clock accumulator for driver loops.

    ``stop(phase, sync=x)`` waits for ``x`` (``_fence``) before taking the
    timestamp, so the window covers the device work that produced it.
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t0: dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._t0[phase] = time.perf_counter()

    def stop(self, phase: str, sync=None) -> float:
        if phase not in self._t0:
            # Checked BEFORE the sync fence: a mistyped phase must fail
            # fast with the clear error, not first wait on the device for
            # a window that was never opened.
            open_ = ", ".join(sorted(self._t0)) or "none"
            raise ValueError(
                f"stop({phase!r}) without a matching start() "
                f"(open phases: {open_})")
        if sync is not None:
            _fence(sync)
        dt = time.perf_counter() - self._t0.pop(phase)
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + 1
        return dt

    @contextlib.contextmanager
    def phase(self, name: str, sync_fn=None):
        """``with timer.phase("solve", lambda: state.X): ...`` — the sync
        callable (if given) produces the device value to fence on at
        exit."""
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync=sync_fn() if sync_fn is not None else None)

    def summary(self) -> str:
        rows = [f"{k}: {v:.4f}s / {self.counts[k]} "
                f"({1e3 * v / max(self.counts[k], 1):.2f} ms avg)"
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])]
        return "\n".join(rows)

    def as_dict(self) -> dict[str, dict[str, float]]:
        """Machine-readable accumulated timings:
        ``{phase: {"total_s", "count", "avg_ms"}}`` — the payload the
        telemetry event stream carries as ``phase_timings``."""
        return {k: {"total_s": v, "count": self.counts[k],
                    "avg_ms": 1e3 * v / max(self.counts[k], 1)}
                for k, v in self.totals.items()}

    def reset(self) -> None:
        """Drop all accumulated totals/counts and any in-flight ``start``
        marks, so one timer instance can be reused across runs/windows."""
        self.totals.clear()
        self.counts.clear()
        self._t0.clear()
