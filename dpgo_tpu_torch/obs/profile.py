"""First-call and device profiling of the port's programs (port of
``dpgo_tpu.obs.profile``).

The JAX package records each jitted program's XLA compile: lower and
compile walls plus the executable's cost and memory analysis.  The port
compiles nothing per program — its one build is the kernel library
(``ops.rtr_kernel.build``), paid at the first launch of a process — so
what a program's first call records here is:

* ``first_call_s`` — the host wall of the first call (the library build
  and load when this call pays them, plus the dispatch of every op);
* ``launches`` — the hand-written kernel launches that call enqueued
  (``ops.rtr_kernel``'s counters);
* ``device_s`` — on CUDA, the device time between events recorded around
  the call, read without a host sync once the work has finished
  (``FirstCall.emit`` polls ``Event.query``; ``flush`` emits what is
  ready).

``ProfiledExecutable`` wraps a program so that its first call per static
argument combination is recorded as one ``compile_profile`` event.
``ProfilerWindow`` captures a ``torch.profiler`` window over the first K
calls.  Both are constructed only behind the telemetry fence, and every
probe degrades to "field absent", never to an exception on the dispatch
path.
"""

from __future__ import annotations

import threading
import time

from .run import get_run

__all__ = [
    "FirstCall",
    "ProfiledExecutable",
    "ProfilerWindow",
    "aot_compile_profile",
    "kernel_launches",
]


def kernel_launches() -> int:
    """Every hand-written kernel launch of this process so far (the sum of
    ``ops.rtr_kernel``'s four counters)."""
    from ..ops import rtr_kernel

    return (rtr_kernel.LAUNCHES + rtr_kernel.RTR_LAUNCHES
            + rtr_kernel.TCG_LAUNCHES + rtr_kernel.REFINE_LAUNCHES)


def _first_cuda_device(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.device if tree.device.type == "cuda" else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            dev = _first_cuda_device(t)
            if dev is not None:
                return dev
    return None


class FirstCall:
    """The record of one program's first call; ``emit`` publishes it as a
    ``compile_profile`` event once its device time can be read without
    waiting."""

    def __init__(self, run, key, label, phase, metric_prefix, fields,
                 events, count_compile=True):
        self.run = run
        self.count_compile = count_compile
        self.key = key
        self.label = label
        self.phase = phase
        self.metric_prefix = metric_prefix
        self.fields = fields
        self.events = events  # (start, end) CUDA events or None
        self.emitted = False

    def emit(self) -> bool:
        """Publish the record once the device work is done (a query, never
        a host sync).  Returns whether it was published."""
        if self.emitted:
            return True
        if self.events is not None:
            if not self.events[1].query():
                return False
            self.fields["device_s"] = \
                self.events[0].elapsed_time(self.events[1]) * 1e-3
        self.emitted = True
        run, fields = self.run, self.fields
        run.event("compile_profile", phase=self.phase, **fields)
        if self.count_compile:
            run.counter(f"{self.metric_prefix}_compile_seconds_total",
                        "host wall of profiled programs' first calls (the "
                        "kernel library's build and load when they pay "
                        "it)", unit="s").inc(fields["first_call_s"],
                                             label=self.label)
        run.gauge(f"{self.metric_prefix}_first_call_launches",
                  "hand-written kernel launches of the last profiled "
                  "program's first call").set(fields["launches"],
                                              label=self.label)
        if "device_s" in fields:
            run.gauge(f"{self.metric_prefix}_first_call_device_seconds",
                      "device time of the last profiled program's first "
                      "call (CUDA events)", unit="s").set(
                fields["device_s"], label=self.label)
        return True


def aot_compile_profile(run, fn, args, kwargs, key: str, label: str,
                        phase: str = "serve", metric_prefix: str = "serve",
                        count_compile: bool = True, **extra):
    """Run ``fn``'s first call for these arguments under the first-call
    probe and return ``(out, FirstCall)``.  ``phase``/``metric_prefix``
    scope the event and metric names to the emitting plane; ``run`` is the
    caller's already-resolved ambient run (the caller's fence).
    ``count_compile=False`` keeps the first call's wall out of
    ``<prefix>_compile_seconds_total`` (the caller bound the kernel
    library elsewhere, so the call compiles nothing)."""
    import torch

    dev = _first_cuda_device((args, kwargs))
    events = None
    if dev is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(torch.cuda.current_stream(dev))
    n0 = kernel_launches()
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    t1 = time.monotonic()
    if events is not None:
        events[1].record(torch.cuda.current_stream(dev))
    fields = {"key": key, "label": label, "first_call_s": t1 - t0,
              "launches": kernel_launches() - n0,
              "device": str(dev) if dev is not None else "cpu"}
    fields.update(extra)
    rec = FirstCall(run, key, label, phase, metric_prefix, fields, events,
                    count_compile)
    return out, rec


class ProfiledExecutable:
    """A program whose first call per static-argument combination is
    recorded (``aot_compile_profile``).  Records whose device work has not
    finished are published at a later call, or by ``flush``.  If telemetry
    vanished since construction, it calls the plain program."""

    def __init__(self, fn, key: str, label: str,
                 static_names: tuple = (), phase: str = "serve",
                 metric_prefix: str = "serve", count_compile: bool = True,
                 **extra):
        self._fn = fn
        self._count = bool(count_compile)
        self._phase = str(phase)
        self._prefix = str(metric_prefix)
        self._key = str(key)
        self._label = str(label)
        self._static = tuple(static_names)
        self._extra = dict(extra)
        self._seen: set = set()
        self._pending: list = []
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        run = get_run()
        if run is None:
            return self._fn(*args, **kwargs)
        self.flush()
        combo = tuple(sorted(
            (k, kwargs[k]) for k in self._static if k in kwargs))
        with self._lock:
            first = combo not in self._seen
            self._seen.add(combo)
        if not first:
            return self._fn(*args, **kwargs)
        out, rec = aot_compile_profile(
            run, self._fn, args, kwargs, self._key, self._label,
            phase=self._phase, metric_prefix=self._prefix,
            count_compile=self._count, static=dict(combo) or None,
            **self._extra)
        if not rec.emit():
            with self._lock:
                self._pending.append(rec)
        return out

    def flush(self) -> None:
        """Publish every pending first-call record whose device work has
        finished."""
        with self._lock:
            pending = list(self._pending)
        done = [rec for rec in pending if rec.emit()]
        with self._lock:
            self._pending = [r for r in self._pending if r not in done]


class ProfilerWindow:
    """Opt-in ``torch.profiler`` capture of the first K batch dispatches.

    ``batch_begin()`` starts the trace before the first profiled batch;
    ``batch_end()`` counts it down and stops the trace after the K-th,
    writing a Chrome-format trace under ``profile_dir``.  Start/stop
    failures disable the window (profiling must never take the caller
    down) and are reported as a ``profiler_error`` event when a run is
    live."""

    def __init__(self, profile_dir: str, num_batches: int = 3):
        self.profile_dir = str(profile_dir)
        self.remaining = max(1, int(num_batches))
        self._trace = None
        self._dead = False
        self._lock = threading.Lock()

    def _error(self, e) -> None:
        self._dead = True
        run = get_run()
        if run is not None:
            run.event("profiler_error", phase="serve", error=repr(e))

    def batch_begin(self) -> None:
        with self._lock:
            if self._dead or self._trace is not None or self.remaining <= 0:
                return
            try:
                from ..utils import profiling

                cm = profiling.trace(self.profile_dir)
                cm.__enter__()
                self._trace = cm
            except Exception as e:
                self._error(e)

    def batch_end(self) -> None:
        with self._lock:
            if self._trace is None:
                return
            self.remaining -= 1
            if self.remaining > 0:
                return
            cm, self._trace = self._trace, None
            try:
                cm.__exit__(None, None, None)
            except Exception as e:
                self._error(e)
            run = get_run()
            if run is not None and not self._dead:
                run.event("profiler_window", phase="serve",
                          profile_dir=self.profile_dir)

    def close(self) -> None:
        """Stop a still-open window (the caller shutting down
        mid-capture)."""
        with self._lock:
            cm, self._trace = self._trace, None
            if cm is not None:
                try:
                    cm.__exit__(None, None, None)
                except Exception:
                    pass
