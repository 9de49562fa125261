"""Deterministic, seeded fault injection for the deployment transports.

A ``FaultInjector`` sits on the *send* side of a transport: every outgoing
frame's bytes pass through ``apply(src, dst, data)``, which returns the
deliveries the network actually performs — possibly none (drop, partition),
possibly late (delay), possibly swapped with the next frame on the link
(reorder), possibly bit-flipped (corrupt).  The decision stream is a
per-link ``np.random.default_rng`` derived from ``(seed, src, dst)``, so a
chaos run is reproducible per link regardless of how threads interleave
*across* links — the property the seeded chaos tests rely on.

The injector is shared mutable state guarded by one lock; ``enabled``
toggles it live (the deployment examples run the lifting-matrix broadcast
and the final anchor sync clean, injecting faults only during solve
rounds).

The PyTorch port's copy of ``dpgo_tpu.comms.faults``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-message fault probabilities and shapes (all independent)."""

    drop: float = 0.0            # P(frame silently dropped)
    delay: float = 0.0           # P(frame delayed)
    delay_s: tuple[float, float] = (0.0, 0.0)  # uniform delay range, seconds
    reorder: float = 0.0         # P(frame held and swapped with the next)
    corrupt: float = 0.0         # P(payload bytes flipped)
    # Node groups that cannot talk across (network partition); nodes absent
    # from every group communicate freely.
    partitions: tuple[tuple, ...] = ()

    def any_active(self) -> bool:
        return bool(self.drop or self.delay or self.reorder or self.corrupt
                    or self.partitions)


class FaultInjector:
    """Seeded fault decisions, one RNG stream per directed link."""

    def __init__(self, spec: FaultSpec, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.enabled = True
        self._lock = threading.Lock()
        self._rngs: dict[tuple, np.random.Generator] = {}
        self._held: dict[tuple, bytes] = {}  # reorder: one held frame/link
        self.stats = {"delivered": 0, "dropped": 0, "delayed": 0,
                      "reordered": 0, "corrupted": 0, "partitioned": 0}

    def _rng(self, link: tuple) -> np.random.Generator:
        rng = self._rngs.get(link)
        if rng is None:
            # Stable per-link derivation: independent of creation order.
            h = zlib.crc32(repr(link).encode())
            rng = np.random.default_rng((self.seed << 32) ^ h)
            self._rngs[link] = rng
        return rng

    def partitioned(self, src, dst) -> bool:
        for group in self.spec.partitions:
            if (src in group) != (dst in group):
                return True
        return False

    def apply(self, src, dst, data: bytes) -> list[tuple[float, bytes]]:
        """Deliveries for one sent frame, as ``(delay_seconds, bytes)``.

        Empty list = the network ate the frame.  More than one entry =
        a previously held (reordered) frame rides out with this one.
        """
        if not self.enabled:
            return [(0.0, data)]
        with self._lock:
            if self.partitioned(src, dst):
                self.stats["partitioned"] += 1
                return []
            rng = self._rng((src, dst))
            sp = self.spec
            # One uniform draw per fault class keeps the stream length
            # deterministic per message (reproducibility under any spec).
            u_drop, u_delay, u_reorder, u_corrupt = rng.uniform(size=4)
            if u_drop < sp.drop:
                self.stats["dropped"] += 1
                return []
            if u_corrupt < sp.corrupt and len(data):
                data = bytearray(data)
                for k in rng.integers(0, len(data), size=3):
                    data[int(k)] ^= 0xFF
                data = bytes(data)
                self.stats["corrupted"] += 1
            delay = 0.0
            if u_delay < sp.delay:
                delay = float(rng.uniform(*sp.delay_s))
                self.stats["delayed"] += 1
            link = (src, dst)
            held = self._held.pop(link, None)
            if held is None and u_reorder < sp.reorder:
                self._held[link] = data
                self.stats["reordered"] += 1
                return []
            out = [(delay, data)]
            if held is not None:
                out.append((delay, held))  # swapped: newer first, older after
            self.stats["delivered"] += len(out)
            return out

    def flush(self, src, dst) -> list[tuple[float, bytes]]:
        """Release any frame held for reordering on a link (called when the
        sender closes so a held frame is not silently lost forever)."""
        with self._lock:
            held = self._held.pop((src, dst), None)
        return [(0.0, held)] if held is not None else []
