"""Seconds to load an Orbax checkpoint the JAX package wrote through the
port's reader, on the host's CPU: the zstd frame of X at each Huffman
step length (``zstd.HUF_JUMP_LEVELS``) and with a one-lookup-per-symbol
loop in its place, and the whole ``load_checkpoint_orbax``.

    python -m dpgo_tpu_torch.experiments.orbax_load_timing CKPT [--reps N]

CKPT is a directory the JAX package's ``save_checkpoint_orbax`` wrote (it
holds ``state/``).  A checkpoint at config #5's shapes is written into
``ck5`` from the repo root, with the JAX package, by::

    python -c "import numpy as np, jax; \\
    jax.config.update('jax_platforms', 'cpu'); \\
    rng = np.random.default_rng(0); from dpgo_tpu.utils import logger; \\
    logger.save_checkpoint_orbax(logger.Checkpoint( \\
    X=rng.standard_normal((64, 1594, 5, 4)).astype(np.float32), \\
    weights=rng.uniform(size=(64, 2236)), mu=1e-3, iteration=2048), 'ck5')"

Prints one JSON line: X's frame and content bytes, the median seconds of
``zstd.decompress`` on the frame per step length and for the loop, and of
the whole load.  Host times only: this script touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time

import numpy as np

from ..utils import logger, zstd
from ..utils.ocdbt import OcdbtStore

#: Step lengths tried: 2**levels codes a Python step.
LEVELS = (3, 4, 5, 6, 8)


def one_lookup_streams(streams, counts, sym, nbits, log) -> np.ndarray:
    """``zstd._huf_streams``'s result, one table lookup per symbol in a
    Python loop (the alternative the step length is measured against)."""
    sym, nbits = sym.tolist(), nbits.tolist()
    mask = (1 << log) - 1
    out = bytearray()
    for s, n in zip(streams, counts):
        pos = 8 * len(s) - 9 + s[-1].bit_length()
        for _ in range(n):
            p = pos - log
            if p >= 0:
                v = (int.from_bytes(s[p >> 3:(p >> 3) + 3], "little")
                     >> (p & 7)) & mask
            else:
                v = (int.from_bytes(s[:3], "little") << -p) & mask
            out.append(sym[v])
            pos -= nbits[v]
    return np.frombuffer(bytes(out), np.uint8)


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    frame = OcdbtStore(os.path.join(args.ckpt, "state")).get("X/0.0.0.0")
    content = zstd.decompress(frame)
    row = {"host": platform.processor() or platform.machine(),
           "cpu_count": os.cpu_count(), "frame_bytes": len(frame),
           "content_bytes": len(content), "reps": args.reps,
           "decode_s_by_levels": {}}
    kept_levels, kept_streams = zstd.HUF_JUMP_LEVELS, zstd._huf_streams
    try:
        for lv in LEVELS:
            zstd.HUF_JUMP_LEVELS = lv
            row["decode_s_by_levels"][lv] = median_s(
                lambda: zstd.decompress(frame), args.reps)
        zstd.HUF_JUMP_LEVELS = kept_levels
        zstd._huf_streams = one_lookup_streams
        assert zstd.decompress(frame) == content
        row["decode_s_one_lookup"] = median_s(
            lambda: zstd.decompress(frame), args.reps)
    finally:
        zstd.HUF_JUMP_LEVELS, zstd._huf_streams = kept_levels, kept_streams
    row["load_checkpoint_orbax_s"] = median_s(
        lambda: logger.load_checkpoint_orbax(args.ckpt), args.reps)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
