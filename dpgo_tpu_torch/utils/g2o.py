"""g2o dataset reader and writer (port of ``dpgo_tpu.utils.g2o``).

``read_g2o`` dispatches between the native C++ loader
(``utils.native_io``, built by the port from ``native/g2o_parser.cpp``)
and the pure-Python parser ``read_g2o_python``, as the JAX package does.

Precisions follow the reference's information-divergence-minimizing
choices (``DPGO_utils.cpp:139-143``, ``184-194``): SE(2)
``tau = 2 / tr(Sigma_t^-1)``, ``kappa = I33``; SE(3)
``tau = 3 / tr(Sigma_t^-1)``, ``kappa = 3 / (2 tr(Sigma_R^-1))``.
"""

from __future__ import annotations

import io

import numpy as np

from ..types import Measurements
from .lie import quat_to_rotation, rotation2d, rotation_to_quat

_INDEX_BITS = 64 - 8 - 8
_INDEX_MASK = (1 << _INDEX_BITS) - 1


def key_to_robot_keyframe(key):
    """Decode gtsam-style symbol keys: high byte = robot char, low 48 bits =
    index (reference ``DPGO_utils.cpp:21-33``)."""
    key = np.asarray(key, dtype=np.uint64)
    robot = (key >> np.uint64(_INDEX_BITS + 8)) & np.uint64(0xFF)
    index = key & np.uint64(_INDEX_MASK)
    return robot.astype(np.int32), index.astype(np.int64)


def _open_g2o_text(source):
    """Text stream over a path, raw bytes, or a file-like object."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return io.StringIO(bytes(source).decode("utf-8"))
    if hasattr(source, "read"):
        data = source.read()
        if isinstance(data, bytes):
            data = data.decode("utf-8")
        return io.StringIO(data)
    return open(source)


def read_g2o(source, backend: str = "auto") -> Measurements:
    """Parse a .g2o dataset into ``Measurements``.

    ``source`` is a filesystem path, the file's bytes, or a file-like
    object.  ``backend``: ``"auto"`` uses the native loader when it builds
    and otherwise warns and parses in Python; ``"native"`` / ``"python"``
    force one side (``"native"`` raises when the library cannot be built).
    The native loader reads files only: in-memory sources parse in Python,
    and ``backend="native"`` with one raises.  Host IO, not a device
    path."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}")
    in_memory = isinstance(source, (bytes, bytearray, memoryview)) \
        or hasattr(source, "read")
    if backend != "python" and not in_memory:
        from . import native_io
        if backend == "native":
            return native_io.read_g2o_native(source)
        if native_io.native_available():
            return native_io.read_g2o_native(source)
        native_io.warn_fallback()
    if backend == "native" and in_memory:
        raise ValueError(
            "backend='native' requires a filesystem path; bytes/file-like "
            "sources parse with the Python backend")
    return read_g2o_python(source)


def read_g2o_python(source) -> Measurements:
    """Parse ``EDGE_SE2`` / ``EDGE_SE3:QUAT`` lines into ``Measurements``
    in Python (vectorized numpy); ``VERTEX_*`` lines only count poses and
    ``FIX`` lines are ignored."""
    rows2, rows3, keys2, keys3 = [], [], [], []
    num_vertices = 0
    with _open_g2o_text(source) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            tag = toks[0]
            if tag in ("EDGE_SE2", "EDGE_SE3:QUAT"):
                key = (int(toks[1]), int(toks[2]))
                vals = [float(x) for x in toks[3:]]
                if tag == "EDGE_SE2":
                    keys2.append(key)
                    rows2.append(vals)
                else:
                    keys3.append(key)
                    rows3.append(vals)
            elif tag.startswith("VERTEX"):
                num_vertices += 1
            elif tag == "FIX":
                continue
            else:
                raise ValueError(f"Unrecognized g2o token: {tag!r}")

    if rows2 and rows3:
        raise ValueError("Mixed SE2/SE3 edges in one file")
    if not rows2 and not rows3:
        where = source if isinstance(source, str) else "g2o source"
        raise ValueError(f"No edges found in {where}")

    if rows3:
        d = 3
        rows = np.asarray(rows3, dtype=np.float64)
        keys = np.asarray(keys3, dtype=np.uint64)
        t = rows[:, 0:3]
        R = quat_to_rotation(rows[:, 3:7])
        info = rows[:, 7:28]
        I11, I12, I13 = info[:, 0], info[:, 1], info[:, 2]
        I22, I23, I33 = info[:, 6], info[:, 7], info[:, 11]
        I44, I45, I46 = info[:, 15], info[:, 16], info[:, 17]
        I55, I56, I66 = info[:, 18], info[:, 19], info[:, 20]
        TranCov = np.stack([I11, I12, I13, I12, I22, I23, I13, I23, I33],
                           axis=-1).reshape(-1, 3, 3)
        RotCov = np.stack([I44, I45, I46, I45, I55, I56, I46, I56, I66],
                          axis=-1).reshape(-1, 3, 3)
        tau = 3.0 / np.trace(np.linalg.inv(TranCov), axis1=-2, axis2=-1)
        kappa = 3.0 / (2.0 * np.trace(np.linalg.inv(RotCov), axis1=-2,
                                      axis2=-1))
    else:
        d = 2
        rows = np.asarray(rows2, dtype=np.float64)
        keys = np.asarray(keys2, dtype=np.uint64)
        t = rows[:, 0:2]
        R = rotation2d(rows[:, 2])
        I11, I12, _I13, I22, _I23, I33 = (rows[:, 3 + k] for k in range(6))
        TranCov = np.stack([I11, I12, I12, I22], axis=-1).reshape(-1, 2, 2)
        tau = 2.0 / np.trace(np.linalg.inv(TranCov), axis1=-2, axis2=-1)
        kappa = I33

    r1, p1 = key_to_robot_keyframe(keys[:, 0])
    r2, p2 = key_to_robot_keyframe(keys[:, 1])
    num_poses = max(num_vertices, int(max(p1.max(), p2.max())) + 1)
    m = len(rows)
    return Measurements(
        d=d, num_poses=num_poses, r1=r1, p1=p1, r2=r2, p2=p2, R=R, t=t,
        kappa=np.asarray(kappa, np.float64), tau=np.asarray(tau, np.float64),
        weight=np.ones(m), is_known_inlier=np.zeros(m, dtype=bool))


def write_g2o(meas: Measurements, path: str) -> None:
    """Write globally-indexed ``Measurements`` as a g2o edge list whose
    precisions round-trip exactly through ``read_g2o``."""
    if (np.asarray(meas.r1) != 0).any() or (np.asarray(meas.r2) != 0).any():
        raise ValueError("write_g2o expects global (single-robot) indexing; "
                         "partition after reading back instead")
    with open(path, "w") as fh:
        for k in range(len(meas)):
            i, j = int(meas.p1[k]), int(meas.p2[k])
            t = np.asarray(meas.t[k], np.float64)
            tau = float(meas.tau[k])
            kappa = float(meas.kappa[k])
            if meas.d == 3:
                q = np.asarray(rotation_to_quat(np.asarray(meas.R[k])))
                c = 2.0 * kappa
                info = [tau, 0, 0, 0, 0, 0, tau, 0, 0, 0, 0, tau, 0, 0, 0,
                        c, 0, 0, c, 0, c]
                vals = [*t, *q]
                tag = "EDGE_SE3:QUAT"
            else:
                theta = float(np.arctan2(meas.R[k][1, 0], meas.R[k][0, 0]))
                info = [tau, 0, 0, tau, 0, kappa]
                vals = [*t, theta]
                tag = "EDGE_SE2"
            fh.write(f"{tag} {i} {j} "
                     + " ".join(repr(float(v)) for v in [*vals, *info])
                     + "\n")
