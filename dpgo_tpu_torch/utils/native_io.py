"""ctypes binding to the native (C++) dataset loader and topology planner
(port of ``dpgo_tpu.utils.native_io``).

The reference's IO layer is C++ (``read_g2o_file``,
``src/DPGO_utils.cpp:78-212``); so is this one: ``native/g2o_parser.cpp``
tokenizes the file in place and returns struct-of-arrays buffers that
become the numpy arrays of ``Measurements`` with one copy, and
``native/graph_builder.cpp`` plans the batched layout
(``utils.graph_plan.plan_native``).

The port builds its own library from those two unedited sources, at first
use: ``g++ -O3 -fPIC -std=c++17 -shared`` into
``dpgo_tpu_torch/_build/libdpgo_native_<hash of sources and flags>.so``,
under a lock, compiled to a temporary name unique per process and thread
and renamed into place atomically (the scheme of
``ops.rtr_kernel.build``).  It never runs ``make -C native``, which
writes the library the JAX package loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

from ..types import Measurements
from .g2o import key_to_robot_keyframe

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
SOURCES = (NATIVE_DIR / "g2o_parser.cpp", NATIVE_DIR / "graph_builder.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.RLock()
_lib = None
_load_error: str | None = None


class _DpgoG2O(ctypes.Structure):
    _fields_ = [
        ("d", ctypes.c_int32),
        ("m", ctypes.c_int64),
        ("num_vertices", ctypes.c_int64),
        ("key1", ctypes.POINTER(ctypes.c_uint64)),
        ("key2", ctypes.POINTER(ctypes.c_uint64)),
        ("R", ctypes.POINTER(ctypes.c_double)),
        ("t", ctypes.POINTER(ctypes.c_double)),
        ("kappa", ctypes.POINTER(ctypes.c_double)),
        ("tau", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 256),
    ]


def library_path() -> Path:
    """Where the library of these sources and flags lives (built or not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libdpgo_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/*.cpp`` into the hashed library unless it exists;
    return its path.  Raises ``RuntimeError`` when there is no C++
    compiler, the sources are missing or the compile fails."""
    with _lock:
        missing = [str(s) for s in SOURCES if not s.exists()]
        if missing:
            raise RuntimeError(f"native sources not found: {missing}")
        lib = library_path()
        if lib.exists():
            return lib
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build the native "
                               "loader")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               *map(str, SOURCES)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed to build {lib.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return lib


def load_library():
    """The loaded native library, built on first use; None when it cannot
    be built or loaded (the reason is in ``load_error()``)."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _load_error = str(e)
            return None
        lib.dpgo_g2o_read.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(_DpgoG2O)]
        lib.dpgo_g2o_read.restype = ctypes.c_int
        lib.dpgo_g2o_free.argtypes = [ctypes.POINTER(_DpgoG2O)]
        lib.dpgo_g2o_free.restype = None
        _lib = lib
        return _lib


def load_error() -> str | None:
    """Why the library is unavailable, or None."""
    return _load_error


def native_available() -> bool:
    return load_library() is not None


def warn_fallback() -> None:
    """The JAX package's warning when ``"auto"`` falls back to Python."""
    warnings.warn(f"[native_io] build failed ({_load_error}); "
                  "falling back to the Python parser")


def read_g2o_native(path) -> Measurements:
    """Parse a .g2o file through the native loader.

    Raises ``RuntimeError`` when the library is unavailable or the file
    cannot be read, ``ValueError`` when it is malformed (the Python
    parser's failure surface)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native g2o loader unavailable: {_load_error}")

    out = _DpgoG2O()
    rc = lib.dpgo_g2o_read(os.fspath(path).encode(), ctypes.byref(out))
    if rc != 0:
        err = out.error.decode(errors="replace")
        if rc == 1:  # IO error — out buffers are empty, nothing to free
            raise RuntimeError(f"native g2o read failed: {err}")
        lib.dpgo_g2o_free(ctypes.byref(out))
        raise ValueError(f"native g2o parse failed: {err}")

    try:
        m, d = int(out.m), int(out.d)
        as_np = np.ctypeslib.as_array
        key1 = as_np(out.key1, (m,)).copy()
        key2 = as_np(out.key2, (m,)).copy()
        R = as_np(out.R, (m, d, d)).copy()
        t = as_np(out.t, (m, d)).copy()
        kappa = as_np(out.kappa, (m,)).copy()
        tau = as_np(out.tau, (m,)).copy()
        num_vertices = int(out.num_vertices)
    finally:
        lib.dpgo_g2o_free(ctypes.byref(out))

    r1, p1 = key_to_robot_keyframe(key1)
    r2, p2 = key_to_robot_keyframe(key2)
    num_poses = max(num_vertices, int(max(p1.max(), p2.max())) + 1)
    return Measurements(
        d=d, num_poses=num_poses,
        r1=r1, p1=p1, r2=r2, p2=p2,
        R=R, t=t, kappa=kappa, tau=tau,
        weight=np.ones(m),
        is_known_inlier=np.zeros(m, dtype=bool),
    )
