"""CSV trajectory / measurement logging (port of
``dpgo_tpu.utils.logger``), the equivalent of the reference's
``PGOLogger`` (``src/PGOLogger.cpp``) that ``agent.PGOAgent`` writes its
dumps through:

* ``log_trajectory`` / ``load_trajectory`` — per-pose quaternion +
  translation CSV (header ``pose_index,qx,qy,qz,qw,tx,ty,tz``,
  ``PGOLogger.cpp:64``), written in the header/loader order (the
  reference's writer emits translation first, ``PGOLogger.cpp:70-77``).
* ``log_measurements`` / ``load_measurements`` — measurement CSV including
  GNC weights and the known-inlier flag (``PGOLogger.cpp:29``, ``148-225``).
* ``save_matrix`` / ``load_matrix`` — raw matrix dump, the reference's
  ``writeMatrixToFile`` ``X.txt`` (``DPGO_utils.cpp:35-63``).

SE(2) trajectories/measurements are logged by embedding the yaw rotation
as a quaternion about z; pass ``d=2`` to the loaders to recover the planar
form.  The same bytes as the JAX package's writer for the same values.

* ``Checkpoint`` / ``save_checkpoint`` / ``load_checkpoint`` — the solver
  checkpoint (lifted iterate, GNC weights, mu, iteration) as the JAX
  package writes it, ``state.npz`` + ``meta.json``: a checkpoint either
  package wrote loads in the other.  Tensors are saved through numpy (a
  CUDA tensor is copied to the host); ``load_checkpoint`` returns numpy,
  for the caller to put on its device.

* ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` — the same
  checkpoint in the layout of Orbax's ``StandardCheckpointer`` under
  ``<directory>/state``, read and written without Orbax (numpy and the
  standard library: ``utils.orbax_store``).  The loader reads what the
  JAX package's pair writes (OCDBT store, zarr v2 chunks in zstd frames);
  the writer writes Orbax's per-directory layout with uncompressed
  chunks, which the JAX package's loader restores.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..types import Measurements
from . import orbax_store
from .lie import quat_to_rotation, rotation_to_quat

TRAJECTORY_HEADER = "pose_index,qx,qy,qz,qw,tx,ty,tz"
MEASUREMENT_HEADER = ("robot_src,pose_src,robot_dst,pose_dst,"
                     "qx,qy,qz,qw,tx,ty,tz,kappa,tau,is_known_inlier,weight")


def _embed_rotations(R: np.ndarray) -> np.ndarray:
    """[n, d, d] rotations -> [n, 3, 3], embedding SE(2) yaw about z."""
    R = np.asarray(R, np.float64)
    if R.shape[-1] == 3:
        return R
    n = R.shape[0]
    out = np.tile(np.eye(3), (n, 1, 1))
    out[:, :2, :2] = R
    return out


def _embed_translations(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, np.float64)
    if t.shape[-1] == 3:
        return t
    return np.concatenate([t, np.zeros((t.shape[0], 1))], axis=-1)


def log_trajectory(T: np.ndarray, path: str) -> None:
    """Write a trajectory ``T: [n, d, d+1]`` of SE(d) poses to CSV.

    Header-order columns (quaternion then translation), matching the
    reference loader (``PGOLogger.cpp:110-129``).
    """
    T = np.asarray(T, np.float64)
    n, d = T.shape[0], T.shape[1]
    q = rotation_to_quat(_embed_rotations(T[:, :, :d]))  # [n, 4] (x, y, z, w)
    t = _embed_translations(T[:, :, d])
    with open(path, "w") as f:
        f.write(TRAJECTORY_HEADER + "\n")
        for i in range(n):
            row = [i, *q[i], *t[i]]
            f.write(",".join(_fmt(v) for v in row) + "\n")


def load_trajectory(path: str, d: int = 3) -> np.ndarray:
    """Load a trajectory CSV back into ``[n, d, d+1]`` (indexed by pose_index)."""
    raw = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    if raw.size == 0:
        return np.zeros((0, d, d + 1))
    order = np.argsort(raw[:, 0].astype(int))
    raw = raw[order]
    q = raw[:, 1:5]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = quat_to_rotation(q)
    t = raw[:, 5:8]
    n = raw.shape[0]
    T = np.zeros((n, d, d + 1))
    T[:, :, :d] = R[:, :d, :d]
    T[:, :, d] = t[:, :d]
    return T


def log_measurements(meas: Measurements, path: str) -> None:
    """Write a ``Measurements`` batch (incl. GNC weights) to CSV.

    Same schema as the reference (``PGOLogger.cpp:29``): the final weights of
    a robust solve ride along so a restart can skip re-running GNC from
    scratch.
    """
    q = rotation_to_quat(_embed_rotations(meas.R))
    t = _embed_translations(meas.t)
    with open(path, "w") as f:
        f.write(MEASUREMENT_HEADER + "\n")
        for k in range(len(meas)):
            row = [int(meas.r1[k]), int(meas.p1[k]),
                   int(meas.r2[k]), int(meas.p2[k]),
                   *q[k], *t[k],
                   meas.kappa[k], meas.tau[k],
                   int(meas.is_known_inlier[k]), meas.weight[k]]
            f.write(",".join(_fmt(v) for v in row) + "\n")


def load_measurements(path: str, load_weight: bool = True,
                      d: int = 3) -> Measurements:
    """Load a measurement CSV back into ``Measurements``.

    ``load_weight=False`` resets GNC weights to 1 (fresh robust solve from
    logged data), mirroring the reference's flag (``PGOLogger.cpp:148``).
    """
    raw = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    if raw.size == 0:
        z = np.zeros(0)
        return Measurements(
            d=d, num_poses=0,
            r1=z.astype(np.int32), p1=z.astype(np.int64),
            r2=z.astype(np.int32), p2=z.astype(np.int64),
            R=np.zeros((0, d, d)), t=np.zeros((0, d)),
            kappa=z, tau=z, weight=z, is_known_inlier=z.astype(bool))
    m = raw.shape[0]
    q = raw[:, 4:8]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = quat_to_rotation(q)[:, :d, :d]
    t = raw[:, 8:11][:, :d]
    p1 = raw[:, 1].astype(np.int64)
    p2 = raw[:, 3].astype(np.int64)
    return Measurements(
        d=d,
        num_poses=int(max(p1.max(), p2.max())) + 1 if m else 0,
        r1=raw[:, 0].astype(np.int32),
        p1=p1,
        r2=raw[:, 2].astype(np.int32),
        p2=p2,
        R=np.ascontiguousarray(R),
        t=np.ascontiguousarray(t),
        kappa=raw[:, 11],
        tau=raw[:, 12],
        weight=raw[:, 14] if load_weight else np.ones(m),
        is_known_inlier=raw[:, 13].astype(bool),
    )


def save_matrix(M: np.ndarray, path: str) -> None:
    """Plain-text matrix dump (reference ``writeMatrixToFile``,
    ``DPGO_utils.cpp:35-49``: one row per line, space-separated)."""
    np.savetxt(path, np.asarray(M).reshape(M.shape[0], -1))


def load_matrix(path: str, shape=None) -> np.ndarray:
    M = np.loadtxt(path, ndmin=2)
    return M.reshape(shape) if shape is not None else M


def _fmt(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# Solver checkpoint (warm restart)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a torch tensor is copied off its
    device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Checkpoint:
    """Everything needed to resume a (robust) solve.

    The reference's resume path is ``loadTrajectory`` +
    ``loadMeasurements(load_weight=true)`` feeding ``setPoseGraph``
    (``PGOLogger.cpp:83-225``); this bundles the same data plus the lifted
    iterate and GNC state so resumption is exact, not just warm.
    """

    X: np.ndarray          # lifted iterate, solver-native shape
    weights: np.ndarray    # per-edge GNC weights (solver-native layout)
    mu: float              # current GNC mu
    iteration: int         # outer iteration count


def save_checkpoint(ckpt: Checkpoint, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "state.npz"),
             X=_host(ckpt.X), weights=_host(ckpt.weights))
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"mu": float(ckpt.mu), "iteration": int(ckpt.iteration)}, f)


def load_checkpoint(directory: str) -> Checkpoint:
    data = np.load(os.path.join(directory, "state.npz"))
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    return Checkpoint(X=data["X"], weights=data["weights"],
                      mu=meta["mu"], iteration=meta["iteration"])


# ---------------------------------------------------------------------------
# Orbax layout (``StandardCheckpointer``), without Orbax
# ---------------------------------------------------------------------------

def _dtype_of(x) -> np.dtype:
    """The numpy dtype of an array or tensor, without copying it."""
    if hasattr(x, "detach"):
        import torch
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def save_checkpoint_orbax(ckpt: Checkpoint, directory: str) -> None:
    """Write the checkpoint as Orbax's ``StandardCheckpointer`` does, under
    ``<directory>/state``, replacing one there: X and weights at their
    dtype, ``mu`` as a 0-d float64, ``iteration`` as a 0-d int64.  The
    layout is Orbax's per-directory one (``"use_ocdbt": false``, chunks
    uncompressed), committed atomically; the JAX package's
    ``load_checkpoint_orbax`` restores it.  Tensors are saved through
    numpy (a CUDA tensor is copied to the host)."""
    orbax_store.write_tree(
        os.path.join(os.path.abspath(directory), "state"),
        {"X": _host(ckpt.X), "weights": _host(ckpt.weights),
         "mu": np.asarray(float(ckpt.mu), np.float64),
         "iteration": np.asarray(int(ckpt.iteration), np.int64)})


def load_checkpoint_orbax(directory: str,
                          like: Checkpoint | None = None) -> Checkpoint:
    """Restore a checkpoint in Orbax's ``StandardCheckpointer`` layout
    under ``<directory>/state``: what either package's
    ``save_checkpoint_orbax`` wrote.  Returns numpy arrays, for the caller
    to put on its device.

    With ``like`` (anything with the target arrays, e.g. the fresh solver
    state wrapped in a ``Checkpoint``), X and weights come back cast to
    ``like``'s dtypes, as the JAX package's typed restore returns them;
    their shapes stay the saved ones whatever ``like``'s are, as there."""
    tree = orbax_store.read_tree(
        os.path.join(os.path.abspath(directory), "state"))
    X, weights = tree["X"], tree["weights"]
    if like is not None:
        X = X.astype(_dtype_of(like.X), copy=False)
        weights = weights.astype(_dtype_of(like.weights), copy=False)
    return Checkpoint(X=X, weights=weights, mu=float(tree["mu"]),
                      iteration=int(tree["iteration"]))
