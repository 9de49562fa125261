"""Partitioning of a global pose graph into per-robot blocks (port of
``dpgo_tpu.utils.partition``; reference
``examples/MultiRobotExample.cpp:73-121``): contiguous blocks, by the
robot ids of multi-robot keys, and one robot's ``setPoseGraph`` split."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import Measurements


@dataclasses.dataclass
class Partition:
    """A pose graph split into per-robot blocks (host side)."""

    num_robots: int
    meas: Measurements  # r1/p1/r2/p2 rewritten robot-local
    n: np.ndarray  # [A] poses per robot
    global_index: np.ndarray  # [A, n_max] local -> global pose id (-1 pad)
    meas_global: Measurements  # the same measurements, globally indexed

    @property
    def n_max(self) -> int:
        return int(self.n.max())

    def classify(self):
        """Per measurement: 0 = odometry, 1 = private LC, 2 = shared."""
        m = self.meas
        same = m.r1 == m.r2
        odo = same & (m.p1 + 1 == m.p2)
        return np.where(odo, 0, np.where(same, 1, 2))


def partition_contiguous(meas: Measurements, num_robots: int) -> Partition:
    """Robot k owns poses [k*npr, (k+1)*npr); the last robot absorbs the
    remainder.  ``meas`` must be globally indexed (r1 == r2 == 0)."""
    if np.any(meas.r1 != 0) or np.any(meas.r2 != 0):
        raise ValueError(
            "partition_contiguous requires globally-indexed measurements "
            "(r1 == r2 == 0)")
    n_total = meas.num_poses
    npr = n_total // num_robots
    if npr <= 0:
        raise ValueError("More robots than poses")
    robot_of = np.minimum(np.arange(n_total) // npr,
                          num_robots - 1).astype(np.int32)
    local_of = np.arange(n_total) - robot_of * npr
    n = np.bincount(robot_of, minlength=num_robots)
    global_index = np.full((num_robots, int(n.max())), -1, np.int64)
    for a in range(num_robots):
        ids = np.nonzero(robot_of == a)[0]
        global_index[a, : len(ids)] = ids
    g1 = meas.p1.astype(np.int64)
    g2 = meas.p2.astype(np.int64)
    local = dataclasses.replace(meas, r1=robot_of[g1], p1=local_of[g1],
                                r2=robot_of[g2], p2=local_of[g2])
    return Partition(num_robots=num_robots, meas=local, n=n,
                     global_index=global_index, meas_global=meas)


def agent_measurements(part: Partition, robot_id: int):
    """One robot's (odometry, private_loop_closures, shared_loop_closures),
    robot-locally indexed — the three arguments of ``PGOAgent::setPoseGraph``
    (reference ``PGOAgent.cpp:126``), as split by the example drivers
    (``MultiRobotExample.cpp:92-121``)."""
    cls = part.classify()
    m = part.meas
    mine = (m.r1 == robot_id) | (m.r2 == robot_id)
    odometry = m.select(mine & (cls == 0))
    private_lc = m.select(mine & (cls == 1))
    shared_lc = m.select(mine & (cls == 2))
    return odometry, private_lc, shared_lc


def partition_by_keys(meas: Measurements) -> Partition:
    """Partition using the robot ids already encoded in the measurement keys
    (multi-robot g2o files; ``MultiRobotCSLAMComparison.cpp:75-101``).

    Robot ids are renumbered densely in sorted order; per-robot pose counts
    are max local index + 1.  Global pose ids are assigned contiguously by
    robot for centralized evaluation.
    """
    robots = np.unique(np.concatenate([meas.r1, meas.r2]))
    remap = {int(r): k for k, r in enumerate(robots)}
    A = len(robots)
    r1 = np.asarray([remap[int(r)] for r in meas.r1], np.int32)
    r2 = np.asarray([remap[int(r)] for r in meas.r2], np.int32)

    # Densify each robot's pose ids (keyed files need not start at 0 or be
    # contiguous; phantom poses would make the init Laplacian singular).
    n = np.zeros(A, np.int64)
    p1 = np.zeros_like(meas.p1)
    p2 = np.zeros_like(meas.p2)
    for a in range(A):
        sel1 = r1 == a
        sel2 = r2 == a
        used = np.unique(np.concatenate([meas.p1[sel1], meas.p2[sel2]]))
        dense = {int(q): k for k, q in enumerate(used)}
        n[a] = len(used)
        p1[sel1] = [dense[int(q)] for q in meas.p1[sel1]]
        p2[sel2] = [dense[int(q)] for q in meas.p2[sel2]]

    offsets = np.concatenate([[0], np.cumsum(n)[:-1]])
    n_max = int(n.max())
    global_index = np.full((A, n_max), -1, np.int64)
    for a in range(A):
        global_index[a, : n[a]] = offsets[a] + np.arange(n[a])

    local = dataclasses.replace(meas, r1=r1, p1=p1, r2=r2, p2=p2)
    meas_global = dataclasses.replace(
        meas,
        num_poses=int(n.sum()),
        r1=np.zeros_like(r1),
        p1=offsets[r1] + p1,
        r2=np.zeros_like(r2),
        p2=offsets[r2] + p2,
    )
    return Partition(num_robots=A, meas=local, n=n,
                     global_index=global_index, meas_global=meas_global)


def gather_poses_to_global(X, part: Partition) -> np.ndarray:
    """Per-agent pose array ``[A, n_max, ...]`` -> global ``[N, ...]``
    (numpy) through the partition's index table alone.  The pose layout
    depends only on ``num_poses``, so a filtered problem's iterate gathers
    with the full measurement set's partition."""
    X = np.asarray(X)
    out = np.zeros((int(part.meas_global.num_poses),) + X.shape[2:], X.dtype)
    valid = part.global_index >= 0
    out[part.global_index[valid]] = X[valid]
    return out
