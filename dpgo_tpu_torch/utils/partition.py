"""Contiguous partitioning of a global pose graph into per-robot blocks
(port of ``dpgo_tpu.utils.partition``; reference
``examples/MultiRobotExample.cpp:73-121``)."""

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
