"""Core data containers of the PyTorch port.

``Measurements`` stays host-side numpy (as in ``dpgo_tpu.types``); the
device-side ``EdgeSet`` is a NamedTuple of tensors.  Edges index into a pose
buffer ``X: [N, r, d+1]`` of blocks ``[Y_i | p_i]``; a local problem's
buffer is ``cat([local X (n), neighbor Z (s)])``.  Every field may carry
leading batch dimensions (``[A, E]`` for the per-agent edge sets).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device


@dataclasses.dataclass
class Measurements:
    """A batch of relative SE(d) measurements (host side, numpy).

    Fields mirror ``RelativeSEMeasurement`` (reference
    ``RelativeSEMeasurement.h:21-89``): edge (r1, p1) -> (r2, p2), rotation
    ``R``, translation ``t``, precisions ``kappa``/``tau``, GNC ``weight``
    and the known-inlier flag.
    """

    d: int
    num_poses: int
    r1: np.ndarray  # [m] robot id of tail
    p1: np.ndarray  # [m] pose index of tail
    r2: np.ndarray  # [m] robot id of head
    p2: np.ndarray  # [m] pose index of head
    R: np.ndarray  # [m, d, d]
    t: np.ndarray  # [m, d]
    kappa: np.ndarray  # [m]
    tau: np.ndarray  # [m]
    weight: np.ndarray  # [m]
    is_known_inlier: np.ndarray  # [m] bool

    def __len__(self) -> int:
        return int(self.r1.shape[0])

    def select(self, idx) -> "Measurements":
        """A new Measurements holding rows ``idx`` (bool mask or indices)."""
        return Measurements(
            d=self.d, num_poses=self.num_poses,
            r1=self.r1[idx], p1=self.p1[idx], r2=self.r2[idx],
            p2=self.p2[idx], R=self.R[idx], t=self.t[idx],
            kappa=self.kappa[idx], tau=self.tau[idx],
            weight=self.weight[idx],
            is_known_inlier=self.is_known_inlier[idx])


class EdgeSet(NamedTuple):
    """Struct-of-arrays edge list of tensors (optional leading batch dims).

    ``mask`` is 1 for valid edges and 0 for padding; ``is_lc`` marks loop
    closures; ``fixed_weight`` marks known inliers.
    """

    i: torch.Tensor  # [E] int64
    j: torch.Tensor  # [E] int64
    R: torch.Tensor  # [E, d, d]
    t: torch.Tensor  # [E, d]
    kappa: torch.Tensor  # [E]
    tau: torch.Tensor  # [E]
    weight: torch.Tensor  # [E]
    mask: torch.Tensor  # [E]
    is_lc: torch.Tensor  # [E]
    fixed_weight: torch.Tensor  # [E]

    @property
    def d(self) -> int:
        return self.R.shape[-1]

    def replace(self, **kw) -> "EdgeSet":
        return self._replace(**kw)


def loop_closure_mask(meas: Measurements) -> np.ndarray:
    """Bool mask of loop closures: an edge is odometry iff same robot and
    consecutive indices (``MultiRobotExample.cpp:104-113``)."""
    return ~((meas.r1 == meas.r2) & (meas.p1 + 1 == meas.p2))


def edge_set_from_measurements(meas: Measurements, dtype=torch.float64,
                               device="cuda") -> EdgeSet:
    """EdgeSet over global pose indices ``p1``/``p2`` (the centralized
    problem), on ``device`` in ``dtype``."""
    device = resolve_device(device)
    m = len(meas)
    d = meas.d

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def ix(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    R = np.broadcast_to(np.eye(d), (m, d, d)) if m == 0 else meas.R
    return EdgeSet(
        i=ix(meas.p1), j=ix(meas.p2), R=f(R), t=f(meas.t),
        kappa=f(meas.kappa), tau=f(meas.tau), weight=f(meas.weight),
        mask=f(np.ones(m)),
        is_lc=f(loop_closure_mask(meas).astype(np.float64)),
        fixed_weight=f(np.asarray(meas.is_known_inlier, np.float64)))
