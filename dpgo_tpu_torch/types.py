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

    @staticmethod
    def concatenate(parts: list["Measurements"]) -> "Measurements":
        """The rows of ``parts`` in order, as one batch."""
        assert parts
        return Measurements(
            d=parts[0].d,
            num_poses=max(p.num_poses for p in parts),
            r1=np.concatenate([p.r1 for p in parts]),
            p1=np.concatenate([p.p1 for p in parts]),
            r2=np.concatenate([p.r2 for p in parts]),
            p2=np.concatenate([p.p2 for p in parts]),
            R=np.concatenate([p.R for p in parts]),
            t=np.concatenate([p.t for p in parts]),
            kappa=np.concatenate([p.kappa for p in parts]),
            tau=np.concatenate([p.tau for p in parts]),
            weight=np.concatenate([p.weight for p in parts]),
            is_known_inlier=np.concatenate(
                [p.is_known_inlier for p in parts]))


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
                               device="cuda", tail_index=None,
                               head_index=None, is_lc=None,
                               pad_to: int | None = None) -> EdgeSet:
    """EdgeSet on ``device`` in ``dtype``.  By default edges index poses by
    their global index ``p1``/``p2`` (the centralized problem);
    ``tail_index``/``head_index`` override the buffer indices (a robot's
    own edge list with remote endpoints in its neighbor slots,
    ``agent.PGOAgent``) and ``is_lc`` the loop-closure flags.  ``pad_to``
    appends zero rows (mask 0) up to that many edges, as the serving
    plane's bucket shapes need (``serve.bucketing``)."""
    device = resolve_device(device)
    m = len(meas)
    d = meas.d
    n_pad = (pad_to or m) - m
    if n_pad < 0:
        raise ValueError(f"pad_to={pad_to} is below the {m} measurements")

    def pad(x):
        x = np.asarray(x)
        if n_pad == 0:
            return x
        return np.pad(x, [(0, n_pad)] + [(0, 0)] * (x.ndim - 1))

    def f(x):
        return torch.as_tensor(pad(np.asarray(x, np.float64)), dtype=dtype,
                               device=device)

    def ix(x):
        return torch.as_tensor(pad(np.asarray(x, np.int64)), device=device)

    if is_lc is None:
        is_lc = loop_closure_mask(meas)
    R = np.broadcast_to(np.eye(d), (m, d, d)) if m == 0 else meas.R
    return EdgeSet(
        i=ix(meas.p1 if tail_index is None else tail_index),
        j=ix(meas.p2 if head_index is None else head_index),
        R=f(R), t=f(meas.t),
        kappa=f(meas.kappa), tau=f(meas.tau), weight=f(meas.weight),
        mask=f(np.ones(m)),
        is_lc=f(np.asarray(is_lc, bool).astype(np.float64)),
        fixed_weight=f(np.asarray(meas.is_known_inlier, np.float64)))
