"""Lifting and rounding between SE(d) and the rank-r relaxation (port of
``dpgo_tpu.models.local_pgo.lift`` / ``round_solution``)."""

from __future__ import annotations

import torch

from ..utils.lie import project_to_rotation


def lift(T: torch.Tensor, ylift: torch.Tensor) -> torch.Tensor:
    """X_i = YLift T_i: [n, d, d+1] -> [n, r, d+1]
    (reference ``PGOAgent.cpp:183,415``)."""
    return torch.einsum("rd,nde->nre", ylift, T)


def round_solution(X: torch.Tensor, ylift: torch.Tensor) -> torch.Tensor:
    """T = YLift^T X, rotation blocks projected to SO(d)
    (reference ``PGOAgent::roundSolution``, ``PGOAgent.cpp:487-494``)."""
    T = torch.einsum("rd,nre->nde", ylift, X)
    d = ylift.shape[1]
    return torch.cat([project_to_rotation(T[..., :d]), T[..., d:]], dim=-1)
