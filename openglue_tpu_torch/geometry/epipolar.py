"""Epipolar geometry (port of ``openglue_tpu/geometry/epipolar.py``): the
essential matrix of a relative pose and the symmetrical epipolar distance
(kornia's, which the reference calls, utils/metrics.py:36-43).

Convention (the reference data's: x1_cam = R @ x0_cam + T): E = [T]_x @ R,
epipolar constraint x1ᵀ E x0 = 0 in K-normalized coordinates.
"""

from __future__ import annotations

import torch


def cross_product_matrix(t: torch.Tensor) -> torch.Tensor:
    """[B, 3] -> [B, 3, 3] skew-symmetric matrices."""
    zeros = torch.zeros_like(t[..., 0])
    rows = [
        torch.stack([zeros, -t[..., 2], t[..., 1]], dim=-1),
        torch.stack([t[..., 2], zeros, -t[..., 0]], dim=-1),
        torch.stack([-t[..., 1], t[..., 0], zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def essential_from_Rt(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """E = [T]_x R for x1 = R x0 + T. R: [B, 3, 3]; T: [B, 3]."""
    return cross_product_matrix(T) @ R


def symmetrical_epipolar_distance(
    pts0: torch.Tensor, pts1: torch.Tensor, E: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Squared residual times the sum of the inverse squared line norms of
    both epipolar lines. pts0/pts1: [B, N, 2] K-normalized; E: [B, 3, 3] ->
    [B, N]."""
    ones = torch.ones((*pts0.shape[:-1], 1), dtype=pts0.dtype, device=pts0.device)
    x0 = torch.cat([pts0, ones], dim=-1)  # [B, N, 3]
    x1 = torch.cat([pts1, ones], dim=-1)

    Ex0 = torch.einsum("bij,bnj->bni", E, x0)  # epipolar lines in image1
    Etx1 = torch.einsum("bji,bnj->bni", E, x1)  # epipolar lines in image0
    num = torch.sum(x1 * Ex0, dim=-1) ** 2  # (x1ᵀ E x0)²
    inv0 = 1.0 / (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + eps)
    inv1 = 1.0 / (Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2 + eps)
    return num * (inv0 + inv1)
