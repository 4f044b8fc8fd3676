"""Geometric transforms for keypoint reprojection (port of
``openglue_tpu/geometry/transforms.py``): batched, static-shape, dispatching
on ``Transformation.kind``.

Coordinate math is exact f32: the GT thresholds are 2 px / 7 px on ~1000 px
coordinates, where one TF32 rounding of a coordinate is already ~1 px. The
3x3 products are written as elementwise sums, so no matmul (and no TF32 mode)
touches them, and distances come from direct differences, never from the
|a|^2 + |b|^2 - 2ab expansion.
"""

from __future__ import annotations

from typing import Tuple

import torch

from openglue_tpu_torch.core.types import Transformation


def _apply(points: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """out[b, n, j] = sum_k points[b, n, k] * mats[b, j, k] as elementwise
    products and a sum: points [B, N, 3], mats [B, 3, 3] -> [B, N, 3]."""
    return (points[:, :, None, :] * mats[:, None, :, :]).sum(dim=-1)


def _homogeneous(kpts: torch.Tensor) -> torch.Tensor:
    return torch.cat([kpts, torch.ones_like(kpts[..., :1])], dim=-1)


def normalize_with_intrinsics(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> calibrated coordinates. kpts [N, 2] or [B, N, 2]; K [3, 3] or
    [B, 3, 3]."""
    if K.dim() == 2:
        principal = K[:2, 2]
        focal = torch.stack([K[0, 0], K[1, 1]])
        return (kpts - principal) / focal
    principal = K[:, None, :2, 2]
    focal = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)[:, None, :]
    return (kpts - principal) / focal


def perspective_transform(
    kpts: torch.Tensor, H: torch.Tensor, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp [B, N, 2] keypoints by [B, 3, 3] homographies. Returns
    (warped [B, N, 2], valid [B, N], all True)."""
    warped = _apply(_homogeneous(kpts), H)
    out = warped[..., :2] / (warped[..., 2:3] + eps)
    return out, torch.ones(kpts.shape[:-1], dtype=torch.bool, device=kpts.device)


def gather_depth_at_keypoints(depth: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """Sample a dense depth map [B, H, W] at the truncated integer pixels of
    [B, N, 2] (x, y) keypoints, clamped to the map."""
    b, h, w = depth.shape
    idx = kpts.to(torch.int64)  # truncation toward zero, as astype(int32)
    x = idx[..., 0].clamp(0, w - 1)
    y = idx[..., 1].clamp(0, h - 1)
    batch = torch.arange(b, device=depth.device)[:, None]
    return depth[batch, y, x]


def reproject_3d(
    kpts: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    T: torch.Tensor,
    R: torch.Tensor,
    depth0: torch.Tensor,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reproject [B, N, 2] keypoints from camera 0 into camera 1 through depth
    and the relative pose. depth0 is per keypoint [B, N] or a dense map
    [B, H, W]. Returns (projected [B, N, 2], depth-valid [B, N])."""
    depth = depth0 if depth0.dim() == 2 else gather_depth_at_keypoints(depth0, kpts)
    valid = ~torch.isclose(depth, torch.zeros_like(depth))
    rays = _apply(_homogeneous(kpts), torch.linalg.inv_ex(K0).inverse)  # no error check: it would read the card
    points = _apply(rays * depth[..., None], R) + T[:, None, :]
    projected = _apply(points, K1)
    return projected[..., :2] / (projected[..., 2:3] + eps), valid


def reproject_keypoints(
    kpts: torch.Tensor, transformation: Transformation
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the transformation kind."""
    if transformation.kind == "perspective":
        return perspective_transform(kpts, transformation.H)
    if transformation.kind == "3d_reprojection":
        t = transformation
        return reproject_3d(kpts, t.K0, t.K1, t.T, t.R, t.depth0)
    raise ValueError(f"Unknown transformation kind {transformation.kind!r}")


def pairwise_cosine_dist(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Half cosine distance (1 - cos) / 2 in [0, 1]: [B, N, D] x [B, M, D] ->
    [B, N, M]."""
    x1 = x1 / torch.clamp(torch.linalg.norm(x1, dim=-1, keepdim=True), min=eps)
    x2 = x2 / torch.clamp(torch.linalg.norm(x2, dim=-1, keepdim=True), min=eps)
    return 0.5 * (1.0 - torch.einsum("bnd,bmd->bnm", x1, x2))


def cdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance [B, N, D] x [B, M, D] -> [B, N, M] from
    direct differences."""
    return torch.sqrt(cdist_sq(x1, x2))


def cdist_sq(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared pairwise Euclidean distance [B, N, D] x [B, M, D] -> [B, N, M]
    from direct differences (callers that only rank distances take the sqrt
    of the reduced values)."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return (diff * diff).sum(dim=-1)
