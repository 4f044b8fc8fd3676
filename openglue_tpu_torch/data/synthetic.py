"""Synthetic pair generators (port of ``openglue_tpu/data/synthetic.py``).

``SyntheticHomographyPairs``: keypoints in image0, a random 4-corner
homography, the warped keypoints in image1 (with jitter) plus distractors,
and descriptors that are noisy copies across the pair.
``SyntheticReprojectionPairs``: two views of random 3D points with depth and
a random relative pose (the cached-MegaDepth batch shape), for the 3D GT
path. Tensors are made on the generator's device from a ``torch.Generator``,
with no host round trip on a card (constants are filled there, not copied
from the host; the solves skip their error checks, which would read the
card's result back); the numbers differ from the JAX generators' for the
same seed, and the two agree only in distribution. ``random_pair_batch`` is
the one-call homography batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation


def _constant(device, *values: float) -> torch.Tensor:
    """A 1-D f32 tensor of ``values`` filled on ``device``: a copy from
    pageable host memory would wait for the card's queue to drain."""
    return torch.stack([torch.full((), float(v), device=device) for v in values])


def _uniform(gen: torch.Generator, shape, low, high) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return low + (high - low) * u


def solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT for 4 point pairs with h9 = 1. src/dst [B, 4, 2] -> [B, 3, 3]."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)
    b = torch.cat([u, v], dim=1)[..., None]
    h = torch.linalg.solve_ex(A, b).result[..., 0]
    return torch.cat([h, torch.ones_like(h[:, :1])], dim=1).reshape(-1, 3, 3)


def random_homography(
    gen: torch.Generator, batch: int, image_size: Tuple[int, int] = (960, 720),
    max_corner_offset: float = 100.0,
) -> torch.Tensor:
    """[B, 3, 3] homographies from random offsets of the four image corners."""
    w, h = image_size
    src = _constant(gen.device, 0.0, 0.0, w, 0.0, w, h, 0.0, h).reshape(4, 2)
    offsets = _uniform(gen, (batch, 4, 2), -max_corner_offset, max_corner_offset)
    return solve_homography(src.expand(batch, 4, 2), src[None] + offsets)


@dataclasses.dataclass(frozen=True)
class SyntheticHomographyPairs:
    """Generator of PairBatch samples related by random homographies."""

    num_keypoints: int = 512
    descriptor_dim: int = 256
    image_size: Tuple[int, int] = (960, 720)
    covisible_fraction: float = 0.7
    jitter: float = 1.0
    descriptor_noise: float = 0.1
    max_corner_offset: float = 100.0
    side_info_dim: int = 1

    def sample(self, gen: torch.Generator, batch: int) -> PairBatch:
        w, h = self.image_size
        n, d = self.num_keypoints, self.descriptor_dim
        device = gen.device
        H = random_homography(gen, batch, self.image_size, self.max_corner_offset)
        hi = _constant(device, w - 1.0, h - 1.0)

        kpts0 = _uniform(gen, (batch, n, 2), 0.0, 1.0) * hi
        ones = torch.ones(batch, n, 1, device=device)
        warped = torch.einsum("bij,bnj->bni", H, torch.cat([kpts0, ones], -1))
        warped = warped[..., :2] / (warped[..., 2:3] + 1e-8)
        warped = warped + self.jitter * torch.randn(batch, n, 2, generator=gen, device=device)
        distractors = _uniform(gen, (batch, n, 2), 0.0, 1.0) * hi

        num_covisible = int(self.covisible_fraction * n)
        covis = (torch.arange(n, device=device) < num_covisible)[None, :, None]
        in_bounds = (
            (warped[..., 0] >= 0) & (warped[..., 0] <= w - 1)
            & (warped[..., 1] >= 0) & (warped[..., 1] <= h - 1)
        )[..., None]
        matched = covis & in_bounds
        kpts1 = torch.where(matched, warped, distractors)

        shared = torch.randn(batch, n, d, generator=gen, device=device)
        desc0 = shared + self.descriptor_noise * torch.randn(batch, n, d, generator=gen, device=device)
        noise1 = self.descriptor_noise * torch.randn(batch, n, d, generator=gen, device=device)
        desc1 = torch.where(matched, shared + noise1, torch.roll(shared, 1, dims=1) + noise1)
        desc0 = desc0 / torch.linalg.norm(desc0, dim=-1, keepdim=True)
        desc1 = desc1 / torch.linalg.norm(desc1, dim=-1, keepdim=True)

        def side_info():
            resp = torch.rand(batch, n, 1, generator=gen, device=device)
            return torch.cat([resp, torch.zeros(batch, n, self.side_info_dim - 1, device=device)], -1)

        mask = torch.ones(batch, n, dtype=torch.bool, device=device)
        image_size = _constant(device, w, h).expand(batch, 2)
        return PairBatch(
            side0=KeypointSet(kpts0, desc0, side_info(), mask, image_size),
            side1=KeypointSet(kpts1, desc1, side_info(), mask.clone(), image_size),
            transformation=Transformation(kind="perspective", H=H),
        )


def _rotation(angles: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx from [B, 3] angles (radians) -> [B, 3, 3]."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = mat([[one, zero, zero], [zero, c[:, 0], -s[:, 0]], [zero, s[:, 0], c[:, 0]]])
    Ry = mat([[c[:, 1], zero, s[:, 1]], [zero, one, zero], [-s[:, 1], zero, c[:, 1]]])
    Rz = mat([[c[:, 2], -s[:, 2], zero], [s[:, 2], c[:, 2], zero], [zero, zero, one]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass(frozen=True)
class SyntheticReprojectionPairs:
    """Two-view 3D pairs with per-keypoint depth and a relative pose.

    3D points are sampled in a box in front of camera 0; camera 1 differs by a
    random small rotation and translation. Keypoints are the two projections
    (image1's with pixel jitter); a ``covisible_fraction`` prefix
    corresponds, the rest of image1 is distractors. Descriptors are noisy
    shares as in SyntheticHomographyPairs."""

    num_keypoints: int = 512
    descriptor_dim: int = 256
    image_size: Tuple[int, int] = (960, 720)
    focal: float = 800.0
    covisible_fraction: float = 0.7
    jitter: float = 1.0
    descriptor_noise: float = 0.1
    max_rotation: float = 0.2  # radians
    max_translation: float = 0.5
    depth_range: Tuple[float, float] = (4.0, 10.0)
    side_info_dim: int = 1

    def intrinsics(self, device) -> torch.Tensor:
        w, h = self.image_size
        return _constant(device, self.focal, 0.0, w / 2, 0.0, self.focal, h / 2, 0.0, 0.0, 1.0).reshape(3, 3)

    def sample(self, gen: torch.Generator, batch: int) -> PairBatch:
        w, h = self.image_size
        n, d = self.num_keypoints, self.descriptor_dim
        device = gen.device
        K = self.intrinsics(device)
        zmin, zmax = self.depth_range
        depth = _uniform(gen, (batch, n, 1), zmin, zmax)
        uv = _uniform(gen, (batch, n, 2), 0.0, 1.0) * _constant(device, w - 1.0, h - 1.0)
        ones = torch.ones(batch, n, 1, device=device)
        rays = torch.einsum("ij,bnj->bni", torch.linalg.inv_ex(K).inverse, torch.cat([uv, ones], -1))
        points = rays * depth  # camera-0 coordinates

        R = _rotation(_uniform(gen, (batch, 3), -self.max_rotation, self.max_rotation))
        T = _uniform(gen, (batch, 3), -self.max_translation, self.max_translation)
        points1 = torch.einsum("bij,bnj->bni", R, points) + T[:, None, :]
        proj1 = torch.einsum("ij,bnj->bni", K, points1)
        kpts1_true = proj1[..., :2] / (proj1[..., 2:3] + 1e-8)
        depth1_true = points1[..., 2]
        kpts1_true = kpts1_true + self.jitter * torch.randn(batch, n, 2, generator=gen, device=device)

        num_covisible = int(self.covisible_fraction * n)
        covis = (torch.arange(n, device=device) < num_covisible)[None, :]
        in_bounds = (
            (kpts1_true[..., 0] >= 0) & (kpts1_true[..., 0] <= w - 1)
            & (kpts1_true[..., 1] >= 0) & (kpts1_true[..., 1] <= h - 1)
            & (depth1_true > 0.1)
        )
        matched = covis & in_bounds
        kpts1 = torch.where(matched[..., None], kpts1_true, torch.roll(uv, 3, dims=1))
        # a distractor's observed depth: a plausible positive value (its true
        # correspondence is elsewhere, so the GT labels it by the thresholds)
        depth1 = torch.where(matched, depth1_true, torch.roll(depth[..., 0], 3, dims=1))

        shared = torch.randn(batch, n, d, generator=gen, device=device)
        desc0 = shared + self.descriptor_noise * torch.randn(batch, n, d, generator=gen, device=device)
        noise1 = self.descriptor_noise * torch.randn(batch, n, d, generator=gen, device=device)
        desc1 = torch.where(matched[..., None], shared + noise1, torch.roll(shared, 3, dims=1) + noise1)
        desc0 = desc0 / torch.linalg.norm(desc0, dim=-1, keepdim=True)
        desc1 = desc1 / torch.linalg.norm(desc1, dim=-1, keepdim=True)

        def side_info():
            resp = torch.rand(batch, n, 1, generator=gen, device=device)
            return torch.cat([resp, torch.zeros(batch, n, self.side_info_dim - 1, device=device)], -1)

        mask = torch.ones(batch, n, dtype=torch.bool, device=device)
        image_size = _constant(device, w, h).expand(batch, 2)
        K_b = K.expand(batch, 3, 3)
        return PairBatch(
            side0=KeypointSet(uv, desc0, side_info(), mask, image_size),
            side1=KeypointSet(kpts1, desc1, side_info(), mask.clone(), image_size),
            transformation=Transformation(
                kind="3d_reprojection", K0=K_b, K1=K_b, R=R, T=T,
                depth0=depth[..., 0], depth1=depth1,
            ),
        )


def random_pair_batch(
    gen: torch.Generator,
    batch: int = 2,
    num_keypoints: int = 512,
    descriptor_dim: int = 256,
    side_info_dim: int = 1,
    image_size: Tuple[int, int] = (960, 720),
) -> PairBatch:
    """One homography pair batch in one call (``SyntheticHomographyPairs``
    with these sizes, sampled from ``gen``)."""
    pairs = SyntheticHomographyPairs(
        num_keypoints=num_keypoints,
        descriptor_dim=descriptor_dim,
        side_info_dim=side_info_dim,
        image_size=image_size,
    )
    return pairs.sample(gen, batch)
