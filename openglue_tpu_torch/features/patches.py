"""LAF-centred patch extraction (port of ``openglue_tpu/features/patches.py``;
it replaces the kornia extract_patches_from_pyramid of the reference's patch
descriptors, models/features/utils.py:15-23).

A LAF [[a11 a12 x], [a21 a22 y]] maps the unit circle to the keypoint's
ellipse; a patch is sampled on a PS x PS grid over the LAF's affine frame:
p(u, v) = A @ (u, v)^T + center, with (u, v) on [-1, 1]^2 at the patch's
pixel centres. Bilinear taps clamp at the image border. Batched over
[B, N] with static shapes.
"""

from __future__ import annotations

import torch


def bilinear_sample_image(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """image [B, H, W]; coords [B, ..., 2] (x, y) pixel coordinates ->
    [B, ...] values. Out-of-bounds taps clamp to the border; each corner is
    one gather from the row-major flattened image."""
    b, h, w = image.shape
    flat = image.reshape(b, h * w)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(xi, yi):
        xc = xi.to(torch.int64).clamp(0, w - 1)
        yc = yi.to(torch.int64).clamp(0, h - 1)
        return flat.gather(1, (yc * w + xc).reshape(b, -1)).reshape(xi.shape)

    return (
        tap(x0, y0) * (1 - wx) * (1 - wy)
        + tap(x0 + 1, y0) * wx * (1 - wy)
        + tap(x0, y0 + 1) * (1 - wx) * wy
        + tap(x0 + 1, y0 + 1) * wx * wy
    )


def extract_laf_patches(image: torch.Tensor, lafs: torch.Tensor, patch_size: int = 32) -> torch.Tensor:
    """image [B, H, W]; lafs [B, N, 2, 3] -> patches [B, N, PS, PS]."""
    ps = patch_size
    lin = (torch.arange(ps, device=image.device) + 0.5) / ps * 2.0 - 1.0
    gu, gv = torch.meshgrid(lin, lin, indexing="xy")  # gu along columns (x), gv along rows (y)
    gu, gv = gu.reshape(-1), gv.reshape(-1)
    A, center = lafs[..., :2, :2, None], lafs[..., :, 2, None]

    def frame(row):
        # u a0 + v a1 with one rounding of the second product, as XLA's CPU
        # dot computes it (a fused multiply-add; exact in float64)
        first = (gu * A[..., row, 0, :]).double()
        return (gv.double() * A[..., row, 1, :].double() + first).float() + center[..., row, :]

    x, y = frame(0), frame(1)
    b, n = lafs.shape[:2]
    return bilinear_sample_image(image, torch.stack([x, y], -1)).reshape(b, n, ps, ps)


def normalize_patches(patches: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Per-patch instance normalization (HardNet's input norm): zero mean,
    unit population std over the last two dims."""
    mean = patches.mean(dim=(-2, -1), keepdim=True)
    std = patches.std(dim=(-2, -1), keepdim=True, correction=0)
    return (patches - mean) / (std + eps)
