"""AffNet (affine shape) and OriNet (orientation) (port of
``openglue_tpu/features/affnet.py``; the networks behind the reference's
GFTTAffNetHardNet and DoG-AffNet-HardNet extractors, which take kornia's
pretrained AffNetFast and OriNet).

Both are one regressor trunk in kornia's ``features`` Sequential layout:
6 x [conv3x3 (16/16/32/32/64/64 channels), affine-free BatchNorm, ReLU],
dropout, conv8x8 with a bias, tanh and a spatial mean, on
instance-normalized 32x32 LAF patches. The JAX package's
``affnet_params_from_torch`` / ``orinet_params_from_torch`` read the port's
``state_dict()``.

  * AffNet's 3 outputs give a residual lower-triangular shape
    L = [[1+x0, 0], [x1, 1+x2]] normalized to det 1, composed into the
    LAF's affine part (its scale kept);
  * OriNet's 2 outputs give an in-plane angle by atan2.
"""

from __future__ import annotations

import torch
from torch import nn

from openglue_tpu_torch.features.hardnet import laf_patch_batch, patch_trunk

_TRUNK = ((16, 1), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1))


def _regressor(out_dim: int) -> nn.Sequential:
    return patch_trunk(_TRUNK, 0.25, (nn.Conv2d(_TRUNK[-1][0], out_dim, 8, bias=True), nn.Tanh(),
                                      nn.AdaptiveAvgPool2d(1)))


def _trunk_output(features: nn.Sequential, patches: torch.Tensor) -> torch.Tensor:
    x = patches if patches.dim() == 4 else patches[:, None]
    return features(x).reshape(x.shape[0], -1)


class AffNet(nn.Module):
    """32x32 patches [N, 1, 32, 32] (or [N, 32, 32]) -> det-1 shape matrices [N, 2, 2]."""

    def __init__(self):
        super().__init__()
        self.features = _regressor(3)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        xy = _trunk_output(self.features, patches)
        a11 = 1.0 + xy[:, 0]
        a21 = xy[:, 1]
        a22 = 1.0 + xy[:, 2]
        norm = torch.sqrt(torch.abs(a11 * a22) + 1e-10)
        L = torch.stack([torch.stack([a11, torch.zeros_like(a11)], -1), torch.stack([a21, a22], -1)], -2)
        return L / norm[:, None, None]


class OriNet(nn.Module):
    """32x32 patches [N, 1, 32, 32] (or [N, 32, 32]) -> in-plane angles [N] (radians)."""

    def __init__(self):
        super().__init__()
        self.features = _regressor(2)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        cs = _trunk_output(self.features, patches)
        return torch.atan2(cs[:, 1], cs[:, 0] + 1e-8)


def estimate_laf_shapes(affnet: AffNet, image: torch.Tensor, lafs: torch.Tensor, patch_size: int = 32) -> torch.Tensor:
    """Compose AffNet's shape into each LAF (LAFAffNetShapeEstimator
    semantics: the LAF's scale is kept, its shape changes)."""
    b, n = lafs.shape[:2]
    L = affnet(laf_patch_batch(image, lafs, patch_size)).reshape(b, n, 2, 2)
    return torch.cat([lafs[..., :2, :2] @ L, lafs[..., 2:]], dim=-1)


def estimate_laf_orientations(orinet: OriNet, image: torch.Tensor, lafs: torch.Tensor,
                              patch_size: int = 32) -> torch.Tensor:
    """OriNet's angle for each LAF, [B, N] (radians)."""
    b, n = lafs.shape[:2]
    return orinet(laf_patch_batch(image, lafs, patch_size)).reshape(b, n)
