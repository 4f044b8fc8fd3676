"""HardNet patch descriptor (port of ``openglue_tpu/features/hardnet.py``;
the descriptor behind the reference's GFTTAffNetHardNet and
DoG-AffNet-HardNet extractors, which take kornia's pretrained HardNet).

Architecture (Mishchuk et al. 2017) in kornia's layout: one ``nn.Sequential``
named ``features`` of 6 x [conv3x3 (32/32/64/64/128/128 channels, strides
1/1/2/1/2/1, padding 1, no bias), affine-free BatchNorm, ReLU], dropout,
conv8x8 -> 128 and an affine-free BatchNorm, on instance-normalized 32x32
patches; L2-normalized output. The ``features.N.*`` keys are kornia's, so
kornia's checkpoints load with ``load_state_dict`` and the JAX package's
``hardnet_params_from_torch`` reads the port's ``state_dict()``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from openglue_tpu_torch.features.patches import extract_laf_patches, normalize_patches
from openglue_tpu_torch.models.layers import GroupBatchNorm2d

# (out_channels, stride) per 3x3 conv; the head is an 8x8 conv without padding
_LAYERS = ((32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1))


def patch_trunk(layers: Sequence[Tuple[int, int]], dropout: float, head: Sequence[nn.Module]) -> nn.Sequential:
    """kornia's Sequential: [conv3x3, BatchNorm2d(affine=False), ReLU] per
    layer, then Dropout and ``head`` (whose first entry is the 8x8 conv)."""
    modules, cin = [], 1
    for cout, stride in layers:
        modules += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
                    GroupBatchNorm2d(cout, affine=False, eps=1e-5, momentum=0.1), nn.ReLU()]
        cin = cout
    return nn.Sequential(*modules, nn.Dropout(dropout), *head)


class HardNet(nn.Module):
    """32x32 patches [N, 1, 32, 32] (or [N, 32, 32]) -> descriptors [N, 128],
    L2-normalized."""

    def __init__(self, descriptor_dim: int = 128):
        super().__init__()
        self.features = patch_trunk(_LAYERS, 0.3, (
            nn.Conv2d(_LAYERS[-1][0], descriptor_dim, 8, bias=False),
            GroupBatchNorm2d(descriptor_dim, affine=False, eps=1e-5, momentum=0.1),
        ))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches if patches.dim() == 4 else patches[:, None]
        x = self.features(x).reshape(x.shape[0], -1)
        return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def laf_patch_batch(image: torch.Tensor, lafs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Instance-normalized LAF patches as one batch [B*N, 1, PS, PS]."""
    return normalize_patches(extract_laf_patches(image, lafs, patch_size)).reshape(-1, 1, patch_size, patch_size)


def describe_lafs(hardnet: HardNet, image: torch.Tensor, lafs: torch.Tensor, patch_size: int = 32) -> torch.Tensor:
    """image [B, H, W] + lafs [B, N, 2, 3] -> descriptors [B, N, 128] (the
    LAFDescriptor composition, reference hardnet.py:36-38)."""
    b, n = lafs.shape[:2]
    return hardnet(laf_patch_batch(image, lafs, patch_size)).reshape(b, n, -1)
