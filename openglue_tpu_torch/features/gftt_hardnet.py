"""The GFTT-AffNet-HardNet device extractor (port of
``openglue_tpu/features/gftt_hardnet.py``; reference
models/features/hardnet.py:16-38: kornia ScaleSpaceDetector(CornerGFTT) +
LAFAffNetShapeEstimator + LAFOrienter(19) + HardNet).

One module holds AffNet (``affnet.*``) and HardNet (``hardnet.*``); the
detector and the orientation are parameter-free ops of ``scale_space``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from openglue_tpu_torch.core.types import Features
from openglue_tpu_torch.features.affnet import AffNet, estimate_laf_shapes
from openglue_tpu_torch.features.hardnet import HardNet, describe_lafs
from openglue_tpu_torch.features.nets import full_f32, gray_batch
from openglue_tpu_torch.features.scale_space import detect_keypoints, dominant_gradient_orientation, rotate_lafs


@dataclasses.dataclass(frozen=True)
class GFTTAffNetHardNetConfig:
    max_keypoints: int = 1024
    descriptor_dim: int = 128
    patch_size: int = 32
    num_levels: int = 3
    init_sigma: float = 1.6
    upright: bool = False
    use_affnet: bool = True
    response_threshold: float = 0.0
    mr_size: float = 6.0
    nms_diameter: int = 9


class GFTTAffNetHardNet(nn.Module):
    """image [B, H, W] or [B, 1, H, W] in [0, 1] -> ``Features`` with
    HardNet descriptors: GFTT corners over the scale space, AffNet's shape,
    the dominant gradient orientation, HardNet."""

    def __init__(self, config: GFTTAffNetHardNetConfig):
        super().__init__()
        self.config = config
        self.affnet = AffNet() if config.use_affnet else None
        self.hardnet = HardNet(config.descriptor_dim)

    @full_f32()
    def forward(self, image: torch.Tensor) -> Features:
        cfg = self.config
        image = gray_batch(image)
        lafs, scores, valid = detect_keypoints(
            image, cfg.max_keypoints, response="gftt", num_levels=cfg.num_levels, init_sigma=cfg.init_sigma,
            double_image=False, response_threshold=cfg.response_threshold, mr_size=cfg.mr_size,
            nms_diameter=cfg.nms_diameter,
        )
        if self.affnet is not None:
            lafs = estimate_laf_shapes(self.affnet, image, lafs, cfg.patch_size)
        if not cfg.upright:
            lafs = rotate_lafs(lafs, dominant_gradient_orientation(image, lafs, patch_size=19))
        desc = describe_lafs(self.hardnet, image, lafs, cfg.patch_size)
        return Features(lafs=lafs, responses=scores, descriptors=desc, mask=valid)
