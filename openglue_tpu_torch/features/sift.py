"""The SIFT patch descriptor and the DoG SIFT extractor on the device (port
of ``openglue_tpu/features/sift.py``; reference models/features/sift.py:16-49,
built there from kornia's ScaleSpaceDetector and SIFTDescriptor).

Descriptor (Lowe 2004, kornia SIFTDescriptor semantics): gradients on a
41x41 LAF patch, 4x4 spatial x 8 orientation bins with bilinear soft
assignment, a Gaussian spatial window, L2 -> clip 0.2 -> L2, and RootSIFT
(L1 -> sqrt) by default.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from openglue_tpu_torch.core.types import Features
from openglue_tpu_torch.features.nets import full_f32, gray_batch
from openglue_tpu_torch.features.patches import extract_laf_patches
from openglue_tpu_torch.features.scale_space import detect_keypoints, dominant_gradient_orientation, rotate_lafs


def sift_describe_patches(
    patches: torch.Tensor,
    num_spatial_bins: int = 4,
    num_ang_bins: int = 8,
    clip: float = 0.2,
    rootsift: bool = True,
    eps: float = 1e-10,
) -> torch.Tensor:
    """patches [..., P, P] -> descriptors [..., num_spatial_bins² * num_ang_bins]."""
    p = patches.shape[-1]
    device = patches.device
    gy, gx = torch.gradient(patches, dim=(-2, -1))
    mag = torch.sqrt(gx * gx + gy * gy + eps)
    ori = torch.atan2(gy, gx)

    lin = torch.arange(p, dtype=torch.float32, device=device) - (p - 1) / 2
    g = torch.exp(-0.5 * (lin / (0.5 * p / 1.6)) ** 2)
    weight = mag * (g[:, None] * g[None, :])

    # spatial soft assignment: [P, S] bilinear weights of each pixel row (and column)
    bin_coord = (torch.arange(p, dtype=torch.float32, device=device) + 0.5) / p * num_spatial_bins - 0.5
    b0 = torch.floor(bin_coord)
    frac = bin_coord - b0
    idx = torch.arange(num_spatial_bins, device=device)[None, :]
    spatial = (torch.where(b0[:, None] == idx, 1.0 - frac[:, None], 0.0)
               + torch.where(b0[:, None] + 1 == idx, frac[:, None], 0.0))

    # orientation soft assignment into num_ang_bins circular bins
    o = (ori + math.pi) / (2 * math.pi) * num_ang_bins
    o0 = torch.floor(o)
    ofrac = o - o0
    o0 = o0.to(torch.int64) % num_ang_bins
    o1 = (o0 + 1) % num_ang_bins
    ang = (F.one_hot(o0, num_ang_bins).to(weight.dtype) * (1.0 - ofrac[..., None])
           + F.one_hot(o1, num_ang_bins).to(weight.dtype) * ofrac[..., None]) * weight[..., None]

    hist = torch.einsum("...yxa,yi,xj->...ija", ang, spatial, spatial)
    desc = hist.reshape(*hist.shape[:-3], num_spatial_bins * num_spatial_bins * num_ang_bins)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), eps)
    desc = torch.clamp_max(desc, clip)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), eps)
    if rootsift:
        l1 = desc.abs().sum(dim=-1, keepdim=True)
        desc = torch.sqrt(desc / torch.clamp_min(l1, eps))
    return desc


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    max_keypoints: int = 1024
    descriptor_dim: int = 128  # 4*4*8, fixed by the descriptor layout
    patch_size: int = 41
    num_levels: int = 3
    init_sigma: float = 1.6
    double_image: bool = True
    upright: bool = False
    rootsift: bool = True
    response_threshold: float = 0.0
    mr_size: float = 6.0
    nms_diameter: int = 9


class SIFTFeature(nn.Module):
    """DoG detector + dominant orientation + (Root)SIFT descriptor, all on
    the device: image [B, H, W] or [B, 1, H, W] in [0, 1] -> ``Features``
    with static [B, K] shapes. No parameters."""

    def __init__(self, **kwargs):
        super().__init__()
        self.config = SIFTConfig(**kwargs)

    @full_f32()
    def forward(self, image: torch.Tensor) -> Features:
        cfg = self.config
        image = gray_batch(image)
        lafs, scores, valid = detect_keypoints(
            image, cfg.max_keypoints, response="dog", num_levels=cfg.num_levels, init_sigma=cfg.init_sigma,
            double_image=cfg.double_image, response_threshold=cfg.response_threshold, mr_size=cfg.mr_size,
            nms_diameter=cfg.nms_diameter,
        )
        if not cfg.upright:
            lafs = rotate_lafs(lafs, dominant_gradient_orientation(image, lafs))
        patches = extract_laf_patches(image, lafs, cfg.patch_size)
        desc = sift_describe_patches(patches, rootsift=cfg.rootsift)
        return Features(lafs=lafs, responses=scores, descriptors=desc, mask=valid)
