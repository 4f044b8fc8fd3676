"""Batch types (port of ``openglue_tpu/core/types.py``): every keypoint set is
a fixed-size padded tensor plus a ``[B, N]`` bool validity mask."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KeypointSet:
    """A padded batch of keypoint sets for one image side.

    keypoints [B, N, 2] (x, y) pixels; descriptors [B, N, D]; side_info
    [B, N, S]; mask [B, N] bool (True for real keypoints); image_size [B, 2]
    (width, height)."""

    keypoints: torch.Tensor
    descriptors: torch.Tensor
    side_info: torch.Tensor
    mask: torch.Tensor
    image_size: torch.Tensor

    @property
    def num_keypoints(self) -> int:
        return self.keypoints.shape[1]


@dataclasses.dataclass
class PairBatch:
    """A batch of image pairs; ``homography`` [B, 3, 3] maps image0 pixels to
    image1 where the pairs are synthetic homography warps."""

    side0: KeypointSet
    side1: KeypointSet
    homography: Optional[torch.Tensor] = None
