"""Batch types (port of ``openglue_tpu/core/types.py``): every keypoint set is
a fixed-size padded tensor plus a ``[B, N]`` bool validity mask."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
class Features:
    """A device extractor's output before side-info preparation, at a fixed
    ``N`` per image: lafs [B, N, 2, 3] local affine frames (last column the
    keypoint xy), responses [B, N], descriptors [B, N, D], mask [B, N] bool."""

    lafs: torch.Tensor
    responses: torch.Tensor
    descriptors: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass
class Transformation:
    """The ground-truth geometric relation between the two images of a pair:
    a homography (``kind="perspective"``, ``H`` [B, 3, 3] mapping image0
    pixels to image1) or a 3D reprojection (``kind="3d_reprojection"``:
    intrinsics ``K0``, ``K1`` [B, 3, 3], relative pose ``R`` [B, 3, 3] and
    ``T`` [B, 3] from camera 0 to camera 1, depths ``depth0``, ``depth1``
    either per keypoint [B, N] or dense maps [B, H, W])."""

    kind: str
    H: Optional[torch.Tensor] = None
    K0: Optional[torch.Tensor] = None
    K1: Optional[torch.Tensor] = None
    R: Optional[torch.Tensor] = None
    T: Optional[torch.Tensor] = None
    depth0: Optional[torch.Tensor] = None
    depth1: Optional[torch.Tensor] = None

    def inverse(self) -> "Transformation":
        """The relation from image1 to image0."""
        if self.kind == "perspective":
            return Transformation(kind="perspective", H=torch.linalg.inv(self.H))
        if self.kind == "3d_reprojection":
            R_t = self.R.transpose(-1, -2)
            return Transformation(
                kind="3d_reprojection",
                K0=self.K1,
                K1=self.K0,
                R=R_t,
                T=-(R_t * self.T[..., None, :]).sum(dim=-1),
                depth0=self.depth1,
                depth1=self.depth0,
            )
        raise ValueError(f"Unknown transformation kind {self.kind!r}")


@dataclasses.dataclass
class PairBatch:
    """A batch of image pairs, with the ground-truth relation where known."""

    side0: KeypointSet
    side1: KeypointSet
    transformation: Optional[Transformation] = None


def map_tensors(batch: PairBatch, fn: Callable[[torch.Tensor], torch.Tensor]) -> PairBatch:
    """The batch with ``fn`` applied to each of its tensors (a missing field
    of the transformation stays None)."""

    def side(s: KeypointSet) -> KeypointSet:
        return KeypointSet(*(fn(getattr(s, f.name)) for f in dataclasses.fields(s)))

    tf = batch.transformation
    if tf is not None:
        tf = Transformation(tf.kind, *(
            None if getattr(tf, f.name) is None else fn(getattr(tf, f.name))
            for f in dataclasses.fields(tf)[1:]
        ))
    return PairBatch(side(batch.side0), side(batch.side1), tf)
