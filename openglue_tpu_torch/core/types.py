"""Batch types (port of ``openglue_tpu/core/types.py``): every keypoint set is
a fixed-size padded tensor plus a ``[B, N]`` bool validity mask."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

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
            return Transformation(kind="perspective", H=torch.linalg.inv_ex(self.H).inverse)  # no check: no host read
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



def superglue_inputs(batch: PairBatch) -> Dict[str, Any]:
    """Map a PairBatch onto the ``SuperGlue.forward`` keyword arguments."""
    s0, s1 = batch.side0, batch.side1
    return dict(
        kpts0=s0.keypoints,
        kpts1=s1.keypoints,
        desc0=s0.descriptors,
        desc1=s1.descriptors,
        side_info0=s0.side_info,
        side_info1=s1.side_info,
        image_size0=s0.image_size,
        image_size1=s1.image_size,
        mask0=s0.mask,
        mask1=s1.mask,
    )

def map_tensors(batch: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """The batch with ``fn`` applied to each of its tensors: a ``PairBatch``,
    a ``Transformation`` (a missing field stays None), a dict of these and
    tensors (the online trainer's image batch), or a tensor."""
    if isinstance(batch, dict):
        return {k: map_tensors(v, fn) for k, v in batch.items()}
    if isinstance(batch, Transformation):
        return Transformation(batch.kind, *(
            None if getattr(batch, f.name) is None else fn(getattr(batch, f.name))
            for f in dataclasses.fields(batch)[1:]
        ))
    if isinstance(batch, PairBatch):
        def side(s: KeypointSet) -> KeypointSet:
            return KeypointSet(*(fn(getattr(s, f.name)) for f in dataclasses.fields(s)))

        tf = batch.transformation
        return PairBatch(side(batch.side0), side(batch.side1), None if tf is None else map_tensors(tf, fn))
    return fn(batch)
