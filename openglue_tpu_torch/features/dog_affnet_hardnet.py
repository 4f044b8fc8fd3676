"""The DoG(OpenCV)-AffNet-HardNet extractor (port of
``openglue_tpu/features/dog_affnet_hardnet.py``; reference
models/features/opencv/dog_affnet_harnet.py:19-81): keypoints detected on
the host with OpenCV's DoG (dense SIFT detection, thresholds disabled, the
port's ``OpenCVFeatures``), then the affine shape (AffNet), the orientation
(OriNet) and the description (HardNet) on the device. The detector pads its
LAFs to ``max_keypoints`` with a mask, so the device stage has one shape.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from openglue_tpu_torch.features.affnet import AffNet, OriNet, estimate_laf_orientations, estimate_laf_shapes
from openglue_tpu_torch.features.hardnet import HardNet, describe_lafs
from openglue_tpu_torch.features.nets import full_f32, seeded_init_
from openglue_tpu_torch.features.opencv_features import OpenCVFeatures
from openglue_tpu_torch.features.prepare import to_device
from openglue_tpu_torch.features.scale_space import rotate_lafs


class DoGAffNetHardNet:
    """Host detection, device description. The three networks live on
    ``device``, drawn from ``torch.Generator`` seeds ``seed``, ``seed + 1``
    and ``seed + 2`` (AffNet, OriNet, HardNet) until ``load_weights``
    replaces them."""

    def __init__(
        self,
        max_keypoints: int = 2048,
        nms_diameter: float = 9.0,
        patch_size: int = 32,
        upright: bool = False,
        use_affnet: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        import cv2

        self.patch_size = patch_size
        self.upright = upright
        self.use_affnet = use_affnet
        self.device = torch.device(device)
        self.detector = OpenCVFeatures(
            cv2.SIFT_create(contrastThreshold=-10000, edgeThreshold=-10000),
            max_keypoints=max_keypoints,
            nms_diameter=nms_diameter,
            laf_scale_mr_size=6.0,
            pad_to_max=True,
        )
        self.affnet, self.orinet, self.hardnet = (
            seeded_init_(net, torch.Generator().manual_seed(seed + i)).to(self.device).eval()
            for i, net in enumerate((AffNet(), OriNet(), HardNet()))
        )

    def load_weights(
        self,
        affnet: Optional[Mapping[str, Any]] = None,
        orinet: Optional[Mapping[str, Any]] = None,
        hardnet: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Load state dicts in kornia's layout (or the port's, which is the same)."""
        for net, state in ((self.affnet, affnet), (self.orinet, orinet), (self.hardnet, hardnet)):
            if state is not None:
                net.load_state_dict(state)

    @full_f32()
    def describe(self, image: torch.Tensor, lafs: torch.Tensor):
        """image [B, H, W] in [0, 1], lafs [B, N, 2, 3] on the device ->
        (lafs with AffNet's shape and OriNet's rotation, HardNet descriptors
        [B, N, 128])."""
        if self.use_affnet:
            lafs = estimate_laf_shapes(self.affnet, image, lafs, self.patch_size)
        if not self.upright:
            lafs = rotate_lafs(lafs, estimate_laf_orientations(self.orinet, image, lafs, self.patch_size))
        return lafs, describe_lafs(self.hardnet, image, lafs, self.patch_size)

    def detect_and_compute(self, image: np.ndarray):
        """uint8 grayscale [H, W] -> (lafs [K, 2, 3], scores [K], desc
        [K, 128], mask [K]) numpy, the host extractors' contract; one copy
        back from the device."""
        lafs, scores, _, mask = self.detector.detect_and_compute(image)
        img = to_device((image.astype(np.float32) / 255.0)[None], self.device)
        with torch.no_grad():
            lafs_d, desc = self.describe(img, to_device(lafs[None], self.device))
            k = lafs.shape[0]
            host = torch.cat([lafs_d[0].reshape(k, 6), desc[0]], 1).cpu().numpy()
        return host[:, :6].reshape(k, 2, 3), scores, host[:, 6:], mask


def dog_affnet_hardnet_create(**kwargs) -> DoGAffNetHardNet:
    return DoGAffNetHardNet(**kwargs)
