"""Homography-warp image-pair dataset (port of ``openglue_tpu/data/homography.py``;
reference data/oxford_paris_dataset.py:27-66 and the unwired
MegaDepthWarpingDataset, megadepth_dataset.py:16-52).

Takes any directory of images (revisitop1m layout or flat), resizes to
(W + 2·off, H + 2·off), applies a random 4-corner perspective warp, crops both
center regions so content stays in-frame, and emits the grayscale pair plus
the effective homography between the crops. numpy and OpenCV on the host, as
in the JAX package: at one seed the samples are the same bytes.

Color augmentation replaces albumentations with numpy equivalents: random
brightness/contrast and gaussian noise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(root) -> List[Path]:
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in IMAGE_EXTENSIONS)


def random_color_jitter(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """uint8 [H, W] -> uint8; contrast (x[0.8, 1.2]), brightness (+-0.2 of
    255) and gauss noise (sigma 5) with p=0.5 each
    (stands in for the reference's albumentations stack,
    oxford_paris_dataset.py:50-57)."""
    img = image.astype(np.float32)
    if rng.random() < 0.5:
        img = img * (1.0 + rng.uniform(-0.2, 0.2))
    if rng.random() < 0.5:
        img = img + 255.0 * rng.uniform(-0.2, 0.2)
    if rng.random() < 0.5:
        img = img + rng.normal(0.0, 5.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


class HomographyPairsDataset:
    """Synthetic pairs: (image, warp(image), H) for homography pretraining.

    Sample dict matches the online training contract: image0/1 [H, W] float32
    in [0, 1] plus transformation {type: 'perspective', H}.
    """

    def __init__(
        self,
        images_root,
        target_size: Tuple[int, int] = (960, 720),
        max_corner_offset: int = 100,
        color_augmentation: bool = True,
        seed: int = 0,
    ):
        self.paths = list_images(images_root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {images_root}")
        self.target_size = tuple(target_size)
        self.off = int(max_corner_offset)
        self.color_augmentation = color_augmentation
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict:
        import cv2

        image = cv2.imread(str(self.paths[idx]))
        if image is None:
            raise FileNotFoundError(self.paths[idx])
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)

        w, h = self.target_size
        big_w, big_h = w + 2 * self.off, h + 2 * self.off
        image = cv2.resize(image, (big_w, big_h))

        # random perspective: jitter the 4 corners by up to ±off (reference
        # oxford_paris_dataset.py:36-44)
        src = np.float32([[0, 0], [big_w, 0], [big_w, big_h], [0, big_h]])
        dst = src + self.rng.uniform(-self.off, self.off, (4, 2)).astype(np.float32)
        H_full = cv2.getPerspectiveTransform(src, dst)
        warped = cv2.warpPerspective(image, H_full, (big_w, big_h))

        # crop both center windows; compose crop shifts into H
        # (reference oxford_paris_dataset.py:46-49)
        crop = lambda im: im[self.off : self.off + h, self.off : self.off + w]
        image_c, warped_c = crop(image), crop(warped)
        S = np.array([[1, 0, -self.off], [0, 1, -self.off], [0, 0, 1]], np.float64)
        H = S @ H_full @ np.linalg.inv(S)

        if self.color_augmentation:
            image_c = random_color_jitter(image_c, self.rng)
            warped_c = random_color_jitter(warped_c, self.rng)

        return {
            "image0": image_c.astype(np.float32) / 255.0,
            "image1": warped_c.astype(np.float32) / 255.0,
            "transformation": {"type": "perspective", "H": H.astype(np.float32)},
        }


# Reference-name aliases: the revisitop1m dataset (oxford_paris_dataset.py) and
# the unwired MegaDepth warping dataset (megadepth_dataset.py:16-52) are both
# instances of the same image-folder + random-warp recipe.
OxfordParis1MDataset = HomographyPairsDataset
MegaDepthWarpingDataset = HomographyPairsDataset
