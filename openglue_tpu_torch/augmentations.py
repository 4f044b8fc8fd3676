"""Device-side photometric augmentations (port of
``openglue_tpu/augmentations.py``; reference utils/augmentations.py:
'weak_color_aug' = kornia RandomEqualize/RandomSharpness/RandomSolarize p=0.25
each + GaussianNoise p=0.5).

Each augmentation is split in two: a draw, from an explicit
``torch.Generator`` on the images' device, and an apply that takes the draws
as tensors (per-image Bernoulli masks, sharpness factors, noise). The
generator's stream is not JAX's ``jax.random``; the split lets a caller feed
any draws, JAX's included, through the same arithmetic. All are photometric,
so the intrinsics are left as they are. ``rows`` = (start, global batch)
makes a data-parallel rank draw for the whole global batch and keep its rows
from ``start`` on, so that the global batch is augmented as one process
augments it; the default is this batch alone.

images: [B, H, W] grayscale in [0, 1], f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from openglue_tpu_torch.features.nets import full_f32

SHARPNESS_CENTRE = 5.0  # the 3x3 blur's centre weight; the others are 1, the sum 13


def draw_mask(generator: torch.Generator, batch: int, p: float, device) -> torch.Tensor:
    """[B] bool: each image is augmented with probability p."""
    return torch.rand(batch, generator=generator, device=device) < p


def _where(apply: torch.Tensor, augmented: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    return torch.where(apply[:, None, None], augmented, images)


def equalize(images: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of each image where ``apply``: 256 bins of
    clip(x * 255) truncated to an integer; each pixel maps to its bin's
    (cdf - cdf of the first filled bin) / (pixels - that cdf)."""
    batch = images.shape[0]
    bins = torch.clamp(images * 255.0, 0, 255).to(torch.int32).reshape(batch, -1).long()
    hist = torch.zeros(batch, 256, dtype=torch.float32, device=images.device)
    hist.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.float32))  # exact below 2^24 pixels
    cdf = torch.cumsum(hist, dim=1)
    cdf_min = cdf.gather(1, (hist > 0).to(torch.int32).argmax(dim=1, keepdim=True))
    denom = torch.clamp(cdf[:, -1:] - cdf_min, min=1.0)
    lut = torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0)
    return _where(apply, lut.gather(1, bins).reshape(images.shape), images)


@full_f32()
def sharpen(images: torch.Tensor, apply: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """images + factor * (images - blur) inside a one-pixel border where
    ``apply``, clipped to [0, 1]: blur is the 3x3 kernel of ones with 5 at
    the centre, over 13, with zero padding."""
    # filled on the device (a slice takes a fill; an element assignment copies from the host)
    kernel = images.new_ones(3, 3)
    kernel[1:2, 1:2] = SHARPNESS_CENTRE
    kernel /= 13.0
    blurred = F.conv2d(images[:, None], kernel[None, None], padding=1)[:, 0]
    sharp = images + factor[:, None, None] * (images - blurred)
    inner = torch.zeros(images.shape[1:], dtype=torch.bool, device=images.device)
    inner[1:-1, 1:-1] = True
    sharp = torch.clamp(torch.where(inner, sharp, images), 0.0, 1.0)
    return _where(apply, sharp, images)


def solarize(images: torch.Tensor, apply: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """1 - x for pixels at or above ``threshold`` where ``apply``."""
    return _where(apply, torch.where(images >= threshold, 1.0 - images, images), images)


def add_noise(images: torch.Tensor, apply: torch.Tensor, noise: torch.Tensor, std: float = 0.05) -> torch.Tensor:
    """clip(x + std * noise, 0, 1) where ``apply``; noise [B, H, W] standard normal."""
    return _where(apply, torch.clamp(images + std * noise, 0.0, 1.0), images)


def random_equalize(generator: torch.Generator, images: torch.Tensor, p: float = 0.25) -> torch.Tensor:
    return equalize(images, draw_mask(generator, images.shape[0], p, images.device))


def random_sharpness(
    generator: torch.Generator, images: torch.Tensor, p: float = 0.25, strength: float = 0.5
) -> torch.Tensor:
    apply = draw_mask(generator, images.shape[0], p, images.device)
    factor = torch.rand(images.shape[0], generator=generator, device=images.device) * strength
    return sharpen(images, apply, factor)


def random_solarize(
    generator: torch.Generator, images: torch.Tensor, p: float = 0.25, threshold: float = 0.5
) -> torch.Tensor:
    return solarize(images, draw_mask(generator, images.shape[0], p, images.device), threshold)


def gaussian_noise(
    generator: torch.Generator, images: torch.Tensor, p: float = 0.5, std: float = 0.05
) -> torch.Tensor:
    apply = draw_mask(generator, images.shape[0], p, images.device)
    noise = torch.randn(images.shape, generator=generator, device=images.device)
    return add_noise(images, apply, noise, std)


Rows = Optional[Tuple[int, int]]


def draw_weak_color_aug(generator: torch.Generator, images: torch.Tensor, rows: Rows = None) -> Dict[str, torch.Tensor]:
    """The draws of ``weak_color_aug`` for ``images``, in the order it uses
    them; with ``rows``, rows start:start + B of the global batch's draws."""
    local, device = images.shape[0], images.device
    start, batch = rows or (0, local)
    draws = {
        "equalize": draw_mask(generator, batch, 0.25, device),
        "sharpen": draw_mask(generator, batch, 0.25, device),
        "sharpness": torch.rand(batch, generator=generator, device=device) * 0.5,
        "solarize": draw_mask(generator, batch, 0.25, device),
        "noisy": draw_mask(generator, batch, 0.5, device),
        "noise": torch.randn((batch, *images.shape[1:]), generator=generator, device=device),
    }
    return {k: v[start:start + local] for k, v in draws.items()}


def apply_weak_color_aug(images: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Equalize, sharpen, solarize, then add noise, each where its mask says."""
    images = equalize(images, draws["equalize"])
    images = sharpen(images, draws["sharpen"], draws["sharpness"])
    images = solarize(images, draws["solarize"])
    return add_noise(images, draws["noisy"], draws["noise"])


def weak_color_aug(generator: torch.Generator, images: torch.Tensor, rows: Rows = None) -> torch.Tensor:
    return apply_weak_color_aug(images, draw_weak_color_aug(generator, images, rows))


def no_aug(generator: torch.Generator, images: torch.Tensor, rows: Rows = None) -> torch.Tensor:
    return images


AUGMENTATIONS: Dict[str, Callable] = {
    "none": no_aug,
    "weak_color_aug": weak_color_aug,
}


def get_augmentation_transform(name: str) -> Callable:
    """Registry lookup (reference utils/augmentations.py:6-18)."""
    if name not in AUGMENTATIONS:
        raise ValueError(f"Unknown augmentation {name!r}; choose from {sorted(AUGMENTATIONS)}")
    return AUGMENTATIONS[name]
