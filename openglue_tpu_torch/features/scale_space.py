"""Multi-scale keypoint detection (port of
``openglue_tpu/features/scale_space.py``; it stands in for kornia's
ScaleSpaceDetector behind the reference's SIFT and GFTTAffNetHardNet
extractors, models/features/sift.py:16-49 and hardnet.py:16-38).

Static shapes, as in the JAX package: the octave count follows from the
image shape, 3D local maxima come from max-pooling over (scale, y, x), and
selection is one fixed-k top-k per octave, then one over all octaves, with
validity masks. Every top-k is exact and in JAX's order
(``nets.top_k``). The blur is a separable ``F.conv2d`` with the JAX
package's float64-normalized taps and zero padding.

Responses: ``dog`` (blob: |difference of Gaussians|) and ``gftt``
(Shi-Tomasi min-eigenvalue corner response). Orientation: the dominant
gradient-histogram orientation on LAF patches (LAFOrienter semantics).
Sub-pixel refinement: a 1D quadratic fit per spatial axis around each
maximum.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from openglue_tpu_torch.features.nets import top_k
from openglue_tpu_torch.features.patches import extract_laf_patches


def gaussian_taps(sigma: float, device) -> Tuple[torch.Tensor, int]:
    """The normalized 1D Gaussian of ``sigma`` over +-ceil(3 sigma) (at
    least 1), computed in float64 on ``device`` (no host copy) and rounded
    to f32; and its radius."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = torch.arange(-radius, radius + 1, dtype=torch.float64, device=device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).float(), radius


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with zero padding; image [..., H, W]: along H,
    then along W."""
    taps, r = gaussian_taps(sigma, image.device)
    shape = image.shape
    x = image.reshape(-1, 1, *shape[-2:])
    x = F.conv2d(x, taps.view(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, taps.view(1, 1, 1, -1), padding=(0, r))
    return x.reshape(shape)


def double_size(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 2H, 2W] linear upsampling (``jax.image.resize``'s
    "linear": at a 2x upsample its edge renormalization equals the clamped
    source coordinate of ``align_corners=False``)."""
    return F.interpolate(image[:, None], scale_factor=2, mode="bilinear", align_corners=False)[:, 0]


def gftt_response(image: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue of the structure tensor; image [B, H, W]."""
    dy, dx = torch.gradient(image, dim=(1, 2))
    jxx = gaussian_blur(dx * dx, sigma)
    jyy = gaussian_blur(dy * dy, sigma)
    jxy = gaussian_blur(dx * dy, sigma)
    tr = jxx + jyy
    det = jxx * jyy - jxy * jxy
    disc = torch.sqrt(torch.clamp_min(0.25 * tr * tr - det, 0.0))
    return 0.5 * tr - disc


def _local_max_3d(resp: torch.Tensor, spatial: int = 3) -> torch.Tensor:
    """resp [B, L, H, W]; True where a voxel is the max of its (3 scales x
    spatial x spatial) neighbourhood, padded with -inf. Separable: one
    window per axis (a max over a box is the max of the per-axis maxima)."""
    pooled = resp[:, None]
    for window in ((3, 1, 1), (1, spatial, 1), (1, 1, spatial)):
        pooled = F.max_pool3d(pooled, window, stride=1, padding=tuple(k // 2 for k in window))
    return resp == pooled[:, 0]


def _per_level(values: Sequence[float], level: torch.Tensor) -> torch.Tensor:
    """``values[level]`` as f32, without a host-to-device copy."""
    out = torch.full(level.shape, values[0], dtype=torch.float32, device=level.device)
    for i, v in enumerate(values[1:], 1):
        out = torch.where(level == i, v, out)
    return out


def _lafs_from(xy: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[B, K, 2] centres and [B, K] scales -> [B, K, 2, 3] isotropic LAFs."""
    eye = torch.eye(2, dtype=xy.dtype, device=xy.device)
    return torch.cat([eye * scale[..., None, None], xy[..., None]], dim=-1)


def detect_keypoints(
    image: torch.Tensor,
    max_keypoints: int,
    response: str = "dog",
    num_levels: int = 3,
    init_sigma: float = 1.6,
    min_size: int = 32,
    double_image: bool = False,
    response_threshold: float = 0.0,
    mr_size: float = 6.0,
    nms_diameter: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image [B, H, W] in [0, 1] -> (lafs [B, K, 2, 3], responses [B, K],
    valid [B, K]). LAF scale = mr_size * sigma (kornia's mr_size
    convention, reference sift.py:46 / hardnet.py:36)."""
    batch = image.shape[0]
    device = image.device
    if double_image:
        image = double_size(image)
        base_scale = 0.5
    else:
        base_scale = 1.0

    k = 2.0 ** (1.0 / num_levels)
    image = gaussian_blur(image, init_sigma)
    per_octave_kpts = max(max_keypoints // 2, 1)
    all_scores, all_xy, all_sigma = [], [], []

    octave = image
    octave_scale = base_scale
    num_octaves = 0
    h, w = octave.shape[1:]
    batch_idx = torch.arange(batch, device=device)[:, None]
    while min(h, w) >= min_size and num_octaves < 8:
        gaussians = [octave]
        sigmas = [init_sigma]
        for lvl in range(1, num_levels + 3):
            sigma_prev = init_sigma * k ** (lvl - 1)
            sigma_inc = sigma_prev * math.sqrt(k * k - 1.0)
            gaussians.append(gaussian_blur(gaussians[-1], sigma_inc))
            sigmas.append(init_sigma * k**lvl)
        stack = torch.stack(gaussians, dim=1)  # [B, L+3, h, w]

        if response == "dog":
            resp = torch.abs(stack[:, 1:] - stack[:, :-1])  # minima count too (reference sift.py:44)
            resp_sigmas = sigmas[1:]
        elif response == "gftt":
            resp = torch.stack([gftt_response(g) for g in gaussians[1:-1]], dim=1)
            resp_sigmas = sigmas[1:-1]
        else:
            raise ValueError(f"unknown response {response!r}")
        is_max = _local_max_3d(resp, spatial=max(3, int(nms_diameter) | 1))
        masked = torch.where(is_max & (resp > response_threshold), resp, 0.0)

        flat = masked.reshape(batch, -1)
        top_scores, top_idx = top_k(flat, min(per_octave_kpts, flat.shape[1]))
        lvl = top_idx // (h * w)
        rem = top_idx % (h * w)
        ys_i = rem // w
        xs_i = rem % w
        sig = _per_level(resp_sigmas, lvl)

        def resp_at(dy, dx):
            return resp[batch_idx, lvl, (ys_i + dy).clamp(0, h - 1), (xs_i + dx).clamp(0, w - 1)]

        r0 = resp_at(0, 0)

        def offset(r_minus, r_plus):
            denom = r_plus + r_minus - 2.0 * r0
            curved = torch.abs(denom) > 1e-10
            off = -0.5 * (r_plus - r_minus) / torch.where(curved, denom, 1.0)
            return torch.clamp(torch.where(curved, off, 0.0), -0.5, 0.5)

        dx = offset(resp_at(0, -1), resp_at(0, 1))
        dy = offset(resp_at(-1, 0), resp_at(1, 0))
        # at a border the clamped neighbour repeats the centre and would push
        # the offset off the image: keep the grid position there
        dx = torch.where((xs_i > 0) & (xs_i < w - 1), dx, 0.0)
        dy = torch.where((ys_i > 0) & (ys_i < h - 1), dy, 0.0)
        xs = xs_i.float() + dx
        ys = ys_i.float() + dy

        all_xy.append(torch.stack([xs, ys], -1) * octave_scale)
        all_sigma.append(sig * octave_scale)
        all_scores.append(top_scores)

        octave = gaussians[num_levels][:, ::2, ::2]  # the next octave's base
        octave_scale *= 2.0
        num_octaves += 1
        h, w = octave.shape[1:]

    if not all_scores:  # smaller than min_size: no octave, every row invalid
        zeros = torch.zeros(batch, max_keypoints, device=device)
        return (_lafs_from(zeros[..., None].expand(-1, -1, 2), torch.ones_like(zeros)), zeros,
                torch.zeros(batch, max_keypoints, dtype=torch.bool, device=device))

    scores = torch.cat(all_scores, dim=1)
    xy = torch.cat(all_xy, dim=1)
    sigma = torch.cat(all_sigma, dim=1)
    kk = min(max_keypoints, scores.shape[1])
    top_scores, top_idx = top_k(scores, kk)
    xy = xy.gather(1, top_idx[..., None].expand(-1, -1, 2))
    sigma = sigma.gather(1, top_idx)
    valid = top_scores > 0.0
    if kk < max_keypoints:
        pad = max_keypoints - kk
        top_scores = F.pad(top_scores, (0, pad))
        xy = F.pad(xy, (0, 0, 0, pad))
        sigma = F.pad(sigma, (0, pad), value=1.0)
        valid = F.pad(valid, (0, pad))
    return _lafs_from(xy, mr_size * sigma), top_scores, valid



def dominant_gradient_orientation(
    image: torch.Tensor, lafs: torch.Tensor, patch_size: int = 19, num_bins: int = 36
) -> torch.Tensor:
    """Dominant gradient orientation per LAF (kornia LAFOrienter semantics):
    a magnitude-weighted, Gaussian-windowed orientation histogram over a
    patch sampled on the LAF frame, smoothed circularly; its peak bin's
    centre, angles [B, N] in radians. The first of equal peaks wins."""
    patches = extract_laf_patches(image, lafs, patch_size)  # [B, N, P, P]
    gy, gx = torch.gradient(patches, dim=(2, 3))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ori = torch.atan2(gy, gx)

    lin = torch.arange(patch_size, dtype=torch.float32, device=image.device) - (patch_size - 1) / 2
    g = torch.exp(-0.5 * (lin / (patch_size / 4.0)) ** 2)
    weight = mag * (g[:, None] * g[None, :])

    bins = torch.floor((ori + math.pi) / (2 * math.pi) * num_bins).to(torch.int64).clamp(0, num_bins - 1)
    one_hot = F.one_hot(bins, num_bins).to(weight.dtype)
    hist = torch.einsum("bnpq,bnpqk->bnk", weight, one_hot)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    return (peak.float() + 0.5) / num_bins * 2 * math.pi - math.pi


def rotate_lafs(lafs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Compose an in-plane rotation by ``angles`` [B, N] into each LAF's
    affine part."""
    c, s = torch.cos(angles), torch.sin(angles)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [B, N, 2, 2]
    return torch.cat([lafs[..., :2, :2] @ rot, lafs[..., 2:]], dim=-1)
