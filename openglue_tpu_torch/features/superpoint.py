"""SuperPoint detector and descriptor (port of
``openglue_tpu/features/superpoint.py``; reference
models/features/superpoint/model.py:16-199, utils.py:1-39).

NCHW, with the layers named after the reference's torch keys (``conv1a`` ...
``conv4b``, ``convPa``, ``convPb``, ``convDa``, ``convDb``, and ``bn1a`` ...
``bnDb`` for ``SuperPointNetBn``), so that a reference checkpoint loads with
``load_state_dict`` and the JAX package's ``superpoint_params_from_torch``
reads the port's ``state_dict()``. The extraction keeps the JAX package's
static shapes: NMS is a max-pool compare (kornia nms2d semantics),
selection one exact top-k of ``max_keypoints`` per image in JAX's order
with validity = score > threshold, and the descriptors are sampled with
explicit bilinear taps (clamped at the border) at the reference's
grid_sample(align_corners=False) coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from openglue_tpu_torch.core.types import Features
from openglue_tpu_torch.features.nets import full_f32, gray_batch, top_k
from openglue_tpu_torch.models.layers import GroupBatchNorm2d

# (conv{i}a in, out, conv{i}b in, out) per block
_LAYER_CHANNELS = ((1, 64, 64, 64), (64, 64, 64, 64), (64, 128, 128, 128), (128, 128, 128, 128))


class SuperPointBackbone(nn.Module):
    """VGG-style encoder with the detector and descriptor heads
    (model.py:35-78); ``bn`` puts a BatchNorm after every convolution
    (SuperPointNetBn, model.py:132-199; the JAX package's flax momentum 0.9
    is torch's 0.1).

    ``forward``: [B, 1, H, W] (or [B, H, W]) grayscale in [0, 1], H and W
    multiples of 8 -> (descriptors [B, D, H/8, W/8] L2-normalized, cell
    scores [B, 64, H/8, W/8])."""

    def __init__(self, descriptor_dim: int = 256, bn: bool = False):
        super().__init__()
        self.bn = bn
        widths = {}
        for i, (ia, oa, ib, ob) in enumerate(_LAYER_CHANNELS):
            widths[f"{i + 1}a"], widths[f"{i + 1}b"] = (ia, oa, 3), (ib, ob, 3)
        widths.update(Pa=(128, 256, 3), Pb=(256, 65, 1), Da=(128, 256, 3), Db=(256, descriptor_dim, 1))
        for name, (cin, cout, k) in widths.items():
            setattr(self, f"conv{name}", nn.Conv2d(cin, cout, k, padding=k // 2))
            if bn:
                setattr(self, f"bn{name}", GroupBatchNorm2d(cout, eps=1e-5, momentum=0.1))

    def _layer(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = getattr(self, f"conv{name}")(x)
        return getattr(self, f"bn{name}")(x) if self.bn else x

    def maps(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = gray_batch(image)[:, None]
        for i in range(1, 5):
            x = F.relu(self._layer(x, f"{i}a"))
            x = F.relu(self._layer(x, f"{i}b"))
            if i != 4:
                x = F.max_pool2d(x, 2, 2)
        d = self._layer(F.relu(self._layer(x, "Da")), "Db")
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        s = self._layer(F.relu(self._layer(x, "Pa")), "Pb")
        return d, torch.softmax(s, dim=1)[:, :-1]

    forward = full_f32()(maps)


def depth_to_space_scores(scores: torch.Tensor) -> torch.Tensor:
    """[B, 64, Hc, Wc] cell scores -> [B, Hc*8, Wc*8] heatmap (model.py:85-88):
    channel 8i + j of cell (y, x) is pixel (8y + i, 8x + j)."""
    return F.pixel_shuffle(scores, 8)[:, 0]


def nms2d(scores: torch.Tensor, kernel_size: int = 9) -> torch.Tensor:
    """Zero every score that is not the maximum of its kernel_size window
    (kornia nms2d semantics, model.py:93; the window padded with -inf);
    scores [B, H, W]."""
    pooled = F.max_pool2d(scores[:, None], kernel_size, stride=1, padding=kernel_size // 2)[:, 0]
    return torch.where(scores == pooled, scores, 0.0)


def remove_borders_mask(h: int, w: int, border: int, device=None) -> torch.Tensor:
    """[H, W] bool, False within ``border`` px of an edge (reference
    utils.py:4-10 drops those keypoints)."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    return ((ys >= border) & (ys < h - border))[:, None] & ((xs >= border) & (xs < w - border))[None, :]


def select_keypoints(
    scores: torch.Tensor, max_keypoints: int, threshold: float = 0.0, border: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS'd [B, H, W] scores -> keypoints [B, K, 2] (x, y), scores [B, K],
    valid [B, K]: the K best pixels outside the border, in JAX's top-k order
    (zero-score padding rows by increasing pixel index)."""
    b, h, w = scores.shape
    masked = torch.where(remove_borders_mask(h, w, border, scores.device)[None], scores, 0.0)
    top_scores, top_idx = top_k(masked.reshape(b, h * w), max_keypoints)
    kpts = torch.stack([(top_idx % w).float(), (top_idx // w).float()], dim=-1)
    return kpts, top_scores, top_scores > threshold


def sample_descriptors(desc_map: torch.Tensor, kpts: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """Bilinear descriptor sampling at keypoint pixels (utils.py:13-31).

    desc_map [B, D, Hc, Wc]; kpts [B, K, 2] (x, y) in full-resolution pixels
    -> [B, K, D] L2-normalized. The reference's normalization, then the
    align_corners=False mapping; each tap's index clamps to the map (where
    grid_sample would read zeros: only border keypoints, which selection
    drops)."""
    b, d, hc, wc = desc_map.shape
    H, W = hc * cell, wc * cell
    pts = kpts - cell / 2 + 0.5
    px = pts[..., 0] / (W - cell / 2 - 0.5) * 2.0 - 1.0
    py = pts[..., 1] / (H - cell / 2 - 0.5) * 2.0 - 1.0
    gx = ((px + 1.0) * wc - 1.0) / 2.0
    gy = ((py + 1.0) * hc - 1.0) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    nhwc = desc_map.permute(0, 2, 3, 1)
    batch_idx = torch.arange(b, device=desc_map.device)[:, None]

    def tap(xi, yi):
        return nhwc[batch_idx, yi.to(torch.int64).clamp(0, hc - 1), xi.to(torch.int64).clamp(0, wc - 1)]

    out = (
        tap(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
        + tap(x0 + 1, y0) * (wx * (1 - wy))[..., None]
        + tap(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
        + tap(x0 + 1, y0 + 1) * (wx * wy)[..., None]
    )
    return out / torch.clamp_min(torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)


def keypoints_to_lafs(kpts: torch.Tensor) -> torch.Tensor:
    """[B, K, 2] -> [B, K, 2, 3] LAFs with an identity shape (model.py:120-127)."""
    eye = torch.eye(2, dtype=kpts.dtype, device=kpts.device).expand(*kpts.shape[:2], 2, 2)
    return torch.cat([eye, kpts[..., None]], dim=-1)


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    max_keypoints: int = 1024
    descriptor_dim: int = 256
    nms_kernel: int = 9
    remove_borders_size: int = 4
    keypoint_threshold: float = 0.0
    bn: bool = False


class SuperPoint(SuperPointBackbone):
    """The whole extractor: image [B, 1, H, W] (or [B, H, W]) -> ``Features``
    with static [B, K] shapes. The backbone's layers sit at the top level
    of the state dict, under the reference's keys."""

    def __init__(self, config: SuperPointConfig):
        super().__init__(config.descriptor_dim, config.bn)
        self.config = config

    @full_f32()
    def forward(self, image: torch.Tensor) -> Features:
        cfg = self.config
        desc_map, cell_scores = self.maps(image)
        heatmap = nms2d(depth_to_space_scores(cell_scores), cfg.nms_kernel)
        kpts, scores, valid = select_keypoints(heatmap, cfg.max_keypoints, cfg.keypoint_threshold,
                                               cfg.remove_borders_size)
        return Features(lafs=keypoints_to_lafs(kpts), responses=scores,
                        descriptors=sample_descriptors(desc_map, kpts), mask=valid)


def rename_thirdparty_superpoint_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Key remapping for third-party KITTI/COCO SuperPoint checkpoints
    (reference superpoint/model.py:151-171)."""
    mapping = {}
    for i, block in enumerate(["inc.conv.conv", "down1.mpconv.1.conv", "down2.mpconv.1.conv", "down3.mpconv.1.conv"]):
        mapping[f"{block}.0"] = f"conv{i + 1}a"
        mapping[f"{block}.1"] = f"bn{i + 1}a"
        mapping[f"{block}.3"] = f"conv{i + 1}b"
        mapping[f"{block}.4"] = f"bn{i + 1}b"
    out = {}
    for key, value in state_dict.items():
        new_key = key
        for old, new in mapping.items():
            if key.startswith(old + "."):
                new_key = new + key[len(old):]
                break
        out[new_key] = value
    return out


def load_extractor_weights(model: nn.Module, weights_path) -> nn.Module:
    """Load a torch checkpoint into an extractor (the extractor's part of
    ``openglue_tpu/cli/online.py::load_extractor_weights_into``): a state
    dict under the module's own keys (the reference's ``superpoint_v1.pth``
    for SuperPoint), or a third-party checkpoint holding it under
    ``model_state_dict`` with the pytorch-superpoint keys, renamed. Strict:
    a missing or unknown key raises. Returns ``model``."""
    state = torch.load(weights_path, map_location="cpu")
    if "model_state_dict" in state:
        state = rename_thirdparty_superpoint_keys(state["model_state_dict"])
    model.load_state_dict(state)
    return model
