"""Raw extractor output -> the matcher's input (port of
``openglue_tpu/features/prepare.py``; reference models/features/utils.py:54-65).

``prepare_features_output`` builds the side information on the host in
numpy, with the LAF helpers (``features/lafs.py``), as the collate builds it;
the finished arrays then go to the caller's device once each (from
page-locked memory without blocking the host, for a CUDA device). The
serving path takes a device extractor's output as host arrays too
(``cli.extract_features.extract_on_device``). ``features_to_keypoint_set``
takes ``Features`` on the device, as the online train step has them, and
builds the same side information there, with no copy to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from openglue_tpu_torch.core.types import Features, KeypointSet
from openglue_tpu_torch.features.lafs import LAFConverter, laf_center


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: for a CUDA device, through
    page-locked memory and a copy queued behind the device's work."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def prepare_features_output(
    lafs: np.ndarray,
    responses: np.ndarray,
    descriptors: np.ndarray,
    laf_converter: LAFConverter,
    image_size: np.ndarray,
    mask: Optional[np.ndarray] = None,
    log_response: bool = False,
    device="cpu",
) -> KeypointSet:
    """keypoints = LAF centers; side_info = concat[response, converter(lafs)]
    with optional log(r + 0.1) transform (reference features/utils.py:54-65).

    Host arrays: lafs [B, N, 2, 3], responses [B, N], descriptors [B, N, D],
    image_size [2] or [B, 2] as (width, height), mask [B, N] (default all
    valid). Returns the KeypointSet on ``device``."""
    lafs = np.asarray(lafs, np.float32)
    kpts = laf_center(lafs)
    resp = np.asarray(responses, np.float32)[..., None]
    if log_response:
        resp = np.log(resp + np.float32(0.1))
    side_info = np.concatenate([resp, laf_converter(lafs)], axis=-1)
    if mask is None:
        mask = np.ones(kpts.shape[:2], dtype=bool)
    image_size = np.asarray(image_size, np.float32)
    if image_size.ndim == 1:
        image_size = np.broadcast_to(image_size, (kpts.shape[0], 2)).copy()
    return KeypointSet(
        keypoints=to_device(kpts, device),
        descriptors=to_device(np.asarray(descriptors, np.float32), device),
        side_info=to_device(side_info, device),
        mask=to_device(np.asarray(mask, bool), device),
        image_size=to_device(image_size, device),
    )


def features_to_keypoint_set(
    features: Features,
    laf_converter: LAFConverter,
    image_size,
    log_response: bool = False,
) -> KeypointSet:
    """``prepare_features_output`` on the tensors of a device extractor's
    ``Features``, on their device: image_size [2] or [B, 2] as (width,
    height)."""
    lafs = features.lafs
    resp = features.responses[..., None]
    if log_response:
        resp = torch.log(resp + 0.1)
    side_info = torch.cat([resp, laf_converter(lafs)], dim=-1)
    image_size = torch.as_tensor(image_size, dtype=torch.float32)
    if image_size.dim() == 1:  # filled on the device: no copy from the host
        image_size = torch.stack([lafs.new_full(lafs.shape[:1], v) for v in image_size.tolist()], dim=-1)
    else:
        image_size = image_size.to(lafs.device)
    return KeypointSet(
        keypoints=laf_center(lafs),
        descriptors=features.descriptors,
        side_info=side_info,
        mask=features.mask,
        image_size=image_size,
    )
