"""Raw extractor output -> the matcher's input (port of
``openglue_tpu/features/prepare.py``; reference models/features/utils.py:54-65).

The side information is built on the host in numpy, with the port's numpy
LAF helpers (``features/lafs.py``), as the collate builds it; the finished
arrays then go to the caller's device once each (from page-locked memory
without blocking the host, for a CUDA device). ``features_to_keypoint_set``
takes the device extractors' ``Features``, which wait for ROADMAP.md module 9.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from openglue_tpu_torch.core.types import KeypointSet
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
