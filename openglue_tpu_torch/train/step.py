"""Training-step helpers (port of ``openglue_tpu/train/step.py``; only the
input mapping so far: the training step itself comes with a later slice)."""

from __future__ import annotations

from typing import Any, Dict

from openglue_tpu_torch.core.types import PairBatch


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
