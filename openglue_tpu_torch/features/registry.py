"""Feature-extractor registry (port of ``openglue_tpu/features/registry.py``;
reference models/features/__init__.py:8-24).

Two kinds of extractors, as in the JAX package:
  * device extractors (SuperPoint, the DoG SIFT, GFTT-AffNet-HardNet), which
    run on the matcher's device; none is ported yet (ROADMAP.md module 9),
    and asking for one raises NotImplementedError;
  * host extractors (OpenCV), run by the offline cacher and the serving
    entry point: ``OPENCV_SIFT``. ``OPENCVDoGAffNetHardNet`` runs the AffNet
    and HardNet networks, which wait for module 9 too.

``get_feature_extractor(name)`` returns the constructor. Unknown names raise
ValueError (the reference's unknown-name path silently returns None —
models/features/__init__.py:33 builds but never raises; fixed here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from openglue_tpu_torch.features.opencv_features import sift_create

DEVICE_EXTRACTORS = ("SuperPointNet", "SuperPointNetBn", "SIFT", "GFTTAffNetHardNet")
HOST_EXTRACTORS: Dict[str, Callable[..., Any]] = {"OPENCV_SIFT": sift_create}
UNPORTED = DEVICE_EXTRACTORS + ("OPENCVDoGAffNetHardNet",)


def get_feature_extractor(name: str) -> Callable[..., Any]:
    if name in HOST_EXTRACTORS:
        return HOST_EXTRACTORS[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"feature extractor {name!r} is not ported yet: ROADMAP.md module 9 (ported: "
            f"{sorted(HOST_EXTRACTORS)})"
        )
    raise ValueError(
        f"Unknown feature extractor {name!r}; device: {sorted(DEVICE_EXTRACTORS)}, "
        f"host (cached-extraction only): {sorted([*HOST_EXTRACTORS, 'OPENCVDoGAffNetHardNet'])}"
    )


def is_device_extractor(name: str) -> bool:
    return name in DEVICE_EXTRACTORS
