"""Feature-extractor registry (port of ``openglue_tpu/features/registry.py``;
reference models/features/__init__.py:8-24).

Two kinds of extractors, as in the JAX package:
  * device extractors (``nn.Module``s: SuperPoint, SuperPoint with
    BatchNorms, the DoG SIFT, GFTT-AffNet-HardNet), built by
    ``cli.extract_features.build_device_extractor`` on the caller's device;
  * host extractors, run by the offline cacher and the serving entry point
    on numpy images: ``OPENCV_SIFT`` and ``OPENCVDoGAffNetHardNet``, whose
    detector is OpenCV's and whose AffNet, OriNet and HardNet run on a
    device (``build_host_extractor``).

``get_feature_extractor(name)`` returns the constructor. Unknown names raise
ValueError (the reference's unknown-name path silently returns None —
models/features/__init__.py:33 builds but never raises; fixed here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

from openglue_tpu_torch.features.dog_affnet_hardnet import dog_affnet_hardnet_create
from openglue_tpu_torch.features.gftt_hardnet import GFTTAffNetHardNet, GFTTAffNetHardNetConfig
from openglue_tpu_torch.features.opencv_features import sift_create
from openglue_tpu_torch.features.sift import SIFTFeature
from openglue_tpu_torch.features.superpoint import SuperPoint, SuperPointConfig


def _superpoint(**params):
    return SuperPoint(SuperPointConfig(**params))


def _superpoint_bn(**params):
    return SuperPoint(SuperPointConfig(bn=True, **params))


def _gftt_affnet_hardnet(**params):
    return GFTTAffNetHardNet(GFTTAffNetHardNetConfig(**params))


DEVICE_EXTRACTORS: Dict[str, Callable[..., Any]] = {
    "SuperPointNet": _superpoint,
    "SuperPointNetBn": _superpoint_bn,
    "SIFT": SIFTFeature,  # DoG + (Root)SIFT on the device (kornia SIFT in the reference)
    "GFTTAffNetHardNet": _gftt_affnet_hardnet,
}
HOST_EXTRACTORS: Dict[str, Callable[..., Any]] = {
    "OPENCV_SIFT": sift_create,
    "OPENCVDoGAffNetHardNet": dog_affnet_hardnet_create,
}
# host extractors with networks, which take the device they run on
_HOST_WITH_NETWORKS = ("OPENCVDoGAffNetHardNet",)


def get_feature_extractor(name: str) -> Callable[..., Any]:
    if name in DEVICE_EXTRACTORS:
        return DEVICE_EXTRACTORS[name]
    if name in HOST_EXTRACTORS:
        return HOST_EXTRACTORS[name]
    raise ValueError(
        f"Unknown feature extractor {name!r}; device: {sorted(DEVICE_EXTRACTORS)}, "
        f"host (cached-extraction only): {sorted(HOST_EXTRACTORS)}"
    )


def is_device_extractor(name: str) -> bool:
    return name in DEVICE_EXTRACTORS


def uses_device(name: str) -> bool:
    """Whether the extractor computes on a device (every device extractor,
    and the host extractors with networks)."""
    return is_device_extractor(name) or name in _HOST_WITH_NETWORKS


def build_host_extractor(features_config: Mapping[str, Any], device):
    """A host extractor from its features config; one with networks runs
    them on ``device``."""
    name = features_config["name"]
    params = dict(features_config.get("parameters", {}))
    if name in _HOST_WITH_NETWORKS:
        params["device"] = device
    return get_feature_extractor(name)(**params)
