"""Combined extractor + matcher module for online training (port of
``openglue_tpu/models/matching_module.py``; reference
models/matching_module.py:17-187).

Holds a device feature extractor (SuperPoint, SuperPoint with BatchNorms,
the DoG SIFT or GFTT-AffNet-HardNet) and the SuperGlue matcher; the
LAF -> side-info conversion sits between them (reference
matching_module.py:40-43 wires side_info_dim = converter dims + 1 for the
response). ``finetune=False`` is the reference's frozen extractor
(requires_grad=False + eval() per step, matching_module.py:29-31,77-78): the
extractor runs without autograd, its BatchNorms on their running
statistics, and ``train.state.make_online_optimizer`` leaves it out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from openglue_tpu_torch.core.types import Features, PairBatch, superglue_inputs
from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
from openglue_tpu_torch.features.nets import seeded_init_
from openglue_tpu_torch.features.prepare import features_to_keypoint_set
from openglue_tpu_torch.features.superpoint import SuperPoint, SuperPointConfig
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig


@dataclasses.dataclass(frozen=True)
class MatchingModuleConfig:
    superglue: SuperGlueConfig
    extractor_name: str = "SuperPointNet"
    extractor_params: Any = dataclasses.field(default_factory=dict)
    laf_converter: str = "none"
    finetune: bool = False
    log_response: bool = False

    @classmethod
    def from_dict(cls, cfg: Mapping[str, Any]) -> "MatchingModuleConfig":
        """Assemble from a reference-schema config: features params +
        superglue block; descriptor_dim and side_info_size are propagated into
        the matcher config (reference matching_module.py:35-43)."""
        features = cfg.get("features", {})
        name = features.get("name", "SuperPointNet")
        params = dict(features.get("parameters", {}))
        if name.startswith("SuperPointNet"):
            fields = {f.name for f in dataclasses.fields(SuperPointConfig)}
            params = {k: v for k, v in params.items() if k in fields}
            descriptor_dim = SuperPointConfig(**params).descriptor_dim
        else:
            descriptor_dim = int(features.get("descriptor_dim", params.get("descriptor_dim", 128)))
        laf_name = cfg.get("laf_to_sideinfo_method", "none")
        converter = get_laf_to_sideinfo_converter(laf_name)
        sg_cfg = dict(cfg.get("superglue", {}))
        sg_cfg["descriptor_dim"] = descriptor_dim
        sg = SuperGlueConfig.from_dict(sg_cfg)
        sg = dataclasses.replace(sg, side_info_size=converter.side_info_dim + 1)
        return cls(
            superglue=sg,
            extractor_name=name,
            extractor_params=params,
            laf_converter=laf_name,
            finetune=cfg.get("train", {}).get("finetune_features_extractor", False),
            log_response=features.get("log_response", False),
        )


def build_extractor(name: str, params: Mapping[str, Any]) -> nn.Module:
    """The device extractor ``name`` of ``features.registry``; a SuperPoint
    name picks the BatchNorm variant by itself."""
    from openglue_tpu_torch.features.registry import DEVICE_EXTRACTORS

    if name.startswith("SuperPointNet"):
        params = dict(params)
        params.pop("bn", None)  # the variant name decides
        return SuperPoint(SuperPointConfig(**params, bn=(name == "SuperPointNetBn")))
    if name not in DEVICE_EXTRACTORS:
        raise ValueError(
            f"MatchingModule requires a device extractor; {name!r} is not one of {sorted(DEVICE_EXTRACTORS)}"
        )
    return DEVICE_EXTRACTORS[name](**dict(params))


class MatchingModule(nn.Module):
    """image pair -> extracted features -> SuperGlue log-assignment.

    Submodules ``extractor`` (its convolutions drawn from
    ``extractor_generator``, as ``cli.extract_features.build_device_extractor``
    draws them) and ``superglue`` (from ``generator``), on ``device``. The
    module's training mode is the step's: the extractor trains with it only
    when ``config.finetune``."""

    def __init__(
        self,
        config: MatchingModuleConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
        extractor_generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.config = config
        self.extractor = seeded_init_(build_extractor(config.extractor_name, config.extractor_params),
                                      extractor_generator)
        if not config.finetune:
            self.extractor.requires_grad_(False)
        self.superglue = SuperGlue(config.superglue, device=device, generator=generator)
        self.laf_converter = get_laf_to_sideinfo_converter(config.laf_converter)
        self.to(device)

    def extract(self, image: torch.Tensor) -> Features:
        """image: [B, H, W] in [0, 1]."""
        if self.config.finetune:
            self.extractor.train(self.training)
            return self.extractor(image)
        self.extractor.eval()
        with torch.no_grad():
            return self.extractor(image)

    def forward(self, image0: torch.Tensor, image1: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], PairBatch]:
        image_size = [float(image0.shape[2]), float(image0.shape[1])]
        if (self.training and self.config.finetune) or image0.shape != image1.shape:
            # training BatchNorm statistics must see each image batch
            # separately (reference matching_module.py:71-79 calls the
            # extractor once per side)
            feats0, feats1 = self.extract(image0), self.extract(image1)
        else:
            # a frozen or eval extractor: one 2B-image call (eval BatchNorm is
            # a per-sample affine, so the halves are the two calls' outputs)
            batch = image0.shape[0]
            feats = self.extract(torch.cat([image0, image1], dim=0))
            feats0, feats1 = (Features(*(getattr(feats, f.name)[part] for f in dataclasses.fields(Features)))
                              for part in (slice(None, batch), slice(batch, None)))
        side0 = features_to_keypoint_set(feats0, self.laf_converter, image_size, self.config.log_response)
        side1 = features_to_keypoint_set(feats1, self.laf_converter, image_size, self.config.log_response)
        pair = PairBatch(side0=side0, side1=side1)
        return self.superglue(**superglue_inputs(pair)), pair
