"""Shared CLI plumbing (port of ``openglue_tpu/cli/common.py``:
``superglue_config_from`` only). It takes a plain dict, so no YAML reader is
needed."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from openglue_tpu_torch.models.superglue import SuperGlueConfig


def superglue_config_from(
    config: Mapping[str, Any], descriptor_dim: int, side_info_dim: int
) -> SuperGlueConfig:
    """SuperGlueConfig from a config's ``superglue`` section; the decode stats
    are on unless the config turns them off."""
    sg = dict(config.get("superglue", {}))
    sg["descriptor_dim"] = descriptor_dim
    sg.setdefault("decode_stats", True)
    cfg = SuperGlueConfig.from_dict(sg)
    return dataclasses.replace(cfg, side_info_size=side_info_dim + 1)
