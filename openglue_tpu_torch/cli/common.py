"""Shared CLI plumbing (port of ``openglue_tpu/cli/common.py``:
``superglue_config_from``, ``loss_config_from``, the FAVOR redraw interval of
``loop_config_from`` and the optimizer the cached trainer builds from the
``train`` section). It takes plain dicts, so no YAML
reader is needed."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Optional

import torch

from openglue_tpu_torch.models.superglue import SuperGlueConfig
from openglue_tpu_torch.train.state import ClippedAdam, make_optimizer, make_warmup_optimizer
from openglue_tpu_torch.train.step import LossConfig


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


def loss_config_from(config: Mapping[str, Any]) -> LossConfig:
    """LossConfig from a config's ``train`` section."""
    train = config.get("train", {})
    return LossConfig(
        positive_threshold=float(train.get("gt_positive_threshold", 2.0)),
        negative_threshold=float(train.get("gt_negative_threshold", 7.0)),
        nll_weight=float(train.get("nll_weight", 1.0)),
        metric_weight=float(train.get("metric_weight", 0.0)),
        margin=train.get("margin"),
    )


def favor_redraw_interval(config: Mapping[str, Any]) -> Optional[int]:
    """How often, in steps, the trainer redraws the FAVOR projections
    (``train.step.redraw_favor_projections``): the ``redraw_interval`` of the
    ``superglue.attention_gnn`` section for a FAVOR kind, else None."""
    gnn = config.get("superglue", {}).get("attention_gnn", {}) or {}
    if str(gnn.get("attention", "")).startswith("favor"):
        return gnn.get("redraw_interval")
    return None


def optimizer_from(config: Mapping[str, Any], params: Iterable[torch.Tensor]) -> ClippedAdam:
    """The cached trainer's optimizer from a config's ``train`` section: Adam
    at ``lr`` with the per-step ``scheduler_gamma`` decay (after
    ``warmup_steps`` of linear warmup when set) and ``grad_clip``."""
    train = config.get("train", {})
    kw = dict(
        learning_rate=float(train.get("lr", 1e-4)),
        gamma=float(train.get("scheduler_gamma", 0.999994)),
        gradient_clip=float(train.get("grad_clip", 10.0)),
    )
    warmup_steps = int(train.get("warmup_steps", 0))
    if warmup_steps > 0:
        return make_warmup_optimizer(params, warmup_steps=warmup_steps, **kw)
    return make_optimizer(params, **kw)
