"""Carry JAX-package matcher weights into the port.

``superglue_state_dict_from_jax`` takes the JAX variable tree as nested dicts
of numpy arrays (``{"params": ..., "batch_stats": ...}`` and, where the model
has them, the ``favor_projections`` and ``int8_calib`` collections) and
returns the port's ``state_dict``, named after the reference torch keys. Dense
kernels ``[in, out]`` become 1x1-conv weights ``[out, in, 1]``; BatchNorm
scale/bias/mean/var become weight/bias/running_mean/running_var; a layer's
FAVOR projection becomes its ``mha.projection`` buffer and its calibration
vector its ``act_absmax`` buffer.
``superglue_grads_from_jax`` maps a gradient tree of the JAX parameters onto
the port's parameter names with the same transposes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from openglue_tpu_torch.models.superglue import SuperGlueConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any], s: Optional[Mapping[str, Any]]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{name}.running_mean"] = _t(s["mean"])
        sd[f"{name}.running_var"] = _t(s["var"])


def _ffn(sd, prefix: str, params: Mapping[str, Any], stats: Optional[Mapping[str, Any]], num_hidden: int):
    for i in range(num_hidden):
        _dense(sd, f"{prefix}.{3 * i}", params[f"dense_{i}"])
        _bn(sd, f"{prefix}.{3 * i + 2}", params[f"bn_{i}"], None if stats is None else stats[f"bn_{i}"])
    _dense(sd, f"{prefix}.{3 * num_hidden}", params[f"dense_{num_hidden}"])


def _convert(
    params: Mapping[str, Any], stats: Optional[Mapping[str, Any]], config: SuperGlueConfig
) -> Dict[str, torch.Tensor]:
    """Port names and layouts for a parameter tree; the BatchNorm running
    statistics too when ``stats`` is given."""

    def sub(*keys):
        node = stats
        for key in keys:
            node = None if node is None else node[key]
        return node

    sd: Dict[str, torch.Tensor] = {}
    encoder = params["positional_encoding"]["encoder"]
    if config.pe_encoder_name == "FeedForwardNetSiren":
        for name, p in encoder.items():
            _dense(sd, f"positional_encoding.encoder.{name}", p)
    else:
        _ffn(
            sd, "positional_encoding.encoder", encoder,
            sub("positional_encoding", "encoder"), len(config.pe_hidden_layers_sizes),
        )
    for stage in range(config.num_stages):
        for offset, kind in ((0, "self"), (1, "cross")):
            prefix = f"attention_gnn.layers.{2 * stage + offset}.module"
            layer = params["attention_gnn"][f"{kind}_{stage}"]
            for jax_name, torch_name in (
                ("q_proj", "in_proj_q"), ("k_proj", "in_proj_k"),
                ("v_proj", "in_proj_v"), ("out_proj", "out_proj"),
            ):
                _dense(sd, f"{prefix}.mha.{torch_name}", layer["mha"][jax_name])
            _ffn(sd, f"{prefix}.fc", layer["ffn"],
                 sub("attention_gnn", f"{kind}_{stage}", "ffn"), num_hidden=1)
    _dense(sd, "linear_proj", params["linear_proj"])
    if config.residual:
        sd["mix_coefs"] = _t(np.asarray(params["mix_coefs"])[:, None])
    sd["dustbin_score"] = _t(params["dustbin_score"])
    return sd


def superglue_state_dict_from_jax(
    variables: Mapping[str, Any], config: SuperGlueConfig
) -> Dict[str, torch.Tensor]:
    """The port's SuperGlue state dict from JAX SuperGlue variables."""
    sd = _convert(variables["params"], variables["batch_stats"], config)
    for stage in range(config.num_stages):
        for offset, kind in ((0, "self"), (1, "cross")):
            prefix = f"attention_gnn.layers.{2 * stage + offset}.module"
            name = f"{kind}_{stage}"
            favor = variables.get("favor_projections", {}).get("attention_gnn", {})
            if name in favor:
                sd[f"{prefix}.mha.projection"] = _t(favor[name]["mha"]["projection"])
            calib = variables.get("int8_calib", {}).get("attention_gnn", {})
            if name in calib:
                sd[f"{prefix}.act_absmax"] = _t(calib[name]["act_absmax"])
    return sd


def superglue_grads_from_jax(
    grads: Mapping[str, Any], config: SuperGlueConfig
) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of the SuperGlue parameters (``jax.grad`` with
    respect to ``variables["params"]``) under the port's parameter names and
    layouts, comparable with ``{name: p.grad}``."""
    return _convert(grads, None, config)
