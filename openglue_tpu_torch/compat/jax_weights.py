"""Carry matcher weights between the JAX package and the port.

``superglue_state_dict_from_jax`` takes the JAX variable tree as nested dicts
of numpy arrays (``{"params": ..., "batch_stats": ...}`` and, where the model
has them, the ``favor_projections`` and ``int8_calib`` collections) and
returns the port's ``state_dict``, named after the reference torch keys. Dense
kernels ``[in, out]`` become 1x1-conv weights ``[out, in, 1]``; BatchNorm
scale/bias/mean/var become weight/bias/running_mean/running_var; a layer's
FAVOR projection becomes its ``mha.projection`` buffer and its calibration
vector its ``act_absmax`` buffer; a model that serves an ``int8_static*``
mode is marked calibrated (``int8_calibration``) exactly when the variables
hold the ``int8_calib`` collection, as the JAX package tells a calibrated
matcher. ``jax_variables_from_state_dict`` is the
inverse, and ``superglue_grads_from_jax`` maps a gradient tree of the JAX
parameters onto the port's parameter names with the same transposes.
``load_npz_tree`` reads the JAX package's weight files (``save_weights``:
one npz entry per leaf, keyed by its path) into such a tree.

All three directions follow one table, ``_layout``: for every port entry,
its JAX collection and path and how its layout changes.

The device extractors' carriers (``superpoint_state_dict_from_jax``,
``hardnet_…``, ``affnet_…``, ``orinet_…`` and
``gftt_affnet_hardnet_state_dict_from_jax``) take the JAX variables of each
network the same way and return the port's state dict, named after the
reference's (SuperPoint) or kornia's (``features.N``) torch keys.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from openglue_tpu_torch.models.superglue import SuperGlueConfig, static_int8

# (port name, JAX collection, JAX path, layout): "dense" is a kernel
# [in, out] <-> weight [out, in, 1]; "column" is [D] <-> [D, 1]; "same" is as is
Entry = Tuple[str, str, Tuple[str, ...], str]


def _dense(name: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{name}.weight", "params", path + ("kernel",), "dense"),
            (f"{name}.bias", "params", path + ("bias",), "same")]


def _bn(name: str, path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{name}.weight", "params", path + ("scale",), "same"),
            (f"{name}.bias", "params", path + ("bias",), "same"),
            (f"{name}.running_mean", "batch_stats", path + ("mean",), "same"),
            (f"{name}.running_var", "batch_stats", path + ("var",), "same")]


def _ffn(prefix: str, path: Tuple[str, ...], num_hidden: int) -> List[Entry]:
    out: List[Entry] = []
    for i in range(num_hidden):
        out += _dense(f"{prefix}.{3 * i}", path + (f"dense_{i}",))
        out += _bn(f"{prefix}.{3 * i + 2}", path + (f"bn_{i}",))
    return out + _dense(f"{prefix}.{3 * num_hidden}", path + (f"dense_{num_hidden}",))


def _layout(config: SuperGlueConfig) -> List[Entry]:
    """Every parameter and BatchNorm statistic of the matcher, and every
    FAVOR projection and int8 calibration buffer it may have."""
    encoder = ("positional_encoding", "encoder")
    if config.pe_encoder_name == "FeedForwardNetSiren":
        out: List[Entry] = []
        for i in range(len(config.pe_hidden_layers_sizes) + 1):
            out += _dense(f"positional_encoding.encoder.dense_{i}", encoder + (f"dense_{i}",))
    else:
        out = _ffn("positional_encoding.encoder", encoder, len(config.pe_hidden_layers_sizes))
    for stage in range(config.num_stages):
        for offset, kind in ((0, "self"), (1, "cross")):
            prefix = f"attention_gnn.layers.{2 * stage + offset}.module"
            layer = ("attention_gnn", f"{kind}_{stage}")
            for jax_name, torch_name in (
                ("q_proj", "in_proj_q"), ("k_proj", "in_proj_k"),
                ("v_proj", "in_proj_v"), ("out_proj", "out_proj"),
            ):
                out += _dense(f"{prefix}.mha.{torch_name}", layer + ("mha", jax_name))
            out += _ffn(f"{prefix}.fc", layer + ("ffn",), num_hidden=1)
            out.append((f"{prefix}.mha.projection", "favor_projections", layer + ("mha", "projection"), "same"))
            out.append((f"{prefix}.act_absmax", "int8_calib", layer + ("act_absmax",), "same"))
    out += _dense("linear_proj", ("linear_proj",))
    if config.residual:
        out.append(("mix_coefs", "params", ("mix_coefs",), "column"))
    out.append(("dustbin_score", "params", ("dustbin_score",), "same"))
    return out


def _lookup(tree: Mapping[str, Any], path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    return node


def _to_port(value, layout: str) -> torch.Tensor:
    value = np.array(value, dtype=np.float32)
    if layout == "dense":
        value = value.T[:, :, None].copy()
    elif layout == "column":
        value = value[:, None]
    return torch.from_numpy(value)


def _to_jax(value: torch.Tensor, layout: str) -> np.ndarray:
    value = value.detach().float().cpu().numpy()
    if layout == "dense":
        return np.ascontiguousarray(value[:, :, 0].T)
    if layout == "column":
        return value[:, 0]
    return value


_OPTIONAL = ("favor_projections", "int8_calib")


def superglue_state_dict_from_jax(
    variables: Mapping[str, Any], config: SuperGlueConfig
) -> Dict[str, torch.Tensor]:
    """The port's SuperGlue state dict from JAX SuperGlue variables."""
    sd: Dict[str, torch.Tensor] = {}
    for name, collection, path, layout in _layout(config):
        value = _lookup(variables, (collection,) + path)
        if value is None and collection in _OPTIONAL:
            continue
        if value is None:
            raise KeyError(f"JAX variables miss {collection}/{'/'.join(path)} (port {name})")
        sd[name] = _to_port(value, layout)
    if static_int8(config):
        sd["int8_calibration._extra_state"] = {"calibrated": "int8_calib" in variables}
    return sd


def jax_variables_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], config: SuperGlueConfig
) -> Dict[str, Any]:
    """The JAX SuperGlue variables (nested dicts of numpy arrays) from the
    port's state dict: ``superglue_state_dict_from_jax`` inverted."""
    tree: Dict[str, Any] = {}
    for name, collection, path, layout in _layout(config):
        if name not in state_dict:
            if collection in _OPTIONAL:
                continue
            raise KeyError(f"state dict misses {name}")
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax(state_dict[name], layout)
    return tree


def superglue_grads_from_jax(
    grads: Mapping[str, Any], config: SuperGlueConfig
) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of the SuperGlue parameters (``jax.grad`` with
    respect to ``variables["params"]``) under the port's parameter names and
    layouts, comparable with ``{name: p.grad}``."""
    return {
        name: _to_port(_lookup(grads, path), layout)
        for name, collection, path, layout in _layout(config) if collection == "params"
    }


def load_npz_tree(path) -> Dict[str, Any]:
    """A JAX weight file (``save_weights``: npz entries keyed by
    ``jax.tree_util.keystr`` of the leaf's path, ``['params']['linear_proj']
    ['kernel']``) as nested dicts of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if not (key.startswith("['") and key.endswith("']")):
                raise ValueError(f"{path}: {key!r} is not a key path of dict entries")
            parts = key[2:-2].split("']['")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return tree


def save_npz_tree(path, tree: Mapping[str, Any]) -> None:
    """Nested dicts of arrays as the JAX package's weight file."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, keys):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, keys + (k,))
        else:
            flat["".join(f"['{k}']" for k in keys)] = np.asarray(node)

    walk(tree, ())
    np.savez(path, **flat)


# --- the device extractors ----------------------------------------------------
# flax convolution kernels are (kh, kw, in, out) on NHWC, torch's weights
# (out, in, kh, kw) on NCHW; flax BatchNorm scale/bias/mean/var are torch's
# weight/bias/running_mean/running_var (flax momentum 0.9 is torch's 0.1,
# a setting of the module, not a weight)


def _conv_weight(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(kernel, np.float32).transpose(3, 2, 0, 1)))


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32))


def superpoint_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's SuperPoint state dict (the reference's keys) from the JAX
    SuperPoint variables; the BatchNorms of ``SuperPointNetBn`` come along
    when the variables have them."""
    params = variables["params"]["backbone"]
    stats = variables.get("batch_stats", {}).get("backbone", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, entry in params.items():
        if name.startswith("conv"):
            sd[f"{name}.weight"] = _conv_weight(entry["kernel"])
            sd[f"{name}.bias"] = _tensor(entry["bias"])
        else:
            sd[f"{name}.weight"] = _tensor(entry["scale"])
            sd[f"{name}.bias"] = _tensor(entry["bias"])
            sd[f"{name}.running_mean"] = _tensor(stats[name]["mean"])
            sd[f"{name}.running_var"] = _tensor(stats[name]["var"])
    return sd


def _patch_net_state_dict(params: Mapping[str, Any], stats: Mapping[str, Any], prefix: str = "features"
                          ) -> Dict[str, torch.Tensor]:
    """A HardNet / AffNet / OriNet tree (``conv_i`` kernels, affine-free
    ``bn_i`` statistics) as kornia's Sequential: conv i at index 3i, its
    BatchNorm at 3i + 1; after six layers and the dropout, the head's 8x8
    conv at 19 (with its bias, where it has one) and HardNet's BatchNorm at 20."""
    sd: Dict[str, torch.Tensor] = {}
    for name, entry in params.items():
        i = int(name.split("_")[1])
        index = 3 * i if i < 6 else 19
        sd[f"{prefix}.{index}.weight"] = _conv_weight(entry["kernel"])
        if "bias" in entry:
            sd[f"{prefix}.{index}.bias"] = _tensor(entry["bias"])
    for name, entry in stats.items():
        i = int(name.split("_")[1])
        index = 3 * i + 1 if i < 6 else 20
        sd[f"{prefix}.{index}.running_mean"] = _tensor(entry["mean"])
        sd[f"{prefix}.{index}.running_var"] = _tensor(entry["var"])
    return sd


def hardnet_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's HardNet state dict from the JAX HardNet variables."""
    return _patch_net_state_dict(variables["params"], variables["batch_stats"])


def affnet_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's AffNet (or OriNet) state dict from the JAX variables, whose
    regressor sits under ``trunk``."""
    return _patch_net_state_dict(variables["params"]["trunk"], variables["batch_stats"]["trunk"])


orinet_state_dict_from_jax = affnet_state_dict_from_jax


def gftt_affnet_hardnet_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's GFTTAffNetHardNet state dict from the JAX module's
    variables: the ``affnet/trunk`` subtree (absent without AffNet) and the
    ``hardnet`` subtree."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {f"hardnet.{k}": v for k, v in hardnet_state_dict_from_jax(
        {"params": params["hardnet"], "batch_stats": stats["hardnet"]}).items()}
    if "affnet" in params:
        sd.update({f"affnet.{k}": v for k, v in affnet_state_dict_from_jax(
            {"params": params["affnet"], "batch_stats": stats["affnet"]}).items()})
    return sd
