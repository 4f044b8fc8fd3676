"""The SuperGlue matcher head (port of ``openglue_tpu/models/superglue.py``).

Normalize keypoints to [-1, 1] -> MLP positional encoding added to the local
descriptors -> attentional GNN (optionally carried in ``chain_dtype``) ->
linear projection (+ the residual mix with a learned per-channel sigmoid
gate) -> scaled dot-product scores -> dustbin-augmented Sinkhorn ->
log-assignment scores ``[B, N+1, M+1]``.

``use_pallas`` keeps its JAX meaning: False runs the composed torch path,
True runs the CUDA kernels: in eval mode the GNN layer kernel of the
configured attention kind (or, with ``quantize`` and softmax attention, the
int8 layer kernel) and the scale-domain Sinkhorn; in training mode
(``model.train()``) the attention half of every softmax layer through the
message kernels and the Sinkhorn through its forward and adjoint kernels,
under autograd. ``train_route`` (a constructor argument, not a config key)
picks one of the JAX package's three training routes of a softmax layer:
``"message"`` (the default), ``"half"`` (the train-half kernel, whose backward
ends in the message backward kernel) or ``"composed"`` (the composed modules
with the standalone attention kernels); ``remat`` checkpoints every GNN layer
in training, on each route. ``quantize`` without ``use_pallas`` or with another attention
kind cannot run: the model warns and serves the unquantized path. The
``int8_static*`` modes serve only after ``calibrate``, which sets the model's
``int8_calibration.calibrated`` flag (a host flag that the state dict
carries, so that a restored model tells whether it was calibrated). On CPU tensors the kernels'
plain versions run instead. In training mode every ``MaskedBatchNorm``
normalizes with the batch statistics of the valid keypoints and updates its
running statistics, as the JAX package's ``mutable=["batch_stats"]`` does.

Keypoint-axis context parallelism: the keypoints of both images are sharded
over a process group (``parallel.shard_pair_batch_cp``), each rank running
this forward on its slice. ``ring_axis`` names that axis of ``mesh``
(``parallel.make_mesh``) and softmax attention then runs the ring schedule of
``parallel/ring.py``; without ``ring_axis``, a ``mesh`` whose ``model`` axis
holds several ranks shards the keypoints over that axis and softmax
attention takes the all-gather route (the counterpart of the JAX package's
GSPMD path: K/V gathered, queries local). The O(N) kinds reduce their KV
aggregates over the axis on either. Every GNN layer then takes the composed
modules (with ``use_pallas`` the attention kernels), ``remat`` included, the
BatchNorm statistics of training are those of every rank, the score rows of
this rank meet every column (the other image's projected descriptors are
all-gathered) and the transport is ``parallel.ring.log_optimal_transport_ring``
over the marginals of the whole problem. ``scores`` holds this rank's rows and
then the replicated dustbin row, ``[B, N/P + 1, M + 1]``
(``parallel.gather_rows`` assembles the whole matrix); the context
descriptors are this rank's rows. ``quantize`` warns and serves unquantized,
as in JAX.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from openglue_tpu_torch.models.gnn import AttentionGNN, KeypointShards
from openglue_tpu_torch.models.layers import Conv1x1, set_batch_norm_group
from openglue_tpu_torch.models.matching import assignment_stats
from openglue_tpu_torch.models.positional_encoding import MLPPositionalEncoding
from openglue_tpu_torch.ops import sinkhorn as sinkhorn_ops
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel
from openglue_tpu_torch.parallel import ring
from openglue_tpu_torch.parallel.distributed import all_gather
from openglue_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size_rank


def as_torch_dtype(value: Any) -> Optional[torch.dtype]:
    """None, a torch dtype or its name ("bfloat16") -> torch dtype or None."""
    if value is None or isinstance(value, torch.dtype):
        return value
    dtype = getattr(torch, str(value), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {value!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class SuperGlueConfig:
    """Static configuration (the JAX package's schema, reference
    config/config.yaml:42-55)."""

    descriptor_dim: int = 256
    pe_hidden_layers_sizes: Sequence[int] = (32, 64, 128)
    pe_encoder_name: str = "FeedForwardNet"
    side_info_size: int = 1
    num_stages: int = 9
    num_heads: int = 4
    attention: str = "softmax"
    use_offset: bool = False
    favor_num_features: Optional[int] = None  # FAVOR kinds; None = 2 * head_dim
    dustbin_score_init: float = 1.0
    otp_num_iters: int = 20
    otp_reg: float = 1.0
    residual: bool = True
    no_descriptors: bool = False
    dtype: Any = None  # computation type; None = the promoted input type (f32)
    chain_dtype: Any = None  # type of the GNN residual chain; None = promoted (f32)
    use_pallas: bool = False
    remat: bool = False
    ring_axis: Any = None
    quantize: Optional[str] = None
    decode_stats: bool = False

    @classmethod
    def from_dict(cls, cfg: Mapping[str, Any]) -> "SuperGlueConfig":
        pe = cfg.get("positional_encoding", {})
        gnn = cfg.get("attention_gnn", {})
        otp = cfg.get("otp", {})
        return cls(
            descriptor_dim=cfg["descriptor_dim"],
            pe_hidden_layers_sizes=tuple(pe.get("hidden_layers_sizes", ()) or ()),
            pe_encoder_name=pe.get("encoder_name", "FeedForwardNet"),
            side_info_size=pe.get("side_info_size", 1),
            num_stages=gnn.get("num_stages", 9),
            num_heads=gnn.get("num_heads", 4),
            attention=gnn.get("attention", "softmax"),
            use_offset=gnn.get("use_offset", False),
            favor_num_features=gnn.get("favor_num_features"),
            dustbin_score_init=cfg.get("dustbin_score_init", 1.0),
            otp_num_iters=otp.get("num_iters", 20),
            otp_reg=otp.get("reg", 1.0),
            residual=cfg.get("residual", False),
            no_descriptors=cfg.get("no_descriptors", False),
            dtype=cfg.get("dtype"),
            chain_dtype=cfg.get("chain_dtype"),
            use_pallas=cfg.get("use_pallas", False),
            remat=cfg.get("remat", False),
            ring_axis=cfg.get("ring_axis"),
            quantize=cfg.get("quantize"),
            decode_stats=cfg.get("decode_stats", False),
        )


def static_int8(config: SuperGlueConfig) -> bool:
    """Whether the model's layers serve an ``int8_static*`` mode, and so hold
    a calibration (``quantize`` runs only on the fused softmax path)."""
    return bool(
        config.quantize and config.quantize.startswith("int8_static") and config.use_pallas
        and config.attention == "softmax" and config.ring_axis is None
    )


class CalibrationState(nn.Module):
    """Whether the ``int8_static*`` layers hold a calibration: a host flag
    that ``SuperGlue.calibrate`` sets, carried by the state dict as this
    module's extra state (``int8_calibration._extra_state``) and read without
    touching the device."""

    def __init__(self):
        super().__init__()
        self.calibrated = False

    def get_extra_state(self) -> Dict[str, bool]:
        return {"calibrated": self.calibrated}

    def set_extra_state(self, state: Mapping[str, Any]) -> None:
        self.calibrated = bool(state["calibrated"])


def keypoint_shards(config: SuperGlueConfig, mesh) -> Optional[KeypointShards]:
    """How a model's keypoints are sharded: over the ``ring_axis`` of
    ``mesh`` on the ring, else over the ``model`` axis of a mesh on which it
    holds several ranks on the all-gather route, else not (None)."""
    if config.ring_axis is not None:
        if mesh is None:
            raise ValueError(f"ring_axis={config.ring_axis!r} needs a mesh (SuperGlue(..., mesh=...))")
        return KeypointShards(mesh.get_group(config.ring_axis), "ring")
    if mesh is not None and axis_size_rank(mesh, MODEL_AXIS)[0] > 1:
        return KeypointShards(mesh.get_group(MODEL_AXIS), "gather")
    return None


def normalize_keypoints(kpts: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates [B, N, 2] -> [-1, 1]; image_size [2] or [B, 2] as
    (width, height)."""
    wh = torch.as_tensor(image_size, dtype=kpts.dtype, device=kpts.device)
    wh = wh[None, None, :] if wh.dim() == 1 else wh[:, None, :]
    return 2.0 * kpts / (wh - 1.0) - 1.0


class SuperGlue(nn.Module):
    """The matcher. Parameter names follow the reference torch state dict."""

    def __init__(
        self,
        config: SuperGlueConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
        train_route: str = "message",
        mesh=None,
    ):
        super().__init__()
        shards = keypoint_shards(config, mesh)
        self.keypoint_group = shards.group if shards else None
        self.config = config
        self.train_route = train_route
        dim = config.descriptor_dim
        dtype = as_torch_dtype(config.dtype)
        self.chain_dtype = as_torch_dtype(config.chain_dtype)
        self.positional_encoding = MLPPositionalEncoding(
            dim, config.pe_hidden_layers_sizes, config.side_info_size, config.pe_encoder_name,
            dtype=dtype,
        )
        self.attention_gnn = AttentionGNN(
            config.num_stages, dim, config.num_heads, config.use_offset, dtype,
            config.use_pallas, config.attention, config.favor_num_features, config.quantize,
            generator, bool(config.remat), train_route, shards,
        )
        if static_int8(config):
            self.int8_calibration = CalibrationState()
        self.linear_proj = Conv1x1(dim, dim, dtype)
        if config.residual:
            self.mix_coefs = nn.Parameter(torch.zeros(dim, 1))
        self.dustbin_score = nn.Parameter(torch.tensor(float(config.dustbin_score_init)))
        for module in self.modules():
            if isinstance(module, Conv1x1):
                module.reset_parameters(generator)
        self.positional_encoding.reset_parameters(generator)
        set_batch_norm_group(self, self.keypoint_group)
        self.to(device)

    def calibrate(self, **inputs) -> Dict[str, torch.Tensor]:
        """One calibration pass of the ``int8_static*`` modes: an eval forward
        that serves through the dynamic int8 path while every layer records
        the running max of its activation sites into its ``act_absmax``
        buffer. Call it on representative inputs, once or several times,
        before serving; it sets ``int8_calibration.calibrated``. Returns the
        pass's output."""
        layers = [layer.module for layer in self.attention_gnn.layers]
        if not any(layer.static_quantize for layer in layers):
            raise ValueError(f"quantize={self.config.quantize!r} has nothing to calibrate")
        was_training = self.training
        self.eval()
        for layer in layers:
            layer.calibrating = True
        try:
            with torch.no_grad():
                out = self(**inputs)
            self.int8_calibration.calibrated = True
            return out
        finally:
            for layer in layers:
                layer.calibrating = False
            self.train(was_training)

    def forward(
        self,
        kpts0: torch.Tensor,
        kpts1: torch.Tensor,
        desc0: torch.Tensor,
        desc1: torch.Tensor,
        side_info0: torch.Tensor,
        side_info1: torch.Tensor,
        image_size0: torch.Tensor,
        image_size1: torch.Tensor,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        if cfg.quantize is not None:
            reasons = []
            if not cfg.use_pallas:
                reasons.append("use_pallas=False")
            if cfg.attention != "softmax":
                reasons.append(f"attention={cfg.attention!r} (softmax only)")
            if cfg.ring_axis is not None:
                reasons.append("ring_axis is set")
            elif self.keypoint_group is not None:
                reasons.append("the keypoints are sharded over the model axis")
            if reasons:
                warnings.warn(
                    f"quantize={cfg.quantize!r} requested but the int8 serving path cannot "
                    f"run ({', '.join(reasons)}); serving the bf16/f32 path instead.",
                    stacklevel=2,
                )
        kpts0 = normalize_keypoints(kpts0, image_size0)
        kpts1 = normalize_keypoints(kpts1, image_size1)
        pe0 = self.positional_encoding(kpts0, side_info0, mask0)
        pe1 = self.positional_encoding(kpts1, side_info1, mask1)
        if cfg.no_descriptors:
            x0, x1 = pe0, pe1
        else:
            x0, x1 = desc0 + pe0, desc1 + pe1
        if self.chain_dtype is not None:
            x0, x1 = x0.to(self.chain_dtype), x1.to(self.chain_dtype)
        gdesc0, gdesc1 = self.attention_gnn(x0.contiguous(), x1.contiguous(), mask0, mask1)

        # dtype None: a bf16 chain meets f32 weights in f32 (Conv1x1 promotes)
        gdesc0, gdesc1 = self.linear_proj(gdesc0), self.linear_proj(gdesc1)
        if cfg.residual:
            alpha = torch.sigmoid(self.mix_coefs[:, 0])
            gdesc0 = alpha * gdesc0 + (1.0 - alpha) * desc0
            gdesc1 = alpha * gdesc1 + (1.0 - alpha) * desc1

        if self.keypoint_group is not None:
            return self._sharded_head(gdesc0, gdesc1, mask0, mask1)
        S = torch.einsum("bnd,bmd->bnm", gdesc0, gdesc1) * cfg.descriptor_dim**-0.5
        ot = sinkhorn_kernel if cfg.use_pallas else sinkhorn_ops
        log_P = ot.log_optimal_transport(
            S.float(), self.dustbin_score, num_iters=cfg.otp_num_iters, reg=cfg.otp_reg,
            mask0=mask0, mask1=mask1,
        )
        out = {
            "context_descriptors0": gdesc0,
            "context_descriptors1": gdesc1,
            "scores": log_P,
        }
        if cfg.decode_stats:
            idx0, idx1, max0 = assignment_stats(log_P, mask0=mask0, mask1=mask1)
            out["decode_indices0"] = idx0
            out["decode_indices1"] = idx1
            out["decode_max0"] = max0
        return out

    def _sharded_head(self, gdesc0, gdesc1, mask0, mask1) -> Dict[str, torch.Tensor]:
        """Scores of this rank's rows against every column, and the
        row-sharded transport over the whole problem's marginals."""
        cfg, group = self.config, self.keypoint_group
        S = torch.einsum("bnd,bmd->bnm", gdesc0, all_gather(gdesc1, group)) * cfg.descriptor_dim**-0.5
        # the masks are small: gathered once per forward
        mask0_all = None if mask0 is None else all_gather(mask0, group)
        mask1_all = None if mask1 is None else all_gather(mask1, group)
        log_P = ring.log_optimal_transport_ring(
            S.float(), self.dustbin_score, group, num_iters=cfg.otp_num_iters, reg=cfg.otp_reg,
            mask0=mask0_all, mask1=mask1_all,
        )
        out = {"context_descriptors0": gdesc0, "context_descriptors1": gdesc1, "scores": log_P}
        if cfg.decode_stats:
            out["decode_indices0"], out["decode_indices1"], out["decode_max0"] = assignment_stats(
                log_P, mask0=mask0, mask1=mask1_all, group=group
            )
        return out
