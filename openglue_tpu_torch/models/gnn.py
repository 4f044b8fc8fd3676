"""Attentional GNN over the two keypoint graphs (port of
``openglue_tpu/models/gnn.py``): softmax, linear (ELU+1), FAVOR-relu and
FAVOR-softmax attention, and the int8-quantized serving layer.

``num_stages`` x (self layer, cross layer); each layer is the residual update
``desc + FFN(concat[desc, MHA(desc, source)])``. As in the reference:

* each self/cross layer is ONE module applied to both images (shared weights);
* cross attention is sequential: image1 attends to the already-updated desc0;
* ``use_offset`` concatenates ``[desc - msg, msg]``.

In eval mode with ``use_pallas`` a layer runs as one fused layer kernel with
its BatchNorm folded: the softmax kernel, the feature-kind kernel for the
three O(N) kinds (``ops/kernels/gnn_layer_kernel.py``), or, with ``quantize``
and softmax attention, the int8 kernel (``ops/kernels/gnn_layer_int8.py``).
There is no shape gate: with ``use_pallas`` in eval mode the kernel runs. In
training mode with ``use_pallas`` and softmax attention a layer takes one of
three routes, the JAX package's, chosen there by environment variables and
here by the constructor argument ``train_route``:

* ``"message"`` (the default): the attention half runs as the fused message
  kernels (forward and backward); the concat, the FFN and its train-mode
  BatchNorm stay in torch autograd;
* ``"half"`` (JAX: ``OPENGLUE_TRAIN_HALF``): the attention half and the FFN's
  first dense + ReLU run as the train-half kernel, whose backward ends in the
  message backward kernel; the BatchNorm and the second dense stay in torch;
* ``"composed"`` (JAX: ``OPENGLUE_NO_FUSED_MESSAGE``): the composed modules
  below, whose multi-head attention runs the standalone attention kernels
  (forward and backward) on its projected heads.

``train_route`` has no effect in eval mode, without ``use_pallas`` or with
another attention kind: there a training layer runs the composed modules
below, under autograd for every kind.

With ``shards`` (a ``KeypointShards``: the process group over which the
keypoints of both images are sharded, ``SuperGlue`` on a mesh with
``ring_axis`` or on a mesh whose ``model`` axis holds several ranks, and the
softmax route) every layer, in eval and in training, runs the composed
modules, as the JAX package skips every fused route there. Softmax attention
on the ``"ring"`` route runs the ring schedule of
``parallel/ring.py`` (with ``use_pallas`` each key block through the
LSE-emitting attention kernel; a self layer rotates the same image's K/V
shards, a cross layer the other image's); on the ``"gather"`` route
of the JAX package's GSPMD path: K/V and their mask are gathered over the
group in one all-gather and this rank's queries attend to every key (with
``use_pallas`` through the attention kernels, forward and backward). The
O(N) kinds reduce their KV aggregate and key sum over the group
(``ops/attention.py``). ``remat`` runs each layer under
``torch.utils.checkpoint`` in training: its activations are rebuilt in the
backward pass instead of kept, on every route, the ring's rotations and the
BatchNorm all-reduces included (every rank rebuilds in the same order, as
the backward runs the same graph on each), and the BatchNorm running
statistics still move once per step.

The FAVOR kinds hold their orthogonal random projection ``[F, dh]`` as a
non-trainable buffer of the ``mha`` module (``mha.projection``), drawn from
the model's generator and redrawn by ``train.step.redraw_favor_projections``.
The ``int8_static*`` modes hold a per-layer buffer ``act_absmax`` (the running
max of each activation site over the calibration passes) and refuse to serve
before a calibration pass has filled it.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from openglue_tpu_torch.models.layers import Conv1x1, FeedForwardNet, frozen_running_statistics
from openglue_tpu_torch.ops import attention as attn_ops
from openglue_tpu_torch.ops.kernels import attention_kernel
from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from openglue_tpu_torch.parallel import ring
from openglue_tpu_torch.parallel.distributed import all_gather

ATTENTION_KINDS = ("softmax", "linear", "favor_relu", "favor_softmax")
TRAIN_ROUTES = ("message", "half", "composed")
QUANTIZE_MODES = ("int8", "int8_static", "int8_attn", "int8_static_attn")
SHARD_ROUTES = ("ring", "gather")


class KeypointShards(NamedTuple):
    """The keypoints of both images sharded over the process group
    ``group``; softmax attention takes ``route``, one of ``SHARD_ROUTES``."""

    group: Any
    route: str


class MultiheadAttention(nn.Module):
    """Multi-head attention with a pluggable score mechanism; channel c belongs
    to head c // head_dim. ``favor_num_features`` defaults to 2 * head_dim.
    With ``use_pallas`` softmax attention runs the attention kernels (forward
    and, under autograd, backward), in training and in eval."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dtype: Optional[torch.dtype] = None,
        attention: str = "softmax",
        favor_num_features: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        use_pallas: bool = False,
        shards: Optional[KeypointShards] = None,
    ):
        super().__init__()
        if attention not in ATTENTION_KINDS:
            raise ValueError(
                f"Attention type {attention!r} is not supported; choose from {ATTENTION_KINDS}"
            )
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.attention = attention
        self.use_pallas = use_pallas
        self.shards = shards
        self.in_proj_q = Conv1x1(embed_dim, embed_dim, dtype)
        self.in_proj_k = Conv1x1(embed_dim, embed_dim, dtype)
        self.in_proj_v = Conv1x1(embed_dim, embed_dim, dtype)
        self.out_proj = Conv1x1(embed_dim, embed_dim, dtype)
        if attention in ("favor_relu", "favor_softmax"):
            self.register_buffer("projection", attn_ops.sample_orthogonal_random_matrix(
                generator, favor_num_features or 2 * self.head_dim, self.head_dim, device="cpu"
            ))

    def forward(
        self, query: torch.Tensor, source: torch.Tensor, kv_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        batch, n, _ = query.shape
        m = source.shape[1]

        def split(x, length):  # [B, L, H * dh] -> [B, H, L, dh]
            return x.reshape(batch, length, -1, self.head_dim).transpose(1, 2)

        q = split(self.in_proj_q(query), n)
        k_buf, v_buf = self.in_proj_k(source), self.in_proj_v(source)
        dim, group = k_buf.shape[-1], self.shards.group if self.shards else None
        if self.attention == "softmax" and group is not None and self.shards.route == "gather":
            # the all-gather route: one gather of K, V and the mask as 16 bytes
            # of channels (the attention kernels take 16-byte row strides)
            pad = 16 // k_buf.element_size()
            mask = torch.ones_like(k_buf[..., :1]) if kv_mask is None else kv_mask[..., None].to(k_buf.dtype)
            gathered = all_gather(torch.cat([k_buf, v_buf, mask.expand(*mask.shape[:-1], pad)], dim=-1), group)
            k_buf, v_buf = gathered[..., :dim], gathered[..., dim:2 * dim]
            kv_mask, m = gathered[..., 2 * dim] > 0.5, gathered.shape[1]
            group = None
        out = self.attend(q, split(k_buf, m), split(v_buf, m), kv_mask, group)
        return self.out_proj(out.transpose(1, 2).reshape(batch, n, -1))

    def attend(self, q, k, v, kv_mask, group=None) -> torch.Tensor:
        """[B, H, n, dh] queries, [B, H, m, dh] keys and values -> [B, H, n, dh]
        by this module's kind; ``group``: the keys are this rank's shard of
        the group's (the ring, or the O(N) kinds' reductions)."""
        if self.attention == "softmax" and group is not None:
            return ring.ring_softmax_attention(q, k, v, kv_mask, group, self.use_pallas)
        if self.attention == "softmax" and self.use_pallas:
            return attention_kernel.masked_softmax_attention(q, k, v, kv_mask)
        if self.attention == "softmax":
            return attn_ops.softmax_attention(q, k, v, kv_mask)[0]
        if self.attention == "linear":
            return attn_ops.linear_attention_elu(q, k, v, kv_mask, group=group)[0]
        proj = self.projection.to(q.dtype)
        if self.attention == "favor_relu":
            q_feat = attn_ops.favor_features_relu(q, proj)
            k_feat = attn_ops.favor_features_relu(k, proj)
        else:
            q_feat = attn_ops.favor_features_softmax(q, proj, is_query=True)
            k_feat = attn_ops.favor_features_softmax(k, proj, is_query=False, kv_mask=kv_mask, group=group)
        return attn_ops.linear_attention(q_feat, k_feat, v, kv_mask, group)[0]


class AttentionalPropagation(nn.Module):
    """One residual message-passing layer."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        use_offset: bool = False,
        dtype: Optional[torch.dtype] = None,
        use_pallas: bool = False,
        attention: str = "softmax",
        favor_num_features: Optional[int] = None,
        quantize: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        train_route: str = "message",
        shards: Optional[KeypointShards] = None,
    ):
        super().__init__()
        if quantize is not None and quantize not in QUANTIZE_MODES:
            raise ValueError(f"quantize {quantize!r} is not supported; choose from {QUANTIZE_MODES}")
        if train_route not in TRAIN_ROUTES:
            raise ValueError(f"train_route {train_route!r} is not supported; choose from {TRAIN_ROUTES}")
        self.train_route = train_route
        self.num_heads = num_heads
        self.use_offset = use_offset
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.attention = attention
        self.fused = shards is None  # sharded keypoints take the composed modules only
        # the int8 layer exists for the fused softmax path only; elsewhere the
        # setting is inert (SuperGlue warns about it)
        self.quantize = quantize if use_pallas and attention == "softmax" and self.fused else None
        self.calibrating = False
        self.mha = MultiheadAttention(
            embed_dim, num_heads, dtype, attention, favor_num_features, generator, use_pallas,
            shards,
        )
        self.fc = FeedForwardNet((2 * embed_dim, 2 * embed_dim, embed_dim), dtype)
        if self.static_quantize:
            self.register_buffer("act_absmax", torch.zeros(self.num_sites))
        self._folded = None
        self._folded_key = None
        self._act_scales = None
        self._act_scales_key = None

    @property
    def static_quantize(self) -> bool:
        return self.quantize is not None and self.quantize.startswith("int8_static")

    @property
    def quant_attention(self) -> bool:
        return self.quantize is not None and self.quantize.endswith("_attn")

    @property
    def num_sites(self) -> int:
        return gli8.ATTENTION_SITES if self.quant_attention else gli8.SITES

    def folded_weights(self, compute_dtype: torch.dtype):
        """The kernel's weights with the eval BatchNorm folded
        (``PropagationWeights``; with ``quantize`` the int8
        ``QuantPropagationWeights`` made from the f32 fold), rebuilt only when
        the compute type or a parameter or a BatchNorm statistic changed."""
        tensors = dict(self.named_parameters())
        tensors.update((k, v) for k, v in self.named_buffers() if k.startswith("fc."))
        # an in-place update bumps a tensor's version; inference tensors
        # (made under torch.inference_mode) have none and cannot be updated
        # outside it
        stamp = tuple(
            (t.data_ptr(), 0 if t.is_inference() else t._version) for t in tensors.values()
        )
        key = (compute_dtype, stamp)
        if key != self._folded_key:
            with torch.no_grad():
                if self.quantize is not None:
                    self._folded = gli8.quantize_propagation_weights(
                        glk.fold_propagation_weights(tensors, torch.float32)
                    )
                else:
                    self._folded = glk.fold_propagation_weights(tensors, compute_dtype)
            self._folded_key = key
        return self._folded

    def _static_scales(self) -> torch.Tensor:
        """The serving scales from the calibrated absmax, checked and rebuilt
        only when the buffer changed (the check reads the card)."""
        t = self.act_absmax
        key = (t.data_ptr(), 0 if t.is_inference() else t._version)
        if key != self._act_scales_key:
            if not bool((t > 0).any()):
                raise RuntimeError(
                    f"quantize={self.quantize!r} is uncalibrated: run a calibration "
                    "pass on representative inputs first (SuperGlue.calibrate)"
                )
            # 10% headroom absorbs mild drift between calibration and
            # serving; values beyond it saturate
            self._act_scales = t * (1.1 / 127.0) + 1e-12
            self._act_scales_key = key
        return self._act_scales

    def _int8_layer(self, desc_q, desc_kv, kv_mask):
        weights = self.folded_weights(torch.float32)
        act_scales = None
        if self.static_quantize:
            if self.act_absmax.shape[0] != self.num_sites:
                raise ValueError(
                    f"act_absmax has {self.act_absmax.shape[0]} sites but "
                    f"quantize={self.quantize!r} needs {self.num_sites}: re-run calibration "
                    "under this quantize mode."
                )
            if self.calibrating:
                # record, and serve this pass through the dynamic path
                absmax = gli8.reference_activation_absmax(
                    desc_q, desc_kv, kv_mask, weights, self.num_heads, self.use_offset,
                    quant_attention=self.quant_attention,
                )
                self.act_absmax.copy_(torch.maximum(self.act_absmax, absmax))
                self._act_scales_key = None
            else:
                act_scales = self._static_scales()
        return gli8.fused_attention_propagation_int8(
            desc_q, desc_kv, kv_mask, weights, self.num_heads, self.use_offset,
            act_scales=act_scales, quant_attention=self.quant_attention,
        )

    def forward(
        self,
        desc_q: torch.Tensor,
        desc_kv: torch.Tensor,
        q_mask: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.use_pallas and self.fused and not self.training:
            if self.quantize is not None:
                return self._int8_layer(desc_q, desc_kv, kv_mask)
            weights = self.folded_weights(self.dtype or desc_q.dtype)
            return glk.fused_attention_propagation(
                desc_q, desc_kv, kv_mask, weights, self.num_heads, self.use_offset,
                self.attention, getattr(self.mha, "projection", None),
            )
        fused_train = self.use_pallas and self.fused and self.attention == "softmax"
        route = self.train_route if fused_train else "composed"
        if route != "composed":
            # the attention half computes in the layer's type or the chain's
            # (bf16 with a bf16 chain, where the composed path promotes to f32)
            compute_dtype = self.dtype or desc_q.dtype
            x_q, x_kv = desc_q.to(compute_dtype), desc_kv.to(compute_dtype)
            weights = glk.extract_message_weights(dict(self.named_parameters()))
        if route == "half":
            # the kernel consumes fc.0; the train-mode BatchNorm and the second
            # dense finish the layer here
            z = glk.fused_train_layer_half(
                x_q, x_kv, kv_mask, weights, self.fc[0].weight[..., 0], self.fc[0].bias,
                self.num_heads, self.use_offset, compute_dtype,
            )
            return desc_q + self.fc(z, q_mask, skip_to_hidden=True)
        if route == "message":
            message = glk.fused_attention_message(
                x_q, x_kv, kv_mask, weights, self.num_heads, compute_dtype
            )
        else:
            message = self.mha(desc_q, desc_kv, kv_mask)
        dt = torch.promote_types(desc_q.dtype, message.dtype)
        desc_c, message = desc_q.to(dt), message.to(dt)
        first = desc_c - message if self.use_offset else desc_c
        update = self.fc(torch.cat([first, message], dim=-1), q_mask)
        return desc_q + update


class _Layer(nn.Module):
    """Holds a layer under ``module``, the reference's state-dict nesting
    (``attention_gnn.layers.{i}.module.*``)."""

    def __init__(self, module: AttentionalPropagation):
        super().__init__()
        self.module = module


class AttentionGNN(nn.Module):
    """num_stages x (self + cross) attention over both keypoint graphs; layer
    2s is stage s's self layer, 2s+1 its cross layer."""

    def __init__(
        self,
        num_stages: int,
        embed_dim: int,
        num_heads: int,
        use_offset: bool = False,
        dtype: Optional[torch.dtype] = None,
        use_pallas: bool = False,
        attention: str = "softmax",
        favor_num_features: Optional[int] = None,
        quantize: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
        train_route: str = "message",
        shards: Optional[KeypointShards] = None,
    ):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            _Layer(AttentionalPropagation(
                embed_dim, num_heads, use_offset, dtype, use_pallas, attention,
                favor_num_features, quantize, generator, train_route, shards,
            ))
            for _ in range(2 * num_stages)
        )

    def _run(self, layer, *args):
        """One layer call; with ``remat`` in training, under a checkpoint: the
        layer's activations are dropped after the forward and rebuilt by a
        second forward in the backward pass, which leaves the BatchNorm
        running statistics alone."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return layer(*args)
        return checkpoint(
            layer, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(), frozen_running_statistics(layer)),
        )

    def forward(
        self,
        desc0: torch.Tensor,
        desc1: torch.Tensor,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(0, len(self.layers), 2):
            self_layer = self.layers[i].module
            desc0 = self._run(self_layer, desc0, desc0, mask0, mask0)
            desc1 = self._run(self_layer, desc1, desc1, mask1, mask1)
            # sequential cross attention: image1 sees the updated desc0
            cross_layer = self.layers[i + 1].module
            desc0 = self._run(cross_layer, desc0, desc1, mask0, mask1)
            desc1 = self._run(cross_layer, desc1, desc0, mask1, mask0)
        return desc0, desc1
