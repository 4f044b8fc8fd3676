"""Attentional GNN over the two keypoint graphs (port of
``openglue_tpu/models/gnn.py``, softmax attention).

``num_stages`` x (self layer, cross layer); each layer is the residual update
``desc + FFN(concat[desc, MHA(desc, source)])``. As in the reference:

* each self/cross layer is ONE module applied to both images (shared weights);
* cross attention is sequential: image1 attends to the already-updated desc0;
* ``use_offset`` concatenates ``[desc - msg, msg]``.

In eval mode with ``use_pallas`` a layer runs as the fused layer kernel
(``ops/kernels/gnn_layer_kernel.py``) with its BatchNorm folded. In training
mode with ``use_pallas`` the attention half runs as the fused message kernels
(forward and backward) and the concat, the FFN and its train-mode BatchNorm
stay in torch autograd. Otherwise a layer runs the composed modules below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from openglue_tpu_torch.models.layers import Conv1x1, FeedForwardNet
from openglue_tpu_torch.ops import attention as attn_ops
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk


class MultiheadAttention(nn.Module):
    """Multi-head softmax attention; channel c belongs to head c // head_dim."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_q = Conv1x1(embed_dim, embed_dim, dtype)
        self.in_proj_k = Conv1x1(embed_dim, embed_dim, dtype)
        self.in_proj_v = Conv1x1(embed_dim, embed_dim, dtype)
        self.out_proj = Conv1x1(embed_dim, embed_dim, dtype)

    def forward(
        self, query: torch.Tensor, source: torch.Tensor, kv_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        batch, n, dim = query.shape
        m = source.shape[1]
        dh = dim // self.num_heads

        def split(x, length):  # [B, L, D] -> [B, H, L, dh]
            return x.reshape(batch, length, self.num_heads, dh).transpose(1, 2)

        q = split(self.in_proj_q(query), n)
        k = split(self.in_proj_k(source), m)
        v = split(self.in_proj_v(source), m)
        out, _ = attn_ops.softmax_attention(q, k, v, kv_mask)
        return self.out_proj(out.transpose(1, 2).reshape(batch, n, dim))


class AttentionalPropagation(nn.Module):
    """One residual message-passing layer."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        use_offset: bool = False,
        dtype: Optional[torch.dtype] = None,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.use_offset = use_offset
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.mha = MultiheadAttention(embed_dim, num_heads, dtype)
        self.fc = FeedForwardNet((2 * embed_dim, 2 * embed_dim, embed_dim), dtype)
        self._folded: Optional[glk.PropagationWeights] = None
        self._folded_key = None

    def folded_weights(self, compute_dtype: torch.dtype) -> glk.PropagationWeights:
        """The kernel's weights with the eval BatchNorm folded, rebuilt only
        when the compute type or a parameter or buffer changed."""
        tensors = dict(self.named_parameters())
        tensors.update(self.named_buffers())
        # an in-place update bumps a tensor's version; inference tensors
        # (made under torch.inference_mode) have none and cannot be updated
        # outside it
        stamp = tuple(
            (t.data_ptr(), 0 if t.is_inference() else t._version) for t in tensors.values()
        )
        key = (compute_dtype, stamp)
        if key != self._folded_key:
            with torch.no_grad():
                self._folded = glk.fold_propagation_weights(tensors, compute_dtype)
            self._folded_key = key
        return self._folded

    def forward(
        self,
        desc_q: torch.Tensor,
        desc_kv: torch.Tensor,
        q_mask: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.use_pallas and not self.training:
            weights = self.folded_weights(self.dtype or desc_q.dtype)
            return glk.fused_attention_propagation(
                desc_q, desc_kv, kv_mask, weights, self.num_heads, self.use_offset
            )
        if self.use_pallas:
            # the attention half computes in the layer's type or the chain's
            # (bf16 with a bf16 chain, where the composed path promotes to f32)
            compute_dtype = self.dtype or desc_q.dtype
            message = glk.fused_attention_message(
                desc_q.to(compute_dtype), desc_kv.to(compute_dtype), kv_mask,
                glk.extract_message_weights(dict(self.named_parameters())),
                self.num_heads, compute_dtype,
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
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            _Layer(AttentionalPropagation(embed_dim, num_heads, use_offset, dtype, use_pallas))
            for _ in range(2 * num_stages)
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
            desc0 = self_layer(desc0, desc0, mask0, mask0)
            desc1 = self_layer(desc1, desc1, mask1, mask1)
            # sequential cross attention: image1 sees the updated desc0
            cross_layer = self.layers[i + 1].module
            desc0 = cross_layer(desc0, desc1, mask0, mask1)
            desc1 = cross_layer(desc1, desc0, mask1, mask0)
        return desc0, desc1
