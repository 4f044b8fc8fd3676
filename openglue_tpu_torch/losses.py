"""Matching losses (port of ``openglue_tpu/losses.py``).

NLL on the log-assignment matrix with per-image mean weighting, and the
optional metric-learning loss (hardest-negative triplet for matched pairs,
margin hinge for unmatched keypoints). Within each batch element the
per-keypoint terms are averaged; the per-image sums add as
``matched + 0.5 * (unmatched0 + unmatched1)`` and are divided by the batch
size. An element with no keypoint in a category contributes zero.

With ``groups`` (``parallel.MeshGroups``) each rank holds a shard of the
global batch: its rows of the batch (the ``data`` group), and with
keypoint-axis context parallelism (``SuperGlue.keypoint_group``, the
``model`` group) its rows of the scores, of ``gt_matches0`` and of the
context descriptors. The loss returned is the global one, on every rank; its
gradient is this rank's share: the terms of its elements over the GLOBAL
batch size, within an element the terms of its rows over the counts of every
``model`` rank, and the terms every ``model`` rank computes alike (the
replicated dustbin row, the metric loss's per-column margins) over the
number of ``model`` ranks, so that they count once. The shares over the
world sum to the one-process loss, and so do the parameter gradients summed
over the world.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from openglue_tpu_torch.geometry.transforms import pairwise_cosine_dist
from openglue_tpu_torch.parallel.distributed import (
    MeshGroups, all_gather, all_reduce_min, all_reduce_sum, max_over,
)

_BIG = 1e9


def _per_image_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked per-element mean [B, N] -> [B], zero where the mask is empty."""
    mask_f = mask.to(values.dtype)
    count = mask_f.sum(dim=1)
    total = (values * mask_f).sum(dim=1)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))


def _rows_mean(values: torch.Tensor, mask: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the masked per-element mean over every rank's
    rows: its masked sum over the global count."""
    mask_f = mask.to(values.dtype)
    count = all_reduce_sum(mask_f.sum(dim=1), group)
    total = (values * mask_f).sum(dim=1)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))


def _global_value(share: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``share`` as the value, the same bits on
    every rank, and this rank's ``share`` as the gradient."""
    if group is None:
        return share
    return all_reduce_sum(share.detach(), group) + (share - share.detach())


def matching_nll_loss(
    gt_matches0: torch.Tensor, gt_matches1: torch.Tensor, scores: torch.Tensor,
    groups: Optional[MeshGroups] = None,
) -> torch.Tensor:
    """Negative log-likelihood of the GT assignment: gt_matches0 [B, N],
    gt_matches1 [B, M], scores [B, N+1, M+1] log-assignment. With
    ``groups``, this rank's shard of them."""
    groups = groups or MeshGroups()
    ring = groups.model
    rows, n_aug, m_aug = scores.shape
    n, m = n_aug - 1, m_aug - 1
    matched0 = gt_matches0 >= 0
    gt_cols = gt_matches0.clamp(0, m - 1).long()
    matched_ll = torch.gather(scores[:, :n, :m], 2, gt_cols[:, :, None])[..., 0]
    unmatched1_loss = _per_image_mean(-scores[:, n, :m], gt_matches1 == -1)
    if ring is None:
        matched_loss = _per_image_mean(-matched_ll, matched0)
        unmatched0_loss = _per_image_mean(-scores[:, :n, m], gt_matches0 == -1)
    else:
        matched_loss = _rows_mean(-matched_ll, matched0, ring)
        unmatched0_loss = _rows_mean(-scores[:, :n, m], gt_matches0 == -1, ring)
        unmatched1_loss = unmatched1_loss / dist.get_world_size(ring)
    share = (matched_loss + 0.5 * (unmatched0_loss + unmatched1_loss)).sum() / (rows * groups.data_size)
    return _global_value(share, groups.world)


def metric_learning_loss(
    gt_matches0: torch.Tensor,
    gt_matches1: torch.Tensor,
    gdesc0: torch.Tensor,
    gdesc1: torch.Tensor,
    margin: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    groups: Optional[MeshGroups] = None,
) -> torch.Tensor:
    """Triplet + margin losses on the cosine distances of the context
    descriptors [B, N, D] / [B, M, D]; the hardest negatives are mined on the
    detached distance matrix with the positives and invalid pairs at 1e9.
    With ``groups``, this rank's rows of the global batch; with a ``model``
    group also its shard of both images' keypoints (``gt_matches1`` whole):
    its rows meet every column (image 1's descriptors and mask gathered),
    the hardest row of a column is the first over every rank's rows, as
    argmin breaks ties, and its distance comes from the gathered rows of
    image 0."""
    groups = groups or MeshGroups()
    ring = groups.model
    if ring is not None:
        gdesc1 = all_gather(gdesc1, ring)
        mask1 = None if mask1 is None else all_gather(mask1, ring)
    batch, n = gt_matches0.shape
    m = gt_matches1.shape[1]
    device = gdesc0.device
    dist = pairwise_cosine_dist(gdesc0, gdesc1)  # [B, N, M]
    if mask0 is None:
        mask0 = torch.ones(batch, n, dtype=torch.bool, device=device)
    if mask1 is None:
        mask1 = torch.ones(batch, m, dtype=torch.bool, device=device)
    pair_valid = mask0[:, :, None] & mask1[:, None, :]

    matched0 = gt_matches0 >= 0
    gt_cols = gt_matches0.clamp(0, m - 1).long()
    pos_mask = matched0[:, :, None] & (gt_cols[:, :, None] == torch.arange(m, device=device)[None, None, :])
    dist_det = torch.where(pos_mask | ~pair_valid, _BIG, dist.detach())
    nn_col = dist_det.argmin(dim=2)  # [B, N] hardest kpt1 per kpt0
    nn_row = dist_det.argmin(dim=1)  # [B, M] hardest kpt0 per kpt1
    if ring is not None:
        col_min = dist_det.amin(dim=1)
        first = nn_row + torch.distributed.get_rank(ring) * n  # `dist` is the distance matrix here
        nn_row = all_reduce_min(torch.where(col_min == all_reduce_min(col_min, ring), first,
                                            torch.iinfo(first.dtype).max), ring)

    dist_ap = torch.gather(dist, 2, gt_cols[:, :, None])[..., 0]
    dist_an0 = torch.gather(dist, 2, nn_col[:, :, None])[..., 0]
    i_neg = torch.gather(nn_row, 1, gt_cols)  # dist[b, nn_row[b, gt_j], gt_j]
    rows = torch.arange(batch, device=device)[:, None]
    if ring is None:
        dist_an1 = dist[rows, i_neg, gt_cols]
    else:
        anchor, negative = all_gather(gdesc0, ring)[rows, i_neg], gdesc1[rows, gt_cols]  # [B, N, D] each
        dim = anchor.shape[-1]
        dist_an1 = pairwise_cosine_dist(anchor.reshape(-1, 1, dim), negative.reshape(-1, 1, dim)).view(batch, n)
    loss0 = torch.clamp(dist_ap - dist_an0 + margin, min=0.0)
    loss1 = torch.clamp(dist_ap - dist_an1 + margin, min=0.0)
    row_mean = _per_image_mean if ring is None else lambda v, mask: _rows_mean(v, mask, ring)
    triplet = row_mean(loss0 + loss1, matched0)

    dist_for_min = torch.where(pair_valid, dist, _BIG)
    margin0 = row_mean(torch.clamp(margin - dist_for_min.amin(dim=2), min=0.0), gt_matches0 == -1)
    col_min = dist_for_min.amin(dim=1)
    if ring is not None:
        col_min = -max_over(-col_min, ring)
    margin1 = _per_image_mean(torch.clamp(margin - col_min, min=0.0), gt_matches1 == -1)
    if ring is not None:
        margin1 = margin1 / torch.distributed.get_world_size(ring)
    share = (triplet + margin0 + margin1).sum() / (batch * groups.data_size)
    return _global_value(share, groups.world)


def criterion(
    y_true: Dict[str, torch.Tensor],
    y_pred: Dict[str, torch.Tensor],
    margin: Optional[float] = None,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    groups: Optional[MeshGroups] = None,
) -> Dict[str, torch.Tensor]:
    """{"loss": NLL, "metric_loss": metric loss or 0 when margin is None}."""
    nll = matching_nll_loss(y_true["gt_matches0"], y_true["gt_matches1"], y_pred["scores"], groups)
    if margin is None:
        metric = torch.zeros((), dtype=nll.dtype, device=nll.device)
    else:
        metric = metric_learning_loss(
            y_true["gt_matches0"], y_true["gt_matches1"],
            y_pred["context_descriptors0"], y_pred["context_descriptors1"],
            margin, mask0=mask0, mask1=mask1, groups=groups,
        )
    return {"loss": nll, "metric_loss": metric}
