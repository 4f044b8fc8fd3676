"""Match decoding from the log-assignment matrix (port of
``openglue_tpu/models/matching.py``): mutual nearest neighbours + threshold,
returned as fixed-size index tensors with -1 for no match.

With ``group`` the log-assignment is row-sharded (``SuperGlue`` with
sharded keypoints): each rank holds its rows and the replicated dustbin row. Row
argmax and max are local; the column max and argmax are reduced across the
ranks to global row indices, ties to the smallest, as ``jnp.argmax`` breaks
them, without gathering the [N, M] matrix; the decode then runs on every rank
from the gathered per-row statistics and returns whole, replicated results."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from openglue_tpu_torch.parallel.distributed import all_gather, all_reduce_max, all_reduce_min


def assignment_stats(
    scores: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    group=None,
):
    """Row argmax [B, N], column argmax [B, M] and row max [B, N] of the inner
    log-assignment matrix, masked entries at -inf; ties take the first index.
    With ``group``: ``scores`` [B, n_loc + 1, M + 1] and ``mask0`` [B, n_loc]
    are this rank's rows, ``mask1`` [B, M] every column; the row statistics
    are this rank's, the column argmax global row indices."""
    inner = scores[:, :-1, :-1]
    if mask1 is not None:
        inner = torch.where(mask1[:, None, :], inner, float("-inf"))
    if mask0 is not None:
        inner = torch.where(mask0[:, :, None], inner, float("-inf"))
    max0 = inner.amax(dim=2)
    indices0 = inner.argmax(dim=2)
    indices1 = inner.argmax(dim=1)
    if group is not None:
        col_max = inner.amax(dim=1)
        best = all_reduce_max(col_max, group)
        first = indices1 + dist.get_rank(group) * inner.shape[1]
        indices1 = all_reduce_min(torch.where(col_max == best, first, torch.iinfo(first.dtype).max), group)
    return indices0, indices1, max0


def decode_matches_from_stats(
    indices0: torch.Tensor,
    indices1: torch.Tensor,
    max0: torch.Tensor,
    match_threshold: float = 0.2,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Mutual-NN + threshold decode from ``assignment_stats`` outputs."""
    n, m = indices0.shape[1], indices1.shape[1]
    arange0 = torch.arange(n, device=indices0.device)[None, :]
    arange1 = torch.arange(m, device=indices1.device)[None, :]
    mutual0 = arange0 == torch.gather(indices1, 1, indices0)
    mutual1 = arange1 == torch.gather(indices0, 1, indices1)

    # Python scalars, not tensors made from them: a scalar tensor made on the
    # card is a copy that waits for the host
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), 0.0)

    valid0 = mutual0 & (mscores0 > match_threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    if mask0 is not None:
        valid0 = valid0 & mask0
        mscores0 = torch.where(mask0, mscores0, 0.0)
    if mask1 is not None:
        valid1 = valid1 & mask1
        mscores1 = torch.where(mask1, mscores1, 0.0)

    return {
        "matches0": torch.where(valid0, indices0, -1),
        "matches1": torch.where(valid1, indices1, -1),
        "matching_scores0": mscores0,
        "matching_scores1": mscores1,
    }


def decode_matches(
    scores: torch.Tensor,
    match_threshold: float = 0.2,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Decode from log-assignment scores [B, N+1, M+1]: matches0 [B, N],
    matches1 [B, M] (index or -1) and their confidences."""
    indices0, indices1, max0 = assignment_stats(scores, mask0=mask0, mask1=mask1)
    return decode_matches_from_stats(
        indices0, indices1, max0, match_threshold=match_threshold, mask0=mask0, mask1=mask1
    )


def decode_from_output(
    out: Dict[str, torch.Tensor],
    match_threshold: float = 0.2,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    group=None,
) -> Dict[str, torch.Tensor]:
    """Decode from a SuperGlue output dict, from the decode stats when the
    model emitted them (``decode_stats``), else from the full matrix. With
    ``group`` (the model's ``keypoint_group``) the output and the masks are this
    rank's shards, and the decode of the whole pair comes back on every
    rank."""
    if group is not None:
        with torch.no_grad():
            mask1_all = None if mask1 is None else all_gather(mask1, group)
            if "decode_indices0" in out:
                stats = out["decode_indices0"], out["decode_indices1"], out["decode_max0"]
            else:
                stats = assignment_stats(out["scores"], mask0, mask1_all, group)
            return decode_matches_from_stats(
                all_gather(stats[0], group), stats[1], all_gather(stats[2], group),
                match_threshold=match_threshold,
                mask0=None if mask0 is None else all_gather(mask0, group), mask1=mask1_all,
            )
    if "decode_indices0" in out:
        return decode_matches_from_stats(
            out["decode_indices0"], out["decode_indices1"], out["decode_max0"],
            match_threshold=match_threshold, mask0=mask0, mask1=mask1,
        )
    return decode_matches(out["scores"], match_threshold=match_threshold, mask0=mask0, mask1=mask1)
