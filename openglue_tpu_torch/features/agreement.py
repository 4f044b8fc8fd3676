"""How far two extractions of one image agree: the card's run of an
extractor against its CPU run with the same weights (``chip_smoke.py``'s
``device_extractors`` phase and the card tests hold them to the bars below).

An extraction is the host extractors' 4-tuple of numpy arrays (lafs
[N, 2, 3], responses [N], descriptors [N, D], mask [N]), as
``cli.extract_features.extract_on_device`` and ``detect_and_compute``
return it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from openglue_tpu_torch.features.patches import extract_laf_patches

# the bars: the share of the reference's valid keypoints found within
# KEYPOINT_PX, and the share found with the same frame (the LAF's 2x2 part
# within FRAME_REL_MAX relative: an extractor that takes the dominant
# gradient orientation turns a keypoint's frame by a whole bin, 10 degrees,
# where two bins of its histogram nearly tie); on the keypoints found with
# the same frame, the share whose descriptors agree within DESCRIPTOR_MAX
# (max |difference|; RootSIFT's square root magnifies a difference near an
# empty bin, so a few SIFT keypoints moved by 3e-4 px differ by up to 0.02);
# on all found, the responses' max relative difference; and the share of
# the same-frame keypoints whose descriptor's nearest neighbour (L2) among
# the other run's is its own counterpart (``identified``). The DoG SIFT is
# held by that share and not by DESCRIPTOR_MAX: moving its keypoints by
# 1e-4 px leaves 0.79 of its textured descriptors within 1e-3 on
# chip_smoke.py's serving image (max 0.045; tests/torch_tolerance_evidence.py:
# the eps under its gradient magnitudes gives every flat pixel a weight at a
# rounding-noise orientation), and the sub-pixel refinement of an H100 run
# differs from the CPU's by up to 3e-4 px. A patch
# descriptor is held only where its patch is not flat (CONTRAST_MIN): a
# flat patch's gradients, and so its descriptor, are rounding noise (the
# zero-padded blur of the DoG SIFT fires along the image's border, where
# the patch clamps to one row)
KEYPOINT_PX = 0.05
SHARED_MIN = 0.99
FRAME_REL_MAX = 1e-3
DESCRIPTOR_MAX = 1e-3
RESPONSE_REL_MAX = 1e-4
CONTRAST_MIN = 1e-3


def textured(image: np.ndarray, lafs: np.ndarray, patch_size: int) -> np.ndarray:
    """[N] bool: rows whose LAF patch of the uint8 ``image`` [H, W] spans at
    least CONTRAST_MIN (max - min, the image in [0, 1])."""
    patches = extract_laf_patches(torch.from_numpy(image.astype(np.float32) / 255.0)[None],
                                  torch.from_numpy(np.ascontiguousarray(lafs, np.float32))[None], patch_size)[0]
    return (patches.amax(dim=(-2, -1)) - patches.amin(dim=(-2, -1)) >= CONTRAST_MIN).numpy()


def agreement(got: Sequence[np.ndarray], ref: Sequence[np.ndarray], px: float = KEYPOINT_PX,
              held: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Readings of ``got`` against ``ref``: for each valid reference row, the
    valid row of ``got`` whose centre lies within ``px`` and whose LAF is
    nearest (centre distance plus the 2x2 parts' distance: two keypoints at
    one place but at two scales stay apart, and so do two of one scale and
    orientation bin a fraction of a pixel apart). ``shared`` is the share of
    reference rows so found; ``frames`` the share found with the same frame
    (2x2 parts within FRAME_REL_MAX of the reference's norm);
    ``descriptors`` the share of those whose descriptors agree within
    DESCRIPTOR_MAX, ``identified`` the share whose counterpart's descriptor
    is the nearest (L2) of the other run's, within DESCRIPTOR_MAX (two
    keypoints in one of SuperPoint's 8x8 cells can carry descriptors that
    close), ``descriptor_max`` their max |descriptor difference| and
    ``turned_descriptor_max`` the rest's (descriptors only of the reference
    rows ``held`` marks, [N] bool, all by default; ``held`` the share of
    valid rows marked); ``response_rel_max`` the max |response difference| /
    |reference response| and ``px_max`` the largest centre distance, on all
    found."""
    (glafs, gresp, gdesc, gmask), (rlafs, rresp, rdesc, rmask) = got, ref
    glafs, gresp, gdesc = glafs[gmask].astype(np.float64), gresp[gmask], gdesc[gmask]
    rheld = np.ones(len(rmask), bool)[rmask] if held is None else held[rmask]
    rlafs, rresp, rdesc = rlafs[rmask].astype(np.float64), rresp[rmask], rdesc[rmask]
    readings = dict(n_ref=int(len(rlafs)), n_got=int(len(glafs)), shared=0.0, frames=0.0, held=0.0, descriptors=0.0,
                    identified=0.0, descriptor_max=0.0, turned_descriptor_max=0.0, response_rel_max=0.0, px_max=0.0)
    if not len(rlafs) or not len(glafs):
        return readings
    centre = np.linalg.norm(rlafs[:, None, :, 2] - glafs[None, :, :, 2], axis=-1)
    shape = np.linalg.norm((rlafs[:, None, :, :2] - glafs[None, :, :, :2]).reshape(len(rlafs), len(glafs), 4), axis=-1)
    cost = np.where(centre <= px, centre + shape, np.inf)
    nearest = cost.argmin(1)
    found = np.isfinite(cost.min(1))
    i, j = np.flatnonzero(found), nearest[found]
    readings["shared"] = float(found.mean())
    if len(i):
        frame = rlafs[i, :, :2].reshape(len(i), 4)
        same = np.linalg.norm(glafs[j, :, :2].reshape(len(j), 4) - frame, axis=1) <= (
            FRAME_REL_MAX * np.linalg.norm(frame, axis=1))
        desc = np.abs(gdesc[j] - rdesc[i]).max(axis=1)
        readings["frames"] = float(same.sum() / len(rlafs))
        readings["held"] = float(rheld.mean())
        kept, turned = same & rheld[i], ~same & rheld[i]
        readings["descriptors"] = float((desc[kept] <= DESCRIPTOR_MAX).mean()) if kept.any() else 0.0
        if kept.any():
            a, b = rdesc[i[kept]].astype(np.float64), gdesc[j[kept]].astype(np.float64)
            dist = np.sqrt(np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T, 0.0))
            own = np.diagonal(dist)
            readings["identified"] = float((own <= dist.min(1) + DESCRIPTOR_MAX).mean())
        readings["descriptor_max"] = float(desc[kept].max()) if kept.any() else 0.0
        readings["turned_descriptor_max"] = float(desc[turned].max()) if turned.any() else 0.0
        readings["response_rel_max"] = float((np.abs(gresp[j] - rresp[i]) / np.maximum(np.abs(rresp[i]), 1e-30)).max())
        readings["px_max"] = float(centre[i, j].max())
    return readings


def within_bars(readings: Dict[str, float], descriptor_max: bool = True) -> bool:
    """The bars; ``descriptor_max`` False leaves out DESCRIPTOR_MAX (the DoG
    SIFT, see above), not the identification."""
    shares = [readings["shared"], readings["frames"], readings["identified"]]
    if descriptor_max:
        shares.append(readings["descriptors"])
    return readings["n_ref"] > 0 and min(shares) >= SHARED_MIN and readings["response_rel_max"] <= RESPONSE_REL_MAX
