"""Inference API + CLI (port of ``openglue_tpu/cli/inference.py``; reference
inference.py:41-270).

``OpenGlueMatcher`` mirrors the reference's kornia-LocalFeatureMatcher-style
module: initialize from an experiment directory (config.yaml +
features_config.yaml + checkpoints/, the layout the cached trainer writes),
take two images, return matched keypoints/LAFs/confidences after
mutual-NN + threshold decoding. ``run_inference`` adds MAGSAC fundamental-
matrix inlier filtering (reference inference.py:230-233).

Features come from a device extractor (SuperPoint, the DoG SIFT,
GFTT-AffNet-HardNet), run on the matcher's device with one copy of its
output back to the host per image, or from a host extractor (OpenCV, whose
AffNet/HardNet variant runs its networks on the matcher's device); the
online trainer's experiments wait for ROADMAP.md module 9b and are refused.
A request moves its extracted arrays to the matcher's device once, decodes
there and copies the decoded matches and the scores back in one transfer.

Usage:
  python -m openglue_tpu_torch.cli.inference --experiment logs/... \\
      --image0 a.jpg --image1 b.jpg [--output matches.npz] [--visualize m.png] \\
      [--device cuda|cpu]

The matcher runs on ``--device`` (default ``cuda``, which must be present).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from openglue_tpu_torch.cli.extract_features import build_device_extractor, extract_on_device
from openglue_tpu_torch.core.config import Config, load_config
from openglue_tpu_torch.data import io
from openglue_tpu_torch.data.bucketing import batch_bucket
from openglue_tpu_torch.features.prepare import prepare_features_output
from openglue_tpu_torch.models.matching import decode_from_output

UNCALIBRATED = (
    "int8_static serving is uncalibrated: match one representative pair first (the first "
    "match_images call calibrates), then precompile"
)


class OpenGlueMatcher:
    """Two-image matcher built from an experiment's configs.

    ``model_or_state``: a SuperGlue module or a state dict whose weights the
    matcher loads (None keeps a seeded random initialization). The matcher
    builds its own model on ``device`` from ``config`` with the decode stats
    on, and serves it in eval mode."""

    def __init__(
        self,
        config: Config,
        features_config: Config,
        model_or_state: Union[torch.nn.Module, Mapping[str, torch.Tensor], None] = None,
        match_threshold: Optional[float] = None,
        target_size: Tuple[int, int] = (960, 720),
        buckets: Optional[Tuple[int, ...]] = None,
        device="cuda",
    ):
        from openglue_tpu_torch.cli.common import superglue_config_from
        from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
        from openglue_tpu_torch.features.registry import build_host_extractor, is_device_extractor
        from openglue_tpu_torch.models.superglue import SuperGlue

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available (pass --device cpu to serve on the CPU)")
        self.config = config
        self.features_config = features_config
        self.match_threshold = (
            match_threshold
            if match_threshold is not None
            else float(config.get("inference.match_threshold", 0.2))
        )
        self.target_size = tuple(target_size)
        # inference.buckets: pad each pair to the smallest bucket that fits its
        # real keypoint counts instead of the extractor cap — sparse images run
        # on smaller O(N^2) matcher graphs (same contract as data.buckets in
        # the train/eval CLIs; see data/bucketing.py)
        if buckets is None:
            buckets = config.get("inference.buckets")
        self.buckets = tuple(int(b) for b in buckets) if buckets else None

        self.device_extractor = is_device_extractor(features_config["name"])
        if self.device_extractor:
            self.extractor = build_device_extractor(features_config, features_config.get("weights"), self.device)
        else:
            self.extractor = build_host_extractor(features_config, self.device)

        laf_method = config.get("superglue.laf_to_sideinfo_method", "none")
        self.laf_converter = get_laf_to_sideinfo_converter(laf_method)
        descriptor_dim = int(features_config["descriptor_dim"])
        sg_config = superglue_config_from(config, descriptor_dim, self.laf_converter.side_info_dim)
        # inference decodes from the stats the forward emits
        # (decode_from_output); the weights are unaffected
        sg_config = dataclasses.replace(sg_config, decode_stats=True)
        self.model = SuperGlue(sg_config, device=self.device, generator=torch.Generator().manual_seed(0))
        if model_or_state is not None:
            state = model_or_state.state_dict() if isinstance(model_or_state, torch.nn.Module) else model_or_state
            self.model.load_state_dict(state)
        self.model.eval()
        self._last_num_keypoints = None  # matcher N of the last match_images

    @property
    def static_int8(self) -> bool:
        """Whether the matcher serves an ``int8_static*`` mode."""
        return hasattr(self.model, "int8_calibration")

    def precompile(self, num_keypoints) -> None:
        """Warm-up at the serving shape(s), the counterpart of the JAX
        package's ahead-of-time compile: build the host NMS and, on a CUDA
        device, every kernel; then one eval forward per keypoint count on
        zeros under ``torch.no_grad()``. Accepts one keypoint count or a
        sequence (e.g. ``matcher.buckets``) and prints its seconds. It
        changes nothing the matcher serves with: eval mode, no BatchNorm
        update, no calibration (an uncalibrated ``int8_static*`` matcher is
        refused)."""
        from openglue_tpu_torch import native

        if self.static_int8 and not self.model.int8_calibration.calibrated:
            raise RuntimeError(UNCALIBRATED)
        # Anything non-iterable is a single count (covers numpy integer
        # scalars, which are not Python ints but must not be iterated).
        counts = (
            tuple(int(k) for k in num_keypoints)
            if hasattr(num_keypoints, "__iter__")
            else (int(num_keypoints),)
        )
        start = time.perf_counter()
        native.load()
        if self.device.type == "cuda":
            from openglue_tpu_torch.ops import kernels

            kernels.build_all()
        d = int(self.features_config["descriptor_dim"])
        s = self.laf_converter.side_info_dim + 1
        self.model.eval()
        with torch.no_grad():
            for k in counts:
                zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=self.device)
                self.model(
                    kpts0=zeros(1, k, 2), kpts1=zeros(1, k, 2),
                    desc0=zeros(1, k, d), desc1=zeros(1, k, d),
                    side_info0=zeros(1, k, s), side_info1=zeros(1, k, s),
                    image_size0=zeros(1, 2), image_size1=zeros(1, 2),
                    mask0=zeros(1, k, dtype=torch.bool), mask1=zeros(1, k, dtype=torch.bool),
                )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"precompile: host NMS{' and kernels' if self.device.type == 'cuda' else ''} built, one "
              f"forward at N={'/'.join(map(str, counts))} in {time.perf_counter() - start:.2f}s", flush=True)

    def _ensure_calibrated(self, kw) -> None:
        """Static-scale PTQ serving (`superglue.quantize: int8_static`): the
        first matched pair doubles as the calibration batch: one calibration
        pass records per-layer activation absmaxes (``SuperGlue.calibrate``);
        every later pair serves with static scales."""
        if self.static_int8 and not self.model.int8_calibration.calibrated:
            self.model.calibrate(**kw)

    def extract(self, image: np.ndarray):
        """grayscale uint8 [H, W] -> (lafs, scores, desc, mask, (w, h)) numpy,
        in the resized image's pixels (a device extractor's detections in
        the padding to multiples of 8 masked out)."""
        resized = io.aspect_preserving_resize(image, self.target_size)
        h, w = resized.shape[:2]
        if self.device_extractor:
            lafs, scores, desc, mask = extract_on_device(self.extractor, resized, self.device)
        else:
            lafs, scores, desc, mask = self.extractor.detect_and_compute(resized)
        return lafs, scores, desc, mask, (w, h)

    @staticmethod
    def _to_bucket(lafs, scores, desc, mask, bucket: int):
        """Trim (top response among valid) or zero-pad the per-image feature
        arrays to ``bucket`` keypoints; padding rows carry mask=False."""
        n = len(scores)
        if n == bucket:
            return lafs, scores, desc, mask
        if n > bucket:
            # valid keypoints first (by response), invalid padding last —
            # the same top-score selection the collate path uses
            order = np.argsort(
                np.where(mask, -scores.astype(np.float64), np.inf), kind="stable"
            )[:bucket]
            return lafs[order], scores[order], desc[order], mask[order]
        pad = bucket - n
        return (
            np.concatenate([lafs, np.zeros((pad,) + lafs.shape[1:], lafs.dtype)]),
            np.concatenate([scores, np.zeros(pad, scores.dtype)]),
            np.concatenate([desc, np.zeros((pad, desc.shape[1]), desc.dtype)]),
            np.concatenate([mask, np.zeros(pad, bool)]),
        )

    def match_images(self, image0: np.ndarray, image1: np.ndarray) -> Dict[str, np.ndarray]:
        """Full pipeline on a pair of grayscale uint8 images."""
        extracted = [self.extract(img) for img in (image0, image1)]
        if self.buckets is not None:
            counts = [int(np.sum(mask)) for _, _, _, mask, _ in extracted]
            bucket = batch_bucket(counts, self.buckets)
            extracted = [
                (*self._to_bucket(lafs, scores, desc, mask, bucket), size)
                for lafs, scores, desc, mask, size in extracted
            ]

        s0, s1 = (
            prepare_features_output(
                lafs[None], scores[None], desc[None], self.laf_converter,
                np.asarray(size, np.float32)[None], mask=mask[None], device=self.device,
            )
            for lafs, scores, desc, mask, size in extracted
        )
        kw = dict(
            kpts0=s0.keypoints, kpts1=s1.keypoints,
            desc0=s0.descriptors, desc1=s1.descriptors,
            side_info0=s0.side_info, side_info1=s1.side_info,
            image_size0=s0.image_size, image_size1=s1.image_size,
            mask0=s0.mask, mask1=s1.mask,
        )
        n0 = int(s0.keypoints.shape[1])
        self._last_num_keypoints = n0
        self._ensure_calibrated(kw)
        with torch.no_grad():
            out = self.model(**kw)
            decoded = decode_from_output(out, self.match_threshold, mask0=s0.mask, mask1=s1.mask)
            # one copy to the host: the matches (exact in f32), their
            # confidences and the log-assignment scores
            scores = out["scores"][0]
            host = torch.cat([
                decoded["matches0"][0].to(scores.dtype), decoded["matching_scores0"][0], scores.flatten(),
            ]).cpu().numpy()
        matches0 = host[:n0].astype(np.int64)
        conf = host[n0:2 * n0]
        valid = matches0 >= 0
        idx0 = np.flatnonzero(valid)
        idx1 = matches0[valid]
        (lafs0, *_), (lafs1, *_) = extracted
        return {
            "keypoints0": lafs0[:, :, 2][idx0],
            "keypoints1": lafs1[:, :, 2][idx1],
            "lafs0": lafs0[idx0],
            "lafs1": lafs1[idx1],
            "confidence": conf[idx0],
            "indices0": idx0,
            "indices1": idx1,
            "scores": host[2 * n0:].reshape(tuple(scores.shape)),
        }


def initialize_matcher(experiment_dir, checkpoint_step: Optional[int] = None, **kwargs) -> OpenGlueMatcher:
    """Build a matcher from a cached-training experiment directory
    (reference initialize_models, inference.py:41-78): config.yaml,
    features_config.yaml and the model's part of ``checkpoints/<step>.pt``
    (the latest unless ``checkpoint_step``). ``kwargs`` go to
    ``OpenGlueMatcher``. An online experiment (its config has a ``features``
    section: the checkpoint holds the extractor and the matcher) waits for
    ROADMAP.md module 9b and raises."""
    from openglue_tpu_torch.train.checkpoint import restore_model

    experiment_dir = Path(experiment_dir)
    config = load_config(experiment_dir / "config.yaml")
    features_config = load_config(experiment_dir / "features_config.yaml")
    if "features" in config:
        raise NotImplementedError(
            f"{experiment_dir} is an online experiment (its config has a features section): the online "
            "trainer and its checkpoints are not ported yet (ROADMAP.md module 9b)"
        )
    matcher = OpenGlueMatcher(config, features_config, **kwargs)
    restore_model(experiment_dir / "checkpoints", matcher.model, step=checkpoint_step)
    return matcher


def magsac_inlier_filter(kpts0: np.ndarray, kpts1: np.ndarray) -> np.ndarray:
    """USAC_MAGSAC fundamental-matrix inlier mask (reference inference.py:230-233)."""
    import cv2

    if len(kpts0) < 8:
        return np.ones(len(kpts0), bool)
    _, mask = cv2.findFundamentalMat(
        kpts0.astype(np.float64), kpts1.astype(np.float64), cv2.USAC_MAGSAC,
        1.0, 0.999, 100000,
    )
    if mask is None:
        return np.ones(len(kpts0), bool)
    return mask.ravel().astype(bool)


def run_inference(matcher: OpenGlueMatcher, image0_path, image1_path, ransac: bool = True):
    img0 = io.read_grayscale(image0_path)
    img1 = io.read_grayscale(image1_path)
    result = matcher.match_images(img0, img1)
    if ransac:
        inliers = magsac_inlier_filter(result["keypoints0"], result["keypoints1"])
        for key in ("keypoints0", "keypoints1", "lafs0", "lafs1", "confidence", "indices0", "indices1"):
            result[key] = result[key][inliers]
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True)
    parser.add_argument("--image0", required=True)
    parser.add_argument("--image1", required=True)
    parser.add_argument("--checkpoint_step", type=int, default=None)
    parser.add_argument("--match_threshold", type=float, default=None)
    parser.add_argument(
        "--buckets", type=int, nargs="*", default=None,
        help="static keypoint bucket sizes (e.g. --buckets 256 512 1024): pad "
        "each pair to the smallest bucket fitting its real counts instead of "
        "the extractor cap (defaults to config inference.buckets)",
    )
    parser.add_argument("--no_ransac", action="store_true")
    parser.add_argument("--output", default=None, help="save matches to .npz")
    parser.add_argument("--visualize", default=None, help="write a match image here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    matcher = initialize_matcher(
        args.experiment, args.checkpoint_step,
        match_threshold=args.match_threshold,
        buckets=tuple(args.buckets) if args.buckets else None,
        device=args.device,
    )
    result = run_inference(matcher, args.image0, args.image1, ransac=not args.no_ransac)
    print(f"{len(result['keypoints0'])} matches")
    if args.output:
        np.savez(
            args.output,
            keypoints0=result["keypoints0"],
            keypoints1=result["keypoints1"],
            confidence=result["confidence"],
        )
        print(f"saved to {args.output}")
    if args.visualize:
        from openglue_tpu_torch.visualization import draw_matches

        img0 = io.aspect_preserving_resize(io.read_grayscale(args.image0), matcher.target_size)
        img1 = io.aspect_preserving_resize(io.read_grayscale(args.image1), matcher.target_size)
        draw_matches(
            img0, img1,
            result["keypoints0"], result["keypoints1"], result["confidence"],
            lafs0=result["lafs0"], lafs1=result["lafs1"],
            output_path=args.visualize,
        )
        print(f"visualization saved to {args.visualize}")
    return result


if __name__ == "__main__":
    main()
