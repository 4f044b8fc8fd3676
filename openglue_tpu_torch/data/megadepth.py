"""MegaDepth pair datasets (port of ``openglue_tpu/data/megadepth.py``: the
pair index, the online trainer's image dataset and the cached-feature
dataset; reference data/megadepth_dataset.py:55-282).

Directory contract (identical to the reference so existing data drops in):

  <root>/pairs/<scene>/sparse-txt/pairs.txt
      lines: img0 img1 exif0 exif1 K0[9] K1[9] RT[16] overlap
  <root>/phoenix/S6/zl548/MegaDepth_v1/<scene>/dense0/imgs/<img>
  <root>/phoenix/S6/zl548/MegaDepth_v1/<scene>/dense0/depths/<img>.h5   (key 'depth')
  <root>/<features_dir>/<scene>/<base>_{lafs,scores,descriptors,size}.h5

Datasets here are plain-Python sequences of numpy sample dicts; batching into
fixed-shape tensors is data/collate.py, thread prefetching data/loader.py.
Every h5 read goes through ``data.io``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openglue_tpu_torch.data import io

MEGADEPTH_IMAGES_SUBDIR = "phoenix/S6/zl548/MegaDepth_v1"


@dataclasses.dataclass(frozen=True)
class PairRecord:
    scene: str
    img0: str
    img1: str
    K0: np.ndarray
    K1: np.ndarray
    R: np.ndarray
    T: np.ndarray
    overlap: float


def parse_pairs_line(line: str, scene: str) -> PairRecord:
    """`img0 img1 exif0 exif1 K0[9] K1[9] RT[16] overlap`
    (reference megadepth_dataset.py:90-99)."""
    img0, img1, _, _, *params, overlap = line.split(" ")
    params = [float(x) for x in params]
    K0 = np.asarray(params[:9], np.float32).reshape(3, 3)
    K1 = np.asarray(params[9:18], np.float32).reshape(3, 3)
    RT = np.asarray(params[18:34], np.float32).reshape(4, 4)
    return PairRecord(
        scene=scene, img0=img0, img1=img1, K0=K0, K1=K1,
        R=RT[:3, :3], T=RT[:3, 3], overlap=float(overlap),
    )


class MegaDepthPairsIndex:
    """Scene -> pair-record listing with overlap filtering and per-scene caps
    (reference BaseMegaDepthPairsDataset, megadepth_dataset.py:55-109)."""

    def __init__(
        self,
        root_path,
        scenes_list: Sequence[str],
        max_pairs_per_scene: Optional[int] = None,
        overlap: Optional[Tuple[float, float]] = None,
    ):
        self.root_path = Path(root_path)
        self.pairs: "OrderedDict[str, List[PairRecord]]" = OrderedDict()
        for scene in scenes_list:
            path = self.root_path / "pairs" / scene / "sparse-txt" / "pairs.txt"
            records: List[PairRecord] = []
            if path.exists():
                for line in path.read_text().splitlines():
                    line = line.rstrip()
                    if not line:
                        continue
                    rec = parse_pairs_line(line, scene)
                    if overlap is None or overlap[0] <= rec.overlap <= overlap[1]:
                        records.append(rec)
            if max_pairs_per_scene is not None:
                records = records[:max_pairs_per_scene]
            self.pairs[scene] = records
        self.flat: List[PairRecord] = [r for recs in self.pairs.values() for r in recs]

    def __len__(self) -> int:
        return len(self.flat)

    def __getitem__(self, idx: int) -> PairRecord:
        return self.flat[idx]

    def scene_sizes(self) -> Dict[str, int]:
        return {scene: len(recs) for scene, recs in self.pairs.items()}


class MegaDepthPairsDataset:
    """Online-mode dataset: grayscale image pairs + depth + pose
    (reference MegaDepthPairsDataset, megadepth_dataset.py:114-192).

    Sample dict: image0/1 [H, W] float32 in [0, 1], transformation dict with
    K0, K1, R, T, dense depth0/1 at the image size.
    """

    def __init__(
        self,
        root_path,
        scenes_list: Sequence[str],
        target_size: Tuple[int, int] = (960, 720),
        random_crop: bool = False,
        max_pairs_per_scene: Optional[int] = None,
        overlap: Optional[Tuple[float, float]] = None,
        seed: int = 0,
    ):
        self.index = MegaDepthPairsIndex(root_path, scenes_list, max_pairs_per_scene, overlap)
        self.root_path = Path(root_path)
        self.target_size = tuple(target_size)
        self.random_crop = random_crop
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.index)

    def _image_dir(self, scene: str) -> Path:
        return self.root_path / MEGADEPTH_IMAGES_SUBDIR / scene / "dense0"

    def __getitem__(self, idx: int) -> Dict:
        rec = self.index[idx]
        sides = []
        for img_name, K in ((rec.img0, rec.K0), (rec.img1, rec.K1)):
            base = self._image_dir(rec.scene)
            image = io.read_grayscale(base / "imgs" / img_name)
            depth = io.load_h5(base / "depths" / (img_name[: -len(Path(img_name).suffix)] + ".h5"), key="depth")
            image, depth, K = io.resize_and_crop(image, depth, K, self.target_size, self.random_crop, self.rng)
            sides.append((image.astype(np.float32) / 255.0, depth.astype(np.float32), K))
        (image0, depth0, K0), (image1, depth1, K1) = sides
        return {
            "image0": image0,
            "image1": image1,
            "transformation": {
                "type": "3d_reprojection",
                "K0": K0, "K1": K1, "R": rec.R, "T": rec.T,
                "depth0": depth0, "depth1": depth1,
            },
        }


class MegaDepthPairsDatasetFeatures:
    """Cached-features dataset (reference MegaDepthPairsDatasetFeatures,
    megadepth_dataset.py:195-282): per-image h5 features from
    ``<root>/<features_dir>/<scene>/``; crop filters keypoints outside the
    window and shifts LAF translations + the principal point.

    Sample dict: lafs0/1 [N, 2, 3], scores0/1 [N], descriptors0/1 [N, D],
    dense depth0/1 at the feature-extraction resolution (cropped),
    transformation, image sizes.

    ``device_descriptors``: the contract of the device-resident descriptor
    cache (data/device_cache.py). descriptors0/1 is then the image's
    unfiltered pre-crop block (the image cache's array itself, not a copy:
    do not mutate it), and the sample also carries ``desc_key0/1`` =
    (scene, image) and ``desc_orig_idx0/1`` [N] int32, each surviving
    keypoint's row in that block. Every other field is as in host mode.
    """

    def __init__(
        self,
        root_path,
        features_dir: str,
        scenes_list: Sequence[str],
        target_size: Tuple[int, int] = (960, 720),
        random_crop: bool = False,
        max_pairs_per_scene: Optional[int] = None,
        overlap: Optional[Tuple[float, float]] = None,
        seed: int = 0,
        cache_images: int = 64,
        device_descriptors: bool = False,
    ):
        self.index = MegaDepthPairsIndex(root_path, scenes_list, max_pairs_per_scene, overlap)
        self.root_path = Path(root_path)
        self.features_base_dir = self.root_path / features_dir
        self.target_size = tuple(target_size)
        self.random_crop = random_crop
        self.rng = np.random.default_rng(seed)
        self._count_cache: Dict[Tuple[str, str], int] = {}
        # LRU of pre-crop per-image arrays (features + extraction-size depth):
        # each image appears in many pairs of its scene, and the depth read
        # dominates a sample's host time, so repeats become crop arithmetic.
        # 0 disables. Entries are immutable: the crop path filters into fresh
        # arrays.
        self.cache_images = int(cache_images)
        self._image_cache: "OrderedDict[Tuple[str, str], tuple]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.device_descriptors = bool(device_descriptors)

    def __len__(self) -> int:
        return len(self.index)

    def _image_keypoint_count(self, scene: str, img_name: str) -> int:
        key = (scene, img_name)
        count = self._count_cache.get(key)
        if count is None:
            base_name = img_name.rsplit(".", 1)[0] if "." in img_name else img_name
            count = int(
                io.h5_dataset_shape(self.features_base_dir / scene / f"{base_name}_scores.h5")[0]
            )
            self._count_cache[key] = count
        return count

    def keypoint_count(self, idx: int) -> int:
        """Cheap bucket key for bucket grouping: the larger side's detector
        keypoint count, read from the ``*_scores.h5`` dataset shape (metadata
        only). It is the pre-crop count: cropping only removes keypoints, so
        the bucket chosen from it always fits the loaded sample (it may
        overshoot by one bucket when a crop drops many keypoints)."""
        rec = self.index[idx]
        return max(
            self._image_keypoint_count(rec.scene, rec.img0),
            self._image_keypoint_count(rec.scene, rec.img1),
        )

    def _load_image_raw(self, scene: str, img_name: str):
        """PRE-crop per-image arrays (cache unit): features at extraction
        size, depth resized to extraction size, original/extraction sizes.
        Returned arrays are shared with the cache — callers must not mutate
        them (the crop path below filters into fresh arrays)."""
        key = (scene, img_name)
        with self._cache_lock:
            entry = self._image_cache.get(key)
            if entry is not None:
                self._image_cache.move_to_end(key)
                return entry
        import cv2

        base_name = img_name.rsplit(".", 1)[0] if "." in img_name else img_name
        fdir = self.features_base_dir / scene
        lafs = io.load_h5(fdir / f"{base_name}_lafs.h5").astype(np.float32)
        scores = io.load_h5(fdir / f"{base_name}_scores.h5").astype(np.float32)
        descriptors = io.load_h5(fdir / f"{base_name}_descriptors.h5").astype(np.float32)
        image_size = np.asarray(io.load_h5(fdir / f"{base_name}_size.h5")).astype(np.int64)

        depth = io.load_h5(
            self.root_path / MEGADEPTH_IMAGES_SUBDIR / scene / "dense0/depths" / f"{base_name}.h5",
            key="depth",
        ).astype(np.float32)
        # original image size from the depth map (the reference reads the jpg
        # for this, megadepth_dataset.py:211-212 — depth has identical dims)
        orig_size = depth.shape[::-1]
        depth = cv2.resize(depth, tuple(int(s) for s in image_size), interpolation=cv2.INTER_NEAREST)
        entry = (lafs, scores, descriptors, depth, image_size, orig_size)
        if self.cache_images > 0:
            with self._cache_lock:
                self._image_cache[key] = entry
                while len(self._image_cache) > self.cache_images:
                    self._image_cache.popitem(last=False)
        return entry

    def _load_side(self, scene: str, img_name: str, K: np.ndarray):
        """Returns (lafs, scores, descriptors, depth, K, orig_idx) of one
        image after the crop; ``orig_idx`` maps each surviving keypoint to
        its row in the pre-crop arrays. With ``device_descriptors`` the
        descriptors are the unfiltered pre-crop block (shared with the image
        cache)."""
        lafs, scores, descriptors, depth, image_size, orig_size = self._load_image_raw(
            scene, img_name
        )
        K = np.diag(
            [image_size[0] / orig_size[0], image_size[1] / orig_size[1], 1.0]
        ).astype(np.float32) @ K
        orig_idx = np.arange(lafs.shape[0], dtype=np.int32)

        tw, th = self.target_size
        if tw < image_size[0]:  # crop width
            start = (
                int(self.rng.integers(0, image_size[0] - tw))
                if self.random_crop
                else (int(image_size[0]) - tw) // 2
            )
            depth = depth[:, start : start + tw]
            keep = (lafs[:, 0, 2] >= start) & (lafs[:, 0, 2] < start + tw)
            K = K.copy(); K[0, 2] -= start
            lafs = lafs[keep]; lafs[:, 0, 2] -= start  # fresh array from the keep-filter
            scores, orig_idx = scores[keep], orig_idx[keep]
            if not self.device_descriptors:
                descriptors = descriptors[keep]
        elif th < image_size[1]:  # crop height
            start = (
                int(self.rng.integers(0, image_size[1] - th))
                if self.random_crop
                else (int(image_size[1]) - th) // 2
            )
            depth = depth[start : start + th, :]
            keep = (lafs[:, 1, 2] >= start) & (lafs[:, 1, 2] < start + th)
            K = K.copy(); K[1, 2] -= start
            lafs = lafs[keep]; lafs[:, 1, 2] -= start
            scores, orig_idx = scores[keep], orig_idx[keep]
            if not self.device_descriptors:
                descriptors = descriptors[keep]
        return lafs, scores, descriptors, depth, K, orig_idx

    def __getitem__(self, idx: int) -> Dict:
        rec = self.index[idx]
        lafs0, scores0, desc0, depth0, K0, oi0 = self._load_side(rec.scene, rec.img0, rec.K0)
        lafs1, scores1, desc1, depth1, K1, oi1 = self._load_side(rec.scene, rec.img1, rec.K1)
        sample = {
            "lafs0": lafs0, "scores0": scores0, "descriptors0": desc0,
            "lafs1": lafs1, "scores1": scores1, "descriptors1": desc1,
            "transformation": {
                "type": "3d_reprojection",
                "K0": K0, "K1": K1, "R": rec.R, "T": rec.T,
                "depth0": depth0, "depth1": depth1,
            },
            "image0_size": self.target_size,
            "image1_size": self.target_size,
        }
        if self.device_descriptors:
            sample["desc_key0"] = (rec.scene, rec.img0)
            sample["desc_key1"] = (rec.scene, rec.img1)
            sample["desc_orig_idx0"] = oi0
            sample["desc_orig_idx1"] = oi1
        return sample
