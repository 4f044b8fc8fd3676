"""Host-side IO helpers (port of ``openglue_tpu/data/io.py``): h5 arrays and
image loading/resizing with intrinsics updates (reference
data/megadepth_dataset.py:133-176). Every h5 read and write of the port goes
through this module; ``h5py`` and ``cv2`` are imported where they are used.

h5 files are read with h5py. The reference uses deepdish (pytables); both
layouts are supported: a dataset named ``data`` (deepdish scalar-array files),
a single top-level dataset of any name, or an explicit key (``depth`` for
MegaDepth depth maps).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def load_h5(path: PathLike, key: Optional[str] = None) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        if key is not None:
            return np.asarray(f[key])
        if "data" in f:
            return np.asarray(f["data"])
        keys = [k for k in f.keys() if isinstance(f[k], h5py.Dataset)]
        if len(keys) != 1:
            raise ValueError(f"{path}: ambiguous h5 keys {list(f.keys())}, pass key=")
        return np.asarray(f[keys[0]])


def h5_dataset_shape(path: PathLike, key: Optional[str] = None) -> Tuple[int, ...]:
    """Shape of the (single) dataset without reading its data (one metadata
    read): the cheap bucket key of bucket grouping (keypoint counts from the
    ``*_scores.h5`` cache files, data/bucketing.py)."""
    import h5py

    with h5py.File(path, "r") as f:
        if key is not None:
            return tuple(f[key].shape)
        if "data" in f:
            return tuple(f["data"].shape)
        keys = [k for k in f.keys() if isinstance(f[k], h5py.Dataset)]
        if len(keys) != 1:
            raise ValueError(f"{path}: ambiguous h5 keys {list(f.keys())}, pass key=")
        return tuple(f[keys[0]].shape)


def save_h5(
    path: PathLike,
    array: np.ndarray,
    key: str = "data",
    compression: Optional[str] = None,
    compression_opts: Optional[int] = None,
) -> None:
    """One dataset ``key`` in a new file at ``path``; ``compression`` and
    ``compression_opts`` are h5py's (the MegaDepth depth maps: gzip, 1)."""
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset(
            key, data=np.asarray(array), compression=compression, compression_opts=compression_opts
        )


def read_grayscale(path: PathLike) -> np.ndarray:
    """Read an image as grayscale float-ready uint8 [H, W]."""
    import cv2

    image = cv2.imread(str(path))
    if image is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)


def aspect_preserving_resize(
    image: np.ndarray, target_size: Tuple[int, int]
) -> np.ndarray:
    """Resize so the constraining side hits target, keeping aspect ratio
    (reference extract_features.py resize: one side equals target, other >=).

    target_size: (width, height). Returns the resized image (possibly larger
    than target in one dimension — cropping is a separate step)."""
    import cv2

    h, w = image.shape[:2]
    tw, th = target_size
    if w / h > tw / th:
        new_h = th
        new_w = int(round(w / h * new_h))
    else:
        new_w = tw
        new_h = int(round(new_w * h / w))
    return cv2.resize(image, (new_w, new_h))


def resize_and_crop(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    K: np.ndarray,
    target_size: Tuple[int, int],
    random_crop: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Aspect-preserving resize + center/random crop, updating intrinsics
    (reference megadepth_dataset.py:133-176: scale the K diagonal by the
    resize factors, then shift the principal point by the crop offset)."""
    import cv2

    rng = rng or np.random.default_rng()
    h, w = image.shape[:2]
    tw, th = target_size
    current_ratio = w / h
    target_ratio = tw / th

    if current_ratio > target_ratio:
        rh, rw = th, int(current_ratio * th)
    else:
        rw = tw
        rh = int(rw / current_ratio)
    image = cv2.resize(image, (rw, rh))
    if depth is not None:
        depth = cv2.resize(depth, (rw, rh), interpolation=cv2.INTER_NEAREST)

    K = np.diag([rw / w, rh / h, 1.0]).astype(np.float32) @ K

    if current_ratio > target_ratio:  # crop width
        start = int(rng.integers(0, max(rw - tw, 1))) if random_crop else (rw - tw) // 2
        image = image[:, start : start + tw]
        if depth is not None:
            depth = depth[:, start : start + tw]
        K = K.copy()
        K[0, 2] -= start
    else:  # crop height
        start = int(rng.integers(0, max(rh - th, 1))) if random_crop else (rh - th) // 2
        image = image[start : start + th, :]
        if depth is not None:
            depth = depth[start : start + th, :]
        K = K.copy()
        K[1, 2] -= start
    return image, depth, K
