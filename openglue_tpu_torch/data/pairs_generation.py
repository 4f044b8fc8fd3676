"""Offline pairs-list generation from COLMAP sparse reconstructions (port of
``openglue_tpu/data/pairs_generation.py``; reference
data/explore_megadepth.py:1-209). numpy only; the depth maps are read
through ``data.io``.

Parses COLMAP text exports (cameras.txt: PINHOLE intrinsics; images.txt:
quaternion extrinsics + observed 2D points with 3D-point ids), computes the
3D-point-id overlap |A ∩ B| / min(|A|, |B|) for every image pair, and writes
the pairs.txt records consumed by MegaDepthPairsIndex:

  img0 img1 exif0 exif1 K0[9] K1[9] RT12[16] overlap

The relative pose maps camera-1 coordinates to camera-2:
R12 = R2 R1ᵀ, T12 = T2 − R12 T1 — consistent with reproject_3d's
x1 = R x0 + T convention. Images whose depth map is missing or contains
-1 sentinels are skipped (reference :147-155).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from openglue_tpu_torch.data import io


@dataclasses.dataclass
class ColmapImage:
    image_id: str
    name: str
    K: np.ndarray
    size: Tuple[int, int]
    R: np.ndarray
    T: np.ndarray
    point3d_ids: Set[str]


def quaternion_to_rotation(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Unit quaternion -> rotation matrix (local -> global)."""
    return np.array(
        [
            [2 * (qw * qw + qx * qx) - 1, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 2 * (qw * qw + qy * qy) - 1, 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 2 * (qw * qw + qz * qz) - 1],
        ]
    )


def parse_cameras(lines: Sequence[str]) -> Dict[str, Tuple[np.ndarray, Tuple[int, int]]]:
    """cameras.txt -> {camera_id: (K, (width, height))} (PINHOLE: fx fy cx cy)."""
    cameras = {}
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        camera_id, _model, width, height, fx, fy, cx, cy = line.split(" ")[:8]
        K = np.array(
            [[float(fx), 0, float(cx)], [0, float(fy), float(cy)], [0, 0, 1]]
        )
        cameras[camera_id] = (K, (int(width), int(height)))
    return cameras


def parse_images(
    lines: Sequence[str], cameras: Dict[str, Tuple[np.ndarray, Tuple[int, int]]]
) -> List[ColmapImage]:
    """images.txt: alternating extrinsics line / 2D-points line after a
    4-line header."""
    content = [l.rstrip("\n") for l in lines]
    # skip comment header (reference hardcodes 4 lines; be tolerant)
    while content and content[0].lstrip().startswith("#"):
        content = content[1:]
    images = []
    for i in range(len(content) // 2):
        ext_line = content[2 * i].strip()
        pts_line = content[2 * i + 1].strip()
        if not ext_line:
            continue
        image_id, *extr, camera_id, name = ext_line.split(" ")
        qw, qx, qy, qz, tx, ty, tz = map(float, extr)
        R = quaternion_to_rotation(qw, qx, qy, qz)
        T = np.array([tx, ty, tz])
        parts = pts_line.split(" ") if pts_line else []
        ids = {parts[3 * j + 2] for j in range(len(parts) // 3)} - {"-1"}
        K, size = cameras[camera_id]
        images.append(ColmapImage(image_id, name, K, size, R, T, ids))
    return images


def points3d_overlap(a: Set[str], b: Set[str]) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / min(len(a), len(b))


def _fmt(arr: np.ndarray) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(arr).flatten())


def make_image_pair_record(img1: ColmapImage, img2: ColmapImage, overlap: float) -> str:
    R12 = img2.R @ img1.R.T
    T12 = -R12 @ img1.T + img2.T
    RT12 = np.eye(4)
    RT12[:3, :3], RT12[:3, 3] = R12, T12
    return (
        f"{img1.name} {img2.name} 0 0 {_fmt(img1.K)} {_fmt(img2.K)} "
        f"{_fmt(RT12)} {overlap}"
    )


def valid_depth(depth_dir: Optional[Path], name: str) -> bool:
    """Depth exists and has no -1 sentinel (reference :147-155)."""
    if depth_dir is None:
        return True
    path = Path(depth_dir) / (name.rsplit(".", 1)[0] + ".h5")
    if not path.exists():
        return False
    try:
        depth = io.load_h5(path, key="depth")
    except Exception:
        return False
    return not np.any(depth == -1)


def generate_pairs(
    sparse_dir,
    out_path,
    depth_dir=None,
    overlap_interval: Tuple[float, float] = (0.1, 0.7),
) -> int:
    """Process one scene: <sparse_dir>/{cameras,images}.txt -> pairs.txt.
    Returns the number of pairs written."""
    sparse_dir = Path(sparse_dir)
    cameras = parse_cameras((sparse_dir / "cameras.txt").read_text().splitlines())
    images = parse_images(
        (sparse_dir / "images.txt").read_text().splitlines(), cameras
    )
    images = [im for im in images if valid_depth(depth_dir, im.name)]

    lo, hi = overlap_interval
    count = 0
    with open(out_path, "w") as f:
        for i in range(len(images)):
            for j in range(i + 1, len(images)):
                overlap = points3d_overlap(images[i].point3d_ids, images[j].point3d_ids)
                if lo <= overlap <= hi:
                    f.write(make_image_pair_record(images[i], images[j], overlap) + "\n")
                    count += 1
    return count
