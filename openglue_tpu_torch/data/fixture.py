"""Synthetic MegaDepth-format dataset with real multi-view geometry, and a
folder of textured synthetic images (port of ``generate_megadepth_fixture``
and ``generate_image_fixture`` of ``openglue_tpu/data/fixture.py``; at one
seed the images are byte-equal to the JAX package's).

``generate_megadepth_fixture`` writes the on-disk contract the cached-feature trainer reads (reference
data/megadepth_dataset.py:90-99 pairs.txt lines, depth h5 maps under
``phoenix/S6/zl548/MegaDepth_v1/<scene>/dense0/depths``, the per-image
``*_lafs/_scores/_descriptors/_size.h5`` feature files and the extractor's
``config.yaml``) from a synthetic 3D scene, so that the data is learnable:
each scene is a sphere in front of a background plane seen by jittered
cameras; keypoints are projections of persistent surface points whose
descriptors agree across views up to noise; depth maps are exact ray-traced
renders; pairs.txt carries the true relative poses and the point-overlap
ratios (reference data/explore_megadepth.py:115-174). Every h5 file goes
through ``data.io.save_h5``; at one seed the arrays equal those of the JAX
package's writer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from openglue_tpu_torch.data import io


def _rot_xyz(angles: np.ndarray) -> np.ndarray:
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _render_depth(
    K: np.ndarray, R: np.ndarray, t: np.ndarray, size: Tuple[int, int],
    sphere_c: np.ndarray, sphere_r: float, plane_z: float,
) -> np.ndarray:
    """Exact per-pixel depth (camera z of the first hit) for the
    sphere-plus-background-plane scene. Camera: x_cam = R @ X + t."""
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)  # [H, W, 3]
    d_cam = pix @ np.linalg.inv(K).T
    # world-frame rays: origin C = -R^T t, direction R^T d
    C = -R.T @ t
    d_w = d_cam @ R  # == d_cam @ (R^T)^T
    d_w = d_w / np.linalg.norm(d_w, axis=-1, keepdims=True)

    # sphere: |C + s d - c|^2 = r^2
    oc = C - sphere_c
    b = d_w @ oc
    disc = b * b - (oc @ oc - sphere_r**2)
    hit = disc > 0
    s_sphere = np.where(hit, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    s_sphere = np.where(s_sphere > 0, s_sphere, np.inf)

    # background plane z = plane_z (world)
    dz = d_w[..., 2]
    s_plane = np.where(np.abs(dz) > 1e-9, (plane_z - C[2]) / dz, np.inf)
    s_plane = np.where(s_plane > 0, s_plane, np.inf)

    s = np.minimum(s_sphere, s_plane)
    X = C[None, None, :] + s[..., None] * d_w
    z_cam = (X @ R.T + t)[..., 2]
    return np.where(np.isfinite(s), z_cam, 0.0).astype(np.float32)


def generate_image_fixture(
    root,
    num_images: int = 64,
    image_size: Tuple[int, int] = (1280, 1024),
    seed: int = 0,
) -> dict:
    """Write a folder of textured synthetic grayscale images — the
    homography-pretraining fixture (HomographyPairsDataset consumes any image
    folder; reference data/oxford_paris_dataset.py:27-66 only needs files).

    Texture = smoothed random low-frequency field + random high-contrast
    rectangles/discs, so corner detectors (SuperPoint) find stable keypoints.
    ``image_size`` should exceed target_size + warp_offset (the dataset crops
    warped views inside the frame)."""
    import cv2

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = image_size
    for i in range(num_images):
        base = rng.random((h // 8, w // 8)).astype(np.float32)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        img = 0.3 + 0.4 * (img - img.min()) / max(float(np.ptp(img)), 1e-6)
        for _ in range(rng.integers(40, 80)):
            shade = float(rng.uniform(0.0, 1.0))
            x, y = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 8))
            sw, sh = int(rng.integers(8, w // 6)), int(rng.integers(8, h // 6))
            if rng.random() < 0.5:
                cv2.rectangle(img, (x, y), (min(x + sw, w - 1), min(y + sh, h - 1)),
                              shade, thickness=-1)
            else:
                cv2.circle(img, (x + sw // 2, y + sh // 2), max(4, sw // 3),
                           shade, thickness=-1)
        img8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"img{i:04d}.jpg"), img8)
    return {"num_images": num_images, "image_size": list(image_size)}


def generate_megadepth_fixture(
    root,
    scenes: int = 8,
    images_per_scene: int = 12,
    points_per_scene: int = 2500,
    image_size: Tuple[int, int] = (640, 480),
    descriptor_dim: int = 256,
    descriptor_noise: float = 0.1,
    pixel_jitter: float = 0.5,
    features_dir: str = "SyntheticSphere_640_480",
    extractor_name: str = "SyntheticSphere",
    val_scenes: int = 2,
    keep_fraction_range: Tuple[float, float] = (1.0, 1.0),
    seed: int = 0,
) -> dict:
    """Write the fixture under ``root``. Returns summary stats.

    Layout (identical to the real-data contract):
      root/pairs/<scene>/sparse-txt/pairs.txt
      root/phoenix/S6/zl548/MegaDepth_v1/<scene>/dense0/depths/<im>.h5
      root/<features_dir>/config.yaml + <scene>/<im>_{lafs,scores,descriptors,size}.h5
      root/assets/megadepth_train.txt + megadepth_valid.txt
    """
    import yaml

    root = Path(root)
    rng = np.random.default_rng(seed)
    w, h = image_size
    focal = 0.9 * w
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)

    scene_names = [f"{5000 + s:04d}" for s in range(scenes)]
    stats = {"scenes": scene_names, "pairs": 0}

    for scene in scene_names:
        depth_dir = root / "phoenix/S6/zl548/MegaDepth_v1" / scene / "dense0/depths"
        pairs_dir = root / "pairs" / scene / "sparse-txt"
        feat_dir = root / features_dir / scene
        for d in (depth_dir, pairs_dir, feat_dir):
            d.mkdir(parents=True, exist_ok=True)

        sphere_c = np.array([0.0, 0.0, 8.0]) + rng.uniform(-0.5, 0.5, 3)
        sphere_r = rng.uniform(2.5, 3.2)
        plane_z = 14.0 + rng.uniform(0.0, 2.0)

        # persistent surface points: ~70% on the camera-facing half of the
        # sphere, the rest on the background plane
        n_sphere = int(0.7 * points_per_scene)
        dirs = rng.normal(size=(n_sphere, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        dirs[:, 2] = -np.abs(dirs[:, 2])  # face the cameras (looking +z)
        pts_sphere = sphere_c + sphere_r * dirs
        half_w = 0.95 * plane_z * (w / 2) / focal
        half_h = 0.95 * plane_z * (h / 2) / focal
        pts_plane = np.stack(
            [
                rng.uniform(-half_w, half_w, points_per_scene - n_sphere),
                rng.uniform(-half_h, half_h, points_per_scene - n_sphere),
                np.full(points_per_scene - n_sphere, plane_z),
            ],
            axis=1,
        )
        points = np.concatenate([pts_sphere, pts_plane], axis=0)
        base_desc = rng.normal(size=(points_per_scene, descriptor_dim)).astype(np.float32)

        names, extrinsics, visible_sets = [], [], []
        for i in range(images_per_scene):
            name = f"im{i}"
            names.append(name + ".jpg")
            # camera i: small rotation, translation around the origin
            Rw = _rot_xyz(rng.uniform(-0.12, 0.12, 3))
            t = rng.uniform(-0.8, 0.8, 3) * np.array([1.0, 1.0, 0.6])
            extrinsics.append((Rw, t))

            depth = _render_depth(K, Rw, t, image_size, sphere_c, sphere_r, plane_z)
            io.save_h5(depth_dir / f"{name}.h5", depth, key="depth", compression="gzip", compression_opts=1)

            # project the persistent points; keep in-frame, in-front and
            # unoccluded (point depth agrees with the rendered depth)
            x_cam = points @ Rw.T + t
            z = x_cam[:, 2]
            uv = (x_cam @ K.T)
            uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
            inside = (
                (z > 0.2)
                & (uv[:, 0] >= 1) & (uv[:, 0] <= w - 2)
                & (uv[:, 1] >= 1) & (uv[:, 1] <= h - 2)
            )
            ui = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
            vi = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
            unoccluded = np.abs(depth[vi, ui] - z) < 0.05 * z + 0.05
            vis = inside & unoccluded
            idx = np.flatnonzero(vis)
            # detector-count variability: keep a random per-image fraction so
            # keypoint counts span the bucket ladder (exercises
            # data.bucket_grouping in the end-to-end trainer run)
            lo, hi = keep_fraction_range
            if hi < 1.0 or lo < 1.0:
                keep = rng.uniform(lo, hi)
                idx = rng.choice(idx, size=max(8, int(keep * len(idx))), replace=False)
                idx = np.sort(idx)
            visible_sets.append(set(idx.tolist()))

            kpts = uv[idx] + pixel_jitter * rng.normal(size=(len(idx), 2))
            kpts = np.clip(kpts, 0, [w - 1, h - 1])
            lafs = np.zeros((len(idx), 2, 3), np.float32)
            lafs[:, 0, 0] = lafs[:, 1, 1] = 1.0
            lafs[:, :, 2] = kpts.astype(np.float32)
            desc = base_desc[idx] + descriptor_noise * rng.normal(
                size=(len(idx), descriptor_dim)
            ).astype(np.float32)
            desc /= np.linalg.norm(desc, axis=1, keepdims=True)
            scores = rng.uniform(0.1, 1.0, len(idx)).astype(np.float32)

            io.save_h5(feat_dir / f"{name}_lafs.h5", lafs)
            io.save_h5(feat_dir / f"{name}_scores.h5", scores)
            io.save_h5(feat_dir / f"{name}_descriptors.h5", desc.astype(np.float32))
            io.save_h5(feat_dir / f"{name}_size.h5", np.asarray([w, h], np.int64))

        # pairs.txt: reference line format (megadepth_dataset.py:90-99) with
        # the explore_megadepth overlap |A∩B| / min(|A|,|B|)
        lines = []
        for i in range(images_per_scene):
            for j in range(i + 1, images_per_scene):
                inter = len(visible_sets[i] & visible_sets[j])
                denom = max(1, min(len(visible_sets[i]), len(visible_sets[j])))
                overlap = inter / denom
                if overlap < 0.1:
                    continue
                R0, t0 = extrinsics[i]
                R1, t1 = extrinsics[j]
                R_rel = R1 @ R0.T
                T_rel = t1 - R_rel @ t0
                RT = np.eye(4)
                RT[:3, :3], RT[:3, 3] = R_rel, T_rel
                parts = (
                    [names[i], names[j], "0", "0"]
                    + [f"{x:.8f}" for x in K.flatten()]
                    + [f"{x:.8f}" for x in K.flatten()]
                    + [f"{x:.8f}" for x in RT.flatten()]
                    + [f"{overlap:.4f}"]
                )
                lines.append(" ".join(parts))
        (pairs_dir / "pairs.txt").write_text("\n".join(lines) + "\n")
        stats["pairs"] += len(lines)

    # extractor-config handshake (extract_features.py:100-104)
    (root / features_dir / "config.yaml").write_text(
        yaml.safe_dump(
            {
                "name": extractor_name,
                "descriptor_dim": descriptor_dim,
                "max_keypoints": 1024,
                "parameters": {},
            }
        )
    )
    assets = root / "assets"
    assets.mkdir(exist_ok=True)
    (assets / "megadepth_train.txt").write_text(
        "\n".join(scene_names[: scenes - val_scenes]) + "\n"
    )
    (assets / "megadepth_valid.txt").write_text(
        "\n".join(scene_names[scenes - val_scenes:]) + "\n"
    )
    return stats
