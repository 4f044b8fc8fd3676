"""Offline feature-cache builder (port of ``openglue_tpu/cli/extract_features.py``;
reference extract_features.py).

Writes per-image ``{base}_lafs/_scores/_descriptors/_size.h5`` plus a
``config.yaml`` describing the extractor into ``<output>/<Name>_<W>_<H>/`` —
the contract consumed by train_cached (reference extract_features.py:100-104,
251-271). Skip-if-exists resumability and atomic cleanup on error preserved.
Every h5 file is written through ``data.io.save_h5``.

Parallelism: the image list is split across the processes of
``torch.distributed`` by rank when a process group is initialized (a launcher
such as torchrun sets ``MASTER_ADDR``: the group is then started on gloo), and
only rank 0 writes ``config.yaml``. The device extractors (SuperPoint, the
DoG SIFT, GFTT-AffNet-HardNet) and the networks of OPENCVDoGAffNetHardNet
run on ``--device`` (default ``cuda``, which must be present when the
extractor uses it); OpenCV SIFT runs on the host alone.

Usage:
  python -m openglue_tpu_torch.cli.extract_features \\
      --features_config configs/features/superpoint_magicleap.yaml \\
      --data_dir /data/MegaDepth --output_dir /data/MegaDepth \\
      [--target_size 960 720] [--megadepth] [--limit N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from openglue_tpu_torch.core.config import load_config, save_config
from openglue_tpu_torch.data import io
from openglue_tpu_torch.features.prepare import to_device

H5_SUFFIXES = ("_lafs.h5", "_scores.h5", "_descriptors.h5", "_size.h5")
# the image files the listing takes (openglue_tpu/data/homography.py:21)
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def list_megadepth_images(data_dir: Path) -> List[Tuple[Path, Path]]:
    """[(image_path, relative_output_dir)] for the MegaDepth layout."""
    base = data_dir / "phoenix/S6/zl548/MegaDepth_v1"
    out = []
    for scene_dir in sorted(base.iterdir()) if base.exists() else []:
        imgs = scene_dir / "dense0" / "imgs"
        if imgs.exists():
            for img in sorted(imgs.iterdir()):
                out.append((img, Path(scene_dir.name)))
    return out


def list_flat_images(data_dir: Path) -> List[Tuple[Path, Path]]:
    out = []
    for img in sorted(data_dir.rglob("*")):
        if img.suffix.lower() in IMAGE_EXTENSIONS:
            out.append((img, img.parent.relative_to(data_dir)))
    return out


def outputs_exist(out_dir: Path, base: str) -> bool:
    return all((out_dir / f"{base}{sfx}").exists() for sfx in H5_SUFFIXES)


def save_outputs(out_dir: Path, base: str, lafs, scores, descriptors, size) -> None:
    """Atomic-ish: delete all four on any failure (reference :261-271)."""
    try:
        io.save_h5(out_dir / f"{base}_lafs.h5", lafs)
        io.save_h5(out_dir / f"{base}_scores.h5", scores)
        io.save_h5(out_dir / f"{base}_descriptors.h5", descriptors)
        io.save_h5(out_dir / f"{base}_size.h5", np.asarray(size))
    except Exception:
        for sfx in H5_SUFFIXES:
            (out_dir / f"{base}{sfx}").unlink(missing_ok=True)
        raise


def build_device_extractor(features_config, weights_path, device="cuda") -> torch.nn.Module:
    """The features config's device extractor on ``device`` in eval mode:
    its convolutions drawn from ``torch.Generator().manual_seed(0)``, then
    the torch checkpoint at ``weights_path`` loaded where one is given
    (``features.superpoint.load_extractor_weights``)."""
    from openglue_tpu_torch.features.nets import seeded_init_
    from openglue_tpu_torch.features.registry import get_feature_extractor
    from openglue_tpu_torch.features.superpoint import load_extractor_weights

    model = get_feature_extractor(features_config["name"])(**features_config.get("parameters", {}))
    seeded_init_(model, torch.Generator().manual_seed(0))
    if weights_path:
        load_extractor_weights(model, weights_path)
    return model.to(device).eval()


def extract_on_device(model: torch.nn.Module, image: np.ndarray, device):
    """uint8 grayscale [h, w] -> (lafs [K, 2, 3], scores [K], desc [K, D],
    mask [K]) numpy: the image in [0, 1], padded with zeros to multiples of
    8 (SuperPoint's cells), through ``model`` on ``device``; a detection in
    the padding band (x >= w or y >= h: the image-to-zeros seam fires the
    detectors) is masked out. One copy back to the host."""
    h, w = image.shape[:2]
    padded = np.zeros((-(-h // 8) * 8, -(-w // 8) * 8), np.float32)
    padded[:h, :w] = image.astype(np.float32) / 255.0
    with torch.no_grad():
        feats = model(to_device(padded[None], device))
        lafs = feats.lafs[0]
        k = lafs.shape[0]
        mask = feats.mask[0] & (lafs[:, 0, 2] < w) & (lafs[:, 1, 2] < h)
        host = torch.cat([lafs.reshape(k, 6), feats.responses[0, :, None], feats.descriptors[0],
                          mask[:, None].float()], 1).cpu().numpy()
    return host[:, :6].reshape(k, 2, 3), host[:, 6], host[:, 7:-1], host[:, -1] > 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--features_config", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--target_size", type=int, nargs=2, default=(960, 720))
    parser.add_argument("--megadepth", action="store_true", help="MegaDepth directory layout")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="where the extractor's networks run: cuda (default) or cpu")
    args = parser.parse_args(argv)

    from openglue_tpu_torch.data.sampler import process_shard
    from openglue_tpu_torch.features.registry import build_host_extractor, is_device_extractor, uses_device
    from openglue_tpu_torch.parallel.distributed import initialize

    features_config = load_config(args.features_config)
    name = features_config["name"]
    device = torch.device(args.device)
    if uses_device(name) and device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to extract on the CPU)")
    initialize(device_type="cpu")  # a no-op unless a launcher named a job
    world, rank = process_shard()
    tw, th = args.target_size
    out_root = Path(args.output_dir) / f"{name}_{tw}_{th}"
    if rank == 0:
        out_root.mkdir(parents=True, exist_ok=True)
        cfg = features_config.copy()
        cfg["parameters"] = dict(cfg.get("parameters", {}))
        save_config(cfg, out_root / "config.yaml")

    data_dir = Path(args.data_dir)
    images = list_megadepth_images(data_dir) if args.megadepth else list_flat_images(data_dir)
    # per-process shard (replaces reference multiprocessing chunking, :108-118)
    images = images[rank::world]
    if args.limit:
        images = images[: args.limit]

    device_mode = is_device_extractor(name)
    if device_mode:
        model = build_device_extractor(features_config, features_config.get("weights"), device)
    else:
        extractor = build_host_extractor(features_config, device)

    import cv2

    done = skipped = 0
    for img_path, rel_dir in images:
        out_dir = out_root / rel_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        base = img_path.stem
        if outputs_exist(out_dir, base):
            skipped += 1
            continue

        image = cv2.imread(str(img_path))
        if image is None:
            print(f"skipping unreadable {img_path}", flush=True)
            continue
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        resized = io.aspect_preserving_resize(gray, (tw, th))
        h, w = resized.shape[:2]

        if device_mode:
            lafs, scores, desc, mask = extract_on_device(model, resized, device)
        else:
            lafs, scores, desc, mask = extractor.detect_and_compute(resized)
        lafs, scores, desc = lafs[mask], scores[mask], desc[mask]

        save_outputs(out_dir, base, lafs, scores, desc, (w, h))
        done += 1
        if done % 100 == 0:
            print(f"[rank {rank}] {done} done / {skipped} skipped", flush=True)

    print(f"[rank {rank}] finished: {done} done / {skipped} skipped", flush=True)


if __name__ == "__main__":
    main()
