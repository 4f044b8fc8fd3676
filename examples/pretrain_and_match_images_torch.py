"""Image-level demo (no downloads; the PyTorch/CUDA port of
examples/pretrain_and_match_images.py): generates a small synthetic image
folder, runs homography pretraining of SuperPoint+SuperGlue for a few steps,
then matches a warped pair and writes a visualization.

Run: python examples/pretrain_and_match_images_torch.py --workdir DIR [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's openglue_tpu_torch


def make_images(img_dir: Path, count=6, size=(320, 240), seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img_dir.mkdir(parents=True, exist_ok=True)
    for i in range(count):
        img = np.zeros((size[1], size[0], 3), np.uint8)
        for _ in range(60):
            x, y = int(rng.integers(10, size[0] - 10)), int(rng.integers(10, size[1] - 10))
            color = tuple(int(c) for c in rng.integers(40, 255, 3))
            if rng.random() < 0.5:
                cv2.circle(img, (x, y), int(rng.integers(3, 14)), color, -1)
            else:
                w, h = int(rng.integers(6, 25)), int(rng.integers(6, 25))
                cv2.rectangle(img, (x, y), (x + w, y + h), color, -1)
        cv2.imwrite(str(img_dir / f"img_{i}.png"), img)


def demo_config(img_dir: Path, work: Path, steps: int) -> dict:
    """The demo's config: a batch of 1 (the one card), 256x192 crops,
    SuperPoint with random weights and a 3-stage matcher."""
    return {
        "data": {
            "root_path": str(img_dir),
            "batch_size": 1,
            "dataloader_workers": 0,
            "target_size": [256, 192],
            "warp_offset": 24,
        },
        "logging": {"root_path": str(work / "logs"), "name": "demo", "train_logs_steps": 5},
        "train": {
            "epochs": 1, "steps_per_epoch": steps, "grad_clip": 10.0,
            "gt_positive_threshold": 3, "gt_negative_threshold": 3,
            "margin": None, "nll_weight": 1.0, "metric_weight": 0.0,
            "lr": 1.0e-3, "scheduler_gamma": 0.999994,
            "augmentations": {"name": "weak_color_aug"},
            "finetune_features_extractor": False,
        },
        "features": {
            "name": "SuperPointNet",
            "parameters": {"max_keypoints": 256, "descriptor_dim": 128},
            "weights": None,
        },
        "superglue": {
            "laf_to_sideinfo_method": "none",
            "positional_encoding": {"hidden_layers_sizes": [32, 64]},
            "attention_gnn": {"num_stages": 3, "num_heads": 4,
                               "attention": "softmax", "use_offset": False},
            "dustbin_score_init": 1.0,
            "otp": {"num_iters": 10, "reg": 1.0},
            "residual": True,
        },
        "inference": {"match_threshold": 0.1},
    }


def main(argv=None):
    """Pretrain, then match one warped pair; returns (the train state, the
    number of matches drawn)."""
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "openglue_tpu_torch_demo"))
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    work = Path(args.workdir)
    img_dir = work / "images"
    make_images(img_dir)

    config = demo_config(img_dir, work, args.steps)
    cfg_path = work / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))

    from openglue_tpu_torch.cli import pretrain_homography

    print(f"pretraining for {args.steps} steps ...")
    state = pretrain_homography.main(["--config", str(cfg_path), "--device", args.device])
    print(f"done at step {int(state.step)}")

    # match a fresh warped pair with the trained weights
    import torch

    from openglue_tpu_torch.cli.online import build_matching_module
    from openglue_tpu_torch.core.config import Config
    from openglue_tpu_torch.data.homography import HomographyPairsDataset
    from openglue_tpu_torch.models.matching import decode_matches
    from openglue_tpu_torch.visualization import draw_matches

    model = build_matching_module(Config(config), device=args.device).eval()
    model.load_state_dict(state.model.state_dict())
    ds = HomographyPairsDataset(
        img_dir, target_size=(256, 192), max_corner_offset=24,
        color_augmentation=False, seed=123,
    )
    sample = ds[0]
    im0 = torch.from_numpy(sample["image0"])[None].to(args.device)
    im1 = torch.from_numpy(sample["image1"])[None].to(args.device)
    with torch.no_grad():
        out, pair = model(im0, im1)
        decoded = decode_matches(out["scores"], 0.1, pair.side0.mask, pair.side1.mask)
    m0 = decoded["matches0"][0].cpu().numpy()
    idx0 = np.flatnonzero(m0 >= 0)
    k0 = pair.side0.keypoints[0].cpu().numpy()[idx0]
    k1 = pair.side1.keypoints[0].cpu().numpy()[m0[idx0]]
    conf = decoded["matching_scores0"][0].float().cpu().numpy()[idx0]
    out_path = work / "matches.png"
    draw_matches(
        (sample["image0"] * 255).astype(np.uint8),
        (sample["image1"] * 255).astype(np.uint8),
        k0, k1, conf, output_path=out_path,
    )
    print(f"{len(k0)} matches -> {out_path}")
    return state, len(k0)


if __name__ == "__main__":
    main()
