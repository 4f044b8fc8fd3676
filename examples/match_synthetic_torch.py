"""End-to-end demo on synthetic data (no downloads; the PyTorch/CUDA port of
examples/match_synthetic.py).

Trains a small matcher on generated homography keypoint pairs, then decodes
matches and reports precision against the ground-truth homography.

Run: python examples/match_synthetic_torch.py [--steps 300] [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's openglue_tpu_torch

from openglue_tpu_torch.cli.online import require_device  # noqa: E402
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs  # noqa: E402
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig  # noqa: E402
from openglue_tpu_torch.train.state import create_train_state  # noqa: E402
from openglue_tpu_torch.train.step import LossConfig, make_eval_step, make_train_step  # noqa: E402


def precision_at_3px(m0, kpts0, kpts1, H):
    """(correct, total) decoded matches, numpy inputs: a match is correct
    where H maps its keypoint of image 0 within 3 px of its keypoint of
    image 1."""
    correct = total = 0
    for b in range(m0.shape[0]):
        for i, j in enumerate(m0[b]):
            if j < 0:
                continue
            p = H[b] @ np.array([*kpts0[b, i], 1.0])
            total += 1
            correct += np.linalg.norm(p[:2] / p[2] - kpts1[b, j]) < 3.0
    return correct, total


def main(argv=None):
    """Train on one batch, decode it and print the precision. Returns the
    train state."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--kpts", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = require_device(args.device)

    cfg = SuperGlueConfig(
        descriptor_dim=128, pe_hidden_layers_sizes=(32, 64), num_stages=3,
        num_heads=4, otp_num_iters=10, residual=True,
    )
    model = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(1))
    gen = SyntheticHomographyPairs(
        num_keypoints=args.kpts, descriptor_dim=128, jitter=0.5, descriptor_noise=0.05
    )
    batch = gen.sample(torch.Generator(device=device).manual_seed(0), 4)
    state = create_train_state(model, learning_rate=1e-3)

    step = make_train_step(LossConfig(positive_threshold=3.0, negative_threshold=5.0))
    losses = torch.stack([step(state, batch)["total_loss"] for _ in range(args.steps)]).cpu().numpy()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} after {args.steps} steps")

    out = make_eval_step(0.2)(state, batch)
    m0 = out["matches0"].cpu().numpy()
    kpts0 = batch.side0.keypoints.cpu().numpy()
    kpts1 = batch.side1.keypoints.cpu().numpy()
    H = batch.transformation.H.cpu().numpy()
    correct, total = precision_at_3px(m0, kpts0, kpts1, H)
    print(f"decoded {total} matches, precision@3px = {correct / max(total, 1):.3f}")
    return state


if __name__ == "__main__":
    main()
