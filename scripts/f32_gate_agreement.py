"""How far each training route's small f32 step lies from exact arithmetic
on its own ReLU gates, on a CUDA card.

    python3 scripts/f32_gate_agreement.py --repo DIR [--small-f32 FILE] [--seeds 100-107]

Imports ``openglue_tpu_torch`` and ``chip_smoke.py``'s config and helpers
from the checkout DIR. For each batch it runs the f32 training step that
``chip_smoke.py`` holds (B=2 N=256, ``chain_dtype`` None, the weights of
seed 1) on the ``composed``, ``half`` and ``message`` routes, each against
an f64 step through the composed path made to take the f32 step's ReLU
gates (``chip_smoke.hold_f32_step_against_exact``), and prints the loss
difference, the relative gradient-norm difference, the gradient cosine, the
BatchNorm statistics' difference and how many gates f64 would have taken
otherwise. Beside them it prints the ``half`` step against the ``message``
step, the hold that ``chip_smoke.py``'s routes phase made before. The
batches: the one saved in FILE by ``scripts/half_route_agreement.py
--small-f32`` (when given), then one seeded B=2 N=256 batch of synthetic
pairs for each seed. The last line holds the largest reading of each route
over the batches.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def seeds_of(text: str):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True)
    parser.add_argument("--small-f32", type=Path, default=None)
    parser.add_argument("--seeds", default="100-107")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_gate_agreement: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.repo.resolve()))
    import chip_smoke as cs
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops import kernels
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    print(f"card: {cs.card_line()}", flush=True)
    config = {"superglue": cs.SUPERGLUE_SECTION, "train": cs.TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))
    cfg = superglue_config_from({"superglue": dict(cs.SUPERGLUE_SECTION, chain_dtype=None)},
                                cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)
    unbarred = dict(loss_tol=float("inf"), norm_tol=float("inf"), cos_min=-1.0, stats_tol=float("inf"))

    def fresh(route):
        model = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(1), train_route=route)
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    batches = []
    if args.small_f32 is not None:
        batches.append((str(args.small_f32), torch.load(args.small_f32, map_location="cuda", weights_only=False)))
    for seed in seeds_of(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        batches.append((f"seed {seed}", cs.make_request(SyntheticHomographyPairs, gen, 2, 256,
                                                        [256, 180], [200, 256])))
    worst = {}
    for label, batch in batches:
        for route in ("composed", "half", "message"):
            got = cs.hold_f32_step_against_exact(fresh(route), batch, step, config, glk,
                                                 f"[{label}] route={route} vs f64 on its gates", **unbarred)
            most = worst.setdefault(route, dict(got))
            for key, value in got.items():
                most[key] = min(most[key], value) if key == "grad_cosine" else max(most[key], value)
        half, message = fresh("half"), fresh("message")
        cs.compare_steps(half.model, message.model, step(half, batch), step(message, batch),
                         f"[{label}] route=half vs route=message", **unbarred)
    print("largest over the batches: " + "; ".join(
        f"{route} " + ", ".join(f"{k} {v:.12f}" if k == "grad_cosine" else f"{k} {v:.3e}" for k, v in most.items())
        for route, most in worst.items()),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
