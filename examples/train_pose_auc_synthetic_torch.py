"""Train a matcher on synthetic 3D two-view pairs and watch pose AUC rise
(the PyTorch/CUDA port of examples/train_pose_auc_synthetic.py).

Fresh training batches are generated on the device at every step (no host
IO in the loop, and no host round trip but the loss printed at each
evaluation); evaluation decodes matches and runs RANSAC pose recovery on
held-out pairs: the MegaDepth headline metrics without any dataset on disk.
With ``--pallas`` a training step runs the message kernels (K4, K5) in every
GNN layer, the Sinkhorn forward (K2) and its adjoint (K3); an evaluation
batch runs the eval layer kernel (K1) and K2, and ``--eval-int8`` serves the
same weights through the int8 layer kernel (K7).

Run: python examples/train_pose_auc_synthetic_torch.py [--epochs 30] [--device cpu]
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's openglue_tpu_torch

from openglue_tpu_torch.cli.online import require_device  # noqa: E402
from openglue_tpu_torch.data.synthetic import SyntheticReprojectionPairs  # noqa: E402
from openglue_tpu_torch.metrics import CameraPoseAUC, EpipolarDistanceMetric  # noqa: E402
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig  # noqa: E402
from openglue_tpu_torch.train.state import create_train_state, make_warmup_optimizer  # noqa: E402
from openglue_tpu_torch.train.step import (  # noqa: E402
    LossConfig,
    make_eval_step,
    make_train_step,
    redraw_favor_projections,
    step_generator,
)

HELD_OUT_SEED, HELD_OUT_BATCHES = 10_000, 4
REDRAW_SEED = 777


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--steps-per-epoch", type=int, default=200)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--kpts", type=int, default=256)
    parser.add_argument("--dim", type=int, default=128, help="descriptor dim (256 = flagship)")
    parser.add_argument("--stages", type=int, default=4, help="GNN stages (9 = flagship)")
    parser.add_argument("--otp-iters", type=int, default=15)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument(
        "--warmup", type=int, default=0,
        help="linear LR warmup steps (deep stacks: the 9-stage GNN's init "
        "gradient norm is ~150x the 4-stage one; warmup walks it off the "
        "uniform-assignment saddle before full-size steps)",
    )
    parser.add_argument(
        "--attention", default="softmax",
        choices=["softmax", "linear", "favor_relu", "favor_softmax"],
        help="attention mechanism (the paper's accuracy-vs-speed study axis)",
    )
    parser.add_argument(
        "--favor-features", type=int, default=None,
        help="FAVOR random-feature count F (default 2*head_dim; the paper's "
        "variance-vs-cost knob: more features = a closer softmax estimate)",
    )
    parser.add_argument(
        "--redraw-epochs", type=int, default=1,
        help="re-sample FAVOR projections every N epochs (reference redraws "
        "via a Lightning callback, lightning_callbacks.py:10-14); 0 = never",
    )
    parser.add_argument(
        "--redraw-anneal-epochs", type=int, default=0,
        help="stop redrawing FAVOR projections after this epoch (a late "
        "redraw perturbs the converged attention estimate); 0 = no annealing",
    )
    parser.add_argument("--seed", type=int, default=1, help="init/data seed")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument(
        "--chain-bf16", action="store_true",
        help="carry the GNN residual chain in bf16 (halves layer memory traffic)",
    )
    parser.add_argument("--pallas", action="store_true", help="the hand-written CUDA kernels")
    parser.add_argument(
        "--eval-int8", action="store_true",
        help="after training, evaluate the SAME weights through the int8 "
        "serving path and print both metric rows (the quantization quality "
        "guard for the int8 inference kernel)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def pair_generator(args) -> SyntheticReprojectionPairs:
    return SyntheticReprojectionPairs(
        num_keypoints=args.kpts, descriptor_dim=args.dim, jitter=1.0, descriptor_noise=0.3,
    )


def model_config(args) -> SuperGlueConfig:
    pe_sizes = (32, 64, 128) if args.dim >= 256 else (32, 64)
    return SuperGlueConfig(
        descriptor_dim=args.dim, pe_hidden_layers_sizes=pe_sizes,
        num_stages=args.stages, num_heads=4, otp_num_iters=args.otp_iters,
        attention=args.attention,
        favor_num_features=args.favor_features,
        residual=True, dtype=torch.bfloat16 if args.bf16 else None,
        chain_dtype=torch.bfloat16 if args.chain_bf16 else None,
        use_pallas=args.pallas,
    )


def held_out_batches(pairs: SyntheticReprojectionPairs, batch: int, device):
    """The evaluation's pairs: HELD_OUT_BATCHES batches, each from a
    generator of its own on ``device``."""
    return [pairs.sample(torch.Generator(device=device).manual_seed(HELD_OUT_SEED + i), batch)
            for i in range(HELD_OUT_BATCHES)]


def evaluate(state, held_out, step_fn):
    """Pose AUC and epipolar precision of ``step_fn``'s decoded matches on
    the held-out batches, as one dict."""
    auc = CameraPoseAUC()
    epi = EpipolarDistanceMetric()
    for batch in held_out:
        out = step_fn(state, batch)
        tf = batch.transformation
        k0, k1, m0 = batch.side0.keypoints, batch.side1.keypoints, out["matches0"]
        auc.update(*(t.cpu().numpy() for t in (k0, k1, m0, tf.K0, tf.K1, tf.R, tf.T)))
        epi.update(k0, k1, m0, tf.K0, tf.K1, tf.R, tf.T)
    return {**auc.compute(), **epi.compute()}


def metric_text(res) -> str:
    return " ".join(f"{k}={v:.3f}" for k, v in res.items())


def main(argv=None):
    """Train, evaluate every 5 epochs (and after the first and the last),
    and with ``--eval-int8`` evaluate the int8 serving path. Returns the
    final train state and the metric rows, one dict per printed line."""
    args = parse_args(argv)
    device = require_device(args.device)
    pairs = pair_generator(args)
    cfg = model_config(args)
    model = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(args.seed))
    optimizer = None
    if args.warmup:
        optimizer = make_warmup_optimizer(model.parameters(), args.lr, warmup_steps=args.warmup)
    state = create_train_state(model, learning_rate=args.lr, optimizer=optimizer)
    step = make_train_step(LossConfig(positive_threshold=3.0, negative_threshold=7.0))
    eval_step = make_eval_step(0.2)
    held_out = held_out_batches(pairs, args.batch, device)

    rows = []
    t0 = time.time()
    for epoch in range(args.epochs):
        if (
            args.redraw_epochs
            and args.attention.startswith("favor")
            and epoch
            and epoch % args.redraw_epochs == 0
            and not (args.redraw_anneal_epochs and epoch > args.redraw_anneal_epochs)
        ):
            state = redraw_favor_projections(state, torch.Generator(device=device).manual_seed(REDRAW_SEED))
        for i in range(args.steps_per_epoch):
            generator = step_generator(42 + args.seed, epoch * args.steps_per_epoch + i, device)
            metrics = step(state, pairs.sample(generator, args.batch))
        if epoch % 5 == 4 or epoch in (0, args.epochs - 1):
            res = evaluate(state, held_out, eval_step)
            loss = float(metrics["total_loss"])
            rows.append({"epoch": epoch, "step": (epoch + 1) * args.steps_per_epoch, "loss": loss, **res})
            print(
                f"epoch {epoch} (step {(epoch + 1) * args.steps_per_epoch}): "
                f"loss {loss:.3f} " + metric_text(res),
                flush=True,
            )
    print(f"total {time.time() - t0:.0f}s")

    if args.eval_int8:
        model_q = SuperGlue(dataclasses.replace(cfg, quantize="int8", use_pallas=True), device=device)
        model_q.load_state_dict(state.model.state_dict())
        res = evaluate(create_train_state(model_q), held_out, make_eval_step(0.2))
        rows.append({"int8": True, **res})
        print("int8 serving path: " + metric_text(res), flush=True)
    return state, rows


if __name__ == "__main__":
    main()
