"""Train the flagship matcher on synthetic 3D pairs on a CUDA card, then
measure how far its serving modes decode apart at the trained weights.

    python3 scripts/trained_agreement.py [--epochs 10] [--steps-per-epoch 200] [--out FILE]

Runs ``examples/train_pose_auc_synthetic_torch.py``'s ``main`` at the flagship
flags (``--stages 9 --dim 256 --kpts 1024 --bf16 --chain-bf16 --pallas
--warmup 500 --eval-int8``, B=8) for the given epochs, after building the
kernels, so that one run prints the example's trajectory, its ``total`` and
its int8 row. At the trained weights (kept in memory only) it serves the
example's four held-out batches through:

* ``f32 plain``: f32 compute and chain, the kernels' plain versions (the reference);
* ``bf16 plain``: the trained configuration on the plain versions (the witness);
* ``bf16``: the trained configuration on the kernels (K1, K2);
* ``int8``, ``int8_static``, ``int8_attn``, ``int8_static_attn``: the int8
  layer kernel (K7) in each mode, the static ones calibrated on one training
  batch of a seed of their own; and each mode again on its plain version
  (``int8 plain``, ...: the witness of the kernel against its mode).

For each it prints the decode's agreement at threshold 0.2 with ``f32
plain`` and with ``bf16`` (valid rows of image 0 whose match index is the
same; a kernel run also with its own plain version), the matches per pair, the example's metric row and the ms of one
held-out batch's forward (CUDA events, ``profiling.device_ms``). The last
line before the card's is one JSON object with all of it, also written to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
INT8_MODES = ("int8", "int8_static", "int8_attn", "int8_static_attn")
CALIBRATION_SEED = 20_000
THRESHOLD = 0.2
DEVICE = "cuda"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps-per-epoch", type=int, default=200)
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trained_agreement: no CUDA card is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops import kernels
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.profiling import device_ms
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_eval_step, superglue_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    start = time.perf_counter()
    kernels.build_all()
    print(f"build {time.perf_counter() - start:.1f} s", flush=True)

    example = cs.load_example(REPO, "train_pose_auc_synthetic_torch")
    argv = [*cs.EXAMPLE_FLAGSHIP, "--eval-int8", "--device", DEVICE, "--epochs", str(args.epochs),
            "--steps-per-epoch", str(args.steps_per_epoch)]
    print(f"python examples/train_pose_auc_synthetic_torch.py {' '.join(argv)}", flush=True)
    start = time.perf_counter()
    state, rows = example.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - start
    steps = args.epochs * args.steps_per_epoch
    ex_args = example.parse_args(argv)
    pairs = example.pair_generator(ex_args)
    held = example.held_out_batches(pairs, ex_args.batch, DEVICE)
    trained = state.model.eval()
    weights = trained.state_dict()
    cfg = trained.config

    def built(**changes):
        model = SuperGlue(dataclasses.replace(cfg, **changes), device=DEVICE).eval()
        model.load_state_dict(weights, strict=False)
        return model

    runs = [("f32 plain", built(dtype=None, chain_dtype=None), True), ("bf16 plain", trained, True),
            ("bf16", trained, False)]
    calibration = superglue_inputs(pairs.sample(torch.Generator(device=DEVICE).manual_seed(CALIBRATION_SEED),
                                                ex_args.batch))
    for mode in INT8_MODES:
        model = built(quantize=mode, use_pallas=True)
        if mode.startswith("int8_static"):
            with torch.no_grad():
                model.calibrate(**calibration)
        runs += [(mode, model, False), (f"{mode} plain", model, True)]

    eval_step = make_eval_step(THRESHOLD)
    decoded, results = {}, {}
    for name, model, plain in runs:
        with cs.plain_versions(glk, sk, gli8) if plain else contextlib.nullcontext(), torch.no_grad():
            decoded[name] = [decode_from_output(model(**superglue_inputs(b)), THRESHOLD, b.side0.mask,
                                                b.side1.mask)["matches0"] for b in held]
            row = example.evaluate(create_train_state(model), held, eval_step)
            inputs = superglue_inputs(held[0])
            ms = device_ms(lambda: model(**inputs), calls=3)
        matches = sum(int((m >= 0).sum()) for m in decoded[name]) / (len(held) * ex_args.batch)
        results[name] = {"matches_per_pair": matches, "forward_ms": ms, **row}

    masks = [b.side0.mask for b in held]

    def agreement(name, ref):
        same = sum(int(((a == r) & m).sum()) for a, r, m in zip(decoded[name], decoded[ref], masks))
        return same / sum(int(m.sum()) for m in masks)

    for name, result in results.items():
        result.update(agreement_vs_f32_plain=agreement(name, "f32 plain"), agreement_vs_bf16=agreement(name, "bf16"))
        own = f" (vs its plain version {agreement(name, name + ' plain'):.5f})" if name + " plain" in results else ""
        print(f"{name}: agreement at {THRESHOLD} vs f32 plain {result['agreement_vs_f32_plain']:.5f}, vs bf16 "
              f"{result['agreement_vs_bf16']:.5f}{own}, {result['matches_per_pair']:.1f} matches a pair, "
              f"{example.metric_text({k: v for k, v in result.items() if '@' in k})}, forward "
              f"{result['forward_ms']:.3f} ms (B={ex_args.batch}) [{card}]", flush=True)
    record = {"argv": argv, "steps": steps, "main_s": main_s, "ms_per_step_with_evaluations": main_s / steps * 1e3,
              "rows": rows, "modes": results, "card": card}
    line = json.dumps(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
