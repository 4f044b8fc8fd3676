"""Train the flagship matcher on synthetic 3D pairs on a CUDA card, then
measure how far its serving modes decode apart at the trained weights.

    python3 scripts/trained_agreement.py [--epochs 10] [--steps-per-epoch 200]
        [--attention softmax] [--calibration-batches 1,4,16]
        [--decodes FILE] [--reference-decodes FILE] [--out FILE]

Runs ``examples/train_pose_auc_synthetic_torch.py``'s ``main`` at the flagship
flags (``--stages 9 --dim 256 --kpts 1024 --bf16 --chain-bf16 --pallas
--warmup 500``, B=8, with ``--eval-int8`` for softmax) and the given
``--attention`` kind for the given epochs, after building the kernels, so
that one run prints the example's trajectory, its ``total`` and (softmax)
its int8 row. At the trained weights (kept in memory only) it serves the
example's four held-out batches through:

* ``f32 plain``: f32 compute and chain, the kernels' plain versions (the reference);
* ``bf16 plain``: the trained configuration on the plain versions (the witness);
* ``bf16``: the trained configuration on the kernels (K1 for softmax, K6
  for linear and FAVOR; K2);
* softmax only (the JAX package serves the other kinds unquantized):
  ``int8`` and ``int8_attn`` through the int8 layer kernel (K7), and the
  static modes ``int8_static K=k`` and ``int8_static_attn K=k`` for each k of
  ``--calibration-batches``: a fresh model calibrated by k successive
  ``SuperGlue.calibrate`` passes, on training batches drawn from seeds
  20,000 to 20,000 + k - 1 (the running max of every activation site
  carries across the passes); and each int8 model again on its plain
  version (``int8 plain``, ...: the witness of the kernel against its mode).

For each it prints the decode's agreement at threshold 0.2 with ``f32
plain`` and with ``bf16`` (valid rows of image 0 whose match index is the
same; a kernel run also with its own plain version, and with
``--reference-decodes`` with the ``f32 plain`` decodes another run saved
with ``--decodes``, such as the softmax run's at the same flags), the
layer kernels' launches, the matches per pair, the example's metric row and
the ms of one held-out batch's forward (CUDA events, ``profiling.device_ms``).
The last line before the card's is one JSON object with all of it, also
written to ``--out``.

The softmax run, then the O(N) kinds held against its decodes (the
decodes file must be on the machine that runs the second command):

    python3 scripts/trained_agreement.py --epochs 30 --calibration-batches 1,4,16 \
        --decodes build/softmax_decodes.pt --out softmax.json
    for kind in linear favor_relu favor_softmax; do
        python3 scripts/trained_agreement.py --epochs 10 --attention $kind \
            --reference-decodes build/softmax_decodes.pt --out $kind.json
    done
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
DYNAMIC_MODES = ("int8", "int8_attn")
STATIC_MODES = ("int8_static", "int8_static_attn")
CALIBRATION_SEED = 20_000
THRESHOLD = 0.2
DEVICE = "cuda"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps-per-epoch", type=int, default=200)
    parser.add_argument("--attention", default="softmax", choices=["softmax", "linear", "favor_relu", "favor_softmax"])
    parser.add_argument("--calibration-batches", default="1",
                        help="comma-separated counts k of calibration passes of the static int8 modes")
    parser.add_argument("--decodes", default=None, help="save the f32 plain decodes here (torch.save)")
    parser.add_argument("--reference-decodes", default=None,
                        help="hold every mode's decodes also against this file's (another run's --decodes)")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    args = parser.parse_args()
    counts = [int(k) for k in args.calibration_batches.split(",")]
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

    softmax = args.attention == "softmax"
    example = cs.load_example(REPO, "train_pose_auc_synthetic_torch")
    argv = [*cs.EXAMPLE_FLAGSHIP, *(["--eval-int8"] if softmax else []), "--attention", args.attention,
            "--device", DEVICE, "--epochs", str(args.epochs), "--steps-per-epoch", str(args.steps_per_epoch)]
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
    if softmax:
        for mode in DYNAMIC_MODES:
            model = built(quantize=mode, use_pallas=True)
            runs += [(mode, model, False), (f"{mode} plain", model, True)]
        calibration = [superglue_inputs(pairs.sample(
            torch.Generator(device=DEVICE).manual_seed(CALIBRATION_SEED + i), ex_args.batch))
            for i in range(max(counts))]
        for mode in STATIC_MODES:
            for k in counts:
                model = built(quantize=mode, use_pallas=True)
                with torch.no_grad():
                    for inputs in calibration[:k]:
                        model.calibrate(**inputs)
                runs += [(f"{mode} K={k}", model, False), (f"{mode} K={k} plain", model, True)]

    eval_step = make_eval_step(THRESHOLD)
    decoded, results = {}, {}
    layer_counters = {"K1": glk.counter, "K6": glk.feature_counter, "K7": gli8.counter}
    for name, model, plain in runs:
        with cs.plain_versions(glk, sk, gli8) if plain else contextlib.nullcontext(), torch.no_grad():
            for counter in layer_counters.values():
                counter.reset()
            decoded[name] = [decode_from_output(model(**superglue_inputs(b)), THRESHOLD, b.side0.mask,
                                                b.side1.mask)["matches0"] for b in held]
            launches = {k: c.count for k, c in layer_counters.items() if c.count}
            row = example.evaluate(create_train_state(model), held, eval_step)
            inputs = superglue_inputs(held[0])
            ms = device_ms(lambda: model(**inputs), calls=3)
        matches = sum(int((m >= 0).sum()) for m in decoded[name]) / (len(held) * ex_args.batch)
        results[name] = {"matches_per_pair": matches, "forward_ms": ms, "launches": launches, **row}

    masks = [b.side0.mask for b in held]
    if args.decodes:
        Path(args.decodes).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"argv": argv, "f32 plain": [m.cpu() for m in decoded["f32 plain"]]}, args.decodes)
    if args.reference_decodes:
        reference = torch.load(args.reference_decodes)
        decoded["reference"] = [m.to(DEVICE) for m in reference["f32 plain"]]

    def agreement(name, ref):
        same = sum(int(((a == r) & m).sum()) for a, r, m in zip(decoded[name], decoded[ref], masks))
        return same / sum(int(m.sum()) for m in masks)

    for name, result in results.items():
        result.update(agreement_vs_f32_plain=agreement(name, "f32 plain"), agreement_vs_bf16=agreement(name, "bf16"))
        own = f" (vs its plain version {agreement(name, name + ' plain'):.5f})" if name + " plain" in results else ""
        if args.reference_decodes:
            result["agreement_vs_reference"] = agreement(name, "reference")
            own += f", vs the reference decodes {result['agreement_vs_reference']:.5f}"
        print(f"{name}: agreement at {THRESHOLD} vs f32 plain {result['agreement_vs_f32_plain']:.5f}, vs bf16 "
              f"{result['agreement_vs_bf16']:.5f}{own}, {result['matches_per_pair']:.1f} matches a pair, "
              f"{example.metric_text({k: v for k, v in result.items() if '@' in k})}, launches "
              f"{result['launches']}, forward {result['forward_ms']:.3f} ms (B={ex_args.batch}) [{card}]", flush=True)
    record = {"argv": argv, "calibration_batches": counts if softmax else None,
              "reference_decodes": args.reference_decodes, "steps": steps, "main_s": main_s,
              "ms_per_step_with_evaluations": main_s / steps * 1e3, "rows": rows, "modes": results, "card": card}
    line = json.dumps(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
