"""Run ``chip_smoke.py``'s cached-trainer phases alone on a CUDA card.

    python3 scripts/trainer_phases.py --repo DIR [trainer] [twin] [dp] [checkify] [cp] [examples] [cp_f64]

Imports ``openglue_tpu_torch`` and ``chip_smoke.py`` from the checkout DIR,
builds the kernels, and runs the named phases in order (all six when none
is named): ``trainer_phase`` (the flagship config as written, its device
descriptor cache included), ``cache_twin_phase`` (host mode against the
cache on the same rows), ``data_parallel_phase`` (world 2 over gloo on the
one card), ``checkify_phase`` (``--checkify`` in a child process) and
``context_parallel_phase`` (two ranks over gloo on the one card with a
model axis of 2: the ring, the all-gather route, the O(N) kinds, remat, the
metric loss, tensor parallelism and the BatchNorm extractor at data axis 2;
the flagship's weights drawn as ``chip_smoke.py`` draws them) and
``examples_phase`` (the three examples; the pose-AUC one at the flagship
flags with its launches counted). ``cp_f64``, run only when named, is
``cp`` with the BatchNorm step's f64 witness: rank 0 holds the world-2 and
world-1 steps against the world-1 step in f64, free and on each step's own
keypoints and ReLU gates (about 40 s more). They share
one in-memory h5 store and one temporary directory; a phase that fails
prints its traceback and the next one runs. The last line lists the phases
that failed.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

PHASES = ("trainer", "twin", "dp", "checkify", "cp", "examples")


def flagship_weights(cs):
    """The flagship matcher's weights as ``chip_smoke.main`` draws them."""
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.models.superglue import SuperGlue

    cfg = superglue_config_from({"superglue": cs.SUPERGLUE_SECTION}, cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)
    return SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).state_dict()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("phases", nargs="*", choices=PHASES + ("cp_f64",), help="default: all six")
    args = parser.parse_args()
    phases = args.phases or list(PHASES)
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import chip_smoke as cs
    from openglue_tpu_torch.data import fixture, io
    from openglue_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    start = time.perf_counter()
    kernels.build_all()
    print(f"build {time.perf_counter() - start:.1f} s", flush=True)
    store, work = cs.MemoryH5(), Path(tempfile.mkdtemp(prefix="trainer-phases-"))
    run = {"trainer": lambda: cs.trainer_phase(card, repo, store, work),
           "twin": lambda: cs.cache_twin_phase(card, repo, store, work),
           "dp": lambda: cs.data_parallel_phase(card, repo, store, work),
           "checkify": lambda: cs.checkify_phase(card, repo, store, work),
           "cp": lambda: cs.context_parallel_phase(card, repo, work, flagship_weights(cs),
                                                   torch.Generator(device="cuda").manual_seed(0)),
           "cp_f64": lambda: cs.context_parallel_phase(card, repo, work, flagship_weights(cs),
                                                       torch.Generator(device="cuda").manual_seed(0),
                                                       f64_witness=True),
           "examples": lambda: cs.examples_phase(card, repo, work)}
    failed = []
    try:
        for name in phases:
            start = time.perf_counter()
            try:
                if name == "twin" and not store.files:  # the trainer phase's fixture
                    with cs.replaced(*store.entries(io)):
                        fixture.generate_megadepth_fixture(work / "megadepth", **cs.TRAINER_FIXTURE)
                run[name]()
                print(f"phase {name} ok, {time.perf_counter() - start:.1f} s", flush=True)
            except Exception:
                traceback.print_exc()
                print(f"phase {name} FAILED, {time.perf_counter() - start:.1f} s", flush=True)
                failed.append(name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
