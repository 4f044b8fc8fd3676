#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openglue_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on a mismatch (the script then exits non-zero):

1. card: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port (one nvcc each, in parallel);
3. kernels: each kernel at the shapes its path gives it, held against its
   plain PyTorch version on the card, with its time, the plain version's time
   and its bound: the eval layer (K1) and the Sinkhorn forward (K2) at the
   serving shapes, and K1's attention core alone at B=16 on K1's operand
   layout beside ``scaled_dot_product_attention`` with the same mask; the
   Sinkhorn adjoint (K3) (K2 and K3 each after a line with the launch plan
   the C code made, held against its Python mirror and against the SMs it
   must fill, and run twice, bit for bit) and the message forward and
   backward (K4, K5; bf16 and f32) at the training shape B=12, N=1024; the
   feature-kind layer (K6: linear, FAVOR-relu, FAVOR-softmax; bf16 and f32)
   and the int8 layer (K7: its four modes, each with its launches per
   layer against its C plan and the plan's mirror, its GEMM and attention
   shares and ``torch._int_mm`` on its six s8 products) at B=16, N=1024; the train-mode
   layer half (K8; bf16 and f32, with and without use_offset) and the
   attention forward and backward on heads (K9, K10; bf16 and f32, a ragged
   mask with one fully masked element, two runs of K10 compared bit for bit,
   the bf16 backward's two wgmma passes counted per call, and K10 bf16 again
   at N=1000, M=777 with and without the LSE's cotangent)
   at B=12, N=1024, K9 and K10 also at B=4, N=2048, with the time of
   ``scaled_dot_product_attention`` on the same inputs beside them; the
   wide Sinkhorn forward (K2s) past the fused kernel's columns, one launch
   per call (bf16 K at B=1 and B=4 N=4352 and B=1 N=8192, past the card's
   shared memory, and f32 K at B=1 N=2048, past its 1536 fused columns;
   each after its plan line, held against the Python mirror, and run twice,
   bit for bit); every kernel that attends (K1, K4-K11) again at heads of
   width 32 (D=128, 4 heads); and the dense GEMMs inside the layer kernels
   alone (gemm_f32 at every shape of a ``message`` step and of the
   pretraining fixture's width, tn_gemm_f32 at their weight gradients, each
   beside one PyTorch call for the same function; the bf16 GEMM at K1's five
   shapes beside ``F.linear`` in bf16), every kernel, plain version and
   library call timed by its device time (``device_ms``). f32 work
   is bounded at 495/3 TFLOP/s, the rate of f32-accurate 3xTF32 products,
   with the f32 FMA bound beside it;
4. serving: the flagship config (the ``superglue:`` section of
   configs/config_cached_sp_magicleap.yaml: D=256, 9 stages, 4 heads, bf16
   chain, 20 Sinkhorn iterations, use_pallas) with seeded random weights,
   serving single-pair requests, a B=16 batch at N=1024 and a B=4 batch at
   N=2048 through ``SuperGlue.forward`` + ``decode_from_output``. It checks
   the kernel launch counts (per forward 36 layer kernels, one Sinkhorn, and
   inside the layers 180 bf16 GEMMs and 36 bf16 attentions, which the C code
   counts where it launches them) and holds every request against the same model
   run through the kernels' plain versions; a small f32 input is also held
   against the independent composed path (use_pallas=False);
   Then the matcher's other serving configurations at the same width and
   depth: attention linear (B=16 N=1024 and B=4 N=2048), favor_relu and
   favor_softmax (B=16 N=1024), each held against its plain path at the
   softmax phases' bars; quantize int8_static_attn (calibrated on its first
   request) and int8 at B=16 and B=1, N=1024, each held against the int8
   plain path and against the bf16 kernel path, the readings printed; the
   matcher at the SIFT shape (D=128, 4 heads of width 32, B=4 N=2048) and one
   flagship pair of 4352 keypoints (its Sinkhorn on K2s), each held against
   its plain path at the same bars;
5. training: ``make_train_step`` of the same model with the optimizer and
   loss of the config's ``train:`` section, on synthetic homography pairs at
   the config's batch (B=12, N=1024, valid counts in [512, 1024]): one step
   held against the same step through the plain versions, 2 warm-up and 5
   timed steps with the launch counts checked per step, a profile, and a
   small f32 step held against the composed path in f64 made to take the f32
   step's ReLU gates (``hold_f32_step_against_exact``); the f32 GEMMs that K4 and
   K5 launch are counted too, by the C code where it launches them (272
   gemm_f32 and 34 tn_gemm_f32 per step), and so are the bf16 attention
   backward's passes (two per bf16 K5 launch: 4 per step). Then the same step on the
   model's two other training routes, ``train_route="composed"`` (K9, K10)
   and ``"half"`` (K8, K5): one step held against the plain versions, timed
   steps with the launch counts checked, a profile, and a small f32 step held
   as the message route's is; and one ``"message"`` step with
   ``remat=True`` held against the step without it, with both peak memories;
   then one step of examples/pretrain_e2e_fixture.yaml as written (bf16
   compute and chain, SIFT D=128 with heads of width 32, B=2 N=2048, 9
   stages), whose Sinkhorn backward takes the autograd route past the adjoint
   kernel's columns and whose 36 bf16 K5 launch 72 bf16 attention backward
   passes: the same step in f32 compute held against its plain
   step, the bf16 step's distance from the plain f32 step held to the plain
   bf16 step's, and timed. Every training phase prints its device busy time
   (kernel rows of the profile only);
6. the cached-feature trainer (``trainer_phase``): ``cli.train_cached.main``
   as a user runs it, with configs/config_cached_sp_magicleap.yaml (B=12,
   max 1024 keypoints, buckets 256/512/1024 grouped, 4 loader threads, the
   device-resident descriptor cache of 512 slots of 2048 rows as the config
   writes it: its hits, misses and copied bytes) and
   an override, on the MegaDepth-format fixture at
   examples/train_e2e_fixture.yaml's generator arguments, its h5 files held
   in memory (the card machine has no h5py): the warm-up at every bucket,
   80 steps with the launches of every step checked (36 K4 + 36 K5 + 1 K2 +
   1 K3, no autograd-route Sinkhorn backward), a validation sweep (36 K1 + 1
   K2 per batch), a checkpoint; the step's time, the device's busy time and
   idle share, the loader's wait, the batches per bucket; the first step of
   each bucket from a copy of the state, kernels against plain (the run's
   bf16 chain by its distance from the plain f32 step, an f32 chain at the
   training bars); a restore that resumes bit for bit, and a resume through
   ``--checkpoint``; then the cache against host mode (``cache_twin_phase``):
   the trainer from the same seeded weights on the same rows, 4 steps with
   the cache and 4 with the descriptors in every batch, the descriptors, the
   losses, the gradient norms and the parameters after each step bit for
   bit, each mode's bytes to the card per step, loader wait and step time;
   then data parallelism (``data_parallel_phase``): the
   same trainer at world 2, two processes on the card in a gloo group (NCCL
   refuses two ranks on one device; what it says is printed), each with 6 of
   the 12 rows of every global batch and a cache of its own, 4 steps and a
   validation sweep, again in host mode on the same rows (bit for bit), and
   in host mode with an f32 chain: the
   launches of every step and eval batch, both ranks' parameters equal bit
   for bit after every step, each step's loss and gradient norm and the final
   state against the same global batches at world 1, at the B=12 training
   bars; each rank's step time, the gradient all-reduce's host time and the
   idle share of one step; then ``cli.train_cached --checkify``
   (``checkify_phase``, a process of its own under ``timeout``): 2 checked
   steps with the unchecked step's launches and, from the same state on the
   same batch, its losses and gradient norms; a NaN in one valid descriptor
   row raising at the first aten op that computed a NaN, and one in K4's
   input raising under K4's name;
7. the serving and evaluation entry points (``serving_cli_phase``) at the
   SIFT serving shape (configs/features/sift_opencv.yaml: D=128, up to 2048
   keypoints, the CLI's 960x720 target) with the flagship matcher section:
   ``cli.extract_features.main`` over fixture images and warped copies,
   ``cli.inference`` (``initialize_matcher`` -> ``precompile`` ->
   ``run_inference`` per pair: each stage's host time, the bucket, 36 K1 + 1
   K2, the host synchronizations, the forward against the plain versions;
   the matches after MAGSAC against the known homography; ``main`` with its
   files; a request in the 512 bucket; an ``int8_static`` matcher through
   K7), and ``cli.evaluate.main`` on the trainer phase's experiment, its
   metrics against those of fit's validation;
8. the device extractors (``device_extractors_phase``), with seeded random
   weights: ``cli.extract_features.main`` with
   configs/features/superpoint_magicleap.yaml (SuperPoint D=256, up to 2048
   keypoints, the 960x720 target: 960x768 images) over the serving phase's
   images; a SuperPoint experiment served (``initialize_matcher`` ->
   ``precompile`` -> ``run_inference`` per pair: the stages, the extraction's
   device time, the bucket, 36 K1 + 1 K2, the host synchronizations, each
   forward against its plain path); the device DoG SIFT, GFTT-AffNet-HardNet,
   DoG(OpenCV)-AffNet-HardNet and SuperPoint with BatchNorms (COCO config)
   served once each; every extractor on the card against its CPU run with
   the same weights (``features/agreement.py``'s bars); the device SIFT
   pairs' matches after MAGSAC against the known homography;
9. the online trainer (``online_trainer_phase``), with seeded random
   weights: ``cli.pretrain_homography.main`` with
   configs/homography_pretraining.yaml as written (B=12, 960x720, warp offset
   256, frozen SuperPoint up to 1024 keypoints D=256, the 9-stage matcher,
   weak_color_aug) on fixture images, with use_pallas, a few steps and a
   validation of two batches: 36 K4 + 36 K5 + 1 K2 + 1 K3 per step and 36
   K1 + 1 K2 per eval batch, the frozen extractor unchanged bit for bit, the
   first step held against its plain versions at the training bars, the
   augmentation on the card against its CPU run, the step's time, busy time,
   idle share, extraction time, host synchronizations, loader wait and peak
   memory; ``cli.train.main`` with configs/config.yaml (B=6, 960x720) and
   the online SuperPoint features config on the MegaDepth layout (the
   fixture's depths in memory, images written beside them), a few steps and
   a validation batch; and ``initialize_matcher`` serving the pretraining
   experiment with the extractor its checkpoint holds (36 K1 + 1 K2, held
   against the plain path);
10. keypoint-axis context parallelism (``ring_axis``): the ring's block
   attention with the LSE (K11) at B=12 N=1024 and B=4 N=2048, bf16 and f32,
   against its plain version with the library call's time beside it; the
   block merge of the ring (K11 on 4 key blocks of a B=12 N=1024 request,
   ``ring.merge_block``) against K9 and K10 on the whole key set, which runs
   K10 with a non-zero LSE cotangent; then, in a one-rank NCCL process group
   (the script drives one card), ``SuperGlue(..., mesh=make_mesh({"model": 1}))``
   with ``ring_axis`` serving the B=16 N=1024 and B=4 N=2048 requests through
   ``shard_pair_batch_cp``, the forward and the sharded decode (36 K11 and no
   K1, K2 per forward), held against the same weights on the composed path
   without ``ring_axis``, and a ring training step held against the same step
   on ``train_route="composed"``, then timed with 36 K11 + 36 K10 per step.
   The process group is destroyed before the last lines;
11. context and tensor parallelism across two ranks (``context_parallel``):
   what gloo does with CUDA tensors on two ranks of card 0 (its point-to-point
   exchange fails, its all-gather and all-reduce work, so the ring's
   exchange is staged through pinned host buffers), then two processes on
   card 0 in a gloo group with a model axis of 2, each holding half the
   keypoints of the flagship's requests (f32 chain, use_pallas): the ring
   serving B=16 N=1024 (72 K11 per forward per rank, its first two-rank
   rotations on a card) and stepping B=12 N=1024 (72 K11 + 72 K10), the
   all-gather route (36 K9; 36 K9 + 36 K10), the linear and FAVOR kinds
   (their KV aggregates all-reduced; no kernel), the ring with remat (144
   K11 + 72 K10) and with the metric loss, the tensor-parallel forward (2
   heads and half the FFN a rank: 36 K9 + 1 K2), and one online step
   fine-tuning SuperPoint's BatchNorms at data axis 2 (36 K4 + 36 K5 + 1 K2
   + 1 K3), each run's launches counted from 0 and held, its bytes through
   each collective and its host time printed, each held against the same
   model at world 1 on the card (serving at the bars above, steps at the
   data-parallel phase's f32 bars) and the ranks' parameters equal bit for
   bit after every step;
12. the examples (``examples_phase``, after the online trainer):
   examples/match_synthetic_torch.py and
   examples/pretrain_and_match_images_torch.py at their defaults (no kernel
   launch), and examples/train_pose_auc_synthetic_torch.py at the flagship
   flags (D=256, 9 stages, N=1024, B=8, bf16 compute and chain, warm-up 500)
   for 20 steps with ``--eval-int8``: 36 K4 + 36 K5 + 1 K2 + 1 K3 per step,
   36 K1 + 1 K2 per held-out batch, 36 K7 + 1 K2 per int8 batch; at the
   trained weights each K1 and K7 launch of a held-out batch against its
   plain version on the same inputs (in bf16 ulps) and each held-out
   forward against the plain path, within twice the plain path's own
   distance when its descriptors move by 1e-6; a step's time, device busy
   time and host synchronizations, and an eval forward timed by
   ``profiling.device_timeit``.

Every device time is taken by ``openglue_tpu_torch/profiling.py``
(``device_ms``, ``device_profile``), which this script re-exports for
scripts/*.py. The line before the last is the card's ``nvidia-smi`` name and power limit,
the line before that the JSON ``kernels`` record, and the last line the JSON
device record. f32 matmuls run in full f32 (TF32 off) on every plain path.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# the timing helpers live in the port; scripts/*.py read them here (``cs.device_ms``)
from openglue_tpu_torch.profiling import device_ms, device_profile, host_profile, kernel_rows  # noqa: F401

# the superglue: section of configs/config_cached_sp_magicleap.yaml (a CPU
# test holds this copy to the YAML)
SUPERGLUE_SECTION = {
    "laf_to_sideinfo_method": "none",
    "positional_encoding": {"hidden_layers_sizes": [32, 64, 128]},
    "attention_gnn": {
        "num_stages": 9, "num_heads": 4, "attention": "softmax", "use_offset": False,
    },
    "dustbin_score_init": 1.0,
    "otp": {"num_iters": 20, "reg": 1.0},
    "residual": True,
    "use_pallas": True,
    "chain_dtype": "bfloat16",
}
# the train: section of the same file, and its data: batch shape (a CPU test
# holds these to the YAML)
TRAIN_SECTION = {
    "epochs": 100, "steps_per_epoch": 10000, "grad_clip": 10.0, "gt_positive_threshold": 2,
    "gt_negative_threshold": 7, "margin": None, "nll_weight": 1.0, "metric_weight": 0.0,
    "lr": 0.0001, "scheduler_gamma": 0.999994,
}
BATCH_SIZE = 12
MAX_KEYPOINTS = 1024
# a bf16-compute step against an f32 step: the kernel path's distance may be
# at most this multiple of the plain path's (both are bf16 rounding)
BF16_DISTANCE_RATIO = 2.0
DESCRIPTOR_DIM = 256  # SuperPoint descriptors
SIDE_INFO_DIM = 0  # laf_to_sideinfo_method: none -> side info is the response only
# SIFT features (configs/features/sift_opencv.yaml): D=128, so 4 heads of width 32
SIFT_DESCRIPTOR_DIM, SIFT_MAX_KEYPOINTS = 128, 2048
# examples/pretrain_e2e_fixture.yaml: the flagship matcher section with SIFT
# descriptors in bf16 compute, B=2 pairs of 2048 keypoints, and its train:
# section (a CPU test holds these to the YAML)
PRETRAIN_SECTION = dict(SUPERGLUE_SECTION, dtype="bfloat16")
PRETRAIN_TRAIN_SECTION = {
    "grad_clip": 10.0, "gt_positive_threshold": 3, "gt_negative_threshold": 3, "margin": None,
    "nll_weight": 1.0, "metric_weight": 0.0, "lr": 0.0002, "scheduler_gamma": 0.999994, "warmup_steps": 500,
}
PRETRAIN_BATCH = 2
WIDE_KEYPOINTS = 4352  # past the fused Sinkhorn kernel's 4096 columns: the wide kernel (K2s)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_F32_TC_FLOPS = 495e12 / 3  # f32-accurate products as 3xTF32 (H100 SXM dense TF32: 495 TFLOP/s)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DECODE_AGREEMENT = 0.99
LOG_P_NATS = 0.05
MATCH_THRESHOLD = 0.2  # the flagship config's inference.match_threshold
SERVE_REPEATS = 5  # a request's latency is the median of this many runs
TRAIN_WARMUP, TRAIN_TIMED = 2, 5  # training steps before and under the clock
ROUTE_WARMUP, ROUTE_TIMED = 1, 3  # the same on the two other training routes


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, flop_rate: float, nbytes: float):
    t_ops, t_bytes = flops / flop_rate, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def work_bound(flops: float, dtype, nbytes: float):
    """(bound_ms, bound_by, fma_ms) of ``flops`` in ``dtype`` against
    ``nbytes``: bf16 at the tensor-core rate; f32 at 495/3 TFLOP/s, the rate
    of f32-accurate products as 3xTF32 on the tensor cores, with the bound at
    the f32 FMA rate, which the phase lines print beside it (``fma_ms``,
    None for bf16)."""
    if dtype == torch.bfloat16:
        return (*bound_ms(flops, PEAK_BF16_FLOPS, nbytes), None)
    fma = bound_ms(flops, PEAK_F32_FLOPS, nbytes)[0]
    return (*bound_ms(flops, PEAK_F32_TC_FLOPS, nbytes), fma)


def bound_note(fma_ms) -> str:
    return "" if fma_ms is None else f", FMA bound {fma_ms:.4f} ms"


def check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def layer_phase(glk, dtype, gen, batch=16, n=1024, dim=256, heads=4):
    """K1 at the serving shape with ragged key masks: kernel vs plain."""
    w = layer_weights(glk, dtype, gen, dim)
    x_q, x_kv, mask = layer_inputs(dtype, gen, batch, n, dim)
    out = glk.fused_attention_propagation(x_q, x_kv, mask, w, heads)
    ref = glk.layer_plain(x_q, x_kv, mask, w, heads)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    # f32: summation order only; bf16: two ulps of the largest output (rounding
    # flips from the online softmax and the accumulation order)
    tol = 1e-3 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    check(err <= tol, f"K1 {dtype}: max error {err} above {tol}")
    ms = device_ms(lambda: glk.fused_attention_propagation(x_q, x_kv, mask, w, heads), 20)
    plain_ms = device_ms(lambda: glk.layer_plain(x_q, x_kv, mask, w, heads), 5)
    elt = x_q.element_size()
    flops = batch * (20 * n * dim * dim + 4 * n * n * dim)
    nbytes = 3 * batch * n * dim * elt + (4 * dim * dim + 6 * dim * dim) * elt + batch * n
    bms, by, fma = work_bound(flops, dtype, nbytes)
    print(f"K1 gnn_layer {str(dtype)[6:]} B={batch} N=M={n} D={dim} H={heads}: max_abs_err={err:.3e} "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}){bound_note(fma)}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def k1_attention_phase(ak, gen, batch=16, n=1024, heads=4, dh=64):
    """K1's attention core alone at the serving shape (bf16, ragged key masks
    with valid counts in [N/4, N]), on K1's operand layout (q a [B, N, D]
    buffer, k and v the column blocks of one [B, M, 2D] buffer): kernel vs
    plain, and ``scaled_dot_product_attention`` with the same mask on the
    same views, which the port never uses."""
    F = torch.nn.functional
    dev, dt, dim = torch.device("cuda"), torch.bfloat16, heads * dh
    split = lambda x: x.view(batch, n, heads, dh).transpose(1, 2)
    q = split(torch.randn(batch, n, dim, generator=gen, device=dev).to(dt))
    kv = torch.randn(batch, n, 2 * dim, generator=gen, device=dev).to(dt)
    k, v = split(kv[..., :dim]), split(kv[..., dim:])
    counts = torch.randint(n // 4, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    run = lambda: ak.attention_forward(q, k, v, mask, False)
    out, ref = run()[0], ak.attention_forward_plain(q, k, v, mask, False)[0]
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0**-7 * ref.float().abs().max().item()  # K9's bar: one or two ulps of the largest output
    check(err <= tol, f"K1 attention bf16: error {err} above {tol}")
    ms = device_ms(run)
    plain_ms = device_ms(lambda: ak.attention_forward_plain(q, k, v, mask, False), 5)
    lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :]))
    # S and P V per head; q, k, v and the mask in, out written
    bms, by, _ = work_bound(batch * 4 * n * n * dim, dt, 4 * batch * n * dim * 2 + batch * n)
    print(f"K1 attention core bf16 B={batch} H={heads} N=M={n} dh={dh} (K1's layout): max_abs_err={err:.3e} "
          f"(bar {tol:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library "
          f"(scaled_dot_product_attention, same mask) {lib:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib)


def layer_weights(glk, dtype, gen, dim=256):
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d2 = 2 * dim
    return glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dtype), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dtype), r(dim),
    )


def layer_inputs(dtype, gen, batch, n, dim):
    """x_q, x_kv and a ragged key mask (valid counts in [N/4, N])."""
    dev = torch.device("cuda")
    x_q = torch.randn(batch, n, dim, generator=gen, device=dev).to(dtype)
    x_kv = torch.randn(batch, n, dim, generator=gen, device=dev).to(dtype)
    counts = torch.randint(n // 4, n + 1, (batch,), generator=gen, device=dev)
    return x_q, x_kv, torch.arange(n, device=dev)[None] < counts[:, None]


def feature_layer_phase(glk, sample_projection, kind, dtype, gen, batch=16, n=1024, dim=256, heads=4):
    """K6 at the serving shape with ragged key masks: kernel vs plain, two
    runs bit-equal, the layer's GEMMs and attention part by device time, and
    the attention part's launch plan."""
    w = layer_weights(glk, dtype, gen, dim)
    x_q, x_kv, mask = layer_inputs(dtype, gen, batch, n, dim)
    dh = dim // heads
    feats = dh if kind == "linear" else 2 * dh
    proj = None if kind == "linear" else sample_projection(gen, feats, dh)
    run = lambda: glk.fused_attention_propagation(x_q, x_kv, mask, w, heads, False, kind, proj)
    plain = lambda: glk.layer_plain(x_q, x_kv, mask, w, heads, False, kind, proj)
    out, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K6 {kind} {dtype}: two runs differ")
    err = (out.float() - ref.float()).abs().max().item()
    # f32: summation order only; bf16: two ulps of the largest output
    # (rounding flips of q, v, the features and the aggregate's operands)
    tol = 1e-3 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    check(err <= tol, f"K6 {kind} {dtype}: max error {err} above {tol}")
    ms = device_ms(run, 20)
    plain_ms = device_ms(plain, 5)
    parts = device_profile(run, top=64)[1]
    gemm_ms = sum(ms for ms, name, _ in parts if name.startswith("gemm"))
    attention_ms = sum(ms for ms, name, _ in parts if not name.startswith("gemm"))
    launches = sum(count for *_, count in parts)
    plan, sms = glk.kernel_feature_plan(batch, heads, n, n, feats, dh, dtype == torch.bfloat16, kind)
    mirror = glk.feature_plan(batch, heads, n, n, feats, dh, dtype == torch.bfloat16, kind, sms)
    check(plan == mirror, f"K6 {kind} {dtype}: the C plan {plan} is not the Python mirror's {mirror}")
    elt = x_q.element_size()
    # the work the function needs: the six dense products; per head the FAVOR
    # projection of queries and keys, the aggregate kf^T v and the key sum, all
    # on operands of the compute type; and qf . KV with the normalizer, whose
    # KV operand is f32 by definition
    favor = 0 if kind == "linear" else 4 * n * dh * feats
    t_ops = batch * (20 * n * dim * dim + heads * (favor + 2 * n * feats * dh + n * feats))
    f32_ops = batch * heads * (2 * n * feats * dh + 2 * n * feats)
    rate = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    nbytes = 3 * batch * n * dim * elt + 10 * dim * dim * elt + batch * n + (feats * dh * 4 if proj is not None else 0)
    t_op, t_bytes = t_ops / rate + f32_ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bms, by = max(t_op, t_bytes) * 1e3, ("operations" if t_op >= t_bytes else "bytes")
    print(f"K6 gnn_layer_features {kind} F={feats} {str(dtype)[6:]} B={batch} N=M={n} D={dim} H={heads}: "
          f"max_abs_err={err:.3e} (bar {tol:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}), two runs equal; by torch.profiler: GEMMs {gemm_ms:.4f} ms + attention "
          f"part {attention_ms:.4f} ms in {launches} launches; plan: {plan.cluster} CTAs per (element, head), "
          f"{plan.chunks_per_cta} 64-key chunks and {plan.query_tiles_per_cta} query tiles of "
          f"{glk.query_rows(dtype == torch.bfloat16)} each, keys resident {bool(plan.resident)}, "
          f"{plan.smem_bytes} B shared memory, {sms} SMs", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, gemms_ms=gemm_ms,
                attention_ms=attention_ms, launches_per_layer=launches)


INT8_MODES = {"int8": (False, False), "int8_static": (True, False), "int8_attn": (False, True),
              "int8_static_attn": (True, True)}
# relative-norm bars of K7 against its plain version: with bf16 attention the
# JAX package's bar between its int8 kernel and its oracle (rounding flips of P
# flip int8 roundings downstream); with int8 attention every product is exact
# and only the f32 summation order of the softmax denominator differs
INT8_REL_NORM = {False: 0.015, True: 1e-3}


def int8_layer_phase(glk, gli8, mode, gen, batch=16, n=1024, dim=256, heads=4):
    """K7 at the serving shape (bf16 x, ragged key masks): kernel vs plain. The
    integer products and their dequantization are exact; the attention's
    summation order (and, in bf16, its rounding of P) flips single int8
    roundings downstream, so the bar is on the relative norm, and the largest
    single difference is reported. Also: the launches of one layer (counted by
    the C code) against the C plan, the C plan against its Python mirror, the
    layer's GEMM and attention shares by torch.profiler device time, and
    ``torch._int_mm`` (s8 x s8 -> s32, no epilogue) on the layer's six
    products, the GEMM share's library yardstick (the port never calls it)."""
    static, quant_attention = INT8_MODES[mode]
    qw = gli8.quantize_propagation_weights(layer_weights(glk, torch.float32, gen, dim))
    x_q, x_kv, mask = layer_inputs(torch.bfloat16, gen, batch, n, dim)
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(x_q, x_kv, mask, qw, heads, quant_attention=quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    kw = dict(act_scales=scales, quant_attention=quant_attention)
    run = lambda: gli8.fused_attention_propagation_int8(x_q, x_kv, mask, qw, heads, **kw)
    plain = lambda: gli8.layer_int8_plain(x_q, x_kv, mask, qw, heads, **kw)
    out, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K7 {mode}: two runs differ")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    exact = (diff == 0).float().mean().item()
    bar = INT8_REL_NORM[quant_attention]
    check(rel <= bar, f"K7 {mode}: relative norm {rel} above {bar}")
    ms = device_ms(run, 20)
    plain_ms = device_ms(plain, 3)
    # the six dense products are s8; the attention's two are bf16, or s8 too
    dense, attn = batch * 20 * n * dim * dim, batch * 4 * n * n * dim
    t_op = dense / PEAK_INT8_OPS + attn / (PEAK_INT8_OPS if quant_attention else PEAK_BF16_FLOPS)
    nbytes = 3 * batch * n * dim * 2 + 10 * dim * dim + batch * n
    t_bytes = nbytes / PEAK_BYTES
    bms, by = max(t_op, t_bytes) * 1e3, ("operations" if t_op >= t_bytes else "bytes")
    # one layer's launches by the C code's counts, against its plan and the plan's mirror
    gli8.launch_counter.reset()
    gli8.memset_counter.reset()
    run()
    torch.cuda.synchronize()
    launched = (gli8.launch_counter.count, gli8.memset_counter.count)
    plan, sms = gli8.kernel_int8_plan(batch, n, n, dim, heads, quant_attention, static)
    mirror = gli8.int8_plan(batch, n, n, dim, heads, quant_attention, static, sms)
    check(plan == mirror, f"K7 {mode}: the C plan {plan} is not the Python mirror's {mirror}")
    check(launched == (plan.launches, plan.memsets), f"K7 {mode}: {launched} launches, the plan's "
          f"{(plan.launches, plan.memsets)}")
    parts = device_profile(run, top=64)[1]
    gemm_ms = sum(t for t, name, _ in parts if name.startswith("gemm_s8"))
    attention_ms = sum(t for t, name, _ in parts if name.startswith("attention"))
    other_ms = sum(t for t, name, _ in parts if not name.startswith(("gemm_s8", "attention")))
    # torch._int_mm on the six products (q, k, v, out: D x D; ffn1 2D x 2D; ffn2 D x 2D)
    rows, dev, lib_gen = batch * n, torch.device("cuda"), torch.Generator(device="cuda").manual_seed(12)
    library_ms = 0.0
    for n_out, k in ((dim, dim),) * 4 + ((2 * dim, 2 * dim), (dim, 2 * dim)):
        a = torch.randint(-127, 128, (rows, k), generator=lib_gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n_out, k), generator=lib_gen, device=dev, dtype=torch.int8)
        library_ms += device_ms(lambda a=a, w=w: torch._int_mm(a, w.t()), 20)
    print(f"K7 gnn_layer_int8 {mode} bf16-x B={batch} N=M={n} D={dim} H={heads}: max_abs_err={err:.3e}, "
          f"relative norm {rel:.3e} (bar {bar}), entries equal {exact:.4f}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), two runs equal", flush=True)
    print(f"  K7 {mode} D={dim}: {launched[0]} launches and {launched[1]} memset(s) per layer (C count); by "
          f"torch.profiler: GEMMs {gemm_ms:.4f} ms + attention {attention_ms:.4f} ms + quantize {other_ms:.4f} ms; "
          f"library (torch._int_mm on the six s8 products, no epilogue) {library_ms:.4f} ms; plan: {plan.tile_rows}-row "
          f"GEMM tiles on {plan.kv_ctas} (kv) / {plan.q_ctas} (q) persistent CTAs, {plan.attention_ctas} attention "
          f"CTAs, shared memory kv {plan.smem_kv} q {plan.smem_q} out {plan.smem_out} ffn1 {plan.smem_ffn1} "
          f"ffn2 {plan.smem_ffn2} attention {plan.smem_attention} B, workspace "
          f"{gli8.workspace_bytes(batch, n, n, dim, quant_attention, static)} B, {sms} SMs", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, rel_norm_err=rel,
                library_ms=library_ms, gemms_ms=gemm_ms, attention_ms=attention_ms,
                launches_per_layer=launched[0])


# the SMs the Sinkhorn kernels' plan must use at least, by batch: one
# element over more than one cluster of 8, the card filled where the batch
# allows it
PLAN_LEAST_SMS = {1: 16, 4: 100, 12: 100, 16: 100}


def plan_line(sk, name, batch, rows, cols, k_dtype, adjoint=False):
    """Print the launch plan the C code makes for a Sinkhorn kernel (K2, or
    K3 with ``adjoint``), check it against the Python mirror and against the
    SMs it must fill."""
    plan, caps, sms = sk.kernel_plan(batch, rows, cols, k_dtype, adjoint)
    mirror = sk.launch_plan(batch, rows, cols, k_dtype, sms, caps)
    in_flight = plan.slots * plan.ctas
    print(f"{name} plan: {plan.ctas} CTAs per element ({plan.groups} cluster(s) of {plan.cs}"
          f"{', cooperative' if plan.cooperative else ''}), {plan.slots} element(s) in flight on {in_flight} SMs, "
          f"{plan.waves} group(s) in turn; per CTA {plan.rows} rows: {plan.smem_rows} in shared memory, "
          f"{plan.spill_rows} in device memory; on-chip K "
          f"{plan.on_chip_bytes(cols, k_dtype)} bytes, {plan.smem_bytes} bytes of shared memory; "
          f"workspace {plan.workspace_bytes} bytes; clusters the card holds {caps}, {sms} SMs", flush=True)
    check(plan == mirror, f"{name}: the C plan {plan} is not the Python mirror's {mirror}")
    check(plan.spill_rows == 0, f"{name}: K does not stay on chip")
    check(in_flight >= PLAN_LEAST_SMS.get(batch, 1), f"{name}: {in_flight} SMs in flight")
    return plan


def sinkhorn_phase(sk, batch, n, gen, iters=20):
    """K2 on a padded, masked OT matrix at a serving shape: kernel vs plain."""
    dev = torch.device("cuda")
    scores = torch.randn(batch, n, n, generator=gen, device=dev) * 4
    mask0 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    rows, cols = n + 1, n + 1
    cp = sk._round_up(cols, sk.COL_ALIGN)
    k_dtype = sk.k_storage_dtype(rows, cols)
    dust = torch.tensor(1.0, device=dev)
    M_pad = sk.build_padded_otp_matrix(scores, dust, 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, n, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    plan_line(sk, f"K2 B={batch} N={n}", batch, rows, cp, k_dtype)
    u = sk.sinkhorn_scale(M_pad, la, lb, iters, k_dtype)
    again = sk.sinkhorn_scale(M_pad, la, lb, iters, k_dtype)
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, iters, k_dtype)
    torch.cuda.synchronize()
    check(torch.equal(u, again), f"K2 B={batch} N={n}: two runs differ")
    live = la > -1e8  # masked rows sit near -1e9, where one f32 ulp is 64
    err = (u - ref).abs()[live].max().item()
    check(err <= 1e-3, f"K2 B={batch} N={n}: max error {err} on live rows")
    ms = device_ms(lambda: sk.sinkhorn_scale(M_pad, la, lb, iters, k_dtype), 10)
    plain_ms = device_ms(lambda: sk.sinkhorn_scale_plain(M_pad, la, lb, iters, k_dtype), 5)
    flops = batch * rows * cp * (4 * (iters - 1) + 2)
    nbytes = batch * (rows * cp * 4 + 2 * rows * 4 + cp * 4)
    bms, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
    print(f"K2 sinkhorn K={str(k_dtype)[6:]} B={batch} N={n}: max_abs_err={err:.3e} "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, k_dtype=k_dtype)


def adjoint_phase(sk, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, iters=20):
    """K3 on a padded, masked OT matrix at the training shape: the gradient
    dM = g - K o (P^T Q) from the kernel's factors vs the plain version's."""
    dev = torch.device("cuda")
    scores = torch.randn(batch, n, n, generator=gen, device=dev) * 4
    mask0 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
    rows, cp = n + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    M_pad = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, n, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    valid = sk.valid_pairs(batch, n, n, mask0, mask1, dev)
    g = torch.zeros(batch, rows, cp, device=dev)
    g[:, :, : n + 1] = torch.randn(batch, rows, n + 1, generator=gen, device=dev) * valid
    rmax = M_pad.amax(dim=2)
    args = (M_pad, la, lb, rmax, g.sum(2), g.sum(1), iters)
    plan_line(sk, f"K3 B={batch} N={n}", batch, rows, cp, torch.float32, adjoint=True)
    K = torch.exp(M_pad - rmax[:, :, None])
    factors = sk.sinkhorn_adjoint(*args)
    again = sk.sinkhorn_adjoint(*args)
    dm = [g - K * torch.bmm(P.transpose(1, 2), Q) for P, Q in (factors, sk.sinkhorn_adjoint_plain(*args))]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(factors, again)), f"K3 B={batch} N={n}: two runs differ")
    live = torch.zeros_like(g, dtype=torch.bool)
    live[:, :, : n + 1] = valid
    err = (dm[0] - dm[1]).abs()[live].max().item()
    scale = dm[1].abs()[live].max().item()
    # the same f32 recursion over 2T passes; matvec summation order differs
    check(err <= 1e-4 * scale, f"K3 B={batch} N={n}: max error {err} above 1e-4 of {scale}")
    ms = device_ms(lambda: sk.sinkhorn_adjoint(*args), 10)
    plain_ms = device_ms(lambda: sk.sinkhorn_adjoint_plain(*args), 3)
    # FMAs of 2T passes over K (the last reverse step has no column pass),
    # bytes: M and the vectors read once, the factors written once
    flops = batch * rows * cp * (8 * iters - 2)
    nbytes = batch * (rows * cp * 4 + 3 * rows * 4 + 2 * cp * 4 + 2 * iters * (rows + cp) * 4)
    bms, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
    print(f"K3 sinkhorn_adjoint B={batch} N={n} T={iters}: max_abs_err={err:.3e} (of {scale:.3e}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def message_phase(glk, dtype, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, dim=256, heads=4):
    """K4 and K5 at the training shape with ragged key masks: kernel vs plain.
    The backward of both takes the plain forward's attn and lse."""
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
    x_q, x_kv, g = r(batch, n, dim).to(dtype), r(batch, n, dim).to(dtype), r(batch, n, dim).to(dtype)
    counts = torch.randint(n // 2, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    fwd = lambda: glk.message_forward(x_q, x_kv, mask, w, heads, dtype)
    out, ref = fwd(), glk.message_forward_plain(x_q, x_kv, mask, w, heads, dtype)
    bwd = lambda: glk.message_backward(x_q, x_kv, mask, w, g, ref[1], ref[2], heads, dtype)
    grads = bwd()
    ref_grads = glk.message_backward_plain(x_q, x_kv, mask, w, g, ref[1], ref[2], heads, dtype)
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    # f32: summation order only; bf16: single rounding flips (one ulp is
    # 2^-8 relative) of q, k, v and P carried through the products
    rel_tol = 1e-5 if dtype == torch.float32 else 2.0**-6
    f_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(out[:2], ref[:2]))
    f_tol = rel_tol * max(b.float().abs().max().item() for b in ref[:2])
    # the LSE, in nats: f32 summation order; bf16 a flip of a q or k entry
    # moves a logit (5.2e-3 measured at this shape on an H100; bar 2e-2)
    lse_err = (out[2] - ref[2]).abs().max().item()
    lse_tol = 1e-5 * ref[2].abs().max().item() if dtype == torch.float32 else 2e-2
    check(f_err <= f_tol and lse_err <= lse_tol,
          f"K4 {name}: msg/attn error {f_err} (tol {f_tol}), lse {lse_err} (tol {lse_tol})")
    # backward: each gradient against its largest entry; a bias gradient
    # against its weight's (dbk is zero up to cancellation)
    got, want = [*grads[:2], *grads[2]], [*ref_grads[:2], *ref_grads[2]]
    rel = []
    for i, (a, b) in enumerate(zip(got, want)):
        scale = b.float().abs().max().item()
        if i >= 2 and i % 2 == 1:
            scale = max(scale, want[i - 1].abs().max().item())
        rel.append((a.float() - b.float()).abs().max().item() / scale)
    b_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got[:2], want[:2]))
    b_tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    check(max(rel) <= b_tol, f"K5 {name}: relative errors {rel} above {b_tol}")
    # dbk = sum_i (sum_j dS_ij) q_i scale is zero in exact arithmetic (each
    # row of dS sums to 0): its size is rounding noise, its weight's is not
    dbk = dict(dbk_max=want[5].abs().max().item(), dwk_max=want[4].abs().max().item(),
               dbk_err=(got[5] - want[5]).abs().max().item())
    elt = x_q.element_size()
    # FLOP the function needs. Forward: 4 N x D x D products (q, k, v, out)
    # and per head 2 N x M x dh (S, P V). Backward: 11 N x D x D (q, k, v
    # recomputed, dattn, dWo, dx_q, dx_kv as two, dWq, dWk, dWv) and per head
    # 5 N x M x dh (S, dP, dV, dQ, dK); K5 recomputes S and dP in its second
    # pass, which the bound does not count
    f_flops = batch * (8 * n * dim * dim + 4 * n * n * dim)
    b_flops = batch * (22 * n * dim * dim + 10 * n * n * dim)
    act = batch * n * dim * elt
    f_bytes = 2 * act + 2 * act + batch * heads * n * 4 + batch * n + 4 * dim * dim * 4
    b_bytes = 4 * act + batch * heads * n * 4 + batch * n + 2 * act + 8 * (dim * dim + dim) * 4
    res = {}
    lse_note = f" lse_max_abs_err={lse_err:.3e} (bar {lse_tol:.1e})"
    for kname, fn, plain, flops, nbytes, err in (
        ("K4", fwd, lambda: glk.message_forward_plain(x_q, x_kv, mask, w, heads, dtype), f_flops, f_bytes, f_err),
        ("K5", bwd, lambda: glk.message_backward_plain(x_q, x_kv, mask, w, g, ref[1], ref[2], heads, dtype),
         b_flops, b_bytes, b_err),
    ):
        ms = device_ms(fn, 10)
        plain_ms = device_ms(plain, 3)
        bms, by, fma = work_bound(flops, dtype, nbytes)
        res[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"{kname} message_{'forward' if kname == 'K4' else 'backward'} {name} B={batch} N=M={n} "
              f"D={dim} H={heads}: max_abs_err={err:.3e}{lse_note if kname == 'K4' else ''} kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}){bound_note(fma)}", flush=True)
    res["K4"]["lse_max_abs_err"] = lse_err
    res["K5"]["max_rel_err"] = max(rel)
    print(f"  K5 {name} relative errors (dx_q, dx_kv, dWq, dbq, dWk, dbk, dWv, dbv, dWo, dbo): "
          + ", ".join(f"{x:.2e}" for x in rel) + f"; plain max |dbk| {dbk['dbk_max']:.3e}, max |dWk| "
          f"{dbk['dwk_max']:.3e}, dbk kernel - plain {dbk['dbk_err']:.3e}", flush=True)
    return res


def half_phase(glk, dtype, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, dim=256, heads=4):
    """K8 at the training shape with ragged key masks, with and without
    use_offset: kernel vs plain on z, attn and the LSE."""
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
    w1, b1 = r(2 * dim, 2 * dim, scale=(2 * dim) ** -0.5), r(2 * dim)
    x_q, x_kv = r(batch, n, dim).to(dtype), r(batch, n, dim).to(dtype)
    counts = torch.randint(n // 2, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    name = str(dtype)[6:]
    # f32: summation order only; bf16: single rounding flips of q, k, v, P and
    # msg carried through the products (K4's bars)
    rel_tol = 1e-5 if dtype == torch.float32 else 2.0**-6
    errs = {}
    for use_offset in (False, True):
        out = glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, heads, use_offset, dtype)
        ref = glk.train_half_plain(x_q, x_kv, mask, w, w1, b1, heads, use_offset, dtype)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(out[:2], ref[:2]))
        tol = rel_tol * max(b.float().abs().max().item() for b in ref[:2])
        lse_err = (out[2] - ref[2]).abs().max().item()
        lse_tol = 1e-5 * ref[2].abs().max().item() if dtype == torch.float32 else 2e-2
        check(err <= tol and lse_err <= lse_tol,
              f"K8 {name} use_offset={use_offset}: z/attn error {err} (tol {tol}), lse {lse_err} (tol {lse_tol})")
        errs[use_offset] = err
    run = lambda: glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, heads, False, dtype)
    ms = device_ms(run, 10)
    plain_ms = device_ms(lambda: glk.train_half_plain(x_q, x_kv, mask, w, w1, b1, heads, False, dtype), 3)
    elt = x_q.element_size()
    # 4 N x D x D products (q, k, v, out), one N x 2D x 2D, per head 2 N x M x dh;
    # x_q, x_kv and the mask in, z, attn and the LSE out, ten weights in f32
    flops = batch * (16 * n * dim * dim + 4 * n * n * dim)
    act = batch * n * dim * elt
    nbytes = 2 * act + 3 * act + batch * heads * n * 4 + batch * n + (8 * dim * dim + 6 * dim) * 4
    bms, by, fma = work_bound(flops, dtype, nbytes)
    print(f"K8 train_half {name} B={batch} N=M={n} D={dim} H={heads}: max_abs_err={errs[False]:.3e} "
          f"(use_offset {errs[True]:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
          f"{bound_note(fma)}", flush=True)
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


# The f32 layers of a `message` training step: 34 of the 36 (the chain is f32
# after the first layer), each K4 (kv, q, out GEMMs) and K5 (kv and q again,
# dA and dx_q in the kn form, dx_kv in the kn form over [Wk; Wv], and the four
# weight gradients in one tn GEMM)
F32_MESSAGE_LAYERS = 34
# the bars of a small f32 training step (B=2 N=256) against f64 on the f32
# step's own ReLU gates (hold_f32_step_against_exact): each route on 9
# batches read at most loss 3.9e-6, norm 2.4e-6, 1 - cosine 2.5e-11 and
# statistics 2.7e-7 (H100); one gate taken apart moves the norm by 2e-4
F32_STEP_BARS = dict(loss_tol=1e-5, norm_tol=2e-5, cos_min=0.999999, stats_tol=2e-6)
# (name, n_out / D, k / D, form, launches per f32 message layer)
GEMM_F32_SHAPES = (("kv", 2, 1, "split", 2), ("q/out", 1, 1, "plain", 3), ("dA/dx_q", 1, 1, "kn", 2),
                   ("dx_kv", 1, 2, "kn_split", 1))
# K1's five GEMMs (name, n_out / D, k / D, epilogue)
GEMM_K1_SHAPES = (("kv", 2, 1, "bias"), ("q", 1, 1, "bias"), ("out+concat", 1, 1, "concat"),
                  ("ffn1", 2, 2, "relu_affine"), ("ffn2", 1, 2, "residual"))


def gemm_phase(gk, gen):
    """The dense GEMMs alone: gemm_f32 at every shape of a `message` training
    step (B=12 N=M=1024 D=256: 12,288 rows) and of the pretraining fixture's
    width (B=2 N=2048 D=128: 4,096 rows), tn_gemm_f32 at the four weight
    gradients of both, each against its plain version, with its bounds and
    the time of one PyTorch call for the same function (``F.linear``, ``a @
    w`` for the kn form, ``torch.bmm`` of the stacked X^T Y for the tn form);
    then the bf16 GEMM (wgmma on TMA tiles) at K1's five shapes (B=16 N=1024
    D=256) against its plain version, beside ``F.linear`` in bf16, with each
    launch's bound. Times are device times (``device_ms``)."""
    F = torch.nn.functional
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    res = {"f32": {}, "tn": {}, "bf16": {}}
    for width, rows, dim in (("B=12 N=1024 D=256", BATCH_SIZE * MAX_KEYPOINTS, 256),
                             ("B=2 N=2048 D=128", PRETRAIN_BATCH * SIFT_MAX_KEYPOINTS, SIFT_DESCRIPTOR_DIM)):
        step_ms = step_lib = step_bound = 0.0
        for name, n_mul, k_mul, form, per_layer in GEMM_F32_SHAPES:
            n_out, k = n_mul * dim, k_mul * dim
            a = r(rows, k)
            if form == "split":
                w, b = r(n_out, k, scale=k**-0.5), r(n_out)
                half = n_out // 2
                kw = dict(a=a, w=w[:half].contiguous(), bias=b[:half].contiguous(), w2=w[half:].contiguous(),
                          bias2=b[half:].contiguous(), split=half)
                library = lambda a=a, w=w, b=b: F.linear(a, w, b)
            elif form == "plain":
                w, b = r(n_out, k, scale=k**-0.5), r(n_out)
                kw = dict(a=a, w=w, bias=b)
                library = lambda a=a, w=w, b=b: F.linear(a, w, b)
            else:
                w = r(k, n_out, scale=k**-0.5)
                kw = dict(a=a, w=w, bias=None, kn=True)
                if form == "kn_split":
                    kw.update(w=w[: k // 2].contiguous(), w2=w[k // 2:].contiguous(), k_split=k // 2)
                library = lambda a=a, w=w: a @ w
            out, ref = gk.gemm(**kw), gk.gemm_plain(**kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()  # summation order and the split's 2^-22 (the layer kernels' bar)
            check(err <= tol, f"gemm_f32 {name} {rows}x{n_out}x{k}: error {err} above {tol}")
            ms = device_ms(lambda: gk.gemm(**kw))
            plain_ms = device_ms(lambda: gk.gemm_plain(**kw), 5)
            library_ms = device_ms(library)
            bms, by, fma = work_bound(2.0 * rows * n_out * k, torch.float32, 4.0 * (rows * k + n_out * k + rows * n_out))
            res["f32"][(width, name)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                             library_ms=library_ms, launches_per_layer=per_layer)
            step_ms += F32_MESSAGE_LAYERS * per_layer * ms
            step_lib += F32_MESSAGE_LAYERS * per_layer * library_ms
            step_bound += F32_MESSAGE_LAYERS * per_layer * bms
            print(f"gemm_f32 {name} ({form}) {width}: {rows}x{n_out}x{k}, max_abs_err={err:.3e} (bar {tol:.1e}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}){bound_note(fma)}, "
                  f"library {library_ms:.4f} ms; {per_layer} per f32 message layer", flush=True)
        xs, ys = [r(rows, dim) for _ in range(4)], [r(rows, dim) for _ in range(4)]
        xst, yst = torch.stack(xs), torch.stack(ys)
        outs, refs = gk.tn_gemm(xs, ys), gk.tn_gemm_plain(xs, ys)
        again = gk.tn_gemm(xs, ys)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(outs, again)), f"tn_gemm_f32 {width}: two runs differ")
        err = max((o - q).abs().max().item() for o, q in zip(outs, refs))
        tol = 1e-5 * max(q.abs().max().item() for q in refs)
        check(err <= tol, f"tn_gemm_f32 {width}: error {err} above {tol}")
        ms = device_ms(lambda: gk.tn_gemm(xs, ys))
        plain_ms = device_ms(lambda: gk.tn_gemm_plain(xs, ys), 5)
        library_ms = device_ms(lambda: torch.bmm(xst.transpose(1, 2), yst))
        bms, by, fma = work_bound(4 * 2.0 * rows * dim * dim, torch.float32, 4.0 * (8 * rows * dim + 4 * dim * dim))
        res["tn"][width] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                library_ms=library_ms, launches_per_layer=1)
        print(f"tn_gemm_f32 {width}: 4 x {dim}x{dim} over {rows} rows, max_abs_err={err:.3e} (bar {tol:.1e}), two "
              f"runs bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
              f"{bound_note(fma)}, library (torch.bmm of X^T Y) {library_ms:.4f} ms", flush=True)
        layers = F32_MESSAGE_LAYERS
        print(f"  per message step at {width} were its {layers} layers f32 ({8 * layers} gemm_f32, {layers} "
              f"tn_gemm_f32): "
              f"gemm_f32 {step_ms:.3f} ms (library {step_lib:.3f}, bound {step_bound:.3f}), tn_gemm_f32 "
              f"{layers * ms:.3f} ms (library {layers * library_ms:.3f}, bound {layers * bms:.3f})", flush=True)
        res["tn"][width]["per_step_ms"] = layers * ms
        res["f32"][(width, "step")] = dict(ms=step_ms, library_ms=step_lib, bound_ms=step_bound)

    rows, dim = 16 * MAX_KEYPOINTS, 256
    for name, n_mul, k_mul, epilogue in GEMM_K1_SHAPES:
        n_out, k = n_mul * dim, k_mul * dim
        a, w, b = r(rows, k).bfloat16(), r(n_out, k, scale=k**-0.5).bfloat16(), r(n_out)
        x, sc, sh = r(rows, n_out).bfloat16(), 1.0 + 0.1 * r(n_out), 0.1 * r(n_out)
        kw = dict(a=a, w=w, bias=b, epilogue=epilogue, x=x, scale=sc, shift=sh)
        out, ref = gk.gemm(**kw), gk.gemm_plain(**kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0**-7 * ref.float().abs().max().item()  # two bf16 ulps of the largest entry
        check(err <= tol, f"gemm_bf16 {name}: error {err} above {tol}")
        ms = device_ms(lambda: gk.gemm(**kw))
        plain_ms = device_ms(lambda: gk.gemm_plain(**kw), 5)
        library_ms = device_ms(lambda: F.linear(a, w, b.bfloat16()))
        # bf16 a and w in, out written (the concat twice as wide), x read by concat and residual
        nbytes = 2.0 * (rows * k + n_out * k + rows * n_out * (2 if epilogue == "concat" else 1)
                        + (rows * n_out if epilogue in ("concat", "residual") else 0))
        bms, by, _ = work_bound(2.0 * rows * n_out * k, torch.bfloat16, nbytes)
        res["bf16"][name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                 library_ms=library_ms)
        print(f"gemm_bf16 K1 {name} ({epilogue}) B=16 N=1024 D=256: {rows}x{n_out}x{k}, max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library (F.linear bf16) "
              f"{library_ms:.4f} ms", flush=True)
    per_layer = {key: sum(v[key] for v in res["bf16"].values()) for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    res["bf16_layer"] = dict(per_layer, max_abs_err=max(v["max_abs_err"] for v in res["bf16"].values()),
                             bound_by="bytes" if all(v["bound_by"] == "bytes" for v in res["bf16"].values())
                             else "operations")
    print(f"  gemm_bf16 per K1 layer (B=16): kernel {per_layer['ms']:.4f} ms, plain {per_layer['plain_ms']:.4f} ms, "
          f"library {per_layer['library_ms']:.4f} ms, bound {per_layer['bound_ms']:.4f} ms", flush=True)
    return res


def attention_phase(ak, dtype, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, heads=4, dh=64):
    """K9 and K10 on the heads of [B, N, H*dh] projections (the views the
    multi-head attention makes), valid key counts in [N/2, N] and one element
    with every key masked: kernel vs plain, two runs of K10 bit for bit, and
    the time of one ``scaled_dot_product_attention`` call on the same inputs
    (forward; forward and backward minus forward), which the port never uses."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    dim = heads * dh

    def r():
        x = torch.randn(batch, n, dim, generator=gen, device=dev).to(dtype)
        return x.view(batch, n, heads, dh).transpose(1, 2)

    q, k, v, g = r(), r(), r(), r()
    counts = torch.randint(n // 2, n + 1, (batch,), generator=gen, device=dev)
    counts[batch // 2] = 0  # one fully masked element
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    live = counts > 0
    name = str(dtype)[6:]
    fwd = lambda: ak.attention_forward(q, k, v, mask)
    (out, lse), (ref, ref_lse) = fwd(), ak.attention_forward_plain(q, k, v, mask)
    bwd = lambda: ak.attention_backward(q, k, v, mask, g, out, lse)
    passes = ak.bf16_backward_counter.count
    grads, again, ref_grads = bwd(), bwd(), ak.attention_backward_plain(q, k, v, mask, g)
    torch.cuda.synchronize()
    passes = ak.bf16_backward_counter.count - passes
    check(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K10 {name}: two runs differ")
    # the bf16 backward is two launches (pass A, pass B) of the wgmma passes
    check(passes == (4 if dtype == torch.bfloat16 else 0), f"K10 {name}: {passes} bf16 pass launches for two calls")
    # f32: summation order only; bf16: the online softmax rounds P against the
    # running max, one or two ulps (2^-8 relative) of the largest output
    f_err = (out.float() - ref.float()).abs().max().item()
    f_tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.float().abs().max().item()
    # the LSE where a key is valid (with none it sits at -1e9, one f32 ulp is 64)
    lse_err = (lse - ref_lse)[live].abs().max().item()
    check(f_err <= f_tol and lse_err <= 1e-4, f"K9 {name}: out error {f_err} (tol {f_tol}), lse {lse_err}")
    # gradients against their largest entry: f32 summation order and the row
    # sums taken from g . out; bf16 rounding flips of P and dS (K5's bars)
    rel = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
           for a, b in zip(grads, ref_grads)]
    b_tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    check(max(rel) <= b_tol, f"K10 {name}: relative errors {rel} above {b_tol}")
    b_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads))

    # the library call on the same inputs (a fully masked row is NaN there)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attn_mask = mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=attn_mask)

    def sdpa_both():
        lq.grad = lk.grad = lv.grad = None
        sdpa().backward(g)

    with torch.enable_grad():
        lib_fwd = device_ms(sdpa, 10)
        lib_bwd = device_ms(sdpa_both, 10) - lib_fwd

    elt = q.element_size()
    act, stat = batch * n * dim * elt, batch * heads * n * 4
    # forward: S and P V per head; q, k, v and the mask in, out and the LSE out.
    # backward: S, dP, dV, dQ, dK per head; q, k, v, g, out, the LSE and the
    # mask in, dq, dk, dv out
    cases = (("K9", "attention_forward", fwd, lambda: ak.attention_forward_plain(q, k, v, mask),
              batch * 4 * n * n * dim, 4 * act + stat + batch * n, f_err, lib_fwd),
             ("K10", "attention_backward", bwd, lambda: ak.attention_backward_plain(q, k, v, mask, g),
              batch * 10 * n * n * dim, 8 * act + stat + batch * n, b_err, lib_bwd))
    res = {}
    for kname, what, fn, plain, flops, nbytes, err, lib in cases:
        ms = device_ms(fn, 10)
        plain_ms = device_ms(plain, 3)
        bms, by, fma = work_bound(flops, dtype, nbytes)
        res[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib)
        print(f"{kname} {what} {name} B={batch} H={heads} N=M={n} dh={dh}: max_abs_err={err:.3e} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}){bound_note(fma)}, library "
              f"(scaled_dot_product_attention) {lib:.4f} ms", flush=True)
    res["K9"]["lse_max_abs_err"] = lse_err
    res["K10"]["max_rel_err"] = max(rel)
    print(f"  K9 {name} lse_max_abs_err={lse_err:.3e} on live elements; K10 {name} relative errors (dq, dk, dv): "
          + ", ".join(f"{x:.2e}" for x in rel) + "; two runs equal", flush=True)
    if dtype == torch.bfloat16:
        res["K10"].update(bf16_pass_launches=passes, ragged=ragged_backward_check(ak, heads, dh))
    return res


def ragged_backward_check(ak, heads, dh, n=1000, m=777):
    """K10 bf16 at N=1000, M=777 (neither a multiple of a tile) with a
    ragged mask and one fully masked element, with and without the LSE's
    cotangent: kernel vs plain at K10's bars, two runs bit for bit, two
    launches of the passes per call. Its own generator, so that later phases
    draw the data they drew before this check existed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    batch, dim = 3, heads * dh

    def r(length):
        return torch.randn(batch, length, dim, generator=gen, device=dev).bfloat16().view(
            batch, length, heads, dh).transpose(1, 2)

    q, k, v, g = r(n), r(m), r(m), r(n)
    counts = torch.randint(m // 2, m + 1, (batch,), generator=gen, device=dev)
    counts[1] = 0
    mask = torch.arange(m, device=dev)[None] < counts[:, None]
    out, lse = ak.attention_forward(q, k, v, mask)
    rel = []
    for g_lse in (None, torch.randn(batch, heads, n, generator=gen, device=dev)):
        before = ak.bf16_backward_counter.count
        grads = ak.attention_backward(q, k, v, mask, g, out, lse, g_lse)
        again = ak.attention_backward(q, k, v, mask, g, out, lse, g_lse)
        ref = ak.attention_backward_plain(q, k, v, mask, g, g_lse=g_lse)
        torch.cuda.synchronize()
        what = f"K10 bf16 N={n} M={m} dh={dh} g_lse={g_lse is not None}"
        check(ak.bf16_backward_counter.count - before == 4, f"{what}: not two pass launches per call")
        check(all(torch.equal(a, b) for a, b in zip(grads, again)), f"{what}: two runs differ")
        rel += [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item() for a, b in zip(grads, ref)]
        check(max(rel) <= 2.0**-6, f"{what}: relative errors {rel} above {2.0**-6}")
    print(f"  K10 bf16 B={batch} N={n} M={m} dh={dh} (one element fully masked): relative errors (dq, dk, dv; "
          "then with g_lse) " + ", ".join(f"{x:.2e}" for x in rel) + "; two runs equal", flush=True)
    return dict(max_rel_err=max(rel))


def lse_phase(ak, dtype, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, heads=4, dh=64):
    """K11, the ring's block attention with the LSE, on the heads of
    [B, N, H*dh] projections, valid key counts in [N/2, N] and one element with
    every key masked: kernel vs plain, and ``scaled_dot_product_attention`` on
    the same inputs (which returns no LSE), which the port never uses."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    dim = heads * dh

    def r():
        x = torch.randn(batch, n, dim, generator=gen, device=dev).to(dtype)
        return x.view(batch, n, heads, dh).transpose(1, 2)

    q, k, v = r(), r(), r()
    counts = torch.randint(n // 2, n + 1, (batch,), generator=gen, device=dev)
    counts[batch // 2] = 0
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    live = counts > 0
    run = lambda: ak.attention_lse_forward(q, k, v, mask)
    (out, lse), (ref, ref_lse) = run(), ak.attention_forward_plain(q, k, v, mask)
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    # K9's bars: f32 summation order; bf16 one or two ulps of the largest output
    err = (out.float() - ref.float()).abs().max().item()
    tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.float().abs().max().item()
    lse_err = (lse - ref_lse)[live].abs().max().item()
    check(err <= tol and lse_err <= 1e-4 and bool((lse[~live] < -1e8).all()),
          f"K11 {name}: out error {err} (tol {tol}), lse {lse_err} on live elements")
    ms = device_ms(run, 10)
    plain_ms = device_ms(lambda: ak.attention_forward_plain(q, k, v, mask), 3)
    attn_mask = mask[:, None, None, :]
    lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), 10)
    elt = q.element_size()
    act, stat = batch * n * dim * elt, batch * heads * n * 4
    # S and P V per head; q, k, v and the mask in, out and the LSE out
    bms, by, fma = work_bound(batch * 4 * n * n * dim, dtype, 4 * act + stat + batch * n)
    print(f"K11 attention_lse {name} B={batch} H={heads} N=M={n} dh={dh}: max_abs_err={err:.3e} (bar {tol:.3e}), "
          f"lse_max_abs_err={lse_err:.3e} on live elements; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}){bound_note(fma)}, library (scaled_dot_product_attention, no LSE) "
          f"{lib:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib,
                lse_max_abs_err=lse_err)


def merge_phase(ak, ring, dtype, gen, batch=BATCH_SIZE, n=MAX_KEYPOINTS, heads=4, blocks=4):
    """The ring's arithmetic that does not depend on the number of ranks, at
    full width: K11 on ``blocks`` key blocks of one request, merged with
    ``ring.merge_block`` and the final where, against K9 on the whole key set
    (one element has a block entirely masked, one no valid key: 0); the
    gradient (K10 with a non-zero g_lse per block) against K10 on the whole
    set."""
    dev = torch.device("cuda")
    dim, width = heads * 64, n // blocks

    def r():
        x = torch.randn(batch, n, dim, generator=gen, device=dev).to(dtype)
        return x.view(batch, n, heads, 64).transpose(1, 2)

    q, k, v, g = r(), r(), r(), r()
    counts = torch.randint(n // 2, n + 1, (batch,), generator=gen, device=dev)
    counts[0] = n - width - 7  # the last block entirely masked
    counts[batch // 2] = 0
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    live = counts > 0
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        acc = torch.zeros_like(leaves[0])
        lse_run = torch.full_like(leaves[0][..., 0], float("-inf"))
        for j in range(blocks):
            keys = slice(j * width, (j + 1) * width)
            blk = ak.masked_softmax_attention_with_lse(
                leaves[0], leaves[1][:, :, keys], leaves[2][:, :, keys], mask[:, keys])
            acc, lse_run = ring.merge_block(acc, lse_run, *blk)
        merged = torch.where(lse_run[..., None] < -1e8, 0.0, acc)
        (merged * g.float()).sum().backward()
    out, lse = ak.attention_forward(q, k, v, mask)
    ref = ak.attention_backward(q, k, v, mask, g, out, lse)
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    # forward: K9's bars; gradients: K10's (2^-6 in bf16: a block's P and dS
    # round against the block's LSE, the merged sum adds four roundings)
    f_tol = (1e-5 if dtype == torch.float32 else 2.0**-7) * out[live].float().abs().max().item()
    f_err = (merged[live] - out[live].float()).abs().max().item()
    check(f_err <= f_tol and not merged[~live].any(), f"merge {name}: forward error {f_err} (bar {f_tol})")
    rel = []
    for a, b in zip(leaves, ref):
        rel.append((a.grad[live].float() - b[live].float()).abs().max().item() / b[live].float().abs().max().item())
        check(not a.grad[~live].any(), f"merge {name}: a gradient of the element with no key is not 0")
    b_tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    check(max(rel) <= b_tol, f"merge {name}: relative gradient errors {rel} above {b_tol}")
    print(f"merge {name} B={batch} N=M={n} in {blocks} blocks of {width} keys (one block masked, one element "
          f"with no key): forward max_abs_err={f_err:.3e} (bar {f_tol:.3e}) vs K9 on the whole set, 0 where no "
          f"key; gradient relative errors (dq, dk, dv) " + ", ".join(f"{x:.2e}" for x in rel)
          + f" (bar {b_tol}) vs K10 on the whole set", flush=True)
    return dict(forward_err=f_err, forward_bar=f_tol, grad_rel_err=max(rel), grad_bar=b_tol)


def ring_phase(gen, card, base_model, ring_requests, device="cuda"):
    """Keypoint-axis context parallelism through NCCL at world size 1 (the
    script drives one card): ring serving of the flagship requests and a
    ring training step. The ring never rotates at one rank; its all-reduces
    run as one-rank NCCL calls. Returns the launches of the counted runs."""
    import functools
    import socket

    import torch.distributed as dist

    from openglue_tpu_torch import parallel
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step, superglue_inputs

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, device_type=device)
    check(dist.get_backend() == {"cuda": "nccl", "cpu": "gloo"}[device], f"backend {dist.get_backend()}")
    mesh = parallel.make_mesh({parallel.MODEL_AXIS: 1}, device_type=device)
    section = dict(SUPERGLUE_SECTION, ring_axis=parallel.MODEL_AXIS)
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "K8": glk.half_counter, "K9": ak.counter, "K10": ak.backward_counter,
                "K11": ak.lse_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2
    launches = {}
    try:
        cfg = superglue_config_from({"superglue": section}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
        model = SuperGlue(cfg, device=device, mesh=mesh).eval()
        model.load_state_dict(base_model.state_dict())
        group = model.keypoint_group
        composed = SuperGlue(dataclasses.replace(cfg, ring_axis=None, use_pallas=False), device=device).eval()
        composed.load_state_dict(base_model.state_dict())
        decode = functools.partial(decode_from_output, group=group)

        def serve_ring(inputs):
            out = model(**inputs)
            return out, decode(out, MATCH_THRESHOLD, inputs["mask0"], inputs["mask1"])

        with torch.inference_mode():
            for name, pairs in ring_requests:
                inputs = superglue_inputs(parallel.shard_pair_batch_cp(pairs, mesh))
                serve_ring(inputs)
                torch.cuda.synchronize()
                for c in counters.values():
                    c.reset()
                out, decoded = serve_ring(inputs)
                delta = {k: c.count for k, c in counters.items()}
                expected = dict({k: 0 for k in counters}, K11=layers)
                check(delta == expected, f"ring serve {name}: launches {delta}, expected {expected}")
                launches[name] = delta["K11"]
                times = []
                for _ in range(SERVE_REPEATS):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    serve_ring(inputs)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - start)
                latency = statistics.median(times)
                whole = dict(out, scores=parallel.gather_rows(out["scores"], group))
                ref = composed(**inputs)
                nats, stats = compare(decode, whole, ref, inputs, f"ring serve {name}")
                vs_kernels = decode_readings(decode, whole, base_model(**inputs), inputs)
                batch = inputs["kpts0"].shape[0]
                busy, kernels_by_time = device_profile(lambda: serve_ring(inputs))
                idle = "not measured" if busy is None else f"{1 - busy / (latency * 1e3):.3f}"
                print(f"ring serve {name} (NCCL, 1 rank): {latency * 1e3:.3f} ms (median of {SERVE_REPEATS}), "
                      f"{batch / latency:.2f} pairs/s, device busy {busy} ms, idle share {idle}, launches "
                      f"K11={delta['K11']} (K1=K2=K9=0), vs the composed path without ring_axis: {nats:.3e} nats, "
                      f"decode {json.dumps(stats)}; vs the bf16 kernel path (reading) {json.dumps(vs_kernels)}, "
                      f"matches {int((decoded['matches0'] >= 0).sum())} [{card}]", flush=True)
                print(f"  device time by kernel, ring serve {name}: "
                      + "; ".join(f"{kname} {ms:.3f} ms" for ms, kname, _ in kernels_by_time), flush=True)
            del composed

        # ---- one ring training step against the same step on the composed route
        config = {"superglue": section, "train": TRAIN_SECTION}
        step = make_train_step(loss_config_from(config))
        ring_model = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(1), mesh=mesh)
        state = create_train_state(ring_model, optimizer=optimizer_from(config, ring_model.parameters()))
        twin = SuperGlue(dataclasses.replace(cfg, ring_axis=None), device=device, train_route="composed")
        twin.load_state_dict(ring_model.state_dict())
        plain = create_train_state(twin, optimizer=optimizer_from(config, twin.parameters()))
        n = MAX_KEYPOINTS
        counts = lambda: torch.randint(n // 2, n + 1, (BATCH_SIZE,), generator=gen, device=device).tolist()
        pairs = make_request(SyntheticHomographyPairs, gen, BATCH_SIZE, n, counts(), counts())
        batch = parallel.shard_pair_batch_cp(pairs, mesh)
        first = step(state, batch)
        ref = step(plain, pairs)
        torch.cuda.synchronize()
        compare_steps(state.model, plain.model, first, ref,
                      f"ring train step B={BATCH_SIZE} N={n} (NCCL, 1 rank) vs route=composed",
                      loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
        del plain, twin
        expected = dict({k: 0 for k in counters}, K11=layers, K10=layers)
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(ROUTE_WARMUP + ROUTE_TIMED):
            before = {k: c.count for k, c in counters.items()}
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            delta = {k: c.count - before[k] for k, c in counters.items()}
            check(delta == expected, f"ring step {i}: launches {delta}, expected {expected}")
            check(all(torch.isfinite(v).item() for v in metrics.values()), f"ring step {i}: {metrics}")
            losses.append(metrics["total_loss"].item())
            if i >= ROUTE_WARMUP:
                times.append(elapsed)
        launches["train"] = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, kernels_by_time = device_profile(lambda: step(state, batch), top=8)
        median = statistics.median(times)
        idle = "not measured" if busy is None else f"{1 - busy / (median * 1e3):.3f}"
        print(f"ring train B={BATCH_SIZE} N={n} (NCCL, 1 rank): step {median * 1e3:.3f} ms (median of {ROUTE_TIMED}; "
              f"all {', '.join(f'{t * 1e3:.3f}' for t in times)}), {BATCH_SIZE / median:.2f} pairs/s, peak memory "
              f"{peak:.2f} GiB, device busy {busy} ms, idle share {idle}, loss {first['total_loss'].item():.4f} -> "
              f"{losses[-1]:.4f}, launches per step {json.dumps({k: v for k, v in expected.items() if v})} [{card}]",
              flush=True)
        print("  device time by kernel, ring train step: "
              + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time), flush=True)
        print("  host time by operator (self), ring train step: "
              + "; ".join(f"{name} {ms:.3f} ms ({calls} calls)" for ms, name, calls in host_profile(
                  lambda: step(state, batch))), flush=True)
    finally:
        dist.destroy_process_group()
    return launches


@contextlib.contextmanager
def plain_versions(glk, sk, gli8=None, ak=None):
    """Route the model's kernel calls to the kernels' plain versions, on the
    card, for the reference run of the same model."""
    names = [(glk, "fused_attention_propagation", glk.layer_plain),
             (glk, "message_forward", glk.message_forward_plain),
             (glk, "message_backward", glk.message_backward_plain),
             (sk, "sinkhorn_scale", sk.sinkhorn_scale_plain),
             (sk, "sinkhorn_adjoint", sk.sinkhorn_adjoint_plain)]
    if gli8 is not None:
        names.append((gli8, "fused_attention_propagation_int8", gli8.layer_int8_plain))
    if ak is not None:
        names += [(ak, "attention_forward", ak.attention_forward_plain),
                  (ak, "attention_backward", ak.attention_backward_plain),
                  (glk, "train_half_forward", glk.train_half_plain)]
    saved = [getattr(module, name) for module, name, _ in names]
    for module, name, plain in names:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(names, saved):
            setattr(module, name, fn)


def flat_grads(model):
    return torch.cat([p.grad.double().flatten() for p in model.parameters() if p.grad is not None])


@contextlib.contextmanager
def f64_floats():
    """``Tensor.float()`` leaves an f64 tensor in f64 (the model casts its
    scores and statistics with it), so that a step of an f64 model on an f64
    batch stays f64 throughout."""
    float32 = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self if self.dtype == torch.float64 else float32(self, *a, **kw)
    try:
        yield
    finally:
        torch.Tensor.float = float32


def to_f64(x):
    """A copy of a batch (dataclasses of tensors) with its floating tensors in f64."""
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_f64(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init})
    return x


@contextlib.contextmanager
def relu_gates(model, glk, force=None):
    """Record the ReLU gates (pre-activation > 0) of the model's forward
    passes in call order: its ReLU modules and the ReLU that the train-half
    kernel fuses. With ``force`` (another run's record), each ReLU module
    takes those gates in place of its own; the record then holds the gates
    this run would have taken."""
    seen = []
    half = glk.train_half_forward

    def hook(module, args, out):
        seen.append(args[0].detach() > 0)
        if force is not None:
            return torch.where(force[len(seen) - 1], args[0], torch.zeros_like(args[0]))
        return None

    def half_recorded(*args, **kwargs):
        z, attn, lse = half(*args, **kwargs)
        seen.append(z.detach() > 0)
        return z, attn, lse

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    glk.train_half_forward = half_recorded
    try:
        yield seen
    finally:
        glk.train_half_forward = half
        for h in hooks:
            h.remove()


def hold_f32_step_against_exact(state, batch, step, config, glk, name, **bars):
    """One f32 training step of ``state`` on ``batch`` against the same step
    in f64 through the composed path (``use_pallas=False``) made to take the
    f32 step's ReLU gates. A gate whose pre-activation lies within f32's
    rounding of 0 falls on either side, and the gradient jumps with it (one
    FFN gate moved the norm by 2e-4 on a B=2 N=256 batch), so a step is held
    against exact arithmetic on its own gates, where rounding alone is
    left."""
    from openglue_tpu_torch.cli.common import optimizer_from
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.train.state import create_train_state

    model = SuperGlue(dataclasses.replace(state.model.config, use_pallas=False),
                      device=next(state.model.parameters()).device).double()
    model.load_state_dict(state.model.state_dict())
    exact = create_train_state(model, optimizer=optimizer_from(config, model.parameters()))
    with relu_gates(state.model, glk) as gates:
        m_f32 = step(state, batch)
    with relu_gates(model, glk, force=gates) as own, f64_floats():
        m_f64 = step(exact, to_f64(batch))
    check(len(own) == len(gates), f"{name}: {len(gates)} ReLU calls in f32, {len(own)} in f64")
    flipped = sum(int((a != b).sum()) for a, b in zip(gates, own))
    print(f"{name}: {len(gates)} ReLU calls, {flipped} gates of {sum(g.numel() for g in gates)} taken "
          f"from the f32 step against f64's own", flush=True)
    return compare_steps(state.model, model, m_f32, m_f64, name, **bars)


def compare_steps(kernel, plain, m_kernel, m_plain, name, loss_tol, norm_tol, cos_min, stats_tol):
    """One training step from the same state and batch on two paths: the
    loss, the unclipped gradient norm, the direction of the gradient (cosine;
    clipping scales it) and the BatchNorm running statistics after the step."""
    loss = abs(m_kernel["total_loss"].item() - m_plain["total_loss"].item())
    norm = abs(m_kernel["grad_norm"].item() / m_plain["grad_norm"].item() - 1)
    a, b = flat_grads(kernel), flat_grads(plain)
    cos = (a @ b / (a.norm() * b.norm())).item()
    stats = max((x - y).abs().max().item() for (k, x), (_, y) in zip(
        kernel.named_buffers(), plain.named_buffers()) if "running" in k)
    print(f"{name}: loss {m_kernel['total_loss'].item():.6f} vs {m_plain['total_loss'].item():.6f} "
          f"(|diff| {loss:.3e}), grad norm {m_kernel['grad_norm'].item():.4f} vs "
          f"{m_plain['grad_norm'].item():.4f} (rel {norm:.3e}), gradient cosine {cos:.6f}, "
          f"BN running stats max |diff| {stats:.3e}", flush=True)
    check(loss <= loss_tol and norm <= norm_tol and cos >= cos_min and stats <= stats_tol,
          f"{name}: outside the bars (loss {loss_tol}, norm {norm_tol}, cosine {cos_min}, stats {stats_tol})")
    return dict(loss_abs_diff=loss, grad_norm_rel_diff=norm, grad_cosine=cos, bn_stats_max_diff=stats)


@contextlib.contextmanager
def recorded_keypoints(module, record, key):
    """Record under ``record[key]`` the keypoints a ``MatchingModule``'s
    forward passes give its matcher: [side 0, side 1] of its last call."""
    def hook(_, args, out):
        record[key] = [out[1].side0.keypoints.detach(), out[1].side1.keypoints.detach()]

    handle = module.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@contextlib.contextmanager
def f32_ground_truth():
    """The online step's ground truth computed in f32 whatever its inputs'
    type, as tests/test_torch_data_parallel.py's f64 step computes it: the
    homography shifts by whole pixels onto the positive threshold, where f64
    rounds other pairs in than f32 does."""
    from openglue_tpu_torch.core.types import map_tensors
    from openglue_tpu_torch.train import step as step_module

    real = step_module.generate_gt_matches
    f32 = lambda t: t.to(torch.float32) if torch.is_tensor(t) and t.is_floating_point() else t
    step_module.generate_gt_matches = lambda *args, **kwargs: real(
        *[map_tensors(a, f32) for a in args], **{k: f32(v) for k, v in kwargs.items()})
    try:
        yield
    finally:
        step_module.generate_gt_matches = real


@contextlib.contextmanager
def given_keypoints(keypoints):
    """SuperPoint selects ``keypoints`` ([image 0's, image 1's], in call
    order) in place of its own top-k, with their scores from its heatmap as
    its own selection reads them (zero within the border)."""
    from openglue_tpu_torch.features import superpoint

    real, calls = superpoint.select_keypoints, iter(keypoints)

    def select(scores, max_keypoints, threshold=0.0, border=4):
        kpts = next(calls).to(scores.device)
        b, h, w = scores.shape
        masked = torch.where(superpoint.remove_borders_mask(h, w, border, scores.device)[None], scores, 0.0)
        top = torch.gather(masked.reshape(b, h * w), 1, (kpts[..., 1] * w + kpts[..., 0]).long())
        return kpts.float(), top, top > threshold

    superpoint.select_keypoints = select
    try:
        yield
    finally:
        superpoint.select_keypoints = real


def distance_from_exact(model, metrics, exact, metrics_exact):
    """An f32 step's gradients against an f64 step's from the same state and
    batch: the gradient norm's relative distance, the cosine, the whole
    gradient's relative L2 distance, and the tensor farthest from its f64
    gradient by relative L2 distance (tensors whose f64 gradient is below
    1e-6 of the whole's norm, zero in exact arithmetic, are left out of that
    one) and by largest element."""
    a, b = flat_grads(model), flat_grads(exact)
    whole = b.norm().item()
    per_tensor, per_element = {}, {}
    for (name, p), (_, q) in zip(model.named_parameters(), exact.named_parameters()):
        if p.grad is None:
            continue
        diff = p.grad.double() - q.grad
        if q.grad.norm().item() >= 1e-6 * whole:
            per_tensor[name] = (diff.norm() / q.grad.norm()).item()
        per_element[name] = diff.abs().max().item()
    far = max(per_tensor, key=per_tensor.get)
    far_element = max(per_element, key=per_element.get)
    return dict(norm=abs(metrics["grad_norm"].item() / metrics_exact["grad_norm"].item() - 1),
                cos=(a @ b / (a.norm() * b.norm())).item(), rel_l2=((a - b).norm() / whole).item(),
                loss=abs(metrics["total_loss"].item() - metrics_exact["total_loss"].item()),
                farthest_tensor=far, farthest_tensor_rel_l2=per_tensor[far],
                largest_element_tensor=far_element, largest_element_diff=per_element[far_element])


def make_request(SyntheticHomographyPairs, gen, batch, n, counts0, counts1, descriptor_dim=DESCRIPTOR_DIM):
    """Synthetic pairs padded as a bucketed server pads them: keypoints beyond
    each image's valid count are zeros with mask False."""
    pairs = SyntheticHomographyPairs(num_keypoints=n, descriptor_dim=descriptor_dim).sample(gen, batch)
    dev = pairs.side0.keypoints.device
    for side, counts in ((pairs.side0, counts0), (pairs.side1, counts1)):
        valid = torch.arange(n, device=dev)[None] < torch.as_tensor(counts, device=dev)[:, None]
        side.mask = valid
        for name in ("keypoints", "descriptors", "side_info"):
            setattr(side, name, getattr(side, name) * valid[..., None])
    return pairs


def serve(model, decode_from_output, inputs):
    out = model(**inputs)
    decoded = decode_from_output(out, MATCH_THRESHOLD, inputs["mask0"], inputs["mask1"])
    return out, decoded


def compare(decode_from_output, out, ref, inputs, name):
    """The served result against the plain path's: log_P on valid entries
    (gated at 0.05 nats) and the decode, the mutual-nearest-neighbour matches
    the server returns, at the config's threshold and at threshold 0 (gated
    at 99% agreement). At random weights no score clears the 0.2 threshold
    and the assignment is nearly flat (top-two margins of ~0.015 nats), so
    threshold 0 is where the decode has content; the row-argmax agreement
    and the median margin are reported beside it."""
    rows = torch.cat([inputs["mask0"], torch.ones_like(inputs["mask0"][:, :1])], 1)
    cols = torch.cat([inputs["mask1"], torch.ones_like(inputs["mask1"][:, :1])], 1)
    valid = rows[:, :, None] & cols[:, None, :]
    scores = out["scores"]
    check(bool(torch.isfinite(scores[valid]).all()), f"{name}: non-finite log_P")
    nats = (scores - ref["scores"]).abs()[valid].max().item()
    check(nats <= LOG_P_NATS, f"{name}: log_P differs by {nats} nats from the plain path")
    m0, m1 = inputs["mask0"], inputs["mask1"]
    stats = {}
    for thr in (MATCH_THRESHOLD, 0.0):
        a = decode_from_output(out, thr, m0, m1)["matches0"]
        b = decode_from_output(ref, thr, m0, m1)["matches0"]
        stats[f"matches@{thr}"] = agree = (a == b)[m0].float().mean().item()
        check(agree >= DECODE_AGREEMENT, f"{name}: decode agreement {agree} at threshold {thr}")
    stats["row_argmax"] = (out["decode_indices0"] == ref["decode_indices0"])[m0].float().mean().item()
    inner = ref["scores"][:, :-1, :-1].masked_fill(~m1[:, None, :], float("-inf"))
    top2 = inner.topk(2, dim=2).values
    stats["median_top2_margin"] = (top2[..., 0] - top2[..., 1])[m0].median().item()
    return nats, stats


def decode_readings(decode_from_output, out, ref, inputs):
    """How far ``out`` is from ``ref``: log_P on valid entries (max and mean
    |diff| in nats), the decode at threshold 0 and the row argmax."""
    m0, m1 = inputs["mask0"], inputs["mask1"]
    rows = torch.cat([m0, torch.ones_like(m0[:, :1])], 1)
    cols = torch.cat([m1, torch.ones_like(m1[:, :1])], 1)
    valid = rows[:, :, None] & cols[:, None, :]
    check(bool(torch.isfinite(out["scores"][valid]).all()), "non-finite log_P")
    diff = (out["scores"] - ref["scores"]).abs()[valid]
    a = decode_from_output(out, 0.0, m0, m1)["matches0"]
    b = decode_from_output(ref, 0.0, m0, m1)["matches0"]
    return {
        "nats_max": diff.max().item(), "nats_mean": diff.mean().item(),
        "matches@0": (a == b)[m0].float().mean().item(),
        "row_argmax": (out["decode_indices0"] == ref["decode_indices0"])[m0].float().mean().item(),
    }


# int8 serving at random weights (a nearly flat assignment), against the int8
# plain path and against the bf16 kernel path. Bars set from the first readings
# on an H100 (700 W): row argmax 0.977-0.993, decode at threshold 0
# 0.9975-1.0, log_P within 4.4e-4 nats, for both modes and both references
INT8_ROW_ARGMAX = 0.95


def other_configs_phase(gen, card, base_model, mods, requests):
    """The matcher's other serving configurations at the flagship's width and
    depth: the three feature kinds through K6 and two int8 modes through K7.
    Returns the launches of the counted runs by configuration."""
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.models.superglue import SuperGlue

    glk, gli8, sk, decode_from_output = mods
    counters = {"K1": glk.counter, "K6": glk.feature_counter, "K7": gli8.counter, "K2": sk.counter}

    def build(**changes):
        section = dict(SUPERGLUE_SECTION)
        section["attention_gnn"] = dict(section["attention_gnn"], attention=changes.pop("attention", "softmax"))
        section.update(changes)
        cfg = superglue_config_from({"superglue": section}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
        return cfg, SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).eval()

    def counted(model, inputs, name, kernel):
        expected = {"K1": 0, "K6": 0, "K7": 0, "K2": 1, kernel: 2 * model.config.num_stages * 2}
        out, decoded, latency, delta = counted_serve(model, decode_from_output, inputs, counters, expected, name)
        return out, decoded, latency, delta[kernel]

    def report(name, model, inputs, latency, decoded, launches, kernel, notes):
        batch = inputs["kpts0"].shape[0]
        busy, kernels_by_time = device_profile(lambda: serve(model, decode_from_output, inputs))
        idle = "not measured" if busy is None else f"{1 - busy / (latency * 1e3):.3f}"
        print(f"serve {name}: {latency * 1e3:.3f} ms (median of {SERVE_REPEATS}), {batch / latency:.2f} pairs/s, "
              f"device busy {busy} ms, idle share {idle}, launches {kernel}={launches} sinkhorn=1, {notes}, "
              f"matches {int((decoded['matches0'] >= 0).sum())} [{card}]", flush=True)
        print(f"  device time by kernel, {name}: "
              + "; ".join(f"{kname} {ms:.3f} ms" for ms, kname, _ in kernels_by_time), flush=True)

    launches = {}
    big, wide, single = requests["B=16 N=1024"], requests["B=4 N=2048"], requests["B=1 N=1024 valid=1024/700"]
    for kind, cases in (("linear", (("B=16 N=1024", big), ("B=4 N=2048", wide))),
                        ("favor_relu", (("B=16 N=1024", big),)), ("favor_softmax", (("B=16 N=1024", big),))):
        _, model = build(attention=kind)
        launches[kind] = 0
        for shape, inputs in cases:
            name = f"attention={kind} {shape}"
            out, decoded, latency, count = counted(model, inputs, name, "K6")
            launches[kind] += count
            with plain_versions(glk, sk):
                ref = serve(model, decode_from_output, inputs)[0]
            nats, stats = compare(decode_from_output, out, ref, inputs, name)
            report(name, model, inputs, latency, decoded, count, "K6", f"vs plain path: {nats:.3e} nats, decode {json.dumps(stats)}")

    for mode in ("int8_static_attn", "int8"):
        _, model = build(quantize=mode)
        model.load_state_dict(base_model.state_dict(), strict=False)
        if mode.startswith("int8_static"):
            model.calibrate(**big)  # the first request calibrates
        launches[mode] = 0
        for shape, inputs in (("B=16 N=1024", big), ("B=1 N=1024", single)):
            name = f"quantize={mode} {shape}"
            out, decoded, latency, count = counted(model, inputs, name, "K7")
            launches[mode] += count
            with plain_versions(glk, sk, gli8):
                vs_plain = decode_readings(decode_from_output, out, serve(model, decode_from_output, inputs)[0], inputs)
            vs_bf16 = decode_readings(decode_from_output, out, serve(base_model, decode_from_output, inputs)[0], inputs)
            for against, got in (("int8 plain path", vs_plain), ("bf16 kernel path", vs_bf16)):
                check(got["nats_max"] <= LOG_P_NATS and got["matches@0"] >= DECODE_AGREEMENT
                      and got["row_argmax"] >= INT8_ROW_ARGMAX,
                      f"{name} vs the {against}: {got} outside the bars ({LOG_P_NATS} nats, decode "
                      f"{DECODE_AGREEMENT}, row argmax {INT8_ROW_ARGMAX})")
            report(name, model, inputs, latency, decoded, count, "K7",
                   f"vs int8 plain path {json.dumps(vs_plain)}, vs bf16 kernel path {json.dumps(vs_bf16)} "
                   f"(bars {LOG_P_NATS} nats, decode {DECODE_AGREEMENT}, row argmax {INT8_ROW_ARGMAX})")
    return launches


def train_phase(gen, card, device="cuda"):
    """The flagship training step at full width (the main training path),
    held against the plain versions and the composed path; returns the
    launches of the counted run by kernel."""
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    config = {"superglue": SUPERGLUE_SECTION, "train": TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))

    def fresh(section):
        cfg = superglue_config_from({"superglue": section}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
        model = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(1))
        return cfg, create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    def twin(state):
        model = copy.deepcopy(state.model)
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    n = MAX_KEYPOINTS
    counts = lambda: torch.randint(n // 2, n + 1, (BATCH_SIZE,), generator=gen, device=device).tolist()
    c0, c1 = counts(), counts()
    batch = make_request(SyntheticHomographyPairs, gen, BATCH_SIZE, n, c0, c1)
    cfg, state = fresh(SUPERGLUE_SECTION)
    plain = twin(state)
    first = step(state, batch)
    with plain_versions(glk, sk):
        ref = step(plain, batch)
    torch.cuda.synchronize()
    # bars from the measured agreement (loss 1.7e-5, norm 0.19%, cosine
    # 0.99981, statistics 4.4e-5; the first layer's bf16 attention half
    # rounds differently) with a margin of 5x or more
    compare_steps(state.model, plain.model, first, ref, f"train step B={BATCH_SIZE} N={n} kernels vs plain",
                  loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
    del plain

    # the main training path, its counts from 0
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter,
                "K4": glk.message_counter, "K5": glk.message_bwd_counter,
                "gemm_f32": gk.counter, "tn_gemm_f32": gk.tn_counter, "attn_bwd_bf16": ak.bf16_backward_counter}
    layers = 2 * cfg.num_stages * 2  # self + cross per stage, both images
    # the chain is f32 after the first layer: 34 f32 layers, 8 + 1 f32 GEMMs
    # each (K4, K5); the 2 bf16 K5 launches run the two bf16 attention passes each
    expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers,
                "gemm_f32": 8 * F32_MESSAGE_LAYERS, "tn_gemm_f32": F32_MESSAGE_LAYERS,
                "attn_bwd_bf16": 2 * (layers - F32_MESSAGE_LAYERS)}
    for counter in counters.values():
        counter.reset()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = {k: c.count for k, c in counters.items()}
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        delta = {k: c.count - before[k] for k, c in counters.items()}
        check(delta == expected, f"train step {i}: launches {delta}, expected {expected}")
        check(all(torch.isfinite(v).item() for v in metrics.values()), f"train step {i}: {metrics}")
        losses.append(metrics["total_loss"].item())
        if i >= TRAIN_WARMUP:
            times.append(elapsed)
    launches = {k: c.count for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, kernels_by_time = device_profile(lambda: step(state, batch), top=8)
    median = statistics.median(times)
    idle = "not measured" if busy is None else f"{1 - busy / (median * 1e3):.3f}"
    print(f"train B={BATCH_SIZE} N={n} (valid counts {min(c0 + c1)}..{max(c0 + c1)}): step "
          f"{median * 1e3:.3f} ms (median of {TRAIN_TIMED}; all {', '.join(f'{t * 1e3:.3f}' for t in times)}), "
          f"{BATCH_SIZE / median:.2f} pairs/s, peak memory {peak:.2f} GiB, device busy {busy} ms, "
          f"idle share {idle}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches per step "
          f"{json.dumps(expected)} [{card}]", flush=True)
    print("  device time by kernel, train step: "
          + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time),
          flush=True)

    # a small f32 step against the independent composed path in f64
    small = make_request(SyntheticHomographyPairs, gen, 2, 256, [256, 180], [200, 256])
    _, kernel_f32 = fresh(dict(SUPERGLUE_SECTION, chain_dtype=None))
    hold_f32_step_against_exact(kernel_f32, small, step, config, glk,
                                "f32 train step B=2 N=256 kernels vs f64 composed on its ReLU gates", **F32_STEP_BARS)
    return launches


def routes_phase(gen, card, device="cuda"):
    """The flagship training step on the model's two other routes and with
    remat: ``composed`` (K9 + K10 around the composed modules), ``half`` (K8
    forward, a torch prologue and K5 backward) and ``message`` with every layer
    checkpointed. Returns the launches of the counted runs by route."""
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    config = {"superglue": SUPERGLUE_SECTION, "train": TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))

    def fresh(section, route):
        cfg = superglue_config_from({"superglue": section}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
        model = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(1), train_route=route)
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    def twin(state, **changes):
        """The same weights in a model of another configuration."""
        model = SuperGlue(dataclasses.replace(state.model.config, **changes), device=device,
                          train_route=state.model.train_route)
        model.load_state_dict(state.model.state_dict())
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = fn()
        torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() / 2**30

    n = MAX_KEYPOINTS
    counts = lambda: torch.randint(n // 2, n + 1, (BATCH_SIZE,), generator=gen, device=device).tolist()
    batch = make_request(SyntheticHomographyPairs, gen, BATCH_SIZE, n, counts(), counts())
    small = make_request(SyntheticHomographyPairs, gen, 2, 256, [256, 180], [200, 256])
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "K8": glk.half_counter, "K9": ak.counter,
                "K10": ak.backward_counter, "gemm_f32": gk.counter, "tn_gemm_f32": gk.tn_counter,
                "attn_bwd_bf16": ak.bf16_backward_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2  # self + cross per stage, both images
    f32 = F32_MESSAGE_LAYERS  # composed: the projections are cuBLAS; half: K8 4 GEMMs, K5 5 + 1 tn
    # composed attends in f32 throughout (K10 f32); half's 2 bf16 K5 run the bf16 passes
    per_step = {"composed": {"K9": layers, "K10": layers},
                "half": {"K8": layers, "K5": layers, "gemm_f32": 9 * f32, "tn_gemm_f32": f32,
                         "attn_bwd_bf16": 2 * (layers - f32)}}
    launches = {}
    for route, kernels_of_route in per_step.items():
        state = fresh(SUPERGLUE_SECTION, route)
        plain = twin(state)
        first = step(state, batch)
        with plain_versions(glk, sk, ak=ak):
            ref = step(plain, batch)
        torch.cuda.synchronize()
        # the bars of the message route's step against its plain step
        compare_steps(state.model, plain.model, first, ref,
                      f"train step route={route} B={BATCH_SIZE} N={n} kernels vs plain",
                      loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
        del plain

        expected = {name: 0 for name in counters}
        expected.update(K2=1, K3=1, **kernels_of_route)
        for counter in counters.values():
            counter.reset()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(ROUTE_WARMUP + ROUTE_TIMED):
            before = {k: c.count for k, c in counters.items()}
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            delta = {k: c.count - before[k] for k, c in counters.items()}
            check(delta == expected, f"route={route} step {i}: launches {delta}, expected {expected}")
            check(all(torch.isfinite(v).item() for v in metrics.values()), f"route={route} step {i}: {metrics}")
            losses.append(metrics["total_loss"].item())
            if i >= ROUTE_WARMUP:
                times.append(elapsed)
        launches[route] = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, kernels_by_time = device_profile(lambda: step(state, batch), top=8)
        median = statistics.median(times)
        idle = "not measured" if busy is None else f"{1 - busy / (median * 1e3):.3f}"
        print(f"train route={route} B={BATCH_SIZE} N={n}: step {median * 1e3:.3f} ms (median of {ROUTE_TIMED}; all "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}), {BATCH_SIZE / median:.2f} pairs/s, peak memory "
              f"{peak:.2f} GiB, device busy {busy} ms, idle share {idle}, loss {first['total_loss'].item():.4f} -> "
              f"{losses[-1]:.4f}, launches per step "
              f"{json.dumps({k: v for k, v in expected.items() if v})} [{card}]", flush=True)
        print(f"  device time by kernel, train step route={route}: "
              + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time),
              flush=True)
        del state

        # a small f32 step against the composed path in f64
        route_f32 = fresh(dict(SUPERGLUE_SECTION, chain_dtype=None), route)
        hold_f32_step_against_exact(route_f32, small, step, config, glk,
                                    f"f32 train step B=2 N=256 route={route} vs f64 composed on its ReLU gates",
                                    **F32_STEP_BARS)
        del route_f32

    # remat on the message route: the same step, its activations rebuilt
    state = fresh(SUPERGLUE_SECTION, "message")
    remat = twin(state, remat=True)
    for counter in counters.values():
        counter.reset()
    m_plain, peak_plain = peak_of(lambda: step(state, batch))
    plain_counts = {k: c.count for k, c in counters.items()}
    for counter in counters.values():
        counter.reset()
    m_remat, peak_remat = peak_of(lambda: step(remat, batch))
    launches["remat"] = {k: c.count for k, c in counters.items()}
    expected = {name: 0 for name in counters}
    expected.update(K2=1, K3=1, K4=layers, K5=layers, gemm_f32=8 * f32, tn_gemm_f32=f32,
                    attn_bwd_bf16=2 * (layers - f32))
    check(plain_counts == expected, f"message step: launches {plain_counts}, expected {expected}")
    expected["K4"] = 2 * layers  # each layer's forward runs again in the backward pass
    expected["gemm_f32"] = 11 * f32
    check(launches["remat"] == expected, f"remat step: launches {launches['remat']}, expected {expected}")
    # the rebuilt forward repeats the first one's arithmetic in the same order
    compare_steps(remat.model, state.model, m_remat, m_plain, f"train step remat vs not, B={BATCH_SIZE} N={n}",
                  loss_tol=1e-5, norm_tol=1e-5, cos_min=0.99999, stats_tol=1e-6)
    times = {}
    for name, st in (("without", state), ("with", remat)):
        runs = []
        for _ in range(ROUTE_TIMED):
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(st, batch)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - start)
        times[name] = statistics.median(runs)
    busy = {name: device_profile(lambda: step(st, batch))[0] for name, st in (("without", state), ("with", remat))}
    print(f"train remat B={BATCH_SIZE} N={n} route=message: peak memory {peak_remat:.2f} GiB with remat, "
          f"{peak_plain:.2f} GiB without; step {times['with'] * 1e3:.3f} ms with, {times['without'] * 1e3:.3f} ms "
          f"without (median of {ROUTE_TIMED}); device busy {busy['with']} ms with, {busy['without']} ms without; "
          f"launches per remat step {json.dumps({k: v for k, v in expected.items() if v})} [{card}]", flush=True)
    return launches


# K2s's shapes: (batch, keypoints, K's storage). bf16 K past the card's
# shared memory (one element and four in turn at N=4352, one at N=8192, most
# of its rows spilled past the L2) and f32 K past its 1536 fused columns
WIDE_SINKHORN_SHAPES = ((1, WIDE_KEYPOINTS, torch.bfloat16), (4, WIDE_KEYPOINTS, torch.bfloat16),
                        (1, 8192, torch.bfloat16), (1, 2048, torch.float32))
# the first square shape past the wide plan's reach (bf16 K, rows spilled):
# the older streaming kernel's route
PAST_REACH_SHAPE = (1, 19184, torch.bfloat16)


def wide_plan_line(sk, name, batch, rows, cols, k_dtype):
    """Print the wide kernel's launch plan as the C code makes it (tiers,
    clusters, waves, workspace) and check it against the Python mirror."""
    found = sk.wide_kernel_plan(batch, rows, cols, k_dtype)
    check(found is not None, f"{name}: the card's C plan places nothing")
    plan, caps, sms = found
    mirror = sk.wide_launch_plan(batch, rows, cols, k_dtype, sms, caps)
    print(f"{name} plan: {plan.ctas} CTAs per element ({plan.groups} cluster(s) of {plan.cs}"
          f"{', cooperative' if plan.cooperative else ''}, exchange in {max(plan.exchange_levels, 1)} level(s)), "
          f"{plan.slots} element(s) in flight, {plan.waves} wave(s); per CTA {plan.rows} rows: {plan.smem_rows} in "
          f"shared memory, {plan.spill_rows} in device memory"
          + (f" read once per iteration through a ring of {plan.stages} rows ({plan.ring_bytes} bytes)"
             if plan.spill_rows else "")
          + f", 0 in registers; column sums in {plan.col_vecs} vectors "
          f"a thread; {plan.smem_bytes} bytes of shared memory; workspace {plan.workspace_bytes} bytes "
          f"(exchange {plan.exchange_bytes}); clusters the card holds {caps}, {sms} SMs", flush=True)
    check(plan == mirror, f"{name}: the C plan {plan} is not the Python mirror's {mirror}")
    return plan


def streaming_sinkhorn_phase(sk, gen, iters=20, extra=None):
    """K2s, the wide kernel past the fused kernel's columns, at each of
    ``WIDE_SINKHORN_SHAPES``: its plan, one launch per call (no fused or
    older streaming launch), kernel vs plain, two runs bit for bit; then the
    older streaming kernel at ``PAST_REACH_SHAPE``: its route, one forward
    through ``log_optimal_transport`` with its launches counted, kernel vs
    plain, two runs bit for bit. The first shape draws from ``gen`` what
    this phase drew before it had the others, the other wide shapes from
    ``extra`` (by default a generator of their own, seed 16) and the last
    from one of its own (seed 17), so that every later phase draws the data
    it drew before. Returns ({(batch, n, storage name): readings}, the
    streaming kernel's readings)."""
    dev = torch.device("cuda")
    extra = torch.Generator(device=dev).manual_seed(16) if extra is None else extra
    readings = {}
    counters = (sk.stream_counter, sk.counter, sk.legacy_stream_counter)
    for i, (batch, n, k_dtype) in enumerate((*WIDE_SINKHORN_SHAPES, PAST_REACH_SHAPE)):
        legacy = i == len(WIDE_SINKHORN_SHAPES)
        g = gen if i == 0 else torch.Generator(device=dev).manual_seed(17) if legacy else extra
        scores = torch.randn(batch, n, n, generator=g, device=dev) * 4
        mask0 = torch.rand(batch, n, generator=g, device=dev) > 0.1
        mask1 = torch.rand(batch, n, generator=g, device=dev) > 0.1
        rows, cols = n + 1, n + 1
        cp = sk._round_up(cols, sk.COL_ALIGN)
        kd = str(k_dtype)[6:]
        name = f"{'streaming' if legacy else 'K2s'} {kd} K B={batch} N={n}"
        route = sk.forward_route(batch, rows, cp, k_dtype)
        check(route == ("stream" if legacy else "wide"), f"{name}: route {route}")
        if legacy:
            check(sk.wide_kernel_plan(batch, rows, cp, k_dtype) is None, f"{name}: the card's wide plan places it")
            before = [c.count for c in counters]
            log_p = sk.log_optimal_transport(scores, torch.tensor(1.0, device=dev), iters, 1.0, mask0, mask1)
            torch.cuda.synchronize()
            launches = [c.count - b for c, b in zip(counters, before)]
            check(launches == [0, 0, 1], f"{name}: log_optimal_transport launches {launches}")
            check(log_p.shape == (batch, rows, cols) and bool(torch.isfinite(log_p).all()),
                  f"{name}: log_optimal_transport's output")
            del log_p
        M_pad = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
        del scores
        la, lb, _ = sk.otp_marginals(batch, n, n, mask0, mask1, dev)
        la, lb = sk.padded_marginals(la, lb, rows, cp)
        if not legacy:
            plan = wide_plan_line(sk, name, batch, rows, cp, k_dtype)
        run = lambda: sk.sinkhorn_scale(M_pad, la, lb, iters, k_dtype)
        plain = lambda: sk.sinkhorn_scale_plain(M_pad, la, lb, iters, k_dtype)
        before = [c.count for c in counters]
        u, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        expected = [0, 0, 2] if legacy else [2, 0, 0]
        check([c.count - b for c, b in zip(counters, before)] == expected, f"{name}: launches")
        check(torch.equal(u, again), f"{name}: two runs differ")
        live = la > -1e8  # masked rows sit near -1e9, where one f32 ulp is 64
        err = (u - ref).abs()[live].max().item()
        check(err <= 1e-3, f"{name}: max error {err} on live rows")  # K2's bar
        ms = device_ms(run, 5)
        plain_ms = device_ms(plain, 2)
        flops = batch * rows * cp * (4 * (iters - 1) + 2)
        nbytes = batch * (rows * cp * 4 + 2 * rows * 4 + cp * 4)
        bms, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
        print(f"{'streaming sinkhorn_scale_streaming' if legacy else 'K2s sinkhorn_wide'} K={kd} B={batch} N={n} "
              f"({cp} columns): max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), two runs equal" + (f"; launches in one log_optimal_transport {launches}"
                                                        if legacy else ""), flush=True)
        reading = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        if legacy:
            streaming = dict(reading, launches=launches[2])
        else:
            readings[(batch, n, kd)] = dict(reading, plan=dict(
                smem_rows=plan.smem_rows, spill_rows=plan.spill_rows, stages=plan.stages, clusters=plan.groups,
                cluster_size=plan.cs, waves=plan.waves, exchange_levels=plan.exchange_levels,
                workspace_bytes=plan.workspace_bytes))
        del M_pad, u, again, ref
    return readings, streaming


def counted_serve(model, decode_from_output, inputs, counters, expected, name):
    """Warm, one run with the counts from 0 (checked against ``expected``),
    then the latency: (out, decoded, median seconds, launches)."""
    serve(model, decode_from_output, inputs)
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    out, decoded = serve(model, decode_from_output, inputs)
    delta = {k: c.count for k, c in counters.items()}
    check(delta == expected, f"{name}: launches {delta}, expected {expected}")
    times = []
    for _ in range(SERVE_REPEATS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        serve(model, decode_from_output, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return out, decoded, statistics.median(times), delta


def wider_serving_phase(gen, card, model, mods):
    """Two serving requests beyond the flagship's shapes, each held against
    the plain path at the bars of the flagship phases: the matcher at the
    SIFT shape (configs/features/sift_opencv.yaml: D=128, so 4 heads of width
    32; B=4 pairs of 2048 keypoints) through K1 and K2, and one flagship pair
    of 4352 keypoints per image, whose Sinkhorn runs the wide kernel (K2s).
    Returns the launches of the counted runs."""
    glk, sk, SuperGlue = mods["glk"], mods["sk"], mods["SuperGlue"]
    decode_from_output = mods["decode_from_output"]
    counters = {"K1": glk.counter, "K2": sk.counter, "K2s": sk.stream_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2
    cfg = mods["superglue_config_from"]({"superglue": SUPERGLUE_SECTION}, SIFT_DESCRIPTOR_DIM, SIDE_INFO_DIM)
    sift = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(2)).eval()
    n = SIFT_MAX_KEYPOINTS
    counts = lambda: torch.randint(n // 2, n + 1, (4,), generator=gen, device="cuda").tolist()
    cases = (
        ("sift_opencv shape B=4 N=2048 D=128 H=4 (dh=32)", sift,
         mods["make"](gen, 4, n, counts(), counts(), descriptor_dim=SIFT_DESCRIPTOR_DIM), dict(K1=layers, K2=1, K2s=0)),
        (f"B=1 N={WIDE_KEYPOINTS} valid={WIDE_KEYPOINTS}/{WIDE_KEYPOINTS - 500}", model,
         mods["make"](gen, 1, WIDE_KEYPOINTS, [WIDE_KEYPOINTS], [WIDE_KEYPOINTS - 500]), dict(K1=layers, K2=0, K2s=1)),
    )
    launches = {}
    for name, net, pairs, expected in cases:
        inputs = mods["superglue_inputs"](pairs)
        out, decoded, latency, delta = counted_serve(net, decode_from_output, inputs, counters, expected,
                                                     f"serve {name}")
        launches[name] = delta
        with plain_versions(glk, sk):
            ref = serve(net, decode_from_output, inputs)[0]
        nats, stats = compare(decode_from_output, out, ref, inputs, name)
        batch = inputs["kpts0"].shape[0]
        busy, kernels_by_time = device_profile(lambda: serve(net, decode_from_output, inputs))
        idle = "not measured" if busy is None else f"{1 - busy / (latency * 1e3):.3f}"
        print(f"serve {name}: {latency * 1e3:.3f} ms (median of {SERVE_REPEATS}), {batch / latency:.2f} pairs/s, "
              f"device busy {busy} ms, idle share {idle}, launches {json.dumps(delta)}, vs plain path: "
              f"{nats:.3e} nats, decode {json.dumps(stats)}, matches {int((decoded['matches0'] >= 0).sum())} "
              f"[{card}]", flush=True)
        print(f"  device time by kernel, {name}: "
              + "; ".join(f"{kname} {ms:.3f} ms" for ms, kname, _ in kernels_by_time), flush=True)
    del sift
    return launches


def step_distance(model, ref_model, metrics, ref_metrics):
    """How far one training step lies from a reference step: the loss, and
    the gradient's L2 distance relative to the reference gradient's norm."""
    a, b = flat_grads(model), flat_grads(ref_model)
    return dict(loss=abs(metrics["total_loss"].item() - ref_metrics["total_loss"].item()),
                grad=((a - b).norm() / b.norm()).item(), cosine=(a @ b / (a.norm() * b.norm())).item())


def pretrain_phase(gen, card, device="cuda"):
    """One use_pallas training step at examples/pretrain_e2e_fixture.yaml's
    shape, as the fixture writes it: the flagship matcher section in bf16
    compute, SIFT descriptors (D=128, 4 heads of width 32), B=2 pairs of 2048
    keypoints, 9 stages, route ``message``, the fixture's loss and optimizer.
    Its Sinkhorn backward is past the adjoint kernel's columns and takes the
    autograd route, which the count shows. Two checks: the same step in f32
    compute, kernels against plain, within the training bars; and the bf16
    step through the kernels and through the plain versions, each against
    the plain f32 step, the kernels' distance at most BF16_DISTANCE_RATIO
    times the plain path's. Then timed steps with the counts checked.
    Returns the launches of the counted run."""
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    config = {"superglue": PRETRAIN_SECTION, "train": PRETRAIN_TRAIN_SECTION}
    step = make_train_step(loss_config_from(config))
    cfg = superglue_config_from(config, SIFT_DESCRIPTOR_DIM, SIDE_INFO_DIM)
    f32_section = {k: v for k, v in PRETRAIN_SECTION.items() if k != "dtype"}
    cfg32 = superglue_config_from({"superglue": f32_section}, SIFT_DESCRIPTOR_DIM, SIDE_INFO_DIM)

    def fresh(c=cfg):
        model = SuperGlue(c, device=device, generator=torch.Generator().manual_seed(1))
        return create_train_state(model, optimizer=optimizer_from(config, model.parameters()))

    n = SIFT_MAX_KEYPOINTS
    counts = lambda: torch.randint(n // 2, n + 1, (PRETRAIN_BATCH,), generator=gen, device=device).tolist()
    batch = make_request(SyntheticHomographyPairs, gen, PRETRAIN_BATCH, n, counts(), counts(),
                         descriptor_dim=SIFT_DESCRIPTOR_DIM)
    counters = {"K1": glk.counter, "K2": sk.counter, "K2s": sk.stream_counter, "K3": sk.adjoint_counter,
                "K4": glk.message_counter, "K5": glk.message_bwd_counter, "autograd_sinkhorn": sk.autograd_counter,
                "attn_bwd_bf16": ak.bf16_backward_counter}
    layers = 2 * cfg.num_stages * 2
    # every K5 launch is bf16 here: two bf16 attention passes each
    expected = dict({k: 0 for k in counters}, K2=1, K4=layers, K5=layers, autograd_sinkhorn=1,
                    attn_bwd_bf16=2 * layers)
    state = fresh()
    for c in counters.values():
        c.reset()
    first = step(state, batch)
    launches = {k: c.count for k, c in counters.items()}
    check(launches == expected, f"pretrain step: launches {launches}, expected {expected}")
    kernel32, plain32, plain16 = fresh(cfg32), fresh(cfg32), fresh()
    m32 = step(kernel32, batch)
    with plain_versions(glk, sk):
        ref32, ref16 = step(plain32, batch), step(plain16, batch)
    torch.cuda.synchronize()
    name = f"pretrain step B={PRETRAIN_BATCH} N={n} D=128 H=4 (dh=32)"
    compare_steps(kernel32.model, plain32.model, m32, ref32, f"{name} f32 compute, kernels vs plain",
                  loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
    d_kernel = step_distance(state.model, plain32.model, first, ref32)
    d_plain = step_distance(plain16.model, plain32.model, ref16, ref32)
    print(f"{name} bf16 compute against the plain f32 step: kernels loss |diff| {d_kernel['loss']:.3e}, "
          f"gradient distance {d_kernel['grad']:.3e}, cosine {d_kernel['cosine']:.6f}; plain loss |diff| "
          f"{d_plain['loss']:.3e}, gradient distance {d_plain['grad']:.3e}, cosine {d_plain['cosine']:.6f}; "
          f"ratio of the gradient distances {d_kernel['grad'] / d_plain['grad']:.3f} "
          f"(bar {BF16_DISTANCE_RATIO})", flush=True)
    check(d_kernel["grad"] <= BF16_DISTANCE_RATIO * d_plain["grad"],
          f"{name} bf16 compute: the kernels' gradient lies {d_kernel['grad']:.3e} from the f32 step, "
          f"more than {BF16_DISTANCE_RATIO} times the plain path's {d_plain['grad']:.3e}")
    del kernel32, plain32, plain16
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ROUTE_WARMUP + ROUTE_TIMED):
        before = {k: c.count for k, c in counters.items()}
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        delta = {k: c.count - before[k] for k, c in counters.items()}
        check(delta == expected, f"pretrain step {i}: launches {delta}, expected {expected}")
        check(all(torch.isfinite(v).item() for v in metrics.values()), f"pretrain step {i}: {metrics}")
        if i >= ROUTE_WARMUP:
            times.append(elapsed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, kernels_by_time = device_profile(lambda: step(state, batch), top=8)
    median = statistics.median(times)
    idle = "not measured" if busy is None else f"{1 - busy / (median * 1e3):.3f}"
    print(f"pretrain train B={PRETRAIN_BATCH} N={n} D=128 H=4: step {median * 1e3:.3f} ms (median of {ROUTE_TIMED}; "
          f"all {', '.join(f'{t * 1e3:.3f}' for t in times)}), {PRETRAIN_BATCH / median:.2f} pairs/s, peak memory "
          f"{peak:.2f} GiB, device busy {busy} ms, idle share {idle}, loss {first['total_loss'].item():.4f}, "
          f"launches per step {json.dumps({k: v for k, v in expected.items() if v})} [{card}]", flush=True)
    print("  device time by kernel, pretrain step: "
          + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time), flush=True)
    return launches


# examples/train_e2e_fixture.yaml's generator arguments (its header)
TRAINER_FIXTURE = dict(scenes=8, images_per_scene=12, points_per_scene=2600, image_size=(640, 480),
                       descriptor_dim=256, keep_fraction_range=(0.3, 1.0), seed=7)
# one epoch long enough for the bucket schedule to reach the 512 bucket (its
# first such batch is the 71st of the seeded sampler's stream on this fixture)
TRAINER_STEPS = 80
# training steps [first, last) run back to back without a synchronize: the
# first window under the host clock alone (the rate), the second under
# torch.profiler and the host clock (the busy time and the idle share, both
# from its own steps; the profiler's host cost is in its wall time)
TRAINER_TIMED, TRAINER_PROFILED = (10, 15), (20, 25)


# a bf16 K4 or K5 launch in the trainer: its outputs' distance from the f32
# computation on the same inputs at most this many times the plain bf16
# version's, plus one bf16 rounding
HELD_RATIO, HELD_SLACK = 1.5, 2.0**-8
MESSAGE_OUTPUTS = ("msg", "attn", "lse")
MESSAGE_GRADIENTS = ("dx_q", "dx_kv", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo")


def relative_distances(got, ref, names, norm=torch.linalg.vector_norm, order=2):
    """Each output's distance from the reference (the L2 norm, or with
    ``order=inf`` the largest entry) over the reference's; a bias gradient's
    over its weight gradient's too (dbk is zero up to cancellation)."""
    size = lambda t: norm(t.double(), ord=order).item()
    out = {}
    for i, (name, a, b) in enumerate(zip(names, got, ref)):
        scale = size(b)
        if name.startswith("db"):
            scale = max(scale, size(ref[i - 1]))
        out[name] = size(a.double() - b.double()) / scale
    return out


class HeldMessageKernels:
    """K4 and K5 as a model launches them. Each bf16 launch is held against
    the f32 computation of the same function on the same inputs (the plain
    versions in f32; K5's from the f32 forward's attn and LSE): every
    output's relative distance from it at most HELD_RATIO times the plain
    bf16 version's, plus HELD_SLACK. Each launch's largest entry-wise
    difference from the plain version in its own type, over the plain
    output's largest entry (message_phase's measure), is kept as well; the
    f32 launches only have that, since an f32 twin of the step holds their
    instantiation at train_phase's bars."""

    def __init__(self, glk):
        self.glk, self.forward_kernel, self.backward_kernel = glk, glk.message_forward, glk.message_backward
        self.launches, self.worst = collections.Counter(), collections.defaultdict(float)

    def entries(self):
        return ((self.glk, "message_forward", self.forward), (self.glk, "message_backward", self.backward))

    def _held(self, kname, dtype, n, got, plain, f32, names):
        name = str(dtype)[6:]
        key = (kname, name)
        diff = max(relative_distances(got, plain, names, order=math.inf).values())
        self.worst[key + ("vs plain",)] = max(self.worst[key + ("vs plain",)], diff)
        if f32 is not None:
            d_kernel, d_plain = relative_distances(got, f32, names), relative_distances(plain, f32, names)
            ratio = max(d_kernel[k] / (d_plain[k] + HELD_SLACK) for k in names)
            self.worst[key + ("ratio",)] = max(self.worst[key + ("ratio",)], ratio)
            failed = [k for k in names if d_kernel[k] > HELD_RATIO * d_plain[k] + HELD_SLACK]
            check(not failed, f"{kname} {name} launch {self.launches[key]} at N={n}: distance from f32 "
                  + ", ".join(f"{k} kernel {d_kernel[k]:.3e} plain {d_plain[k]:.3e}" for k in failed)
                  + f" (bar {HELD_RATIO} x plain + {HELD_SLACK})")
        self.launches[key] += 1

    def forward(self, x_q, x_kv, mask, w, heads, dtype):
        out = self.forward_kernel(x_q, x_kv, mask, w, heads, dtype)
        plain = self.glk.message_forward_plain(x_q, x_kv, mask, w, heads, dtype)
        f32 = None
        if dtype == torch.bfloat16:
            f32 = self.glk.message_forward_plain(x_q.float(), x_kv.float(), mask, w, heads, torch.float32)
        self._held("K4", dtype, x_q.shape[1], out, plain, f32, MESSAGE_OUTPUTS)
        return out

    def backward(self, x_q, x_kv, mask, w, g, attn, lse, heads, dtype):
        dxq, dxkv, dw = self.backward_kernel(x_q, x_kv, mask, w, g, attn, lse, heads, dtype)
        ref = self.glk.message_backward_plain(x_q, x_kv, mask, w, g, attn, lse, heads, dtype)
        f32 = None
        if dtype == torch.bfloat16:
            xq32, xkv32 = x_q.float(), x_kv.float()
            _, attn32, lse32 = self.glk.message_forward_plain(xq32, xkv32, mask, w, heads, torch.float32)
            f32 = self.glk.message_backward_plain(xq32, xkv32, mask, w, g.float(), attn32, lse32, heads,
                                                  torch.float32)
            f32 = [*f32[:2], *f32[2]]
        self._held("K5", dtype, x_q.shape[1], [dxq, dxkv, *dw], [*ref[:2], *ref[2]], f32, MESSAGE_GRADIENTS)
        return dxq, dxkv, dw

    def line(self):
        return "; ".join(f"{k} {t}: {self.launches[(k, t)]} launches, worst "
                         + ", ".join(f"{w} {v:.3e}" for (k2, t2, w), v in self.worst.items() if (k2, t2) == (k, t))
                         for k, t in sorted(self.launches))


class MemoryH5:
    """The h5 files of ``openglue_tpu_torch.data.io`` held in memory, keyed by
    path, with io's semantics (a dataset ``data``, or the file's one dataset,
    unless a key is given): the card machine has no h5py."""

    def __init__(self):
        self.files = {}

    def save_h5(self, path, array, key="data", compression=None, compression_opts=None):
        import numpy as np

        self.files[str(Path(path).resolve())] = {key: np.array(array)}

    def _dataset(self, path, key):
        try:
            datasets = self.files[str(Path(path).resolve())]
        except KeyError:
            raise FileNotFoundError(path) from None
        if key is not None:
            return datasets[key]
        if "data" in datasets:
            return datasets["data"]
        if len(datasets) != 1:
            raise ValueError(f"{path}: ambiguous h5 keys {list(datasets)}, pass key=")
        return next(iter(datasets.values()))

    def load_h5(self, path, key=None):
        import numpy as np

        return np.array(self._dataset(path, key))

    def h5_dataset_shape(self, path, key=None):
        return tuple(self._dataset(path, key).shape)

    def nbytes(self) -> int:
        return sum(a.nbytes for datasets in self.files.values() for a in datasets.values())

    def entries(self, io):
        """``replaced`` entries that route data.io's h5 functions here."""
        return ((io, "save_h5", self.save_h5), (io, "load_h5", self.load_h5),
                (io, "h5_dataset_shape", self.h5_dataset_shape))


@contextlib.contextmanager
def replaced(*entries):
    """Set ``(owner, name, value)`` attributes for the block, then restore
    them: an attribute the owner held itself is set back, one it took from
    its class (a method) is deleted again."""
    saved = [(owner, name, getattr(owner, name), name in getattr(owner, "__dict__", {}))
             for owner, name, _ in entries]
    for owner, name, value in entries:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value, own in reversed(saved):
            if own:
                setattr(owner, name, value)
            else:
                delattr(owner, name)


class TrainerProbe:
    """What the trainer phase reads from inside ``cli.train_cached.main``,
    through wrappers of the functions main looks up at call time: every train
    and eval step (launches, host time, bucket; a copy of the state and the
    batch of the first step of each bucket and phase), the warm-up, the
    validation sweep and each wait on a loader's ``next()``. Outside the two
    windows (TRAINER_TIMED, TRAINER_PROFILED) every train step is
    synchronized and timed alone."""

    def __init__(self, counters, train_expected, eval_expected):
        self.counters, self.train_expected, self.eval_expected = counters, train_expected, eval_expected
        self.phase = "train"
        self.step_ms, self.gap_ms, self.waits = [], [], {"train": [], "eval": []}
        self.buckets = {"warm-up": {}, "train": {}, "eval": {}}
        self.first = {}  # (phase, N) -> (state copy, batch)
        self.train_steps = 0
        self.windows = {}
        self.eval_seconds = self.eval_metrics = None
        self.eval_ms = []
        self.eval_batches = []  # batch_key of each eval batch, in order
        self._last_end = None

    def counts(self):
        return {k: c.count for k, c in self.counters.items()}

    def _checked(self, fn, expected, what):
        before = self.counts()
        out = fn()
        delta = {k: v - before[k] for k, v in self.counts().items()}
        check(delta == expected, f"trainer {what}: launches {delta}, expected {expected}")
        return out

    def make_train_step(self, real_make_train_step, clone_train_state):
        def make(loss_config):
            step = real_make_train_step(loss_config)

            def probed(state, batch):
                n = batch.side0.keypoints.shape[1]
                phase = self.phase
                self.buckets[phase][n] = self.buckets[phase].get(n, 0) + 1
                if (phase, n) not in self.first:
                    torch.cuda.synchronize()
                    self.first[(phase, n)] = (clone_train_state(state), batch)
                if phase != "train":
                    return self._checked(lambda: step(state, batch), self.train_expected, f"{phase} step N={n}")
                i = self.train_steps
                self.train_steps += 1
                window = next((w for w in (TRAINER_TIMED, TRAINER_PROFILED) if w[0] <= i < w[1]), None)
                if window is not None and i == window[0]:
                    torch.cuda.synchronize()
                    record = self.windows[window] = {"steps": window[1] - window[0]}
                    if window == TRAINER_PROFILED:
                        from torch.profiler import ProfilerActivity, profile

                        record["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        record["prof"].start()
                    record["start"] = time.perf_counter()
                start = time.perf_counter()
                if self._last_end is not None and window is None:
                    self.gap_ms.append((start - self._last_end) * 1e3)
                metrics = self._checked(lambda: step(state, batch), self.train_expected, f"train step {i} N={n}")
                if window is None or i == window[1] - 1:
                    torch.cuda.synchronize()
                end = time.perf_counter()
                if window is None:
                    self.step_ms.append(((end - start) * 1e3, n))
                elif i == window[1] - 1:
                    record = self.windows[window]
                    if "prof" in record:
                        record["prof"].stop()
                    record["wall_ms"] = (end - record["start"]) * 1e3
                self._last_end = end
                return metrics

            return probed

        return make

    def make_eval_step(self, real_make_eval_step):
        def make(match_threshold):
            step = real_make_eval_step(match_threshold)

            def probed(state, batch):
                n = batch.side0.keypoints.shape[1]
                self.buckets["eval"][n] = self.buckets["eval"].get(n, 0) + 1
                self.eval_batches.append(batch_key(batch))
                start = time.perf_counter()
                out = self._checked(lambda: step(state, batch), self.eval_expected, f"eval batch N={n}")
                torch.cuda.synchronize()
                self.eval_ms.append((time.perf_counter() - start) * 1e3)
                return out

            return probed

        return make

    def warm_up(self, real_warm_up):
        def probed(*args, **kwargs):
            self.phase = "warm-up"
            try:
                return real_warm_up(*args, **kwargs)
            finally:
                self.phase = "train"

        return probed

    def evaluate(self, real_evaluate):
        def probed(*args, **kwargs):
            self.phase = "eval"
            start = time.perf_counter()
            try:
                self.eval_metrics = real_evaluate(*args, **kwargs)
            finally:
                self.phase = "train"
            self.eval_seconds = time.perf_counter() - start
            self._last_end = None  # the sweep is not a gap between steps
            return self.eval_metrics

        return probed

    def loader_iter(self, real_iter):
        probe = self

        def probed(loader):
            it = real_iter(loader)
            while True:
                start = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                probe.waits["eval" if probe.phase == "eval" else "train"].append((time.perf_counter() - start) * 1e3)
                yield batch

        return probed


def batch_key(batch):
    """A batch's shape and its pairs, in order: (N, each pair's relative
    pose as bytes)."""
    tf = batch.transformation
    poses = torch.cat([tf.R.flatten(1), tf.T], 1).cpu().numpy()
    return batch.side0.keypoints.shape[1], tuple(row.tobytes() for row in poses)


def sync_sites(fn):
    """The host synchronizations that ``fn`` makes (torch.cuda's sync debug
    mode), counted by the innermost line of the port that made each."""
    import traceback
    import warnings

    sites = collections.Counter()

    running = []  # set while fn runs: setting the debug mode may warn itself

    def record(message, category, filename, lineno, file=None, line=None):
        if not running or "synchroniz" not in str(message):  # not fn's, or not the sync debug mode's
            return
        frames = [f for f in traceback.extract_stack() if "openglue_tpu_torch" in f.filename]
        where = (f"{frames[-1].filename.split('openglue_tpu_torch/')[-1]}:{frames[-1].lineno}"
                 if frames else f"{Path(filename).name}:{lineno}")
        sites[where] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        running.append(True)
        try:
            fn()
        finally:
            running.clear()
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def trainer_override(root: Path, logs: Path, steps: int, val_pairs_per_scene: int) -> dict:
    """The trainer phases' override of configs/config_cached_sp_magicleap.yaml:
    the fixture under ``root``, one epoch of ``steps`` steps and a
    validation of ``val_pairs_per_scene`` pairs of each validation scene.
    The device-resident descriptor cache stays as the config writes it (512
    slots of 2048 rows)."""
    return {
        "data": {"root_path": str(root), "features_dir": "SyntheticSphere_640_480",
                 "train_list_path": "assets/megadepth_train.txt",
                 "val_list_path": "assets/megadepth_valid.txt",
                 "dataloader_workers": 4,
                 # the fixture's images are 640x480, smaller than the flagship's 960x720
                 "target_size": [640, 480], "val_max_pairs_per_scene": val_pairs_per_scene},
        "logging": {"root_path": str(logs)},
        "train": {"epochs": 1, "steps_per_epoch": steps},
    }


def trainer_phase(card, repo: Path, store: "MemoryH5", work: Path, device="cuda"):
    """The port's cached-feature trainer end to end: ``cli.train_cached.main``
    on the MegaDepth-format fixture at examples/train_e2e_fixture.yaml's
    generator arguments, with configs/config_cached_sp_magicleap.yaml (the
    flagship: D=256, 9 stages, B=12, max 1024 keypoints, buckets 256/512/1024
    grouped) and an override naming the fixture, one epoch of TRAINER_STEPS steps and a
    validation sweep of 48 pairs. data.io's three h5 functions are an
    in-memory store (``MemoryH5``); the pairs lists, configs, logging
    directory and checkpoints are files. The config's device-resident
    descriptor cache (512 slots of 2048 rows of 256) holds the descriptors;
    its hits, misses and copied bytes are printed. Checks: the cache as the
    config writes it, 36 K4 + 36 K5 + 1 K2 + 1 K3
    per train step and no autograd-route Sinkhorn backward, 36 K1 + 1 K2 per
    eval batch; the first step of each bucket (warm-up and training) from a
    copy of the state, kernels against plain: in the run's bf16 chain every
    bf16 K4 and K5 launch by its distance from the f32 computation on its
    inputs (``HeldMessageKernels``) and the step by its distance from the
    plain f32 step (pretrain_phase's rule), in an f32 chain at train_phase's
    bars; a
    restore from the checkpoint equal to the trained state, whose next two
    steps on one batch give bit-equal losses; and a resume through the entry
    point (``--checkpoint``). ``store`` holds the h5 files and ``work`` the
    other files; both outlive the phase (the serving phase evaluates the
    trained experiment on the same fixture). Returns the launches of the run
    by kernel and what the serving phase reads: the experiment's directory,
    its checkpoint step, and the metrics and batches (``batch_key``) of
    fit's validation sweep."""
    import yaml

    from openglue_tpu_torch.cli import common, train_cached
    from openglue_tpu_torch.data import device_cache, fixture, io
    from openglue_tpu_torch.data import loader as loader_mod
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train import checkpoint, loop
    from openglue_tpu_torch.train import step as step_mod
    from openglue_tpu_torch.train.state import clone_train_state, create_train_state

    with replaced(*store.entries(io)):
        print("trainer: openglue_tpu_torch.data.io's save_h5, load_h5 and h5_dataset_shape replaced by an "
              "in-memory store for this phase (no h5py on this machine); everything else is files under "
              f"{work}", flush=True)
        root = work / "megadepth"
        start = time.perf_counter()
        stats = fixture.generate_megadepth_fixture(root, **TRAINER_FIXTURE)
        print(f"trainer fixture: {len(stats['scenes'])} scenes, {stats['pairs']} pairs, "
              f"{len(store.files)} h5 files, {store.nbytes() / 2**20:.1f} MiB in memory, "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        override = trainer_override(root, work / "logs", TRAINER_STEPS, val_pairs_per_scene=24)
        (work / "override.yaml").write_text(yaml.safe_dump(override))
        base = repo / "configs" / "config_cached_sp_magicleap.yaml"
        argv = ["--config", str(base), "--config_override", str(work / "override.yaml"), "--device", device]
        config = common.load_merged_config(str(base), str(work / "override.yaml"))
        counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter,
                    "K4": glk.message_counter, "K5": glk.message_bwd_counter,
                    "autograd_sinkhorn": sk.autograd_counter}
        layers = 2 * int(config.get("superglue.attention_gnn.num_stages")) * 2
        train_expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers, "autograd_sinkhorn": 0}
        eval_expected = {"K1": layers, "K2": 1, "K3": 0, "K4": 0, "K5": 0, "autograd_sinkhorn": 0}
        probe = TrainerProbe(counters, train_expected, eval_expected)
        real_step = step_mod.make_train_step
        probes = ((step_mod, "make_train_step", probe.make_train_step(real_step, clone_train_state)),
                  (step_mod, "make_eval_step", probe.make_eval_step(step_mod.make_eval_step)),
                  (loop, "warm_up_buckets", probe.warm_up(loop.warm_up_buckets)),
                  (loop, "evaluate", probe.evaluate(loop.evaluate)),
                  (loader_mod.DataLoader, "__iter__", probe.loader_iter(loader_mod.DataLoader.__iter__)))
        cache_record = CacheRecord()
        for counter in counters.values():
            counter.reset()
        start = time.perf_counter()
        with replaced(*probes, *cache_record.entries(device_cache)):
            state = train_cached.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - start
        launches = {k: c.count for k, c in counters.items()}
        print_cache_run(cache_record, config, card, "trainer")

        # ---- the readings of the run
        check(state.step == TRAINER_STEPS, f"trainer: state.step {state.step}, expected {TRAINER_STEPS}")
        check(probe.train_steps == TRAINER_STEPS and set(probe.windows) == {TRAINER_TIMED, TRAINER_PROFILED},
              f"trainer: the probe saw {probe.train_steps} of {TRAINER_STEPS} train steps: main() no longer "
              f"looks up make_train_step in train.step when it runs")
        step_ms = statistics.median(ms for ms, _ in probe.step_ms)
        by_bucket = {n: statistics.median(ms for ms, m in probe.step_ms if m == n)
                     for n in sorted({m for _, m in probe.step_ms})}
        timed, profiled = probe.windows[TRAINER_TIMED], probe.windows[TRAINER_PROFILED]
        busy, kernels_by_time = kernel_rows(profiled["prof"], top=6)
        per_step = timed["wall_ms"] / timed["steps"]
        profiled_step = profiled["wall_ms"] / profiled["steps"]
        busy_step = "not measured" if busy is None else f"{busy / profiled['steps']:.3f}"
        idle = "not measured" if busy is None else f"{1 - busy / profiled['wall_ms']:.3f}"
        waits = probe.waits["train"]
        batch = int(config.get("data.batch_size"))
        buckets = "/".join(str(b) for b in config.get("data.buckets"))
        print(f"trainer B={batch} buckets {buckets} grouped: {probe.train_steps} steps in {run_s:.1f} s "
              f"(main() whole: fixture files, warm-up, steps, validation, checkpoint); step "
              f"{step_ms:.3f} ms (median of {len(probe.step_ms)} synchronized steps; by bucket "
              f"{json.dumps({n: round(v, 3) for n, v in by_bucket.items()})}), {batch / step_ms * 1e3:.2f} "
              f"pairs/s; steps {TRAINER_TIMED[0]}-{TRAINER_TIMED[1] - 1} back to back: {per_step:.3f} ms per "
              f"step, {batch / per_step * 1e3:.2f} pairs/s; steps {TRAINER_PROFILED[0]}-"
              f"{TRAINER_PROFILED[1] - 1} back to back under the profiler: {profiled_step:.3f} ms per step, "
              f"device busy {busy_step} ms per step, idle share {idle} (both of these steps); loader next() "
              f"wait median {statistics.median(waits):.3f} ms "
              f"(max {max(waits):.3f}, {len(waits)} batches); host time between synchronized steps median "
              f"{statistics.median(probe.gap_ms):.3f} ms; batches per bucket: train "
              f"{json.dumps(probe.buckets['train'])}, warm-up {json.dumps(probe.buckets['warm-up'])}, eval "
              f"{json.dumps(probe.buckets['eval'])}; launches per train step {json.dumps(train_expected)}, "
              f"per eval batch {json.dumps(eval_expected)} [{card}]", flush=True)
        print(f"  device time by kernel, trainer steps {TRAINER_PROFILED[0]}-{TRAINER_PROFILED[1] - 1}: "
              + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time),
              flush=True)
        metrics = probe.eval_metrics
        check(metrics is not None and all(math.isfinite(v) for v in metrics.values()),
              f"trainer validation: {metrics}")
        print(f"trainer validation: {sum(probe.buckets['eval'].values())} batches, "
              f"{probe.eval_seconds:.2f} s (eval steps median {statistics.median(probe.eval_ms):.3f} ms, "
              f"loader wait median {statistics.median(probe.waits['eval']):.3f} ms), "
              f"{json.dumps(metrics)} [{card}]", flush=True)

        # ---- the first step of each bucket, kernels against plain. The
        # run's chain is bf16, which the kernels and the plain versions
        # round differently, each as validly: every bf16 K4 and K5 launch
        # of the step is held against the f32 computation on its inputs
        # (HeldMessageKernels), and the step as pretrain_phase
        # holds bf16 compute, by its gradient's distance from the plain
        # f32 step (at most BF16_DISTANCE_RATIO times the plain bf16
        # step's); the same state and batch in an f32 chain, kernels
        # against plain, at train_phase's bars.
        def twin(saved, **changes):
            model = SuperGlue(dataclasses.replace(saved.model.config, **changes), device=device)
            model.load_state_dict(saved.model.state_dict())
            return create_train_state(model, optimizer=common.optimizer_from(config, model.parameters()))

        step = real_step(common.loss_config_from(config))
        for (phase, n), (saved, first_batch) in sorted(probe.first.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            name = f"trainer first {phase} step N={n}"
            kernel, plain = clone_train_state(saved), clone_train_state(saved)
            kernel32, plain32 = twin(saved, chain_dtype=None), twin(saved, chain_dtype=None)
            held = HeldMessageKernels(glk)
            with replaced(*held.entries()):
                m_kernel = step(kernel, first_batch)
            check(sum(v for (k, _), v in held.launches.items() if k == "K4") == layers
                  and sum(v for (k, _), v in held.launches.items() if k == "K5") == layers
                  and held.launches[("K4", "bfloat16")] > 0 and held.launches[("K5", "bfloat16")] > 0,
                  f"{name}: held launches {dict(held.launches)}")
            print(f"{name} bf16 chain, each launch on its inputs: largest difference from the plain "
                  f"version in its type over the plain's largest entry ('vs plain'); bf16 launches: "
                  f"distance from f32 over the plain bf16 version's plus {HELD_SLACK} ('ratio', bar "
                  f"{HELD_RATIO}): {held.line()}", flush=True)
            m_kernel32 = step(kernel32, first_batch)
            with plain_versions(glk, sk):
                m_plain, m_plain32 = step(plain, first_batch), step(plain32, first_batch)
            torch.cuda.synchronize()
            compare_steps(kernel32.model, plain32.model, m_kernel32, m_plain32,
                          f"{name} f32 chain, kernels vs plain",
                          loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
            d = step_distance(kernel.model, plain.model, m_kernel, m_plain)
            d_kernel = step_distance(kernel.model, plain32.model, m_kernel, m_plain32)
            d_plain = step_distance(plain.model, plain32.model, m_plain, m_plain32)
            print(f"{name} bf16 chain (the run's): kernels vs plain loss |diff| {d['loss']:.3e}, gradient "
                  f"distance {d['grad']:.3e}, cosine {d['cosine']:.6f}; against the plain f32 step: kernels "
                  f"{d_kernel['grad']:.3e} (cosine {d_kernel['cosine']:.6f}), plain {d_plain['grad']:.3e} "
                  f"(cosine {d_plain['cosine']:.6f}), ratio {d_kernel['grad'] / d_plain['grad']:.3f} "
                  f"(bar {BF16_DISTANCE_RATIO})", flush=True)
            check(d_kernel["grad"] <= BF16_DISTANCE_RATIO * d_plain["grad"],
                  f"{name} bf16 chain: the kernels' gradient lies {d_kernel['grad']:.3e} from the f32 step, "
                  f"more than {BF16_DISTANCE_RATIO} times the plain path's {d_plain['grad']:.3e}")
            del kernel, plain, kernel32, plain32
        check({n for phase, n in probe.first if phase == "warm-up"} == {256, 512, 1024},
              f"trainer warm-up buckets {sorted(probe.first)}")

        # ---- the checkpoint, a restore and a resume
        ckpt_dir = next((work / "logs").glob("*/*/checkpoints"))
        path = checkpoint.checkpoint_path(ckpt_dir, checkpoint.latest_step(ckpt_dir))
        model = SuperGlue(state.model.config, device=device, generator=torch.Generator().manual_seed(5))
        restored = checkpoint.restore_train_state(
            ckpt_dir, create_train_state(model, optimizer=common.optimizer_from(config, model.parameters())))
        check(restored.step == state.step, f"trainer restore: step {restored.step} vs {state.step}")
        trained = state.model.state_dict()
        check(all(torch.equal(v, trained[k]) for k, v in restored.model.state_dict().items()),
              "trainer restore: the model differs from the trained one")
        _, resume_batch = probe.first[max(k for k in probe.first if k[0] == "train")]
        copy_ = clone_train_state(state)
        losses = [(step(copy_, resume_batch)["total_loss"], step(restored, resume_batch)["total_loss"])
                  for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in losses), f"trainer resume: losses {losses}")
        print(f"trainer checkpoint {path} ({path.stat().st_size / 2**20:.1f} MiB): restored state equal to "
              f"the trained one; two steps from each on one batch: total loss "
              f"{', '.join(f'{a.item():.6f}' for a, _ in losses)}, bit-equal", flush=True)
        # ---- the host synchronizations inside one train step and one eval step
        eval_step = step_mod.make_eval_step(float(config.get("inference.match_threshold", 0.2)))
        for what, fn in (("train step", lambda: step(copy_, resume_batch)),
                         ("eval step", lambda: eval_step(copy_, resume_batch))):
            sites = sync_sites(fn)
            print(f"trainer {what} N={resume_batch.side0.keypoints.shape[1]}: {sum(sites.values())} host "
                  f"synchronizations ({', '.join(f'{n} at {w}' for w, n in sites.most_common())})", flush=True)
        resume_override = dict(override, train={"epochs": 1, "steps_per_epoch": 2})
        (work / "resume.yaml").write_text(yaml.safe_dump(resume_override))
        resumed = train_cached.main(["--config", str(base), "--config_override", str(work / "resume.yaml"),
                                     "--checkpoint", str(ckpt_dir), "--device", device])
        check(resumed.step == state.step + 2, f"trainer --checkpoint: step {resumed.step}")
        print(f"trainer resume through --checkpoint: step {state.step} -> {resumed.step}", flush=True)
    return launches, dict(experiment=ckpt_dir.parent, step=int(state.step), eval_metrics=metrics,
                          eval_batches=probe.eval_batches)


def nbytes(batch) -> int:
    """The bytes of every tensor of a batch (or of a tensor)."""
    from openglue_tpu_torch.core.types import map_tensors

    total = []
    map_tensors(batch, lambda t: total.append(t.numel() * t.element_size()) or t)
    return sum(total)


class CacheRecord:
    """``replaced`` entries (``entries``) under which every
    ``DeviceDescriptorCache`` that ``cli.train_cached.main`` builds records
    itself and, for each ``DeviceDescBatch`` it moves, the bytes that went
    to the card (the light fields, the index tensors and the missed blocks),
    the hits, the misses and the host time of the call."""

    def __init__(self):
        self.caches, self.calls = [], []

    def entries(self, device_cache):
        from openglue_tpu_torch.data.collate import DeviceDescBatch

        record = self

        class Recorded(device_cache.DeviceDescriptorCache):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                record.caches.append(self)

            def to_device(self, item):
                before = (self.bytes_copied, self.hits, self.misses)
                start = time.perf_counter()
                out = super().to_device(item)
                if isinstance(item, DeviceDescBatch):
                    record.calls.append(dict(
                        bytes=nbytes(item.batch) + nbytes(item.index0) + nbytes(item.index1)
                        + self.bytes_copied - before[0], hits=self.hits - before[1], misses=self.misses - before[2],
                        ms=(time.perf_counter() - start) * 1e3))
                return out

        return ((device_cache, "DeviceDescriptorCache", Recorded),)


def print_cache_run(record: CacheRecord, config, card, name):
    """Check that the run kept the config's cache, and print what it did."""
    slots, cap = int(config.get("data.device_descriptor_cache")), int(config.get("data.device_cache_cap"))
    check(len(record.caches) == 1 and record.caches[0].slots == slots and record.caches[0].cap == cap,
          f"{name}: caches {[(c.slots, c.cap) for c in record.caches]}, expected one of {slots} x {cap}")
    cache = record.caches[0]
    total = cache.hits + cache.misses
    sent = [c["bytes"] for c in record.calls]
    print(f"{name} device descriptor cache: {cache.slots} slots x {cache.cap} x {cache.dim} {str(cache.dtype)[6:]} "
          f"({cache.cache.numel() * cache.cache.element_size() / 2**20:.0f} MiB on the card), {cache.hits} hits and "
          f"{cache.misses} misses over {len(record.calls)} batches (hit rate {cache.hits / max(total, 1):.4f}), "
          f"{len(cache.slot_of)} slots in use, {cache.bytes_copied / 2**20:.1f} MiB of blocks copied; bytes to the "
          f"card per batch (light fields, indices, missed blocks) mean {statistics.mean(sent):.0f}, median "
          f"{statistics.median(sent):.0f}; to_device host ms median {statistics.median(c['ms'] for c in record.calls):.3f} "
          f"[{card}]", flush=True)


def seeded_collates(seed: int):
    """``replaced`` entries under which both collates of data/collate.py draw
    from one generator seeded with ``seed``: with one loader thread, host
    mode and the device cache's collate pick the same rows of the same
    samples."""
    import numpy as np

    from openglue_tpu_torch.data import collate

    rng = np.random.default_rng(seed)
    return tuple((collate, name, lambda samples, _real=getattr(collate, name), **kw: _real(samples, rng=rng, **kw))
                 for name in ("stack_keypoints_batch", "stack_keypoints_batch_device"))


# the device-cache twin (cache_twin_phase): the flagship trainer in host mode
# and with the cache, TWIN_STEPS steps each on the same rows
TWIN_STEPS = 4


def run_trainer_mode(argv, counters, expected, name):
    """``cli.train_cached.main(argv)`` with seeded collates: per train step the
    loss and gradient norm, the launches (held to ``expected``), the
    synchronized step time, the descriptors the step saw, the parameters
    after it and the bytes of the batch; the train loader's waits; the
    CacheRecord. Returns (state, steps, waits, cache record)."""
    from openglue_tpu_torch.cli import train_cached
    from openglue_tpu_torch.data import device_cache
    from openglue_tpu_torch.train import step as step_mod

    steps, waits, cache_record = [], [], CacheRecord()
    real_make, real_build = step_mod.make_train_step, train_cached.build_dataloaders

    def make(loss_config):
        step = real_make(loss_config)

        def probed(state, batch):
            torch.cuda.synchronize()
            before = {k: c.count for k, c in counters.items()}
            start = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            delta = {k: c.count - before[k] for k, c in counters.items()}
            check(delta == expected, f"{name} step {len(steps)}: launches {delta}, expected {expected}")
            steps.append(dict(loss=metrics["total_loss"].item(), norm=metrics["grad_norm"].item(), ms=ms,
                              n=batch.side0.keypoints.shape[1], bytes=nbytes(batch),
                              desc=(batch.side0.descriptors.clone(), batch.side1.descriptors.clone()),
                              params=torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])))
            return metrics

        return probed

    def build(*args, **kwargs):
        train_loader, val_fn = real_build(*args, **kwargs)

        def timed():
            it = iter(train_loader)
            while True:
                start = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - start) * 1e3)
                yield batch

        return timed(), val_fn

    with replaced(*seeded_collates(0), (step_mod, "make_train_step", make), (train_cached, "build_dataloaders", build),
                  *cache_record.entries(device_cache)):
        state = train_cached.main(argv)
    check(len(steps) == TWIN_STEPS, f"{name}: {len(steps)} steps")
    return state, steps, waits, cache_record


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, so that +0.0 and -0.0 differ."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def cache_twin_phase(card, repo: Path, store: "MemoryH5", work: Path, device="cuda"):
    """The flagship trainer (configs/config_cached_sp_magicleap.yaml on the
    trainer phase's fixture) twice from the same seeded weights and on the
    same rows: in host mode (device_descriptor_cache 0: the descriptors ride
    every batch) and with the device-resident descriptor cache as the config
    writes it (512 slots of 2048 rows; a batch carries row indices). One
    loader thread and one seeded generator for both collates make the rows
    the same; no warm-up. Checks: the descriptors each step sees, the
    losses, the gradient norms and the parameters after each of TWIN_STEPS
    steps bit for bit, the final states (running statistics included), and
    36 K4 + 36 K5 + 1 K2 + 1 K3 per step in both. Prints each mode's bytes
    sent to the card per step, loader wait (one thread: reading, collate and
    pinning) and step time, and the cache's hits and misses. Returns the
    launches of both runs by kernel."""
    import yaml

    from openglue_tpu_torch.cli import common
    from openglue_tpu_torch.data import io
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk

    start = time.perf_counter()
    base = repo / "configs" / "config_cached_sp_magicleap.yaml"
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "autograd_sinkhorn": sk.autograd_counter}
    for counter in counters.values():
        counter.reset()
    runs = {}
    with replaced(*store.entries(io)):
        for mode in ("host", "device"):
            override = trainer_override(work / "megadepth", work / f"logs_twin_{mode}", TWIN_STEPS,
                                        val_pairs_per_scene=1)
            override["data"]["dataloader_workers"] = 0
            override["train"]["precompile_buckets"] = False
            if mode == "host":
                override["data"]["device_descriptor_cache"] = 0
            (work / f"twin_{mode}.yaml").write_text(yaml.safe_dump(override))
            argv = ["--config", str(base), "--config_override", str(work / f"twin_{mode}.yaml"), "--device", device]
            config = common.load_merged_config(str(base), str(work / f"twin_{mode}.yaml"))
            layers = 2 * int(config.get("superglue.attention_gnn.num_stages")) * 2
            expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers, "autograd_sinkhorn": 0}
            runs[mode] = (config, *run_trainer_mode(argv, counters, expected, f"cache twin {mode}"))
    (_, host_state, host, host_waits, _), (config, dev_state, dev, dev_waits, record) = runs["host"], runs["device"]
    print_cache_run(record, config, card, "cache twin")
    for i, (a, b) in enumerate(zip(host, dev)):
        same = dict(descriptors=all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
                                    for x, y in zip(a["desc"], b["desc"])),
                    loss=a["loss"] == b["loss"], norm=a["norm"] == b["norm"],
                    parameters=torch.equal(bits(a["params"]), bits(b["params"])))
        print(f"cache twin step {i} N={a['n']}: host mode loss {a['loss']!r} norm {a['norm']!r}; cache loss "
              f"{b['loss']!r} norm {b['norm']!r}; bit-equal: {json.dumps(same)}; bytes to the card: host mode "
              f"{a['bytes']} (descriptors {sum(nbytes(d) for d in a['desc'])}), cache {record.calls[i]['bytes']} "
              f"({record.calls[i]['misses']} misses, {record.calls[i]['hits']} hits); step ms host mode "
              f"{a['ms']:.3f}, cache {b['ms']:.3f} [{card}]", flush=True)
        check(all(same.values()), f"cache twin step {i}: not bit-equal: {same}")
    final = dev_state.model.state_dict()
    check(all(torch.equal(bits(v), bits(final[k])) for k, v in host_state.model.state_dict().items()
              if v.is_floating_point()), "cache twin: the final states differ")
    print(f"cache twin: {TWIN_STEPS} steps in each mode bit-equal (descriptors, losses, gradient norms, parameters, "
          f"final state with running statistics); bytes to the card per train step: host mode "
          f"{statistics.mean(s['bytes'] for s in host):.0f}, cache "
          f"{statistics.mean(c['bytes'] for c in record.calls[:TWIN_STEPS]):.0f}; loader wait median (one loader "
          f"thread: reading, collate, pinning) host mode {statistics.median(host_waits):.3f} ms, cache "
          f"{statistics.median(dev_waits):.3f} ms; step median host mode "
          f"{statistics.median(s['ms'] for s in host):.3f} ms, cache {statistics.median(s['ms'] for s in dev):.3f} ms; "
          f"the phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return {k: c.count for k, c in counters.items()}


# the checkify phase (checkify_phase): cli.train_cached --checkify in a process
# of its own under coreutils' timeout
CHECKIFY_STEPS = 2
CHECKIFY_TIMEOUT = 300  # seconds


def checkify_child(work: str) -> None:
    """The checkify phase's process: ``cli.train_cached.main`` with
    ``--checkify`` for CHECKIFY_STEPS steps on the trainer phase's fixture
    (the h5 store the phase saved), each step's launches counted and the
    state and batch it started from kept; each step again unchecked from
    that state on that batch; then the checked step on a batch with a NaN in
    one valid descriptor row, and on the first batch with a NaN planted in
    the input of the first K4 launch. Writes ``checkify.json``."""
    from torch.utils._python_dispatch import _disable_current_modes

    from openglue_tpu_torch import debugging
    from openglue_tpu_torch.cli import common, train_cached
    from openglue_tpu_torch.core.types import KeypointSet, PairBatch
    from openglue_tpu_torch.data import io
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train import step as step_mod
    from openglue_tpu_torch.train.state import clone_train_state

    work = Path(work)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = MemoryH5()
    store.files = torch.load(work / "store.pt", weights_only=False)
    argv = json.loads((work / "checkify_argv.json").read_text())
    config = common.load_merged_config(argv[1], argv[3])
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "autograd_sinkhorn": sk.autograd_counter}
    counts = lambda: {k: c.count for k, c in counters.items()}
    out = dict(steps=[], replays=[])
    kept, wrappers = [], []
    real_make, real_checked = step_mod.make_train_step, debugging.checked

    def checked(fn, *args, **kwargs):
        wrapper = real_checked(fn, *args, **kwargs)
        wrappers.append(wrapper)
        return wrapper

    def make(loss_config):
        step = real_make(loss_config)

        def probed(state, batch):
            saved = clone_train_state(state)
            torch.cuda.synchronize()
            before, start = counts(), time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            out["steps"].append(dict(loss=metrics["total_loss"].item(), norm=metrics["grad_norm"].item(),
                                     launches={k: v - before[k] for k, v in counts().items()},
                                     ms=(time.perf_counter() - start) * 1e3, n=batch.side0.keypoints.shape[1]))
            kept.append((saved, batch))
            return metrics

        return probed

    start = time.perf_counter()
    with replaced(*store.entries(io), (step_mod, "make_train_step", make), (debugging, "checked", checked)):
        state = train_cached.main(argv + ["--checkify"])
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - start
    out["state_step"] = int(state.step)
    # the checked wrapper main built wraps the probed step: its last call's ops
    seen = wrappers[0].seen if wrappers else collections.Counter()
    out["ops"] = sum(seen.values())
    out["backward_ops"] = sum(v for k, v in seen.items() if k.endswith("_backward"))
    out["op_kinds"] = len(seen)

    plain = real_make(common.loss_config_from(config))
    for saved, batch in kept:
        before, start = counts(), time.perf_counter()
        metrics = plain(clone_train_state(saved), batch)
        torch.cuda.synchronize()
        out["replays"].append(dict(loss=metrics["total_loss"].item(), norm=metrics["grad_norm"].item(),
                                   launches={k: v - before[k] for k, v in counts().items()},
                                   ms=(time.perf_counter() - start) * 1e3))

    saved, batch = kept[0]
    mask = batch.side0.mask[0]
    row = int(mask.nonzero()[0, 0])
    desc = batch.side0.descriptors.clone()
    desc[0, row, 0] = float("nan")
    s0 = batch.side0
    bad = PairBatch(KeypointSet(s0.keypoints, desc, s0.side_info, s0.mask, s0.image_size), batch.side1,
                    batch.transformation)
    real_forward = glk.message_forward

    def planted(x_q, *args, **kwargs):  # a NaN in the input of every K4 launch, put there unseen by the mode
        with _disable_current_modes():
            x_q = x_q.clone()
            x_q[0, 0, 0] = float("nan")
        return real_forward(x_q, *args, **kwargs)

    for what, case, entries in (("descriptor", bad, ()), ("k4_input", batch, ((glk, "message_forward", planted),))):
        start = time.perf_counter()
        out[what] = None
        try:
            with replaced(*entries):
                real_checked(plain)(clone_train_state(saved), case)
        except debugging.CheckError as exc:
            out[what] = str(exc)
        torch.cuda.synchronize()
        out[f"{what}_ms"] = (time.perf_counter() - start) * 1e3
    out["descriptor_row"] = row
    (work / "checkify.json").write_text(json.dumps(out))


def checkify_phase(card, repo: Path, store: "MemoryH5", work: Path, device="cuda"):
    """``cli.train_cached --checkify`` (``checkify_child``, in a process of
    its own under coreutils' ``timeout``) on the flagship config with the
    cache as written, CHECKIFY_STEPS steps and a validation of one pair a
    scene. Checks: the checked steps' launches are the unchecked step's (36
    K4 + 36 K5 + 1 K2 + 1 K3), each step's loss and gradient norm equal the
    unchecked step's from the same state on the same batch, the dispatch
    mode saw the backward's ops, a NaN in one valid descriptor row raises
    naming an aten op, and a NaN in K4's input raises naming K4. Returns the
    launches of the checked steps by kernel."""
    import yaml

    from openglue_tpu_torch.cli import common
    from openglue_tpu_torch.data import fixture, io

    start = time.perf_counter()
    base = repo / "configs" / "config_cached_sp_magicleap.yaml"
    if not store.files:  # run alone: the trainer phase's fixture
        with replaced(*store.entries(io)):
            fixture.generate_megadepth_fixture(work / "megadepth", **TRAINER_FIXTURE)
    if not (work / "store.pt").exists():
        torch.save(store.files, work / "store.pt")
    override = trainer_override(work / "megadepth", work / "logs_checkify", CHECKIFY_STEPS, val_pairs_per_scene=1)
    (work / "checkify.yaml").write_text(yaml.safe_dump(override))
    argv = ["--config", str(base), "--config_override", str(work / "checkify.yaml"), "--device", device]
    (work / "checkify_argv.json").write_text(json.dumps(argv))
    config = common.load_merged_config(str(base), str(work / "checkify.yaml"))
    layers = 2 * int(config.get("superglue.attention_gnn.num_stages")) * 2
    expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers, "autograd_sinkhorn": 0}
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(repo)
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import chip_smoke; "
            f"chip_smoke.checkify_child({str(work)!r})")
    done = subprocess.run(["timeout", "-k", "10", str(CHECKIFY_TIMEOUT), sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    took = time.perf_counter() - start
    check(done.returncode == 0, f"checkify: exit {done.returncode} after {took:.1f} s:\n{done.stdout[-3000:]}\n"
                                f"{done.stderr[-6000:]}")
    out = json.loads((work / "checkify.json").read_text())
    check(out["state_step"] == CHECKIFY_STEPS and len(out["steps"]) == CHECKIFY_STEPS,
          f"checkify: {len(out['steps'])} checked steps, state.step {out['state_step']}")
    for i, (got, plain) in enumerate(zip(out["steps"], out["replays"])):
        print(f"checkify step {i} N={got['n']}: checked loss {got['loss']!r} norm {got['norm']!r} in "
              f"{got['ms']:.1f} ms; unchecked from the same state on the same batch loss {plain['loss']!r} norm "
              f"{plain['norm']!r} in {plain['ms']:.1f} ms; launches checked {json.dumps(got['launches'])}, "
              f"unchecked {json.dumps(plain['launches'])} [{card}]", flush=True)
        check(got["launches"] == plain["launches"] == expected,
              f"checkify step {i}: launches {got['launches']} / {plain['launches']}, expected {expected}")
        check(got["loss"] == plain["loss"] and got["norm"] == plain["norm"],
              f"checkify step {i}: the checked step differs from the unchecked one")
    print(f"checkify: the dispatch mode checked {out['ops']} aten ops of {out['op_kinds']} kinds in the last "
          f"checked step, {out['backward_ops']} of them backward ops; a NaN in descriptor row {out['descriptor_row']} "
          f"of pair 0: {out['descriptor']!r} ({out['descriptor_ms']:.1f} ms); a NaN in the first K4 launch's input: "
          f"{out['k4_input']!r} ({out['k4_input_ms']:.1f} ms); main() with --checkify {out['run_s']:.1f} s, the "
          f"phase {took:.1f} s under timeout {CHECKIFY_TIMEOUT} s [{card}]", flush=True)
    check(out["backward_ops"] > 0, "checkify: the dispatch mode saw no backward op")
    check(bool(out["descriptor"]) and out["descriptor"].startswith("nan generated by aten."),
          f"checkify: a NaN in a descriptor row gave {out['descriptor']!r}")
    check(bool(out["k4_input"]) and "K4 message_forward kernel" in out["k4_input"],
          f"checkify: a NaN in K4's input gave {out['k4_input']!r}")
    launches = collections.Counter()
    for got in out["steps"]:
        launches.update(got["launches"])
    return dict(launches)


# the data-parallel phase (data_parallel_phase): cli.train_cached at world 2,
# two processes on the one card over gloo (NCCL refuses two ranks on one
# device), each step held against world 1 in this process. Three runs: the
# flagship as written (its bf16 chain, a device descriptor cache on each
# rank), the same in host mode on the same rows (both with one loader thread
# and seeded collates), then the f32-chain twin (chain_dtype null) in host
# mode, as the trainer phase holds its steps
DP_WORLD, DP_VAL_PAIRS = 2, 6
DP_RUNS = {"bf16": 4, "bf16_host": 4, "f32": 2}  # run -> steps
DP_SEEDED = ("bf16", "bf16_host")  # the runs held against each other bit for bit
DP_PROFILED = 2  # the flagship run's step (from 0, after the warm-up) under torch.profiler
DP_BARS = dict(loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)  # the B=12 training bars
DP_TIMEOUT = 300  # seconds for the ranks
NCCL_PROBE = """
import os, sys
import torch
import torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
try:
    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"rank {rank}: all_reduce returned {x.item()}", flush=True)
except Exception as exc:
    print(f"rank {rank}: {type(exc).__name__}: {str(exc).strip().splitlines()[0]}", flush=True)
os._exit(0)
"""


GLOO_PROBE = """
import os, sys
import torch
import torch.distributed as dist
op, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
x = torch.arange(4096, device="cuda", dtype=torch.float32) + 10000.0 * rank
peer = 1 - rank
try:
    if op == "batch_isend_irecv":
        got = [torch.zeros_like(x)]
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got[0], peer)]):
            req.wait()
    elif op == "all_gather":
        got = [torch.zeros_like(x) for _ in range(2)]
        dist.all_gather(got, x)
        got = got[peer:peer + 1]
    else:
        got = [x.clone()]
        dist.all_reduce(got[0], op=dist.ReduceOp.MAX)
    torch.cuda.synchronize()
    want = torch.arange(4096, device="cuda", dtype=torch.float32) + 10000.0 * (1 if op == "all_reduce_max" else peer)
    said = "works" if torch.equal(got[0], want) else "returns wrong data"
except Exception as exc:
    said = f"raises {type(exc).__name__}: {str(exc).strip().splitlines()[0][:160]}"
print(f"rank {rank}: {said}", flush=True)
os._exit(0)
"""
GLOO_PROBE_OPS = ("batch_isend_irecv", "all_gather", "all_reduce_max")


def gloo_probe(env, logs: Path):
    """What gloo does with CUDA tensors on two ranks of card 0, each
    collective in a pair of processes of its own (a failed one can close the
    group): {op: [rank 0's word, rank 1's]}."""
    commands, ports = [], {op: free_port() for op in GLOO_PROBE_OPS}
    for op in GLOO_PROBE_OPS:
        commands += [(["timeout", "60", sys.executable, "-c", GLOO_PROBE, op, str(r), str(ports[op])], env)
                     for r in range(2)]
    said = run_ranks(commands, 75, logs)
    out = {}
    for i, op in enumerate(GLOO_PROBE_OPS):
        out[op] = []
        for r in range(2):
            rc, text = said[2 * i + r]
            lines = [line[len(f"rank {r}: "):] for line in text.splitlines() if line.startswith(f"rank {r}: ")]
            out[op].append(lines[-1] if lines else f"exit {rc}: " + " | ".join(text.strip().splitlines()[-2:]))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cat_pair_batches(parts):
    """One pair batch of the rows of ``parts``, in order."""
    from openglue_tpu_torch.core.types import map_tensors

    leaves = [[] for _ in parts]
    for found, part in zip(leaves, parts):
        map_tensors(part, lambda t, found=found: found.append(t) or t)
    joined = iter([torch.cat(ts) for ts in zip(*leaves)])
    return map_tensors(parts[0], lambda _: next(joined))


def data_parallel_rank(rank: int, port: int, work: str) -> None:
    """One rank of ``data_parallel_phase``, in a process of its own: for each
    chain of DP_RUNS, ``cli.train_cached.main`` in a gloo group of DP_WORLD
    ranks on card 0, with data.io's h5 functions on the store the phase
    saved. Every train step (the warm-up's too) and eval batch is checked
    for its launches; after each step of a run the ranks' parameters are
    gathered and held equal bit for bit; the gradient all-reduce is timed on
    the host; one step of the flagship run runs under torch.profiler; the
    DP_SEEDED runs draw their rows from seeded collates. Rank 0 writes the
    state each step starts from and its gradient; each rank writes its
    readings and its batches."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from openglue_tpu_torch import parallel
    from openglue_tpu_torch.cli import common, train_cached
    from openglue_tpu_torch.core.types import map_tensors
    from openglue_tpu_torch.data import io
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train import loop
    from openglue_tpu_torch.train import step as step_mod
    from openglue_tpu_torch.train.checkpoint import save_train_state

    work = Path(work)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize(f"tcp://127.0.0.1:{port}", DP_WORLD, rank, device_type="cuda", backend="gloo")
    store = MemoryH5()
    store.files = torch.load(work / "store.pt", weights_only=False)
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "autograd_sinkhorn": sk.autograd_counter}
    real = dict(make=step_mod.make_train_step, make_eval=step_mod.make_eval_step, summed=step_mod._sum_gradients,
                warm=loop.warm_up_buckets, evaluate=loop.evaluate)
    for chain, steps in DP_RUNS.items():
        argv = json.loads((work / f"dp_{chain}_argv.json").read_text())
        out = work / f"dp_{chain}"
        config = common.load_merged_config(argv[1], argv[3])
        layers = 2 * int(config.get("superglue.attention_gnn.num_stages")) * 2
        train_expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers, "autograd_sinkhorn": 0}
        eval_expected = {"K1": layers, "K2": 1, "K3": 0, "K4": 0, "K5": 0, "autograd_sinkhorn": 0}
        rec = dict(steps=[], batches=[], warm_up=0, eval_batches=0, allreduce_ms=[], busy_ms=None,
                   profiled_ms=None, eval_metrics=None, layers=layers)
        warming = [False]
        for counter in counters.values():
            counter.reset()

        def counted(fn, expected, what):
            before = {k: c.count for k, c in counters.items()}
            result = fn()
            delta = {k: c.count - before[k] for k, c in counters.items()}
            check(delta == expected, f"data_parallel {chain} rank {rank} {what}: launches {delta}, "
                                     f"expected {expected}")
            return result

        def sum_gradients(params, group):
            torch.cuda.synchronize()
            start = time.perf_counter()
            real["summed"](params, group)
            torch.cuda.synchronize()
            rec["allreduce_ms"].append((time.perf_counter() - start) * 1e3)

        def make_train_step(loss_config):
            step = real["make"](loss_config)

            def probed(state, batch):
                if warming[0]:
                    rec["warm_up"] += 1
                    return counted(lambda: step(state, batch), train_expected, "warm-up step")
                i = len(rec["steps"])
                if rank == 0:  # the state this step starts from, for the world-1 step in the parent
                    save_train_state(out, state, step=i)
                profiled = chain == "bf16" and i == DP_PROFILED
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
                torch.cuda.synchronize()
                dist.barrier()  # rank 0's state save above is not the other ranks' step time
                if prof is not None:
                    prof.start()
                start = time.perf_counter()
                metrics = counted(lambda: step(state, batch), train_expected, f"step {i}")
                torch.cuda.synchronize()
                ms = (time.perf_counter() - start) * 1e3
                if prof is not None:
                    prof.stop()
                    rec["busy_ms"], rec["profiled_ms"] = kernel_rows(prof)[0], ms
                flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()]).cpu()
                gathered = [torch.empty_like(flat) for _ in range(DP_WORLD)]
                dist.all_gather(gathered, flat)
                check(all(torch.equal(g, flat) for g in gathered),
                      f"data_parallel {chain} step {i}: the ranks' parameters differ")
                rec["steps"].append(dict(loss=metrics["total_loss"].item(), norm=metrics["grad_norm"].item(),
                                         ms=ms, allreduce_ms=rec["allreduce_ms"][-1],
                                         rows=batch.side0.keypoints.shape[0], n=batch.side0.keypoints.shape[1]))
                rec["batches"].append(map_tensors(batch, lambda t: t.cpu()))
                if rank == 0:
                    torch.save(flat_grads(state.model).float().cpu(), out / f"grads{i}.pt")
                    if i == steps - 1:
                        save_train_state(out, state, step=steps)
                return metrics

            return probed

        def make_eval_step(match_threshold):
            step = real["make_eval"](match_threshold)

            def probed(state, batch):
                rec["eval_batches"] += 1
                return counted(lambda: step(state, batch), eval_expected, "eval batch")

            return probed

        def warm_up(*args, **kwargs):
            warming[0] = True
            try:
                return real["warm"](*args, **kwargs)
            finally:
                warming[0] = False

        def evaluate(*args, **kwargs):
            rec["eval_metrics"] = real["evaluate"](*args, **kwargs)
            return rec["eval_metrics"]

        with replaced(*store.entries(io), (step_mod, "make_train_step", make_train_step),
                      (step_mod, "make_eval_step", make_eval_step), (step_mod, "_sum_gradients", sum_gradients),
                      (loop, "warm_up_buckets", warm_up), (loop, "evaluate", evaluate),
                      *(seeded_collates(0) if chain in DP_SEEDED else ())):
            state = train_cached.main(argv)
        check(state.step == steps and len(rec["steps"]) == steps,
              f"data_parallel {chain} rank {rank}: {len(rec['steps'])} steps, state.step {state.step}")
        rec["launches"] = {k: c.count for k, c in counters.items()}
        torch.save(rec, out / f"rank{rank}.pt")
        del state
    parallel.barrier()
    dist.destroy_process_group()


def run_ranks(commands, timeout, logs: Path):
    """Start one process per ``(argv, env)``, each writing its output to a
    file under ``logs``; wait for all, killing every one still running at
    ``timeout`` seconds or once one has failed (its peers would wait in a
    collective). Returns each one's (exit code, output)."""
    logs.mkdir(parents=True, exist_ok=True)
    files = [open(logs / f"{i}.log", "w+b") for i in range(len(commands))]
    procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env)
             for (cmd, env), f in zip(commands, files)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read().decode(errors="replace"))
        f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def flat_distance(a, b):
    """(gradient L2 distance relative to ``b``'s norm, cosine) of two flat
    gradients."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item(), (a @ b / (a.norm() * b.norm())).item()


def data_parallel_phase(card, repo: Path, store: "MemoryH5", work: Path, device="cuda"):
    """Data parallelism (``parallel.shard_train_step``) through the cached
    trainer as a user launches it: DP_WORLD processes
    (``data_parallel_rank``) on the one card in a gloo group, each running
    ``cli.train_cached.main`` with the trainer phase's flagship config and
    fixture (global B=12, 6 rows a rank, buckets 256/512/1024 grouped,
    use_pallas, a device descriptor cache of 512 slots on each rank) and a
    validation sweep, the same in host mode (device_descriptor_cache 0) on
    the same rows, then host mode with an f32 chain. Checks each rank's
    launches per step (36 K4 + 36 K5 + 1 K2 + 1 K3) and per eval batch (36
    K1 + 1 K2) and the ranks' parameters equal bit for bit after every step;
    the cache run's steps bit for bit those of host mode (the descriptors,
    the losses, the gradient norms, the parameters after each step); then
    each step of the cache run and of the f32 run again at
    world 1 in this process, from the state the ranks started it from, on
    the global batch: the f32 chain at the B=12 training bars (loss, norm,
    cosine, statistics; the parameters after the step at the statistics'
    bar), the flagship's bf16 chain at those bars for the loss, the
    statistics and the parameters and for its gradient by the trainer
    phase's rule (its distance from the f32-chain step at most
    BF16_DISTANCE_RATIO times world 1's). Prints each rank's step time,
    the gradient all-reduce's host time and the idle share of one step;
    then what NCCL says when two ranks are put on one device. Two processes
    share one card, so the times are no scaling figure. Returns the
    launches of both ranks, both runs, by kernel."""
    import yaml

    from openglue_tpu_torch.cli import common
    from openglue_tpu_torch.core.config import load_config
    from openglue_tpu_torch.data import fixture, io
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.train.checkpoint import restore_model, restore_train_state
    from openglue_tpu_torch.train.loop import batch_to_device
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    start = time.perf_counter()
    root = work / "megadepth"
    if not store.files:  # run alone: the trainer phase's fixture
        with replaced(*store.entries(io)):
            fixture.generate_megadepth_fixture(root, **TRAINER_FIXTURE)
    torch.save(store.files, work / "store.pt")
    base = repo / "configs" / "config_cached_sp_magicleap.yaml"
    for chain, steps in DP_RUNS.items():
        override = trainer_override(root, work / f"logs_dp_{chain}", steps, val_pairs_per_scene=DP_VAL_PAIRS)
        if chain == "f32":
            override["superglue"] = {"chain_dtype": None}
        if chain != "bf16":
            override["data"]["device_descriptor_cache"] = 0
        if chain in DP_SEEDED:
            override["data"]["dataloader_workers"] = 0
        (work / f"dp_{chain}.yaml").write_text(yaml.safe_dump(override))
        argv = ["--config", str(base), "--config_override", str(work / f"dp_{chain}.yaml"), "--device", device]
        (work / f"dp_{chain}_argv.json").write_text(json.dumps(argv))
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env.update(LOCAL_RANK="0", PYTHONPATH=str(repo))  # both ranks on card 0
    port = free_port()
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import chip_smoke; "
            f"chip_smoke.data_parallel_rank(int(sys.argv[1]), {port}, {str(work)!r})")
    results = run_ranks([([sys.executable, "-c", code, str(r)], env) for r in range(DP_WORLD)], DP_TIMEOUT,
                        work / "dp_logs")
    for r, (rc, out) in enumerate(results):
        check(rc == 0, f"data_parallel rank {r} exited with {rc}:\n{out[-6000:]}")
    run_s = time.perf_counter() - start
    descriptor_dim = int(load_config(root / "SyntheticSphere_640_480" / "config.yaml")["descriptor_dim"])

    launches = collections.Counter()
    failures = []
    for chain in DP_RUNS:
        out = work / f"dp_{chain}"
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
        for rank in ranks:
            launches.update({k: v for k, v in rank["launches"].items() if k != "autograd_sinkhorn"})
        for r, rank in enumerate(ranks):
            steps, layers = rank["steps"], rank["layers"]
            timed = ""
            if rank["profiled_ms"] is not None:
                busy, wall = rank["busy_ms"], rank["profiled_ms"]
                idle = "not measured" if busy is None else f"{1 - busy / wall:.3f}"
                busy = "not measured" if busy is None else f"{busy:.3f} ms"
                timed = f"; step {DP_PROFILED} under the profiler {wall:.3f} ms, device busy {busy}, idle share {idle}"
            print(f"data_parallel {chain} chain rank {r}/{DP_WORLD} (gloo, card 0): {len(steps)} steps of "
                  f"{steps[0]['rows']} rows (global {steps[0]['rows'] * DP_WORLD}), N {[s['n'] for s in steps]}, "
                  f"step ms {[round(s['ms'], 3) for s in steps]} (median "
                  f"{statistics.median(s['ms'] for s in steps):.3f}, each synchronized), gradient all-reduce host "
                  f"ms {[round(s['allreduce_ms'], 3) for s in steps]} (median "
                  f"{statistics.median(s['allreduce_ms'] for s in steps):.3f}){timed}; {rank['warm_up']} warm-up "
                  f"and {len(steps)} steps at {layers} K4 + {layers} K5 + 1 K2 + 1 K3 each, {rank['eval_batches']} "
                  f"eval batches at {layers} K1 + 1 K2 each; launches {json.dumps(rank['launches'])}; validation "
                  f"{json.dumps(rank['eval_metrics'])} [{card}]", flush=True)

        if chain == "bf16_host":  # ---- the cache run against host mode, step by step
            cached = [torch.load(work / "dp_bf16" / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
            for i in range(DP_RUNS[chain]):
                a = torch.load(out / f"{i + 1}.pt", weights_only=False)["model"]
                b = torch.load(work / "dp_bf16" / f"{i + 1}.pt", weights_only=False)["model"]
                same = dict(
                    descriptors=all(torch.equal(bits(getattr(x["batches"][i], s).descriptors),
                                                bits(getattr(y["batches"][i], s).descriptors))
                                    for x, y in zip(ranks, cached) for s in ("side0", "side1")),
                    losses=all(x["steps"][i]["loss"] == y["steps"][i]["loss"] for x, y in zip(ranks, cached)),
                    norms=all(x["steps"][i]["norm"] == y["steps"][i]["norm"] for x, y in zip(ranks, cached)),
                    parameters=all(torch.equal(bits(v), bits(b[k])) for k, v in a.items() if v.is_floating_point()))
                print(f"data_parallel step {i} N={ranks[0]['steps'][i]['n']}, world {DP_WORLD}: the device cache "
                      f"(one per rank) against host mode on the same rows, bit-equal {json.dumps(same)} [{card}]",
                      flush=True)
                if not all(same.values()):
                    failures.append(f"cache step {i}: {same}")
            continue

        # ---- each step again at world 1, on its global batch, from the state the ranks started it from
        config = common.load_merged_config(str(base), str(work / f"dp_{chain}.yaml"))
        cfg = common.superglue_config_from(config, descriptor_dim, SIDE_INFO_DIM)
        twin_cfg = dataclasses.replace(cfg, chain_dtype=None)
        state = create_train_state(SuperGlue(cfg, device=device))
        twin = create_train_state(SuperGlue(twin_cfg, device=device)) if twin_cfg != cfg else None
        after = SuperGlue(cfg, device=device)
        step = make_train_step(common.loss_config_from(config))
        for i, parts in enumerate(zip(*(r["batches"] for r in ranks))):
            got = ranks[0]["steps"][i]
            check(all(r["steps"][i]["loss"] == got["loss"] and r["steps"][i]["norm"] == got["norm"] for r in ranks),
                  f"data_parallel {chain} step {i}: the ranks' metrics differ")
            batch = batch_to_device(cat_pair_batches(parts), device)
            restore_train_state(out, state, step=i)
            restore_model(out, after, step=i + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dp_grad, grad = torch.load(out / f"grads{i}.pt").to(device), flat_grads(state.model)
            d, cos = flat_distance(dp_grad, grad)
            ranked = dict(after.named_buffers())
            x = dict(loss=abs(got["loss"] - metrics["total_loss"].item()),
                     norm=abs(got["norm"] / metrics["grad_norm"].item() - 1), grad=d, cos=cos,
                     stats=max((ranked[k] - v).abs().max().item()
                               for k, v in state.model.named_buffers() if "running" in k),
                     params=max((q.detach() - p.detach()).abs().max().item()
                                for q, p in zip(after.parameters(), state.model.parameters())))
            line = (f"data_parallel {chain} chain step {i} N={got['n']}, world {DP_WORLD} against world 1 from the "
                    f"same state on the same global batch: loss |diff| {x['loss']:.3e}, grad norm rel "
                    f"{x['norm']:.3e}, gradient distance {x['grad']:.3e}, cosine {x['cos']:.6f}, running stats max "
                    f"|diff| {x['stats']:.3e}, parameters after the step max |diff| {x['params']:.3e}")
            held = (x["loss"] <= DP_BARS["loss_tol"] and x["stats"] <= DP_BARS["stats_tol"]
                    and x["params"] <= DP_BARS["stats_tol"])
            if twin is None:
                held = held and x["norm"] <= DP_BARS["norm_tol"] and x["cos"] >= DP_BARS["cos_min"]
            else:  # the bf16 chain: both steps by their distance from the f32-chain step
                restore_train_state(out, twin, step=i)
                step(twin, batch)
                ref = flat_grads(twin.model)
                d_dp, d_one = flat_distance(dp_grad, ref)[0], flat_distance(grad, ref)[0]
                line += (f"; against the f32-chain step: world {DP_WORLD} {d_dp:.3e}, world 1 {d_one:.3e}, ratio "
                         f"{d_dp / d_one:.3f} (bar {BF16_DISTANCE_RATIO})")
                held = held and d_dp <= BF16_DISTANCE_RATIO * d_one
            print(f"{line}; world-1 step {ms:.3f} ms in this process [{card}]", flush=True)
            if not held:
                failures.append(f"{chain} step {i}: {x}")
        del state, twin, after
    print(f"data_parallel: bars {json.dumps(DP_BARS)} (the parameters at the statistics' bar); the ranks' parameters "
          f"equal bit for bit after every step; the ranks and their start {run_s:.1f} s [{card}]", flush=True)

    # ---- what NCCL says to two ranks on one device
    port = free_port()
    said = run_ranks([([sys.executable, "-c", NCCL_PROBE, str(r), str(port)], env) for r in range(2)], 45,
                     work / "nccl_logs")
    for r, (rc, out) in enumerate(said):
        lines = [line for line in out.splitlines() if line.startswith(f"rank {r}:")] or out.strip().splitlines()[-2:]
        print(f"data_parallel NCCL with two ranks on card 0, rank {r} (exit {rc}): {' | '.join(lines)}", flush=True)
    print(f"data_parallel phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    check(not failures, "data_parallel: world 2 against world 1 outside the bars: " + "; ".join(failures))
    return dict(launches)


CP_WORLD = 2  # two ranks on card 0, both on the model axis
CP_TIMEOUT = 240  # seconds for the ranks
CP_STEP_BARS = DP_BARS  # the f32-chain runs of the data_parallel phase
CP_KINDS = ("linear", "favor_relu", "favor_softmax")
# homography_pretraining.yaml's global pairs and width x height; image 1's shift in px
CP_ONLINE = dict(batch=12, size=(960, 720), shift=(3, -2))


def cp_section(**changes):
    """The flagship's superglue section with an f32 chain (and ``changes``
    to its attention_gnn)."""
    gnn = dict(SUPERGLUE_SECTION["attention_gnn"], **changes)
    return dict(SUPERGLUE_SECTION, chain_dtype=None, attention_gnn=gnn)


def cp_online_batch(gen):
    """CP_ONLINE's global image pairs on the CPU: smooth random images, image
    1 the image 0 shifted by whole pixels, the homography that shift."""
    import torch.nn.functional as F

    from openglue_tpu_torch.core.types import Transformation

    (w, h), (dx, dy) = CP_ONLINE["size"], CP_ONLINE["shift"]
    noise = torch.rand(CP_ONLINE["batch"], 1, h // 8, w // 8, generator=gen)
    image0 = F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    image1 = torch.zeros_like(image0)
    image1[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        image0[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    H = torch.tensor([[1.0, 0.0, dx], [0.0, 1.0, dy], [0.0, 0.0, 1.0]]).expand(CP_ONLINE["batch"], 3, 3).clone()
    return {"image0": image0, "image1": image1, "transformation": Transformation(kind="perspective", H=H)}


def cp_online_module_config():
    return {"features": {"name": "SuperPointNetBn", "parameters": {"max_keypoints": MAX_KEYPOINTS,
                                                                    "descriptor_dim": DESCRIPTOR_DIM}},
            "laf_to_sideinfo_method": "none", "superglue": cp_section(),
            "train": {"finetune_features_extractor": True}}


def context_parallel_rank(rank: int, port: int, work: str, device: str = "cuda", f64_witness: bool = False) -> None:
    """One rank of ``context_parallel_phase``, in a process of its own, on
    card 0 in a gloo group of CP_WORLD ranks: every way the port shards the
    matcher over a model axis of CP_WORLD at the flagship's width with an
    f32 chain: each serving run and the ring's step twice (the first held,
    the second timed), every other step once, with the launches of each run
    counted from 0 and held against the expected counts, its bytes through
    each collective and its host time. Rank 0
    holds each run against the same model at world 1 on the same card (the
    first run's outputs, or the step from the same weights on the global
    batch) and the ranks' parameters after each step are held equal bit for
    bit. With ``f64_witness`` rank 0 also holds both BatchNorm fine-tuning
    steps, world 2's and world 1's, against the world-1 step in f64
    (``exact`` below). Each rank writes its readings to ``cp{rank}.pt``."""
    import torch.distributed as dist

    from openglue_tpu_torch import parallel
    from openglue_tpu_torch.cli.common import loss_config_from, optimizer_from, superglue_config_from
    from openglue_tpu_torch.core.types import map_tensors
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.matching_module import MatchingModule, MatchingModuleConfig
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.parallel import distributed, tensor_parallel
    from openglue_tpu_torch.parallel.mesh import mesh_device
    from openglue_tpu_torch.parallel.distributed import all_gather
    from openglue_tpu_torch.train.state import create_train_state, make_online_optimizer
    from openglue_tpu_torch.train.step import make_online_train_step, make_train_step, superglue_inputs

    work = Path(work)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize(f"tcp://127.0.0.1:{port}", CP_WORLD, rank, device_type=device, backend="gloo")
    mesh = parallel.make_mesh({parallel.MODEL_AXIS: CP_WORLD}, device_type=device)
    group = mesh.get_group(parallel.MODEL_AXIS)
    device = mesh_device(mesh)
    given = torch.load(work / "cp_inputs.pt", weights_only=False)
    to_card = lambda batch: map_tensors(batch, lambda t: t.to(device))
    serve_pairs, train_pairs = to_card(given["serve"]), to_card(given["train"])
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "K6": glk.feature_counter, "K8": glk.half_counter,
                "K9": ak.counter, "K10": ak.backward_counter, "K11": ak.lse_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2
    records = {}

    def counted(name, fn, expected, hold, times=2):
        """Run ``fn`` ``times`` times, each time with the counters and the
        traffic from 0 just before it and read just after it; ``hold`` takes
        the first run's result before the next. The last run's bytes are
        kept."""
        expected = dict({k: 0 for k in counters}, **expected)
        runs = []
        for i in range(times):
            torch.cuda.synchronize()
            dist.barrier()
            for c in counters.values():
                c.reset()
            distributed.traffic.clear()
            start = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            launches = {k: c.count for k, c in counters.items()}
            check(launches == expected, f"context_parallel {name} rank {rank}: launches {launches}, "
                                        f"expected {expected}")
            runs.append((ms, dict(distributed.traffic)))
            if i == 0:
                records[name] = dict(launches={k: v for k, v in expected.items() if v})
                hold(name, result)
        records[name].update(ms=[r[0] for r in runs], bytes=runs[-1][1])
        print(f"context_parallel {name} rank {rank}: {json.dumps(records[name])}", flush=True)

    def whole(out):
        """The sharded forward's outputs of every row, on every rank."""
        return {"scores": parallel.gather_rows(out["scores"], group),
                "decode_indices0": all_gather(out["decode_indices0"], group),
                "decode_indices1": out["decode_indices1"], "decode_max0": all_gather(out["decode_max0"], group)}

    def config_of(section):
        return superglue_config_from({"superglue": section}, DESCRIPTOR_DIM, SIDE_INFO_DIM)

    def matcher(section, weights, sharded=True, **kwargs):
        """The model of ``section`` with ``weights``: sharded over the model
        axis, or at world 1 (without ``ring_axis``)."""
        cfg = config_of(section)
        if not sharded:
            cfg = dataclasses.replace(cfg, ring_axis=None)
        model = SuperGlue(cfg, device=device, mesh=mesh if sharded else None, **kwargs)
        model.load_state_dict(weights)
        return model

    def params_equal(model, name):
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
        gathered = [torch.empty_like(flat) for _ in range(CP_WORLD)]
        dist.all_gather(gathered, flat)
        check(all(torch.equal(g, flat) for g in gathered), f"context_parallel {name}: the ranks' parameters differ")

    def hold_serve(section, weights):
        """The served outputs against the same model at world 1."""
        def hold(name, out):
            if rank == 0:
                inputs = superglue_inputs(serve_pairs)
                with torch.inference_mode():
                    ref = matcher(section, weights, sharded=False).eval()(**inputs)
                records[name]["vs_world1"] = compare(decode_from_output, out, ref, inputs, f"context_parallel {name}")

        return hold

    def hold_step(state, reference, exact=None):
        """The step's gradients, statistics and metrics against the same step
        at world 1 (``reference()``: its state and metrics, on rank 0), and
        the ranks' parameters equal. ``exact(metrics, ref_state,
        ref_metrics)`` reads both steps' distances from an f64 step."""
        def hold(name, metrics):
            params_equal(state.model, name)
            if rank != 0:
                if exact is not None:  # rank 0's f64 step needs the card's memory
                    torch.cuda.empty_cache()
                return
            ref_state, ref_metrics = reference()
            if exact is not None:
                torch.cuda.empty_cache()
                records[name]["vs_f64"] = exact(metrics, ref_state, ref_metrics)
            a, b = flat_grads(state.model), flat_grads(ref_state.model)
            x = dict(loss=abs(metrics["total_loss"].item() - ref_metrics["total_loss"].item()),
                     norm=abs(metrics["grad_norm"].item() / ref_metrics["grad_norm"].item() - 1),
                     cos=(a @ b / (a.norm() * b.norm())).item(),
                     stats=max((u - v).abs().max().item() for (k, u), (_, v) in zip(
                         state.model.named_buffers(), ref_state.model.named_buffers()) if "running" in k),
                     loss_value=metrics["total_loss"].item(), metric_loss=metrics["metric_loss"].item())
            records[name]["vs_world1"] = x
            check(x["loss"] <= CP_STEP_BARS["loss_tol"] and x["norm"] <= CP_STEP_BARS["norm_tol"]
                  and x["cos"] >= CP_STEP_BARS["cos_min"] and x["stats"] <= CP_STEP_BARS["stats_tol"],
                  f"context_parallel {name}: against world 1 outside the bars {CP_STEP_BARS}: {x}")

        return hold

    def serve_run(name, section, weights, expected):
        model = matcher(section, weights).eval()
        batch = parallel.shard_pair_batch_cp(serve_pairs, mesh)
        with torch.inference_mode():
            counted(name, lambda: whole(model(**superglue_inputs(batch))), expected, hold_serve(section, weights))

    def step_run(name, section, weights, expected, loss=None, times=1):
        config = {"superglue": section, "train": dict(TRAIN_SECTION, **(loss or {}))}
        model = matcher(section, weights)
        state = create_train_state(model, optimizer=optimizer_from(config, model.parameters()))
        step = parallel.shard_train_step_cp(make_train_step(loss_config_from(config)), mesh)

        def reference():
            twin = matcher(section, weights, sharded=False, train_route="composed")
            ref_state = create_train_state(twin, optimizer=optimizer_from(config, twin.parameters()))
            return ref_state, make_train_step(loss_config_from(config))(ref_state, train_pairs)

        counted(name, lambda: step(state, train_pairs), expected, hold_step(state, reference), times)

    base = given["weights"]["softmax"]
    ring = cp_section()
    # ---- the ring rotating between the two ranks
    serve_run("ring serve B=16 N=1024", dict(ring, ring_axis="model"), base, {"K11": 2 * layers})
    step_run("ring train B=12 N=1024", dict(ring, ring_axis="model"), base, {"K11": 2 * layers, "K10": 2 * layers},
             times=2)
    # ---- the all-gather route (no ring_axis)
    serve_run("all-gather serve B=16 N=1024", ring, base, {"K9": layers})
    step_run("all-gather train B=12 N=1024", ring, base, {"K9": layers, "K10": layers})
    # ---- the O(N) kinds: composed, their KV aggregates all-reduced
    for kind in CP_KINDS:
        section = cp_section(attention=kind)
        serve_run(f"{kind} serve B=16 N=1024", section, given["weights"][kind], {})
        step_run(f"{kind} train B=12 N=1024", section, given["weights"][kind], {})
    # ---- the ring with remat, and with the metric loss
    step_run("ring+remat train B=12 N=1024", dict(ring, ring_axis="model", remat=True), base,
             {"K11": 4 * layers, "K10": 2 * layers})
    step_run("ring+margin train B=12 N=1024", dict(ring, ring_axis="model"), base,
             {"K11": 2 * layers, "K10": 2 * layers}, loss={"margin": 0.5, "metric_weight": 1.0})

    # ---- tensor parallelism: this rank's 2 heads and half the FFN's hidden channels
    name = "tensor-parallel serve B=16 N=1024"
    model = tensor_parallel.shard_model_tp(matcher(ring, base, sharded=False).eval(), mesh)
    with torch.inference_mode():
        counted(name, lambda: tensor_parallel.tp_forward(model, **superglue_inputs(serve_pairs)),
                {"K9": layers, "K2": 1}, hold_serve(ring, base))
    records[name]["model_bytes"] = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    del model

    # ---- the online step fine-tuning SuperPoint's BatchNorms at data axis 2
    data_mesh = parallel.make_mesh({parallel.DATA_AXIS: CP_WORLD}, device_type=device.type)
    module_config = MatchingModuleConfig.from_dict(cp_online_module_config())
    online = to_card(given["online"])

    def module():
        m = MatchingModule(module_config, device=device)
        m.load_state_dict(given["online_weights"])
        return m

    def online_state(m):
        return create_train_state(m, optimizer=make_online_optimizer(m, learning_rate=1e-4, finetune_extractor=True))

    name = f"online BN fine-tune B={CP_ONLINE['batch']} {CP_ONLINE['size'][0]}x{CP_ONLINE['size'][1]}, data axis 2"
    raw = make_online_train_step(loss_config_from({"train": TRAIN_SECTION}))
    step = parallel.shard_train_step(raw, data_mesh)
    state = online_state(module())

    seen = {}  # each step's keypoints, extractor maps (rank 0's rows) and matcher's ReLU gates

    @contextlib.contextmanager
    def recorded(model, key, force=None):
        """Record the step's keypoints, maps and ReLU gates under ``key``;
        ``force``: (keypoints, gates) of another step for this one to take."""
        if not f64_witness:
            yield
            return
        maps, seen[key + " maps"] = model.extractor.maps, []

        def recorded_maps(image):
            out = maps(image)
            seen[key + " maps"].append([t.detach() for t in out])
            return out

        model.extractor.maps = recorded_maps
        try:
            with (given_keypoints(force[0]) if force else contextlib.nullcontext()), \
                    recorded_keypoints(model, seen, key), \
                    relu_gates(model.superglue, glk, force=force[1] if force else None) as gates:
                yield
        finally:
            model.extractor.maps = maps
        seen[key + " gates"] = gates

    def world2_step():
        with recorded(state.model, "world2"):
            metrics = step(state, parallel.shard_batch(online, data_mesh))
        if f64_witness and "world2 global" not in seen:  # every rank's rows, for rank 0's f64 step on them
            data_group = data_mesh.get_group(parallel.DATA_AXIS)
            seen["world2 global"] = [[all_gather(t, data_group, dim=0) for t in seen["world2" + part]]
                                     for part in ("", " gates")]
        return metrics

    def reference():
        ref_state = online_state(module())
        with recorded(ref_state.model, "world1"):
            return ref_state, raw(ref_state, online)

    def f64_step(force=None):
        """The world-1 step in f64: the matcher on its plain path, the ground
        truth in f32 as in the f32 step, on its own keypoints and ReLU gates
        or on ``force``'s (another step's)."""
        m64 = MatchingModule(dataclasses.replace(module_config, superglue=dataclasses.replace(
            module_config.superglue, use_pallas=False)), device=device)
        m64.load_state_dict(given["online_weights"])
        state64 = online_state(m64.double())
        # the backbone's f64 activations take about 24 GB an image batch at
        # B=12 960x720: keep none, recompute them in the backward (the
        # gradients are the same; the BatchNorms' running statistics move twice)
        maps = m64.extractor.maps
        m64.extractor.maps = lambda image: torch.utils.checkpoint.checkpoint(maps, image, use_reentrant=False)
        with recorded(m64, "f64", force), f32_ground_truth(), f64_floats():
            return m64, raw(state64, {k: to_f64(v) for k, v in online.items()})

    def exact(metrics, ref_state, ref_metrics):
        """Both f32 steps (world 2's, ``state``, and world 1's) against the
        world-1 step in f64, free and on each f32 step's own keypoints and
        ReLU gates: the rounding moves keypoints across near ties of the
        selection (often only their order) and gates within rounding of 0,
        and a moved gate moves the gradient by more than rounding. Also the
        extractor's maps of rank 0's rows against the free f64 step's
        (relative L2, descriptors and scores)."""
        rows = slice(0, online["image0"].shape[0] // CP_WORLD)  # rank 0's rows of the global batch
        steps = {"world1": (ref_state.model, ref_metrics, [seen["world1"], seen["world1 gates"]], rows),
                 "world2": (state.model, metrics, seen["world2 global"], slice(None))}
        m64, metrics64 = f64_step()
        out = {"grad_norm_f64": metrics64["grad_norm"].item(), "free": {}, "on its own keypoints and gates": {}}
        for world, (model, m, force, part) in steps.items():
            out["free"][world] = dict(
                distance_from_exact(model, m, m64, metrics64),
                maps_rel_l2_rows_of_rank_0=[max(((ours[i][part].double() - ref[i][rows]).norm()
                                                 / ref[i][rows].norm()).item()
                                                for ours, ref in zip(seen[world + " maps"], seen["f64 maps"]))
                                            for i in range(2)],
                keypoints_in_other_places=sum(int((a != b).any(-1).sum()) for a, b in zip(force[0], seen["f64"])),
                gates_other=sum(int((a != b).sum()) for a, b in zip(force[1], seen["f64 gates"])))
        del m64
        for world, (model, m, force, _) in steps.items():
            torch.cuda.empty_cache()
            m64, metrics64 = f64_step(force)
            out["on its own keypoints and gates"][world] = dict(
                distance_from_exact(model, m, m64, metrics64),
                gates_f64_would_take_otherwise=sum(int((a != b).sum()) for a, b in zip(force[1], seen["f64 gates"])))
            del m64
        torch.cuda.empty_cache()
        print(f"context_parallel {name}: both f32 steps against the world-1 step in f64: {json.dumps(out)}",
              flush=True)
        return out

    counted(name, world2_step, {"K4": layers, "K5": layers, "K2": 1, "K3": 1},
            hold_step(state, reference, exact if f64_witness else None))
    torch.save(records, work / f"cp{rank}.pt")
    parallel.barrier()
    dist.destroy_process_group()


def context_parallel_phase(card, repo: Path, work: Path, weights, gen, f64_witness: bool = False):
    """Keypoint-axis context parallelism and tensor parallelism across two
    ranks: CP_WORLD processes (``context_parallel_rank``) on card 0 in a
    gloo group, the first two-rank rotations of the ring on the card. First
    what gloo does with CUDA tensors (``gloo_probe``: its point-to-point
    exchange fails, so the ring's exchange is staged through pinned host
    buffers); then the ring serving B=16 N=1024 and stepping B=12 N=1024,
    the all-gather route, the three O(N) kinds, the ring with remat and with
    the metric loss, the TP forward, and the online step fine-tuning
    SuperPoint's BatchNorms at data axis 2 (``context_parallel_rank``). Every
    model is the flagship's width with an f32 chain and ``use_pallas``, each
    rank holding N/2 keypoints. Prints each run's launches, bytes and host
    time and its distance from world 1. Returns the launches of both ranks
    by kernel."""
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.core.types import map_tensors
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.matching_module import MatchingModule, MatchingModuleConfig
    from openglue_tpu_torch.models.superglue import SuperGlue

    start = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env.update(LOCAL_RANK="0", PYTHONPATH=str(repo))  # both ranks on card 0
    said = gloo_probe(env, work / "gloo_probe")
    for op, words in said.items():
        print(f"context_parallel: gloo {op} on CUDA tensors, two ranks on card 0: rank 0 {words[0]}; rank 1 "
              f"{words[1]} [{card}]", flush=True)
    check(all(w == "works" for w in said["all_gather"] + said["all_reduce_max"]),
          f"context_parallel: gloo's collectives on CUDA tensors: {said}")

    n = MAX_KEYPOINTS
    counts = lambda b: torch.randint(n // 2, n + 1, (b,), generator=gen, device="cuda").tolist()
    cpu = lambda batch: map_tensors(batch, lambda t: t.cpu())

    weight_sets = {"softmax": {k: v.cpu() for k, v in weights.items()}}
    for kind in CP_KINDS:
        cfg = superglue_config_from({"superglue": cp_section(attention=kind)}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
        weight_sets[kind] = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    online = MatchingModule(MatchingModuleConfig.from_dict(cp_online_module_config()), device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            extractor_generator=torch.Generator().manual_seed(0))
    torch.save(dict(serve=cpu(make_request(SyntheticHomographyPairs, gen, 16, n, counts(16), counts(16))),
                    train=cpu(make_request(SyntheticHomographyPairs, gen, BATCH_SIZE, n, counts(BATCH_SIZE),
                                           counts(BATCH_SIZE))),
                    weights=weight_sets, online=cp_online_batch(torch.Generator().manual_seed(5)),
                    online_weights=online.state_dict()), work / "cp_inputs.pt")
    del online
    torch.cuda.empty_cache()  # the ranks share card 0 with this process: its cached blocks go back
    port = free_port()
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import chip_smoke; "
            f"chip_smoke.context_parallel_rank(int(sys.argv[1]), {port}, {str(work)!r}, "
            f"f64_witness={f64_witness})")
    results = run_ranks([(["timeout", str(CP_TIMEOUT), sys.executable, "-c", code, str(r)], env)
                         for r in range(CP_WORLD)], CP_TIMEOUT + 15, work / "cp_logs")
    for r, (rc, out) in enumerate(results):
        if rc != 0:  # the runs that passed, then the failure
            print("\n".join(line for line in out.splitlines() if line.startswith("context_parallel ")), flush=True)
        check(rc == 0, f"context_parallel rank {r} exited with {rc}:\n{out[-6000:]}")
    ranks = [torch.load(work / f"cp{r}.pt", weights_only=False) for r in range(CP_WORLD)]
    launches = collections.Counter()
    for name, rec in ranks[0].items():
        for r in ranks:
            launches.update(r[name]["launches"])
        order = "(held, timed)" if len(rec["ms"]) == 2 else "(held and timed)"
        per_rank = "; ".join(f"rank {r}: host ms {', '.join(f'{ms:.3f}' for ms in x[name]['ms'])} {order}, "
                             f"bytes {json.dumps(x[name]['bytes'])}" for r, x in enumerate(ranks))
        extra = f", TP shard of the model {rec['model_bytes']} bytes a rank" if "model_bytes" in rec else ""
        exact = f"; both steps against world 1's in f64 {json.dumps(rec['vs_f64'])}" if "vs_f64" in rec else ""
        print(f"context_parallel {name} (gloo, {CP_WORLD} ranks on card 0): launches per rank "
              f"{json.dumps(rec['launches'] or {'none': 0})}{extra}; {per_rank}; against world 1 "
              f"{json.dumps(rec.get('vs_world1'))}{exact} [{card}]", flush=True)
    print(f"context_parallel: step bars {json.dumps(CP_STEP_BARS)}, serving bars {LOG_P_NATS} nats and "
          f"{DECODE_AGREEMENT} decode agreement; the ranks' parameters equal bit for bit after every step; the "
          f"phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return dict(launches)


# the serving phase (serving_cli_phase): generate_image_fixture's 1280x1024
# images, each beside a copy warped by a known mild homography, through the
# port's extract_features, inference and evaluate entry points
SERVING_IMAGES = 4
SERVING_BUCKETS = [512, 1024, 2048]
SERVING_SMALL_TARGET = (240, 180)  # about 400 keypoints a side: the 512 bucket
GEOMETRY_MIN_MATCHES, GEOMETRY_MAX_PX = 8, 3.0
EVAL_METRIC_TOL = 1e-3  # evaluate's metrics against fit's on other batches (1e-6 on the same)


def serving_homography(i, size=(1280, 1024)):
    """Pair i's homography (image pixels to the warped copy's): a rotation of
    5 degrees (alternating in sign) and scale 0.95 about the centre, a
    perspective term of about 1e-5 and a shift of about 20 px."""
    import numpy as np

    w, h = size
    angle = np.deg2rad(5.0 if i % 2 == 0 else -5.0)
    c, s = 0.95 * np.cos(angle), 0.95 * np.sin(angle)
    to_centre = np.array([[1.0, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]])
    shape = np.array([[c, -s, 0], [s, c, 0], [1e-5, -5e-6, 1]])
    back = np.array([[1.0, 0, w / 2 + 20 - 3 * i], [0, 1, h / 2 - 15 + 5 * i], [0, 0, 1]])
    return back @ shape @ to_centre


def reprojection_px(kpts0, kpts1, H, scale):
    """|H(k0) - k1| in the resized images' pixels: H of the full-size images
    conjugated by the resize (``cv2.resize`` maps pixel centres: x' = s (x +
    0.5) - 0.5)."""
    import numpy as np

    S = np.array([[scale, 0, 0.5 * scale - 0.5], [0, scale, 0.5 * scale - 0.5], [0, 0, 1]])
    p = np.c_[kpts0, np.ones(len(kpts0))] @ (S @ H @ np.linalg.inv(S)).T
    return np.linalg.norm(p[:, :2] / p[:, 2:] - kpts1, axis=1)


class ServingProbe:
    """What the serving phase reads from inside ``run_inference``, through
    wrappers of what it looks up at call time: the host time of each stage
    (read, resize, SIFT detect and describe, NMS, the rest of the
    extractor: keypoints to arrays, top-k, LAFs and pad; prepare and copy,
    forward, decode, the rest of ``match_images``: the copy back; MAGSAC),
    with the card synchronized after each stage that queues device work so
    that its time holds that work; each forward's inputs, output and
    launches; MAGSAC's matches before and after."""

    def __init__(self, counters):
        self.counters = counters
        self.reset()

    def reset(self):
        self.ms = collections.defaultdict(float)
        self.forwards, self.magsac = [], []

    def counts(self):
        return {k: c.count for k, c in self.counters.items()}

    def timed(self, stage, fn, sync=False):
        def run(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.ms[stage] += (time.perf_counter() - start) * 1e3
            return out

        return run

    def magsac_filter(self, fn):
        def run(kpts0, kpts1):
            start = time.perf_counter()
            inliers = fn(kpts0, kpts1)
            self.ms["magsac"] += (time.perf_counter() - start) * 1e3
            self.magsac.append((len(kpts0), int(inliers.sum())))
            return inliers

        return run

    def forward(self, fn):
        def run(**kw):
            before = self.counts()
            start = time.perf_counter()
            out = fn(**kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
            self.ms["forward"] += wall
            self.forwards.append(dict(kw=kw, out=out, wall_ms=wall,
                                      launches={k: v - before[k] for k, v in self.counts().items()}))
            return out

        return run

    def entries(self, inference, opencv_features, io, matcher):
        class Detector:  # the cv2 detector, timed
            def __init__(self, inner, probe):
                self.inner, self.probe = inner, probe

            def detectAndCompute(self, image, mask):
                return self.probe.timed("detect", self.inner.detectAndCompute)(image, mask)

        extractor = type(matcher.extractor)
        return ((io, "read_grayscale", self.timed("read", io.read_grayscale)),
                (io, "aspect_preserving_resize", self.timed("resize", io.aspect_preserving_resize)),
                (matcher.extractor, "features", Detector(matcher.extractor.features, self)),
                (opencv_features, "nms_keypoints", self.timed("nms", opencv_features.nms_keypoints)),
                (extractor, "detect_and_compute", self.timed("extractor", extractor.detect_and_compute)),
                (inference, "prepare_features_output", self.timed("prepare", inference.prepare_features_output,
                                                                  sync=True)),
                (matcher.model, "forward", self.forward(matcher.model.forward)),
                (inference, "decode_from_output", self.timed("decode", inference.decode_from_output, sync=True)),
                (matcher, "match_images", self.timed("match_images", matcher.match_images)),
                (inference, "magsac_inlier_filter", self.magsac_filter(inference.magsac_inlier_filter)))

    def stages(self):
        ms = self.ms
        return {"read": ms["read"], "resize": ms["resize"], "SIFT detect and describe": ms["detect"],
                "NMS": ms["nms"], "keypoints to arrays, top-k, LAFs and pad": ms["extractor"] - ms["detect"] - ms["nms"],
                "prepare and copy": ms["prepare"], "forward": ms["forward"], "decode": ms["decode"],
                "copy back and the rest": ms["match_images"] - ms["resize"] - ms["extractor"] - ms["prepare"]
                - ms["forward"] - ms["decode"], "MAGSAC": ms["magsac"]}


def serving_pairs(images: Path):
    """SERVING_IMAGES fixture images (1280x1024) in ``images``, each beside a
    copy warped by ``serving_homography``: [(image, warped copy, H)]."""
    import cv2

    from openglue_tpu_torch.data import fixture, io

    fixture.generate_image_fixture(images, num_images=SERVING_IMAGES, image_size=(1280, 1024), seed=0)
    pairs = []
    for i in range(SERVING_IMAGES):
        a = images / f"img{i:04d}.jpg"
        b = images / f"img{i:04d}_warped.png"
        H = serving_homography(i)
        cv2.imwrite(str(b), cv2.warpPerspective(io.read_grayscale(a), H, (1280, 1024)))
        pairs.append((a, b, H))
    return pairs


def f32_twin(model, device):
    """The served matcher's f32 twin: the same weights, chain_dtype None, no quantize."""
    from openglue_tpu_torch.models.superglue import SuperGlue

    twin = SuperGlue(dataclasses.replace(model.config, chain_dtype=None, quantize=None), device=device).eval()
    twin.load_state_dict(model.state_dict())
    return twin


def held_forward(m, twin, fwd, name):
    """A served forward (``fwd``: its inputs and output) against its plain
    path: the served chain is bf16 (int8 for the int8_static matcher), which
    the kernels and the plain versions round differently, each as validly:
    at random weights the assignment is nearly flat (top-two margins under
    1e-3 nats), so the decode at threshold 0 flips with the rounding.
    ``compare``'s bars hold the same request on the f32 ``twin`` (chain_dtype
    None, no quantize, the same weights); the served forward is held to
    log_P within LOG_P_NATS of its plain path, and its decode's disagreement
    with the plain f32 path to at most BF16_DISTANCE_RATIO times its plain
    path's, or to compare's 1 - DECODE_AGREEMENT where that is larger.
    Returns (the plain path's output, the readings)."""
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk

    kw = fwd["kw"]
    with torch.no_grad():
        out32 = twin(**kw)
        with plain_versions(glk, sk, gli8):
            ref32, ref = twin(**kw), m.model(**kw)
    nats, stats = compare(decode_from_output, out32, ref32, kw, f"{name} f32 twin")
    got = decode_readings(decode_from_output, fwd["out"], ref, kw)
    d_kernel = 1 - decode_readings(decode_from_output, fwd["out"], ref32, kw)["matches@0"]
    d_plain = 1 - decode_readings(decode_from_output, ref, ref32, kw)["matches@0"]
    bar = max(BF16_DISTANCE_RATIO * d_plain, 1 - DECODE_AGREEMENT)
    check(got["nats_max"] <= LOG_P_NATS and d_kernel <= bar,
          f"{name}: vs its plain path {got}; decode disagreement with the plain f32 path {d_kernel} "
          f"(kernels) vs {d_plain} (plain), bar {bar}")
    return ref, (f"vs plain path {got['nats_max']:.3e} nats, decode {got['matches@0']:.4f} at threshold 0, row "
                 f"argmax {got['row_argmax']:.4f}; decode disagreement with the plain f32 path {d_kernel:.4f} "
                 f"(its plain path {d_plain:.4f}; bar {bar:.4f}); f32 twin vs its plain path {nats:.3e} nats, decode "
                 f"{json.dumps(stats)}")


def serving_cli_phase(card, repo: Path, store: MemoryH5, work: Path, trained, device="cuda"):
    """The port's serving and evaluation entry points on the card, at the
    SIFT serving shape (configs/features/sift_opencv.yaml: OpenCV SIFT,
    D=128, up to 2048 keypoints, RootSIFT; the CLI's 960x720 target) with
    the flagship ``superglue:`` section and seeded random weights:
    ``cli.extract_features.main`` over SERVING_IMAGES fixture images and
    their warped copies (h5 files in ``store``); an experiment
    (config.yaml with inference buckets 512/1024/2048 at threshold 0.2,
    features_config.yaml, checkpoints/0.pt); ``initialize_matcher`` ->
    ``precompile`` -> ``run_inference`` on every pair, each request's stage
    times, bucket, launches (36 K1 + 1 K2), host synchronizations, and its
    forward held against the plain versions on its own inputs (``compare``);
    the geometry of the matches at threshold 0 after MAGSAC against the
    known homography; ``main`` once with --output and --visualize; a request
    in the 512 bucket; an ``int8_static`` matcher (refused before its first
    pair calibrates it, then 36 K7 launches of 6 kernels each and no K1,
    held against the int8 plain path and the bf16 matcher); and
    ``cli.evaluate.main`` on the trainer phase's experiment and fixture at
    the checkpoint of fit's validation (36 K1 + 1 K2 per batch), its
    metrics against fit's. Returns the launches of the phase by kernel."""
    import numpy as np
    import yaml

    from openglue_tpu_torch.cli import evaluate, extract_features, inference
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.core.config import load_config
    from openglue_tpu_torch.data import io
    from openglue_tpu_torch.features import opencv_features
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train import step as step_mod
    from openglue_tpu_torch.train.checkpoint import save_train_state
    from openglue_tpu_torch.train.state import create_train_state

    import cv2

    phase_start = time.perf_counter()
    root = work / "serving"
    counters = {"K1": glk.counter, "K2": sk.counter, "K2s": sk.stream_counter, "K7": gli8.counter,
                "K7_kernels": gli8.launch_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2
    bf16_expected = {"K1": layers, "K2": 1, "K2s": 0, "K7": 0, "K7_kernels": 0}
    launches = collections.Counter()

    # ---- images: the fixture and a warped copy of each
    images = root / "images"
    pairs = serving_pairs(images)

    with replaced(*store.entries(io)):
        # ---- extraction through the cacher's entry point
        sift_yaml = repo / "configs" / "features" / "sift_opencv.yaml"
        saved = []

        def timed_save(out_dir, base, lafs, scores, descriptors, size):
            save_outputs(out_dir, base, lafs, scores, descriptors, size)
            saved.append((base, lafs.shape[0], descriptors.shape[1], tuple(size), time.perf_counter()))

        save_outputs = extract_features.save_outputs
        start = time.perf_counter()
        with replaced((extract_features, "save_outputs", timed_save)):
            extract_features.main(["--features_config", str(sift_yaml), "--data_dir", str(images),
                                   "--output_dir", str(root / "features")])
        handshake = root / "features" / "OPENCV_SIFT_960_720" / "config.yaml"
        features_config = load_config(sift_yaml)
        check(handshake.is_file() and load_config(handshake) == features_config,
              f"extract_features: the handshake {handshake} is missing or differs from {sift_yaml}")
        check(len(saved) == 2 * SERVING_IMAGES, f"extract_features: {len(saved)} images extracted")
        max_k = int(features_config["parameters"]["max_keypoints"])
        times = np.diff([start] + [t for *_, t in saved]) * 1e3
        for (base, n, d, size, _), ms in zip(saved, times):
            check(0 < n <= max_k and d == SIFT_DESCRIPTOR_DIM, f"extract_features {base}: {n} keypoints, D={d}")
        print("serving_cli extract_features (OPENCV_SIFT, 960x720 target, max 2048): "
              + "; ".join(f"{base} {w}x{h} {n} keypoints D={d} {ms:.1f} ms" for (base, n, d, (w, h), _), ms
                          in zip(saved, times))
              + f"; handshake {handshake.name} written [{card}]", flush=True)

        # ---- the experiment: flagship matcher section, SIFT features, a seeded initialization
        exp = root / "experiment"
        exp.mkdir(parents=True)
        config = {"superglue": SUPERGLUE_SECTION, "inference": {"match_threshold": MATCH_THRESHOLD,
                                                                 "buckets": SERVING_BUCKETS}}
        (exp / "config.yaml").write_text(yaml.safe_dump(config))
        shutil.copy(sift_yaml, exp / "features_config.yaml")
        cfg = superglue_config_from(config, SIFT_DESCRIPTOR_DIM, SIDE_INFO_DIM)
        init = SuperGlue(cfg, device=device, generator=torch.Generator().manual_seed(0))
        save_train_state(exp / "checkpoints", create_train_state(init), step=0)
        del init

        # ---- serving: initialize_matcher -> precompile -> run_inference on every pair
        matcher = inference.initialize_matcher(exp, device=device)
        check(matcher.buckets == tuple(SERVING_BUCKETS) and matcher.match_threshold == MATCH_THRESHOLD,
              f"initialize_matcher: buckets {matcher.buckets}, threshold {matcher.match_threshold}")
        start = time.perf_counter()
        matcher.precompile(matcher.buckets)
        precompile_s = time.perf_counter() - start
        probe = ServingProbe(counters)

        def request(m, a, b, name, expected, ransac=True):
            """One probed run_inference: (result, probe readings)."""
            probe.reset()
            with replaced(*probe.entries(inference, opencv_features, io, m)):
                start = time.perf_counter()
                result = inference.run_inference(m, a, b, ransac=ransac)
                total = (time.perf_counter() - start) * 1e3
            fwd = probe.forwards[-1]
            check(fwd["launches"] == expected, f"{name}: launches {fwd['launches']}, expected {expected}")
            launches.update(fwd["launches"])
            n = m._last_num_keypoints  # K2's K storage at this shape (f32 or bf16: two kernel rows)
            launches[f"K2 {sk.k_storage_dtype(n + 1, n + 1)}"] += fwd["launches"]["K2"]
            return result, dict(total_ms=total, stages=probe.stages(), forward=fwd, forwards=list(probe.forwards),
                                magsac=probe.magsac[-1] if probe.magsac else None, bucket=m._last_num_keypoints)

        def stage_line(m, r):
            """The stages' host ms, and the forward's device ms on the same
            inputs (``device_ms``: CUDA events, one call queued behind a busy
            card: the host takes longer to queue a forward than the device to
            run it, so several calls would time the host)."""
            with torch.no_grad():
                device = device_ms(lambda: m.model(**r["forward"]["kw"]), calls=1)
            return (", ".join(f"{k} {v:.2f}" for k, v in r["stages"].items())
                    + f" ms (forward device {device:.3f} ms); request {r['total_ms']:.1f} ms with the card "
                    f"synchronized after each device stage, the card busy {device / r['total_ms']:.4f} of it")

        # each forward against its plain path on an f32 twin (held_forward)
        twin = f32_twin(matcher.model, device)
        held = lambda m, fwd, name: held_forward(m, twin, fwd, name)

        def latency_ms(m, a, b, repeats=3):
            times = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                start = time.perf_counter()
                inference.run_inference(m, a, b)
                times.append((time.perf_counter() - start) * 1e3)
            return statistics.median(times)

        bf16_out = {}
        for i, (a, b, _) in enumerate(pairs):
            name = f"serving_cli pair {i} ({a.name}, {b.name})"
            result, r = request(matcher, a, b, name, bf16_expected)
            fwd = r["forward"]
            bf16_out[i] = fwd
            largest = fwd["out"]["decode_max0"].exp().max().item()
            before, after = r["magsac"] or (0, 0)
            print(f"{name}: bucket {r['bucket']} (valid {int(fwd['kw']['mask0'].sum())}/"
                  f"{int(fwd['kw']['mask1'].sum())}); {stage_line(matcher, r)}; not synchronized: "
                  f"{latency_ms(matcher, a, b):.1f} ms (median of 3); launches {json.dumps(fwd['launches'])}; matches "
                  f"at threshold {matcher.match_threshold}: {before} before MAGSAC, {after} after (largest confidence "
                  f"{largest:.3e}); {held(matcher, fwd, name)[1]} [{card}]", flush=True)
        a, b, _ = pairs[0]
        sites = sync_sites(lambda: inference.run_inference(matcher, a, b))
        print(f"serving_cli run_inference: {sum(sites.values())} host synchronizations per request "
              f"({', '.join(f'{n} at {w}' for w, n in sites.most_common())}); precompile (kernels built, a "
              f"forward at N={'/'.join(map(str, SERVING_BUCKETS))}) {precompile_s:.2f} s [{card}]", flush=True)

        # the cache and the server extract the same features from one image
        lafs, _, desc, mask, _ = matcher.extract(io.read_grayscale(a))
        cached = root / "features" / "OPENCV_SIFT_960_720" / f"{a.stem}_descriptors.h5"
        check(np.array_equal(io.load_h5(cached), desc[mask]), "the cached and the served descriptors differ")

        # ---- geometry: the mutual nearest neighbours (threshold 0) after MAGSAC
        geo = inference.initialize_matcher(exp, match_threshold=0.0, device=device)
        for i, (a, b, H) in enumerate(pairs):
            name = f"serving_cli geometry pair {i}"
            result, r = request(geo, a, b, name, bf16_expected)
            before, after = r["magsac"]
            scale = geo.target_size[0] / 1280  # 1280x1024 images, 960 wide at the 960x720 target
            error = reprojection_px(result["keypoints0"], result["keypoints1"], H, scale)
            median = float(np.median(error)) if len(error) else float("inf")
            print(f"{name}: threshold 0: {before} matches before MAGSAC, {after} after (MAGSAC "
                  f"{r['stages']['MAGSAC']:.2f} ms, request {r['total_ms']:.1f} ms), reprojection error under "
                  f"the known homography median {median:.3f} px, within 3 px {float(np.mean(error < 3)):.3f} "
                  f"(bars: at least {GEOMETRY_MIN_MATCHES} matches, median under {GEOMETRY_MAX_PX} px) [{card}]",
                  flush=True)
            check(after >= GEOMETRY_MIN_MATCHES and median < GEOMETRY_MAX_PX,
                  f"{name}: {after} matches after MAGSAC, median reprojection error {median} px")

        # ---- the command line once, with its files
        a, b, _ = pairs[0]
        before = {k: c.count for k, c in counters.items()}
        out = inference.main(["--experiment", str(exp), "--image0", str(a), "--image1", str(b), "--match_threshold",
                              "0", "--output", str(root / "matches.npz"), "--visualize", str(root / "matches.png"),
                              "--device", device])
        delta = {k: c.count - before[k] for k, c in counters.items()}
        check(delta == bf16_expected, f"inference.main: launches {delta}, expected {bf16_expected}")
        launches.update(delta)
        n = bf16_out[0]["kw"]["kpts0"].shape[1]  # pair 0's bucket
        launches[f"K2 {sk.k_storage_dtype(n + 1, n + 1)}"] += delta["K2"]
        saved_npz = np.load(root / "matches.npz")
        drawing = cv2.imread(str(root / "matches.png"))
        check(len(saved_npz["keypoints0"]) == len(out["keypoints0"]) >= GEOMETRY_MIN_MATCHES
              and drawing is not None and drawing.shape == (768, 1920, 3),
              f"inference.main: {len(saved_npz['keypoints0'])} saved matches, drawing "
              f"{None if drawing is None else drawing.shape}")
        print(f"serving_cli inference.main --match_threshold 0 --output --visualize: {len(out['keypoints0'])} "
              f"matches saved, drawing {drawing.shape[1]}x{drawing.shape[0]}", flush=True)

        # ---- a request in a smaller bucket
        small = inference.initialize_matcher(exp, target_size=SERVING_SMALL_TARGET, device=device)
        a, b, _ = pairs[1]
        name = f"serving_cli pair 1 at target {SERVING_SMALL_TARGET[0]}x{SERVING_SMALL_TARGET[1]}"
        _, r = request(small, a, b, name, bf16_expected)
        fwd = r["forward"]
        check(r["bucket"] < SERVING_BUCKETS[-1], f"{name}: bucket {r['bucket']}")
        print(f"{name}: bucket {r['bucket']} (valid {int(fwd['kw']['mask0'].sum())}/{int(fwd['kw']['mask1'].sum())}); "
              f"{stage_line(small, r)}; launches {json.dumps(fwd['launches'])}; {held(small, fwd, name)[1]} [{card}]",
              flush=True)
        del small, geo

        # ---- int8_static: calibrated by its first pair, then static scales
        exp8 = root / "experiment_int8_static"
        shutil.copytree(exp, exp8)
        config8 = dict(config, superglue=dict(SUPERGLUE_SECTION, quantize="int8_static"))
        (exp8 / "config.yaml").write_text(yaml.safe_dump(config8))
        q = inference.initialize_matcher(exp8, device=device)
        try:
            q.precompile(q.buckets)
            refused = None
        except RuntimeError as err:
            refused = str(err)
        check(refused is not None and "uncalibrated" in refused and not q.model.int8_calibration.calibrated,
              f"int8_static: precompile before calibration: {refused!r}")
        int8_expected = {"K1": 0, "K2": 1, "K2s": 0, "K7": layers, "K7_kernels": 6 * layers}
        for i, (a, b, _) in enumerate(pairs):
            name = f"serving_cli int8_static pair {i}"
            _, r = request(q, a, b, name, int8_expected)
            fwd = r["forward"]
            if i == 0:
                check(q.model.int8_calibration.calibrated and len(r["forwards"]) == 2,
                      f"{name}: the first pair did not calibrate ({len(r['forwards'])} forwards)")
                print(f"{name}: calibration pass launches {json.dumps(r['forwards'][0]['launches'])}", flush=True)
                q.precompile(q.buckets)
            # the row argmax against the bf16 matcher: at these nearly flat
            # assignments the int8 rounding flips rows as the bf16 one does,
            # so the kernels' disagreement is held to at most
            # BF16_DISTANCE_RATIO times the plain int8 path's with the plain
            # bf16 path, or to 1 - INT8_ROW_ARGMAX where that is larger
            ref, line = held(q, fwd, name)
            with torch.no_grad(), plain_versions(glk, sk):
                bf16_plain = matcher.model(**fwd["kw"])
            vs_bf16 = decode_readings(decode_from_output, fwd["out"], bf16_out[i]["out"], fwd["kw"])
            plain_rows = decode_readings(decode_from_output, ref, bf16_plain, fwd["kw"])["row_argmax"]
            bar = max(BF16_DISTANCE_RATIO * (1 - plain_rows), 1 - INT8_ROW_ARGMAX)
            check(1 - vs_bf16["row_argmax"] <= bar,
                  f"{name}: vs the bf16 matcher {vs_bf16}; row argmax disagreement {1 - vs_bf16['row_argmax']}, "
                  f"plain int8 vs plain bf16 {1 - plain_rows}, bar {bar}")
            print(f"{name}: bucket {r['bucket']}; {stage_line(q, r)}; launches {json.dumps(fwd['launches'])} "
                  f"({fwd['launches']['K7_kernels'] // layers} kernels per layer); vs the bf16 matcher "
                  f"{json.dumps(vs_bf16)}: row argmax disagreement {1 - vs_bf16['row_argmax']:.4f} (plain int8 vs "
                  f"plain bf16 {1 - plain_rows:.4f}; bar {bar:.4f}); {line} [{card}]", flush=True)
        del q, matcher, twin

        # ---- evaluation of the trainer phase's experiment at the step fit validated
        eval_expected = {"K1": layers, "K2": 1, "K2s": 0, "K7": 0, "K7_kernels": 0}
        eval_batches = []
        real_make_eval_step = step_mod.make_eval_step

        def make_eval_step(match_threshold):
            step = real_make_eval_step(match_threshold)

            def counted(state, batch):
                before = {k: c.count for k, c in counters.items()}
                out = step(state, batch)
                delta = {k: c.count - before[k] for k, c in counters.items()}
                check(delta == eval_expected, f"evaluate batch: launches {delta}, expected {eval_expected}")
                launches.update(delta)
                n = batch.side0.keypoints.shape[1]
                launches[f"K2 {sk.k_storage_dtype(n + 1, n + 1)}"] += delta["K2"]
                eval_batches.append(batch_key(batch))
                return out

            return counted

        start = time.perf_counter()
        with replaced((step_mod, "make_eval_step", make_eval_step)):
            metrics = evaluate.main(["--experiment", str(trained["experiment"]), "--checkpoint_step",
                                     str(trained["step"]), "--device", device])
        eval_s = time.perf_counter() - start
        fit_metrics = trained["eval_metrics"]
        # fit's validation groups the pairs by bucket, the CLI takes them in
        # order: when every pair fell in one bucket the batches are the same
        same = eval_batches == trained["eval_batches"]
        tol = 1e-6 if same else EVAL_METRIC_TOL
        diffs = {k: abs(metrics[k] - fit_metrics[k]) for k in metrics if not k.startswith("AUC")}
        print(f"serving_cli evaluate --checkpoint_step {trained['step']}: {len(eval_batches)} batches (N "
              f"{'/'.join(str(n) for n, _ in eval_batches)}, {sum(len(k) for _, k in eval_batches)} pairs), "
              f"{eval_s:.2f} s, launches per batch {json.dumps(eval_expected)}; {json.dumps(metrics)}; fit's "
              f"validation of the same state: {json.dumps(fit_metrics)}; the batches "
              f"{'are the same (shape, pairs, order)' if same else 'differ: fit groups its pairs by bucket'}; "
              f"|diff| {json.dumps(diffs)} (bar {tol}) [{card}]", flush=True)
        check(set(metrics) == set(fit_metrics) and all(d <= tol for d in diffs.values()),
              f"evaluate: {metrics} against fit's {fit_metrics} (bar {tol})")
    print(f"serving_cli phase: {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return dict(launches)


# the device extractors' phase (device_extractors_phase): the flagship's own
# features config, cached and served, and every other device extractor's
# config served once, on the serving phase's images
DEVICE_FEATURES = "configs/features/superpoint_magicleap.yaml"
OTHER_EXTRACTORS = ("configs/features_online/sift.yaml", "configs/features_online/gftt_affnet_hardnet.yaml",
                    "configs/features/dog_opencv_affnet_hardnet.yaml", "configs/features/superpoint_coco.yaml")
# the device SIFT pairs' matches at threshold 0 after MAGSAC under the known
# homography are held to the serving phase's bars (GEOMETRY_MIN_MATCHES,
# GEOMETRY_MAX_PX): at random matcher weights 16-28 of them are kept, at a
# median error of 0.64-2.58 px (an NVIDIA H100 80GB HBM3 at 700 W), not the
# 100 and 1.0 px first set for them; the line prints the descriptors' own
# mutual nearest neighbours beside OpenCV SIFT's


def flat_patches_line(ref, held):
    """Where the reference extraction's valid keypoints whose patch is flat lie."""
    xy = ref[0][ref[3] & ~held][:, :, 2]
    if not len(xy):
        return "; no keypoint on a flat patch"
    return (f"; {len(xy)} valid keypoints on flat patches, x {xy[:, 0].min():.1f}-{xy[:, 0].max():.1f}, "
            f"y {xy[:, 1].min():.1f}-{xy[:, 1].max():.1f}")


class ExtractorProbe(ServingProbe):
    """``ServingProbe`` for a matcher whose extractor computes on the card:
    the host time of read, resize, extraction (upload, the extractor, the
    seam mask and the one copy back; for OPENCVDoGAffNetHardNet the OpenCV
    detection on the host too), to-bucket, prepare, forward, decode, the
    rest of ``match_images`` and MAGSAC; and the extractor's device time by
    CUDA events around its device part (the module's forward, or
    ``describe``)."""

    def reset(self):
        super().reset()
        self.events = []

    def device_part(self, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        return run

    def entries(self, inference, io, matcher):
        extractor = matcher.extractor
        if matcher.device_extractor:
            extraction = [(inference, "extract_on_device", self.timed("extraction", inference.extract_on_device)),
                          (extractor, "forward", self.device_part(extractor.forward))]
        else:  # OpenCV's detection on the host, AffNet, OriNet and HardNet on the card
            extraction = [(extractor, "detect_and_compute", self.timed("extraction", extractor.detect_and_compute)),
                          (extractor.detector, "detect_and_compute",
                           self.timed("detect", extractor.detector.detect_and_compute)),
                          (extractor, "describe", self.device_part(extractor.describe))]
        return ((io, "read_grayscale", self.timed("read", io.read_grayscale)),
                (io, "aspect_preserving_resize", self.timed("resize", io.aspect_preserving_resize)),
                *extraction,
                (matcher, "_to_bucket", self.timed("to_bucket", matcher._to_bucket)),
                (inference, "prepare_features_output", self.timed("prepare", inference.prepare_features_output,
                                                                  sync=True)),
                (matcher.model, "forward", self.forward(matcher.model.forward)),
                (inference, "decode_from_output", self.timed("decode", inference.decode_from_output, sync=True)),
                (matcher, "match_images", self.timed("match_images", matcher.match_images)),
                (inference, "magsac_inlier_filter", self.magsac_filter(inference.magsac_inlier_filter)))

    def extraction_device_ms(self):
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.events)

    def stages(self):
        ms = self.ms
        out = {"read": ms["read"], "resize": ms["resize"], "extraction": ms["extraction"]}
        if "detect" in ms:
            out["of which OpenCV detection"] = ms["detect"]
        out.update({"to-bucket": ms["to_bucket"], "prepare and copy": ms["prepare"], "forward": ms["forward"],
                    "decode": ms["decode"],
                    "copy back and the rest": ms["match_images"] - ms["resize"] - ms["extraction"]
                    - ms["to_bucket"] - ms["prepare"] - ms["forward"] - ms["decode"],
                    "MAGSAC": ms["magsac"]})
        return out


def device_extractors_phase(card, repo: Path, store: MemoryH5, work: Path, device="cuda", target=(960, 720)):
    """The device extractors on the card, behind the cacher and the serving
    entry point, with seeded random weights (no trained extractor weights
    are in the repository):

    (a) ``cli.extract_features.main`` with configs/features/superpoint_magicleap.yaml
        (SuperPoint D=256, up to 2048 keypoints) over the serving phase's
        images and their warped copies at the CLI's 960x720 target (the
        1280x1024 images become 960x768): keypoints and ms per image, the
        handshake config.yaml, the extractor's device time;
    (b) a SuperPoint experiment (the flagship ``superglue:`` section,
        buckets 512/1024/2048): ``initialize_matcher`` -> ``precompile`` ->
        ``run_inference`` on every pair, each request's stages (the
        extraction by host and device time), bucket, launches (36 K1 + 1
        K2), each forward held against its plain path (``held_forward``);
        the host synchronizations of a request; the matches at threshold 0
        after MAGSAC against the known homography (printed, no bar: the
        weights are random);
    (c) each other config of OTHER_EXTRACTORS served once at its own shape
        (D=128 runs heads of width 32), the same readings;
    (d) every extractor on the card against the same module with the same
        weights on the CPU in f32, on one image, at the bars of
        ``features/agreement.py``;
    (e) the device SIFT pairs' matches at threshold 0 after MAGSAC under the
        known homography, at the serving phase's bars (GEOMETRY_MIN_MATCHES
        kept, median error under GEOMETRY_MAX_PX), with the descriptors' own
        mutual nearest neighbours beside OpenCV SIFT's.

    Returns the phase's launches by kernel (K2 by its K storage dtype too)."""
    import copy

    import numpy as np
    import yaml

    from openglue_tpu_torch.cli import extract_features, inference
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.core.config import Config, load_config
    from openglue_tpu_torch.data import io
    from openglue_tpu_torch.features import agreement as agree
    from openglue_tpu_torch.features.dog_affnet_hardnet import DoGAffNetHardNet
    from openglue_tpu_torch.features.prepare import to_device
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train.checkpoint import save_train_state
    from openglue_tpu_torch.train.state import create_train_state

    phase_start = time.perf_counter()
    root = work / "device_extractors"
    counters = {"K1": glk.counter, "K2": sk.counter, "K2s": sk.stream_counter}
    layers = 2 * SUPERGLUE_SECTION["attention_gnn"]["num_stages"] * 2
    expected = {"K1": layers, "K2": 1, "K2s": 0}
    launches = collections.Counter()
    pairs = serving_pairs(root / "images")
    sp_yaml = repo / DEVICE_FEATURES
    sp_config = load_config(sp_yaml)
    tw, th = target
    config = {"superglue": SUPERGLUE_SECTION, "inference": {"match_threshold": MATCH_THRESHOLD,
                                                             "buckets": SERVING_BUCKETS}}
    probe = ExtractorProbe(counters)
    twins = {}

    def request(m, a, b, name, ransac=True):
        """One probed run_inference: (result, readings)."""
        probe.reset()
        with replaced(*probe.entries(inference, io, m)):
            start = time.perf_counter()
            result = inference.run_inference(m, a, b, ransac=ransac)
            total = (time.perf_counter() - start) * 1e3
        fwd = probe.forwards[-1]
        check(fwd["launches"] == expected, f"{name}: launches {fwd['launches']}, expected {expected}")
        launches.update(fwd["launches"])
        n = m._last_num_keypoints
        launches[f"K2 {sk.k_storage_dtype(n + 1, n + 1)}"] += fwd["launches"]["K2"]
        return result, dict(total_ms=total, stages=probe.stages(), forward=fwd, bucket=n,
                            extraction_device_ms=probe.extraction_device_ms(), magsac=probe.magsac[-1])

    def request_line(m, r, name):
        """The request's readings, its forward held against its plain path."""
        fwd = r["forward"]
        twin = twins.setdefault(id(m), f32_twin(m.model, device))
        with torch.no_grad():
            forward_device = device_ms(lambda: m.model(**fwd["kw"]), calls=1)
        before, after = r["magsac"]
        return (f"bucket {r['bucket']} (valid {int(fwd['kw']['mask0'].sum())}/{int(fwd['kw']['mask1'].sum())}); "
                + ", ".join(f"{k} {v:.2f}" for k, v in r["stages"].items())
                + f" ms; extraction on the card {r['extraction_device_ms']:.3f} ms device time for both images, "
                f"forward device {forward_device:.3f} ms; request {r['total_ms']:.1f} ms with the card synchronized "
                f"after each device stage; launches {json.dumps(fwd['launches'])}; matches at threshold "
                f"{m.match_threshold}: {before} before MAGSAC, {after} after; "
                f"{held_forward(m, twin, fwd, name)[1]} [{card}]")

    def mutual_nn_within_3px(m, a, b, H):
        """The extractor's own mutual nearest neighbours (L2 of the
        descriptors, no matcher) on a pair: (count, within 3 px)."""
        fa, fb = (m.extract(io.read_grayscale(p)) for p in (a, b))
        da, db = fa[2][fa[3]].astype(np.float64), fb[2][fb[3]].astype(np.float64)
        d = (da * da).sum(1)[:, None] + (db * db).sum(1)[None] - 2 * da @ db.T
        n01, n10 = d.argmin(1), d.argmin(0)
        i = np.flatnonzero(n10[n01] == np.arange(len(da)))
        err = reprojection_px(fa[0][fa[3]][i, :, 2], fb[0][fb[3]][n01[i], :, 2], H, tw / 1280)
        return len(i), int((err < 3).sum())

    def geometry(m, name, min_matches=None, max_px=None):
        """The pairs' matches at threshold 0 after MAGSAC under the known homography."""
        m.match_threshold = 0.0
        readings = []
        for i, (a, b, H) in enumerate(pairs):
            result, r = request(m, a, b, f"{name} geometry pair {i}")
            scale = tw / 1280
            error = reprojection_px(result["keypoints0"], result["keypoints1"], H, scale)
            median = float(np.median(error)) if len(error) else float("inf")
            readings.append((r["magsac"][0], r["magsac"][1], median, float(np.mean(error < 3)) if len(error) else 0.0))
        bars = "" if min_matches is None else f" (bars: at least {min_matches} kept, median under {max_px} px)"
        a, b, H = pairs[0]
        mnn, good = mutual_nn_within_3px(m, a, b, H)
        print(f"{name} geometry at threshold 0: " + "; ".join(
            f"pair {i} {n0} matches, {n1} after MAGSAC, median error {med:.3f} px, within 3 px {w3:.3f}"
            for i, (n0, n1, med, w3) in enumerate(readings)) + f"{bars}; the descriptors' own mutual nearest "
              f"neighbours on pair 0: {mnn}, {good} within 3 px [{card}]", flush=True)
        if min_matches is not None:
            for i, (_, kept, med, _) in enumerate(readings):
                check(kept >= min_matches and med < max_px,
                      f"{name} geometry pair {i}: {kept} matches after MAGSAC, median error {med} px")

    with replaced(*store.entries(io)):
        # ---- (a) the cacher with SuperPoint
        saved = []

        def timed_save(out_dir, base, lafs, scores, descriptors, size):
            save_outputs(out_dir, base, lafs, scores, descriptors, size)
            saved.append((base, lafs.shape[0], descriptors.shape[1], tuple(size), time.perf_counter()))

        save_outputs = extract_features.save_outputs
        start = time.perf_counter()
        with replaced((extract_features, "save_outputs", timed_save)):
            extract_features.main(["--features_config", str(sp_yaml), "--data_dir", str(root / "images"),
                                   "--output_dir", str(root / "features"), "--target_size", str(tw), str(th),
                                   "--device", device])
        cache_s = time.perf_counter() - start
        handshake = root / "features" / f"SuperPointNet_{tw}_{th}" / "config.yaml"
        check(handshake.is_file() and load_config(handshake) == sp_config,
              f"extract_features: the handshake {handshake} is missing or differs from {sp_yaml}")
        check(len(saved) == 2 * SERVING_IMAGES, f"extract_features: {len(saved)} images extracted")
        max_k = int(sp_config["parameters"]["max_keypoints"])
        for base, n, d, size, _ in saved:
            check(0 < n <= max_k and d == DESCRIPTOR_DIM, f"extract_features {base}: {n} keypoints, D={d}")
        times = np.diff([start] + [t for *_, t in saved]) * 1e3
        model = extract_features.build_device_extractor(sp_config, None, device)
        image = io.aspect_preserving_resize(io.read_grayscale(pairs[0][0]), target)
        h, w = image.shape
        padded = np.zeros((-(-h // 8) * 8, -(-w // 8) * 8), np.float32)
        padded[:h, :w] = image / np.float32(255.0)
        x = to_device(padded[None], device)
        with torch.no_grad():
            sp_ms = device_ms(lambda: model(x), calls=5)
        print("device_extractors extract_features (SuperPointNet D=256, max 2048, 960x720 target): "
              + "; ".join(f"{base} {w}x{h} {n} keypoints {ms:.1f} ms" for (base, n, _, (w, h), _), ms
                          in zip(saved, times))
              + f"; {cache_s:.2f} s for {len(saved)} images with the first call; handshake {handshake.name} "
              f"written; SuperPoint's forward (extraction on the card, B=1 {padded.shape[1]}x{padded.shape[0]}) "
              f"{sp_ms:.3f} ms device time [{card}]", flush=True)
        del model

        # ---- (b) serving a SuperPoint experiment
        exp = root / "experiment"
        exp.mkdir(parents=True)
        (exp / "config.yaml").write_text(yaml.safe_dump(config))
        shutil.copy(sp_yaml, exp / "features_config.yaml")
        init = SuperGlue(superglue_config_from(config, DESCRIPTOR_DIM, SIDE_INFO_DIM), device=device,
                         generator=torch.Generator().manual_seed(0))
        save_train_state(exp / "checkpoints", create_train_state(init), step=0)
        del init
        matcher = inference.initialize_matcher(exp, target_size=target, device=device)
        check(matcher.device_extractor and matcher.buckets == tuple(SERVING_BUCKETS),
              f"initialize_matcher: device extractor {matcher.device_extractor}, buckets {matcher.buckets}")
        start = time.perf_counter()
        matcher.precompile(matcher.buckets)
        precompile_s = time.perf_counter() - start
        for i, (a, b, _) in enumerate(pairs):
            name = f"device_extractors SuperPoint pair {i} ({a.name}, {b.name})"
            _, r = request(matcher, a, b, name)
            print(f"{name}: {request_line(matcher, r, name)}", flush=True)
        a, b, _ = pairs[0]
        sites = sync_sites(lambda: inference.run_inference(matcher, a, b))
        print(f"device_extractors SuperPoint run_inference: {sum(sites.values())} host synchronizations per request "
              f"({', '.join(f'{n} at {where}' for where, n in sites.most_common())}); precompile {precompile_s:.2f} s "
              f"[{card}]", flush=True)
        geometry(matcher, "device_extractors SuperPoint")

        # ---- (c) the other extractors' configs, one pair each
        matchers = {"SuperPointNet": matcher}
        for rel in OTHER_EXTRACTORS:
            fc = load_config(repo / rel)
            m = inference.OpenGlueMatcher(Config(config), fc, target_size=target, device=device)
            m.precompile(m.buckets)
            name = f"device_extractors {fc['name']} ({rel}, D={fc['descriptor_dim']}, max {fc['parameters']['max_keypoints']})"
            a, b, _ = pairs[0]
            _, r = request(m, a, b, name)
            print(f"{name}, its first request: {r['total_ms']:.1f} ms, extraction {r['stages']['extraction']:.2f} ms "
                  f"(the card's first convolutions and sorts at these shapes)", flush=True)
            _, r = request(m, a, b, name)
            print(f"{name}: {request_line(m, r, name)}", flush=True)
            matchers[fc["name"]] = m

        # ---- (d) each extractor on the card against its CPU run
        image = io.aspect_preserving_resize(io.read_grayscale(pairs[0][0]), target)
        for name, m in matchers.items():
            if m.device_extractor:
                start = time.perf_counter()
                got = extract_features.extract_on_device(m.extractor, image, device)
                card_s = time.perf_counter() - start
                cpu = copy.deepcopy(m.extractor).cpu()
                start = time.perf_counter()
                ref = extract_features.extract_on_device(cpu, image, "cpu")
            else:
                ext = m.extractor
                start = time.perf_counter()
                got = ext.detect_and_compute(image)
                card_s = time.perf_counter() - start
                cpu = DoGAffNetHardNet(max_keypoints=ext.detector.max_keypoints, device="cpu")
                cpu.load_weights(ext.affnet.state_dict(), ext.orinet.state_dict(), ext.hardnet.state_dict())
                start = time.perf_counter()
                ref = cpu.detect_and_compute(image)
            cpu_s = time.perf_counter() - start
            patch_size = getattr(getattr(m.extractor, "config", m.extractor), "patch_size", None)
            held = None if patch_size is None else agree.textured(image, ref[0], patch_size)
            readings = agree.agreement(got, ref, held=held)
            flat = "" if held is None else flat_patches_line(ref, held)
            if m.device_extractor:
                x = to_device(padded[None], device)
                with torch.no_grad():
                    busy, top = device_profile(lambda: m.extractor(x))
            else:
                with torch.no_grad():
                    busy, top = device_profile(lambda: ext.detect_and_compute(image))
            print(f"device_extractors {name} card vs CPU (f32, {image.shape[1]}x{image.shape[0]}): "
                  f"{json.dumps(readings)}{flat}; bars: shared and same frame >= {agree.SHARED_MIN} within "
                  f"{agree.KEYPOINT_PX} px, and of those with the same frame >= {agree.SHARED_MIN} identified by "
                  f"their descriptors{'' if name == 'SIFT' else f' and within {agree.DESCRIPTOR_MAX}'} (patch "
                  f"descriptors: where the patch spans {agree.CONTRAST_MIN}), "
                  f"responses within {agree.RESPONSE_REL_MAX} relative; host {card_s * 1e3:.1f} ms on the card, "
                  f"{cpu_s * 1e3:.1f} ms on the CPU; one extraction's device busy {busy} ms, by kernel: "
                  + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in top) + f" [{card}]",
                  flush=True)
            check(agree.within_bars(readings, descriptor_max=name != "SIFT"), f"{name}: card vs CPU {readings}")

        # ---- (e) the device SIFT's geometry, beside OpenCV SIFT's descriptors; the SuperPoint pairs printed above
        geometry(matchers["SIFT"], "device_extractors SIFT", GEOMETRY_MIN_MATCHES, GEOMETRY_MAX_PX)
        ocv = inference.OpenGlueMatcher(Config(config), load_config(repo / "configs/features/sift_opencv.yaml"),
                                        target_size=target, device=device)
        a, b, H = pairs[0]
        mnn, good = mutual_nn_within_3px(ocv, a, b, H)
        print(f"device_extractors OpenCV SIFT (configs/features/sift_opencv.yaml, max 2048): the descriptors' own "
              f"mutual nearest neighbours on pair 0: {mnn}, {good} within 3 px [{card}]", flush=True)
        del matchers, matcher, m, ocv
    print(f"device_extractors phase: {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return dict(launches)


# the online trainer phase (online_trainer_phase): configs/homography_pretraining.yaml
# as written but for its image folder (generate_image_fixture's images at the
# dataset's resize size, target + 2 x warp offset), use_pallas, the steps and
# a validation of ONLINE_VAL_PAIRS pairs; then cli.train on configs/config.yaml
# with the online SuperPoint features config on the MegaDepth layout
ONLINE_IMAGES = 24  # the validation takes min(images, val_pairs) pairs
ONLINE_STEPS = 6  # the first is the warm-up
ONLINE_VAL_PAIRS = 24  # two batches of 12
ONLINE_MEGADEPTH = dict(scenes=4, images_per_scene=8, val_scenes=1, seed=13)
ONLINE_MEGADEPTH_STEPS = 3
ONLINE_MEGADEPTH_VAL_PAIRS = 6  # one batch of 6


class OnlineProbe:
    """What the online phase reads from inside the online CLIs, through
    wrappers of what ``cli.online.run_online_training`` looks up at call
    time: each train step (its launches checked, its host time with the card
    synchronized before and after it, a copy of the state and the batch of
    the first one), each eval batch (its launches checked), the validation
    sweep's metrics and seconds, and each wait on a loader's ``next()``."""

    def __init__(self, counters, train_expected, eval_expected, clone_train_state):
        self.counters, self.train_expected, self.eval_expected = counters, train_expected, eval_expected
        self.clone_train_state = clone_train_state
        self.train_steps, self.eval_batches = 0, 0
        self.step_ms, self.waits, self.first = [], [], None
        self.eval_metrics = self.eval_seconds = None

    def counts(self):
        return {k: c.count for k, c in self.counters.items()}

    def _checked(self, fn, expected, what):
        before = self.counts()
        out = fn()
        delta = {k: v - before[k] for k, v in self.counts().items()}
        check(delta == expected, f"online {what}: launches {delta}, expected {expected}")
        return out

    def make_train_step(self, real):
        def make(*args, **kwargs):
            step = real(*args, **kwargs)

            def probed(state, batch):
                i = self.train_steps
                self.train_steps += 1
                torch.cuda.synchronize()
                if self.first is None:
                    self.first = (self.clone_train_state(state), batch)
                start = time.perf_counter()
                metrics = self._checked(lambda: step(state, batch), self.train_expected, f"train step {i}")
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - start) * 1e3)
                check(all(math.isfinite(v.item()) for v in metrics.values()), f"online train step {i}: {metrics}")
                return metrics

            return probed

        return make

    def make_eval_step(self, real):
        def make(*args, **kwargs):
            step = real(*args, **kwargs)

            def probed(state, batch):
                self.eval_batches += 1
                return self._checked(lambda: step(state, batch), self.eval_expected, f"eval batch {self.eval_batches}")

            return probed

        return make

    def evaluate(self, real):
        def probed(*args, **kwargs):
            start = time.perf_counter()
            self.eval_metrics = real(*args, **kwargs)
            self.eval_seconds = time.perf_counter() - start
            return self.eval_metrics

        return probed

    def loader_iter(self, real_iter):
        probe = self

        def probed(loader):
            it = real_iter(loader)
            while True:
                start = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                probe.waits.append((time.perf_counter() - start) * 1e3)
                yield batch

        return probed

    def entries(self, step_mod, loop, loader_mod):
        return ((step_mod, "make_online_train_step", self.make_train_step(step_mod.make_online_train_step)),
                (step_mod, "make_online_eval_step", self.make_eval_step(step_mod.make_online_eval_step)),
                (loop, "evaluate_online", self.evaluate(loop.evaluate_online)),
                (loader_mod.DataLoader, "__iter__", self.loader_iter(loader_mod.DataLoader.__iter__)))


def write_megadepth_images(store: MemoryH5, root: Path, seed=0):
    """A grayscale image beside each depth map of a ``generate_megadepth_fixture``
    tree (``dense0/imgs/<name>.jpg``, the depth map's size): a smooth random
    field with discs, shaded by the depth, so that an extractor finds
    corners. The package's fixture writes no images."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    depths = sorted(p for p in store.files if "/dense0/depths/" in p and p.startswith(str(root.resolve())))
    for path in depths:
        depth = store.load_h5(path, key="depth")
        h, w = depth.shape
        field = cv2.resize(rng.random((h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        image = 60 + 120 * field + 20 * np.sin(depth * 4.0)
        for _ in range(60):
            cv2.circle(image, (int(rng.integers(0, w)), int(rng.integers(0, h))), int(rng.integers(3, 20)),
                       float(rng.uniform(0, 255)), -1)
        out = Path(path).parent.parent / "imgs" / (Path(path).stem + ".jpg")
        out.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out), np.clip(image, 0, 255).astype(np.uint8))
    return len(depths)


def online_trainer_phase(card, repo: Path, store: MemoryH5, work: Path, device="cuda"):
    """The online trainer end to end (module 9b), with seeded random
    weights. (a) ``cli.pretrain_homography.main`` with
    configs/homography_pretraining.yaml as written (B=12, 960x720, warp
    offset 256, SuperPoint up to 1024 keypoints D=256, the 9-stage matcher,
    weak_color_aug, a frozen extractor) and an override that changes only
    the image folder (ONLINE_IMAGES fixture images), use_pallas (true, so
    that K1-K5 run), the steps (ONLINE_STEPS) and a validation of
    ONLINE_VAL_PAIRS pairs (``evaluate_online``, the homography precision):
    36 K4 + 36 K5 + 1 K2 + 1 K3 per step, 36 K1 + 1 K2 per eval batch,
    every step finite, the extractor's parameters and buffers unchanged bit
    for bit; the first step from a copy of its state and batch, kernels
    against the plain versions, at train_phase's f32 bars; the augmentation
    on the card against its CPU run with the same draws; the step's time,
    busy time and idle share, the extraction's device time, the host
    synchronizations, the loader's wait and the peak memory. (b)
    ``cli.train.main`` with configs/config.yaml (B=6, 960x720) and
    configs/features_online/superpoint_magicleap.yaml on the MegaDepth
    layout (``generate_megadepth_fixture``, its depths in ``store``, and
    images this phase writes), ONLINE_MEGADEPTH_STEPS steps and one
    validation batch, the launches checked as in (a). (c)
    ``cli.inference.initialize_matcher`` on (a)'s experiment serves one pair
    with the extractor its checkpoint holds: 36 K1 + 1 K2, the forward held
    against its plain path at ``compare``'s bars. Returns the launches of
    the three runs by kernel."""
    import cv2
    import yaml

    from openglue_tpu_torch import augmentations as aug
    from openglue_tpu_torch.cli import common, inference, pretrain_homography
    from openglue_tpu_torch.cli import train as online_train
    from openglue_tpu_torch.data import fixture, io
    from openglue_tpu_torch.data import loader as loader_mod
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.train import loop
    from openglue_tpu_torch.train import step as step_mod
    from openglue_tpu_torch.train.state import clone_train_state

    phase_start = time.perf_counter()
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "autograd_sinkhorn": sk.autograd_counter}
    total = collections.Counter()

    # ---- (a) homography pretraining at the config's width
    base = repo / "configs" / "homography_pretraining.yaml"
    written = common.load_merged_config(str(base))
    (tw, th), off = written["data"]["target_size"], int(written["data"]["warp_offset"])
    images = work / "online_images"
    start = time.perf_counter()
    fixture.generate_image_fixture(images, num_images=ONLINE_IMAGES, image_size=(tw + 2 * off, th + 2 * off), seed=11)
    fixture_s = time.perf_counter() - start
    override = {"data": {"root_path": str(images), "val_pairs": ONLINE_VAL_PAIRS},
                "logging": {"root_path": str(work / "online_logs")},
                "train": {"epochs": 1, "steps_per_epoch": ONLINE_STEPS, "evaluation": True},
                "superglue": {"use_pallas": True}}
    (work / "online.yaml").write_text(yaml.safe_dump(override))
    config = common.load_merged_config(str(base), str(work / "online.yaml"))
    layers = 2 * int(config.get("superglue.attention_gnn.num_stages")) * 2
    train_expected = {"K1": 0, "K2": 1, "K3": 1, "K4": layers, "K5": layers, "autograd_sinkhorn": 0}
    eval_expected = {"K1": layers, "K2": 1, "K3": 0, "K4": 0, "K5": 0, "autograd_sinkhorn": 0}
    probe = OnlineProbe(counters, train_expected, eval_expected, clone_train_state)
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    with replaced(*probe.entries(step_mod, loop, loader_mod)):
        state = pretrain_homography.main(["--config", str(base), "--config_override", str(work / "online.yaml"),
                                          "--device", device])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: c.count for k, c in counters.items()}
    total.update(launches)
    batch = int(config.get("data.batch_size"))
    check(state.step == ONLINE_STEPS and probe.train_steps == ONLINE_STEPS,
          f"online pretraining: state.step {state.step}, probed steps {probe.train_steps}, expected {ONLINE_STEPS}: "
          f"run_online_training no longer looks up make_online_train_step in train.step when it runs")
    check(probe.eval_batches == ONLINE_VAL_PAIRS // batch, f"online validation: {probe.eval_batches} batches")
    metrics = probe.eval_metrics
    check(metrics is not None and "H-Precision@3.0px" in metrics and all(math.isfinite(v) for v in metrics.values()),
          f"online validation: {metrics}")
    saved, first_batch = probe.first
    before, after = saved.model.extractor.state_dict(), state.model.extractor.state_dict()
    check(set(before) == set(after) and all(torch.equal(before[k], after[k]) for k in before),
          "online pretraining: the frozen extractor changed")
    check(not torch.equal(saved.model.superglue.dustbin_score, state.model.superglue.dustbin_score),
          "online pretraining: the matcher did not change")

    # the first step from a copy of its state and batch, kernels against plain
    loss_config = common.loss_config_from(config)
    augmentation = config.get("train.augmentations.name")
    step = step_mod.make_online_train_step(loss_config, augmentation=augmentation)
    kernel, plain = clone_train_state(saved), clone_train_state(saved)
    m_kernel = step(kernel, first_batch)
    with plain_versions(glk, sk):
        m_plain = step(plain, first_batch)
    torch.cuda.synchronize()
    name = f"online pretraining first step B={batch} {tw}x{th} N={config.get('features.parameters.max_keypoints')}"
    compare_steps(kernel.model, plain.model, m_kernel, m_plain, f"{name}, kernels vs plain",
                  loss_tol=1e-3, norm_tol=0.01, cos_min=0.999, stats_tol=1e-3)
    del kernel, plain

    # the augmentation on the card against its CPU run with the same draws
    x = first_batch["image0"]
    draws = aug.draw_weak_color_aug(torch.Generator(device=device).manual_seed(0), x)
    on_card = aug.apply_weak_color_aug(x, draws).cpu()
    on_cpu = aug.apply_weak_color_aug(x.cpu(), {k: v.cpu() for k, v in draws.items()})
    every = torch.ones(x.shape[0], dtype=torch.bool)
    equalized = torch.equal(aug.equalize(x, every.to(device)).cpu(), aug.equalize(x.cpu(), every))
    aug_err = (on_card - on_cpu).abs().max().item()
    check(equalized and aug_err <= 1e-6, f"online weak_color_aug: card vs CPU {aug_err}, equalize equal {equalized}")

    # one more step on a copy of the trained state: the profile, the
    # extraction's device time and the host synchronizations
    copy_ = clone_train_state(state)
    busy, kernels_by_time = device_profile(lambda: step(copy_, first_batch), top=6)
    pair_images = torch.cat([first_batch["image0"], first_batch["image1"]], dim=0)
    extract_ms = device_ms(lambda: copy_.model.extract(pair_images), calls=3)
    sites = sync_sites(lambda: step(copy_, first_batch))
    step_ms = statistics.median(probe.step_ms[1:])
    idle = "not measured" if busy is None else f"{1 - busy / step_ms:.3f}"
    matcher_ms = "not measured" if busy is None else f"{busy - extract_ms:.3f}"
    print(f"online pretraining B={batch} {tw}x{th} (configs/homography_pretraining.yaml, {augmentation}, frozen "
          f"SuperPoint, use_pallas): {ONLINE_STEPS} steps and {probe.eval_batches} validation batches in "
          f"{run_s:.1f} s (main() whole; the image fixture {fixture_s:.1f} s before it); step {step_ms:.3f} ms "
          f"(median of {len(probe.step_ms) - 1} synchronized steps after the first; all "
          f"{', '.join(f'{t:.1f}' for t in probe.step_ms)}), {batch / step_ms * 1e3:.2f} pairs/s, device busy "
          f"{busy} ms a step, idle share {idle}; extraction (2B={2 * batch} images, one call) {extract_ms:.3f} "
          f"device ms, the rest of the step {matcher_ms} device ms; {sum(sites.values())} host synchronizations a "
          f"step ({', '.join(f'{n} at {w}' for w, n in sites.most_common())}); loader next() wait median "
          f"{statistics.median(probe.waits):.3f} ms (max {max(probe.waits):.3f}, {len(probe.waits)} batches); "
          f"peak memory {peak:.2f} GiB; augmentation card vs CPU with the same draws {aug_err:.3e} (equalize "
          f"equal); launches per step {json.dumps(train_expected)}, per eval batch {json.dumps(eval_expected)} "
          f"[{card}]", flush=True)
    print("  device time by kernel, online pretraining step: "
          + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time), flush=True)
    print(f"online validation: {probe.eval_batches} batches, {probe.eval_seconds:.2f} s, {json.dumps(metrics)} "
          f"[{card}]", flush=True)
    del copy_, saved, first_batch, state

    # ---- (b) cli.train on the MegaDepth layout at configs/config.yaml's width
    with replaced(*store.entries(io)):
        root = work / "online_megadepth"
        start = time.perf_counter()
        stats = fixture.generate_megadepth_fixture(root, **ONLINE_MEGADEPTH)
        written_images = write_megadepth_images(store, root)
        # the fixture's cameras sit close together: of its training pairs one
        # lies inside the config's overlap range [0.15, 0.7] (the rest 0.66-0.94)
        md_override = {
            "data": {"root_path": str(root), "val_max_pairs_per_scene": ONLINE_MEGADEPTH_VAL_PAIRS,
                     "train_pairs_overlap": None},
            "logging": {"root_path": str(work / "online_logs")},
            "train": {"epochs": 1, "steps_per_epoch": ONLINE_MEGADEPTH_STEPS},
            "superglue": {"use_pallas": True},
        }
        (work / "online_md.yaml").write_text(yaml.safe_dump(md_override))
        md_fixture_s = time.perf_counter() - start
        md_probe = OnlineProbe(counters, train_expected, eval_expected, clone_train_state)
        for c in counters.values():
            c.reset()
        start = time.perf_counter()
        with replaced(*md_probe.entries(step_mod, loop, loader_mod)):
            md_state = online_train.main(["--config", str(repo / "configs" / "config.yaml"), "--config_override",
                                          str(work / "online_md.yaml"), "--features_config",
                                          str(repo / "configs/features_online/superpoint_magicleap.yaml"),
                                          "--device", device])
        torch.cuda.synchronize()
        md_s = time.perf_counter() - start
    md_launches = {k: c.count for k, c in counters.items()}
    total.update(md_launches)
    check(md_state.step == ONLINE_MEGADEPTH_STEPS and md_probe.eval_batches == 1,
          f"online MegaDepth: {md_state.step} steps, {md_probe.eval_batches} eval batches")
    md_metrics = md_probe.eval_metrics
    check(md_metrics is not None and "AUC@5deg" in md_metrics and all(math.isfinite(v) for v in md_metrics.values()),
          f"online MegaDepth validation: {md_metrics}")
    md_config = common.load_merged_config(str(repo / "configs" / "config.yaml"), str(work / "online_md.yaml"))
    print(f"online MegaDepth B={md_config.get('data.batch_size')} {'x'.join(map(str, md_config['data']['target_size']))} "
          f"(configs/config.yaml, configs/features_online/superpoint_magicleap.yaml): fixture {len(stats['scenes'])} "
          f"scenes, {stats['pairs']} pairs, {written_images} images written, {md_fixture_s:.1f} s; "
          f"{ONLINE_MEGADEPTH_STEPS} steps and 1 validation batch in {md_s:.1f} s; steps "
          f"{', '.join(f'{t:.1f}' for t in md_probe.step_ms)} ms (synchronized); loader next() wait median "
          f"{statistics.median(md_probe.waits):.3f} ms; validation {json.dumps(md_metrics)}; launches "
          f"{json.dumps(md_launches)} [{card}]", flush=True)
    del md_state

    # ---- (c) the pretraining experiment served with its own extractor
    experiment = next((work / "online_logs").glob("pretrain_superpoint/*/checkpoints")).parent
    matcher = inference.initialize_matcher(experiment, target_size=(tw, th), device=device)
    a = images / "img0000.jpg"
    b = work / "online_warped.png"
    cv2.imwrite(str(b), cv2.warpPerspective(io.read_grayscale(a), serving_homography(0, (tw + 2 * off, th + 2 * off)),
                                            (tw + 2 * off, th + 2 * off)))
    forwards = []
    real_forward = matcher.model.forward

    def forward(**kw):
        before = {k: c.count for k, c in counters.items()}
        out = real_forward(**kw)
        forwards.append((kw, out, {k: c.count - before[k] for k, c in counters.items()}))
        return out

    with replaced((matcher.model, "forward", forward)):
        inference.run_inference(matcher, a, b, ransac=False)  # the first request builds and warms
        forwards.clear()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = inference.run_inference(matcher, a, b, ransac=False)
        request_ms = (time.perf_counter() - start) * 1e3
    (kw, out, served), = forwards
    total.update(served)
    check(served == eval_expected, f"online experiment served: launches {served}, expected {eval_expected}")
    with torch.no_grad(), plain_versions(glk, sk):
        ref = matcher.model(**kw)
    nats, decode = compare(decode_from_output, out, ref, kw, "online experiment served")
    print(f"online experiment served (initialize_matcher on the pretraining experiment, its extractor from the "
          f"checkpoint): a request {request_ms:.1f} ms, N={kw['kpts0'].shape[1]}, {len(result['keypoints0'])} "
          f"matches at threshold {matcher.match_threshold}; launches {json.dumps(served)}; vs plain path "
          f"{nats:.3e} nats, decode {json.dumps(decode)} [{card}]", flush=True)
    del matcher
    print(f"online_trainer phase: {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return dict(total)


# the flagship flags of examples/train_pose_auc_synthetic_torch.py (as the
# JAX package's quality run of its example sets them) and the phase's steps
EXAMPLE_FLAGSHIP = ["--stages", "9", "--dim", "256", "--kpts", "1024", "--bf16", "--chain-bf16", "--pallas",
                    "--warmup", "500"]
EXAMPLE_STEPS = 20


def load_example(repo: Path, name: str):
    """``examples/<name>.py`` of the checkout as a module, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", repo / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


class ExampleProbe:
    """What the examples phase reads from inside the pose-AUC example's
    ``main``, through wrappers of the step builders it looks up when it
    runs: each train step's launches (checked against ``train_expected``),
    the last step's batch, and each eval batch's launches (checked against
    ``eval_expected`` by the model's ``quantize``). Nothing here
    synchronizes the card."""

    def __init__(self, counters, train_expected, eval_expected):
        self.counters, self.train_expected, self.eval_expected = counters, train_expected, eval_expected
        self.train_steps, self.eval_batches, self.last_batch = 0, collections.Counter(), None

    def _checked(self, fn, expected, what):
        before = {k: c.count for k, c in self.counters.items()}
        out = fn()
        delta = {k: c.count - before[k] for k, c in self.counters.items()}
        check(delta == expected, f"pose-AUC example {what}: launches {delta}, expected {expected}")
        return out

    def entries(self, example):
        real_train, real_eval = example.make_train_step, example.make_eval_step

        def make_train_step(*args, **kwargs):
            step = real_train(*args, **kwargs)

            def probed(state, batch):
                self.train_steps += 1
                self.last_batch = batch
                return self._checked(lambda: step(state, batch), self.train_expected, f"step {self.train_steps}")

            return probed

        def make_eval_step(*args, **kwargs):
            step = real_eval(*args, **kwargs)

            def probed(state, batch):
                mode = state.model.config.quantize or "bf16"
                self.eval_batches[mode] += 1
                return self._checked(lambda: step(state, batch), self.eval_expected[mode],
                                     f"{mode} eval batch {self.eval_batches[mode]}")

            return probed

        return ((example, "make_train_step", make_train_step), (example, "make_eval_step", make_eval_step))


def with_decode_stats(out, inputs):
    """``out`` with the decode statistics ``compare`` reads (the example's
    config leaves ``decode_stats`` off)."""
    from openglue_tpu_torch.models.matching import assignment_stats

    out = dict(out)
    out["decode_indices0"], out["decode_indices1"], out["decode_max0"] = assignment_stats(
        out["scores"], mask0=inputs["mask0"], mask1=inputs["mask1"])
    return out


EXAMPLE_LAYER_ULPS = 2  # a layer launch against its plain version on the same inputs
EXAMPLE_WITNESS_RATIO = 2.0  # the kernel path's distance from the plain path, as a multiple of the plain path's own
EXAMPLE_WITNESS_SLACK = 1e-3  # added to each of those bars (nats, and shares of rows)


def launch_ulps(model, inputs, module, name, plain):
    """Each launch of ``module.name`` in one forward of ``model`` against
    ``plain`` on the same inputs: max |kernel - plain| in bf16 ulps of the
    plain output's largest magnitude (2^-7 of it), one value a launch."""
    real, ulps = getattr(module, name), []

    def held(*args, **kwargs):
        out, ref = real(*args, **kwargs), plain(*args, **kwargs)
        out, ref = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
        ulps.append(((out.float() - ref.float()).abs().max() / (ref.float().abs().max() * 2.0**-7)).item())
        return out

    with replaced((module, name, held)):
        model(**inputs)
    return ulps


def perturbed(inputs, seed=5):
    """The inputs with each descriptor entry times 1 + 1e-6 u."""
    gen = torch.Generator(device=inputs["desc0"].device).manual_seed(seed)
    moved = dict(inputs)
    for key in ("desc0", "desc1"):
        moved[key] = inputs[key] * (1 + 1e-6 * torch.rand(inputs[key].shape, generator=gen, device=gen.device))
    return moved


def held_by_witness(name, got, own):
    """``got`` (decode_readings of the kernel path against the plain path)
    within EXAMPLE_WITNESS_RATIO of ``own`` (the plain path against itself
    on moved inputs), plus EXAMPLE_WITNESS_SLACK, in log_P nats and in the
    shares of rows whose decode at threshold 0 and row argmax differ."""
    r, slack = EXAMPLE_WITNESS_RATIO, EXAMPLE_WITNESS_SLACK
    fine = (got["nats_max"] <= r * own["nats_max"] + slack
            and 1 - got["matches@0"] <= r * (1 - own["matches@0"]) + slack
            and 1 - got["row_argmax"] <= r * (1 - own["row_argmax"]) + slack)
    check(fine, f"{name}: kernels vs plain {got} past {r}x the plain path's own distance {own} + {slack}")


def examples_phase(card, repo: Path, work: Path, device="cuda"):
    """The port's three examples on the card. examples/match_synthetic_torch.py
    and examples/pretrain_and_match_images_torch.py at their defaults (no
    use_pallas: no kernel launch); examples/train_pose_auc_synthetic_torch.py
    at the flagship flags (D=256, 9 stages, N=1024, B=8, bf16 compute and
    chain, the kernels, warm-up 500) for EXAMPLE_STEPS steps and one
    evaluation, with ``--eval-int8``: 36 K4 + 36 K5 + 1 K2 + 1 K3 per step,
    36 K1 + 1 K2 per held-out batch and 36 K7 + 1 K2 per int8 batch; then
    its held-out batches at the trained weights, bf16 (K1) and int8 (K7):
    each layer launch of the first against its plain version on the same
    inputs (EXAMPLE_LAYER_ULPS), and each forward against the plain path
    within EXAMPLE_WITNESS_RATIO of the plain path's own distance when the
    descriptors move by 1e-6 (``held_by_witness``); both ``evaluate`` rows;
    on a copy of the state a synchronized step's time, its device busy time
    and its host synchronizations (none may occur); an eval forward's busy
    time and its time by ``device_timeit``. Returns the launches by
    kernel."""
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.profiling import device_timeit
    from openglue_tpu_torch.train.state import clone_train_state
    from openglue_tpu_torch.train.step import superglue_inputs

    phase_start = time.perf_counter()
    counters = {"K1": glk.counter, "K2": sk.counter, "K3": sk.adjoint_counter, "K4": glk.message_counter,
                "K5": glk.message_bwd_counter, "K7": gli8.counter, "autograd_sinkhorn": sk.autograd_counter}
    none = {k: 0 for k in counters}
    total = collections.Counter()

    # ---- the two examples without kernels, at their defaults
    for name, argv in (("match_synthetic_torch", ["--device", device]),
                       ("pretrain_and_match_images_torch", ["--workdir", str(work / "demo"), "--device", device])):
        example = load_example(repo, name)
        for c in counters.values():
            c.reset()
        start = time.perf_counter()
        result = example.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        state = result[0] if isinstance(result, tuple) else result
        launches = {k: c.count for k, c in counters.items()}
        check(launches == none, f"{name}: launches {launches}, expected none")
        check(all(torch.isfinite(p).all() for p in state.model.parameters()), f"{name}: non-finite parameters")
        print(f"example {name} (its defaults): {state.step} steps, {seconds:.1f} s (main() whole), no kernel "
              f"launch [{card}]", flush=True)
    check((work / "demo" / "matches.png").stat().st_size > 0, "pretrain_and_match_images_torch: no matches.png")

    # ---- the pose-AUC example at the flagship flags, counted
    example = load_example(repo, "train_pose_auc_synthetic_torch")
    argv = [*EXAMPLE_FLAGSHIP, "--epochs", "1", "--steps-per-epoch", str(EXAMPLE_STEPS), "--eval-int8",
            "--device", device]
    args = example.parse_args(argv)
    layers = 2 * args.stages * 2
    train_expected = dict(none, K2=1, K3=1, K4=layers, K5=layers)
    eval_expected = {"bf16": dict(none, K1=layers, K2=1), "int8": dict(none, K7=layers, K2=1)}
    probe = ExampleProbe(counters, train_expected, eval_expected)
    for c in counters.values():
        c.reset()
    start = time.perf_counter()
    with replaced(*probe.entries(example)):
        state, rows = example.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - start
    launches = {k: c.count for k, c in counters.items()}
    total.update(launches)
    held = example.held_out_batches(example.pair_generator(args), args.batch, device)
    n = args.kpts
    total[f"K2 {sk.k_storage_dtype(n + 1, n + 1)}"] += launches["K2"]
    check(state.step == EXAMPLE_STEPS == probe.train_steps,
          f"pose-AUC example: state.step {state.step}, probed steps {probe.train_steps}: main no longer looks up "
          f"make_train_step in its module when it runs")
    check(probe.eval_batches == {"bf16": len(held), "int8": len(held)}, f"eval batches {dict(probe.eval_batches)}")
    check(len(rows) == 2 and all(math.isfinite(v) for row in rows for v in row.values()), f"rows {rows}")

    # the held-out batches at the trained weights: kernels against plain.
    # After the phase's steps the model amplifies rounding: the plain path
    # moves as far under a 1e-6 change of its inputs as the kernel path is
    # from it (int8: 0.088 nats, row argmax 0.94; compare's random-weight
    # bars do not fit), so each launch is held against its plain version on
    # the same inputs, and the forward by the plain path's own distance
    model = state.model.eval()
    int8 = SuperGlue(dataclasses.replace(model.config, quantize="int8", use_pallas=True), device=device).eval()
    int8.load_state_dict(model.state_dict())
    paths = (("bf16", model, (glk, "fused_attention_propagation", glk.layer_plain), (glk, sk)),
             ("int8", int8, (gli8, "fused_attention_propagation_int8", gli8.layer_int8_plain), (glk, sk, gli8)))
    readings = collections.defaultdict(list)
    with torch.no_grad():
        for i, batch in enumerate(held):
            inputs = superglue_inputs(batch)
            for mode, m, launch, plain_mods in paths:
                if i == 0:
                    ulps = launch_ulps(m, inputs, *launch)
                    check(max(ulps) <= EXAMPLE_LAYER_ULPS, f"pose-AUC {mode} held-out batch 0: a layer launch is "
                          f"{max(ulps):.2f} bf16 ulps from its plain version (bar {EXAMPLE_LAYER_ULPS})")
                    readings[f"{mode} launch ulps"] = ulps
                out = with_decode_stats(m(**inputs), inputs)
                with plain_versions(*plain_mods):
                    ref = with_decode_stats(m(**inputs), inputs)
                    moved = perturbed(inputs)
                    witness = with_decode_stats(m(**moved), moved)
                got = decode_readings(decode_from_output, out, ref, inputs)
                own = decode_readings(decode_from_output, witness, ref, inputs)
                held_by_witness(f"pose-AUC {mode} held-out batch {i}", got, own)
                matches = int((decode_from_output(out, MATCH_THRESHOLD, inputs["mask0"], inputs["mask1"])["matches0"]
                               >= 0).sum())
                readings[mode].append(dict(vs_plain=got, plain_moved=own, matches=matches))
    eval_step = example.make_eval_step(0.2)
    kernel_row = example.evaluate(state, held, eval_step)
    with plain_versions(glk, sk):
        plain_row = example.evaluate(state, held, eval_step)

    # a step's time, busy time and host synchronizations, on copies of the state
    copy_ = clone_train_state(state)
    step = example.make_train_step(example.LossConfig(positive_threshold=3.0, negative_threshold=7.0))
    batch = probe.last_batch
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(copy_, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    busy, kernels_by_time = device_profile(lambda: step(copy_, batch), top=6)
    sites = sync_sites(lambda: step(copy_, batch))
    check(not sites, f"pose-AUC step: host synchronizations {dict(sites)}")
    idle = "not measured" if busy is None else f"{1 - busy / statistics.median(step_ms):.3f}"
    inputs = superglue_inputs(held[0])
    with torch.no_grad():
        eval_s = device_timeit(lambda kw: model(**kw), inputs)
        eval_busy = device_profile(lambda: model(**inputs))[0]
    del copy_, int8
    print(f"example train_pose_auc_synthetic_torch ({' '.join(argv)}): main() {main_s:.1f} s whole ({EXAMPLE_STEPS} "
          f"steps, {len(held)} bf16 and {len(held)} int8 eval batches, the held-out pairs' RANSAC); launches per step "
          f"{json.dumps(train_expected)}, per eval batch {json.dumps(eval_expected)}, in all {json.dumps(launches)}; "
          f"rows {json.dumps(rows)} [{card}]", flush=True)
    print(f"  pose-AUC step B={args.batch} N={n}: {statistics.median(step_ms):.3f} ms (median of 3 synchronized, "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}), device busy {busy} ms, idle share {idle}; "
          f"no host synchronization a step; eval forward B={args.batch}: device busy {eval_busy} ms, "
          f"{eval_s * 1e3:.3f} ms a call back to back (device_timeit) [{card}]", flush=True)
    print("  device time by kernel, pose-AUC step: "
          + "; ".join(f"{kname} {ms:.3f} ms ({calls} calls)" for ms, kname, calls in kernels_by_time), flush=True)
    for mode in ("bf16", "int8"):
        ulps = readings[f"{mode} launch ulps"]
        print(f"  {mode} layer launches of held-out batch 0 against their plain versions on the same inputs: at most "
              f"{max(ulps):.2f} bf16 ulps of the output's largest magnitude ({len(ulps)} launches) [{card}]", flush=True)
        for i, r in enumerate(readings[mode]):
            print(f"  {mode} held-out batch {i} at the trained weights: kernels vs plain {json.dumps(r['vs_plain'])}; "
                  f"plain vs plain on descriptors moved by 1e-6 {json.dumps(r['plain_moved'])}; {r['matches']} "
                  f"matches at {MATCH_THRESHOLD} [{card}]", flush=True)
    print(f"  evaluate on the kernels {json.dumps(kernel_row)}, on the plain versions {json.dumps(plain_row)} "
          f"[{card}]", flush=True)
    print(f"examples phase: {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return dict(total)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "openglue_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.ops import kernels
    from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
    from openglue_tpu_torch.parallel import ring
    from openglue_tpu_torch.train.step import superglue_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build = kernels.build_all()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in build.items()})} "
          f"({time.perf_counter() - t0:.1f} s wall, parallel nvcc)", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the flagship serving config at full width, with seeded random weights
    cfg = superglue_config_from({"superglue": SUPERGLUE_SECTION}, DESCRIPTOR_DIM, SIDE_INFO_DIM)
    model = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    f32_section = dict(SUPERGLUE_SECTION, chain_dtype=None)
    f32_model = SuperGlue(superglue_config_from({"superglue": f32_section}, DESCRIPTOR_DIM, SIDE_INFO_DIM),
                          device="cuda").eval()
    composed = SuperGlue(superglue_config_from({"superglue": dict(f32_section, use_pallas=False)},
                                               DESCRIPTOR_DIM, SIDE_INFO_DIM), device="cuda").eval()
    f32_model.load_state_dict(model.state_dict())
    composed.load_state_dict(model.state_dict())
    with torch.inference_mode():
        k1 = {dt: layer_phase(glk, dt, gen) for dt in (torch.bfloat16, torch.float32)}
        k1_attention = k1_attention_phase(ak, torch.Generator(device="cuda").manual_seed(8))
        k2 = {shape: sinkhorn_phase(sk, *shape, gen) for shape in ((16, 1024), (1, 1024), (4, 2048))}
        k3 = adjoint_phase(sk, gen)
        k45 = {dt: message_phase(glk, dt, gen) for dt in (torch.bfloat16, torch.float32)}
        k6 = {(kind, dt): feature_layer_phase(glk, sample_orthogonal_random_matrix, kind, dt, gen)
              for kind in glk.FEATURE_KINDS for dt in (torch.bfloat16, torch.float32)}
        k7 = {mode: int8_layer_phase(glk, gli8, mode, gen) for mode in INT8_MODES}
        k2s, streaming = streaming_sinkhorn_phase(sk, gen)
        # every kernel that attends, at heads of width 32 (D=128, 4 heads: the SIFT configurations)
        k1_32 = {dt: layer_phase(glk, dt, gen, dim=128) for dt in (torch.bfloat16, torch.float32)}
        k45_32 = {dt: message_phase(glk, dt, gen, dim=128) for dt in (torch.bfloat16, torch.float32)}
        k6_32 = {(kind, dt): feature_layer_phase(glk, sample_orthogonal_random_matrix, kind, dt, gen, dim=128)
                 for kind in glk.FEATURE_KINDS for dt in (torch.bfloat16, torch.float32)}
        k7_32 = {mode: int8_layer_phase(glk, gli8, mode, gen, dim=128) for mode in ("int8", "int8_static_attn")}

        # ---- slice: serve requests through SuperGlue.forward + decode
        layers = 2 * cfg.num_stages * 2  # self + cross per stage, both images
        singles = [(1024, 1024), (1024, 700), (700, 513), (513, 300)]
        requests = [(f"B=1 N=1024 valid={c0}/{c1}", make_request(
            SyntheticHomographyPairs, gen, 1, 1024, [c0], [c1])) for c0, c1 in singles]
        counts = lambda b, n: torch.randint(n // 2, n + 1, (b,), generator=gen, device="cuda").tolist()
        requests.append(("B=16 N=1024", make_request(
            SyntheticHomographyPairs, gen, 16, 1024, counts(16, 1024), counts(16, 1024))))
        requests.append(("B=4 N=2048", make_request(
            SyntheticHomographyPairs, gen, 4, 2048, counts(4, 2048), counts(4, 2048))))
        ring_requests = requests[-2:]  # the ring phase shards these
        requests = [(name, superglue_inputs(pairs)) for name, pairs in requests]
        for _, inputs in requests:  # warm the allocator and the folded weights
            serve(model, decode_from_output, inputs)
        torch.cuda.synchronize()

        # the layer kernel's launches, and inside each the five bf16 GEMMs and
        # the bf16 attention, which the C code counts where it launches them
        main_counters = (glk.counter, sk.counter, gk.bf16_counter, ak.bf16_counter)
        expected = (layers, 1, 5 * layers, layers)
        for c in main_counters:
            c.reset()
        results = []
        for name, inputs in requests:
            before = tuple(c.count for c in main_counters)
            out, decoded = serve(model, decode_from_output, inputs)
            delta = tuple(c.count - b for c, b in zip(main_counters, before))
            check(delta == expected, f"{name}: launches (layer, sinkhorn, gemm_bf16, attention_bf16) {delta}, "
                                     f"expected {expected}")
            times = []
            for _ in range(SERVE_REPEATS):
                torch.cuda.synchronize()
                start = time.perf_counter()
                serve(model, decode_from_output, inputs)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - start)
            results.append((name, inputs, out, decoded, statistics.median(times), delta))
        launches = {"layer": glk.counter.count, "sinkhorn": sk.counter.count, "gemm_bf16": gk.bf16_counter.count,
                    "attention_bf16": ak.bf16_counter.count}

        with plain_versions(glk, sk):
            refs = [serve(model, decode_from_output, inputs)[0] for _, inputs, *_ in results]
        for (name, inputs, out, decoded, latency, delta), ref in zip(results, refs):
            nats, stats = compare(decode_from_output, out, ref, inputs, name)
            batch = inputs["kpts0"].shape[0]
            n_matches = int((decoded["matches0"] >= 0).sum())
            busy, kernels_by_time = device_profile(
                lambda: serve(model, decode_from_output, inputs))
            idle = "not measured" if busy is None else f"{1 - busy / (latency * 1e3):.3f}"
            print(f"serve {name}: {latency * 1e3:.3f} ms (median of {SERVE_REPEATS}), "
                  f"{batch / latency:.2f} pairs/s, "
                  f"device busy {busy} ms, idle share {idle}, "
                  f"launches layer={delta[0]} sinkhorn={delta[1]} (gemm_bf16={delta[2]}, attention_bf16={delta[3]}), "
                  f"vs plain path: "
                  f"{nats:.3e} nats, decode {json.dumps(stats)}, matches {n_matches} "
                  f"[{card}]", flush=True)
            print(f"  device time by kernel, {name}: "
                  + "; ".join(f"{kname} {ms:.3f} ms" for ms, kname, _ in kernels_by_time), flush=True)

        # ---- a small f32 input against the independent composed path
        inputs = superglue_inputs(make_request(SyntheticHomographyPairs, gen, 2, 256, [256, 180], [200, 256]))
        out, ref = f32_model(**inputs), composed(**inputs)
        rows = torch.cat([inputs["mask0"], torch.ones_like(inputs["mask0"][:, :1])], 1)
        cols = torch.cat([inputs["mask1"], torch.ones_like(inputs["mask1"][:, :1])], 1)
        valid = rows[:, :, None] & cols[:, None, :]
        f32_err = (out["scores"] - ref["scores"]).abs()[valid].max().item()
        check(f32_err <= 5e-4, f"f32 kernel path vs composed path: {f32_err}")
        check(torch.equal(out["decode_indices0"][inputs["mask0"]], ref["decode_indices0"][inputs["mask0"]]),
              "f32 kernel path vs composed path: decode differs")
        print(f"f32 B=2 N=256: kernel path vs composed path max |log_P| diff {f32_err:.3e}, decode identical",
              flush=True)

        # ---- the other serving configurations (K6, K7)
        other = other_configs_phase(gen, card, model, (glk, gli8, sk, decode_from_output), dict(requests))

        # ---- the SIFT shape (heads of width 32) and a request past 4096 keypoints
        make = lambda *a, **kw: make_request(SyntheticHomographyPairs, *a, **kw)
        wider = wider_serving_phase(gen, card, model, dict(
            glk=glk, sk=sk, SuperGlue=SuperGlue, decode_from_output=decode_from_output, make=make,
            superglue_config_from=superglue_config_from, superglue_inputs=superglue_inputs))

    # the kernels of the other training routes (the library call beside K9 and
    # K10 differentiates, which inference mode forbids)
    with torch.no_grad():
        k8 = {dt: half_phase(glk, dt, gen) for dt in (torch.bfloat16, torch.float32)}
        k910 = {(dt, n): attention_phase(ak, dt, gen, batch, n) for batch, n in ((BATCH_SIZE, 1024), (4, 2048))
                for dt in (torch.bfloat16, torch.float32)}
        k11 = {(dt, n): lse_phase(ak, dt, gen, batch, n) for batch, n in ((BATCH_SIZE, 1024), (4, 2048))
               for dt in (torch.bfloat16, torch.float32)}
        k8_32 = {dt: half_phase(glk, dt, gen, dim=128) for dt in (torch.bfloat16, torch.float32)}
        k910_32 = {dt: attention_phase(ak, dt, gen, BATCH_SIZE, 1024, dh=32) for dt in (torch.bfloat16, torch.float32)}
        k11_32 = {dt: lse_phase(ak, dt, gen, BATCH_SIZE, 1024, dh=32) for dt in (torch.bfloat16, torch.float32)}
        # its own generator, so that every later phase draws the data it drew before this phase existed
        gemms = gemm_phase(gk, torch.Generator(device="cuda").manual_seed(7))
    merge = {str(dt)[6:]: merge_phase(ak, ring, dt, gen) for dt in (torch.float32, torch.bfloat16)}

    train = train_phase(gen, card)
    routes = routes_phase(gen, card)
    pretrain = pretrain_phase(gen, card)
    store, work = MemoryH5(), Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        trainer, trained = trainer_phase(card, repo, store, work)
        twin = cache_twin_phase(card, repo, store, work)
        data_parallel = data_parallel_phase(card, repo, store, work)
        checkify = checkify_phase(card, repo, store, work)
        serving_cli = serving_cli_phase(card, repo, store, work, trained)
        extractors = device_extractors_phase(card, repo, store, work)
        online = online_trainer_phase(card, repo, store, work)
        examples = examples_phase(card, repo, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rings = ring_phase(gen, card, model, ring_requests)
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-cp-"))
    try:
        cp = context_parallel_phase(card, repo, work, model.state_dict(), gen)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    n1024 = sum(d[1] for name, *_, d in results if "N=1024" in name)
    n2048 = sum(d[1] for name, *_, d in results if "N=2048" in name)
    csrc = "openglue_tpu_torch/ops/csrc/"
    layer, sinkhorn = csrc + "gnn_layer.cu", csrc + "sinkhorn.cu"
    pallas = "openglue_tpu/ops/pallas/"
    sift = "sift_opencv shape B=4 N=2048 D=128 H=4 (dh=32)"

    def dh32(bf16, f32=None):  # a kernel's readings at heads of width 32, beside its row
        return dict(bf16, library_ms=bf16.get("library_ms"), **({} if f32 is None else {"f32": f32}))

    record = {"kernels": [
        dict(name="gnn_layer_softmax (bf16, B=16 N=M=1024 D=256 H=4)", route="cuda", source=layer,
             replaces="openglue_tpu/ops/pallas/gnn_layer_kernel.py:117", launches=launches["layer"],
             **k1[torch.bfloat16], library_ms=None,
             f32=dict(k1[torch.float32], library_ms=None),
             dh32=dh32(k1_32[torch.bfloat16], k1_32[torch.float32]), sift_launches=wider[sift]["K1"],
             trainer_launches=trainer["K1"], data_parallel_launches=data_parallel["K1"],
             cache_twin_launches=twin["K1"], serving_cli_launches=serving_cli["K1"],
             device_extractors_launches=extractors["K1"], online_trainer_launches=online["K1"],
             examples_launches=examples["K1"]),
        dict(name="sinkhorn_scale (f32 K, B=16 N=1024)", route="cuda", source=sinkhorn,
             replaces="openglue_tpu/ops/pallas/sinkhorn_kernel.py:128", launches=n1024,
             train_launches=train["K2"], trainer_launches=trainer["K2"], data_parallel_launches=data_parallel["K2"],
             cache_twin_launches=twin["K2"], checkify_launches=checkify["K2"],
             serving_cli_launches=serving_cli.get("K2 torch.float32", 0),
             device_extractors_launches=extractors.get("K2 torch.float32", 0),
             online_trainer_launches=online["K2"], context_parallel_launches=cp.get("K2", 0),
             examples_launches=examples.get("K2 torch.float32", 0),
             **{k: v for k, v in k2[(16, 1024)].items() if k != "k_dtype"}, library_ms=None,
             single_pair=dict({k: v for k, v in k2[(1, 1024)].items() if k != "k_dtype"},
                              replaces="openglue_tpu/ops/pallas/sinkhorn_kernel.py:56")),
        dict(name="sinkhorn_scale (bf16 K, B=4 N=2048)", route="cuda", source=sinkhorn,
             replaces="openglue_tpu/ops/pallas/sinkhorn_kernel.py:315", launches=n2048,
             **{k: v for k, v in k2[(4, 2048)].items() if k != "k_dtype"}, library_ms=None,
             pretrain_launches=pretrain["K2"], serving_cli_launches=serving_cli.get("K2 torch.bfloat16", 0),
             device_extractors_launches=extractors.get("K2 torch.bfloat16", 0),
             examples_launches=examples.get("K2 torch.bfloat16", 0)),
        dict(name=f"sinkhorn_scale wide (bf16 K, B=1 N={WIDE_KEYPOINTS})", route="cuda", source=sinkhorn,
             replaces="openglue_tpu/ops/pallas/sinkhorn_kernel.py:315",
             launches=sum(d["K2s"] for d in wider.values()), **k2s[(1, WIDE_KEYPOINTS, "bfloat16")],
             library_ms=None,
             shapes={f"{kd} K B={b} N={n}": dict(reading, library_ms=None)
                     for (b, n, kd), reading in k2s.items() if (b, n, kd) != (1, WIDE_KEYPOINTS, "bfloat16")}),
        # past the wide plan's reach; its launches: one log_optimal_transport in its phase
        dict(name=f"sinkhorn_scale streaming (bf16 K, B={PAST_REACH_SHAPE[0]} N={PAST_REACH_SHAPE[1]}, past the wide "
                  f"plan's reach)", route="cuda", source=sinkhorn,
             replaces="openglue_tpu/ops/pallas/sinkhorn_kernel.py:315", **streaming, library_ms=None),
        dict(name="sinkhorn_adjoint (f32 K, B=12 N=1024 T=20)", route="cuda", source=csrc + "sinkhorn_adjoint.cu",
             replaces=pallas + "sinkhorn_kernel.py:548", launches=train["K3"], trainer_launches=trainer["K3"],
             data_parallel_launches=data_parallel["K3"], cache_twin_launches=twin["K3"],
             checkify_launches=checkify["K3"],
             online_trainer_launches=online["K3"], context_parallel_launches=cp.get("K3", 0),
             examples_launches=examples["K3"], **k3,
             library_ms=None),
        dict(name="message_forward (bf16, B=12 N=M=1024 D=256 H=4)", route="cuda",
             source=csrc + "message_forward.cu", replaces=pallas + "gnn_layer_kernel.py:557",
             launches=train["K4"], **k45[torch.bfloat16]["K4"], library_ms=None,
             f32=dict(k45[torch.float32]["K4"], library_ms=None),
             dh32=dh32(k45_32[torch.bfloat16]["K4"], k45_32[torch.float32]["K4"]), pretrain_launches=pretrain["K4"],
             trainer_launches=trainer["K4"], data_parallel_launches=data_parallel["K4"],
             cache_twin_launches=twin["K4"], checkify_launches=checkify["K4"],
             online_trainer_launches=online["K4"], context_parallel_launches=cp.get("K4", 0),
             examples_launches=examples["K4"]),
        dict(name="message_backward (bf16, B=12 N=M=1024 D=256 H=4)", route="cuda",
             source=csrc + "message_backward.cu", replaces=pallas + "gnn_layer_kernel.py:627",
             launches=train["K5"], **k45[torch.bfloat16]["K5"], library_ms=None,
             f32=dict(k45[torch.float32]["K5"], library_ms=None),
             dh32=dh32(k45_32[torch.bfloat16]["K5"], k45_32[torch.float32]["K5"]), pretrain_launches=pretrain["K5"],
             bf16_pass_launches=train["attn_bwd_bf16"], pretrain_bf16_pass_launches=pretrain["attn_bwd_bf16"],
             trainer_launches=trainer["K5"], data_parallel_launches=data_parallel["K5"],
             cache_twin_launches=twin["K5"], checkify_launches=checkify["K5"],
             online_trainer_launches=online["K5"], context_parallel_launches=cp.get("K5", 0),
             examples_launches=examples["K5"]),
        *[dict(name=f"gnn_layer_features {kind} (bf16, B=16 N=M=1024 D=256 H=4)", route="cuda",
               source=csrc + "gnn_layer_features.cu", replaces=pallas + "gnn_layer_kernel.py:117",
               launches=other[kind], **k6[(kind, torch.bfloat16)], library_ms=None,
               f32=dict(k6[(kind, torch.float32)], library_ms=None),
               dh32=dh32(k6_32[(kind, torch.bfloat16)], k6_32[(kind, torch.float32)])) for kind in glk.FEATURE_KINDS],
        dict(name="gnn_layer_int8 int8 (bf16 x, B=16 N=M=1024 D=256 H=4)", route="cuda",
             source=csrc + "gnn_layer_int8.cu", replaces=pallas + "gnn_layer_int8.py:129",
             launches=other["int8"], **k7["int8"], int8_static=k7["int8_static"], int8_attn=k7["int8_attn"],
             dh32=dh32(k7_32["int8"]), int8_static_serving_cli_launches=serving_cli["K7"],
             examples_launches=examples["K7"]),
        dict(name="gnn_layer_int8 int8_static_attn (bf16 x, B=16 N=M=1024 D=256 H=4)", route="cuda",
             source=csrc + "gnn_layer_int8.cu", replaces=pallas + "gnn_layer_int8.py:129",
             launches=other["int8_static_attn"], **k7["int8_static_attn"], dh32=dh32(k7_32["int8_static_attn"])),
        dict(name="train_half (bf16, B=12 N=M=1024 D=256 H=4)", route="cuda", source=csrc + "train_half.cu",
             replaces=pallas + "gnn_layer_kernel.py:587", launches=routes["half"]["K8"],
             **k8[torch.bfloat16], library_ms=None, f32=dict(k8[torch.float32], library_ms=None),
             dh32=dh32(k8_32[torch.bfloat16], k8_32[torch.float32])),
        # the composed route's projections are f32, so its launches are
        *[dict(name=f"{what} (f32, B=12 H=4 N=M=1024 dh=64)", route="cuda", source=csrc + what + ".cu",
               replaces=pallas + f"attention_kernel.py:{line}", launches=routes["composed"][kname],
               **k910[(torch.float32, 1024)][kname], bf16=k910[(torch.bfloat16, 1024)][kname],
               n2048_f32=k910[(torch.float32, 2048)][kname], n2048_bf16=k910[(torch.bfloat16, 2048)][kname],
               dh32=dh32(k910_32[torch.bfloat16][kname], k910_32[torch.float32][kname]),
               context_parallel_launches=cp.get(kname, 0),
               **({"ring_train_launches": rings["train"]["K10"],
                   "bf16_pass_launches": k910[(torch.bfloat16, 1024)]["K10"]["bf16_pass_launches"]}
                  if kname == "K10" else {}))
          for kname, what, line in (("K9", "attention", 38), ("K10", "attention_backward", 251))],
        # the ring's projections are f32 too
        dict(name="attention_lse (f32, B=12 H=4 N=M=1024 dh=64)", route="cuda", source=csrc + "attention.cu",
             replaces=pallas + "attention_kernel.py:57", launches=rings["B=16 N=1024"] + rings["B=4 N=2048"],
             ring_train_launches=rings["train"]["K11"], context_parallel_launches=cp.get("K11", 0),
             **k11[(torch.float32, 1024)],
             bf16=k11[(torch.bfloat16, 1024)], n2048_f32=k11[(torch.float32, 2048)],
             n2048_bf16=k11[(torch.bfloat16, 2048)], block_merge=merge,
             dh32=dh32(k11_32[torch.bfloat16], k11_32[torch.float32])),
        # the dense GEMMs inside K4 and K5 (and K1, K6, K8 in f32): the row's
        # numbers are the q/out shape's; every shape's beside them
        dict(name="gemm_f32 (q/out projection, f32, 12288x256x256)", route="cuda", source=csrc + "gemm.cuh",
             replaces=pallas + "gnn_layer_kernel.py:557", launches=train["gemm_f32"],
             **{k: v for k, v in gemms["f32"][("B=12 N=1024 D=256", "q/out")].items() if k != "launches_per_layer"},
             shapes={f"{w} {n}": v for (w, n), v in gemms["f32"].items()}, remat_launches=routes["remat"]["gemm_f32"],
             half_launches=routes["half"]["gemm_f32"]),
        dict(name="tn_gemm_f32 (weight gradients, f32, 4 x 256x256 over 12288 rows)", route="cuda",
             source=csrc + "tn_gemm.cuh", replaces=pallas + "gnn_layer_kernel.py:627", launches=train["tn_gemm_f32"],
             **{k: v for k, v in gemms["tn"]["B=12 N=1024 D=256"].items() if k not in ("launches_per_layer",
                                                                                      "per_step_ms")},
             per_step_ms=gemms["tn"]["B=12 N=1024 D=256"]["per_step_ms"], d128=gemms["tn"]["B=2 N=2048 D=128"],
             half_launches=routes["half"]["tn_gemm_f32"]),
        # K1's parts in bf16 (their launches on the serving requests above,
        # counted by the C code): the five GEMMs of a layer, summed, each beside them
        dict(name="gemm_bf16 (K1's five GEMMs per layer, bf16, B=16 N=1024 D=256)", route="cuda",
             source=csrc + "gemm.cuh", replaces=pallas + "gnn_layer_kernel.py:117", launches=launches["gemm_bf16"],
             **gemms["bf16_layer"], shapes=gemms["bf16"]),
        dict(name="attention_bf16 (K1's attention core, bf16, B=16 H=4 N=M=1024 dh=64)", route="cuda",
             source=csrc + "attention.cuh", replaces=pallas + "gnn_layer_kernel.py:117",
             launches=launches["attention_bf16"], **k1_attention),
    ]}
    for entry in record["kernels"]:
        check(entry["launches"] > 0, f"{entry['name']} was not launched on the main path")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    # the number of cards this script drives
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
