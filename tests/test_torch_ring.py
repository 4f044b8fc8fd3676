"""Keypoint-axis context parallelism of the port (``openglue_tpu_torch.parallel``
and ``SuperGlue`` with ``ring_axis``) against the JAX package's ``shard_map``
ring on a 4-device CPU mesh.

The port runs as 4 processes over gloo (``_WORKER``, spawned once for the
module, one thread each), every rank on its shard of the same numpy inputs and
the same weights; the JAX references run in the test process while the
workers run. Each rank writes its results; the tests put the shards together
and compare: the ring attention (both branches, self and cross with M != N, a
fully masked element and a fully masked block, the gradients), the
row-sharded Sinkhorn and its gradient, the ring forward and its sharded
decode, and one ring train step (loss, every gradient, the BatchNorm running
statistics), the latter also against the port's single-process ``composed``
step. Tolerances: the JAX package's own ring bars (attention 2e-5, Sinkhorn
1e-5), scores 2e-4, the loss 1e-5 relative.

The same workers then run the other ways of sharding the keypoints over the
``model`` axis (D=32, 2 stages, 64 keypoints, 16 a rank), each held against
JAX's single-device model, which GSPMD equals by construction: the
all-gather route (softmax without ``ring_axis``), the three O(N) kinds with
and without ``ring_axis``, each forward and one ``shard_train_step_cp`` step
with the metric-learning loss at margin 0.5 (loss 1e-5 and gradient norm
1e-4 relative, as tests/test_context_parallel.py holds GSPMD's step), the
ring with and without ``remat``, and the metric loss alone on planted
descriptors whose hardest negatives tie across ranks."""

import os
import socket
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from openglue_tpu.core.types import KeypointSet as JaxKeypointSet
from openglue_tpu.losses import metric_learning_loss as jax_metric_learning_loss
from openglue_tpu.core.types import PairBatch as JaxPairBatch
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models import matching as jax_matching
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops.pallas.attention_kernel import masked_softmax_attention_with_lse as jax_attention_lse
from openglue_tpu.parallel import make_mesh as jax_make_mesh
from openglue_tpu.parallel.context_parallel import shard_pair_batch_cp as jax_shard_pair_batch_cp
from openglue_tpu.parallel.context_parallel import shard_train_step_cp
from openglue_tpu.parallel.ring import log_optimal_transport_ring as jax_ot_ring
from openglue_tpu.parallel.ring import ring_softmax_attention as jax_ring_attention
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_train_step as jax_make_train_step
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.compat.jax_weights import (
    jax_variables_from_state_dict, superglue_grads_from_jax, superglue_state_dict_from_jax,
)
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import attention_kernel
from openglue_tpu_torch.train import state as port_state
from openglue_tpu_torch.train.step import LossConfig, make_train_step

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
B, H, DH, N, M = 2, 2, 16, 32, 48  # the attention blocks: n_loc 8, m_loc 12
MODEL = dict(
    descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=2, num_heads=4,
    otp_num_iters=10, residual=True, decode_stats=True,
)
KPTS = 32  # keypoints per image of the model's batch: 8 per rank
SINKHORN_ITERS = 15
CP_MODEL = dict(descriptor_dim=32, pe_hidden_layers_sizes=(16,), num_stages=2, num_heads=4, otp_num_iters=8,
                residual=True)
CP_KPTS = 64  # 16 per rank
CP_LOSS = dict(positive_threshold=3.0, negative_threshold=5.0, margin=0.5, metric_weight=1.0)
CP_KINDS = ("softmax", "linear", "favor_relu", "favor_softmax")
# (tag, attention, config changes, whether a step runs too)
CP_CASES = [("cp_gather", "softmax", {"use_pallas": True}, True),
            ("cp_ring", "softmax", {"use_pallas": True, "ring_axis": "model"}, True),
            ("cp_remat", "softmax", {"use_pallas": True, "ring_axis": "model", "remat": True}, True)]
CP_CASES += [case for kind in CP_KINDS[1:] for case in (
    (f"cp_{kind}", kind, {}, True), (f"cp_{kind}_ring", kind, {"ring_axis": "model"}, False))]

_WORKER = textwrap.dedent(
    """
    import dataclasses, sys, warnings
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    from openglue_tpu_torch import parallel
    from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
    from openglue_tpu_torch.models.matching import assignment_stats, decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
    from openglue_tpu_torch.parallel import ring
    from openglue_tpu_torch.train import state as port_state
    from openglue_tpu_torch.train.step import LossConfig, make_train_step, superglue_inputs

    assert parallel.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu")
    mesh = parallel.make_mesh({"model": world}, device_type="cpu")
    group = mesh.get_group("model")
    data = {k: torch.from_numpy(v) for k, v in np.load(root / "inputs.npz").items()}
    out = {}

    def mine(x, dim):
        size = x.shape[dim] // world
        return x.narrow(dim, rank * size, size).clone()

    # ---- the ring attention, both branches, self and cross
    for use_pallas in (False, True):
        for case in ("self", "cross"):
            q = mine(data["q"], 2).requires_grad_()
            k = mine(data[f"k_{case}"], 2).requires_grad_()
            v = mine(data[f"v_{case}"], 2).requires_grad_()
            res = ring.ring_softmax_attention(q, k, v, mine(data[f"mask_{case}"], 1), group, use_pallas)
            (res * mine(data["g_attn"], 2)).sum().backward()
            tag = f"attn_{case}_{int(use_pallas)}"
            for name, t in (("out", res), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                out[f"{tag}_{name}"] = t.detach().numpy()

    # ---- the row-sharded transport; this rank's share of the loss
    scores = mine(data["ot_scores"], 1).requires_grad_()
    dust = torch.tensor(0.8, requires_grad=True)
    log_p = ring.log_optimal_transport_ring(
        scores, dust, group, SINKHORN_ITERS, 1.0, data["ot_mask0"], data["ot_mask1"])
    g = data["g_ot"]
    share = (log_p[:, :-1] * mine(g[:, :-1], 1)).sum() + (log_p[:, -1:] * g[:, -1:]).sum() / world
    share.backward()
    out["ot_log_p"] = parallel.gather_rows(log_p.detach(), group).numpy()
    out["ot_dscores"] = scores.grad.numpy()
    out["ot_ddust"] = parallel.distributed.all_reduce_sum(dust.grad, group).numpy()

    # ---- the sharded column decode: ties across ranks, masked rows
    tie = data["tie_scores"]
    idx0, idx1, max0 = assignment_stats(
        torch.cat([mine(tie[:, :-1], 1), tie[:, -1:]], 1), mine(data["tie_mask0"], 1), data["tie_mask1"], group)
    out["tie_idx1"], out["tie_idx0"], out["tie_max0"] = idx1.numpy(), idx0.numpy(), max0.numpy()

    # ---- the model: one batch, sharded
    def side(i):
        return KeypointSet(*[data[f"s{i}_{f}"] for f in ("keypoints", "descriptors", "side_info", "mask", "image_size")])
    whole = PairBatch(side(0), side(1), Transformation("perspective", H=data["H"]))
    batch = parallel.shard_pair_batch_cp(whole, mesh)
    weights = torch.load(root / "weights.pt")
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in CONFIG.items()}

    def model_of(**changes):
        cfg = SuperGlueConfig(**dict(kwargs, ring_axis="model", **changes))
        model = SuperGlue(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(weights)
        return model

    for use_pallas in (False, True):
        model = model_of(use_pallas=use_pallas).eval()
        with torch.no_grad():
            res = model(**superglue_inputs(batch))
        out[f"fwd{int(use_pallas)}_scores"] = parallel.gather_rows(res["scores"], group).numpy()
        for i in (0, 1):
            out[f"fwd{int(use_pallas)}_desc{i}"] = parallel.distributed.all_gather(
                res[f"context_descriptors{i}"], group).numpy()
        for thr in (0.0, 0.2):
            for stats in (True, False):  # from the decode stats, and from the scores
                given = res if stats else {"scores": res["scores"]}
                dec = decode_from_output(given, thr, batch.side0.mask, batch.side1.mask, group=group)
                for key in ("matches0", "matches1", "matching_scores0", "matching_scores1"):
                    out[f"fwd{int(use_pallas)}_dec{thr}_{int(stats)}_{key}"] = dec[key].numpy()

    # quantize with ring_axis warns and serves the unquantized path
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            quant = model_of(use_pallas=True, quantize="int8").eval()(**superglue_inputs(batch))
    out["quantize_warned"] = np.asarray(any("ring_axis is set" in str(w.message) for w in caught))
    out["quantize_scores_equal"] = np.asarray(bool(torch.equal(quant["scores"], res["scores"])))

    # one training step
    model = model_of(use_pallas=True)
    state = port_state.create_train_state(model, learning_rate=1e-3)
    metrics = make_train_step(LossConfig())(state, batch)
    for key, value in metrics.items():
        out[f"train_{key}"] = value.numpy()
    for name, p in model.named_parameters():
        out[f"grad:{name}"] = p.grad.numpy()
    for name, b in model.named_buffers():
        if "running" in name:
            out[f"stat:{name}"] = b.numpy()

    # an indivisible keypoint count
    cut = dataclasses.replace(whole.side0, **{
        f: getattr(whole.side0, f)[:, :30] for f in ("keypoints", "descriptors", "side_info", "mask")})
    try:
        parallel.shard_pair_batch_cp(PairBatch(cut, whole.side1, whole.transformation), mesh)
        out["indivisible_raised"] = np.asarray(False)
    except ValueError:
        out["indivisible_raised"] = np.asarray(True)

    # ---- the other ways to shard the keypoints over the model axis
    from openglue_tpu_torch.losses import metric_learning_loss

    cp = PairBatch(*[KeypointSet(*[data[f"c{i}_{f}"] for f in (
        "keypoints", "descriptors", "side_info", "mask", "image_size")]) for i in (0, 1)],
        Transformation("perspective", H=data["cH"]))
    cp_batch = parallel.shard_pair_batch_cp(cp, mesh)
    for tag, kind, changes, stepped in CP_CASES:
        model = SuperGlue(SuperGlueConfig(**dict(CP_CONFIG, attention=kind, **changes)), device="cpu", mesh=mesh)
        model.load_state_dict(torch.load(root / f"cp_{kind}.pt"))
        with torch.no_grad():
            res = model.eval()(**superglue_inputs(cp_batch))
        out[f"{tag}_scores"] = parallel.gather_rows(res["scores"], group).numpy()
        if stepped:
            state = port_state.create_train_state(model, learning_rate=1e-3)
            metrics = parallel.shard_train_step_cp(make_train_step(LossConfig(**CP_LOSS)), mesh)(state, cp)
            for key, value in metrics.items():
                out[f"{tag}_{key}"] = value.numpy()
            for name, p in model.named_parameters():
                out[f"{tag}_grad:{name}"] = p.grad.numpy()
            for name, b in model.named_buffers():
                if "running" in name:
                    out[f"{tag}_stat:{name}"] = b.numpy()

    # ---- the metric loss on planted descriptors; this rank's share
    g0 = mine(data["ml_g0"], 1).requires_grad_()
    g1 = mine(data["ml_g1"], 1).requires_grad_()
    value = metric_learning_loss(mine(data["ml_gt0"], 1), data["ml_gt1"], g0, g1, CP_LOSS["margin"],
                                 mine(data["ml_mask0"], 1), mine(data["ml_mask1"], 1),
                                 parallel.MeshGroups(model=group, world=group))
    value.backward()
    out["ml_value"], out["ml_dg0"], out["ml_dg1"] = value.detach().numpy(), g0.grad.numpy(), g1.grad.numpy()

    np.savez(root / f"out{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- inputs


def _attention_inputs(rng):
    """q [B, H, N, dh]; K/V of the same length (self) and of M (cross); valid
    key counts 20 (self: the last block of 8 is fully masked) and 30 (cross:
    the last block of 12), and a second element with every key masked."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        q=r(B, H, N, DH), k_self=r(B, H, N, DH), v_self=r(B, H, N, DH),
        k_cross=r(B, H, M, DH), v_cross=r(B, H, M, DH), g_attn=r(B, H, N, DH),
        mask_self=np.arange(N)[None] < np.asarray([20, 0])[:, None],
        mask_cross=np.arange(M)[None] < np.asarray([30, 0])[:, None],
    )


def _ot_valid(mask0, mask1):
    """The entries of the [B, N+1, M+1] log-assignment a loss can read: valid
    rows and columns, the dustbins included."""
    rows = np.concatenate([mask0, np.ones((B, 1), bool)], 1)
    cols = np.concatenate([mask1, np.ones((B, 1), bool)], 1)
    return rows[:, :, None] & cols[:, None, :]


def _ot_inputs(rng):
    """Scores with ragged masks and a cotangent on the entries a loss reads
    (a masked entry sits near -1e9, where one f32 ulp is 64)."""
    mask0 = np.arange(N)[None] < np.asarray([N, 21])[:, None]
    mask1 = np.arange(M)[None] < np.asarray([37, M])[:, None]
    g = rng.standard_normal((B, N + 1, M + 1)).astype(np.float32) * _ot_valid(mask0, mask1)
    return dict(ot_scores=(rng.standard_normal((B, N, M)) * 2).astype(np.float32),
                ot_mask0=mask0, ot_mask1=mask1, g_ot=g)


def _tie_inputs():
    """Scores whose column maxima tie across rows of different ranks, a row
    mask that hides some of the tied rows, and a column masked entirely."""
    rng = np.random.default_rng(5)
    scores = np.round(rng.standard_normal((B, N + 1, M + 1)), 0).astype(np.float32)
    scores[:, 3, 5] = scores[:, 20, 5] = scores[:, 30, 5] = 9.0  # a tie over ranks 0, 2 and 3
    mask0 = np.ones((B, N), bool)
    mask0[1, :9] = False  # element 1: the tie at row 3 is masked, row 20 wins
    mask1 = np.ones((B, M), bool)
    mask1[:, 7] = False
    return dict(tie_scores=scores, tie_mask0=mask0, tie_mask1=mask1)


def _model_batch():
    """A homography batch from the JAX generator, zero-padded beyond ragged
    valid counts, as numpy arrays."""
    batch = JaxPairs(num_keypoints=KPTS, descriptor_dim=64, jitter=0.3).sample(jax.random.key(0), B)
    masks = (np.arange(KPTS)[None] < np.asarray([KPTS, 21])[:, None],
             np.arange(KPTS)[None] < np.asarray([26, KPTS])[:, None])
    out = {"H": np.array(batch.transformation.H)}
    for i, (side, mask) in enumerate(zip((batch.side0, batch.side1), masks)):
        for f in ("keypoints", "descriptors", "side_info"):
            out[f"s{i}_{f}"] = np.array(getattr(side, f)) * mask[..., None]
        out[f"s{i}_mask"] = mask
        out[f"s{i}_image_size"] = np.array(side.image_size)
    return out


def _cp_batch():
    """The 64-keypoint batch of the module-10b cases (``c0_*``, ``c1_*``,
    ``cH``), ragged as ``_model_batch``'s."""
    batch = JaxPairs(num_keypoints=CP_KPTS, descriptor_dim=CP_MODEL["descriptor_dim"], jitter=0.3).sample(
        jax.random.key(2), B)
    masks = (np.arange(CP_KPTS)[None] < np.asarray([CP_KPTS, 45])[:, None],
             np.arange(CP_KPTS)[None] < np.asarray([52, CP_KPTS])[:, None])
    out = {"cH": np.array(batch.transformation.H)}
    for i, (side, mask) in enumerate(zip((batch.side0, batch.side1), masks)):
        for f in ("keypoints", "descriptors", "side_info"):
            out[f"c{i}_{f}"] = np.array(getattr(side, f)) * mask[..., None]
        out[f"c{i}_mask"] = mask
        out[f"c{i}_image_size"] = np.array(side.image_size)
    return out


def _metric_inputs():
    """Context descriptors [B, 64, 32] whose hardest negatives tie across
    ranks: rows 3 (rank 0) and 40 (rank 2) are both e_0, as is column 5, so
    column 5's nearest rows tie at a distance of exactly 0 and row 20 (rank
    1), matched to column 5, takes row 3 as its negative; rows 41 and 55
    (ranks 2 and 3) tie the same way on e_1 and column 9 for row 2 (rank 0).
    Both columns are unmatched on image 1's side, so their margin terms
    split the tie's gradient."""
    rng = np.random.default_rng(7)
    n = CP_KPTS
    g0 = rng.standard_normal((B, n, 32)).astype(np.float32)
    g1 = rng.standard_normal((B, n, 32)).astype(np.float32)
    gt0 = np.where(rng.random((B, n)) < 0.5, rng.integers(0, n, (B, n)), -1)
    gt1 = np.where(rng.random((B, n)) < 0.5, rng.integers(0, n, (B, n)), -1)
    for row_a, row_b, col, anchor, axis in ((3, 40, 5, 20, 0), (41, 55, 9, 2, 1)):
        g0[:, row_a] = g0[:, row_b] = g1[:, col] = np.eye(32, dtype=np.float32)[axis]
        gt0[:, anchor], gt1[:, col] = col, -1
        gt0[:, row_a] = np.where(gt0[:, row_a] == col, -1, gt0[:, row_a])
        gt0[:, row_b] = np.where(gt0[:, row_b] == col, -1, gt0[:, row_b])
    mask0 = np.arange(n)[None] < np.asarray([n, 60])[:, None]
    mask1 = np.arange(n)[None] < np.asarray([58, n])[:, None]
    return dict(ml_g0=g0, ml_g1=g1, ml_gt0=gt0, ml_gt1=gt1, ml_mask0=mask0, ml_mask1=mask1)


def _jax_batch(data, prefix="s", homography="H"):
    sides = [JaxKeypointSet(*[jnp.asarray(data[f"{prefix}{i}_{f}"]) for f in (
        "keypoints", "descriptors", "side_info", "mask", "image_size")]) for i in (0, 1)]
    return JaxPairBatch(*sides, JaxTransformation(kind="perspective", H=jnp.asarray(data[homography])))


def _port_batch(data):
    sides = [KeypointSet(*[torch.from_numpy(data[f"s{i}_{f}"]) for f in (
        "keypoints", "descriptors", "side_info", "mask", "image_size")]) for i in (0, 1)]
    return PairBatch(*sides, Transformation("perspective", H=torch.from_numpy(data["H"])))


# ----------------------------------------------------------------- JAX side


def _jax_attention(mesh, data, case, use_pallas):
    fn = jax.shard_map(
        partial(jax_ring_attention, axis_name="model", use_pallas=use_pallas), mesh=mesh,
        in_specs=(P(None, None, "model"),) * 3 + (P(None, "model"),), out_specs=P(None, None, "model"),
        check_vma=not use_pallas,  # pallas interpret mode vs the vma checker
    )
    mask = jnp.asarray(data[f"mask_{case}"])
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask),
                       *(jnp.asarray(data[x]) for x in ("q", f"k_{case}", f"v_{case}")))
    return (out, *vjp(jnp.asarray(data["g_attn"])))


def _jax_references(mesh, data, variables):
    refs = {}
    for use_pallas in (False, True):
        for case in ("self", "cross"):
            values = jax.jit(lambda: _jax_attention(mesh, data, case, use_pallas))()
            for name, value in zip(("out", "dq", "dk", "dv"), values):
                refs[f"attn_{case}_{int(use_pallas)}_{name}"] = np.asarray(value)

    mask0, mask1 = jnp.asarray(data["ot_mask0"]), jnp.asarray(data["ot_mask1"])
    with jax.set_mesh(mesh):
        log_p, vjp = jax.vjp(
            lambda s, d: jax_ot_ring(s, d, "model", SINKHORN_ITERS, 1.0, mask0, mask1),
            jnp.asarray(data["ot_scores"]), jnp.asarray(0.8, jnp.float32))
        dscores, ddust = vjp(jnp.asarray(data["g_ot"]))
    refs.update(ot_log_p=np.asarray(log_p), ot_dscores=np.asarray(dscores), ot_ddust=np.asarray(ddust))

    tie = {k: jnp.asarray(data[k]) for k in ("tie_scores", "tie_mask0", "tie_mask1")}
    idx0, idx1, max0 = jax_matching.assignment_stats(tie["tie_scores"], tie["tie_mask0"], tie["tie_mask1"])
    refs.update(tie_idx0=np.asarray(idx0), tie_idx1=np.asarray(idx1), tie_max0=np.asarray(max0))

    batch = _jax_batch(data)
    sharded = jax_shard_pair_batch_cp(batch, mesh)
    for use_pallas in (False, True):
        model = JaxSuperGlue(JaxConfig(**MODEL, use_pallas=use_pallas, ring_axis="model"))
        with jax.set_mesh(mesh):
            res = jax.jit(lambda v, b: model.apply(v, **jax_superglue_inputs(b)))(variables, sharded)
        tag = f"fwd{int(use_pallas)}"
        refs[f"{tag}_scores"] = np.asarray(res["scores"])
        refs[f"{tag}_desc0"] = np.asarray(res["context_descriptors0"])
        refs[f"{tag}_desc1"] = np.asarray(res["context_descriptors1"])
        for thr in (0.0, 0.2):
            dec = jax_matching.decode_from_output(res, thr, batch.side0.mask, batch.side1.mask)
            for key in ("matches0", "matches1", "matching_scores0", "matching_scores1"):
                refs[f"{tag}_dec{thr}_{key}"] = np.asarray(dec[key])

    # the XLA ring: the same function as the Pallas one, a third of its compile
    model = JaxSuperGlue(JaxConfig(**MODEL, ring_axis="model"))
    state = jax_create_train_state(model.apply, variables, learning_rate=1e-3)
    with jax.set_mesh(mesh):
        step = shard_train_step_cp(jax_make_train_step(JaxLossConfig()), mesh, batch)
        new_state, metrics = step(state, sharded)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    # below the clip, Adam's first moment after one update is (1 - b1) * grad
    assert float(metrics["grad_norm"]) < 10.0
    refs["train_grads"] = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / np.float32(0.1), adam.mu)
    refs["train_metrics"] = {k: float(v) for k, v in metrics.items()}
    refs["train_new"] = jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.model_state["batch_stats"]})
    return refs


def _jax_step(model, variables, batch, loss):
    """One jitted JAX train step: its metrics, gradients (below the clip,
    Adam's first moment after one update is (1 - b1) * grad) and updated
    variables."""
    state = jax_create_train_state(model.apply, variables, learning_rate=1e-3)
    new_state, metrics = jax.jit(jax_make_train_step(JaxLossConfig(**loss)))(state, batch)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert float(metrics["grad_norm"]) < 10.0
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree_util.tree_map(lambda mu: np.asarray(mu) / np.float32(0.1), adam.mu),
                new=jax.tree_util.tree_map(np.asarray, {
                    "params": new_state.params, "batch_stats": new_state.model_state["batch_stats"]}))


def _jax_cp_references(data, cp_variables):
    """JAX's single-device forward and step of each attention kind on the
    64-keypoint batch, and its metric loss and gradient on the planted
    descriptors."""
    refs = {}
    batch = _jax_batch(data, "c", "cH")
    for kind in CP_KINDS:
        model = JaxSuperGlue(JaxConfig(**CP_MODEL, attention=kind))
        variables = cp_variables[kind]
        refs[f"{kind}_scores"] = np.asarray(
            jax.jit(lambda v, b: model.apply(v, **jax_superglue_inputs(b))["scores"])(variables, batch))
        refs[kind] = _jax_step(model, variables, batch, CP_LOSS)
    gt0, gt1, mask0, mask1 = (jnp.asarray(data[k]) for k in ("ml_gt0", "ml_gt1", "ml_mask0", "ml_mask1"))
    value, grads = jax.value_and_grad(
        lambda g0, g1: jax_metric_learning_loss(gt0, gt1, g0, g1, CP_LOSS["margin"], mask0, mask1),
        argnums=(0, 1))(jnp.asarray(data["ml_g0"]), jnp.asarray(data["ml_g1"]))
    refs.update(ml_value=float(value), ml_dg0=np.asarray(grads[0]), ml_dg1=np.asarray(grads[1]))
    return refs


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """(inputs, JAX references, the 4 ranks' results, the weights)."""
    root = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    data = {**_attention_inputs(rng), **_ot_inputs(rng), **_tie_inputs(), **_model_batch(), **_cp_batch(),
            **_metric_inputs()}
    jbatch = _jax_batch(data)
    variables = JaxSuperGlue(JaxConfig(**MODEL)).init(jax.random.key(1), **jax_superglue_inputs(jbatch))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    np.savez(root / "inputs.npz", **data)
    cfg = SuperGlueConfig(**MODEL)
    torch.save(superglue_state_dict_from_jax(variables, cfg), root / "weights.pt")
    cp_variables = {}
    for kind in CP_KINDS:
        cp_cfg = SuperGlueConfig(**CP_MODEL, attention=kind)
        weights = SuperGlue(cp_cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
        torch.save(weights, root / f"cp_{kind}.pt")
        cp_variables[kind] = jax_variables_from_state_dict(weights, cp_cfg)

    code = (f"SINKHORN_ITERS = {SINKHORN_ITERS}\nCONFIG = {MODEL!r}\nCP_CONFIG = {CP_MODEL!r}\n"
            f"CP_CASES = {CP_CASES!r}\nCP_LOSS = {CP_LOSS!r}\n" + _WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(WORLD), str(port), str(root)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        refs = _jax_references(jax_make_mesh({"model": WORLD}, devices=jax.devices()[:WORLD]), data, variables)
        refs["cp"] = _jax_cp_references(data, cp_variables)
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:  # a rank that failed leaves the others waiting in a collective
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in range(WORLD)]
    return data, refs, ranks, variables


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


# ----------------------------------------------------------------- the tests


def test_lse_kernel_plain_matches_jax():
    """K11's plain path (CPU tensors): out, lse and the gradient through both
    outputs against the JAX kernel in interpret mode and its VJP. One element
    has no valid key: with M = 128 the TPU kernel's 128-padded average is the
    port's M-key average, and both VJPs give dq = dk = 0 there."""
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = r(3, 2, 40, 64), r(3, 2, 128, 64), r(3, 2, 128, 64)
    g, g_lse = r(3, 2, 40, 64), r(3, 2, 40)
    mask = np.arange(128)[None] < np.asarray([100, 0, 128])[:, None]
    (ref_out, ref_lse), vjp = jax.vjp(
        lambda a, b, c: jax_attention_lse(a, b, c, jnp.asarray(mask)), *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    launches = attention_kernel.lse_counter.count, attention_kernel.backward_counter.count
    out, lse = attention_kernel.masked_softmax_attention_with_lse(tq, tk, tv, torch.from_numpy(mask))
    ((out * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    assert (attention_kernel.lse_counter.count, attention_kernel.backward_counter.count) == launches
    # f32 summation order; the LSE on live elements (at -1e9 one f32 ulp is 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=2e-5)
    live = mask.any(1)
    np.testing.assert_allclose(lse.detach().numpy()[live], np.asarray(ref_lse)[live], atol=2e-5)
    assert np.all(lse.detach().numpy()[~live] < -1e8)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert not tq.grad[1].any() and not tk.grad[1].any() and tv.grad[1].abs().sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["self", "cross"])
def test_ring_attention_matches_jax(ring_run, case, use_pallas):
    """Out and the gradients of q, k, v over 4 ranks against JAX's shard_map
    ring at its own bar (2e-5; gradients 1e-4). The fully masked element is 0
    with use_pallas and the uniform average without, in both packages."""
    _, refs, ranks, _ = ring_run
    tag = f"attn_{case}_{int(use_pallas)}"
    out = _cat(ranks, f"{tag}_out", 2)
    np.testing.assert_allclose(out, refs[f"{tag}_out"], atol=2e-5)
    if use_pallas:
        assert not out[1].any()
    else:
        np.testing.assert_allclose(out[1], np.broadcast_to(refs[f"{tag}_out"][1, :, :1], out[1].shape), atol=2e-5)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_cat(ranks, f"{tag}_{name}", 2), refs[f"{tag}_{name}"], atol=1e-4,
                                   err_msg=name)


def test_sharded_sinkhorn_matches_jax(ring_run):
    """The row-sharded transport with ragged masks (marginals of the whole
    problem) and its gradient in the scores and the dustbin score, against
    JAX's ring at its bar (1e-5 on the entries a loss reads; gradients
    1e-4)."""
    data, refs, ranks, _ = ring_run
    valid = _ot_valid(data["ot_mask0"], data["ot_mask1"])
    np.testing.assert_allclose(ranks[0]["ot_log_p"][valid], refs["ot_log_p"][valid], atol=1e-5)
    assert np.all(ranks[0]["ot_log_p"][~valid] < -1e8) and np.all(refs["ot_log_p"][~valid] < -1e8)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["ot_log_p"], ranks[0]["ot_log_p"])
    np.testing.assert_allclose(_cat(ranks, "ot_dscores", 1), refs["ot_dscores"], atol=1e-4)
    np.testing.assert_allclose(ranks[0]["ot_ddust"], refs["ot_ddust"], rtol=1e-4)


def test_sharded_decode_stats_break_ties_like_jax(ring_run):
    """Column argmax across ranks: a tie goes to the smallest global row, a
    masked row never wins, a masked column gives 0, as jnp.argmax does."""
    _, refs, ranks, _ = ring_run
    for r in ranks:
        np.testing.assert_array_equal(r["tie_idx1"], refs["tie_idx1"])
    assert refs["tie_idx1"][0, 5] == 3 and refs["tie_idx1"][1, 5] == 20
    np.testing.assert_array_equal(_cat(ranks, "tie_idx0", 1), refs["tie_idx0"])
    np.testing.assert_array_equal(_cat(ranks, "tie_max0", 1), refs["tie_max0"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ring_forward_and_decode_match_jax(ring_run, use_pallas):
    """The ring SuperGlue eval forward over 4 ranks against JAX's ring model:
    scores (2e-4) and context descriptors, and the sharded decode, from the
    decode stats and from the scores, identical on every rank and to JAX's."""
    _, refs, ranks, _ = ring_run
    tag = f"fwd{int(use_pallas)}"
    np.testing.assert_allclose(ranks[0][f"{tag}_scores"], refs[f"{tag}_scores"], atol=2e-4)
    for i in (0, 1):
        np.testing.assert_allclose(ranks[0][f"{tag}_desc{i}"], refs[f"{tag}_desc{i}"], atol=2e-4)
    for thr in (0.0, 0.2):
        for stats in (0, 1):
            for key in ("matches0", "matches1", "matching_scores0", "matching_scores1"):
                got = [r[f"{tag}_dec{thr}_{stats}_{key}"] for r in ranks]
                for other in got[1:]:
                    np.testing.assert_array_equal(other, got[0])
                np.testing.assert_allclose(got[0], refs[f"{tag}_dec{thr}_{key}"], atol=1e-5, err_msg=key)
    assert (ranks[0][f"{tag}_dec0.0_1_matches0"] >= 0).sum() > 0


def test_ring_quantize_warns_and_serves_unquantized(ring_run):
    _, _, ranks, _ = ring_run
    assert all(bool(r["quantize_warned"]) and bool(r["quantize_scores_equal"]) for r in ranks)


def test_shard_pair_batch_refuses_an_indivisible_count(ring_run):
    _, _, ranks, _ = ring_run
    assert all(bool(r["indivisible_raised"]) for r in ranks)


def test_ring_train_step_matches_jax(ring_run):
    """One ring train step over 4 ranks against JAX's ring step under
    shard_train_step_cp: the metrics (1e-5 relative), every gradient (the
    train-step bar of test_torch_train.py) and the BatchNorm running
    statistics, the same on every rank."""
    _, refs, ranks, _ = ring_run
    for key in ("total_loss", "nll_loss", "grad_norm"):
        for r in ranks:
            np.testing.assert_allclose(r[f"train_{key}"], refs["train_metrics"][key], rtol=1e-5, err_msg=key)
    cfg = SuperGlueConfig(**MODEL)
    ref = superglue_grads_from_jax(refs["train_grads"], cfg)
    grads = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad:")}
    assert set(ref) == set(grads)
    for name, value in grads.items():
        scale = np.abs(ref[name].numpy()).max()
        np.testing.assert_allclose(value, ref[name].numpy(), atol=3e-4 + 1e-5 * scale, rtol=1e-4, err_msg=name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"grad:{name}"], value)
    new_sd = superglue_state_dict_from_jax(refs["train_new"], cfg)
    stats = {k[5:]: v for k, v in ranks[0].items() if k.startswith("stat:")}
    assert len(stats) == 2 * (len(MODEL["pe_hidden_layers_sizes"]) + 2 * MODEL["num_stages"])
    for name, value in stats.items():
        np.testing.assert_allclose(value, new_sd[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"stat:{name}"], value)


def test_ring_train_step_matches_the_single_process_composed_step(ring_run):
    """The same step through the port in one process on the ``composed``
    route (the attention kernels' plain versions): the metrics, every
    gradient and the running statistics."""
    data, _, ranks, variables = ring_run
    cfg = SuperGlueConfig(**MODEL, use_pallas=True)
    model = SuperGlue(cfg, device="cpu", train_route="composed")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    metrics = make_train_step(LossConfig())(
        port_state.create_train_state(model, learning_rate=1e-3), _port_batch(data))
    for key in ("total_loss", "nll_loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][f"train_{key}"], metrics[key].item(), rtol=1e-5, err_msg=key)
    for name, p in model.named_parameters():
        scale = p.grad.abs().max().item()
        np.testing.assert_allclose(ranks[0][f"grad:{name}"], p.grad.numpy(), atol=3e-4 + 1e-5 * scale,
                                   rtol=1e-4, err_msg=name)
    for name, b in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(ranks[0][f"stat:{name}"], b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def _cp_kind(tag):
    return next(kind for t, kind, _, _ in CP_CASES if t == tag)


@pytest.mark.parametrize("tag", [case[0] for case in CP_CASES])
def test_sharded_keypoints_forward_matches_jax(ring_run, tag):
    """Each way to shard the keypoints over a model axis of 4 (the
    all-gather route, the ring, the O(N) kinds with and without
    ``ring_axis``): the eval forward's log-assignment against JAX's
    single-device model (2e-4 on the entries a loss reads, the ring model's
    bar), the same on every rank."""
    data, refs, ranks, _ = ring_run
    want = refs["cp"][f"{_cp_kind(tag)}_scores"]
    valid = _ot_valid(data["c0_mask"], data["c1_mask"])
    got = ranks[0][f"{tag}_scores"]
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-4)
    assert np.all(got[~valid] < -1e8)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{tag}_scores"], got)


@pytest.mark.parametrize("tag", [case[0] for case in CP_CASES if case[3]])
def test_sharded_keypoints_step_matches_jax(ring_run, tag):
    """One ``shard_train_step_cp`` step with the metric loss (margin 0.5) on
    each sharded route against JAX's single-device step on the global
    batch: the losses 1e-5 and the gradient norm 1e-4 relative (the bars of
    JAX's GSPMD test), every gradient at the train-step bar, the running
    statistics 1e-5; every rank the same."""
    _, refs, ranks, _ = ring_run
    ref = refs["cp"][_cp_kind(tag)]
    for r in ranks:
        for key in ("total_loss", "nll_loss", "metric_loss"):
            np.testing.assert_allclose(r[f"{tag}_{key}"], ref["metrics"][key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(r[f"{tag}_grad_norm"], ref["metrics"]["grad_norm"], rtol=1e-4)
    assert ref["metrics"]["metric_loss"] > 0.1
    cfg = SuperGlueConfig(**CP_MODEL, attention=_cp_kind(tag))
    want = superglue_grads_from_jax(ref["grads"], cfg)
    grads = {k.split(":", 1)[1]: v for k, v in ranks[0].items() if k.startswith(f"{tag}_grad:")}
    assert set(grads) == set(want)
    for name, value in grads.items():
        scale = np.abs(want[name].numpy()).max()
        np.testing.assert_allclose(value, want[name].numpy(), atol=3e-4 + 1e-5 * scale, rtol=1e-4, err_msg=name)
    new_sd = superglue_state_dict_from_jax(ref["new"], cfg)
    stats = {k.split(":", 1)[1]: v for k, v in ranks[0].items() if k.startswith(f"{tag}_stat:")}
    assert len(stats) == 2 * (len(CP_MODEL["pe_hidden_layers_sizes"]) + 2 * CP_MODEL["num_stages"])
    for name, value in stats.items():
        np.testing.assert_allclose(value, new_sd[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    for key, value in ranks[0].items():
        if key.startswith(f"{tag}_"):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_ring_remat_step_equals_the_ring_step(ring_run):
    """The ring with ``remat`` rebuilds each layer in the backward pass, its
    rotations and BatchNorm all-reduces included, in the same order on every
    rank: its step's metrics, gradients and running statistics are those of
    the ring without it."""
    _, _, ranks, _ = ring_run
    keys = [k[len("cp_ring_"):] for k in ranks[0] if k.startswith("cp_ring_") and not k.endswith("scores")]
    assert any(k.startswith("grad:") for k in keys) and any(k.startswith("stat:") for k in keys)
    for r in ranks:
        for key in keys:
            np.testing.assert_allclose(r[f"cp_remat_{key}"], r[f"cp_ring_{key}"], rtol=1e-6, atol=1e-7, err_msg=key)


def test_metric_loss_breaks_cross_rank_ties_like_jax(ring_run):
    """The metric loss on descriptors sharded over 4 ranks whose hardest
    negatives tie across ranks: the value once (not once per rank) and the
    gradients of both images' descriptors, put together from the ranks'
    shards, against JAX's loss on the whole (1e-5)."""
    data, refs, ranks, _ = ring_run
    for r in ranks:
        np.testing.assert_allclose(r["ml_value"], refs["cp"]["ml_value"], rtol=1e-5)
    for name in ("ml_dg0", "ml_dg1"):
        np.testing.assert_allclose(_cat(ranks, name, 1), refs["cp"][name], atol=1e-5, err_msg=name)
    dg0 = refs["cp"]["ml_dg0"]
    assert all(np.abs(dg0[:, row]).max() > 0 for row in (3, 40, 41, 55))  # the tied rows carry gradient
