"""The port's training step against the JAX package on the CPU: one
attentional-propagation layer in training mode (with the masked BatchNorm's
batch statistics), the optimizer against optax, and one whole
``make_train_step`` from identical weights and an identical batch, with the
kernel path (use_pallas, the JAX side through its Pallas kernels in
interpret mode under forced dispatch) and the composed path, and with linear
attention (the composed path under autograd in both packages). Also: the port
alone overfits a small batch, and the FAVOR redraw."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglue_tpu.core.types import KeypointSet as JaxKeypointSet
from openglue_tpu.core.types import PairBatch as JaxPairBatch
from openglue_tpu.core.types import Transformation as JaxTransformation
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models.gnn import AttentionalPropagation as JaxPropagation
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_train_step as jax_make_train_step
from openglue_tpu.train import state as jax_state
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.compat.jax_weights import superglue_grads_from_jax, superglue_state_dict_from_jax
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
from openglue_tpu_torch.models.gnn import AttentionalPropagation
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel, sinkhorn_kernel
from openglue_tpu_torch.train import state as port_state
from openglue_tpu_torch.cli.common import favor_redraw_interval
from openglue_tpu_torch.train.step import (
    LossConfig, make_eval_step, make_train_step, redraw_favor_projections,
)

SMALL = dict(
    descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=2, num_heads=4,
    otp_num_iters=10, residual=True,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------- one layer


def _layer_state(params, stats):
    """The port layer's state dict from the JAX layer's variables."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    sd = {}
    for jax_name, name in (("q_proj", "in_proj_q"), ("k_proj", "in_proj_k"),
                           ("v_proj", "in_proj_v"), ("out_proj", "out_proj")):
        sd[f"mha.{name}.weight"] = t(np.asarray(params["mha"][jax_name]["kernel"]).T[:, :, None])
        sd[f"mha.{name}.bias"] = t(params["mha"][jax_name]["bias"])
    for jax_name, name in (("dense_0", "fc.0"), ("dense_1", "fc.3")):
        sd[f"{name}.weight"] = t(np.asarray(params["ffn"][jax_name]["kernel"]).T[:, :, None])
        sd[f"{name}.bias"] = t(params["ffn"][jax_name]["bias"])
    sd["fc.2.weight"] = t(params["ffn"]["bn_0"]["scale"])
    sd["fc.2.bias"] = t(params["ffn"]["bn_0"]["bias"])
    sd["fc.2.running_mean"] = t(stats["ffn"]["bn_0"]["mean"])
    sd["fc.2.running_var"] = t(stats["ffn"]["bn_0"]["var"])
    return sd


@pytest.mark.parametrize("use_pallas", [True, False])
def test_layer_train_mode_matches_jax(use_pallas):
    """Mirrors test_pallas_kernels.py::test_module_train_step_parity: the
    loss, input and parameter gradients, and the mutated BatchNorm running
    statistics, against the JAX layer (its fused message kernels under forced
    dispatch when use_pallas)."""
    dim, heads, n = 64, 4, 96
    rng = np.random.default_rng(0)
    x_q = rng.standard_normal((2, n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, n, dim)).astype(np.float32)
    kv_mask = np.arange(n)[None] < np.asarray([70, n])[:, None]
    q_mask = np.arange(n)[None] < np.asarray([n, 80])[:, None]
    jq, jkv, jqm, jkm = map(jnp.asarray, (x_q, x_kv, q_mask, kv_mask))
    variables = JaxPropagation(embed_dim=dim, num_heads=heads).init(
        jax.random.key(0), jq, jkv, jqm, jkm, True)
    module = JaxPropagation(embed_dim=dim, num_heads=heads, use_pallas=use_pallas)

    def loss(params, a, b):
        out, mutated = module.apply({**variables, "params": params}, a, b, jqm, jkm, True,
                                    mutable=["batch_stats"])
        return jnp.sum(out * jnp.cos(out)), mutated

    force_fused_dispatch(use_pallas)
    try:
        (value, mutated), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            variables["params"], jq, jkv)
    finally:
        force_fused_dispatch(False)

    layer = AttentionalPropagation(dim, heads, use_pallas=use_pallas)
    layer.load_state_dict(_layer_state(_np(variables["params"]), _np(variables["batch_stats"])))
    layer.train()
    tq, tkv = torch.from_numpy(x_q).requires_grad_(), torch.from_numpy(x_kv).requires_grad_()
    out = layer(tq, tkv, torch.from_numpy(q_mask), torch.from_numpy(kv_mask))
    port_value = (out * torch.cos(out)).sum()
    port_value.backward()

    np.testing.assert_allclose(port_value.item(), float(value), rtol=1e-5)
    new_stats = _layer_state(_np(variables["params"]), _np(mutated["batch_stats"]))
    for name in ("fc.2.running_mean", "fc.2.running_var"):
        np.testing.assert_allclose(getattr(layer.fc[2], name.split(".")[-1]).numpy(),
                                   new_stats[name].numpy(), atol=1e-5)
    # the JAX package's bar for its fused layer against the composed one
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(grads[1]), atol=3e-4)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(grads[2]), atol=3e-4)
    ref = _layer_state(_np(grads[0]), _np(variables["batch_stats"]))
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=3e-4, err_msg=name)


# ----------------------------------------------------------- the optimizer


@pytest.mark.parametrize("warmup_steps", [0, 2])
def test_optimizer_matches_optax(warmup_steps):
    # At the flagship learning rate (1e-4). optax forms Adam's bias
    # corrections 1 - b**t in f32 (1 - 0.999 is off by 1.3e-5 relative there)
    # and torch in f64, so an update differs by ~7e-6 relative, ~1e-9 here;
    # torch also adds the update in one rounding where optax rounds twice.
    # Parameters of magnitude about 0.1 (one f32 ulp ~7e-9) keep three steps
    # well within the 1e-7 bound
    rng = np.random.default_rng(1)
    params = {"a": rng.uniform(-0.1, 0.1, (4, 3)).astype(np.float32),
              "b": rng.uniform(-0.1, 0.1, 5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.1, 5.0, 0.2)]  # the second step's norm is above the clip
    kw = dict(learning_rate=1e-4, gamma=0.9, gradient_clip=1.0)
    if warmup_steps:
        tx = jax_state.make_warmup_optimizer(warmup_steps=warmup_steps, **kw)
    else:
        tx = jax_state.make_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    if warmup_steps:
        opt = port_state.make_warmup_optimizer(tensors.values(), warmup_steps=warmup_steps, **kw)
    else:
        opt = port_state.make_optimizer(tensors.values(), **kw)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)
    schedule = jax_state.make_lr_schedule(1e-4, 0.9, warmup_steps)
    port_schedule = port_state.make_lr_schedule(1e-4, 0.9, warmup_steps)
    for k in range(6):
        np.testing.assert_allclose(port_schedule(k), float(schedule(k)), rtol=1e-6)


# ----------------------------------------------------------- one whole step


def _step_batch(n=80):
    """A homography pair batch from the JAX generator, zero-padded beyond
    ragged valid counts, as numpy arrays."""
    batch = JaxPairs(num_keypoints=n, descriptor_dim=64, jitter=0.3).sample(jax.random.key(0), 2)
    masks = (np.arange(n)[None] < np.asarray([n, 60])[:, None],
             np.arange(n)[None] < np.asarray([70, n])[:, None])
    sides = []
    for side, mask in zip((batch.side0, batch.side1), masks):
        sides.append(dict(
            keypoints=np.array(side.keypoints) * mask[..., None],
            descriptors=np.array(side.descriptors) * mask[..., None],
            side_info=np.array(side.side_info) * mask[..., None],
            mask=mask, image_size=np.array(side.image_size),
        ))
    return sides, np.array(batch.transformation.H)


def _jax_batch(sides, H):
    return JaxPairBatch(*[JaxKeypointSet(**{k: jnp.asarray(v) for k, v in s.items()}) for s in sides],
                        JaxTransformation(kind="perspective", H=jnp.asarray(H)))


def _port_batch(sides, H):
    return PairBatch(*[KeypointSet(**{k: torch.from_numpy(v) for k, v in s.items()}) for s in sides],
                     Transformation("perspective", H=torch.from_numpy(H)))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_train_step_matches_jax(use_pallas):
    _check_train_step(use_pallas, "softmax")


def test_train_step_linear_attention_matches_jax():
    """attention="linear" with use_pallas: both packages train it through the
    composed path and their framework's autodiff; the Sinkhorn runs through
    its kernels' plain versions."""
    _check_train_step(True, "linear")


def _check_train_step(use_pallas, attention):
    sides, H = _step_batch()
    jbatch = _jax_batch(sides, H)
    SMALL = dict(globals()["SMALL"], attention=attention)
    model = JaxSuperGlue(JaxConfig(**SMALL, use_pallas=use_pallas))
    variables = model.init(jax.random.key(1), **jax_superglue_inputs(jbatch))
    state = jax_create_train_state(model.apply, variables, learning_rate=1e-3)
    force_fused_dispatch(use_pallas)
    try:
        new_state, metrics = jax.jit(jax_make_train_step(JaxLossConfig()))(state, jbatch)
    finally:
        force_fused_dispatch(False)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    # below the clip, Adam's first moment after one update is (1 - b1) * grad
    assert float(metrics["grad_norm"]) < 10.0
    jax_grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / np.float32(0.1), adam.mu)

    cfg = SuperGlueConfig(**SMALL, use_pallas=use_pallas)
    port = SuperGlue(cfg, device="cpu")
    port.load_state_dict(superglue_state_dict_from_jax(_np(variables), cfg))
    counts = gnn_layer_kernel.message_counter.count, sinkhorn_kernel.adjoint_counter.count
    port_metrics = make_train_step(LossConfig())(
        port_state.create_train_state(port, learning_rate=1e-3), _port_batch(sides, H))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (gnn_layer_kernel.message_counter.count, sinkhorn_kernel.adjoint_counter.count) == counts

    for key in ("total_loss", "nll_loss", "metric_loss", "grad_norm"):
        np.testing.assert_allclose(port_metrics[key].item(), float(metrics[key]), rtol=1e-5, err_msg=key)
    # every gradient: f32 summation order through 4 layers, the Sinkhorn
    # adjoint and the BatchNorm statistics, at the JAX fused-layer bar
    ref = superglue_grads_from_jax(jax_grads, cfg)
    params = dict(port.named_parameters())
    assert set(ref) == set(params)
    for name, p in params.items():
        scale = np.abs(ref[name].numpy()).max()
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=3e-4 + 1e-5 * scale,
                                   rtol=1e-4, err_msg=name)
    new_sd = superglue_state_dict_from_jax(
        _np({"params": new_state.params, "batch_stats": new_state.model_state["batch_stats"]}), cfg)
    stats = {k: v for k, v in port.state_dict().items() if "running" in k}
    assert len(stats) == 2 * (len(SMALL["pe_hidden_layers_sizes"]) + 2 * SMALL["num_stages"])
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), new_sd[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_train_step_reduces_loss(use_pallas):
    """Mirrors tests/test_train_step.py::test_train_step_reduces_loss with the
    port alone: a fixed batch, 30 steps, the loss at most half the first."""
    cfg = SuperGlueConfig(descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=2,
                          num_heads=4, otp_num_iters=10, use_pallas=use_pallas)
    model = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    batch = SyntheticHomographyPairs(
        num_keypoints=64, descriptor_dim=64, jitter=0.0, descriptor_noise=0.05
    ).sample(torch.Generator().manual_seed(0), 2)
    state = port_state.create_train_state(model, learning_rate=1e-3)
    step = make_train_step(LossConfig(positive_threshold=3.0, negative_threshold=5.0))
    first = step(state, batch)
    for _ in range(30):
        metrics = step(state, batch)
    assert metrics["total_loss"].item() < 0.5 * first["total_loss"].item()
    assert np.isfinite(metrics["grad_norm"].item())
    assert state.step == 31
    out = make_eval_step(match_threshold=0.2)(state, batch)
    assert out["matches0"].shape == (2, 64) and out["scores"].shape == (2, 65, 65)
    assert (out["matches0"] >= 0).sum() > 0 and not model.training


@pytest.mark.parametrize("attention", ["favor_relu", "favor_softmax", "linear"])
def test_redraw_favor_projections_changes_the_projections_only(attention):
    cfg = SuperGlueConfig(**SMALL, attention=attention, favor_num_features=24)
    model = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = port_state.create_train_state(model, learning_rate=1e-3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    projections = [k for k in before if k.endswith("mha.projection")]
    assert len(projections) == (0 if attention == "linear" else 2 * SMALL["num_stages"])
    assert all(before[k].shape == (24, 16) for k in projections)
    assert not any(p.requires_grad for p in (model.get_buffer(k) for k in projections))
    assert redraw_favor_projections(state, torch.Generator().manual_seed(7)) is state
    after = model.state_dict()
    for name, value in before.items():
        assert torch.equal(after[name], value) == (name not in projections), name
    # ranks that seed alike draw alike
    twin = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    redraw_favor_projections(port_state.create_train_state(twin), torch.Generator().manual_seed(7))
    for name in projections:
        assert torch.equal(twin.state_dict()[name], after[name])


def test_favor_redraw_interval_from_config():
    gnn = {"attention": "favor_softmax", "redraw_interval": 500}
    assert favor_redraw_interval({"superglue": {"attention_gnn": gnn}}) == 500
    assert favor_redraw_interval({"superglue": {"attention_gnn": dict(gnn, attention="linear")}}) is None
    assert favor_redraw_interval({}) is None
    cfg = SuperGlueConfig.from_dict({"descriptor_dim": 64, "attention_gnn": dict(gnn, favor_num_features=48)})
    assert (cfg.attention, cfg.favor_num_features) == ("favor_softmax", 48)
