"""The port's three training routes of a softmax layer with ``use_pallas``
and ``remat`` against the JAX package on the CPU.

The JAX package picks a route from environment variables read at trace time
(``OPENGLUE_TRAIN_HALF``, ``OPENGLUE_NO_FUSED_MESSAGE``); the port from the
constructor argument ``train_route``. The JAX side runs its Pallas kernels in
interpret mode under forced dispatch: the message kernels, the train-half
kernel or the standalone attention kernels. Per route: one layer in training
mode (loss, input and parameter gradients, BatchNorm running statistics, with
and without ``use_offset``) and one whole ``make_train_step``; ``remat`` against
JAX's ``remat`` and, bit for bit, against the port's own step without it."""

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
from openglue_tpu.models.gnn import MultiheadAttention as JaxMultiheadAttention
from openglue_tpu.models.layers import FeedForwardNet as JaxFeedForwardNet
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu.ops.pallas import gnn_layer_kernel as jax_glk
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_train_step as jax_make_train_step
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.compat.jax_weights import superglue_grads_from_jax, superglue_state_dict_from_jax
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.models import gnn as port_gnn
from openglue_tpu_torch.models.gnn import AttentionalPropagation, AttentionGNN, MultiheadAttention
from openglue_tpu_torch.models.layers import FeedForwardNet
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import attention_kernel, gnn_layer_kernel
from openglue_tpu_torch.train import state as port_state
from openglue_tpu_torch.train.step import LossConfig, make_train_step

SMALL = dict(
    descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=2, num_heads=4,
    otp_num_iters=10, residual=True,
)
# the JAX switch behind each route of the port
ROUTE_ENV = {"message": None, "half": "OPENGLUE_TRAIN_HALF", "composed": "OPENGLUE_NO_FUSED_MESSAGE"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _set_route(monkeypatch, route):
    for name in ("OPENGLUE_TRAIN_HALF", "OPENGLUE_NO_FUSED_MESSAGE", "OPENGLUE_FUSED_MESSAGE_ONLY"):
        monkeypatch.delenv(name, raising=False)
    if ROUTE_ENV[route]:
        monkeypatch.setenv(ROUTE_ENV[route], "1")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _dense(params, name):
    return {f"{name}.weight": _t(np.asarray(params["kernel"]).T[:, :, None]), f"{name}.bias": _t(params["bias"])}


def _layer_state(params, stats):
    """The port layer's state dict from the JAX layer's variables."""
    sd = {}
    for jax_name, name in (("q_proj", "in_proj_q"), ("k_proj", "in_proj_k"),
                           ("v_proj", "in_proj_v"), ("out_proj", "out_proj")):
        sd.update(_dense(params["mha"][jax_name], f"mha.{name}"))
    sd.update(_dense(params["ffn"]["dense_0"], "fc.0"))
    sd.update(_dense(params["ffn"]["dense_1"], "fc.3"))
    sd["fc.2.weight"] = _t(params["ffn"]["bn_0"]["scale"])
    sd["fc.2.bias"] = _t(params["ffn"]["bn_0"]["bias"])
    sd["fc.2.running_mean"] = _t(stats["ffn"]["bn_0"]["mean"])
    sd["fc.2.running_var"] = _t(stats["ffn"]["bn_0"]["var"])
    return sd


# ----------------------------------------------------------- one layer


@pytest.mark.parametrize("use_offset", [False, True])
@pytest.mark.parametrize("route", ["message", "half", "composed"])
def test_layer_route_matches_jax(route, use_offset, monkeypatch):
    """Mirrors tests/test_pallas_kernels.py::test_module_train_step_parity on
    every route: loss rtol 1e-5, BatchNorm statistics atol 1e-5, gradients
    atol 3e-4 (the JAX package's bars for its fused layer against the
    composed one)."""
    _set_route(monkeypatch, route)
    dim, heads, n = 64, 4, 96
    rng = np.random.default_rng(0)
    x_q = rng.standard_normal((2, n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, n, dim)).astype(np.float32)
    kv_mask = np.arange(n)[None] < np.asarray([70, n])[:, None]
    q_mask = np.arange(n)[None] < np.asarray([n, 80])[:, None]
    jq, jkv, jqm, jkm = map(jnp.asarray, (x_q, x_kv, q_mask, kv_mask))
    variables = JaxPropagation(embed_dim=dim, num_heads=heads, use_offset=use_offset).init(
        jax.random.key(0), jq, jkv, jqm, jkm, True)
    module = JaxPropagation(embed_dim=dim, num_heads=heads, use_offset=use_offset, use_pallas=True)

    def loss(params, a, b):
        out, mutated = module.apply({**variables, "params": params}, a, b, jqm, jkm, True,
                                    mutable=["batch_stats"])
        return jnp.sum(out * jnp.cos(out)), mutated

    force_fused_dispatch(True)
    try:
        (value, mutated), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            variables["params"], jq, jkv)
    finally:
        force_fused_dispatch(False)

    layer = AttentionalPropagation(dim, heads, use_offset, use_pallas=True, train_route=route)
    layer.load_state_dict(_layer_state(_np(variables["params"]), _np(variables["batch_stats"])))
    layer.train()
    tq, tkv = torch.from_numpy(x_q).requires_grad_(), torch.from_numpy(x_kv).requires_grad_()
    counts = (gnn_layer_kernel.half_counter.count, attention_kernel.counter.count,
              attention_kernel.backward_counter.count, gnn_layer_kernel.message_bwd_counter.count)
    out = layer(tq, tkv, torch.from_numpy(q_mask), torch.from_numpy(kv_mask))
    port_value = (out * torch.cos(out)).sum()
    port_value.backward()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert counts == (gnn_layer_kernel.half_counter.count, attention_kernel.counter.count,
                      attention_kernel.backward_counter.count, gnn_layer_kernel.message_bwd_counter.count)

    np.testing.assert_allclose(port_value.item(), float(value), rtol=1e-5)
    new_stats = _layer_state(_np(variables["params"]), _np(mutated["batch_stats"]))
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(layer.fc[2], name).numpy(), new_stats[f"fc.2.{name}"].numpy(), atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(grads[1]), atol=3e-4)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(grads[2]), atol=3e-4)
    ref = _layer_state(_np(grads[0]), _np(variables["batch_stats"]))
    for name, p in layer.named_parameters():
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=3e-4, err_msg=name)


def _half_case(seed=0, dim=64, n=72, m=56):
    rng = np.random.default_rng(seed)
    r = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    x_q, x_kv = r(2, n, dim), r(2, m, dim)
    mask = np.arange(m)[None] < np.asarray([40, m])[:, None]
    mats = [r(dim, dim, scale=dim**-0.5) for _ in range(4)]  # flax layout [in, out]
    vecs = [r(dim, scale=0.1) for _ in range(4)]
    w1, b1 = r(2 * dim, 2 * dim, scale=(2 * dim) ** -0.5), r(2 * dim, scale=0.1)
    return x_q, x_kv, mask, mats, vecs, w1, b1


@pytest.mark.parametrize("use_offset", [False, True])
def test_train_half_plain_and_function_match_jax(use_offset):
    """``train_half_plain`` against ``xla_reference_train_half`` (f32, atol
    3e-5: summation order), and ``fused_train_layer_half`` with its torch
    prologue against jax.grad of the JAX function through its Pallas kernels
    (atol 3e-4, the JAX package's bar; a bias gradient at the same bar)."""
    x_q, x_kv, mask, mats, vecs, w1, b1 = _half_case()
    jw = jax_glk.MessageWeights(*[jnp.asarray(t) for pair in zip(mats, [v[None] for v in vecs]) for t in pair])
    ref = jax_glk.xla_reference_train_half(
        jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask), jw, jnp.asarray(w1), jnp.asarray(b1[None]),
        4, use_offset)
    tw = gnn_layer_kernel.MessageWeights(
        *[torch.from_numpy(t) for pair in zip([m.T.copy() for m in mats], vecs) for t in pair])
    tw1, tb1 = torch.from_numpy(w1.T.copy()), torch.from_numpy(b1)
    z, attn, lse = gnn_layer_kernel.train_half_plain(
        torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask), tw, tw1, tb1, 4,
        use_offset, torch.float32)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), atol=3e-5)
    assert attn.shape == x_q.shape and lse.shape == (2, 4, x_q.shape[1])

    def loss(a, b, w, w1_, b1_):
        out = jax_glk.fused_train_layer_half(a, b, jnp.asarray(mask), w, w1_, b1_, 4, use_offset, block_q=32)
        return jnp.sum(out * jnp.cos(out))

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x_q), jnp.asarray(x_kv), jw, jnp.asarray(w1), jnp.asarray(b1[None]))
    leaves = [torch.from_numpy(x_q), torch.from_numpy(x_kv), *tw, tw1, tb1]
    for t in leaves:
        t.requires_grad_()
    out = gnn_layer_kernel.fused_train_layer_half(
        leaves[0], leaves[1], torch.from_numpy(mask), gnn_layer_kernel.MessageWeights(*leaves[2:10]),
        leaves[10], leaves[11], 4, use_offset)
    (out * torch.cos(out)).sum().backward()
    want = [grads[0], grads[1]]
    for i, t in enumerate(grads[2]):  # flax [in, out] and [1, D] -> torch [out, in] and [D]
        want.append(np.asarray(t).T if i % 2 == 0 else np.asarray(t)[0])
    want += [np.asarray(grads[3]).T, np.asarray(grads[4])[0]]
    names = ["dx_q", "dx_kv", *gnn_layer_kernel.MessageWeights._fields, "dw1", "db1"]
    for name, t, ref_grad in zip(names, leaves, want):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad), atol=3e-4, err_msg=name)


def test_multihead_attention_with_use_pallas_matches_jax_in_eval():
    """The module on its own, in eval: with ``use_pallas`` it runs the
    attention wrapper (its plain version here), as the JAX module runs its
    kernel under forced dispatch. f32, atol 1e-5."""
    dim, heads, n, m = 64, 4, 72, 56
    rng = np.random.default_rng(2)
    x_q = rng.standard_normal((2, n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, m, dim)).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray([40, m])[:, None]
    module = JaxMultiheadAttention(embed_dim=dim, num_heads=heads, use_pallas=True)
    variables = module.init(jax.random.key(1), jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask))
    force_fused_dispatch(True)
    try:
        ref = module.apply(variables, jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask))
    finally:
        force_fused_dispatch(False)
    mha = MultiheadAttention(dim, heads, use_pallas=True).eval()
    params = _np(variables["params"])
    state = {}
    for jax_name, name in (("q_proj", "in_proj_q"), ("k_proj", "in_proj_k"),
                           ("v_proj", "in_proj_v"), ("out_proj", "out_proj")):
        state.update(_dense(params[jax_name], name))
    mha.load_state_dict(state)
    calls = []
    original = attention_kernel.masked_softmax_attention
    attention_kernel.masked_softmax_attention = lambda *a: calls.append(1) or original(*a)
    try:
        with torch.no_grad():
            out = mha(torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask))
            plain = MultiheadAttention(dim, heads)
            plain.load_state_dict(state)
            other = plain(torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask))
    finally:
        attention_kernel.masked_softmax_attention = original
    assert calls == [1]  # only the use_pallas module reaches the wrapper
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(other.numpy(), np.asarray(ref), atol=1e-5)


def test_feed_forward_skip_to_hidden_matches_jax():
    """``skip_to_hidden`` starts at the first BatchNorm, in training mode with
    a mask (f32, atol 1e-5), and leaves the first conv's parameters unused."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    mask = np.arange(40)[None] < np.asarray([40, 25])[:, None]
    module = JaxFeedForwardNet((48, 16))
    variables = module.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask), True)
    z = np.maximum(rng.standard_normal((2, 40, 48)), 0).astype(np.float32)
    ref, mutated = module.apply(variables, jnp.asarray(z), jnp.asarray(mask), True, True, mutable=["batch_stats"])
    ffn = FeedForwardNet((32, 48, 16)).train()
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    state = {**_dense(params["dense_0"], "0"), **_dense(params["dense_1"], "3"),
             "2.weight": _t(params["bn_0"]["scale"]), "2.bias": _t(params["bn_0"]["bias"]),
             "2.running_mean": _t(stats["bn_0"]["mean"]), "2.running_var": _t(stats["bn_0"]["var"])}
    ffn.load_state_dict(state)
    out = ffn(torch.from_numpy(z), torch.from_numpy(mask), skip_to_hidden=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(ffn[2].running_var.numpy(), np.asarray(mutated["batch_stats"]["bn_0"]["var"]), atol=1e-5)
    out.sum().backward()
    assert ffn[0].weight.grad is None and ffn[3].weight.grad is not None


def test_unknown_train_route_raises():
    for build in (lambda: AttentionalPropagation(64, 4, train_route="fused"),
                  lambda: AttentionGNN(1, 64, 4, train_route="fused"),
                  lambda: SuperGlue(SuperGlueConfig(**SMALL), device="cpu", train_route="fused")):
        with pytest.raises(ValueError, match="train_route 'fused' is not supported"):
            build()
    assert port_gnn.TRAIN_ROUTES == ("message", "half", "composed")
    assert "train_route" not in {f.name for f in SuperGlueConfig.__dataclass_fields__.values()}


def test_train_route_is_inert_outside_training_softmax_use_pallas():
    """Eval routing, a model without ``use_pallas`` and another attention kind
    do not see the route: equal bits on all three."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    mask = torch.from_numpy(np.arange(40)[None] < np.asarray([40, 25])[:, None])
    for kwargs, training in ((dict(use_pallas=True), False), (dict(use_pallas=False), True),
                             (dict(use_pallas=True, attention="linear"), True)):
        outs = []
        for route in port_gnn.TRAIN_ROUTES:
            layer = AttentionalPropagation(64, 4, train_route=route, **kwargs)
            for module in layer.modules():
                if hasattr(module, "reset_parameters"):
                    module.reset_parameters(torch.Generator().manual_seed(5))
            layer.train(training)
            with torch.no_grad():
                outs.append(layer(x, x, mask, mask))
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2]), kwargs


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


def _port_step(variables, cfg, route, sides, H):
    port = SuperGlue(cfg, device="cpu", train_route=route)
    port.load_state_dict(superglue_state_dict_from_jax(_np(variables), cfg))
    metrics = make_train_step(LossConfig())(
        port_state.create_train_state(port, learning_rate=1e-3), _port_batch(sides, H))
    return port, metrics


@pytest.mark.parametrize("route,remat", [("half", False), ("composed", False), ("message", True),
                                         ("half", True), ("composed", True)])
def test_train_step_route_matches_jax(route, remat, monkeypatch):
    """One whole ``make_train_step`` from identical weights and an identical
    batch (the ``message`` route without remat is tests/test_torch_train.py's):
    metrics rtol 1e-5, every gradient at the JAX fused-layer bar, the running
    statistics rtol/atol 1e-5. With ``remat`` also bit for bit against the
    port's own step without it: loss, gradients and running statistics."""
    _set_route(monkeypatch, route)
    sides, H = _step_batch()
    jbatch = _jax_batch(sides, H)
    model = JaxSuperGlue(JaxConfig(**SMALL, use_pallas=True, remat=remat))
    variables = model.init(jax.random.key(1), **jax_superglue_inputs(jbatch))
    state = jax_create_train_state(model.apply, variables, learning_rate=1e-3)
    force_fused_dispatch(True)
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

    cfg = SuperGlueConfig(**SMALL, use_pallas=True, remat=remat)
    port, port_metrics = _port_step(variables, cfg, route, sides, H)
    for key in ("total_loss", "nll_loss", "metric_loss", "grad_norm"):
        np.testing.assert_allclose(port_metrics[key].item(), float(metrics[key]), rtol=1e-5, err_msg=key)
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

    if remat:
        plain, plain_metrics = _port_step(variables, SuperGlueConfig(**SMALL, use_pallas=True), route, sides, H)
        assert port_metrics["total_loss"].item() == plain_metrics["total_loss"].item()
        for (name, a), (_, b) in zip(port.named_parameters(), plain.named_parameters()):
            assert torch.equal(a.grad, b.grad), name
        for (name, a), (_, b) in zip(port.state_dict().items(), plain.state_dict().items()):
            assert torch.equal(a, b), name


def test_remat_runs_each_layer_forward_twice_and_updates_statistics_once():
    """Under ``remat`` a layer's forward runs once in the forward pass and
    once more in the backward pass (where its running statistics stay put);
    without gradients or in eval there is no checkpoint."""
    rng = np.random.default_rng(6)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32)) for _ in range(2))
    gnn = AttentionGNN(1, 64, 4, use_pallas=True, remat=True).train()
    for module in gnn.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(torch.Generator().manual_seed(7))
    calls = []
    for layer in gnn.layers:
        layer.module.register_forward_pre_hook(lambda *_: calls.append(1))  # a rebuild stops early: count entries
    a, b = gnn(x0.requires_grad_(), x1)
    assert len(calls) == 4
    momentum = gnn.layers[0].module.fc[2].momentum
    stats = [layer.module.fc[2].running_mean.clone() for layer in gnn.layers]
    (a.sum() + b.sum()).backward()
    assert len(calls) == 8
    for layer, before in zip(gnn.layers, stats):
        assert torch.equal(layer.module.fc[2].running_mean, before)
        assert layer.module.fc[2].update_running and momentum == 0.1
    with torch.no_grad():
        gnn(x0, x1)
    gnn.eval()
    gnn(x0, x1)
    assert len(calls) == 16  # four per pass, none rebuilt
