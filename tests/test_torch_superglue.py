"""The port's serving forward (SuperGlue + decode) against the JAX package on
the CPU: the kernel path (use_pallas=True; JAX through its Pallas kernels in
interpret mode) and the composed path, in f32 and with a bf16 chain; the
weight carrier; the slice's config; and the port's isolation from JAX."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openglue_tpu.compat.torch_weights import superglue_params_from_torch
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models import matching as jax_matching
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.ops.pallas import force_fused_dispatch
from openglue_tpu_torch.cli.common import superglue_config_from
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
from openglue_tpu_torch.models import matching
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel, sinkhorn_kernel
from openglue_tpu_torch.train.step import superglue_inputs

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(
    descriptor_dim=64, pe_hidden_layers_sizes=(32, 64), num_stages=2, num_heads=4,
    otp_num_iters=20, residual=True, decode_stats=True,
)


def _numpy_inputs():
    """Ragged masked pairs with N0=130, N1=97, made by the JAX generator and
    handed to both frameworks as numpy arrays."""
    batch = JaxPairs(num_keypoints=130, descriptor_dim=64).sample(jax.random.key(0), 2)
    s0, s1 = batch.side0, batch.side1
    out = dict(
        kpts0=s0.keypoints, kpts1=s1.keypoints[:, :97], desc0=s0.descriptors,
        desc1=s1.descriptors[:, :97], side_info0=s0.side_info, side_info1=s1.side_info[:, :97],
        image_size0=s0.image_size, image_size1=s1.image_size,
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    out["mask0"] = np.arange(130)[None] < np.asarray([130, 75])[:, None]
    out["mask1"] = np.arange(97)[None] < np.asarray([60, 97])[:, None]
    return out


def _jax_variables(inputs):
    model = JaxSuperGlue(JaxConfig(**SMALL))
    variables = model.init(jax.random.key(1), **{k: jnp.asarray(v) for k, v in inputs.items()})
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.3 * jax.random.normal(jax.random.key(9), v.shape) ** 2,
        variables["batch_stats"],
    )  # non-trivial running stats, so the BatchNorm fold is exercised
    variables = {"params": variables["params"], "batch_stats": stats}
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def inputs():
    return _numpy_inputs()


@pytest.fixture(scope="module")
def variables(inputs):
    return _jax_variables(inputs)


def _run_jax(variables, inputs, use_pallas, chain_dtype):
    model = JaxSuperGlue(JaxConfig(**SMALL, use_pallas=use_pallas, chain_dtype=chain_dtype))
    force_fused_dispatch(use_pallas)
    try:
        out = model.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()})
    finally:
        force_fused_dispatch(False)
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(variables, inputs, use_pallas, chain_dtype):
    cfg = SuperGlueConfig(**SMALL, use_pallas=use_pallas, chain_dtype=chain_dtype)
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    model.eval()
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
    return out


def _valid(inputs):
    rows = np.concatenate([inputs["mask0"], np.ones((2, 1), bool)], 1)
    cols = np.concatenate([inputs["mask1"], np.ones((2, 1), bool)], 1)
    return rows[:, :, None] & cols[:, None, :]


def _decode(out, inputs, threshold):
    return {k: v.numpy() for k, v in matching.decode_from_output(
        out, threshold, torch.from_numpy(inputs["mask0"]), torch.from_numpy(inputs["mask1"])
    ).items()}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_f32_forward_matches_jax(variables, inputs, use_pallas):
    ref = _run_jax(variables, inputs, use_pallas, None)
    layer_launches, ot_launches = gnn_layer_kernel.counter.count, sinkhorn_kernel.counter.count
    out = _run_port(variables, inputs, use_pallas, None)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (gnn_layer_kernel.counter.count, sinkhorn_kernel.counter.count) == (layer_launches, ot_launches)
    # the JAX package's own bar for its kernel path against XLA (test_pallas_kernels.py:226)
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], atol=5e-4)
    for key in ("decode_indices0", "decode_indices1"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key])
    # threshold 0: at random weights the assignment is nearly flat, so every
    # mutual nearest neighbour counts and the whole decode is compared
    port = _decode(out, inputs, 0.0)
    jref = jax_matching.decode_from_output(
        {k: jnp.asarray(v) for k, v in ref.items()}, 0.0,
        jnp.asarray(inputs["mask0"]), jnp.asarray(inputs["mask1"]),
    )
    assert (port["matches0"] >= 0).sum() > 0
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(port[key], np.asarray(jref[key]))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_chain_forward_matches_jax(variables, inputs, use_pallas):
    ref = _run_jax(variables, inputs, use_pallas, jnp.bfloat16)
    out = _run_port(variables, inputs, use_pallas, "bfloat16")
    valid = _valid(inputs)
    # bf16 roundings in 4 layers move log_P by a few hundredths of a nat at
    # most (the JAX package's bf16 bound); the decode keeps its structure
    diff = np.abs(out["scores"].numpy() - ref["scores"])[valid]
    assert diff.max() <= 0.05
    rows = inputs["mask0"]
    agree = (out["decode_indices0"].numpy() == ref["decode_indices0"])[rows].mean()
    assert agree >= 0.99


def test_siren_encoder_forward_matches_jax(inputs):
    kwargs = dict(SMALL, pe_encoder_name="FeedForwardNetSiren")
    jmodel = JaxSuperGlue(JaxConfig(**kwargs))
    jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(jax.random.key(2), **jinputs)))
    assert "positional_encoding" not in variables["batch_stats"]  # no BatchNorm in the Siren encoder
    ref = jmodel.apply(variables, **jinputs)
    cfg = SuperGlueConfig(**kwargs)
    model = SuperGlue(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    # the port's own init: every weight within the SIREN bounds, zero biases
    first, last = model.positional_encoding.encoder.dense_0, model.positional_encoding.encoder.dense_2
    assert first.weight.abs().max() <= 1 / 3 and last.weight.abs().max() <= np.sqrt(6 / 64) / 30
    assert first.weight.std() > 0.1 and not first.bias.any() and not last.bias.any()
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    model.eval()
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
    # sin(30 x) amplifies an f32 rounding of x by 30; the forward bar holds
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=5e-4)
    np.testing.assert_array_equal(out["decode_indices0"].numpy(), np.asarray(ref["decode_indices0"]))
    with pytest.raises(NameError, match="was not found among positional encoders"):
        SuperGlue(SuperGlueConfig(**dict(SMALL, pe_encoder_name="Fourier")), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("ring_axis", "kp"), ("remat", True), ("ring_axis+attention", "linear"), ("ring_axis+remat", True),
])
def test_unported_switches_are_refused(field, value):
    """``ring_axis`` needs a mesh (``tests/test_torch_ring.py`` runs it on
    one); with another attention kind or with ``remat`` the model builds on
    a one-rank mesh (a gloo group of this process, destroyed after). ``remat``
    alone is ported."""
    if field == "remat":
        assert SuperGlue(SuperGlueConfig(**SMALL, remat=True), device="cpu").attention_gnn.remat
        return
    if field == "ring_axis":
        with pytest.raises(ValueError, match="needs a mesh"):
            SuperGlue(SuperGlueConfig(**SMALL, ring_axis=value), device="cpu")
        return
    import socket

    import torch.distributed as dist

    from openglue_tpu_torch import parallel

    other = field.split("+")[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert parallel.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device_type="cpu")
    try:
        mesh = parallel.make_mesh({"kp": 1}, device_type="cpu")
        model = SuperGlue(SuperGlueConfig(**SMALL, ring_axis="kp", **{other: value}), device="cpu", mesh=mesh)
        assert model.keypoint_group is not None and getattr(model.config, other) == value
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_weights_round_trip_exactly(variables):
    cfg = SuperGlueConfig(**SMALL)
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    back = superglue_params_from_torch(model.state_dict(), JaxConfig(**SMALL))
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_orig = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat_back) == len(flat_orig)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_orig[path], err_msg=str(path))


def test_init_matches_torch_conv_default_bounds():
    gen = torch.Generator().manual_seed(3)
    model = SuperGlue(SuperGlueConfig(**SMALL), device="cpu", generator=gen)
    w = model.attention_gnn.layers[0].module.fc[0].weight
    assert w.shape == (128, 128, 1)
    assert w.abs().max() <= 128**-0.5 and w.std() > 0.5 * 128**-0.5 / np.sqrt(3)
    again = SuperGlue(SuperGlueConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_decode_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    scores = np.round(rng.standard_normal((2, 9, 8)), 1).astype(np.float32)  # ties
    mask0 = np.arange(8)[None] < np.asarray([8, 5])[:, None]
    mask1 = np.arange(7)[None] < np.asarray([3, 7])[:, None]
    ref = jax_matching.decode_matches(jnp.asarray(scores), 0.3, jnp.asarray(mask0), jnp.asarray(mask1))
    out = matching.decode_matches(torch.from_numpy(scores), 0.3, torch.from_numpy(mask0), torch.from_numpy(mask1))
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-6)


def test_synthetic_pairs_follow_their_homography():
    batch = SyntheticHomographyPairs(num_keypoints=64, descriptor_dim=32, jitter=0.0).sample(
        torch.Generator().manual_seed(0), 3
    )
    inputs = superglue_inputs(batch)
    assert inputs["desc0"].shape == (3, 64, 32) and inputs["mask0"].all()
    H = batch.transformation.H
    pts = torch.cat([batch.side0.keypoints, torch.ones(3, 64, 1)], -1) @ H.transpose(1, 2)
    warped = pts[..., :2] / pts[..., 2:]
    close = (warped - batch.side1.keypoints).norm(dim=-1) < 1e-2
    assert close[:, : int(0.7 * 64)].float().mean() > 0.5  # the covisible prefix
    assert torch.allclose(inputs["desc0"].norm(dim=-1), torch.ones(3, 64))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_config_is_the_yaml_section():
    with open(REPO / "configs" / "config_cached_sp_magicleap.yaml") as f:
        section = yaml.safe_load(f)["superglue"]
    smoke = _load_chip_smoke()
    assert smoke.SUPERGLUE_SECTION == section
    cfg = superglue_config_from({"superglue": section}, descriptor_dim=256, side_info_dim=0)
    assert (cfg.num_stages, cfg.num_heads, cfg.otp_num_iters, cfg.side_info_size) == (9, 4, 20, 1)
    assert cfg.use_pallas and cfg.decode_stats and cfg.chain_dtype == "bfloat16"
    with open(REPO / "configs" / "config_cached_sp_magicleap.yaml") as f:
        full = yaml.safe_load(f)
    assert smoke.TRAIN_SECTION == full["train"]
    assert (smoke.BATCH_SIZE, smoke.MAX_KEYPOINTS) == (full["data"]["batch_size"], full["data"]["max_keypoints"])


def test_chip_smoke_sift_and_pretraining_shapes_are_the_yaml_files():
    smoke = _load_chip_smoke()
    with open(REPO / "configs" / "features" / "sift_opencv.yaml") as f:
        sift = yaml.safe_load(f)
    assert (smoke.SIFT_DESCRIPTOR_DIM, smoke.SIFT_MAX_KEYPOINTS) == (
        sift["descriptor_dim"], sift["parameters"]["max_keypoints"])
    with open(REPO / "examples" / "pretrain_e2e_fixture.yaml") as f:
        fixture = yaml.safe_load(f)
    assert smoke.PRETRAIN_SECTION == fixture["superglue"]
    assert smoke.PRETRAIN_TRAIN_SECTION == {k: fixture["train"][k] for k in smoke.PRETRAIN_TRAIN_SECTION}
    assert smoke.PRETRAIN_BATCH == fixture["data"]["batch_size"]
    assert smoke.SIFT_MAX_KEYPOINTS == fixture["features"]["parameters"]["max_keypoints"]
    cfg = superglue_config_from({"superglue": smoke.PRETRAIN_SECTION}, smoke.SIFT_DESCRIPTOR_DIM, 0)
    assert cfg.descriptor_dim // cfg.num_heads == 32 and cfg.use_pallas


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = (list((REPO / "openglue_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + list((REPO / "examples").glob("*_torch.py")) + list((REPO / "scripts").glob("*.py")))
    assert REPO / "openglue_tpu_torch" / "parallel" / "ring.py" in files
    assert REPO / "examples" / "train_pose_auc_synthetic_torch.py" in files
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "flax", "openglue_tpu"), f"{path}: imports {name}"


def test_port_runs_without_jax_in_the_process():
    code = """
import importlib, pathlib, sys, torch
import openglue_tpu_torch
root = pathlib.Path(openglue_tpu_torch.__file__).parent
for path in sorted(root.rglob("*.py")):  # every module of the port
    parts = path.relative_to(root.parent).with_suffix("").parts
    importlib.import_module(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs, SyntheticReprojectionPairs
from openglue_tpu_torch.models.matching import decode_from_output
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.train.state import create_train_state
from openglue_tpu_torch.train.step import LossConfig, make_train_step, superglue_inputs
batch = SyntheticHomographyPairs(num_keypoints=40, descriptor_dim=64).sample(torch.Generator().manual_seed(0), 2)
cfg = SuperGlueConfig(descriptor_dim=64, pe_hidden_layers_sizes=(32,), num_stages=1, use_pallas=True, decode_stats=True)
model = SuperGlue(cfg, device="cpu").eval()
with torch.no_grad():
    out = model(**superglue_inputs(batch))
decode_from_output(out, 0.2)
pairs = SyntheticReprojectionPairs(num_keypoints=40, descriptor_dim=64).sample(torch.Generator().manual_seed(1), 2)
metrics = make_train_step(LossConfig())(create_train_state(model), pairs)
assert torch.isfinite(metrics["total_loss"])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "openglue_tpu")]
assert not bad, bad
assert {"openglue_tpu_torch.parallel.ring", "openglue_tpu_torch.parallel.context_parallel",
        "openglue_tpu_torch.cli.online", "openglue_tpu_torch.models.matching_module",
        "openglue_tpu_torch.augmentations"} <= set(sys.modules)
print("ok")
"""
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().endswith("ok")
