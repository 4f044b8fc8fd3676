"""The port's examples and ``random_pair_batch`` on the CPU, against the JAX
package at toy sizes (2 stages, D=64, N <= 64, B=2).

* ``random_pair_batch`` is ``SyntheticHomographyPairs(...).sample`` bit for
  bit, with JAX's fields, shapes and dtypes;
* the pose-AUC example's ``evaluate`` on a JAX-generated held-out batch (the
  third of the example's four; at the init below its pose errors are 12 and
  73 degrees, so AUC@20 is not 0), with
  weights converted from JAX's init, decodes JAX's ``matches0`` exactly and
  its metrics lie within 1e-6 of the JAX example's (its nested ``evaluate``
  restated here). The init is made to match: each layer's last FFN dense and
  the keypoint encoder's last dense are zero and the final projection is 18
  times the identity, so that the scores are peaked on the descriptors'
  correspondences and threshold 0.2 keeps matches (random weights give a
  flat assignment that nothing clears);
* precision@3px equals the JAX example's loop on the same matches;
* ``make_images`` writes the JAX example's bytes;
* each example's ``main`` runs on the CPU at toy arguments and refuses
  ``--device cuda`` without a card.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from openglue_tpu.data.synthetic import SyntheticReprojectionPairs as JaxReprojectionPairs
from openglue_tpu.data.synthetic import random_pair_batch as jax_random_pair_batch
from openglue_tpu.metrics import CameraPoseAUC as JaxCameraPoseAUC
from openglue_tpu.metrics import EpipolarDistanceMetric as JaxEpipolarDistanceMetric
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_eval_step as jax_make_eval_step
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.data import SyntheticHomographyPairs, random_pair_batch
from openglue_tpu_torch.train.state import create_train_state
from openglue_tpu_torch.train.step import make_eval_step, redraw_favor_projections

REPO = Path(__file__).resolve().parents[1]
METRIC_TOL = 1e-6
TOY = ["--batch", "2", "--stages", "2", "--dim", "64", "--kpts", "64", "--device", "cpu"]


def _load(name):
    """An example script as a module, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def pose_auc():
    return _load("train_pose_auc_synthetic_torch")


def _fields(x, prefix=""):
    """{path: leaf} of a pair batch (port or JAX dataclasses)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(x):
        value = getattr(x, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, f"{prefix}{f.name}."))
        elif value is not None:
            out[f"{prefix}{f.name}"] = value
    return out


@pytest.mark.parametrize("side_info_dim, image_size", [(1, (960, 720)), (3, (640, 480))])
def test_random_pair_batch_is_the_generator_sample(side_info_dim, image_size):
    sizes = dict(num_keypoints=40, descriptor_dim=64, side_info_dim=side_info_dim, image_size=image_size)
    got = random_pair_batch(torch.Generator().manual_seed(3), 2, **sizes)
    want = SyntheticHomographyPairs(**sizes).sample(torch.Generator().manual_seed(3), 2)
    ref = jax.eval_shape(lambda key: jax_random_pair_batch(key, 2, **sizes), jax.random.key(3))
    got, want, ref = _fields(got), _fields(want), _fields(ref)
    assert got.keys() == want.keys() == ref.keys()
    for name, value in got.items():
        if name.endswith("kind"):
            assert value == want[name] == ref[name] == "perspective"
            continue
        assert torch.equal(value, want[name]), name
        assert tuple(value.shape) == ref[name].shape, name
        assert str(value.dtype).removeprefix("torch.") == str(ref[name].dtype), name


# ------------------------------------------------- the pose-AUC evaluation


def _jax_config():
    return JaxConfig(descriptor_dim=64, pe_hidden_layers_sizes=(32, 64), num_stages=2, num_heads=4,
                     otp_num_iters=15, residual=True)


def _port_batch(batch):
    """A JAX PairBatch as the port's, on the CPU."""
    t = lambda x: torch.from_numpy(np.array(x))
    sides = [KeypointSet(t(s.keypoints), t(s.descriptors), t(s.side_info), t(s.mask), t(s.image_size))
             for s in (batch.side0, batch.side1)]
    tf = batch.transformation
    return PairBatch(*sides, Transformation(kind=tf.kind, **{k: t(getattr(tf, k)) for k in
                                                             ("K0", "K1", "R", "T", "depth0", "depth1")}))


@pytest.fixture(scope="module")
def held_out_and_variables():
    """A held-out batch of the JAX example's generator and seed, and JAX's
    init of the toy matcher with the changes the module docstring names."""
    gen = JaxReprojectionPairs(num_keypoints=48, descriptor_dim=64, jitter=1.0, descriptor_noise=0.3)
    batch = jax.jit(gen.sample, static_argnums=1)(jax.random.key(10_000 + 2), 2)
    model = JaxSuperGlue(_jax_config())
    variables = jax.jit(lambda r, b: model.init(r, **jax_superglue_inputs(b)))(jax.random.key(1), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = variables["params"]
    for layer in params["attention_gnn"].values():
        layer["ffn"]["dense_1"] = {k: np.zeros_like(v) for k, v in layer["ffn"]["dense_1"].items()}
    last = params["positional_encoding"]["encoder"]["dense_2"]
    params["positional_encoding"]["encoder"]["dense_2"] = {k: np.zeros_like(v) for k, v in last.items()}
    params["linear_proj"] = {"kernel": 18.0 * np.eye(64, dtype=np.float32), "bias": np.zeros(64, np.float32)}
    return batch, variables


def _jax_evaluate(state, held_out, step_fn):
    """The JAX example's nested ``evaluate``, restated (it is not top-level
    there), returning the matches too."""
    auc = JaxCameraPoseAUC()
    epi = JaxEpipolarDistanceMetric()
    matches = []
    for batch in held_out:
        out = step_fn(state, batch)
        tf = batch.transformation
        k0 = np.asarray(batch.side0.keypoints)
        k1 = np.asarray(batch.side1.keypoints)
        m0 = np.asarray(out["matches0"])
        auc.update(k0, k1, m0, tf.K0, tf.K1, tf.R, tf.T)
        epi.update(k0, k1, m0, tf.K0, tf.K1, tf.R, tf.T)
        matches.append(m0)
    return {**auc.compute(), **epi.compute()}, matches


def test_evaluate_matches_the_jax_example(pose_auc, held_out_and_variables):
    from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig

    batch, variables = held_out_and_variables
    jax_state = jax_create_train_state(JaxSuperGlue(_jax_config()).apply, variables)
    want, want_matches = _jax_evaluate(jax_state, [batch], jax.jit(jax_make_eval_step(0.2)))

    cfg = SuperGlueConfig(descriptor_dim=64, pe_hidden_layers_sizes=(32, 64), num_stages=2, num_heads=4,
                          otp_num_iters=15, residual=True)
    model = SuperGlue(cfg, device="cpu")
    model.load_state_dict(superglue_state_dict_from_jax(variables, cfg))
    seen = []
    eval_step = make_eval_step(0.2)

    def step_fn(state, b):
        seen.append(eval_step(state, b))
        return seen[-1]

    got = pose_auc.evaluate(create_train_state(model), [_port_batch(batch)], step_fn)
    matches = seen[0]["matches0"].numpy()
    assert (matches >= 0).sum() > 40  # the decode has content at threshold 0.2
    np.testing.assert_array_equal(matches, want_matches[0])
    assert got.keys() == want.keys()
    assert want["AUC@20deg"] > 0 and want["Precision@0.0005"] > 0
    for key in want:
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])


def _jax_precision(m0, kpts0, kpts1, H):
    """The JAX example's precision@3px loop (examples/match_synthetic.py), restated."""
    correct = total = 0
    for b in range(m0.shape[0]):
        for i, j in enumerate(m0[b]):
            if j < 0:
                continue
            p = H[b] @ np.array([*kpts0[b, i], 1.0])
            total += 1
            correct += np.linalg.norm(p[:2] / p[2] - kpts1[b, j]) < 3.0
    return correct, total


def test_precision_at_3px_is_the_jax_loop():
    example = _load("match_synthetic_torch")
    batch = SyntheticHomographyPairs(num_keypoints=64, descriptor_dim=16, jitter=0.5).sample(
        torch.Generator().manual_seed(0), 2)
    rng = np.random.default_rng(0)
    m0 = np.where(rng.random((2, 64)) < 0.6, np.arange(64), rng.integers(-1, 64, (2, 64)))
    args = (m0, batch.side0.keypoints.numpy(), batch.side1.keypoints.numpy(), batch.transformation.H.numpy())
    correct, total = example.precision_at_3px(*args)
    assert (correct, total) == _jax_precision(*args)
    assert 0 < correct < total


def test_make_images_writes_the_jax_examples_bytes(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_pretrain_example", REPO / "examples" / "pretrain_and_match_images.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    jax_example.make_images(tmp_path / "jax")
    _load("pretrain_and_match_images_torch").make_images(tmp_path / "port")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 6
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


# ------------------------------------------------- the examples end to end


def test_pose_auc_example_runs_with_kernels_and_int8(pose_auc, capsys):
    state, rows = pose_auc.main(["--epochs", "1", "--steps-per-epoch", "2", *TOY,
                                 "--bf16", "--chain-bf16", "--pallas", "--warmup", "5", "--eval-int8"])
    assert state.step == 2 and state.model.config.use_pallas
    assert [row.get("epoch") for row in rows] == [0, None] and rows[1]["int8"]
    for row in rows:
        assert {"AUC@5deg", "AUC@10deg", "AUC@20deg", "Precision@0.0005", "Matching Score@0.0005"} <= row.keys()
        assert all(np.isfinite(v) for v in row.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("epoch 0 (step 2): loss ") and "AUC@20deg=" in lines[0]
    assert lines[1].startswith("total ") and lines[2].startswith("int8 serving path: AUC@5deg=")


def test_pose_auc_example_redraws_favor_projections(pose_auc):
    state, rows = pose_auc.main(["--epochs", "2", "--steps-per-epoch", "1", *TOY, "--attention", "favor_relu"])
    assert state.step == 2 and [row["epoch"] for row in rows] == [0, 1]
    projections = {k: v.clone() for k, v in state.model.named_buffers() if k.endswith("mha.projection")}
    assert len(projections) == 4
    # the one redraw, after epoch 0, drew every projection from the redraw seed
    redraw_favor_projections(state, torch.Generator().manual_seed(pose_auc.REDRAW_SEED))
    for name, value in state.model.named_buffers():
        if name in projections:
            assert torch.equal(value, projections[name]), name


def test_match_synthetic_example_runs(capsys):
    state = _load("match_synthetic_torch").main(["--steps", "2", "--kpts", "64", "--device", "cpu"])
    assert state.step == 2
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("loss: ") and lines[0].endswith("after 2 steps")
    assert lines[1].startswith("decoded ") and "precision@3px = " in lines[1]


def test_pretrain_and_match_images_example_runs(tmp_path):
    state, matches = _load("pretrain_and_match_images_torch").main(
        ["--workdir", str(tmp_path), "--steps", "2", "--device", "cpu"])
    assert state.step == 2 and matches >= 0
    assert (tmp_path / "matches.png").stat().st_size > 0


@pytest.mark.parametrize("name, argv", [
    ("train_pose_auc_synthetic_torch", ["--epochs", "1", "--steps-per-epoch", "1"]),
    ("match_synthetic_torch", ["--steps", "1"]),
    ("pretrain_and_match_images_torch", ["--steps", "1"]),
])
def test_examples_refuse_cuda_without_a_card(name, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name.startswith("pretrain"):
        argv = argv + ["--workdir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
