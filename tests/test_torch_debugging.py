"""The port's numerical-safety checks (``openglue_tpu_torch/debugging.py``)
against the JAX package's checkify-based ones on the CPU: the verdicts of
tests/test_debugging.py's four cases, a zero divisor, an out-of-range
index, a NaN made in a backward pass and in a kernel's outputs; and
``cli.train_cached --checkify`` on the MegaDepth fixture, which trains as
the unchecked trainer does and raises on a planted NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from openglue_tpu import debugging as jax_debugging
from openglue_tpu.data.synthetic import SyntheticHomographyPairs as JaxPairs
from openglue_tpu.models.superglue import SuperGlue as JaxSuperGlue
from openglue_tpu.models.superglue import SuperGlueConfig as JaxConfig
from openglue_tpu.train import LossConfig as JaxLossConfig
from openglue_tpu.train import create_train_state as jax_create_train_state
from openglue_tpu.train import make_train_step as jax_make_train_step
from openglue_tpu.train.step import superglue_inputs as jax_superglue_inputs
from openglue_tpu_torch import debugging
from openglue_tpu_torch.compat.jax_weights import superglue_state_dict_from_jax
from openglue_tpu_torch.core.types import KeypointSet, PairBatch, Transformation
from openglue_tpu_torch.data.megadepth import MegaDepthPairsDatasetFeatures
from openglue_tpu_torch.debugging import CheckError, assert_all_finite, checked, find_nonfinite
from openglue_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
from openglue_tpu_torch.train.state import clone_train_state, create_train_state
from openglue_tpu_torch.train.step import LossConfig, make_train_step
from tests.test_torch_device_cache import cli_fixture, run_recorded


def _jax_verdict(fn, *args, errors=jax_debugging.DEFAULT_CHECKS):
    """The JAX package's checked(fn) on args: None if it runs clean, else
    its message."""
    try:
        jax_debugging.checked(fn, errors=errors)(*args)
    except Exception as exc:  # JaxRuntimeError
        return str(exc)
    return None


def _verdict(fn, *args, errors=debugging.DEFAULT_CHECKS):
    try:
        checked(fn, errors=errors)(*args)
    except CheckError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("x", [1.0, 0.5, -1.0], ids=["one", "half", "negative"])
def test_checked_catches_nan_as_jax(x):
    """test_debugging.py's first case: the log of a negative number."""
    want = _jax_verdict(jax.jit(jnp.log), jnp.asarray(x))
    got = _verdict(torch.log, torch.tensor(x))
    assert (got is None) == (want is None)
    if got is not None:
        assert "nan" in want and got == "nan generated by aten.log.default"
    else:
        assert float(checked(torch.log)(torch.tensor(x))) == pytest.approx(np.log(x))


def test_assert_all_finite_inside_checked_as_jax():
    """test_debugging.py's second case: a user check inside the checked
    function, the same message."""
    def jax_fn(tree):
        jax_debugging.assert_all_finite(tree, "tree")
        return tree["a"] * 2

    def fn(tree):
        assert_all_finite(tree, "tree")
        return tree["a"] * 2

    out = checked(fn, errors=debugging.USER_CHECKS)({"a": torch.ones(3)})
    assert torch.equal(out, torch.full((3,), 2.0))
    for a in ([1.0, 2.0, 3.0], [1.0, np.nan, 2.0], [np.inf, 0.0, 1.0]):
        want = _jax_verdict(jax_fn, {"a": jnp.asarray(a)}, errors=checkify.user_checks)
        got = _verdict(fn, {"a": torch.tensor(a)}, errors=debugging.USER_CHECKS)
        assert (got is None) == (want is None), a
        if got is not None:
            assert got == "non-finite values in tree['a']" and got in want


def test_find_nonfinite_report_as_jax():
    """test_debugging.py's third case, and a nested tree: the same paths and
    counts."""
    values = {"good": np.ones(4, np.float32), "bad": np.asarray([1.0, np.nan, np.inf, 2.0], np.float32),
              "ints": np.arange(3), "nested": [np.zeros(2, np.float32), np.asarray([np.nan] * 3, np.float32)]}
    want = jax_debugging.find_nonfinite(jax.tree_util.tree_map(jnp.asarray, values))
    got = find_nonfinite(jax.tree_util.tree_map(torch.from_numpy, values))
    assert got == want == {"['bad']": {"nan": 1, "inf": 1, "size": 4},
                           "['nested'][1]": {"nan": 3, "inf": 0, "size": 3}}
    side = KeypointSet(torch.zeros(1, 2, 2), torch.full((1, 2, 4), float("inf")), torch.zeros(1, 2, 1),
                       torch.ones(1, 2, dtype=torch.bool), torch.ones(1, 2))
    assert find_nonfinite(PairBatch(side, side, Transformation("perspective", H=torch.eye(3)[None]))) == {
        ".side0.descriptors": {"nan": 0, "inf": 8, "size": 8}, ".side1.descriptors": {"nan": 0, "inf": 8, "size": 8}}


def test_checked_train_step_runs_clean_as_jax():
    """test_debugging.py's fourth case on the same weights and batch: JAX's
    checked step and the port's run clean, the port's equal to its unchecked
    step bit for bit, and the mode saw the backward's ops."""
    cfg = JaxConfig(descriptor_dim=32, pe_hidden_layers_sizes=(16,), num_stages=1, otp_num_iters=4)
    model = JaxSuperGlue(cfg)
    batch = JaxPairs(num_keypoints=32, descriptor_dim=32).sample(jax.random.key(0), 2)
    variables = jax.jit(lambda key: model.init(key, **jax_superglue_inputs(batch)))(jax.random.key(1))
    step = jax_debugging.checked(jax_make_train_step(JaxLossConfig(positive_threshold=3.0)),
                                 errors=checkify.float_checks)
    _, jax_metrics = step(jax_create_train_state(model.apply, variables), batch)
    assert np.isfinite(float(jax_metrics["total_loss"]))

    port_cfg = SuperGlueConfig(descriptor_dim=32, pe_hidden_layers_sizes=(16,), num_stages=1, otp_num_iters=4)
    port = SuperGlue(port_cfg, device="cpu")
    port.load_state_dict(superglue_state_dict_from_jax(variables, port_cfg))
    sides = [KeypointSet(*(torch.from_numpy(np.array(getattr(s, f))) for f in (
        "keypoints", "descriptors", "side_info", "mask", "image_size"))) for s in (batch.side0, batch.side1)]
    port_batch = PairBatch(*sides, Transformation("perspective", H=torch.from_numpy(np.array(batch.transformation.H))))
    state = create_train_state(port)
    twin = clone_train_state(state)
    run = checked(make_train_step(LossConfig(positive_threshold=3.0)))
    metrics = run(state, port_batch)
    plain = make_train_step(LossConfig(positive_threshold=3.0))(twin, port_batch)
    assert torch.equal(metrics["total_loss"], plain["total_loss"])
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jax_metrics["total_loss"]), rtol=1e-5)
    assert any(name.endswith("_backward") for name in run.seen) and sum(run.seen.values()) > 500
    for a, b in zip(state.model.parameters(), twin.model.parameters()):
        assert torch.equal(a, b)


def test_zero_divisor_and_out_of_range_index_raise_as_jax():
    """A zero divisor and an index past its axis: the verdicts of JAX's
    checks, the aten op named; in range and nonzero, clean."""
    x = np.arange(4, dtype=np.float32)
    for y in (np.ones(4, np.float32), np.asarray([1, 2, 0, 4], np.float32)):
        want = _jax_verdict(lambda a, b: a / b, jnp.asarray(x), jnp.asarray(y))
        got = _verdict(torch.div, torch.from_numpy(x), torch.from_numpy(y))
        assert (got is None) == (want is None)
        if got:
            assert "division by zero" in want and got == "division by zero in aten.div.Tensor"
    assert _verdict(lambda a: a % 0, torch.arange(3)) == "division by zero in aten.remainder.Scalar"
    for i in ([1, 3], [1, 4]):
        want = _jax_verdict(lambda a, j: a[j], jnp.asarray(x), jnp.asarray(i))
        got = _verdict(lambda a, j: a[j], torch.from_numpy(x), torch.tensor(i))
        assert (got is None) == (want is None), i
        if got:
            assert "out-of-bounds" in want and got == "out-of-bounds index in aten.index.Tensor: index 4 for axis 0 of size 4"
    grid = torch.zeros(2, 3)
    assert _verdict(torch.gather, grid, 1, torch.tensor([[0, 3]])) == (
        "out-of-bounds index in aten.gather.default: index 3 for axis 1 of size 3")
    assert _verdict(lambda t: t.index_select(0, torch.tensor([2])), grid).startswith("out-of-bounds index")
    assert _verdict(lambda t: torch.zeros(3).scatter_add(0, torch.tensor([5]), t[0, :1]), grid).startswith(
        "out-of-bounds index in aten.scatter_add")


def test_nan_made_in_a_backward_pass_raises():
    """The mode follows the step into its backward: sqrt's backward at 0
    divides 0 by 0."""
    def fn(x):
        (x.sqrt() * 0).sum().backward()
        return x.grad

    x = torch.zeros(3, requires_grad=True)
    assert _verdict(fn, x, errors={debugging.NAN}) == "nan generated by aten.div.Tensor"
    x = torch.zeros(3, requires_grad=True)
    assert _verdict(fn, x) == "division by zero in aten.div.Tensor"
    assert _verdict(fn, torch.ones(3, requires_grad=True)) is None


@pytest.mark.parametrize("counter", [glk.message_counter, glk.message_bwd_counter, glk.counter, sk.counter,
                                     sk.adjoint_counter], ids=lambda c: c.name.split()[0])
def test_kernel_outputs_are_checked_under_the_kernels_name(counter):
    """A wrapper hands its launch's outputs to the checks: inside ``checked``
    a NaN there raises under the kernel's name; outside, or without the NaN
    check, the launch is only counted."""
    start = counter.count
    clean, bad = torch.ones(4), torch.tensor([1.0, float("nan")])
    checked(counter.add)(clean, clean)
    counter.add(bad)
    checked(counter.add, errors={debugging.DIV})(bad)
    with pytest.raises(CheckError, match=f"nan generated by the {counter.name} kernel \\(output 1\\)"):
        checked(counter.add)(clean, bad)
    assert counter.count == start + 4
    counter.count = start


# ---------------------------------------------------------- --checkify on the CPU


def test_train_cached_checkify_equals_unchecked(tmp_path, monkeypatch, capsys):
    """--checkify with the device cache: the same losses, gradient norms,
    validation and final state as the unchecked trainer on the same rows,
    and no warm-up."""
    argv = cli_fixture(tmp_path, 16)
    plain_state, plain = run_recorded(argv, monkeypatch)
    capsys.readouterr()
    state, record = run_recorded(argv + ["--checkify"], monkeypatch)
    assert "warm-up" not in capsys.readouterr().out
    assert state.step == plain_state.step == 2
    assert record["metrics"] == plain["metrics"] and record["eval"] == plain["eval"]
    want = plain_state.model.state_dict()
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_train_cached_checkify_raises_on_a_planted_nan(tmp_path, monkeypatch):
    """One NaN in every descriptor of one image (column 0): the checked step
    raises naming the aten op that first computed a NaN; unchecked, the step
    returns a NaN loss."""
    argv = cli_fixture(tmp_path, 0)
    real = MegaDepthPairsDatasetFeatures._load_image_raw

    def planted(self, scene, img_name):
        lafs, scores, desc, *rest = real(self, scene, img_name)
        if (scene, img_name) == ("scene_a", "im0.jpg"):
            desc = desc.copy()
            desc[:, 0] = np.nan
        return (lafs, scores, desc, *rest)

    monkeypatch.setattr(MegaDepthPairsDatasetFeatures, "_load_image_raw", planted)
    with pytest.raises(CheckError, match=r"^nan generated by aten\.") as raised:
        run_recorded(argv + ["--checkify"], monkeypatch)
    assert "kernel" not in str(raised.value)
