"""The device-resident descriptor cache of the port (``data/device_cache.py``),
its collate (``data/collate.py::stack_keypoints_batch_device``) and the
dataset's device mode against the JAX package on the CPU, on
tests/test_data.py's MegaDepth fixture; and ``cli.train_cached`` with the
cache, held bit for bit against host mode on the same rows."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglue_tpu.data.collate import resize_keypoint_axis as jax_resize_keypoint_axis
from openglue_tpu.data.collate import stack_keypoints_batch_device as jax_stack_device
from openglue_tpu.data.device_cache import DeviceDescriptorCache as JaxCache
from openglue_tpu.data.megadepth import MegaDepthPairsDatasetFeatures as JaxDataset
from openglue_tpu_torch.cli import train_cached
from openglue_tpu_torch.data import collate
from openglue_tpu_torch.data.collate import (
    DeviceDescBatch, cast_for_transfer, resize_keypoint_axis, stack_keypoints_batch, stack_keypoints_batch_device,
)
from openglue_tpu_torch.data.device_cache import DeviceDescriptorCache
from openglue_tpu_torch.data.megadepth import MegaDepthPairsDatasetFeatures
from openglue_tpu_torch.train.loop import pin_batch
from tests.test_cli import write_yaml
from tests.test_data import TARGET_CACHED, make_megadepth_fixture
from tests.torch_dp_worker import recorded_cli

REPO = Path(__file__).resolve().parents[1]
SCENES = ["scene_a", "scene_b"]
B, N = 3, 64


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("megadepth")
    make_megadepth_fixture(root, num_kpts=80)
    return root


def _datasets(root, device_descriptors, random_crop=False):
    return (MegaDepthPairsDatasetFeatures(root, "features_cache", SCENES, target_size=TARGET_CACHED,
                                          random_crop=random_crop, device_descriptors=device_descriptors),
            JaxDataset(root, "features_cache", SCENES, target_size=TARGET_CACHED, random_crop=random_crop,
                       device_descriptors=device_descriptors))


def test_dataset_device_samples_match_jax(fixture_root):
    """Every device-mode sample (keys, original row indices, the unfiltered
    block, lafs, scores, geometry) equals the JAX package's."""
    port, ref = _datasets(fixture_root, True)
    assert len(port) == len(ref) == 6
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert set(got) == set(want)
        for side in (0, 1):
            assert got[f"desc_key{side}"] == want[f"desc_key{side}"]
            for field in ("desc_orig_idx", "lafs", "scores", "descriptors"):
                a, b = got[f"{field}{side}"], want[f"{field}{side}"]
                assert a.dtype == b.dtype and a.shape == b.shape, field
                np.testing.assert_array_equal(a, b, err_msg=field)
            assert got[f"descriptors{side}"].shape[0] > got[f"lafs{side}"].shape[0]  # the crop dropped rows
        for key in ("K0", "K1", "R", "T", "depth0", "depth1"):
            np.testing.assert_array_equal(got["transformation"][key], want["transformation"][key], err_msg=key)


@pytest.mark.parametrize("random", [False, True], ids=["top-score", "seeded-draws"])
def test_device_collate_matches_jax(fixture_root, random):
    """stack_keypoints_batch_device's index arrays, masks, side info, keys
    and geometry equal JAX's on the same samples and draws; its light fields
    equal the host collate's on the same draws."""
    port, ref = _datasets(fixture_root, True)
    host, _ = _datasets(fixture_root, False)
    kw = dict(target_num_keypoints=N, random=random, buckets=(32, 64, 128))
    got = stack_keypoints_batch_device([port[i] for i in range(B)], rng=np.random.default_rng(4), **kw)
    want = jax_stack_device([ref[i] for i in range(B)], rng=np.random.default_rng(4), **kw)
    plain = stack_keypoints_batch([host[i] for i in range(B)], rng=np.random.default_rng(4), **kw)
    assert isinstance(got, DeviceDescBatch) and got.batch.side0.descriptors.shape == (B, N, 0)
    assert got.keys0 == want.keys0 and got.keys1 == want.keys1 and set(got.blocks) == set(want.blocks)
    for side in (0, 1):
        index = getattr(got, f"index{side}")
        assert index.dtype == torch.int32
        np.testing.assert_array_equal(index.numpy(), getattr(want, f"index{side}"))
        mine, theirs, host_side = (getattr(b, f"side{side}") for b in (got.batch, want.batch, plain))
        for field in ("keypoints", "side_info", "mask", "image_size"):
            np.testing.assert_array_equal(getattr(mine, field).numpy(), np.asarray(getattr(theirs, field)))
            assert torch.equal(getattr(mine, field), getattr(host_side, field)), field
        assert not bool(mine.mask.all())  # padding rows are in the batch
    for key in ("K0", "K1", "R", "T", "depth0", "depth1"):
        np.testing.assert_array_equal(getattr(got.batch.transformation, key).numpy(),
                                      np.asarray(getattr(want.batch.transformation, key)), err_msg=key)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gather_matches_jax_cache_and_host_collate(fixture_root, dtype):
    """The gathered descriptors equal JAX's cache's (stored in the same type)
    and, bit for bit, the host collate's cast to that type; padding rows are
    +0.0."""
    port, ref = _datasets(fixture_root, True)
    host, _ = _datasets(fixture_root, False)
    item = stack_keypoints_batch_device([port[i] for i in range(B)], N, rng=np.random.default_rng(1), random=True)
    jax_item = jax_stack_device([ref[i] for i in range(B)], N, rng=np.random.default_rng(1), random=True)
    plain = stack_keypoints_batch([host[i] for i in range(B)], N, rng=np.random.default_rng(1), random=True)
    if dtype == torch.bfloat16:  # the trainer's cast for a bf16-compute model, in both modes
        plain, item = cast_for_transfer(plain), cast_for_transfer(item)
    cache = DeviceDescriptorCache(slots=8, cap=96, dim=32, dtype=dtype, device="cpu")
    jax_cache = JaxCache(slots=8, cap=96, dim=32, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    moved = cache.to_device(item)
    jax_cache.ensure([*jax_item.keys0, *jax_item.keys1], jax_item.blocks)
    assert cache.misses == jax_cache.misses == len(item.blocks) and cache.hits == jax_cache.hits
    for side in (0, 1):
        got = getattr(moved, f"side{side}").descriptors
        want = jax_cache.gather(getattr(jax_item, f"keys{side}"), getattr(jax_item, f"index{side}"),
                                getattr(jax_item.batch, f"side{side}").mask)
        assert got.dtype == dtype and got.shape == (B, N, 32)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        host_desc = getattr(plain, f"side{side}").descriptors
        assert host_desc.dtype == dtype
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), host_desc.view(bits))  # +0.0 padding included
        mask = getattr(moved, f"side{side}").mask
        assert not bool(mask.all()) and bool((got[~mask].view(bits) == 0).all())
        assert torch.equal(getattr(moved, f"side{side}").side_info, getattr(plain, f"side{side}").side_info)


def test_lru_eviction_and_reinstall_as_jax():
    """tests/test_data.py's LRU sequence: the same hits, misses and evictions
    as JAX's cache, and the reinstalled block gathers back."""
    rng = np.random.default_rng(0)
    blocks = {("s", f"i{k}"): rng.normal(size=(10, 8)).astype(np.float32) for k in range(4)}
    keys = list(blocks)
    port, ref = DeviceDescriptorCache(slots=2, cap=16, dim=8, device="cpu"), JaxCache(slots=2, cap=16, dim=8)
    for batch, (hits, misses) in zip([keys[:2], [keys[0]], [keys[2]], [keys[1]]], [(0, 2), (1, 2), (1, 3), (1, 4)]):
        for cache in (port, ref):
            cache.ensure(batch, blocks)
            assert (cache.hits, cache.misses) == (hits, misses)
        assert list(port.slot_of) == list(ref.slot_of)
    assert keys[1] in port.slot_of and keys[0] not in port.slot_of
    assert port.bytes_copied == 4 * 10 * 8 * 2  # each miss copies the image's 10 rows, not the cap's 16
    idx, mask = torch.arange(10, dtype=torch.int32)[None], torch.ones(1, 10, dtype=torch.bool)
    got = port.gather([keys[1]], idx, mask)
    want = ref.gather([keys[1]], idx.numpy(), mask.numpy())
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(got[0], torch.from_numpy(blocks[keys[1]]).to(torch.bfloat16))


def test_cap_refusal():
    big = {("s", "big"): np.zeros((9, 8), np.float32)}
    for cache in (DeviceDescriptorCache(slots=2, cap=4, dim=8, device="cpu"), JaxCache(slots=2, cap=4, dim=8)):
        with pytest.raises(ValueError, match="cap is 4"):
            cache.ensure([("s", "big")], big)


def test_more_images_than_slots_refused():
    """A batch naming 3 images with 2 slots: the port refuses it with a
    ValueError before touching the cache; JAX's cache evicts one of the
    batch's own images and its gather fails on the missing key."""
    blocks = {("s", f"i{k}"): np.ones((4, 8), np.float32) for k in range(3)}
    port = DeviceDescriptorCache(slots=2, cap=4, dim=8, device="cpu")
    with pytest.raises(ValueError, match="names 3 images but the device cache has 2 slots"):
        port.ensure(list(blocks), blocks)
    assert port.misses == 0 and not port.slot_of
    ref = JaxCache(slots=2, cap=4, dim=8)
    ref.ensure(list(blocks), blocks)
    with pytest.raises(KeyError):
        ref.gather(list(blocks), np.zeros((3, 4), np.int32), np.ones((3, 4), bool))


def test_resize_keypoint_axis_of_a_device_batch(fixture_root):
    port, ref = _datasets(fixture_root, True)
    item = stack_keypoints_batch_device([port[i] for i in range(B)], N, random=False)
    jax_item = jax_stack_device([ref[i] for i in range(B)], N, random=False)
    for n in (32, 64, 96):
        got, want = resize_keypoint_axis(item, n), jax_resize_keypoint_axis(jax_item, n)
        assert isinstance(got, DeviceDescBatch) and got.blocks is item.blocks and got.keys0 == item.keys0
        for side in (0, 1):
            np.testing.assert_array_equal(getattr(got, f"index{side}").numpy(), getattr(want, f"index{side}"))
            for field in ("keypoints", "side_info", "mask"):
                np.testing.assert_array_equal(getattr(getattr(got.batch, f"side{side}"), field).numpy(),
                                              np.asarray(getattr(getattr(want.batch, f"side{side}"), field)))
        assert got.batch.side0.descriptors.shape == (B, n, 0)
    pinned = cast_for_transfer(item)
    assert pinned.batch.side0.side_info.dtype == torch.bfloat16 and pinned.index0.dtype == torch.int32
    if torch.cuda.is_available():
        assert pin_batch(item).index0.is_pinned()


# ---------------------------------------------------------- the CLI on the CPU


def cli_fixture(root, cache_slots):
    """tests/test_data.py's fixture under ``root`` and an override of the
    flagship config: batch 4 of at most 64 keypoints, buckets 32/64 grouped,
    one loader thread (the random crops come in order), 2 steps and a
    validation sweep."""
    if not (root / "features_cache").exists():
        make_megadepth_fixture(root, pairs_per_scene=10)
        write_yaml(root / "features_cache" / "config.yaml", {"name": "OPENCV_SIFT", "descriptor_dim": 32,
                                                           "parameters": {}})
        (root / "train_list.txt").write_text("scene_a\nscene_b\n")
        (root / "val_list.txt").write_text("scene_a\n")
    override = {
        "data": {"root_path": str(root), "train_list_path": "train_list.txt", "val_list_path": "val_list.txt",
                 "features_dir": "features_cache", "max_keypoints": 64, "batch_size": 4,
                 "dataloader_workers": 0, "target_size": list(TARGET_CACHED), "val_max_pairs_per_scene": 3,
                 "train_pairs_overlap": None, "buckets": [32, 64], "device_descriptor_cache": cache_slots,
                 "device_cache_cap": 64},
        "logging": {"root_path": str(root / f"logs{cache_slots}"), "name": "t", "train_logs_steps": 1},
        "train": {"epochs": 1, "steps_per_epoch": 2, "lr": 1.0e-3, "gt_positive_threshold": 3,
                  "gt_negative_threshold": 5},
        "superglue": {"positional_encoding": {"hidden_layers_sizes": [16]}, "attention_gnn": {"num_stages": 1},
                      "otp": {"num_iters": 5}},
        "inference": {"match_threshold": 0.0},
    }
    path = root / f"override{cache_slots}.yaml"
    write_yaml(path, override)
    return ["--config", str(REPO / "configs" / "config_cached_sp_magicleap.yaml"), "--config_override", str(path),
            "--device", "cpu"]


def seeded_collates(monkeypatch, seed):
    """Both collates draw from one generator seeded with ``seed`` (they make
    the same draws for the same samples)."""
    rng = np.random.default_rng(seed)
    for name in ("stack_keypoints_batch", "stack_keypoints_batch_device"):
        real = getattr(collate, name)
        monkeypatch.setattr(collate, name, lambda samples, _real=real, **kw: _real(samples, rng=rng, **kw))


def run_recorded(argv, monkeypatch, seed=0):
    with monkeypatch.context() as mp:
        seeded_collates(mp, seed)
        with recorded_cli({}) as record:
            state = train_cached.main(argv)
    return state, record


def test_train_cached_with_the_cache_equals_host_mode(tmp_path, monkeypatch, capsys):
    """cli.train_cached with data.device_descriptor_cache: 16 trains 2 steps
    and validates bit for bit as host mode does on the same rows: the
    batches the steps see (descriptors included), the losses, the gradient
    norms, the validation metrics and the final state. The flagship computes
    in f32, so both modes carry f32 descriptors (the bf16 storage of a
    bf16-compute model: test_gather_matches_jax_cache_and_host_collate)."""
    host_state, host = run_recorded(cli_fixture(tmp_path, 0), monkeypatch)
    made = []
    real = DeviceDescriptorCache.__init__

    def record_cache(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(DeviceDescriptorCache, "__init__", record_cache)
    dev_state, dev = run_recorded(cli_fixture(tmp_path, 16), monkeypatch)
    (cache,) = made
    want = torch.float32
    assert cache.slots == 16 and cache.cap == 64 and cache.dtype == want and cache.misses > 0
    assert dev_state.step == host_state.step == 2 and len(dev["batches"]) == len(host["batches"]) == 2
    for a, b in zip(dev["batches"], host["batches"]):
        for side in ("side0", "side1"):
            for field in ("keypoints", "descriptors", "side_info", "mask"):
                x, y = getattr(getattr(a, side), field), getattr(getattr(b, side), field)
                assert x.dtype == y.dtype and torch.equal(x, y), (side, field)
        assert a.side0.descriptors.dtype == want
    assert dev["metrics"] == host["metrics"]
    assert dev["eval"] == host["eval"] and "AUC@20deg" in dev["eval"]
    host_sd = host_state.model.state_dict()
    for name, value in dev_state.model.state_dict().items():
        assert torch.equal(value, host_sd[name]), name
    assert "warm-up: one step at N=32" in capsys.readouterr().out
