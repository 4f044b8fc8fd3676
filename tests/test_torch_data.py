"""The port's data path (fixture writer, pair index, cached-feature dataset,
collate, bucket schedules, samplers, loader) against the JAX package on the
CPU: the same fixture files and seeds give equal arrays, bit for bit."""

import subprocess
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from openglue_tpu.data import bucketing as jax_bucketing
from openglue_tpu.data import collate as jax_collate
from openglue_tpu.data import fixture as jax_fixture
from openglue_tpu.data import loader as jax_loader
from openglue_tpu.data import megadepth as jax_megadepth
from openglue_tpu.data import sampler as jax_sampler
from openglue_tpu.features.lafs import get_laf_to_sideinfo_converter as jax_converter
from openglue_tpu_torch.data import bucketing, collate, fixture, io, loader, megadepth, sampler
from openglue_tpu_torch.features.lafs import get_laf_to_sideinfo_converter
from tests.test_data import TARGET_CACHED, make_megadepth_fixture

REPO = Path(__file__).resolve().parents[1]
SCENES = ["scene_a", "scene_b"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("megadepth")
    make_megadepth_fixture(path)
    return path


def _datasets(root, **kw):
    args = (root, "features_cache", SCENES)
    kw = dict(target_size=TARGET_CACHED, **kw)
    return megadepth.MegaDepthPairsDatasetFeatures(*args, **kw), jax_megadepth.MegaDepthPairsDatasetFeatures(*args, **kw)


def _assert_tree_equal(port, ref, where=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(np.asarray(port), ref, err_msg=where)
    else:
        assert port == ref, where


def _batch_arrays(batch):
    """Every array of a PairBatch of either package, as numpy (bf16 as f32)."""
    out = {}
    for name, side in (("side0", batch.side0), ("side1", batch.side1)):
        for field in ("keypoints", "descriptors", "side_info", "mask", "image_size"):
            value = getattr(side, field)
            if isinstance(value, torch.Tensor):
                value = value.float() if value.dtype == torch.bfloat16 else value
                value = value.numpy()
            value = np.asarray(value)
            out[f"{name}.{field}"] = value.astype(np.float32) if value.dtype == ml_dtypes.bfloat16 else value
    tf = batch.transformation
    for field in ("K0", "K1", "R", "T", "depth0", "depth1"):
        value = getattr(tf, field)
        out[f"tf.{field}"] = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
    assert tf.kind == "3d_reprojection"
    return out


def _assert_batches_equal(port, ref):
    port, ref = _batch_arrays(port), _batch_arrays(ref)
    assert set(port) == set(ref)
    for key in ref:
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


# ------------------------------------------------------------ fixture writer


def test_fixture_writer_matches_jax(tmp_path):
    """The port's generate_megadepth_fixture (every h5 file through
    data.io.save_h5) writes the JAX writer's files at one seed: the arrays,
    the depth's gzip settings, pairs.txt, the scene lists and config.yaml."""
    import h5py

    kw = dict(scenes=3, images_per_scene=4, points_per_scene=300, image_size=(96, 72),
              descriptor_dim=16, keep_fraction_range=(0.3, 1.0), val_scenes=1, seed=7)
    port_stats = fixture.generate_megadepth_fixture(tmp_path / "port", **kw)
    ref_stats = jax_fixture.generate_megadepth_fixture(tmp_path / "jax", **kw)
    assert port_stats == ref_stats and ref_stats["pairs"] > 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert sum(f.suffix == ".h5" for f in files) == 3 * 4 * 5
    for rel in files:
        port, ref = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix != ".h5":
            assert port.read_bytes() == ref.read_bytes(), rel
            continue
        with h5py.File(port, "r") as fp, h5py.File(ref, "r") as fr:
            assert list(fp.keys()) == list(fr.keys()), rel
            for key in fr:
                assert (fp[key].compression, fp[key].compression_opts) == (
                    fr[key].compression, fr[key].compression_opts), rel
                assert fp[key].dtype == fr[key].dtype, rel
                np.testing.assert_array_equal(fp[key][()], fr[key][()], err_msg=str(rel))


def test_port_modules_import_without_h5py_and_cv2():
    """h5py and cv2 are imported where they are used: every port module
    imports in a process where both are missing."""
    code = """
import importlib, pathlib, sys
sys.modules["h5py"] = None
sys.modules["cv2"] = None
import openglue_tpu_torch
root = pathlib.Path(openglue_tpu_torch.__file__).parent
for path in sorted(root.rglob("*.py")):
    parts = path.relative_to(root.parent).with_suffix("").parts
    importlib.import_module(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
from openglue_tpu_torch.data import io
try:
    io.load_h5("missing.h5")
except ImportError:
    print("ok")
"""
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_save_h5_round_trips_with_compression(tmp_path):
    depth = np.random.default_rng(0).uniform(1, 9, (12, 16)).astype(np.float32)
    io.save_h5(tmp_path / "d.h5", depth, key="depth", compression="gzip", compression_opts=1)
    io.save_h5(tmp_path / "s.h5", np.arange(5, dtype=np.float32))
    np.testing.assert_array_equal(io.load_h5(tmp_path / "d.h5", key="depth"), depth)
    np.testing.assert_array_equal(io.load_h5(tmp_path / "s.h5"), np.arange(5, dtype=np.float32))
    assert io.h5_dataset_shape(tmp_path / "d.h5", key="depth") == (12, 16)
    assert io.h5_dataset_shape(tmp_path / "s.h5") == (5,)


# ---------------------------------------------------------------- the index


@pytest.mark.parametrize("kw", [
    {}, {"overlap": (0.25, 0.45)}, {"max_pairs_per_scene": 1}, {"overlap": (0.5, 0.9)},
], ids=["all", "overlap", "capped", "none-pass"])
def test_pairs_index_matches_jax(root, kw):
    port = megadepth.MegaDepthPairsIndex(root, SCENES + ["nonexistent"], **kw)
    ref = jax_megadepth.MegaDepthPairsIndex(root, SCENES + ["nonexistent"], **kw)
    assert len(port) == len(ref) and port.scene_sizes() == ref.scene_sizes()
    for a, b in zip(port.flat, ref.flat):
        assert (a.scene, a.img0, a.img1, a.overlap) == (b.scene, b.img0, b.img1, b.overlap)
        for field in ("K0", "K1", "R", "T"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


# ----------------------------------------------------- the cached dataset


@pytest.mark.parametrize("random_crop", [False, True], ids=["centre", "random"])
def test_cached_sample_matches_jax(root, random_crop):
    """Every sample of a pass, with the crop's RNG from one seed: random
    crops draw in the same order, so the whole stream agrees."""
    port, ref = _datasets(root, random_crop=random_crop, seed=5)
    assert len(port) == len(ref) == 6
    for i in list(range(len(ref))) * 2:  # the second pass reads the image cache
        _assert_tree_equal(port[i], ref[i], f"sample {i}")


def test_keypoint_count_matches_jax(root):
    port, ref = _datasets(root)
    counts = [port.keypoint_count(i) for i in range(len(port))]
    assert counts == [ref.keypoint_count(i) for i in range(len(ref))] and counts[0] == 50


# ------------------------------------------------------------------ collate


@pytest.fixture(scope="module")
def samples(root):
    port, _ = _datasets(root)
    return [port[i] for i in range(4)]


@pytest.mark.parametrize("kw", [
    dict(target_num_keypoints=64),
    dict(target_num_keypoints=8),
    dict(target_num_keypoints=8, random=True),
    dict(target_num_keypoints=1024, buckets=(64, 256, 1024), random=True),
    dict(target_num_keypoints=32, buckets=(64, 256)),
    dict(target_num_keypoints=1024, buckets=(64, 256, 1024), force_bucket=256),
    dict(target_num_keypoints=32, force_bucket=256, random=True),
    dict(target_num_keypoints=40, random=True, laf="scale_rotation", log_response=True),
], ids=["pad", "top-score", "random", "buckets", "bucket-capped", "force-bucket", "force-capped", "laf"])
def test_stack_keypoints_batch_matches_jax(samples, kw):
    kw = dict(kw)
    laf = kw.pop("laf", "none")
    port = collate.stack_keypoints_batch(samples, rng=np.random.default_rng(3),
                                         laf_converter=get_laf_to_sideinfo_converter(laf), **kw)
    ref = jax_collate.stack_keypoints_batch(samples, rng=np.random.default_rng(3),
                                            laf_converter=jax_converter(laf), **kw)
    _assert_batches_equal(port, ref)


@pytest.mark.parametrize("n", [128, 64, 32])
def test_resize_keypoint_axis_matches_jax(samples, n):
    port = collate.stack_keypoints_batch(samples, 64)
    ref = jax_collate.stack_keypoints_batch(samples, 64)
    _assert_batches_equal(collate.resize_keypoint_axis(port, n), jax_collate.resize_keypoint_axis(ref, n))


def test_cast_for_transfer_matches_jax(samples):
    port = collate.cast_for_transfer(collate.stack_keypoints_batch(samples, 64))
    ref = jax_collate.cast_for_transfer(jax_collate.stack_keypoints_batch(samples, 64))
    assert port.side0.descriptors.dtype == torch.bfloat16 and port.side0.keypoints.dtype == torch.float32
    _assert_batches_equal(port, ref)


# ---------------------------------------------------- samplers and schedules


@pytest.mark.parametrize("shard", [0, 1])
def test_balanced_sampler_stream_matches_jax(shard):
    sizes = {"a": 7, "empty": 0, "b": 30, "c": 3}
    port = iter(sampler.BalancedSceneSampler(sizes, seed=5, num_shards=2, shard_index=shard))
    ref = iter(jax_sampler.BalancedSceneSampler(sizes, seed=5, num_shards=2, shard_index=shard))
    assert [next(port) for _ in range(300)] == [next(ref) for _ in range(300)]


@pytest.mark.parametrize("shard", [0, 1])
def test_sharded_sequential_sampler_matches_jax(shard):
    port = sampler.ShardedSequentialSampler(11, num_shards=2, shard_index=shard)
    ref = jax_sampler.ShardedSequentialSampler(11, num_shards=2, shard_index=shard)
    assert list(port) == list(ref) and len(port) == len(ref)


def test_samplers_default_to_one_shard():
    assert list(sampler.ShardedSequentialSampler(5)) == list(range(5))
    port = iter(sampler.BalancedSceneSampler({"a": 4, "b": 9}, seed=2))
    ref = iter(jax_sampler.BalancedSceneSampler({"a": 4, "b": 9}, seed=2, num_shards=1, shard_index=0))
    assert [next(port) for _ in range(50)] == [next(ref) for _ in range(50)]
    with pytest.raises(ValueError, match="no scene has any pairs"):
        sampler.BalancedSceneSampler({"a": 0})


def _counts(i):
    return (100, 900, 300, 40, 1000)[i % 5] + i


@pytest.mark.parametrize("local_slice", [None, (0, 4), (4, 8)])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("length", [64, 67])
def test_bucket_grouped_index_schedule_matches_jax(local_slice, drop_last, length):
    kw = dict(batch_size=8, buckets=(256, 512, 1024), local_slice=local_slice, drop_last=drop_last)
    port = list(bucketing.BucketGroupedIndexBatches(iter(range(length)), _counts, **kw))
    ref = list(jax_bucketing.BucketGroupedIndexBatches(iter(range(length)), _counts, **kw))
    assert port == ref and len(ref) > 4


@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_bucket_groups_matches_jax(drop_last):
    kw = dict(batch_size=4, buckets=(256, 1024), drop_last=drop_last)
    port = list(bucketing.iter_bucket_groups(iter(range(45)), _counts, **kw))
    assert port == list(jax_bucketing.iter_bucket_groups(iter(range(45)), _counts, **kw))
    assert list(bucketing.iter_bucket_groups(iter(range(45)), _counts, num_batches=3, **kw)) == port[:3]
    assert {b for b, _ in port} == {256, 1024}


# -------------------------------------------------------------------- loader


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_matches_jax(workers, drop_last):
    kw = dict(batch_size=7, collate_fn=lambda xs: [x * x for x in xs], num_workers=workers,
              prefetch=2, drop_last=drop_last)
    port = list(loader.DataLoader(list(range(100)), **kw))
    assert port == list(jax_loader.DataLoader(list(range(100)), **kw))
    assert len(port) == (14 if drop_last else 15)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batch_sampler_and_bound_match_jax(workers):
    batches = [([1, 2, 3], {"force_bucket": 64}), ([4, 5], {"force_bucket": 16}), [7, 8]]
    collate_fn = lambda xs, force_bucket=None: (sum(xs), force_bucket)
    results = []
    for module in (loader, jax_loader):
        results.append(list(module.DataLoader(list(range(100)), batch_size=3, collate_fn=collate_fn,
                                              batch_sampler=iter(batches), num_workers=workers)))
        results.append(list(module.DataLoader(list(range(10)), batch_size=2, collate_fn=list,
                                              sampler=iter(lambda: 3, None), num_workers=workers,
                                              num_batches=5)))
    assert results[0] == results[2] == [(6, 64), (9, 16), (15, None)]
    assert results[1] == results[3] == [[3, 3]] * 5


def _bad_collate(xs):
    if 12 in xs:
        raise RuntimeError("boom")
    return xs


def _bad_sampler():
    yield from range(5)
    raise RuntimeError("sampler boom")


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("source", ["worker", "sampler"])
def test_loader_raises_in_the_consumer_like_jax(workers, source):
    """A worker's and a sampler's exception reach the consumer after the
    batches before it, in both packages."""
    for module in (loader, jax_loader):
        if source == "worker":
            it = iter(module.DataLoader(list(range(20)), batch_size=4, collate_fn=_bad_collate,
                                        num_workers=workers))
            match, before = "boom", 3
        else:
            it = iter(module.DataLoader(list(range(20)), batch_size=2, collate_fn=sum,
                                        sampler=_bad_sampler(), num_workers=workers))
            match, before = "sampler boom", 2
        got = [next(it) for _ in range(before)]
        with pytest.raises(RuntimeError, match=match):
            next(it)
        assert len(got) == before


class _RacingDraws:
    """Each sample one draw from the dataset's generator ``rng``; sample
    ``late`` holds its draw until the other of the first two has drawn (or
    half a second has passed), so that two loader threads meet here in the
    order ``late`` sets."""

    def __init__(self, late):
        self.rng = np.random.default_rng(0)
        self.late, self.other_drew = late, threading.Event()

    def __len__(self):
        return 4

    def __getitem__(self, idx):
        if idx == self.late:
            self.other_drew.wait(timeout=0.5)
        draw = int(self.rng.integers(1 << 30))
        if idx == 1 - self.late:
            self.other_drew.set()
        return draw


@pytest.mark.parametrize("dataset", ["racing draws", "cached features, random crop"])
def test_loader_threads_draw_the_same_batches_whatever_their_order(root, dataset):
    """With worker threads each batch draws from a generator of its own
    (seeded from the dataset's and its place in the sampler's order), so the
    batches do not depend on which thread draws first (a world-2 trainer's
    batches once did, and with them its distance from world 1)."""
    def batches(late):
        if dataset == "racing draws":
            return list(loader.DataLoader(_RacingDraws(late), batch_size=1, collate_fn=list, num_workers=2))
        ds = megadepth.MegaDepthPairsDatasetFeatures(root, "features_cache", SCENES, target_size=TARGET_CACHED,
                                                     random_crop=True, seed=1)
        # a crop moves the principal point by its offset and drops keypoints
        col = lambda s: [(*x["transformation"]["K0"][:2, 2].tolist(), *x["transformation"]["K1"][:2, 2].tolist(),
                          len(x["lafs0"]), len(x["lafs1"])) for x in s]
        return list(loader.DataLoader(ds, batch_size=2, collate_fn=col, sampler=range(len(ds)), num_workers=3,
                                      drop_last=False))

    assert batches(0) == batches(1)


def test_loader_with_the_cached_dataset_matches_jax(root):
    """The loader over the dataset with the collate, grouped by bucket:
    one worker-free pass gives the same batches in both packages."""
    batches = []
    for ds_mod, col_mod, bk_mod, ld_mod in ((megadepth, collate, bucketing, loader),
                                            (jax_megadepth, jax_collate, jax_bucketing, jax_loader)):
        ds = ds_mod.MegaDepthPairsDatasetFeatures(root, "features_cache", SCENES, target_size=TARGET_CACHED,
                                                  random_crop=True, seed=1)
        rng = np.random.default_rng(9)
        groups = bk_mod.BucketGroupedIndexBatches(iter(range(len(ds))), ds.keypoint_count, batch_size=2,
                                                  buckets=(32, 64), drop_last=False)
        col = lambda s, **kw: col_mod.stack_keypoints_batch(s, 64, random=True, rng=rng, buckets=(32, 64), **kw)
        batches.append(list(ld_mod.DataLoader(ds, batch_size=2, collate_fn=col, batch_sampler=iter(groups),
                                              num_workers=0, drop_last=False)))
    assert len(batches[0]) == len(batches[1]) == 3
    for port, ref in zip(*batches):
        _assert_batches_equal(port, ref)
