"""The port's COLMAP pairs generator (``openglue_tpu_torch/data/
pairs_generation.py``) against the JAX package's on the scene that
tests/test_pairs_generation.py writes: the same rotations and overlaps, the
same pairs.txt records (numbers within 1e-6), depth validity read through
the port's ``data.io``, and the written pose reprojecting through the
port's geometry."""

import numpy as np
import torch

from openglue_tpu.data import pairs_generation as jax_pairs
from openglue_tpu_torch.data import io
from openglue_tpu_torch.data.megadepth import parse_pairs_line
from openglue_tpu_torch.data.pairs_generation import (
    generate_pairs, points3d_overlap, quaternion_to_rotation, valid_depth,
)
from openglue_tpu_torch.geometry.transforms import reproject_3d
from tests.test_pairs_generation import write_colmap_scene

C, S = np.cos(np.pi / 16), np.sin(np.pi / 16)
IMAGES = [
    ("a.jpg", (1, 0, 0, 0), (0, 0, 0), [f"p{i}" for i in range(20)]),
    ("b.jpg", (C, 0, S, 0), (0.4, 0.1, 0.05), [f"p{i}" for i in range(10, 20)] + [f"r{i}" for i in range(10)]),
    ("c.jpg", (1, 0, 0, 0), (5, 5, 5), ["q1", "q2"]),
    ("d.jpg", (0.9, 0.1, 0.3, 0.2), (1, -2, 0.5), [f"p{i}" for i in range(5)] + ["q1"]),
]


def _records(path):
    rows = [line.split(" ") for line in path.read_text().splitlines()]
    return [(r[:4], np.asarray(r[4:], np.float64)) for r in rows]


def test_quaternion_and_overlap_as_jax():
    c = np.cos(np.pi / 4)
    for q in [(1, 0, 0, 0), (c, 0, 0, c), (C, 0, S, 0), (0.9, 0.1, 0.3, 0.2)]:
        np.testing.assert_array_equal(quaternion_to_rotation(*q), jax_pairs.quaternion_to_rotation(*q))
    np.testing.assert_allclose(quaternion_to_rotation(c, 0, 0, c) @ [1, 0, 0], [0, 1, 0], atol=1e-12)
    for a, b in [({"1", "2", "3"}, {"2", "3", "4", "5"}), (set(), {"1"}), ({"1"}, {"1"})]:
        assert points3d_overlap(a, b) == jax_pairs.points3d_overlap(a, b)
    assert points3d_overlap({"1", "2", "3"}, {"2", "3", "4", "5"}) == 2 / 3


def test_generate_pairs_writes_jax_records_and_reprojects(tmp_path):
    sparse = tmp_path / "sparse-txt"
    write_colmap_scene(sparse, IMAGES)
    for interval in [(0.1, 0.9), (0.0, 1.0), (0.6, 0.7)]:
        n = generate_pairs(sparse, tmp_path / "port.txt", overlap_interval=interval)
        m = jax_pairs.generate_pairs(sparse, tmp_path / "jax.txt", overlap_interval=interval)
        got, want = _records(tmp_path / "port.txt"), _records(tmp_path / "jax.txt")
        assert n == m == len(got) == len(want)
        for (names, values), (ref_names, ref_values) in zip(got, want):
            assert names == ref_names
            np.testing.assert_allclose(values, ref_values, rtol=0, atol=1e-6)
    n = generate_pairs(sparse, sparse / "pairs.txt", overlap_interval=(0.1, 0.9))
    lines = (sparse / "pairs.txt").read_text().splitlines()
    assert n == len(lines) == 3  # (a, b) 1/2, (a, d) 5/6, (c, d) 1/2; b and d share nothing, c and a nothing
    rec = parse_pairs_line(lines[0], scene="s")
    assert (rec.img0, rec.img1) == ("a.jpg", "b.jpg") and rec.overlap == 0.5

    # a world point into both cameras, and reproject_3d from a into b
    rng = np.random.default_rng(0)
    world = np.stack([rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8), rng.uniform(4, 8, 8)], axis=1)
    R_b, T_b = quaternion_to_rotation(C, 0, S, 0), np.array([0.4, 0.1, 0.05])

    def project(R, T):
        cam = world @ R.T + T
        uv = cam @ rec.K0.astype(np.float64).T
        return uv[:, :2] / uv[:, 2:3], cam[:, 2]

    kpts_a, depth_a = project(np.eye(3), np.zeros(3))
    kpts_b, _ = project(R_b, T_b)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)[None])
    projected, valid = reproject_3d(as_t(kpts_a), as_t(rec.K0), as_t(rec.K1), as_t(rec.T), as_t(rec.R),
                                    as_t(depth_a))
    assert bool(valid.all())
    np.testing.assert_allclose(projected[0].numpy(), kpts_b, atol=1e-2)


def test_depth_validity_through_the_ports_io(tmp_path):
    """Images whose depth map is missing or holds a -1 are skipped, as JAX
    skips them."""
    sparse, depths = tmp_path / "sparse-txt", tmp_path / "depths"
    write_colmap_scene(sparse, IMAGES)
    depths.mkdir()
    io.save_h5(depths / "a.h5", np.ones((4, 4), np.float32), key="depth")
    io.save_h5(depths / "b.h5", np.ones((4, 4), np.float32), key="depth")
    bad = np.ones((4, 4), np.float32)
    bad[1, 2] = -1
    io.save_h5(depths / "d.h5", bad, key="depth")
    for name in ("a.jpg", "b.jpg", "c.jpg", "d.jpg"):
        assert valid_depth(depths, name) == jax_pairs.valid_depth(depths, name)
    assert [valid_depth(depths, n) for n in ("a.jpg", "c.jpg", "d.jpg")] == [True, False, False]
    assert valid_depth(None, "c.jpg")
    n = generate_pairs(sparse, tmp_path / "port.txt", depth_dir=depths, overlap_interval=(0.0, 1.0))
    assert n == jax_pairs.generate_pairs(sparse, tmp_path / "jax.txt", depth_dir=depths,
                                         overlap_interval=(0.0, 1.0)) == 1
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
