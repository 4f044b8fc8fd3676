"""The port's request-path bucketing (data/bucketing.py) against the JAX
package's ``choose_bucket`` / ``batch_bucket`` and ``OpenGlueMatcher._to_bucket``."""

import numpy as np
import pytest
import torch

from openglue_tpu.cli.inference import OpenGlueMatcher
from openglue_tpu.data import bucketing as jax_bucketing
from openglue_tpu_torch.core.types import KeypointSet
from openglue_tpu_torch.data import bucketing

BUCKETS = (512, 128, 256)


@pytest.mark.parametrize("count", [0, 1, 128, 129, 256, 300, 512, 513, 4000])
def test_choose_bucket_matches_jax(count):
    assert bucketing.choose_bucket(count, BUCKETS) == jax_bucketing.choose_bucket(count, BUCKETS)


@pytest.mark.parametrize("counts", [[], [3], [100, 130], [600, 2], [256, 256]])
def test_batch_bucket_matches_jax(counts):
    assert bucketing.batch_bucket(counts, BUCKETS) == jax_bucketing.batch_bucket(counts, BUCKETS)


def _side(rng, n, valid):
    lafs = rng.standard_normal((n, 2, 3)).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    scores[::7] = scores[0]  # ties, which a stable sort keeps in order
    desc = rng.standard_normal((n, 8)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:valid]] = True
    return lafs, scores, desc, mask


@pytest.mark.parametrize("n,valid,bucket", [(40, 33, 64), (40, 33, 40), (90, 70, 64), (90, 20, 64)])
def test_to_bucket_matches_jax_request_path(n, valid, bucket):
    rng = np.random.default_rng(n + bucket)
    lafs, scores, desc, mask = _side(rng, n, valid)
    ref_lafs, ref_scores, ref_desc, ref_mask = OpenGlueMatcher._to_bucket(lafs, scores, desc, mask, bucket)
    side = KeypointSet(
        keypoints=torch.from_numpy(lafs[None, :, :, 2].copy()), descriptors=torch.from_numpy(desc[None]),
        side_info=torch.from_numpy(scores[None, :, None]), mask=torch.from_numpy(mask[None]),
        image_size=torch.tensor([[640.0, 480.0]]),
    )
    out = bucketing.to_bucket(side, bucket)
    assert out.num_keypoints == bucket and out.image_size is side.image_size
    np.testing.assert_array_equal(out.mask[0].numpy(), ref_mask)
    np.testing.assert_array_equal(out.keypoints[0].numpy(), ref_lafs[:, :, 2])
    np.testing.assert_array_equal(out.descriptors[0].numpy(), ref_desc)
    np.testing.assert_array_equal(out.side_info[0, :, 0].numpy(), ref_scores)


def test_pair_to_bucket_pads_both_sides_to_the_larger_valid_count():
    rng = np.random.default_rng(0)
    sides = []
    for n, valid in ((300, 120), (300, 200)):
        lafs, scores, desc, mask = _side(rng, n, valid)
        sides.append(KeypointSet(
            torch.from_numpy(lafs[None, :, :, 2].copy()), torch.from_numpy(desc[None]),
            torch.from_numpy(scores[None, :, None]), torch.from_numpy(mask[None]),
            torch.tensor([[640.0, 480.0]]),
        ))
    out0, out1 = bucketing.pair_to_bucket(*sides, BUCKETS)
    assert out0.num_keypoints == out1.num_keypoints == 256
    # trimming keeps every valid keypoint when the bucket holds them all
    assert int(out0.mask.sum()) == 120 and int(out1.mask.sum()) == 200
