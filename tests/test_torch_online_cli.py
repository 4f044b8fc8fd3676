"""The online trainer's entry points on the CPU, end to end:
``cli.pretrain_homography`` on a ``generate_image_fixture`` folder (with
weak_color_aug and the homography-precision validation) and ``cli.train``
on tests/test_data.py's MegaDepth fixture (with the pose validation), each
to a checkpoint; ``cli.inference.initialize_matcher`` serving the
pretraining experiment with the extractor its checkpoint holds; resuming;
and the refusals: a data-parallel world that WORLD_SIZE names without the
address of its rendezvous, and ``--device cuda`` without a card."""

import numpy as np
import pytest
import torch

from openglue_tpu_torch.cli import inference, pretrain_homography, train
from openglue_tpu_torch.data.fixture import generate_image_fixture
from openglue_tpu_torch.train.checkpoint import latest_step
from tests.test_cli import SMALL_SUPERGLUE, write_yaml
from tests.test_data import make_megadepth_fixture

FEATURES = {"name": "SuperPointNet", "descriptor_dim": 32,
            "parameters": {"max_keypoints": 64, "descriptor_dim": 32}, "weights": None}
TRAIN = {
    "epochs": 1, "steps_per_epoch": 2, "grad_clip": 10.0, "margin": None, "nll_weight": 1.0,
    "metric_weight": 0.0, "lr": 1.0e-3, "scheduler_gamma": 0.999994, "finetune_features_extractor": False,
}


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A pretraining run of two steps (``--smoke``) and its experiment."""
    root = tmp_path_factory.mktemp("pretrain")
    generate_image_fixture(root / "images", num_images=3, image_size=(160, 128), seed=2)
    config = {
        "data": {"root_path": str(root / "images"), "batch_size": 2, "dataloader_workers": 0,
                 "target_size": [128, 96], "warp_offset": 16, "val_pairs": 2},
        "logging": {"root_path": str(root / "logs"), "name": "p", "train_logs_steps": 1},
        "train": dict(TRAIN, gt_positive_threshold=3, gt_negative_threshold=3, evaluation=True,
                      augmentations={"name": "weak_color_aug"}),
        "features": FEATURES,
        "superglue": SMALL_SUPERGLUE,
        "inference": {"match_threshold": 0.0},
    }
    write_yaml(root / "cfg.yaml", config)
    state = pretrain_homography.main(["--config", str(root / "cfg.yaml"), "--device", "cpu", "--smoke"])
    (experiment,) = (root / "logs" / "p").iterdir()
    return dict(root=root, state=state, experiment=experiment, config=root / "cfg.yaml")


def test_pretrain_homography_runs_to_a_checkpoint(pretrained):
    state, experiment = pretrained["state"], pretrained["experiment"]
    assert state.step == 2 and latest_step(experiment / "checkpoints") == 2
    assert (experiment / "features_config.yaml").exists() and (experiment / "config.yaml").exists()
    payload = torch.load(experiment / "checkpoints" / "2.pt", weights_only=True)
    keys = set(payload["model"])
    assert any(k.startswith("extractor.conv1a") for k in keys) and any(k.startswith("superglue.") for k in keys)
    for key, value in state.model.state_dict().items():
        assert torch.equal(payload["model"][key], value), key


def test_pretraining_experiment_is_served(pretrained):
    """initialize_matcher on the online experiment: the matcher takes the
    checkpoint's superglue part, the device extractor its extractor part
    (the features config names no weights, so a fresh seeded extractor
    would differ), and a pair is matched."""
    matcher = inference.initialize_matcher(pretrained["experiment"], target_size=(128, 96), device="cpu")
    model = pretrained["state"].model
    assert matcher.device_extractor
    for key, value in model.extractor.state_dict().items():
        assert torch.equal(matcher.extractor.state_dict()[key], value), key
    for key, value in model.superglue.state_dict().items():
        assert torch.equal(matcher.model.state_dict()[key], value), key
    images = pretrained["root"] / "images"
    result = inference.run_inference(matcher, images / "img0000.jpg", images / "img0001.jpg", ransac=False)
    assert result["keypoints0"].shape == result["keypoints1"].shape and len(result["keypoints0"]) >= 1


def test_pretraining_resumes_from_its_checkpoint(pretrained):
    state = pretrain_homography.main(["--config", str(pretrained["config"]), "--device", "cpu", "--smoke",
                                      "--checkpoint", str(pretrained["experiment"] / "checkpoints")])
    assert state.step == 4
    assert np.isfinite(state.model.superglue.dustbin_score.detach().item())


def test_train_on_megadepth_images(tmp_path):
    make_megadepth_fixture(tmp_path, pairs_per_scene=4, with_features=False)
    (tmp_path / "train_list.txt").write_text("scene_a\n")
    (tmp_path / "val_list.txt").write_text("scene_b\n")
    write_yaml(tmp_path / "features.yaml", FEATURES)
    config = {
        "data": {"root_path": str(tmp_path), "train_list_path": "train_list.txt", "val_list_path": "val_list.txt",
                 "batch_size": 2, "dataloader_workers": 0, "target_size": [160, 120],
                 "val_max_pairs_per_scene": 2, "train_pairs_overlap": None},
        "logging": {"root_path": str(tmp_path / "logs"), "name": "on", "train_logs_steps": 1},
        "train": dict(TRAIN, gt_positive_threshold=3, gt_negative_threshold=5, augmentations={"name": "none"}),
        "evaluation": {"epipolar_dist_threshold": 5.0e-4, "camera_auc_thresholds": [5, 10, 20],
                       "camera_auc_ransac_inliers_threshold": 1.0},
        "inference": {"match_threshold": 0.0},
        "superglue": SMALL_SUPERGLUE,
    }
    write_yaml(tmp_path / "cfg.yaml", config)
    state = train.main(["--config", str(tmp_path / "cfg.yaml"), "--features_config", str(tmp_path / "features.yaml"),
                        "--device", "cpu", "--smoke"])
    assert state.step == 2
    (experiment,) = (tmp_path / "logs" / "on").iterdir()
    assert latest_step(experiment / "checkpoints") == 2
    assert (experiment / "features_config.yaml").read_text() == (tmp_path / "features.yaml").read_text()


def test_refusals(pretrained, monkeypatch):
    args = ["--config", str(pretrained["config"]), "--smoke"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain_homography.main(args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--config", str(pretrained["config"])])
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for main in (pretrain_homography.main, train.main):
        with pytest.raises(RuntimeError, match="MASTER_ADDR is not set"):
            main(args + ["--device", "cpu"])
