"""CLI application parity tests (the reference's executable inventory)."""

import os

import numpy as np
import pytest

from visual_odometry_tpu import apps
from visual_odometry_tpu.utils import evaluation as ev
from visual_odometry_tpu.utils import io


def test_real_init(reference_data_dir, tmp_path, capsys):
    x, tri = apps.run_real_init(reference_data_dir, str(tmp_path))
    # The two-view init recovers the ground-truth relative pose of the
    # first pair (frame 0 in frame 1's camera), up to the monocular scale.
    params = io.load_camera_params(os.path.join(reference_data_dir, "camera.dat"))
    gt = io.gt_poses_se3(
        io.load_trajectory(os.path.join(reference_data_dir, "trajectory.dat"))[1]
    )
    cir = params.cam_in_robot
    x_gt = np.linalg.inv(cir) @ np.linalg.inv(gt[1]) @ gt[0] @ cir
    assert np.abs(x[:3, :3] - x_gt[:3, :3]).max() < 1e-3
    t = x[:3, 3] / np.linalg.norm(x[:3, 3])
    t_gt = x_gt[:3, 3] / np.linalg.norm(x_gt[:3, 3])
    assert float(t @ t_gt) > 0.99
    assert len(tri) > 40
    assert os.path.exists(tmp_path / "triangulated.txt")
    assert os.path.exists(tmp_path / "world.txt")


def test_picp_known_real_near_perfect(reference_data_dir, tmp_path):
    poses = apps.run_picp_known_real(reference_data_dir, str(tmp_path), verbose=False)
    params = io.load_camera_params(os.path.join(reference_data_dir, "camera.dat"))
    gt = io.gt_poses_se3(
        io.load_trajectory(os.path.join(reference_data_dir, "trajectory.dat"))[1]
    )
    absolute = io.robot_trajectory(poses, params.cam_in_robot)
    res = ev.evaluate(absolute, gt)
    # Known world + known DA => metric scale and near-zero error.
    assert abs(res.scale - 1.0) < 1e-3
    assert res.rmse_position < 1e-3
    assert os.path.exists(tmp_path / "trajectory_est.txt")


def test_compute_corr_perfect_agreement(reference_data_dir):
    a_set, g_set = apps.run_compute_corr(reference_data_dir, verbose=False)
    # On this dataset appearances are unique landmark keys => appearance DA
    # reproduces the ground-truth association exactly.
    assert a_set == g_set and len(a_set) > 40


def test_read_data_test_smoke(reference_data_dir, capsys):
    params, seq = apps.run_read_data_test(reference_data_dir)
    out = capsys.readouterr().out
    assert "frames: 121" in out
    assert "world landmarks: 1000" in out


def test_cli_dispatch(reference_data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert apps.main(["read_data_test", reference_data_dir]) == 0
    assert apps.main(["bogus", reference_data_dir]) == 1
    assert apps.main([]) == 1


def test_init_synthetic(capsys):
    x, x_gt = apps.run_init_synthetic(seed=0, num_points=400)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=5e-3)
    # constant per-axis t ratio = correct direction up to monocular scale
    ratio = x[:3, 3] / x_gt[:3, 3]
    assert np.abs(ratio - ratio.mean()).max() < 1e-2 * abs(ratio.mean())


def test_picp_synthetic():
    x, x_gt = apps.run_picp_synthetic(seed=0, num_points=1000, iterations=100, verbose=False)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-3)
    np.testing.assert_allclose(x[:3, 3], x_gt[:3, 3], atol=1e-2)


def test_whole_synthetic_app():
    x, x_gt = apps.run_whole_synthetic(seed=0, num_points=1500, verbose=False)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-2)


def test_kdtree_selfcheck():
    correct = apps.run_kdtree_test(seed=0, num_points=300, verbose=False)
    assert correct.mean() > 0.9


def test_cli_dispatch_synthetic(capsys):
    assert apps.main(["kdtree_test", "3"]) == 0
    assert "FAST Correct" in capsys.readouterr().out
