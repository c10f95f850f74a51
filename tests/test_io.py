import os

import numpy as np

from visual_odometry_tpu.utils import io


def test_camera_params(reference_data_dir):
    p = io.load_camera_params(os.path.join(reference_data_dir, "camera.dat"))
    np.testing.assert_allclose(
        p.camera_matrix, [[180, 0, 320], [0, 180, 240], [0, 0, 1]]
    )
    assert (p.z_near, p.z_far, p.width, p.height) == (0, 5, 640, 480)
    np.testing.assert_allclose(
        p.cam_in_robot,
        [[0, 0, 1, 0.2], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
    )


def test_measurements(reference_data_dir):
    f = io.load_measurements(os.path.join(reference_data_dir, "meas-00000.dat"))
    assert f.points.shape[1] == 2 and f.appearances.shape[1] == 10
    assert len(f.ids) == len(f.points) == len(f.appearances)
    # The generator lists each frame's landmarks in id order, projected
    # inside the 640 x 480 image, with the landmark's own appearance.
    assert (np.diff(f.ids) > 0).all()
    assert (f.points >= 0).all() and (f.points[:, 0] <= 639).all()
    assert (f.points[:, 1] <= 479).all()
    ids, _, apps = io.load_world(os.path.join(reference_data_dir, "world.dat"))
    np.testing.assert_allclose(f.appearances, apps[f.ids], rtol=1e-5)


def test_world(reference_data_dir):
    ids, pts, apps = io.load_world(os.path.join(reference_data_dir, "world.dat"))
    assert pts.shape == (1000, 3) and apps.shape == (1000, 10)
    assert ids[0] == 0 and ids[-1] == 999
    # 20 x 20 x 4 m box around the driven circle (dataset_gen).
    assert (np.abs(pts[:, 2]) <= 2.0).all()
    assert np.ptp(pts[:, 0]) <= 20.0 and np.ptp(pts[:, 1]) <= 20.0


def test_sequence_padding(reference_data_dir):
    seq = io.load_sequence(reference_data_dir, 128)
    assert seq.points.shape == (121, 128, 2)
    assert seq.mask.shape == (121, 128)
    assert (seq.counts >= 1).all() and (seq.counts <= 128).all()
    # Padded appearances are the huge sentinel, padded ids -1.
    first_pad = seq.counts[0]
    assert (seq.appearances[0, first_pad:] == io.PAD_APPEARANCE).all()
    assert (seq.ids[0, first_pad:] == -1).all()
    assert seq.mask[0, : seq.counts[0]].all()


def test_trajectory_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    # Random relative poses -> save with rotation -> load back absolute.
    from visual_odometry_tpu.utils.synthetic import generate_pose

    poses = np.stack([generate_pose(rng) for _ in range(5)])
    h = generate_pose(rng)
    out = str(tmp_path / "traj.txt")
    absolute = io.save_trajectory(out, poses, h, save_rotation=True)
    loaded = io.load_est_trajectory(out)
    np.testing.assert_allclose(loaded[:, :3, 3], absolute[:, :3, 3], atol=2e-4)
    np.testing.assert_allclose(loaded[:, :3, :3], absolute[:, :3, :3], atol=2e-4)


def test_gt_poses(reference_data_dir):
    odom, gt = io.load_trajectory(os.path.join(reference_data_dir, "trajectory.dat"))
    assert odom.shape == gt.shape == (121, 3)
    poses = io.gt_poses_se3(gt)
    assert poses.shape == (121, 4, 4)
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
