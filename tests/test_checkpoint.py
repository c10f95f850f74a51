"""Checkpoint/resume: split tracking must equal one-shot tracking."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from visual_odometry_tpu.models import pipeline
from visual_odometry_tpu.ops.camera import Camera
from visual_odometry_tpu.utils import checkpoint, io
from visual_odometry_tpu.utils.config import VOConfig


@pytest.fixture(scope="module")
def loaded(reference_data_dir):
    data_dir = reference_data_dir
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(
        params.camera_matrix, rows=params.height, cols=params.width,
        z_near=params.z_near, z_far=params.z_far,
    )
    seq = io.load_sequence(data_dir, 128)
    return camera, seq


def test_split_equals_oneshot(loaded, tmp_path):
    camera, seq = loaded
    cfg = VOConfig(gn_iterations=20)
    pts = jnp.asarray(seq.points[:40])
    apps_ = jnp.asarray(seq.appearances[:40])
    m = jnp.asarray(seq.mask[:40])
    ids = jnp.asarray(seq.ids[:40])

    f0 = pipeline.FrameData(pts[0], apps_[0], m[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps_[1], m[1], ids[1])
    state0, x_init = pipeline.initialize(camera, cfg, f0, f1)

    # One shot over frames 2..40 from the same state.
    _, out_full = pipeline.continue_sequence(
        camera, cfg, state0, pts[2:], apps_[2:], m[2:], ids[2:]
    )

    # Split: frames 2..20, checkpoint round-trip, resume 20..40.
    state, out_a = pipeline.continue_sequence(
        camera, cfg, state0, pts[2:20], apps_[2:20], m[2:20], ids[2:20]
    )
    ckpt = str(tmp_path / "state.npz")
    traj_a = np.concatenate(
        [np.eye(4, dtype=np.float32)[None], np.asarray(x_init)[None], np.asarray(out_a.pose)]
    )
    checkpoint.save_state(ckpt, state, traj_a)
    state2, traj_a2 = checkpoint.load_state(ckpt)
    np.testing.assert_array_equal(traj_a, traj_a2)

    _, out_b = pipeline.continue_sequence(
        camera, cfg, state2, pts[20:], apps_[20:], m[20:], ids[20:]
    )
    split_poses = np.concatenate([np.asarray(out_a.pose), np.asarray(out_b.pose)])

    # The carry is the complete pipeline state: split == one-shot exactly.
    np.testing.assert_array_equal(np.asarray(out_full.pose), split_poses)

    # And the whole-run entry point agrees to f32 chain tolerance.
    traj_full, _, _ = pipeline.run_sequence(camera, cfg, pts, apps_, m)
    full_split = np.concatenate([traj_a2, np.asarray(out_b.pose)])
    np.testing.assert_allclose(
        np.asarray(traj_full)[:, :3, 3], full_split[:, :3, 3], atol=5e-3
    )


def test_split_equals_oneshot_fused(loaded):
    """The fused resume path (continue_sequence on the frame-loop kernel,
    through the Pallas interpreter) must match: split == one-shot
    bit-for-bit on the fused backend, and agree with the scan backend
    within the documented cross-backend f32 tolerance — including the
    carried map."""
    camera, seq = loaded
    cfg = VOConfig(gn_iterations=20, scan_backend="fused_interpret")
    pts = jnp.asarray(seq.points[:30])
    apps_ = jnp.asarray(seq.appearances[:30])
    m = jnp.asarray(seq.mask[:30])
    ids = jnp.asarray(seq.ids[:30])

    f0 = pipeline.FrameData(pts[0], apps_[0], m[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps_[1], m[1], ids[1])
    state0, _ = pipeline.initialize(camera, cfg, f0, f1)

    sf_full, out_full = pipeline.continue_sequence(
        camera, cfg, state0, pts[2:], apps_[2:], m[2:], ids[2:]
    )
    state_a, out_a = pipeline.continue_sequence(
        camera, cfg, state0, pts[2:16], apps_[2:16], m[2:16], ids[2:16]
    )
    state_b, out_b = pipeline.continue_sequence(
        camera, cfg, state_a, pts[16:], apps_[16:], m[16:], ids[16:]
    )
    split_poses = np.concatenate([np.asarray(out_a.pose), np.asarray(out_b.pose)])
    np.testing.assert_array_equal(np.asarray(out_full.pose), split_poses)
    # Final carried state matches too: map layout and positions, lookup,
    # triangulation carry.
    np.testing.assert_array_equal(
        np.asarray(sf_full.map.valid), np.asarray(state_b.map.valid)
    )
    # Map POSITIONS: the frame-0 gauge chains are tree-reduced
    # (associative_scan over f32 matmuls), so a split re-associates the
    # products at the boundary — documented ~1e-5 tolerance
    # (pipeline.continue_sequence docstring); everything else is exact.
    np.testing.assert_allclose(
        np.asarray(sf_full.map.points), np.asarray(state_b.map.points),
        atol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(sf_full.point_lookup), np.asarray(state_b.point_lookup)
    )

    # Cross-backend: the scan resume and the fused resume are different
    # f32 programs; they must agree to the kernel-equality tolerance.
    cfg_x = cfg.replace(scan_backend="xla")
    sx, out_x = pipeline.continue_sequence(
        camera, cfg_x, state0, pts[2:], apps_[2:], m[2:], ids[2:]
    )
    np.testing.assert_allclose(
        np.asarray(out_full.pose), np.asarray(out_x.pose), atol=2e-3
    )
    assert int(np.asarray(sf_full.map.valid).sum()) == int(
        np.asarray(sx.map.valid).sum()
    )
