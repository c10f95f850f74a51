"""Map-scale re-localization (pipeline.relocalize_frame + apps.run_relocalize):
one frame's descriptors queried against the global landmark map."""

import numpy as np
import jax.numpy as jnp
import pytest

from visual_odometry_tpu import apps
from visual_odometry_tpu.models import pipeline
from visual_odometry_tpu.models.refinement import absolute_from_relative
from visual_odometry_tpu.utils import synthetic
from visual_odometry_tpu.utils.config import VOConfig


@pytest.fixture(scope="module")
def tracked_scene():
    from visual_odometry_tpu.ops import se3
    from visual_odometry_tpu.ops.camera import Camera, project_points

    rng = np.random.default_rng(3)
    n_slots, frames = 64, 24
    # The monocular scale is arbitrary (~5x true here), so the tracked map
    # lands deeper than the synthetic default z_far=5 and the solver's
    # frustum gate would reject everything — use a deep-frustum camera.
    k = np.array(
        [[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]],
        np.float32,
    )
    camera = Camera.create(k, rows=480, cols=640, z_near=0, z_far=100.0)
    world = np.stack(
        [
            rng.uniform(-1.5, 1.5, n_slots),
            rng.uniform(-1.2, 1.2, n_slots),
            rng.uniform(2.0, 4.0, n_slots),
        ],
        axis=1,
    ).astype(np.float32)
    apps_keys = synthetic.generate_appearances(rng, n_slots)
    pts, masks = [], []
    for i in range(frames):
        v = np.float32(
            [0.05 * i, -0.02 * i, 0.08 * i, 0.005 * i, -0.005 * i, 0.0025 * i]
        )
        pose = np.array(se3.v2t_euler(jnp.asarray(v)))
        uv, valid = project_points(
            Camera.create(k, pose, rows=480, cols=640, z_near=0, z_far=100.0),
            jnp.asarray(world),
        )
        pts.append(np.asarray(uv))
        masks.append(np.asarray(valid))
    pts = np.stack(pts)
    masks = np.stack(masks)
    apps_a = np.tile(apps_keys[None], (frames, 1, 1))
    # A map database far larger than a frame: the map-scale query regime.
    cfg = VOConfig(n_slots=n_slots, map_capacity=16384, gn_iterations=50)
    traj, map_state, _ = pipeline.run_sequence(
        camera, cfg, jnp.asarray(pts), jnp.asarray(apps_a), jnp.asarray(masks)
    )
    absolute = absolute_from_relative(np.asarray(traj))
    return camera, cfg, map_state, pts, apps_a, masks, absolute


def _frame(pts, apps_a, masks, f):
    s = masks.shape[1]
    return pipeline.FrameData(
        jnp.asarray(pts[f]), jnp.asarray(apps_a[f]), jnp.asarray(masks[f]),
        jnp.full((s,), -1, jnp.int32),
    )


def test_relocalize_recovers_tracked_pose(tracked_scene):
    camera, cfg, map_state, pts, apps_a, masks, absolute = tracked_scene
    for f in (8, 16, 23):
        frame = _frame(pts, apps_a, masks, f)
        pose, stats, n_matches = pipeline.relocalize_frame(
            camera, cfg, map_state, frame, jnp.asarray(absolute[f - 1])
        )
        pose = np.asarray(pose)
        assert int(n_matches) > 20
        assert int(stats.num_inliers) > 20
        # Tracked and relocalized poses share the map's (monocular) scale,
        # so they must agree directly.
        assert np.linalg.norm(pose[:3, 3] - absolute[f][:3, 3]) < 0.05
        assert float(np.trace(np.eye(3) - pose[:3, :3].T @ absolute[f][:3, :3])) < 1e-3


def test_relocalize_app(tmp_path, reference_data_dir):
    rows = apps.run_relocalize(
        reference_data_dir, str(tmp_path), every=30, verbose=False
    )
    assert rows, "no frames relocalized"
    errs = np.array([r[1] for r in rows])
    assert np.median(errs) < 0.05
    assert (tmp_path / "relocalization.txt").exists()
