import numpy as np
import jax.numpy as jnp

from visual_odometry_tpu.ops import triangulation
from visual_odometry_tpu.utils import synthetic


def test_recovers_synthetic_points(rng):
    world, w1, _, p1, p2, corr_valid, x12 = synthetic.two_view_scene(rng, 3000)
    pts, ok = triangulation.triangulate_pairs(
        jnp.asarray(np.array(synthetic.default_camera().camera_matrix)),
        jnp.asarray(x12),
        jnp.asarray(p1),
        jnp.asarray(p2),
        jnp.asarray(corr_valid),
    )
    ok = np.array(ok)
    assert ok.sum() > 30
    # Triangulated points are in camera-1 coordinates.
    expected = world @ w1[:3, :3].T + w1[:3, 3]
    err = np.linalg.norm(np.array(pts)[ok] - expected[ok], axis=1)
    assert np.median(err) < 1e-2
    # Invalid correspondences are masked out.
    assert not ok[~corr_valid].any()


def test_behind_camera_rejected():
    # Two cameras looking at +z; a point behind both rays' origins.
    k = jnp.eye(3)
    x12 = jnp.eye(4).at[:3, 3].set(jnp.array([1.0, 0.0, 0.0]))  # pure baseline
    # Rays pointing forward triangulate in front:
    p_front, ok_front = triangulation.triangulate_pairs(
        k, x12, jnp.array([[0.0, 0.0]]), jnp.array([[0.0, 0.0]]), jnp.array([True])
    )
    del p_front
    # A geometry whose ray intersection needs a negative ray parameter:
    # cam-2 origin is at [-1, 0, 0] in cam-1 coords, rays (u,0,1) meet at
    # s = -1/(u1 - u2) which is negative when u1 > u2.
    _, ok_behind = triangulation.triangulate_pairs(
        k,
        x12,
        jnp.array([[2.0, 0.0]]),
        jnp.array([[-2.0, 0.0]]),
        jnp.array([True]),
    )
    assert not bool(ok_behind[0])
    del ok_front


def test_masks_propagate(rng):
    world, _, _, p1, p2, corr_valid, x12 = synthetic.two_view_scene(rng, 128)
    cam = synthetic.default_camera()
    all_false = jnp.zeros_like(jnp.asarray(corr_valid))
    _, ok = triangulation.triangulate_pairs(
        cam.camera_matrix, jnp.asarray(x12), jnp.asarray(p1), jnp.asarray(p2), all_false
    )
    assert not np.array(ok).any()


def test_near_parallel_rays_never_emit_nonfinite(rng):
    """Rays just above the determinant epsilon can push the ray parameters
    past f32 range; such points must be rejected (ok=False) and zeroed —
    a non-finite 'valid' triangulation NaN-poisons downstream GN through
    inf * 0 (observed on an accelerator with a degenerate bootstrap)."""
    from visual_odometry_tpu.ops import triangulation
    from visual_odometry_tpu.utils import synthetic

    cam = synthetic.default_camera()
    n = 64
    p1 = rng.uniform(100, 500, (n, 2)).astype(np.float32)
    # Sub-micro-pixel offsets: nearly identical rays at a nearly-identity
    # relative pose -> det barely above eps, huge ray parameters.
    p2 = p1 + rng.uniform(1e-5, 1e-3, (n, 2)).astype(np.float32)
    x = np.eye(4, dtype=np.float32)
    x[:3, 3] = [1e-12, 0.0, 0.0]
    pts, ok = triangulation.triangulate_pairs(
        cam.camera_matrix, jnp.asarray(x), jnp.asarray(p1), jnp.asarray(p2),
        jnp.ones(n, bool),
    )
    pts = np.asarray(pts)
    assert np.isfinite(pts).all()
    assert (np.abs(pts[np.asarray(ok)]) < 1e18).all()


def test_zero_parallax_sequence_stays_finite(rng):
    """A fully degenerate sequence (camera never moves: every pair is
    homography-explained, bootstrap falls back to identity, triangulation
    is all-parallel) must still produce a finite trajectory in both scan
    backends — the reference would produce garbage-but-running output;
    NaNs are never acceptable."""
    import warnings

    from visual_odometry_tpu.models import pipeline
    from visual_odometry_tpu.ops.camera import project_points
    from visual_odometry_tpu.utils import synthetic
    from visual_odometry_tpu.utils.config import VOConfig

    n, f = 64, 8
    world = np.stack(
        [
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(-1.2, 1.2, n),
            rng.uniform(2.0, 4.0, n),
        ],
        axis=1,
    ).astype(np.float32)
    apps = synthetic.generate_appearances(rng, n)
    uv, valid = project_points(synthetic.default_camera(), jnp.asarray(world))
    pts = jnp.asarray(np.tile(np.asarray(uv)[None], (f, 1, 1)))
    msk = jnp.asarray(np.tile(np.asarray(valid)[None], (f, 1)))
    aps = jnp.asarray(np.tile(apps[None], (f, 1, 1)))
    cfg = VOConfig(n_slots=n, map_capacity=128, gn_iterations=10)
    for backend in ("xla", "fused_interpret"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            traj, _, _ = pipeline.run_sequence(
                synthetic.default_camera(),
                cfg.replace(scan_backend=backend),
                pts, aps, msk,
            )
        assert np.isfinite(np.asarray(traj)).all(), backend
