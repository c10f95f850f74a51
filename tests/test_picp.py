import numpy as np
import jax
import jax.numpy as jnp

from visual_odometry_tpu.ops import picp, se3
from visual_odometry_tpu.ops.camera import project_points
from visual_odometry_tpu.utils import synthetic


def _perturbed_pose(rng, scale=0.2):
    v = rng.uniform(-scale, scale, 6).astype(np.float32)
    return np.array(se3.v2t_euler(jnp.asarray(v)))


def test_converges_to_ground_truth(rng):
    # Mirrors picp_solver_test.cpp:42-79: known world points, measurements
    # projected at a ground-truth pose, solver starts elsewhere.
    world = synthetic.generate_points3d(rng, 3000)
    gt_pose = _perturbed_pose(rng, 0.1)
    cam_gt = synthetic.default_camera(gt_pose)
    meas, valid = project_points(cam_gt, jnp.asarray(world))

    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))
    weights = np.array(valid).astype(np.float32)
    assert weights.sum() > 50
    cam_est, stats = picp.solve(
        cam0,
        jnp.asarray(world),
        meas,
        jnp.asarray(weights),
        num_iterations=100,
        kernel_threshold=10000.0,
    )
    est = np.array(cam_est.world_in_camera)
    np.testing.assert_allclose(est, gt_pose, atol=1e-3)
    assert int(stats.num_inliers) > 50


def test_masked_points_do_not_contribute(rng):
    world = synthetic.generate_points3d(rng, 200)
    gt_pose = _perturbed_pose(rng, 0.1)
    cam_gt = synthetic.default_camera(gt_pose)
    meas, valid = project_points(cam_gt, jnp.asarray(world))
    # Corrupt half the measurements but mask them out.
    meas = np.array(meas)
    meas[::2] += 500.0
    weights = np.array(valid).astype(np.float32)
    weights[::2] = 0.0
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))
    cam_est, _ = picp.solve(
        cam0, jnp.asarray(world), jnp.asarray(meas), jnp.asarray(weights), 100
    )
    np.testing.assert_allclose(np.array(cam_est.world_in_camera), gt_pose, atol=1e-3)


def test_robust_kernel_downweights_outliers(rng):
    world = synthetic.generate_points3d(rng, 400)
    gt_pose = _perturbed_pose(rng, 0.1)
    cam_gt = synthetic.default_camera(gt_pose)
    meas, valid = project_points(cam_gt, jnp.asarray(world))
    meas = np.array(meas)
    # 10% gross outliers that stay "live" (weight 1) — the kernel must cope.
    n_out = len(world) // 10
    meas[:n_out] += 200.0
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))
    cam_est, stats = picp.solve(
        cam0,
        jnp.asarray(world),
        jnp.asarray(meas),
        jnp.asarray(np.array(valid).astype(np.float32)),
        200,
        kernel_threshold=1000.0,
    )
    np.testing.assert_allclose(np.array(cam_est.world_in_camera), gt_pose, atol=5e-3)
    assert int(stats.num_inliers) > 0


def test_linearize_matches_scalar_oracle(rng):
    """Bit-level check of H/b against a literal numpy port of picp_solver.cpp:25-96."""
    world = synthetic.generate_points3d(rng, 64)
    pose = _perturbed_pose(rng, 0.3)
    cam = synthetic.default_camera(pose)
    meas_rng = rng.uniform(0, 480, (64, 2)).astype(np.float32)

    kt = 1000.0
    h, b, stats = picp.linearize(
        cam,
        jnp.asarray(world),
        jnp.asarray(meas_rng),
        jnp.ones(64, jnp.float32),
        jnp.float32(kt),
    )

    k = np.array(cam.camera_matrix)
    w = np.array(cam.world_in_camera)
    h_ref = np.zeros((6, 6), np.float64)
    b_ref = np.zeros(6, np.float64)
    n_inl = 0
    for wp, mp in zip(world, meas_rng):
        pc = w[:3, :3] @ wp + w[:3, 3]
        if pc[2] > float(cam.z_far) or pc[2] < float(cam.z_near):
            continue
        ph = k @ pc
        uv = ph[:2] / ph[2]
        if not (0 <= uv[0] <= float(cam.cols) - 1 and 0 <= uv[1] <= float(cam.rows) - 1):
            continue
        e = uv - mp
        jr = np.zeros((3, 6))
        jr[:, :3] = np.eye(3)
        # skew(-pc), matching picp_solver.cpp:41
        jr[:, 3:] = np.array(
            [[0, pc[2], -pc[1]], [-pc[2], 0, pc[0]], [pc[1], -pc[0], 0]]
        )
        iz = 1.0 / ph[2]
        jp = np.array([[iz, 0, -ph[0] * iz * iz], [0, iz, -ph[1] * iz * iz]])
        jac = jp @ k @ jr
        chi = float(e @ e)
        lam, inlier = 1.0, True
        if chi > kt:
            lam = np.sqrt(kt / chi)
            inlier = False
        if inlier:
            n_inl += 1
            h_ref += jac.T @ jac * lam
            b_ref += jac.T @ e * lam
    np.testing.assert_allclose(np.array(h), h_ref, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(np.array(b), b_ref, rtol=2e-3, atol=1e-2)
    assert int(stats.num_inliers) == n_inl


def test_min_num_inliers_floor_skips_update(rng):
    """picp_solver.cpp:103-107: rounds with < min_num_inliers inliers apply
    no pose update, so a floor above the available inlier count freezes the
    start pose — in ops.picp.solve and in the frame-loop kernel's GN."""
    world = synthetic.generate_points3d(rng, 512)
    gt_pose = _perturbed_pose(rng, 0.05)
    cam_gt = synthetic.default_camera(gt_pose)
    meas, valid = project_points(cam_gt, jnp.asarray(world))
    weights = jnp.asarray(np.array(valid), jnp.float32)
    n_valid = int(np.array(valid).sum())
    assert n_valid >= 8
    start = _perturbed_pose(rng, 0.05)
    cam0 = synthetic.default_camera(start)

    for path in ("xla", "kernel"):
        if path == "kernel":
            out = _kernel_gn(cam0, world, meas, weights, 20, -1.0,
                             min_inl=n_valid + 1)
            frozen, n_inl = _pose_of(out), int(out[14])
        else:
            cam_est, stats = picp.solve(
                cam0, jnp.asarray(world), meas, weights, 20,
                min_num_inliers=n_valid + 1,
            )
            frozen = np.array(cam_est.world_in_camera)
            n_inl = int(stats.num_inliers)
        np.testing.assert_allclose(frozen, start, atol=1e-6)
        # Stats still reflect the (skipped) round's linearization.
        assert 0 < n_inl <= n_valid

    # A floor the data satisfies must not change the solution.
    cam_lo, _ = picp.solve(
        cam0, jnp.asarray(world), meas, weights, 50, min_num_inliers=4,
    )
    cam_ref, _ = picp.solve(cam0, jnp.asarray(world), meas, weights, 50)
    np.testing.assert_allclose(
        np.array(cam_lo.world_in_camera),
        np.array(cam_ref.world_in_camera),
        atol=0.0,
    )


def test_min_num_inliers_floor_se2(rng):
    from visual_odometry_tpu.ops import picp_se2

    world = synthetic.generate_points3d(rng, 64)
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))
    meas, valid = project_points(cam0, jnp.asarray(world))
    meas = jnp.asarray(np.array(meas) + 3.0)  # offset so dx would be nonzero
    weights = jnp.asarray(np.array(valid), jnp.float32)
    n_valid = int(np.array(valid).sum())
    solved, stats = picp_se2.solve_se2(
        cam0, jnp.asarray(world), meas, weights, 10,
        min_num_inliers=n_valid + 1,
    )
    np.testing.assert_allclose(
        np.array(solved.world_in_camera), np.eye(4), atol=1e-6
    )


def test_solve_is_jittable(rng):
    world = jnp.asarray(synthetic.generate_points3d(rng, 128))
    cam = synthetic.default_camera(np.eye(4, dtype=np.float32))
    meas, valid = project_points(cam, world)
    f = jax.jit(lambda c, w, m, wt: picp.solve(c, w, m, wt, 10))
    cam_out, _ = f(cam, world, meas, valid.astype(jnp.float32))
    assert np.isfinite(np.array(cam_out.world_in_camera)).all()


def test_min_iterations_delays_tolerance_exit(rng):
    """A huge tolerance exits after one round; min_iterations forces the
    loop to keep refining first (same final contract in ops.picp.solve and
    the frame-loop kernel's GN)."""
    world = synthetic.generate_points3d(rng, 256)
    gt_pose = _perturbed_pose(rng, 0.05)
    meas, valid = project_points(synthetic.default_camera(gt_pose), jnp.asarray(world))
    weights = jnp.asarray(np.array(valid), jnp.float32)
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))

    # tolerance so large every round's dx passes it -> exit at min_iterations.
    one, _ = picp.solve(
        cam0, jnp.asarray(world), meas, weights, 50, tolerance=1e6,
    )
    more, _ = picp.solve(
        cam0, jnp.asarray(world), meas, weights, 50, tolerance=1e6,
        min_iterations=10,
    )
    err_one = np.abs(np.array(one.world_in_camera) - gt_pose).max()
    err_more = np.abs(np.array(more.world_in_camera) - gt_pose).max()
    assert err_more < err_one * 0.5, (err_one, err_more)

    out = _kernel_gn(cam0, world, meas, weights, 50, 1e6, min_iterations=10)
    np.testing.assert_allclose(
        _pose_of(out), np.array(more.world_in_camera), atol=5e-5
    )


def _kernel_gn(cam, world, meas, weights, iters, tol, min_inl=0.0,
               min_iterations=1):
    """The frame-loop kernel's SE(3) Gauss-Newton loop, run as plain JAX."""
    from visual_odometry_tpu.ops.pallas import frame_kernel

    f32 = jnp.float32
    k = tuple(f32(x) for x in np.asarray(cam.camera_matrix).reshape(9))
    pose0 = tuple(
        f32(x) for x in np.asarray(cam.world_in_camera)[:3, :4].reshape(12)
    )
    w = jnp.asarray(world)
    return frame_kernel._gn_se3(
        iters, min_iterations, k, pose0, w[:, 0], w[:, 1], w[:, 2],
        meas[:, 0], meas[:, 1], weights, cam.z_near, cam.z_far, cam.cols,
        cam.rows, f32(10000.0), f32(0.0), f32(1.0), f32(tol), f32(min_inl),
    )


def _pose_of(out):
    rows = np.asarray(jnp.stack(out[:12])).reshape(3, 4)
    return np.vstack([rows, [0.0, 0.0, 0.0, 1.0]])
