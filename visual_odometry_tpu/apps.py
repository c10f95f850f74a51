"""Command-line applications of the framework.

The equivalents of the reference's executables
(``/root/reference/src/CMakeLists.txt:1-9``):

  * ``vo_complete``   -> :func:`run_vo_complete`  (vo_complete.cpp)
  * ``evaluation``    -> :func:`run_evaluation`   (evaluate.cpp)
  * ``vo_daKnown``    -> :func:`run_vo_da_known`  (vo_daKnown.cpp)

Usage::

    python -m visual_odometry_tpu.apps vo_complete <data_dir> [out_dir]
    python -m visual_odometry_tpu.apps evaluation  <data_dir> [out_dir]
    python -m visual_odometry_tpu.apps vo_daknown  <data_dir> [out_dir]
    python -m visual_odometry_tpu.apps init        [seed]   # initialization_test.cpp
    python -m visual_odometry_tpu.apps picp_test   [seed]   # picp_solver_test.cpp
    python -m visual_odometry_tpu.apps whole_test  [seed]   # essential_picp_test.cpp
    python -m visual_odometry_tpu.apps kdtree_test [seed]   # eigen_kdtree_test.cpp

Output-file contract matches README.md:56-68 (world.txt, map.txt,
map_appearances.txt, trajectory_gt.txt, trajectory_est_complete.txt,
trajectory_est_data.txt, out_performance.txt, map_corrected.txt,
arrows.txt, world_pruned.txt), so gnuplot recipes and the reference
``evaluation`` binary work unchanged on our outputs.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

from .models import pipeline
from .models.landmark_map import compact
from .ops.camera import Camera
from .utils import evaluation as eval_mod
from .utils import io
from .utils import synthetic as synthetic_mod
from .utils.config import DEFAULT_CONFIG, VOConfig


def _load(data_dir: str, config: VOConfig):
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(
        params.camera_matrix,
        rows=params.height,
        cols=params.width,
        z_near=params.z_near,
        z_far=params.z_far,
    )
    seq = io.load_sequence(data_dir, config.n_slots)
    return params, camera, seq


def _check_bootstrap(config: VOConfig, seq, use_known_da: bool = False):
    """Guard the serial pipeline's first frame pair (pipeline.check_bootstrap):
    raises BootstrapError on < 8 correspondences — the reference's exit at
    epipolar_utils.cpp:104-108 — and warns on a homography-degenerate pair."""
    f0 = pipeline.FrameData(
        seq.points[0], seq.appearances[0], seq.mask[0], seq.ids[0]
    )
    f1 = pipeline.FrameData(
        seq.points[1], seq.appearances[1], seq.mask[1], seq.ids[1]
    )
    return pipeline.check_bootstrap(config, f0, f1, use_known_da)


def run_vo_complete(
    data_dir: str,
    out_dir: str = ".",
    config: VOConfig = DEFAULT_CONFIG,
    verbose: bool = True,
):
    """Full VO with appearance-based DA (vo_complete.cpp:68-186)."""
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config)
    _, world_points, world_apps = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)
    io.save_gt_trajectory(
        os.path.join(data_dir, "trajectory.dat"),
        os.path.join(out_dir, "trajectory_gt.txt"),
    )

    # Stage inputs on device first: the host-to-device copy is dataloader
    # work, not pipeline time.
    import jax

    pts_d, apps_d, mask_d = jax.block_until_ready(
        jax.device_put((seq.points, seq.appearances, seq.mask))
    )

    t0 = time.perf_counter()
    if config.num_chunks > 1:
        from .parallel import posegraph

        trajectory, map_state, outs = posegraph.run_sequence_chunked(
            camera, config, pts_d, apps_d, mask_d,
            num_chunks=config.num_chunks, overlap=config.chunk_overlap,
        )
    else:
        _check_bootstrap(config, seq)
        trajectory, map_state, outs = pipeline.run_sequence(
            camera, config, pts_d, apps_d, mask_d
        )
    trajectory = np.asarray(trajectory)  # blocks until done
    elapsed = time.perf_counter() - t0

    if config.refine_iterations > 0:
        from .models import refinement

        refine = (
            refinement.refine_trajectory_sparse
            if config.refine_backend == "sparse"
            else refinement.refine_trajectory
        )
        trajectory, map_pts, map_apps, _ = refine(
            params.camera_matrix,
            trajectory,
            map_state,
            np.asarray(seq.points),
            np.asarray(seq.appearances),
            np.asarray(seq.mask),
            num_iterations=config.refine_iterations,
            damping=config.refine_damping,
            kernel_threshold=config.kernel_threshold,
        )
    else:
        map_pts, map_apps = compact(map_state)
    # map = H * map before writing (vo_complete.cpp:181).
    h = params.cam_in_robot
    map_robot = map_pts @ h[:3, :3].T + h[:3, 3]
    io.write_vectors(os.path.join(out_dir, "map.txt"), map_robot)
    io.write_vectors(os.path.join(out_dir, "map_appearances.txt"), map_apps)
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_complete.txt"), trajectory, h
    )
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"), trajectory, h, save_rotation=True
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames in {elapsed:.3f}s ({f / elapsed:.1f} frames/s)")
        print(f"map landmarks: {len(map_pts)}")
    return trajectory, map_state, outs, elapsed


def run_relocalize(
    data_dir: str,
    out_dir: str = ".",
    config: VOConfig = DEFAULT_CONFIG,
    every: int = 10,
    verbose: bool = True,
):
    """Map-scale re-localization sweep (no reference counterpart).

    Tracks the sequence (building the global landmark map), then, every
    ``every``-th frame, re-localizes that frame AGAINST THE WHOLE MAP
    (pipeline.relocalize_frame) with the previous absolute pose as prior —
    the loop-closure / tracking-recovery query mode, and the end-to-end
    production seat of the streaming map-scale matcher. Writes
    ``relocalization.txt``: frame, position error vs the tracked absolute
    pose, orientation error, matches, inliers.
    """
    os.makedirs(out_dir, exist_ok=True)
    _, camera, seq = _load(data_dir, config)
    import jax
    import jax.numpy as jnp

    pts_d, apps_d, mask_d = jax.block_until_ready(
        jax.device_put((seq.points, seq.appearances, seq.mask))
    )
    _check_bootstrap(config, seq)
    trajectory, map_state, _ = pipeline.run_sequence(
        camera, config, pts_d, apps_d, mask_d
    )
    trajectory = np.asarray(trajectory)
    from .models.refinement import absolute_from_relative

    absolute = absolute_from_relative(trajectory)

    rows = []
    ids = np.full(seq.mask.shape[1:], -1, np.int32)
    for f in range(every, len(trajectory), every):
        frame = pipeline.FrameData(
            jnp.asarray(seq.points[f]), jnp.asarray(seq.appearances[f]),
            jnp.asarray(seq.mask[f]), jnp.asarray(ids),
        )
        pose, stats, n_matches = pipeline.relocalize_frame(
            camera, config, map_state, frame, jnp.asarray(absolute[f - 1])
        )
        pose = np.asarray(pose)
        err_t = float(np.linalg.norm(pose[:3, 3] - absolute[f][:3, 3]))
        r_rel = pose[:3, :3].T @ absolute[f][:3, :3]
        err_r = float(np.trace(np.eye(3) - r_rel))
        rows.append(
            (f, err_t, err_r, int(n_matches), int(stats.num_inliers))
        )
    with open(os.path.join(out_dir, "relocalization.txt"), "w") as fh:
        for r in rows:
            fh.write(f"{r[0]} {r[1]:.6f} {r[2]:.6e} {r[3]} {r[4]}\n")
    if verbose:
        errs = np.array([r[1] for r in rows])
        print(
            f"relocalized {len(rows)} frames: median pos err "
            f"{np.median(errs):.4f}, max {errs.max():.4f}"
        )
    return rows


def run_evaluation(data_dir: str, out_dir: str = ".", verbose: bool = True):
    """Offline metrics (evaluate.cpp), reading the files run_vo_complete wrote."""
    _, gt_xyt = io.load_trajectory(os.path.join(data_dir, "trajectory.dat"))
    gt_poses = io.gt_poses_se3(gt_xyt)
    est_poses = io.load_est_trajectory(os.path.join(out_dir, "trajectory_est_data.txt"))

    map_est = np.loadtxt(os.path.join(out_dir, "map.txt"), ndmin=2, dtype=np.float32)
    map_apps = np.loadtxt(
        os.path.join(out_dir, "map_appearances.txt"), ndmin=2, dtype=np.float32
    )
    _, world_points, world_apps = io.load_world(os.path.join(data_dir, "world.dat"))

    res = eval_mod.evaluate(
        est_poses, gt_poses, map_est, map_apps, world_points, world_apps
    )

    perf = np.stack([res.orientation_errors, res.ratios], axis=1)
    np.savetxt(os.path.join(out_dir, "out_performance.txt"), perf, fmt="%g")
    io.write_vectors(os.path.join(out_dir, "map_corrected.txt"), map_est * res.scale)
    mi, wi = eval_mod.match_map_to_world(map_est, map_apps, world_points, world_apps)
    arrows = np.concatenate([map_est[mi] * res.scale, world_points[wi]], axis=1)
    io.write_vectors(os.path.join(out_dir, "arrows.txt"), arrows)
    io.write_vectors(os.path.join(out_dir, "world_pruned.txt"), world_points[wi])

    if verbose:
        finite = np.isfinite(res.orientation_errors)
        print(f"ratio used for map correction: {res.scale}")
        print(f"orientation error mean: {np.abs(res.orientation_errors[finite]).mean()}")
        print(f"RMSE position: {res.rmse_position}")
        print(f"RMSE map: {res.rmse_map}  ({res.n_map_matched} landmarks matched)")
    return res


def run_vo_da_known(
    data_dir: str,
    out_dir: str = ".",
    config: Optional[VOConfig] = None,
    verbose: bool = True,
):
    """VO with ground-truth data association (vo_daKnown.cpp).

    Uses the landmark ids carried by the measurement files instead of the
    appearance matcher, and the reference's 1000 GN iterations per frame
    (vo_daKnown.cpp:149-150). Writes ``trajectory_est_noWorld.txt``.
    """
    if config is None:
        config = DEFAULT_CONFIG.replace(gn_iterations=1000)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config)

    _check_bootstrap(config, seq, use_known_da=True)
    t0 = time.perf_counter()
    trajectory, _, outs = pipeline.run_sequence_known_da(
        camera,
        config,
        np.asarray(seq.points),
        np.asarray(seq.appearances),
        np.asarray(seq.mask),
        np.asarray(seq.ids),
    )
    trajectory = np.asarray(trajectory)
    elapsed = time.perf_counter() - t0

    # Per-frame DA timing -> time_known.txt (vo_daKnown.cpp:127-129,163-164).
    # The tracking itself fuses DA into one device program, so the timing is
    # measured on a dedicated per-frame run of the id-matcher.
    import jax
    import jax.numpy as jnp

    from .models import pipeline as pl_mod
    from .utils.profiling import StageTimer

    timer = StageTimer()
    match_jit = jax.jit(pl_mod.match_by_ids)
    ids_d = jnp.asarray(seq.ids)
    mask_d = jnp.asarray(seq.mask)
    match_jit(ids_d[0], mask_d[0], ids_d[1], mask_d[1]).valid.block_until_ready()
    for k in range(1, len(trajectory)):
        with timer.stage("da"):
            corr = match_jit(ids_d[k - 1], mask_d[k - 1], ids_d[k], mask_d[k])
            corr.valid.block_until_ready()
    timer.dump(os.path.join(out_dir, "time_known.txt"), "da")

    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_noWorld.txt"), trajectory, params.cam_in_robot
    )
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"),
        trajectory,
        params.cam_in_robot,
        save_rotation=True,
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames (known DA) in {elapsed:.3f}s ({f / elapsed:.1f} frames/s)")
    return trajectory, outs, elapsed


def run_real_init(data_dir: str, out_dir: str = ".", verbose: bool = True):
    """Two-view initialization on the first two real frames.

    Mirrors ``real_init`` (initialization_real_data.cpp): id-ground-truth
    correspondences, 8-point estimate, triangulation dumped (in the robot
    frame) to ``triangulated.txt`` for gnuplot comparison against
    ``world.txt``.
    """
    import jax.numpy as jnp

    from .models import pipeline as pl_mod
    from .ops import epipolar, triangulation

    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, DEFAULT_CONFIG)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)

    _check_bootstrap(DEFAULT_CONFIG, seq, use_known_da=True)
    corr = pl_mod.match_by_ids(
        jnp.asarray(seq.ids[0]), jnp.asarray(seq.mask[0]),
        jnp.asarray(seq.ids[1]), jnp.asarray(seq.mask[1]),
    )
    p0, p1 = jnp.asarray(seq.points[0]), jnp.asarray(seq.points[1])
    m0, m1 = jnp.asarray(seq.mask[0]), jnp.asarray(seq.mask[1])
    x = epipolar.estimate_transform(
        camera.camera_matrix, corr.idx1, corr.idx2, corr.valid, p0, p1, m0, m1
    )
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, x, corr.idx1, corr.idx2, corr.valid, p0, p1
    )
    tri = np.asarray(tri)[np.asarray(ok)]
    h = params.cam_in_robot
    tri = tri @ h[:3, :3].T + h[:3, 3]
    io.write_vectors(os.path.join(out_dir, "triangulated.txt"), tri)
    if verbose:
        x = np.asarray(x)
        print("R estimated:\n", x[:3, :3])
        print("t estimated:", x[:3, 3])
        print(f"triangulated {len(tri)} points -> triangulated.txt")
    return x, tri


def run_picp_known_real(
    data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None, verbose: bool = True
):
    """PICP alone on real data with known world points and known DA.

    Mirrors ``picp_known_real`` (picp_real_data_allKnown.cpp): world points
    are chained into the previous camera frame each step
    (picp_real_data_allKnown.cpp:76-77), correspondences are
    (meas slot, landmark id), 1000 GN rounds/frame, output
    ``trajectory_est.txt``.
    """
    import jax
    import jax.numpy as jnp

    from .ops import picp, se3

    if config is None:
        config = DEFAULT_CONFIG.replace(gn_iterations=1000)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))

    h_inv = np.linalg.inv(params.cam_in_robot).astype(np.float32)

    @jax.jit
    def track(world, points, masks, ids):
        def body(carry, frame):
            world_prev, x_curr = carry
            # world moved into the previous camera's frame
            world_curr = se3.transform_points(x_curr, world_prev)
            pts, mask, fid = frame
            safe = jnp.where(mask, fid, 0)
            wp = world_curr[safe]
            cam0 = camera.with_pose(jnp.eye(4, dtype=world.dtype))
            solved, _ = picp.solve(
                cam0, wp, pts, mask.astype(world.dtype),
                config.gn_iterations,
                kernel_threshold=config.kernel_threshold,
                damping=config.damping,
                tolerance=config.gn_tolerance,
            )
            pose = solved.world_in_camera
            return (world_curr, pose), pose

        (_, _), poses = jax.lax.scan(
            body, (world, jnp.asarray(h_inv)), (points, masks, ids)
        )
        return poses

    t0 = time.perf_counter()
    poses = np.asarray(
        track(
            jnp.asarray(world_points),
            jnp.asarray(seq.points),
            jnp.asarray(seq.mask),
            jnp.asarray(seq.ids),
        )
    )
    elapsed = time.perf_counter() - t0
    io.save_trajectory(os.path.join(out_dir, "trajectory_est.txt"), poses, params.cam_in_robot)
    if verbose:
        print(f"picp_known_real: {len(poses)} frames in {elapsed:.3f}s")
    return poses


def run_compute_corr(data_dir: str, verbose: bool = True):
    """Appearance-DA vs id-ground-truth-DA comparison on the first two frames.

    Mirrors ``compute_corr`` (compute_corr.cpp:114-118) without its
    hardcoded path: reports how many appearance matches agree with the id
    ground truth.
    """
    import jax.numpy as jnp

    from .models import pipeline as pl_mod
    from .ops import matching

    _, _, seq = _load(data_dir, DEFAULT_CONFIG)
    a = matching.match_appearances(
        jnp.asarray(seq.appearances[0]), jnp.asarray(seq.mask[0]),
        jnp.asarray(seq.appearances[1]), jnp.asarray(seq.mask[1]),
    )
    g = pl_mod.match_by_ids(
        jnp.asarray(seq.ids[0]), jnp.asarray(seq.mask[0]),
        jnp.asarray(seq.ids[1]), jnp.asarray(seq.mask[1]),
    )
    a_set = {
        (int(i), int(j))
        for i, j, v in zip(np.asarray(a.idx1), np.asarray(a.idx2), np.asarray(a.valid))
        if v
    }
    g_set = {
        (int(i), int(j))
        for i, j, v in zip(np.asarray(g.idx1), np.asarray(g.idx2), np.asarray(g.valid))
        if v
    }
    agree = len(a_set & g_set)
    if verbose:
        print(
            f"appearance matches: {len(a_set)}, gt matches: {len(g_set)}, "
            f"agreeing: {agree} ({100.0 * agree / max(len(g_set), 1):.1f}%)"
        )
    return a_set, g_set


def run_vo_se2(
    data_dir: str,
    out_dir: str = ".",
    config: Optional[VOConfig] = None,
    verbose: bool = True,
):
    """Full VO with the estimation constrained to SE(2) in the robot plane.

    The counterpart of the reference's ``est_SE2`` branch
    (README.md:13): identical pipeline to :func:`run_vo_complete`, but the
    per-frame solve uses the 3-DoF planar solver (ops/picp_se2) conjugated
    by the camera mount from ``camera.dat``, and the two-view init is
    planarized. Outputs use the same file contract so ``evaluation`` works
    unchanged.
    """
    params, _, _ = _load(data_dir, DEFAULT_CONFIG)
    if config is None:
        config = DEFAULT_CONFIG
    config = config.with_planar_mount(params.cam_in_robot)
    return run_vo_complete(data_dir, out_dir, config, verbose)


def _print_comparison(x_est: np.ndarray, x_gt: np.ndarray, title: str = ""):
    """Printed pose comparison (initialization_test.cpp:27-40 format)."""
    if title:
        print(title)
    print("R estimated:\n", x_est[:3, :3])
    print("R gt:\n", x_gt[:3, :3])
    ratio = x_est[:3, 3] / x_gt[:3, 3]
    print("t ratio:", ", ".join(f"{r:g}" for r in ratio))


def run_init_synthetic(seed: int = 0, num_points: int = 1000, verbose: bool = True):
    """Synthetic epipolar-initialization check (initialization_test.cpp:41-89).

    Random pose + ``num_points`` world points, projected by two cameras with
    identity correspondences; runs the 8-point estimator and prints the R
    comparison and the per-axis t ratio (constant ratio = correct direction;
    monocular scale is unobservable).
    """
    import jax.numpy as jnp

    from .ops import epipolar

    rng = np.random.default_rng(seed)
    world, w1, w2, p1, p2, corr_valid, x_gt = synthetic_mod.two_view_scene(rng, num_points)
    cam = synthetic_mod.default_camera()
    idx = jnp.arange(num_points, dtype=jnp.int32)
    x = np.asarray(
        epipolar.estimate_transform(
            cam.camera_matrix,
            idx,
            idx,
            jnp.asarray(corr_valid),
            jnp.asarray(p1),
            jnp.asarray(p2),
            jnp.asarray(corr_valid),
            jnp.asarray(corr_valid),
        )
    )
    if verbose:
        _print_comparison(x, x_gt, "epipolar init")
    return x, x_gt


def run_picp_synthetic(
    seed: int = 0, num_points: int = 1000, iterations: int = 1000, verbose: bool = True
):
    """Synthetic PICP-only check (picp_solver_test.cpp:42-79).

    Known world points, measurements projected under a random ground-truth
    pose, solver started at identity with kernel threshold 10000 and the
    reference's 1000 rounds; prints estimated vs ground-truth pose.
    """
    import jax.numpy as jnp

    from .ops import picp
    from .ops.camera import project_points

    rng = np.random.default_rng(seed)
    x_gt = synthetic_mod.generate_pose(rng)
    world = synthetic_mod.generate_points3d(rng, num_points)
    cam_ref = synthetic_mod.default_camera()
    cam_cur = synthetic_mod.default_camera(x_gt)
    p_ref, v_ref = project_points(cam_ref, jnp.asarray(world))
    p_cur, v_cur = project_points(cam_cur, jnp.asarray(world))
    weights = (v_ref & v_cur).astype(jnp.float32)

    cam0 = synthetic_mod.default_camera(np.eye(4, dtype=np.float32))
    solved, stats = picp.solve(
        cam0, jnp.asarray(world), p_cur, weights, iterations, kernel_threshold=10000.0
    )
    x_est = np.asarray(solved.world_in_camera)
    if verbose:
        _print_comparison(x_est, x_gt, "PICP solver")
        print(f"inliers: {int(stats.num_inliers)}  chi inliers: {float(stats.chi_inliers):g}")
    return x_est, x_gt


def run_whole_synthetic(seed: int = 0, num_points: int = 1000, verbose: bool = True):
    """Composed synthetic pipeline check (essential_picp_test.cpp:45-106).

    Three synthetic views: epipolar init between views 0-1, triangulation,
    PICP against view 2; the PICP stage's ground truth is the scale-free
    relative pose ``X_gt2 · X_gt1⁻¹``.
    """
    import jax.numpy as jnp

    from .ops import epipolar, picp, se3, triangulation
    from .ops.camera import project_points

    rng = np.random.default_rng(seed)
    world = jnp.asarray(synthetic_mod.generate_points3d(rng, num_points))
    w1 = synthetic_mod.generate_pose(rng)
    w2 = synthetic_mod.generate_pose(rng)
    w3 = synthetic_mod.generate_pose(rng)
    cam = synthetic_mod.default_camera()
    p1, v1 = project_points(synthetic_mod.default_camera(w1), world)
    p2, v2 = project_points(synthetic_mod.default_camera(w2), world)
    p3, v3 = project_points(synthetic_mod.default_camera(w3), world)
    idx = jnp.arange(num_points, dtype=jnp.int32)
    corr12 = v1 & v2

    x12 = epipolar.estimate_transform(cam.camera_matrix, idx, idx, corr12, p1, p2, v1, v2)
    x12_gt = (w2 @ np.linalg.inv(w1)).astype(np.float32)
    if verbose:
        _print_comparison(np.asarray(x12), x12_gt, "init (view 1 in view 2)")

    tri, ok = triangulation.triangulate_correspondences(
        cam.camera_matrix, x12, idx, idx, corr12, p1, p2
    )
    tri_in_2 = se3.transform_points(x12, tri)
    weights = (ok & v3).astype(jnp.float32)
    cam0 = synthetic_mod.default_camera(np.eye(4, dtype=np.float32))
    solved, stats = picp.solve(cam0, tri_in_2, p3, weights, 1000, kernel_threshold=10000.0)
    x23_est = np.asarray(solved.world_in_camera)
    x23_gt = (w3 @ np.linalg.inv(w2)).astype(np.float32)
    if verbose:
        print(f"triangulated in front: {int(ok.sum())}")
        _print_comparison(x23_est, x23_gt, "PICP (view 2 in view 3)")
        print(f"inliers: {int(stats.num_inliers)}")
    return x23_est, x23_gt


def run_kdtree_test(seed: int = 0, num_points: int = 500, verbose: bool = True):
    """Exact-vs-approximate matcher cross-check (eigen_kdtree_test.cpp:42-67).

    Builds the batched PCA-split tree over random points and compares the
    one-sided ``best_match_fast`` against the exact dense search per query,
    printing the FAST Correct / Not Correct tally the reference prints
    per line.
    """
    import jax.numpy as jnp

    from .ops import matching, pca_tree

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10.0, 10.0, (num_points, 3)).astype(np.float32)
    queries = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    mask = jnp.ones(num_points, bool)
    db = jnp.asarray(pts)
    q = jnp.asarray(queries)

    levels = max(1, int(np.log2(max(num_points / 10.0, 2.0))))
    tree = pca_tree.build_tree(db, mask, levels=levels)
    idx_fast, found_fast = pca_tree.best_match_fast(tree, db, q, mask, radius=0.5)

    d = np.asarray(matching.pairwise_sq_dists(q, db))
    exact_idx = d.argmin(1)
    exact_found = d.min(1) < 0.5**2
    fast_idx = np.asarray(idx_fast)
    fast_found = np.asarray(found_fast)
    correct = (fast_found == exact_found) & (~exact_found | (fast_idx == exact_idx))
    if verbose:
        print(
            f"FAST Correct: {int(correct.sum())}/{num_points} "
            f"(exact matches: {int(exact_found.sum())}, tree depth {levels})"
        )
        for i in np.where(~correct)[0][:10]:
            print(
                f"FAST Not Correct: query {i}: fast="
                f"{fast_idx[i] if fast_found[i] else 'NONE'} "
                f"full={exact_idx[i] if exact_found[i] else 'NONE'}"
            )
    return correct


def run_read_data_test(data_dir: str):
    """Dataset-reader smoke test (read_data_test.cpp)."""
    params, camera, seq = _load(data_dir, DEFAULT_CONFIG)
    _, world_points, world_apps = io.load_world(os.path.join(data_dir, "world.dat"))
    print(f"frames: {len(seq.counts)}, meas per frame min/max: "
          f"{seq.counts.min()}/{seq.counts.max()}")
    print(f"world landmarks: {len(world_points)}")
    print("camera matrix:\n", params.camera_matrix)
    print("cam_in_robot:\n", params.cam_in_robot)
    print(f"z_near={params.z_near} z_far={params.z_far} "
          f"width={params.width} height={params.height}")
    return params, seq


_SYNTHETIC_CMDS = {
    "init": run_init_synthetic,
    "picp_test": run_picp_synthetic,
    "whole_test": run_whole_synthetic,
    "kdtree_test": run_kdtree_test,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd in _SYNTHETIC_CMDS:
        seed = int(argv[1]) if len(argv) > 1 else 0
        _SYNTHETIC_CMDS[cmd](seed=seed)
        return 0
    if len(argv) < 2:
        print(__doc__)
        return 1
    data_dir = argv[1]
    out_dir = argv[2] if len(argv) > 2 else "."
    if cmd == "vo_complete":
        run_vo_complete(data_dir, out_dir)
    elif cmd == "vo_se2":
        run_vo_se2(data_dir, out_dir)
    elif cmd == "evaluation":
        run_evaluation(data_dir, out_dir)
    elif cmd == "vo_daknown":
        run_vo_da_known(data_dir, out_dir)
    elif cmd == "real_init":
        run_real_init(data_dir, out_dir)
    elif cmd == "picp_known_real":
        run_picp_known_real(data_dir, out_dir)
    elif cmd == "relocalize":
        run_relocalize(data_dir, out_dir)
    elif cmd == "compute_corr":
        run_compute_corr(data_dir)
    elif cmd == "read_data_test":
        run_read_data_test(data_dir)
    elif cmd == "plot":
        from .utils import plots

        for p in plots.plot_all(out_dir if len(argv) > 2 else data_dir):
            print(f"wrote {p}")
    else:
        print(f"unknown command {cmd!r}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
