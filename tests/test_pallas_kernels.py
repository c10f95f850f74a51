"""The frame-loop Pallas kernel (ops/pallas/frame_kernel) against its plain
references: the ``lax.scan`` over ``pipeline.frame_step``, ``ops.picp``,
``ops.picp_se2`` and ``ops.triangulation``.

On the CPU the kernel runs through the Pallas interpreter
(``scan_backend="fused_interpret"``) and its in-kernel math runs as plain
JAX; the ``gpu``-marked test compiles it for the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visual_odometry_tpu.models import pipeline
from visual_odometry_tpu.ops import picp, picp_se2, se3, triangulation
from visual_odometry_tpu.ops.camera import project_points
from visual_odometry_tpu.ops.pallas import frame_kernel
from visual_odometry_tpu.utils import synthetic
from visual_odometry_tpu.utils.config import VOConfig

MOUNT = np.array(
    [[0, 0, 1, 0.2], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32
)


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(0)
    p, a, m = synthetic.generate_tracking_sequence(rng, 12, 64)
    return synthetic.deep_camera(), jnp.asarray(p), jnp.asarray(a), jnp.asarray(m)


def _rows(pose):
    return tuple(jnp.float32(x) for x in np.asarray(pose, np.float32)[:3, :4].reshape(12))


def _cam_scalars(cam):
    k = tuple(jnp.float32(x) for x in np.asarray(cam.camera_matrix).reshape(9))
    return k, (cam.z_near, cam.z_far, cam.cols, cam.rows)


def _pose(rows):
    return np.vstack([np.asarray(jnp.stack(rows)).reshape(3, 4), [0, 0, 0, 1]])


@pytest.mark.parametrize("planar", [False, True])
def test_kernel_matches_scan(sequence, planar):
    """The whole frame loop through the interpreter == the scan backend on a
    real trajectory (two different f32 programs: trajectory within 2e-3,
    identical correspondence and map counts)."""
    cam, p, a, m = sequence
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=20)
    if planar:
        cfg = cfg.replace(planar=True)
    tf, mf, of = pipeline.run_sequence(
        cam, cfg.replace(scan_backend="fused_interpret"), p, a, m
    )
    tx, mx, ox = pipeline.run_sequence(cam, cfg.replace(scan_backend="xla"), p, a, m)
    np.testing.assert_allclose(np.asarray(tf), np.asarray(tx), atol=2e-3)
    np.testing.assert_array_equal(
        np.asarray(of.num_solver_corr), np.asarray(ox.num_solver_corr)
    )
    np.testing.assert_array_equal(np.asarray(of.num_inliers), np.asarray(ox.num_inliers))
    assert int(mf.valid.sum()) == int(mx.valid.sum())
    assert int(np.asarray(of.join_overflow).sum()) == 0


def test_slot_padding_to_power_of_two(sequence):
    """n_slots that is no power of two: the wrapper pads the lanes to one
    (Triton's block sizes) and slices them off; results match the scan."""
    cam, p, a, m = sequence
    s = 48
    cfg = VOConfig(n_slots=s, map_capacity=256, gn_iterations=20)
    args = (p[:, :s], a[:, :s], m[:, :s])
    tf, _, of = pipeline.run_sequence(cam, cfg.replace(scan_backend="fused_interpret"), *args)
    tx, _, ox = pipeline.run_sequence(cam, cfg.replace(scan_backend="xla"), *args)
    assert of.tri_points.shape == (10, s, 3) and of.tri_valid.shape == (10, s)
    np.testing.assert_allclose(np.asarray(tf), np.asarray(tx), atol=2e-3)
    np.testing.assert_array_equal(
        np.asarray(of.tri_valid), np.asarray(ox.tri_valid)
    )


def _kernel_args(cam, cfg, pp, aa, mm):
    """The frame-loop kernel's inputs for one sequence, built the way
    pipeline._track builds them."""
    ids = jnp.full(mm.shape, -1, jnp.int32)
    f0 = pipeline.FrameData(pp[0], aa[0], mm[0], ids[0])
    f1 = pipeline.FrameData(pp[1], aa[1], mm[1], ids[1])
    corr01 = pipeline._match(cfg, False, f0, f1)
    state, _ = pipeline.initialize(cam, cfg, f0, f1, corr=corr01)
    rest = pipeline.FrameData(pp[2:], aa[2:], mm[2:], ids[2:])
    prev = pipeline.FrameData(pp[1:-1], aa[1:-1], mm[1:-1], ids[1:-1])
    corr = pipeline._batched_match(cfg, False, rest, prev)
    cand = frame_kernel.join_candidates(
        jnp.concatenate([corr01.idx2[None], corr.idx2[:-1]]),
        jnp.concatenate([corr01.valid[None], corr.valid[:-1]]),
        corr.idx1, corr.valid, cfg.fused_join_depth,
    )
    w0 = frame_kernel.first_valid_join(
        state.tri_points, state.tri_valid, cand.idx[0], cand.ok[0]
    )
    safe1 = jnp.where(corr.valid, corr.idx1, 0)[..., None]
    safe2 = jnp.where(corr.valid, corr.idx2, 0)[..., None]
    return (
        state.x_curr, w0[0], w0[1], jax.tree.map(lambda x: x[1:], cand),
        jnp.take_along_axis(prev.points, safe1, axis=1),
        jnp.take_along_axis(rest.points, safe2, axis=1), corr.valid,
    )


@pytest.mark.parametrize("n_frames", [1, 2, 7])
def test_track_frames_batched_equals_single(sequence, n_frames):
    """vmap of the wrapper runs one program per sequence: each batch entry
    equals its single-sequence call, for any frame count (to the last ulp
    or so: the interpreter's batched evaluation fuses differently; the
    compiled kernel runs the same program per block)."""
    cam, p, a, m = sequence
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=20)
    n = n_frames + 2
    xs = [(p[:n], a[:n], m[:n]), (p[2:n + 2], a[2:n + 2], m[2:n + 2])]
    args = [jax.jit(lambda *x: _kernel_args(cam, cfg, *x))(*x) for x in xs]
    cam_params = jnp.stack([cam.z_near, cam.z_far, cam.cols, cam.rows])

    def run(*kargs):
        return frame_kernel.track_frames(
            cam.camera_matrix, cam_params, *kargs, 20, 1e4, 1.0, 1e-12,
            interpret=True,
        )

    singles = [jax.jit(run)(*x) for x in args]
    batched = jax.jit(jax.vmap(run))(*jax.tree.map(lambda *t: jnp.stack(t), *args))
    assert batched[0].shape == (2, n_frames, 4, 4)
    assert batched[1].shape == (2, n_frames, 64, 3)
    for b, single in enumerate(singles):
        for got, want in zip(batched, single):
            np.testing.assert_allclose(
                np.asarray(got[b]), np.asarray(want), rtol=2e-5, atol=2e-5
            )


def _brute_candidates(src_idx2, src_valid, dst_idx1, dst_valid, depth):
    s = src_idx2.shape[0]
    idx = np.zeros((depth, s), np.int32)
    ok = np.zeros((depth, s), bool)
    over = np.zeros(s, bool)
    for j in range(s):
        if not dst_valid[j]:
            continue
        hits = [i for i in range(s) if src_valid[i] and src_idx2[i] == dst_idx1[j]]
        for d, i in enumerate(hits[:depth]):
            idx[d, j], ok[d, j] = i, True
        over[j] = len(hits) > depth
    return idx, ok, over


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_join_candidates_match_bruteforce(rng, depth):
    """The segment-min chains == the first-wins scan of vo_complete.cpp:55-63
    (d-th smallest matching source lane), overflow flags included."""
    f, s = 3, 40
    src_idx2 = rng.integers(0, 12, (f, s)).astype(np.int32)  # many duplicates
    dst_idx1 = rng.integers(0, 14, (f, s)).astype(np.int32)
    src_valid = rng.uniform(size=(f, s)) > 0.3
    dst_valid = rng.uniform(size=(f, s)) > 0.2
    got = frame_kernel.join_candidates(
        jnp.asarray(src_idx2), jnp.asarray(src_valid),
        jnp.asarray(dst_idx1), jnp.asarray(dst_valid), depth,
    )
    assert got.idx.shape == (f, depth, s)
    for i in range(f):
        idx, ok, over = _brute_candidates(
            src_idx2[i], src_valid[i], dst_idx1[i], dst_valid[i], depth
        )
        np.testing.assert_array_equal(np.asarray(got.ok[i]), ok)
        np.testing.assert_array_equal(np.asarray(got.idx[i]), idx)
        np.testing.assert_array_equal(np.asarray(got.overflow[i]), over)


def test_first_valid_join_skips_failed_triangulations():
    tri = jnp.arange(18, dtype=jnp.float32).reshape(6, 3)
    tri_ok = jnp.asarray([True, False, True, True, False, True])
    idx = jnp.asarray([[1, 0, 4, 3], [2, 5, 0, 1]], jnp.int32)
    ok = jnp.asarray([[True, True, True, False], [True, True, False, True]])
    pts, have = frame_kernel.first_valid_join(tri, tri_ok, idx, ok)
    # lane 0: cand 1 failed -> cand 2; lane 1: cand 0; lane 2: 4 failed and
    # no second; lane 3: first absent, second (1) failed.
    np.testing.assert_array_equal(np.asarray(have), [True, True, False, False])
    np.testing.assert_array_equal(np.asarray(pts[:2]), np.asarray(tri[jnp.asarray([2, 0])]))


def test_kernel_triangulation_matches_ops(rng):
    """In-kernel mid-point triangulation == ops.triangulation on lanes."""
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32))
    x = synthetic.generate_pose(rng)
    world = synthetic.generate_points3d(rng, 64)
    p1, v1 = project_points(cam0, jnp.asarray(world))
    p2, v2 = project_points(synthetic.default_camera(x), jnp.asarray(world))
    slots = jnp.arange(64, dtype=jnp.int32)
    valid = v1 & v2
    ref, ref_ok = triangulation.triangulate_correspondences(
        cam0.camera_matrix, jnp.asarray(x), slots, slots, valid, p1, p2
    )
    ik = tuple(jnp.float32(v) for v in np.linalg.inv(np.asarray(cam0.camera_matrix)).reshape(9))
    tx, ty, tz, ok = frame_kernel._triangulate(
        _rows(x), ik, p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1], valid
    )
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ref_ok))
    got = np.stack([tx, ty, tz], -1)[np.asarray(ok)]
    np.testing.assert_allclose(got, np.asarray(ref)[np.asarray(ok)], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tol", [0.0, 1e-12])
def test_kernel_gn_matches_picp_solve(rng, tol):
    """The in-kernel SE(3) Gauss-Newton loop == ops.picp.solve, both the
    fixed budget and the early exit."""
    world = synthetic.generate_points3d(rng, 160)
    x_gt = synthetic.generate_pose(rng)
    cam = synthetic.default_camera(np.eye(4, dtype=np.float32))
    meas, v = project_points(synthetic.default_camera(x_gt), jnp.asarray(world))
    w = v.astype(jnp.float32)
    solved, st = picp.solve(cam, jnp.asarray(world), meas, w, 50,
                            kernel_threshold=10000.0, tolerance=tol)
    k, (zn, zf, cols, rows) = _cam_scalars(cam)
    wj = jnp.asarray(world)
    out = frame_kernel._gn_se3(
        50, 1, k, _rows(np.eye(4)), wj[:, 0], wj[:, 1], wj[:, 2],
        meas[:, 0], meas[:, 1], w, zn, zf, cols, rows,
        jnp.float32(1e4), jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(tol if tol > 0 else -1.0), jnp.float32(0.0),
    )
    np.testing.assert_allclose(_pose(out[:12]), np.asarray(solved.world_in_camera), atol=5e-5)
    assert int(out[14]) == int(st.num_inliers)


def test_kernel_gn_se2_matches_solve_se2(rng):
    """The in-kernel planar loop == ops.picp_se2.solve_se2 (est_SE2)."""
    world = synthetic.generate_points3d(rng, 160)
    c = MOUNT
    dx = np.asarray(se3.v2t_euler(jnp.float32([0.05, -0.03, 0.0, 0.0, 0.0, 0.02])))
    x_gt = np.linalg.inv(c) @ np.asarray(se3.project_se2(jnp.asarray(dx))) @ c
    cam = synthetic.default_camera(np.eye(4, dtype=np.float32))
    meas, v = project_points(synthetic.default_camera(x_gt), jnp.asarray(world))
    w = v.astype(jnp.float32)
    solved, st = picp_se2.solve_se2(
        cam, jnp.asarray(world), meas, w, 30, kernel_threshold=10000.0,
        tolerance=1e-12, cam_in_robot=c,
    )
    k, (zn, zf, cols, rows) = _cam_scalars(cam)
    wj = jnp.asarray(world)
    out = frame_kernel._gn_se2(
        30, 1, k, _rows(c), _rows(np.linalg.inv(c)), _rows(np.eye(4)),
        wj[:, 0], wj[:, 1], wj[:, 2], meas[:, 0], meas[:, 1], w,
        zn, zf, cols, rows, jnp.float32(1e4), jnp.float32(0.0),
        jnp.float32(1.0), jnp.float32(1e-12), jnp.float32(0.0),
    )
    np.testing.assert_allclose(_pose(out[:12]), np.asarray(solved.world_in_camera), atol=5e-5)
    assert int(out[14]) == int(st.num_inliers)


@pytest.mark.parametrize("s", [16, 100, 128])
def test_kernel_lowers_for_triton(s):
    """The kernel lowers to Triton IR for a CUDA target (what the card
    compiles), one program per sequence under vmap, with lanes padded to a
    power of two. Lowering needs no GPU; compiling it does."""
    cfg = VOConfig(n_slots=s, scan_backend="fused")
    f = 6
    p = jnp.zeros((3, f, s, 2))
    a = jnp.zeros((3, f, s, 10))
    m = jnp.zeros((3, f, s), bool)
    ids = jnp.full((f, s), -1, jnp.int32)
    cam = synthetic.deep_camera()

    def run(pp, aa, mm):
        return pipeline._run(cam, cfg, pp, aa, mm, ids, False)

    text = (
        jax.jit(jax.vmap(run)).trace(p, a, m)
        .lower(lowering_platforms=("cuda",)).as_text()
    )
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "grid_x = 3 " in text and "num_warps = 4 " in text


@pytest.mark.gpu
def test_compiled_kernel_matches_scan_on_gpu(gpu, sequence):
    """The kernel compiled for the card == the scan backend (same bounds as
    the interpreter test). Runs with JAX_PLATFORMS=cuda on a GPU."""
    cam, p, a, m = sequence
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=20)
    tf, _, of = pipeline.run_sequence(cam, cfg.replace(scan_backend="fused"), p, a, m)
    tx, _, ox = pipeline.run_sequence(cam, cfg.replace(scan_backend="xla"), p, a, m)
    np.testing.assert_allclose(np.asarray(tf), np.asarray(tx), atol=2e-3)
    np.testing.assert_array_equal(
        np.asarray(of.num_solver_corr), np.asarray(ox.num_solver_corr)
    )
