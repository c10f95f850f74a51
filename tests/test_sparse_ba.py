"""Sparse (COO + matrix-free Schur-CG) bundle adjustment.

Covers: equality with the dense Schur path on small problems, the
device-side COO observation join vs the dense-grid host join, convergence
at an observation multiplicity the dense path cannot represent densely,
lm-sharded == single-device, and the gauge clamp.
"""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visual_odometry_tpu.models import refinement
from visual_odometry_tpu.parallel import bundle_adjustment as ba
from visual_odometry_tpu.parallel import sparse_ba as sba
from visual_odometry_tpu.ops import se3
from visual_odometry_tpu.ops.camera import project_points
from visual_odometry_tpu.utils import synthetic


def _make_scene(rng, f=4, l=64, noise_pose=0.05, noise_lm=0.05):
    world = np.stack(
        [
            rng.uniform(-1.5, 1.5, l),
            rng.uniform(-1.2, 1.2, l),
            rng.uniform(2.0, 4.0, l),
        ],
        axis=1,
    ).astype(np.float32)
    gt_poses = []
    for i in range(f):
        v = np.float32([0.05 * i, -0.02 * i, 0.08 * i, 0.01 * i, -0.015 * i, 0.01 * i])
        gt_poses.append(np.array(se3.v2t_euler(jnp.asarray(v))))
    gt_poses = np.stack(gt_poses)

    cam = synthetic.default_camera()
    obs = np.zeros((f, l, 2), np.float32)
    mask = np.zeros((f, l), bool)
    for i in range(f):
        uv, valid = project_points(
            synthetic.default_camera(gt_poses[i]), jnp.asarray(world)
        )
        obs[i] = np.array(uv)
        mask[i] = np.array(valid)

    poses0 = gt_poses.copy()
    landmarks0 = world.copy()
    for i in range(1, f):
        dv = rng.uniform(-noise_pose, noise_pose, 6).astype(np.float32)
        poses0[i] = np.array(se3.v2t_euler(jnp.asarray(dv))) @ poses0[i]
    landmarks0 = landmarks0 + rng.uniform(-noise_lm, noise_lm, (l, 3)).astype(
        np.float32
    )
    return cam, poses0, landmarks0, obs, mask, gt_poses, world


def _coo_from_grid(obs, mask):
    """Flatten a dense (F, L) observation grid to the COO layout."""
    f, l = mask.shape
    fi, li = np.nonzero(mask)
    return (
        jnp.asarray(fi.astype(np.int32)),
        jnp.asarray(li.astype(np.int32)),
        jnp.asarray(obs[fi, li]),
        jnp.ones((len(fi),), bool),
    )


def _problems(rng, **kw):
    cam, poses0, lms0, obs, mask, gt_poses, world = _make_scene(rng, **kw)
    dense = ba.BAProblem(
        poses=jnp.asarray(poses0),
        landmarks=jnp.asarray(lms0),
        observations=jnp.asarray(obs),
        obs_mask=jnp.asarray(mask),
    )
    fi, li, uv, m = _coo_from_grid(obs, mask)
    sparse = sba.SparseBAProblem(
        poses=jnp.asarray(poses0),
        landmarks=jnp.asarray(lms0),
        frame_idx=fi,
        lm_idx=li,
        uv=uv,
        obs_mask=m,
    )
    return cam, dense, sparse, gt_poses, world


def test_step_matches_dense(rng):
    """One sparse step == one dense step (the CG solve vs the dense Cholesky
    solve of the SAME reduced system; tight CG tolerance)."""
    cam, dense, sparse, *_ = _problems(rng)
    d_out, d_stats = ba.ba_step(cam.camera_matrix, dense, damping=0.1)
    s_out, s_stats = sba.sparse_ba_step(
        cam.camera_matrix, sparse, damping=0.1, cg_iterations=200,
        cg_tolerance=1e-10,
    )
    assert int(d_stats.num_obs) == int(s_stats.num_obs)
    np.testing.assert_allclose(
        np.asarray(d_stats.chi), np.asarray(s_stats.chi), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(d_out.poses), np.asarray(s_out.poses), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(d_out.landmarks), np.asarray(s_out.landmarks), atol=5e-4
    )


def test_refine_reduces_chi_and_recovers_scene(rng):
    cam, _, sparse, gt_poses, world = _problems(rng)
    refined, stats = sba.refine_sparse(
        cam.camera_matrix, sparse, num_iterations=15, damping=0.1
    )
    np.testing.assert_allclose(np.asarray(refined.poses), gt_poses, atol=2e-3)
    np.testing.assert_allclose(np.asarray(refined.landmarks), world, atol=2e-2)
    assert float(stats.cg_residual) < 1e-3


def test_gauge_fixed(rng):
    cam, _, sparse, *_ = _problems(rng)
    p0 = np.asarray(sparse.poses[0])
    refined, _ = sba.refine_sparse(
        cam.camera_matrix, sparse, num_iterations=5, damping=0.1
    )
    np.testing.assert_allclose(np.asarray(refined.poses[0]), p0, atol=1e-6)


def test_duplicate_observations_supported(rng):
    """Two observations of the same (frame, landmark) pair — representable
    in COO, impossible on the dense grid — still converge (the matrix-free
    operator never assumes one obs per pair)."""
    cam, _, sparse, gt_poses, world = _problems(rng)
    dup = sba.SparseBAProblem(
        poses=sparse.poses,
        landmarks=sparse.landmarks,
        frame_idx=jnp.concatenate([sparse.frame_idx, sparse.frame_idx[:8]]),
        lm_idx=jnp.concatenate([sparse.lm_idx, sparse.lm_idx[:8]]),
        uv=jnp.concatenate([sparse.uv, sparse.uv[:8]]),
        obs_mask=jnp.concatenate([sparse.obs_mask, sparse.obs_mask[:8]]),
    )
    refined, _ = sba.refine_sparse(
        cam.camera_matrix, dup, num_iterations=15, damping=0.1
    )
    np.testing.assert_allclose(np.asarray(refined.poses), gt_poses, atol=2e-3)


# Runs in a FRESH interpreter via the _fresh_process wrapper below when
# collected as part of a long suite: compiling the 8-device sharded
# sparse-BA program after ~30 min of accumulated XLA:CPU compilations in
# one process segfaults inside backend_compile_and_load (observed
# repeatedly at exactly this test in full-suite runs on a 2-vCPU host;
# it passes every time in isolation) — a state-dependent XLA:CPU compiler
# issue, not a framework one. The inner test stays directly runnable with
# VO_SUBPROC_TEST=1.
@pytest.mark.skipif(
    os.environ.get("VO_SUBPROC_TEST") != "1",
    reason="executed via test_sharded_matches_single_device_fresh_process",
)
@pytest.mark.parametrize("n_lm", [4, 8])
def test_sharded_matches_single_device(rng, n_lm):
    if len(jax.devices()) < n_lm:
        pytest.skip("needs 8 virtual devices")
    from jax.sharding import Mesh

    cam, _, sparse, *_ = _problems(rng, f=3, l=64)
    single, s_single = sba.sparse_ba_step(
        cam.camera_matrix, sparse, damping=0.1, cg_iterations=200,
        cg_tolerance=1e-10,
    )

    fi, li, uv, mask, l_per = sba.partition_observations(
        n_lm, 64, np.asarray(sparse.frame_idx), np.asarray(sparse.lm_idx),
        np.asarray(sparse.uv), np.asarray(sparse.obs_mask),
    )
    lms = np.zeros((n_lm * l_per, 3), np.float32)
    lms[:64] = np.asarray(sparse.landmarks)
    sharded_problem = sba.SparseBAProblem(
        poses=sparse.poses,
        landmarks=jnp.asarray(lms),
        frame_idx=jnp.asarray(fi),
        lm_idx=jnp.asarray(li),
        uv=jnp.asarray(uv),
        obs_mask=jnp.asarray(mask),
    )
    mesh = Mesh(np.array(jax.devices()[:n_lm]), ("lm",))
    step = sba.make_sharded_sparse_ba_step(
        mesh, damping=0.1, cg_iterations=200, cg_tolerance=1e-10
    )
    out, s_shard = step(cam.camera_matrix, sharded_problem)
    assert int(s_single.num_obs) == int(s_shard.num_obs)
    np.testing.assert_allclose(
        np.asarray(single.poses), np.asarray(out.poses), atol=5e-5
    )
    # Un-shard the landmark layout back to global ids for comparison.
    np.testing.assert_allclose(
        np.asarray(single.landmarks), np.asarray(out.landmarks)[:64], atol=5e-4
    )


def test_sharded_matches_single_device_fresh_process():
    """Run the sharded-vs-single equality test in a fresh interpreter
    (see the skipif note on the inner test)."""
    import subprocess
    import sys

    env = {**os.environ, "VO_SUBPROC_TEST": "1"}
    r = subprocess.run(
        [
            sys.executable, "-m", "pytest", "-q", "-x",
            f"{__file__}::test_sharded_matches_single_device",
        ],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-1000:])


def test_coo_join_matches_dense_join(rng):
    """build_observations_coo == the host-loop dense grid join."""
    f, s, l, d = 6, 32, 40, 10
    map_apps = synthetic.generate_appearances(rng, l)
    pts = rng.uniform(0, 600, (f, s, 2)).astype(np.float32)
    # The host join assumes compacted (prefix) masks; match that.
    counts = rng.integers(s // 2, s + 1, f)
    mask = np.arange(s)[None, :] < counts[:, None]
    apps = np.zeros((f, s, d), np.float32)
    which = rng.integers(0, l + 5, (f, s))  # some measurements match no landmark
    extra = synthetic.generate_appearances(rng, 5)
    allapps = np.concatenate([map_apps, extra])
    for i in range(f):
        apps[i] = allapps[which[i]]

    obs_d, mask_d = refinement.build_observations(pts, apps, mask, map_apps)
    fi, li, uv, m = refinement.build_observations_coo(
        jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask),
        jnp.asarray(map_apps),
    )
    fi, li, uv, m = (np.asarray(x) for x in (fi, li, uv, m))

    got = np.zeros_like(obs_d)
    gmask = np.zeros_like(mask_d)
    for n in np.nonzero(m)[0]:
        got[fi[n], li[n]] = uv[n]
        gmask[fi[n], li[n]] = True
    # The dense host join keeps the LAST in-frame slot for a duplicate key;
    # generate_appearances keys are unique and `which` may repeat a
    # landmark within a frame, in which case both joins agree on membership
    # but may pick different slots — compare membership everywhere and
    # positions where the frame observes the landmark exactly once.
    np.testing.assert_array_equal(gmask, mask_d)
    for i in range(f):
        ids = which[i][mask[i]]
        uniq = [j for j in range(l) if (ids == j).sum() == 1]
        np.testing.assert_allclose(got[i, uniq], obs_d[i, uniq])


def test_build_observations_coo_mask_only_live(rng):
    """Dead measurement slots and unknown appearances never join."""
    f, s, l = 3, 16, 16
    map_apps = synthetic.generate_appearances(rng, l)
    apps = np.tile(map_apps[:s][None], (f, 1, 1)).astype(np.float32)
    pts = rng.uniform(0, 100, (f, s, 2)).astype(np.float32)
    mask = np.ones((f, s), bool)
    mask[:, s // 2:] = False
    _, li, _, m = refinement.build_observations_coo(
        jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask),
        jnp.asarray(map_apps),
    )
    m = np.asarray(m).reshape(f, s)
    assert m[:, : s // 2].all()
    assert not m[:, s // 2:].any()


def test_vo_complete_with_sparse_refinement(tmp_path, reference_data_dir):
    """End-to-end: refine_backend="sparse" improves on tracking alone on
    the reference-shaped dataset like the dense path does (the COO join +
    Schur-CG path as a drop-in production refinement)."""
    from visual_odometry_tpu import apps
    from visual_odometry_tpu.utils.config import VOConfig

    cfg = VOConfig(refine_iterations=10, refine_backend="sparse")
    apps.run_vo_complete(reference_data_dir, str(tmp_path), cfg, verbose=False)
    res = apps.run_evaluation(reference_data_dir, str(tmp_path), verbose=False)
    assert res.rmse_position < 0.039   # measured 0.0338 (tracking alone 0.0439)
    assert res.rmse_map is not None and res.rmse_map < 0.028  # measured 0.0239


def test_packed_refinement_matches_unpacked(rng):
    """pack=True (fixed-degree lm-major layout, scatter-free LM stages)
    converges to the same solution as the raw COO path."""
    cam, _, sparse, *_ = _problems(rng)
    out_p, _ = sba.refine_sparse(
        cam.camera_matrix, sparse, num_iterations=8, damping=0.1, pack=True
    )
    out_u, _ = sba.refine_sparse(
        cam.camera_matrix, sparse, num_iterations=8, damping=0.1, pack=False
    )
    np.testing.assert_allclose(
        np.asarray(out_p.poses), np.asarray(out_u.poses), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(out_p.landmarks), np.asarray(out_u.landmarks), atol=1e-3
    )
    # The caller's observation layout is preserved.
    np.testing.assert_array_equal(
        np.asarray(out_p.frame_idx), np.asarray(sparse.frame_idx)
    )


@pytest.mark.parametrize("n_lm", [4])
def test_sharded_packed_matches_single_device(rng, n_lm):
    """The per-shard fixed-degree packed layout
    (partition_observations_packed + lm_degree) must reproduce the
    single-device step — the scatter-free form every shard runs."""
    if len(jax.devices()) < n_lm:
        pytest.skip("needs virtual devices")
    from jax.sharding import Mesh

    cam, _, sparse, *_ = _problems(rng, f=3, l=64)
    single, s_single = sba.sparse_ba_step(
        cam.camera_matrix, sparse, damping=0.1, cg_iterations=200,
        cg_tolerance=1e-10,
    )

    fi, li, uv, mask, l_per, degree = sba.partition_observations_packed(
        n_lm, 64, np.asarray(sparse.frame_idx), np.asarray(sparse.lm_idx),
        np.asarray(sparse.uv), np.asarray(sparse.obs_mask),
    )
    lms = np.zeros((n_lm * l_per, 3), np.float32)
    lms[:64] = np.asarray(sparse.landmarks)
    sharded_problem = sba.SparseBAProblem(
        poses=sparse.poses,
        landmarks=jnp.asarray(lms),
        frame_idx=jnp.asarray(fi),
        lm_idx=jnp.asarray(li),
        uv=jnp.asarray(uv),
        obs_mask=jnp.asarray(mask),
    )
    mesh = Mesh(np.array(jax.devices()[:n_lm]), ("lm",))
    step = sba.make_sharded_sparse_ba_step(
        mesh, damping=0.1, cg_iterations=200, cg_tolerance=1e-10,
        lm_degree=degree,
    )
    out, s_shard = step(cam.camera_matrix, sharded_problem)
    assert int(s_single.num_obs) == int(s_shard.num_obs)
    np.testing.assert_allclose(
        np.asarray(single.poses), np.asarray(out.poses), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(single.landmarks), np.asarray(out.landmarks)[:64], atol=5e-4
    )
