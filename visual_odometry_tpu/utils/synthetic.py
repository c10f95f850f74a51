"""Synthetic scene generation — the test backend of the framework.

Host-side numpy re-design of the reference's synthetic generators
(``/root/reference/src/utils.cpp:8-34``) and the fake-correspondence builder
duplicated across its synthetic tests
(``/root/reference/src/tests/initialization_test.cpp:8-26``,
``picp_solver_test.cpp:8-26``, ``essential_picp_test.cpp:11-29``). Used as
pytest fixtures (SURVEY.md §4) and by the synthetic benchmark workloads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.camera import Camera, project_points


def generate_pose(rng: np.random.Generator) -> np.ndarray:
    """Random rigid transform: uniform(-1,1) axis-angle + translation.

    Mirrors ``generate_isometry3f`` (utils.cpp:8-20).
    """
    axis = rng.uniform(-1.0, 1.0, 3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-1.0, 1.0)
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]],
        np.float32,
    )
    r = np.eye(3, dtype=np.float32) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = r
    pose[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return pose


def generate_points3d(rng: np.random.Generator, num_points: int) -> np.ndarray:
    """Random world points, z compressed toward [0, 2] around 1.

    Mirrors ``generate_points3d`` (utils.cpp:22-34): x, y ~ U(-10, 10),
    z ~ U(-10, 10) * 0.1 + 1.
    """
    p = rng.uniform(-10.0, 10.0, (num_points, 3)).astype(np.float32)
    p[:, 2] = p[:, 2] * 0.1 + 1.0
    return p


def generate_appearances(rng: np.random.Generator, num_points: int, dim: int = 10) -> np.ndarray:
    """Unique random appearance descriptors (the dataset's landmark keys)."""
    return rng.uniform(-1.0, 1.0, (num_points, dim)).astype(np.float32)


def default_camera(world_in_camera=None) -> Camera:
    """The synthetic-test camera (initialization_test.cpp:51-57 K and sizes)."""
    k = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    return Camera.create(k, world_in_camera, rows=480, cols=640, z_near=0, z_far=5)


def deep_camera(world_in_camera=None) -> Camera:
    """The same K with a deep frustum (z_far=100) for TRACKING synthetic
    sequences end-to-end: the monocular bootstrap normalizes the two-view
    baseline to ~unit norm, which rescales the map by 1/true_baseline —
    with small per-frame motion that puts triangulated depths far past
    the reference camera's z_far=5 and the solver's frustum gate then
    rejects every point (zero-inlier no-op tracking). The reference
    dataset's own geometry happens to land inside z_far; generic synthetic
    scenes do not."""
    k = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    return Camera.create(k, world_in_camera, rows=480, cols=640, z_near=0, z_far=100.0)


def generate_tracking_sequence(
    rng: np.random.Generator,
    num_frames: int,
    n_slots: int,
    seed_motion: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A trackable synthetic sequence: (points (F,S,2), apps (F,S,D), masks).

    A fixed landmark field observed by a camera on a BOUNDED orbit (a
    circle in front of the field with gentle periodic rotation): every
    consecutive pair has the same real parallax (~0.03 baseline), the
    field stays in view for ANY sequence length — the previous unbounded
    forward+turn path walked out of the scene after ~100 frames, so "long
    sequence" workloads silently degenerated to empty frames — and no
    pair is stationary or pure-rotation. Appearances are the per-landmark
    unique keys (utils.cpp:127 semantics). Used by the scaling
    measurements, the kernel tests and the multi-device dry runs; track with
    :func:`deep_camera` (see its docstring for why z_far=5 cannot hold a
    monocularly-rescaled synthetic map).
    """
    import jax.numpy as jnp

    from ..ops import se3

    world = np.stack(
        [
            rng.uniform(-1.5, 1.5, n_slots),
            rng.uniform(-1.2, 1.2, n_slots),
            rng.uniform(2.0, 4.0, n_slots),
        ],
        axis=1,
    ).astype(np.float32)
    apps = generate_appearances(rng, n_slots)
    pts, masks = [], []
    for i in range(num_frames):
        ph = 2.0 * np.pi * i / 64.0
        v = seed_motion * np.float32(
            [
                0.3 * np.cos(ph),
                0.3 * np.sin(ph),
                0.1 * np.sin(2.0 * ph),
                0.02 * np.sin(ph),
                -0.02 * np.cos(ph),
                0.01 * np.sin(3.0 * ph),
            ]
        )
        pose = np.array(se3.v2t_euler(jnp.asarray(v)))
        uv, valid = project_points(default_camera(pose), world)
        pts.append(np.asarray(uv))
        masks.append(np.asarray(valid))
    return (
        np.stack(pts),
        np.tile(apps[None], (num_frames, 1, 1)),
        np.stack(masks),
    )


def two_view_scene(
    rng: np.random.Generator, num_points: int = 1000
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """World points seen from two random cameras, with identity correspondences.

    Returns (world, w1, w2, p1, p2, corr_valid, x_1_in_2) where w1/w2 are
    world_in_camera poses, p1/p2 the (N, 2) projections ((-1,-1) when
    invalid), corr_valid the both-views-valid mask (the masked equivalent of
    ``computeFakeCorrespondences``), and x_1_in_2 = w2 @ w1⁻¹ the ground
    truth relative pose (essential_picp_test.cpp:103 convention).
    """
    world = generate_points3d(rng, num_points)
    w1 = generate_pose(rng)
    w2 = generate_pose(rng)
    cam1 = default_camera(w1)
    cam2 = default_camera(w2)
    p1, v1 = project_points(cam1, world)
    p2, v2 = project_points(cam2, world)
    corr_valid = np.asarray(v1) & np.asarray(v2)
    x_1_in_2 = w2 @ np.linalg.inv(w1)
    return (
        world,
        w1,
        w2,
        np.asarray(p1),
        np.asarray(p2),
        corr_valid,
        x_1_in_2.astype(np.float32),
    )


def generate_ba_corridor(
    f: int = 512,
    l: int = 100_000,
    obs_per_lm: int = 6,
    seed: int = 0,
    noise_lm: float = 0.02,
    noise_pose: float = 0.01,
    with_truth: bool = False,
):
    """Production-scale sparse-BA corridor problem (shared by
    chip_smoke.py, benchmarks/bench_sparse_ba and parallel/scaling).

    Cameras advance along +z at 0.2/frame; landmark i becomes visible
    around camera ``i * f / l`` and is observed by the next ``obs_per_lm``
    cameras, giving N ~ f-independent ``l * obs_per_lm`` observations —
    the observation structure of a real forward-moving VO sequence. The
    returned problem carries landmark/pose noise so a BA step performs
    genuine correction work. Returns (camera_matrix (3, 3) np.float32,
    SparseBAProblem, live observation count), plus the noise-free (poses,
    landmarks) with ``with_truth``.
    """
    import jax.numpy as jnp

    from ..ops import se3
    from ..parallel import sparse_ba as sba

    rng = np.random.default_rng(seed)
    world = np.stack(
        [
            rng.uniform(-2.0, 2.0, l),
            rng.uniform(-1.5, 1.5, l),
            rng.uniform(0.0, 0.2 * f, l),
        ],
        axis=1,
    ).astype(np.float32)
    vs = np.zeros((f, 6), np.float32)
    vs[:, 2] = 0.2 * np.arange(f)  # t_z
    poses = np.asarray(
        np.stack([np.array(se3.v2t_euler(jnp.asarray(-v))) for v in vs])
    )

    # Cameras look +z from z = 0.2*i: observe each landmark from the
    # obs_per_lm cameras ~1-2.2 units BEFORE it (all depths positive).
    first = np.clip(
        (world[:, 2] / 0.2).astype(np.int64) - obs_per_lm - 5, 0, f - obs_per_lm
    )
    lm_idx = np.repeat(np.arange(l, dtype=np.int64), obs_per_lm)
    frame_idx = (
        np.repeat(first, obs_per_lm)
        + np.tile(np.arange(obs_per_lm), l)
    ).astype(np.int64)

    k = np.array(
        [[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]],
        np.float32,
    )
    pw = world[lm_idx]
    rp = poses[frame_idx]
    pc = np.einsum("nij,nj->ni", rp[:, :3, :3], pw) + rp[:, :3, 3]
    depth_ok = pc[:, 2] > 0.1
    uv = (pc @ k.T)
    uv = uv[:, :2] / np.maximum(uv[:, 2:], 1e-6)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
    )
    mask = depth_ok & in_img

    noisy_lms = world + rng.normal(0, noise_lm, world.shape).astype(np.float32)
    noisy_poses = poses.copy()
    for i in range(1, f):
        dv = rng.uniform(-noise_pose, noise_pose, 6).astype(np.float32)
        noisy_poses[i] = np.array(se3.v2t_euler(jnp.asarray(dv))) @ noisy_poses[i]

    problem = sba.SparseBAProblem(
        poses=jnp.asarray(noisy_poses),
        landmarks=jnp.asarray(noisy_lms),
        frame_idx=jnp.asarray(frame_idx.astype(np.int32)),
        lm_idx=jnp.asarray(lm_idx.astype(np.int32)),
        uv=jnp.asarray(uv.astype(np.float32)),
        obs_mask=jnp.asarray(mask),
    )
    if with_truth:
        return k, problem, int(mask.sum()), (poses, world)
    return k, problem, int(mask.sum())
