"""Projective-ICP constrained to SE(2): the planar estimation variant.

The reference keeps a whole branch (``est_SE2``, README.md:13) where the
estimation runs on SE(2) instead of SE(3) — the dataset's robot moves in a
plane (trajectory.dat ground truth is (x, y, theta)), so freezing z, roll and
pitch removes three unobservable-under-planar-motion DoF and tightens the
solve. That branch is not part of this checkout; this module is a from-
scratch design of the same idea, structured like
:mod:`visual_odometry_tpu.ops.picp` (SE(3) solver, picp_solver.cpp:25-112).

Geometry. The camera is rigidly mounted on the robot via ``cam_in_robot``
(camera.dat's ``cam_transform``, files_utils.cpp:94-134). A planar robot
increment ``T(d)``, d = (dx, dy, dtheta), acts on the world-in-camera pose
``X`` conjugated through the mount::

    X  <-  c^-1 · T(d) · c · X          (c = cam_in_robot)

so the composed relative ROBOT motion ``c · X^-1 · c^-1``
(files_utils.cpp:142-150 pose-chaining convention) stays exactly in SE(2).

Jacobian. With q = c · X · p the model point in robot coordinates, the
derivative of the updated camera-frame point at d = 0 is::

    d(p_cam')/dd = c_R^T · [ e_x | e_y | skew(e_z) q ]     (3, 3)

and the residual Jacobian is ``Jp · K ·`` that (2, 3) — the planar analogue
of ``J = Jp · K · Jr`` (picp_solver.cpp:43-52). H is 3x3, solved in closed
form; all correspondences are processed batched exactly like the SE(3)
solver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from . import se3
from .camera import Camera, project_points
from .picp import PICPStats

Array = jnp.ndarray


def linearize_se2(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    kernel_threshold: Array,
    cam_in_robot: Array,
    keep_outliers: bool = False,
) -> Tuple[Array, Array, PICPStats]:
    """Build the planar normal system H (3, 3), b (3,) over all slots.

    Mirrors the SE(3) ``linearize`` (picp.py / picp_solver.cpp:55-96) with
    the 3-DoF conjugated Jacobian described in the module docstring.
    """
    predicted, in_frustum = project_points(camera, world_points)
    error = predicted - measured_points  # (N, 2)

    p_cam = se3.transform_points(camera.world_in_camera, world_points)
    q = se3.transform_points(cam_in_robot, p_cam)  # robot coords
    c_rt = cam_in_robot[:3, :3].T

    n = world_points.shape[0]
    zeros = jnp.zeros((n,), world_points.dtype)
    ones = jnp.ones((n,), world_points.dtype)
    # Columns: d/d(dx) = e_x, d/d(dy) = e_y, d/d(dtheta) = skew(e_z) q.
    col_x = jnp.stack([ones, zeros, zeros], -1)
    col_y = jnp.stack([zeros, ones, zeros], -1)
    col_t = jnp.stack([-q[..., 1], q[..., 0], zeros], -1)
    jr = jnp.stack([col_x, col_y, col_t], -1)  # (N, 3, 3) in robot coords
    jr = jnp.einsum("ij,njk->nik", c_rt, jr)  # back to camera coords

    # Projection Jacobian (picp_solver.cpp:43-49), identical to SE(3).
    p_hom = p_cam @ camera.camera_matrix.T
    iz = 1.0 / jnp.where(p_hom[..., 2] == 0.0, 1.0, p_hom[..., 2])
    iz2 = iz * iz
    # Minimum-depth guard (see ops/picp.linearize): 1/z^2 overflow safety.
    near_ok = p_hom[..., 2] > 1e-6
    zero = jnp.zeros_like(iz)
    jp = jnp.stack(
        [
            jnp.stack([iz, zero, -p_hom[..., 0] * iz2], -1),
            jnp.stack([zero, iz, -p_hom[..., 1] * iz2], -1),
        ],
        -2,
    )  # (N, 2, 3)
    jac = jp @ camera.camera_matrix @ jr  # (N, 2, 3)

    chi = jnp.sum(error * error, -1)
    is_outlier = chi > kernel_threshold
    safe_chi = jnp.maximum(chi, 1e-30)
    lam = jnp.where(is_outlier, jnp.sqrt(kernel_threshold / safe_chi), 1.0)
    live = (
        weights * in_frustum.astype(weights.dtype) * near_ok.astype(weights.dtype)
    )
    contrib = live * jnp.where(is_outlier, float(keep_outliers), 1.0)
    w = contrib * lam

    jw = jac * w[:, None, None]
    j2 = jac.reshape(2 * n, 3)
    jw2 = jw.reshape(2 * n, 3)
    h = jw2.T @ j2
    b = jw2.T @ error.reshape(2 * n)

    inlier = live * (1.0 - is_outlier.astype(weights.dtype))
    stats = PICPStats(
        chi_inliers=jnp.sum(chi * inlier),
        chi_outliers=jnp.sum(chi * live * is_outlier.astype(weights.dtype)),
        num_inliers=jnp.sum(inlier).astype(jnp.int32),
    )
    return h, b, stats


def one_round_se2(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    kernel_threshold: Array,
    damping: Array,
    cam_in_robot: Array,
    cam_in_robot_inv: Array,
    keep_outliers: bool = False,
    min_num_inliers: Array = 0,
) -> Tuple[Camera, PICPStats, Array]:
    """One planar GN round: linearize, damp, 3x3 solve, conjugated update.

    The inlier floor (picp_solver.cpp:103-107) skips the pose update when
    the round's inlier count is below ``min_num_inliers`` (same contract as
    ``picp.one_round``).
    """
    h, b, stats = linearize_se2(
        camera, world_points, measured_points, weights, kernel_threshold,
        cam_in_robot, keep_outliers,
    )
    h = h + damping * jnp.eye(3, dtype=h.dtype)
    dx = jnp.linalg.solve(h, -b)
    enough = stats.num_inliers >= jnp.asarray(min_num_inliers, jnp.int32)
    dx = jnp.where(enough, dx, jnp.zeros_like(dx))
    incr = cam_in_robot_inv @ se3.v2t_se2(dx) @ cam_in_robot
    return camera.with_pose(incr @ camera.world_in_camera), stats, dx


def solve_se2(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    num_iterations: int,
    kernel_threshold: float = 10000.0,
    damping: float = 1.0,
    keep_outliers: bool = False,
    tolerance: float = 0.0,
    cam_in_robot: Optional[Array] = None,
    min_num_inliers: int = 0,
    min_iterations: int = 1,
) -> Tuple[Camera, PICPStats]:
    """Planar PICP solve, same loop structure as the SE(3) ``picp.solve``.

    ``min_iterations`` keeps the tolerance exit from firing before that
    many rounds (same contract as ``picp.solve``: a warm-started solve
    takes a small first step near its prior even when not converged).

    ``cam_in_robot=None`` means the camera IS the planar body (identity
    mount). The returned pose lies exactly in the conjugated SE(2) subgroup
    provided the start pose does (apps planarize the start with
    ``se3.project_se2``).
    """
    dtype = world_points.dtype
    c = jnp.eye(4, dtype=dtype) if cam_in_robot is None else jnp.asarray(cam_in_robot, dtype)
    c_inv = se3.inverse(c)
    kt = jnp.asarray(kernel_threshold, dtype)
    dp = jnp.asarray(damping, dtype)
    init_stats = PICPStats(
        chi_inliers=jnp.zeros((), dtype),
        chi_outliers=jnp.zeros((), dtype),
        num_inliers=jnp.zeros((), jnp.int32),
    )

    if tolerance <= 0.0:

        def body(_, carry):
            cam, _ = carry
            cam, stats, _dx = one_round_se2(
                cam, world_points, measured_points, weights, kt, dp, c, c_inv,
                keep_outliers, min_num_inliers,
            )
            return cam, stats

        return jax.lax.fori_loop(0, num_iterations, body, (camera, init_stats))

    tol = jnp.asarray(tolerance, dtype)

    def cond(carry):
        _, _, it, dx2 = carry
        return (it < num_iterations) & ((dx2 > tol) | (it < min_iterations))

    def body(carry):
        cam, _, it, _ = carry
        cam, stats, dx = one_round_se2(
            cam, world_points, measured_points, weights, kt, dp, c, c_inv,
            keep_outliers, min_num_inliers,
        )
        return cam, stats, it + 1, jnp.sum(dx * dx)

    cam, stats, _, _ = jax.lax.while_loop(
        cond, body, (camera, init_stats, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
    )
    return cam, stats
