"""Projective-ICP (pose from 2D-3D) as a fused, batched Gauss-Newton solver.

Re-design of ``PICPSolver``
(``/root/reference/include/picp_solver.h``,
``/root/reference/src/picp_solver.cpp``). The reference linearizes with a
scalar host loop over correspondences (picp_solver.cpp:55-96) and runs
``oneRound`` from another host loop (e.g. 100x in vo_complete.cpp:163-164).
Here:

  * the per-correspondence error/Jacobian (picp_solver.cpp:25-53) is computed
    for ALL correspondences at once;
  * the H/b accumulation is a single (6, 2N) x (2N, 6) contraction;
  * the full iteration loop is a ``lax.fori_loop`` inside one jit — zero
    host round-trips for the whole solve;
  * invalid / out-of-frustum / outlier points are handled by weights instead
    of ``continue`` (picp_solver.cpp:72-73).

Semantics preserved exactly (SURVEY.md §6):
  * robust kernel: chi > threshold => weight sqrt(thr/chi), outlier
    (picp_solver.cpp:75-88); outliers contribute only if ``keep_outliers``;
  * damping added to H's diagonal every round (picp_solver.cpp:102);
  * update on the Euler chart, left-multiplied: ``X <- v2tEuler(dx) X``
    (picp_solver.cpp:110);
  * defaults damping=1, kernel_threshold=1000 (picp_solver.cpp:9-13) — apps
    override the threshold to 10000 (vo_complete.cpp:139).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import se3
from .camera import Camera, project_points

Array = jnp.ndarray


class PICPStats(NamedTuple):
    """Per-round statistics, mirroring the solver accessors (picp_solver.h:44-50)."""

    chi_inliers: Array
    chi_outliers: Array
    num_inliers: Array


def linearize(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    kernel_threshold: Array,
    keep_outliers: bool = False,
) -> Tuple[Array, Array, PICPStats]:
    """Build the normal system H (6,6), b (6,) over all correspondences.

    Args:
      camera: current camera (pose = current GN iterate).
      world_points: (N, 3) model points, one per correspondence slot
        (already gathered; the reference gathers via correspondence.second,
        picp_solver.cpp:66-71).
      measured_points: (N, 2) measured image points per slot.
      weights: (N,) {0,1} mask of live correspondence slots.
      kernel_threshold: scalar robust-kernel threshold (squared pixels).
    """
    predicted, in_frustum = project_points(camera, world_points)
    error = predicted - measured_points  # (N, 2)

    # Jacobian of the transformation (picp_solver.cpp:37-41):
    #   Jr = [ I3 | skew(-p_cam) ]  (3, 6)
    p_cam = se3.transform_points(camera.world_in_camera, world_points)
    n = world_points.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=world_points.dtype), (n, 3, 3))
    jr = jnp.concatenate([eye, se3.skew(-p_cam)], axis=-1)  # (N, 3, 6)

    # Jacobian of the projection (picp_solver.cpp:43-49).
    p_hom = p_cam @ camera.camera_matrix.T
    iz = 1.0 / jnp.where(p_hom[..., 2] == 0.0, 1.0, p_hom[..., 2])
    iz2 = iz * iz
    # Minimum-depth guard: with z_near == 0 (the dataset's camera) a point
    # essentially AT the pinhole passes the frustum test but its 1/z^2
    # Jacobian terms overflow f32 to inf and NaN-poison H (observed when a
    # degenerate bootstrap collapses the monocular scale toward zero). A
    # micrometre of depth is far below any legitimate scene.
    near_ok = p_hom[..., 2] > 1e-6
    zero = jnp.zeros_like(iz)
    jp = jnp.stack(
        [
            jnp.stack([iz, zero, -p_hom[..., 0] * iz2], -1),
            jnp.stack([zero, iz, -p_hom[..., 1] * iz2], -1),
        ],
        -2,
    )  # (N, 2, 3)

    jac = jp @ camera.camera_matrix @ jr  # (N, 2, 6)

    chi = jnp.sum(error * error, -1)  # (N,)
    is_outlier = chi > kernel_threshold
    safe_chi = jnp.maximum(chi, 1e-30)
    lam = jnp.where(is_outlier, jnp.sqrt(kernel_threshold / safe_chi), 1.0)

    live = weights * in_frustum.astype(weights.dtype) * near_ok.astype(weights.dtype)
    contrib = live * jnp.where(is_outlier, float(keep_outliers), 1.0)
    w = contrib * lam  # (N,)

    # H = Σ w JᵀJ, b = Σ w Jᵀe: fold the N and residual axes together so the
    # contraction is a (6, 2N)x(2N, 6) matmul.
    jw = jac * w[:, None, None]
    j2 = jac.reshape(2 * n, 6)
    jw2 = jw.reshape(2 * n, 6)
    h = jw2.T @ j2
    b = jw2.T @ error.reshape(2 * n)

    inlier = live * (1.0 - is_outlier.astype(weights.dtype))
    stats = PICPStats(
        chi_inliers=jnp.sum(chi * inlier),
        chi_outliers=jnp.sum(chi * live * is_outlier.astype(weights.dtype)),
        num_inliers=jnp.sum(inlier).astype(jnp.int32),
    )
    return h, b, stats


def one_round(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    kernel_threshold: Array,
    damping: Array,
    keep_outliers: bool = False,
    min_num_inliers: Array = 0,
) -> Tuple[Camera, PICPStats, Array]:
    """One GN round (picp_solver.cpp:98-112): linearize, damp, solve, update.

    Also returns the applied increment ``dx`` (6,) for convergence checks.
    When the round's inlier count is below ``min_num_inliers`` the pose
    update is skipped (picp_solver.cpp:103-107: the reference returns
    ``false`` after linearizing, leaving the pose untouched); the stats
    still reflect the linearization, and the returned ``dx`` is zero so
    tolerance-based loops terminate (the reference would keep re-running
    the identical skipped round, which changes nothing).
    """
    h, b, stats = linearize(
        camera, world_points, measured_points, weights, kernel_threshold, keep_outliers
    )
    h = h + damping * jnp.eye(6, dtype=h.dtype)
    dx = jnp.linalg.solve(h, -b)
    enough = stats.num_inliers >= jnp.asarray(min_num_inliers, jnp.int32)
    dx = jnp.where(enough, dx, jnp.zeros_like(dx))
    new_pose = se3.v2t_euler(dx) @ camera.world_in_camera
    return camera.with_pose(new_pose), stats, dx


def solve(
    camera: Camera,
    world_points: Array,
    measured_points: Array,
    weights: Array,
    num_iterations: int,
    kernel_threshold: float = 10000.0,
    damping: float = 1.0,
    keep_outliers: bool = False,
    tolerance: float = 0.0,
    min_num_inliers: int = 0,
    min_iterations: int = 1,
) -> Tuple[Camera, PICPStats]:
    """Run up to ``num_iterations`` GN rounds as one on-device loop.

    Replaces the host loops of vo_complete.cpp:163-164 (100 rounds) and
    vo_daKnown.cpp:149-150 (1000 rounds). The reference runs its full
    iteration budget blindly; with ``tolerance > 0`` we stop once the
    applied increment satisfies ``||dx||^2 <= tolerance`` — GN converges
    quadratically, so a tight tolerance reproduces the 100-round result
    while doing ~10x less sequential work (the frame loop's latency is
    iteration-bound).

    ``tolerance == 0`` runs exactly ``num_iterations`` rounds (bit-parity
    with the reference's fixed budget).
    """
    # Dead correspondence slots may carry garbage (failed triangulations can
    # be NaN/inf); 0 * NaN = NaN would poison the H/b reductions, so
    # sanitize masked-out inputs once up front.
    live = weights > 0.0
    world_points = jnp.where(live[:, None], world_points, 1.0)
    measured_points = jnp.where(live[:, None], measured_points, 0.0)

    kt = jnp.asarray(kernel_threshold, world_points.dtype)
    dp = jnp.asarray(damping, world_points.dtype)

    init_stats = PICPStats(
        chi_inliers=jnp.zeros((), world_points.dtype),
        chi_outliers=jnp.zeros((), world_points.dtype),
        num_inliers=jnp.zeros((), jnp.int32),
    )

    if tolerance <= 0.0:

        def body(_, carry):
            cam, _ = carry
            cam, stats, _dx = one_round(
                cam, world_points, measured_points, weights, kt, dp, keep_outliers,
                min_num_inliers,
            )
            return cam, stats

        return jax.lax.fori_loop(0, num_iterations, body, (camera, init_stats))

    tol = jnp.asarray(tolerance, world_points.dtype)

    def cond(carry):
        # min_iterations delays the tolerance exit: a warm-started solve
        # takes a small first step near its prior before real convergence.
        _, _, it, dx2 = carry
        return (it < num_iterations) & ((dx2 > tol) | (it < min_iterations))

    def body(carry):
        cam, _, it, _ = carry
        cam, stats, dx = one_round(
            cam, world_points, measured_points, weights, kt, dp, keep_outliers,
            min_num_inliers,
        )
        return cam, stats, it + 1, jnp.sum(dx * dx)

    cam, stats, _, _ = jax.lax.while_loop(
        cond, body, (camera, init_stats, jnp.int32(0), jnp.asarray(jnp.inf, world_points.dtype))
    )
    return cam, stats
