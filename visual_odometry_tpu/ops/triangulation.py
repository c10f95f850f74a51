"""Mid-point two-view triangulation, fully batched with validity masks.

Re-design of ``triangulate_point`` / ``triangulate_points``
(``/root/reference/src/utils.cpp:36-134``). The reference solves a 2x2
normal-equation system per correspondence inside a host loop and *compacts*
the output vector; here the 2x2 solve is closed-form, vmapped across all
correspondences at once, and compaction is replaced by a validity mask so all
shapes stay static (SURVEY.md §7 "pad-to-max + masks everywhere").

Geometry (utils.cpp:51-76): for correspondence (i, j) between image 1 and
image 2, with X = pose of camera 1 expressed in camera 2's frame,
  d1 = K⁻¹ [p1_i; 1]              (ray from cam-1 origin, cam-1 frame)
  d2 = (X⁻¹.R K⁻¹) [p2_j; 1]      (ray direction of cam 2, cam-1 frame)
  t  = X⁻¹.t                      (cam-2 origin in cam-1 frame)
Solve min ||s0*d1 - (t + s1*d2)|| => 2x2 system; a point is rejected when
either ray parameter is negative, i.e. behind a camera (utils.cpp:41-42).
The triangulated point is the segment midpoint, in camera-1 coordinates.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from . import se3

Array = jnp.ndarray

# Rays closer to parallel than this produce a singular 2x2 system; the
# reference feeds it to LDLT anyway (utils.cpp:39) and gets garbage that the
# cheirality test then discards — we mask it out explicitly instead.
_DET_EPS = 1e-12


def triangulate_pairs(
    camera_matrix: Array,
    x_1_in_2: Array,
    p1: Array,
    p2: Array,
    valid: Array,
) -> Tuple[Array, Array]:
    """Triangulate already-gathered point pairs.

    Args:
      camera_matrix: (3, 3) intrinsics.
      x_1_in_2: (4, 4) pose of camera 1 in camera 2's frame.
      p1: (..., N, 2) pixel coords in image 1 (gathered per correspondence).
      p2: (..., N, 2) pixel coords in image 2.
      valid: (..., N) bool mask of live correspondences.

    Returns:
      (points, ok): (..., N, 3) mid-points in camera-1 coordinates and the
      (..., N) success mask (valid & in-front-of-both-cameras), mirroring the
      ``n_success`` compaction of utils.cpp:60-75 as a mask.
    """
    i_x = se3.inverse(x_1_in_2)
    i_k = jnp.linalg.inv(camera_matrix)
    ir_ik = se3.rot(i_x) @ i_k
    t = se3.trans(i_x)

    ones = jnp.ones(p1.shape[:-1] + (1,), p1.dtype)
    d1 = jnp.concatenate([p1, ones], -1) @ i_k.T
    d2 = jnp.concatenate([p2, ones], -1) @ ir_ik.T

    # Normal equations of D = [-d1 | d2]:  (DᵀD) s = -Dᵀ t, solved closed-form.
    a00 = jnp.sum(d1 * d1, -1)
    a01 = -jnp.sum(d1 * d2, -1)
    a11 = jnp.sum(d2 * d2, -1)
    b0 = -jnp.sum(-d1 * t, -1)
    b1 = -jnp.sum(d2 * t, -1)
    det = a00 * a11 - a01 * a01
    safe_det = jnp.where(jnp.abs(det) < _DET_EPS, 1.0, det)
    s0 = (a11 * b0 - a01 * b1) / safe_det
    s1 = (a00 * b1 - a01 * b0) / safe_det

    ok = valid & (s0 >= 0.0) & (s1 >= 0.0) & (jnp.abs(det) >= _DET_EPS)
    points = 0.5 * (s0[..., None] * d1 + t + s1[..., None] * d2)
    # Near-parallel rays with a just-above-eps determinant can push the ray
    # parameters past f32 range; a non-finite (or overflow-adjacent) "valid"
    # point downstream turns masked-out GN contributions into NaN
    # (inf * 0 through the projection chain), so reject it here like the
    # behind-camera case. 1e18 is astronomically beyond any scene while
    # keeping every downstream f32 intermediate finite.
    ok = ok & jnp.all(jnp.abs(points) < 1e18, axis=-1)
    points = jnp.where(ok[..., None], points, 0.0)
    return points, ok


def triangulate_correspondences(
    camera_matrix: Array,
    x_1_in_2: Array,
    idx1: Array,
    idx2: Array,
    corr_valid: Array,
    p1_img: Array,
    p2_img: Array,
) -> Tuple[Array, Array]:
    """Triangulate indexed correspondences (the batched ``triangulate_points``).

    Mirrors utils.cpp:51-105 with static shapes: output slot ``s`` holds the
    triangulation of correspondence ``s`` (the reference's compacted index is
    recovered implicitly: valid slots in order ARE the compact sequence, and
    the (idx_second, new_idx) pairs of utils.cpp:98 become the
    ``point_lookup`` scatter in models/pipeline.py).

    Args:
      idx1, idx2: (N,) int32 correspondence indices into p1_img / p2_img.
      corr_valid: (N,) bool.
      p1_img, p2_img: (M1, 2), (M2, 2) full per-frame point arrays.

    Returns: ((N, 3) points in camera-1 frame, (N,) ok mask).
    """
    p1 = p1_img[idx1]
    p2 = p2_img[idx2]
    return triangulate_pairs(camera_matrix, x_1_in_2, p1, p2, corr_valid)
