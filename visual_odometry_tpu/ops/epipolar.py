"""Two-view epipolar initialization (8-point algorithm), batched + masked.

Re-design of ``/root/reference/src/epipolar_utils.cpp``:

  * ``estimate_fundamental`` (epipolar_utils.cpp:103-144): [-1,1] coordinate
    normalization, Nx9 design matrix, null-space extraction, rank-2
    projection, de-normalization. The reference takes the smallest right
    singular vector of A via thin SVD; we take the smallest eigenvector of
    the 9x9 normal matrix AᵀA (same subspace, pad-row-invariant: zero rows
    from masked correspondences contribute nothing to AᵀA) — this keeps the
    decomposition a fixed tiny 9x9 ``eigh`` regardless of correspondence
    count, which is what XLA wants.
  * ``essential2transformPair`` (epipolar_utils.cpp:146-174): SVD of E,
    R = V·W·Uᵀ. The reference re-runs the SVD on -E when det(R) < 0; that
    fix-up is algebraically identical to flipping the sign of both candidate
    rotations, so we apply the sign branchlessly.
  * ``estimate_transform`` (epipolar_utils.cpp:176-213): builds the 4
    candidate transforms (2 rotations x ±t) and picks the one with the most
    in-front triangulations (cheirality vote). The reference triangulates the
    4 candidates serially; we vmap the triangulation over a stacked (4, ...)
    candidate axis. Tie-breaking matches the reference's strict
    ``n_test > n_in_front`` scan (first argmax; identity if all votes are 0).

Returns the pose of camera 1 expressed in camera 2's frame, with arbitrary
translation scale (monocular; SURVEY.md §6 gotcha 3).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import se3, triangulation

Array = jnp.ndarray


def transform_to_essential(x_1_in_2: Array) -> Array:
    """Ground-truth essential matrix from a relative pose.

    Mirrors ``transform2essential`` (epipolar_utils.cpp:3-7):
    ``E = Rᵀ skew(t)`` — used for synthetic cross-checks of the estimator.
    """
    return jnp.swapaxes(se3.rot(x_1_in_2), -1, -2) @ se3.skew(se3.trans(x_1_in_2))


def normalize_points(points: Array, mask: Array) -> Tuple[Array, Array]:
    """Scale pixel coords into [-1, 1] per axis; returns (normalized, T).

    Mirrors ``normalize`` (epipolar_utils.cpp:48-65): the max is taken over
    *all* (valid) points of the frame starting from 0, and
    ``T = [[2/max_x, 0, -1], [0, 2/max_y, -1], [0, 0, 1]]`` maps originals to
    normalized coords. Masked slots are excluded from the max.
    """
    masked = jnp.where(mask[..., None], points, 0.0)
    maxs = jnp.max(masked, axis=-2)  # (..., 2); reference starts max at 0
    half = maxs / 2.0
    safe_half = jnp.where(half == 0.0, 1.0, half)
    normalized = points / safe_half[..., None, :] - 1.0
    t = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], points.dtype)
    t = t.at[0, 0].set(1.0 / safe_half[..., 0]).at[1, 1].set(1.0 / safe_half[..., 1])
    return normalized, t


def _null_vector(ata: Array, iters: int = 3) -> Array:
    """Unit null vector of a PSD normal matrix, robust in f32.

    eigh's f32 null vector carries ~1e-3 error (fatal for the downstream
    essential decomposition; CPU LAPACK gives ~1e-5), so it is polished by
    inverse iteration, which contracts the error by (lambda_0+ridge)/
    (lambda_1+ridge) per step and is self-correcting under inexact f32
    solves. The ridge must dominate eigh's f32 eigenvalue roundoff: the
    smallest eigenvalue comes back as large as ~|1e-7 * lambda_max| and
    NEGATIVE on real data (measured -5.1e-7 on a sparse 13-correspondence
    frame pair), and an LU solve through that near-singular indefinite
    matrix can emit NaN — 1e-6 * trace sits two orders above the roundoff
    and two below any usable lambda_1. A non-finite polish result (truly
    rank-deficient ata) falls back to the unpolished eigh vector.
    """
    _, vecs = jnp.linalg.eigh(ata)
    v0 = vecs[:, 0]
    ridge = 1e-6 * jnp.trace(ata)
    ata_r = ata + ridge * jnp.eye(ata.shape[0], dtype=ata.dtype)
    v = v0
    for _ in range(iters):
        v = jnp.linalg.solve(ata_r, v)
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
    return jnp.where(jnp.all(jnp.isfinite(v)), v, v0)


def normalize_points_gauss(points: Array, mask: Array) -> Tuple[Array, Array]:
    """Whitening normalization: zero mean, identity covariance; returns (p, T).

    Mirrors ``normalizeGauss`` (epipolar_utils.cpp:67-101): mean and sample
    covariance (1/(N-1)) over the VALID points, ``T = [[L^-1, -L^-1 mu],
    [0, 1]]`` with ``L`` the lower Cholesky factor of the covariance, so
    valid points map to ``L^-1 (p - mu)``. The reference leaves its
    invalid (-1,-1) sentinels untouched; here masked slots pass through
    unchanged. Statistics are computed with masked reductions (static
    shapes), and a degenerate covariance (N < 2 or collinear points) falls
    back to the identity transform instead of a NaN Cholesky.
    """
    m = mask.astype(points.dtype)
    n = jnp.sum(m)
    mu = jnp.sum(points * m[..., None], axis=-2) / jnp.maximum(n, 1.0)
    c = (points - mu) * m[..., None]
    sigma = (c.T @ c) / jnp.maximum(n - 1.0, 1.0)
    # 2x2 lower Cholesky in closed form; guard degeneracy.
    a = sigma[0, 0]
    b = sigma[1, 0]
    d = sigma[1, 1]
    ok = (n >= 2.0) & (a > 0.0)
    l00 = jnp.sqrt(jnp.where(ok, a, 1.0))
    l10 = b / l00
    s22 = d - l10 * l10
    ok = ok & (s22 > 0.0)
    l11 = jnp.sqrt(jnp.where(ok, s22, 1.0))
    # inv(L) for lower-triangular 2x2.
    i00 = 1.0 / l00
    i11 = 1.0 / l11
    i10 = -l10 * i00 * i11
    inv_l = jnp.stack(
        [jnp.stack([i00, jnp.zeros_like(i00)]), jnp.stack([i10, i11])]
    )
    w = jnp.where(ok, inv_l, jnp.eye(2, dtype=points.dtype))
    shift = jnp.where(ok, -(w @ mu), jnp.zeros_like(mu))
    t = jnp.eye(3, dtype=points.dtype)
    t = t.at[:2, :2].set(w).at[:2, 2].set(shift)
    whitened = points @ w.T + shift
    out = jnp.where(mask[..., None], whitened, points)
    return out, t


def estimate_essential(
    camera_matrix: Array,
    idx1: Array,
    idx2: Array,
    corr_valid: Array,
    p1_img: Array,
    p2_img: Array,
) -> Array:
    """Direct essential-matrix estimate from calibrated ray directions.

    Mirrors ``estimate_essential`` (epipolar_utils.cpp:9-46, marked "Not
    used" at epipolar_utils.h:8): per correspondence, the calibrated
    directions ``d1 = K^-1 [p1;1]``, ``d2 = K^-1 [p2;1]`` give the design
    row ``vec(d1 d2^T)`` (row-major); the 9x9 normal-matrix accumulation is
    one batched outer-product matmul here, and E is its smallest
    eigenvector (same eigh + inverse-iteration polish as
    :func:`estimate_fundamental`). Like the reference, no rank-2/singular-
    value constraint is imposed (its constrained variant is commented out,
    epipolar_utils.cpp:40-44). The reference aborts on < 8 correspondences
    (epipolar_utils.cpp:10-13); this batched form is pure — callers check
    :func:`count_valid_correspondences` (apps raise BootstrapError).
    """
    ik = jnp.linalg.inv(camera_matrix)
    ones = jnp.ones(idx1.shape + (1,), p1_img.dtype)
    d1 = jnp.concatenate([p1_img[idx1], ones], -1) @ ik.T  # (N, 3)
    d2 = jnp.concatenate([p2_img[idx2], ones], -1) @ ik.T  # (N, 3)
    rows = (d1[..., :, None] * d2[..., None, :]).reshape(idx1.shape + (9,))
    rows = jnp.where(corr_valid[..., None], rows, 0.0)

    ata = rows.T @ rows
    return _null_vector(ata).reshape(3, 3)


def estimate_fundamental(
    idx1: Array,
    idx2: Array,
    corr_valid: Array,
    p1_img: Array,
    p2_img: Array,
    mask1: Array,
    mask2: Array,
) -> Array:
    """8-point fundamental-matrix estimate with masked correspondences.

    Mirrors epipolar_utils.cpp:103-144. The design row for a pair (d1, d2)
    in homogeneous normalized coords is vec(d1 d2ᵀ) in row-major order
    (epipolar_utils.cpp:121-125); invalid correspondences contribute a zero
    row, which leaves AᵀA unchanged.
    """
    p1n, t1 = normalize_points(p1_img, mask1)
    p2n, t2 = normalize_points(p2_img, mask2)

    ones = jnp.ones(idx1.shape + (1,), p1_img.dtype)
    d1 = jnp.concatenate([p1n[idx1], ones], -1)  # (N, 3)
    d2 = jnp.concatenate([p2n[idx2], ones], -1)  # (N, 3)
    rows = (d1[..., :, None] * d2[..., None, :]).reshape(idx1.shape + (9,))
    rows = jnp.where(corr_valid[..., None], rows, 0.0)

    ata = rows.T @ rows  # (9, 9) normal matrix — one small matmul
    f_approx = _null_vector(ata).reshape(3, 3)

    # Re-impose rank 2 (epipolar_utils.cpp:133-141).
    u, s, vt = jnp.linalg.svd(f_approx, full_matrices=True)
    f = (u * s.at[2].set(0.0)) @ vt

    # Undo normalization: T1ᵀ F T2 (epipolar_utils.cpp:143).
    return t1.T @ f @ t2


def essential_to_transform_pair(e: Array) -> Tuple[Array, Array, Array, Array]:
    """E -> two candidate rotations and translations.

    Mirrors ``essential2transformPair`` (epipolar_utils.cpp:146-174):
    ``R1 = V W Uᵀ``, ``R2 = V Wᵀ Uᵀ``, translation read off the skew matrix
    ``R E``. The det(R)<0 fix-up (recompute the SVD of -E,
    epipolar_utils.cpp:154-159) flips the sign of exactly one of U/V and so
    of both rotations; we apply ``sign(det)`` directly.
    """
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e.dtype)
    u, _, vt = jnp.linalg.svd(e, full_matrices=True)
    v = vt.T
    r1 = v @ w @ u.T
    sign = jnp.sign(jnp.linalg.det(r1))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    r1 = sign * r1
    r2 = sign * (v @ w.T @ u.T)

    def unskew(m: Array) -> Array:
        return jnp.stack([m[2, 1], m[0, 2], m[1, 0]])

    t1 = unskew(r1 @ e)
    t2 = unskew(r2 @ e)
    return r1, t1, r2, t2


def homography_transfer_residuals(
    idx1: Array,
    idx2: Array,
    corr_valid: Array,
    p1_img: Array,
    p2_img: Array,
    mask1: Array,
    mask2: Array,
) -> Tuple[Array, Array]:
    """Per-correspondence transfer residual of the best-fit DLT homography.

    Two-view degeneracy score with no reference counterpart (the reference
    never bootstraps mid-sequence): a pure-rotation (or planar) frame pair
    is EXACTLY explained by a homography, so the residual of the best-fit
    H measures the translation-plus-depth-variation evidence that the
    8-point initializer (epipolar_utils.cpp:176-213) needs — E = Rᵀskew(t)
    vanishes as t -> 0, making bootstrap scale meaningless there. Chunked
    tracking (parallel/posegraph) uses the masked median of these residuals
    to pick well-conditioned bootstrap pairs.

    Returns (residuals, valid) in the [-1, 1]-normalized image frame, one
    per correspondence slot; built exactly like ``estimate_fundamental``
    (same normalization, same 9x9 normal-matrix null space, same
    inverse-iteration polish) but with the two DLT rows per point.
    """
    p1n, t1 = normalize_points(p1_img, mask1)
    p2n, t2 = normalize_points(p2_img, mask2)
    del t1, t2  # residuals are scored in the normalized frame

    x1 = p1n[idx1, 0]
    y1 = p1n[idx1, 1]
    x2 = p2n[idx2, 0]
    y2 = p2n[idx2, 1]
    zeros = jnp.zeros_like(x1)
    ones = jnp.ones_like(x1)
    row_a = jnp.stack(
        [x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], axis=-1
    )
    row_b = jnp.stack(
        [zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1, -y2], axis=-1
    )
    rows = jnp.concatenate([row_a, row_b], axis=0)
    rows = jnp.where(jnp.concatenate([corr_valid, corr_valid])[:, None], rows, 0.0)

    ata = rows.T @ rows
    h = _null_vector(ata, iters=2).reshape(3, 3)

    px = h[0, 0] * x1 + h[0, 1] * y1 + h[0, 2]
    py = h[1, 0] * x1 + h[1, 1] * y1 + h[1, 2]
    pz = h[2, 0] * x1 + h[2, 1] * y1 + h[2, 2]
    safe_pz = jnp.where(jnp.abs(pz) < 1e-12, 1.0, pz)
    res = jnp.hypot(px / safe_pz - x2, py / safe_pz - y2)
    valid = corr_valid & (jnp.abs(pz) >= 1e-12)
    return jnp.where(valid, res, 0.0), valid


def estimate_transform(
    camera_matrix: Array,
    idx1: Array,
    idx2: Array,
    corr_valid: Array,
    p1_img: Array,
    p2_img: Array,
    mask1: Array,
    mask2: Array,
) -> Array:
    """Full two-view initializer: F -> E -> 4 candidates -> cheirality vote.

    Mirrors ``estimate_transform`` (epipolar_utils.cpp:176-213). Returns the
    (4, 4) pose of camera 1 in camera 2's frame (identity if no candidate
    triangulates any point in front of both cameras, matching the reference's
    ``X_best`` initialization at epipolar_utils.cpp:183).
    """
    f = estimate_fundamental(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2)
    e = camera_matrix.T @ f @ camera_matrix  # epipolar_utils.cpp:180
    r1, t1, r2, t2 = essential_to_transform_pair(e)

    # Candidate order matches the reference's test sequence
    # (epipolar_utils.cpp:187-211): X1, X1 with -t, X2, X2 with -t.
    rs = jnp.stack([r1, r1, r2, r2])
    ts = jnp.stack([t1, -t1, t2, -t2])
    candidates = se3.pose_from_rt(rs, ts)  # (4, 4, 4)

    def count_in_front(x: Array) -> Array:
        _, ok = triangulation.triangulate_correspondences(
            camera_matrix, x, idx1, idx2, corr_valid, p1_img, p2_img
        )
        return jnp.sum(ok.astype(jnp.int32))

    votes = jax.vmap(count_in_front)(candidates)  # (4,)
    best = jnp.argmax(votes)  # first max == reference's strict-> scan
    x_best = candidates[best]
    return jnp.where(votes[best] > 0, x_best, jnp.eye(4, dtype=x_best.dtype))
