"""Production-scale bundle adjustment on a sparse (COO) observation graph.

The dense formulation (parallel/bundle_adjustment.py) materializes an
(F, L) observation grid and an (F, L, 6, 3) coupling tensor — fine at the
reference's 121x1000, impossible at 512 poses x 10^5..10^6 landmarks
(3.7 TB of coupling alone), which is exactly the regime the distributed-BA
story exists for (SURVEY.md §5 north star; no reference counterpart — the
reference never refines jointly, PointCloud.h:52-66).

This module solves the SAME robust reprojection problem on a flat
per-observation layout:

    obs n = (frame_idx[n], lm_idx[n], uv[n])  — memory O(N), not O(F*L)

with a Levenberg-Marquardt Gauss-Newton step whose reduced (Schur) pose
system is solved by **matrix-free preconditioned conjugate gradients**:

  * per-observation residuals/Jacobians are elementwise over (N,) lanes
    (identical math to the dense path / picp_solver.cpp:25-53);
  * H_pp (F, 6, 6), b_p, H_ll (L, 3, 3), b_l accumulate via segment_sum —
    in monocular VO each (frame, landmark) pair is observed at most once,
    so each observation IS one coupling block W_n = w * j_pose^T (x) j_lm
    (6, 3), never materialized per (f, l);
  * the reduced operator S v = (H_pp + lambda I) v - W Hll^-1 W^T v is
    applied matrix-free in O(N): gather v at frame_idx -> per-obs (3,)
    products -> segment_sum over lm_idx -> Hll^-1 -> per-obs (6,) products
    -> segment_sum over frame_idx. No (6F, 6F) matrix, no landmark-degree
    pairing, works for any observation multiplicity;
  * CG is preconditioned with the EXACT block diagonal of S (the diagonal
    coupling correction sum_{n in f} W_n Hll^-1 W_n^T is also O(N)),
    solved per 6x6 block by the same Jacobi-scaled 3x3-block Schur inverse
    as the PICP kernel;
  * landmarks back-substitute locally: dx_l = -Hll^-1 (b_l + W^T dx_p).

Gauge: pose 0 is clamped by projecting its 6 coordinates out of the CG
space (operator, rhs and preconditioner all zero its block), equivalent to
the dense path's identity-row clamp. Pose updates use the tracking Euler
chart ``X <- v2tEuler(dx) X`` (utils.h:73-78).

Distribution: landmarks AND their observations shard over the ``lm`` mesh
axis (each observation lives with its landmark, so H_ll / b_l / the CG
landmark stage are all shard-local); the (F, 6) pose-space vectors are
replicated and the ONLY collectives are one psum of H_pp/b_p/precond per
step plus one (F, 6) psum per CG matvec — all O(F), independent of N and
L. ``partition_observations`` builds the shard layout on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import se3

Array = jnp.ndarray


def _gather_frame_rows(v: Array, frame_idx: Array) -> Array:
    """(F, R) table gathered to (N, R) by frame id."""
    return v[frame_idx]


def _segsum_frame_rows(vals: Array, frame_idx: Array, f: int) -> Array:
    """(N, R) rows summed into (F, R) by frame id (id >= f drops the row)."""
    return jax.ops.segment_sum(vals, frame_idx, num_segments=f + 1)[:f]


class SparseBAProblem(NamedTuple):
    """A bundle-adjustment instance over a flat observation list."""

    poses: Array       # (F, 4, 4) world->camera (absolute)
    landmarks: Array   # (L, 3) world coords
    frame_idx: Array   # (N,) int32
    lm_idx: Array      # (N,) int32
    uv: Array          # (N, 2) pixel measurements
    obs_mask: Array    # (N,) bool (padding entries False)


class SparseBAStats(NamedTuple):
    chi: Array         # () total robust chi^2
    num_obs: Array     # () int32 live observations
    cg_residual: Array  # () final CG relative residual of the pose solve


def pack_problem(problem: SparseBAProblem):
    """Host-side repack into a fixed-degree lm-major layout.

    Returns (packed_problem, degree) with N' = L * degree observation
    slots, slot l*degree + r holding landmark l's r-th observation (padded
    slots masked). With this layout the LM-side stages of the Schur-CG
    matvec — segment-sum by landmark and the gather back — become a
    reshape-reduce and a broadcast instead of a scatter-add and a gather.
    Returns (problem, None) unchanged when packing would blow up the
    observation count (a landmark observed in most frames).
    """
    li = np.asarray(problem.lm_idx)
    fi = np.asarray(problem.frame_idx)
    uv = np.asarray(problem.uv)
    mask = np.asarray(problem.obs_mask).astype(bool)
    l = int(problem.landmarks.shape[0])
    counts = np.bincount(li[mask], minlength=l)
    degree = max(int(counts.max()) if counts.size else 1, 1)
    if l * degree > 4 * max(len(li), 1):
        return problem, None
    fi2 = np.zeros((l, degree), np.int32)
    uv2 = np.zeros((l, degree, 2), np.float32)
    m2 = np.zeros((l, degree), bool)
    order = np.argsort(li[mask], kind="stable")
    lm_sorted = li[mask][order]
    rank = np.arange(len(lm_sorted)) - np.searchsorted(lm_sorted, lm_sorted, side="left")
    fi2[lm_sorted, rank] = fi[mask][order]
    uv2[lm_sorted, rank] = uv[mask][order]
    m2[lm_sorted, rank] = True
    li2 = np.repeat(np.arange(l, dtype=np.int32), degree)
    packed = SparseBAProblem(
        poses=problem.poses,
        landmarks=problem.landmarks,
        frame_idx=jnp.asarray(fi2.reshape(-1)),
        lm_idx=jnp.asarray(li2),
        uv=jnp.asarray(uv2.reshape(-1, 2)),
        obs_mask=jnp.asarray(m2.reshape(-1)),
    )
    return packed, degree


def _segsum_lm(rows: Array, lm_idx: Array, mask: Array, l: int,
               lm_degree) -> Array:
    """(N, R) -> (L, R) sums by landmark. In the packed layout this is a
    reshape-reduce; otherwise an XLA segment scatter (rows are pre-zeroed
    for masked slots in every call site, so drop semantics are moot)."""
    if lm_degree is not None:
        # Per-column (N,) -> (L, D) reshapes: the 3D (N, R) ->
        # (L, D, R) form makes XLA pick a transposed layout and pay a
        # physical relayout per CG iteration (measured 33 ms per
        # (600k, 3) reshape at L=100k).
        return jnp.stack(
            [
                rows[:, i].reshape(l, lm_degree).sum(axis=1)
                for i in range(rows.shape[-1])
            ],
            axis=-1,
        )
    safe = jnp.where(mask, lm_idx, l)
    return jax.ops.segment_sum(rows, safe, num_segments=l + 1)[:l]


def _gather_lm(values: Array, lm_idx: Array, n: int, lm_degree) -> Array:
    """(L, ...) per-landmark values -> (N, ...) per-observation. Packed:
    a broadcast over the degree axis; otherwise an XLA gather."""
    if lm_degree is not None:
        l = values.shape[0]
        if values.ndim == 2:
            # Column-wise broadcast avoids the 3D relayout (see _segsum_lm).
            return jnp.stack(
                [
                    jnp.broadcast_to(
                        values[:, i:i + 1], (l, lm_degree)
                    ).reshape(n)
                    for i in range(values.shape[1])
                ],
                axis=-1,
            )
        return jnp.broadcast_to(
            values[:, None], (l, lm_degree) + values.shape[1:]
        ).reshape((n,) + values.shape[1:])
    return values[lm_idx]


def _per_obs_system(camera_matrix, poses, landmarks, frame_idx, lm_idx, uv,
                    obs_mask, kernel_threshold, lm_degree=None):
    """Residuals, Jacobian rows and robust weights per observation.

    Same component expansion as the dense path (bundle_adjustment.py:70-152
    / picp_solver.cpp:25-53), on (N,) lanes. Returns j_pose x/y (N, 6),
    j_lm x/y (N, 3), residuals, weights, chi.
    """
    safe_f = jnp.where(obs_mask, frame_idx, 0)
    safe_l = jnp.where(obs_mask, lm_idx, 0)
    rf = poses[safe_f, :3, :3]                  # (N, 3, 3)
    tf = poses[safe_f, :3, 3]                   # (N, 3)
    p = _gather_lm(landmarks, safe_l, uv.shape[0], lm_degree)  # (N, 3)
    k = camera_matrix
    wx, wy, wz = p[:, 0], p[:, 1], p[:, 2]

    def rr(i, j):
        return rf[:, i, j]

    px = rr(0, 0) * wx + rr(0, 1) * wy + rr(0, 2) * wz + tf[:, 0]
    py = rr(1, 0) * wx + rr(1, 1) * wy + rr(1, 2) * wz + tf[:, 1]
    pz = rr(2, 0) * wx + rr(2, 1) * wy + rr(2, 2) * wz + tf[:, 2]

    hx = k[0, 0] * px + k[0, 1] * py + k[0, 2] * pz
    hy = k[1, 0] * px + k[1, 1] * py + k[1, 2] * pz
    hz = k[2, 0] * px + k[2, 1] * py + k[2, 2] * pz
    iz = 1.0 / jnp.where(hz == 0.0, 1.0, hz)
    u = hx * iz
    v = hy * iz
    in_front = pz > 1e-3
    ex = u - uv[:, 0]
    ey = v - uv[:, 1]

    iz2 = iz * iz
    a00 = k[0, 0] * iz - k[2, 0] * hx * iz2
    a01 = k[0, 1] * iz - k[2, 1] * hx * iz2
    a02 = k[0, 2] * iz - k[2, 2] * hx * iz2
    a10 = k[1, 0] * iz - k[2, 0] * hy * iz2
    a11 = k[1, 1] * iz - k[2, 1] * hy * iz2
    a12 = k[1, 2] * iz - k[2, 2] * hy * iz2

    jx3 = a01 * (-pz) + a02 * py
    jx4 = a00 * pz + a02 * (-px)
    jx5 = a00 * (-py) + a01 * px
    jy3 = a11 * (-pz) + a12 * py
    jy4 = a10 * pz + a12 * (-px)
    jy5 = a10 * (-py) + a11 * px
    j_pose_x = jnp.stack([a00, a01, a02, jx3, jx4, jx5], -1)   # (N, 6)
    j_pose_y = jnp.stack([a10, a11, a12, jy3, jy4, jy5], -1)

    j_lm_x = jnp.stack(
        [
            a00 * rr(0, 0) + a01 * rr(1, 0) + a02 * rr(2, 0),
            a00 * rr(0, 1) + a01 * rr(1, 1) + a02 * rr(2, 1),
            a00 * rr(0, 2) + a01 * rr(1, 2) + a02 * rr(2, 2),
        ],
        -1,
    )                                                           # (N, 3)
    j_lm_y = jnp.stack(
        [
            a10 * rr(0, 0) + a11 * rr(1, 0) + a12 * rr(2, 0),
            a10 * rr(0, 1) + a11 * rr(1, 1) + a12 * rr(2, 1),
            a10 * rr(0, 2) + a11 * rr(1, 2) + a12 * rr(2, 2),
        ],
        -1,
    )

    chi = ex * ex + ey * ey
    lam = jnp.where(
        chi > kernel_threshold,
        jnp.sqrt(kernel_threshold / jnp.maximum(chi, 1e-30)),
        1.0,
    )
    w = obs_mask.astype(ex.dtype) * in_front.astype(ex.dtype) * lam
    return ex, ey, j_pose_x, j_pose_y, j_lm_x, j_lm_y, w, chi


def _inv3x3(m: Array) -> Array:
    """Batched adjugate 3x3 inverse with Jacobi pre-scaling.

    The raw adjugate overflows f32 when diagonal entries reach ~1e20
    (cofactor products hit f32 max; see ops/pallas/frame_kernel._gn_se3's
    scaled Schur solve) — scale to unit diagonal first, invert, scale back.
    """
    d = jnp.sqrt(jnp.maximum(jnp.stack(
        [m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1), 1e-30))
    s = 1.0 / d
    ms = m * s[..., :, None] * s[..., None, :]
    a, b, c = ms[..., 0, 0], ms[..., 0, 1], ms[..., 0, 2]
    dd, e, f = ms[..., 1, 0], ms[..., 1, 1], ms[..., 1, 2]
    g, h, i = ms[..., 2, 0], ms[..., 2, 1], ms[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - dd * i
    co11 = a * i - c * g
    co12 = c * dd - a * f
    co20 = dd * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * dd
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1.0, det)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], -1),
            jnp.stack([co10, co11, co12], -1),
            jnp.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    inv_s = adj * inv_det[..., None, None]
    return inv_s * s[..., :, None] * s[..., None, :]


def _inv6x6(m: Array) -> Array:
    """Batched 6x6 SPD inverse via the 3x3-block Schur complement (the
    preconditioner blocks; same structure as the PICP kernel's solve)."""
    a = m[..., :3, :3]
    b = m[..., :3, 3:]
    d = m[..., 3:, 3:]
    ai = _inv3x3(a)
    bt = jnp.swapaxes(b, -1, -2)
    s = d - bt @ ai @ b
    si = _inv3x3(s)
    top_left = ai + ai @ b @ si @ bt @ ai
    top_right = -(ai @ b @ si)
    bottom_left = jnp.swapaxes(top_right, -1, -2)
    return jnp.concatenate(
        [
            jnp.concatenate([top_left, top_right], -1),
            jnp.concatenate([bottom_left, si], -1),
        ],
        -2,
    )


class _ReducedSystem(NamedTuple):
    """Everything the CG solve and back-substitution need, O(N + F + L)."""

    h_pp_d: Array      # (F, 6, 6) damped pose blocks (gauge NOT applied)
    b_p: Array         # (F, 6)
    h_ll_inv: Array    # (L, 3, 3) damped landmark block inverses
    b_l: Array         # (L, 3)
    w_rows_x: Array    # (N, 6) sqrt-weighted j_pose rows (x residual)
    w_rows_y: Array    # (N, 6)
    l_rows_x: Array    # (N, 3) sqrt-weighted j_lm rows
    l_rows_y: Array    # (N, 3)
    frame_idx: Array   # (N,) sanitized
    lm_idx: Array      # (N,) sanitized
    precond: Array     # (F, 6, 6) inverse of the exact diagonal of S


def _build_reduced(camera_matrix, problem: SparseBAProblem, damping,
                   kernel_threshold, psum_axis: Optional[str] = None,
                   lm_degree=None):
    """Assemble the reduced system from the observation list.

    With ``psum_axis`` the observation/landmark arrays are one shard and
    the pose-space accumulations (H_pp, b_p, the preconditioner's coupling
    correction, stats) are psum'ed over it.
    """
    f = problem.poses.shape[0]
    l = problem.landmarks.shape[0]
    ex, ey, jpx, jpy, jlx, jly, w, chi = _per_obs_system(
        camera_matrix, problem.poses, problem.landmarks, problem.frame_idx,
        problem.lm_idx, problem.uv, problem.obs_mask, kernel_threshold,
        lm_degree,
    )
    sw = jnp.sqrt(w)[:, None]
    wrx, wry = jpx * sw, jpy * sw           # (N, 6)
    lrx, lry = jlx * sw, jly * sw           # (N, 3)
    fi = jnp.where(problem.obs_mask, problem.frame_idx, f)  # pad -> drop row
    li = jnp.where(problem.obs_mask, problem.lm_idx, l)

    # H_pp[f] = sum_n wrx wrx^T + wry wry^T; (N, 36) segment_sum.
    outer_p = (
        wrx[:, :, None] * wrx[:, None, :] + wry[:, :, None] * wry[:, None, :]
    ).reshape(-1, 36)
    h_pp = _segsum_frame_rows(outer_p, fi, f).reshape(f, 6, 6)
    b_p = _segsum_frame_rows(
        wrx * (ex * jnp.sqrt(w))[:, None] + wry * (ey * jnp.sqrt(w))[:, None],
        fi, f,
    )
    outer_l = (
        lrx[:, :, None] * lrx[:, None, :] + lry[:, :, None] * lry[:, None, :]
    ).reshape(-1, 9)
    h_ll = _segsum_lm(
        outer_l, problem.lm_idx, problem.obs_mask, l, lm_degree
    ).reshape(l, 3, 3)
    b_l = _segsum_lm(
        lrx * (ex * jnp.sqrt(w))[:, None] + lry * (ey * jnp.sqrt(w))[:, None],
        problem.lm_idx, problem.obs_mask, l, lm_degree,
    )

    eye3 = jnp.eye(3, dtype=h_ll.dtype)
    h_ll_inv = _inv3x3(h_ll + damping * eye3)
    eye6 = jnp.eye(6, dtype=h_pp.dtype)

    # Exact diagonal of S: H_pp + lambda - sum_{n in f} W_n Hll^-1 W_n^T,
    # where W_n = wrx_n (x) lrx_n + wry_n (x) lry_n. O(N).
    n_obs = problem.uv.shape[0]
    hinv_n = _gather_lm(
        h_ll_inv, jnp.where(problem.obs_mask, problem.lm_idx, 0), n_obs,
        lm_degree,
    )                                                        # (N, 3, 3)
    w_n = wrx[:, :, None] * lrx[:, None, :] + wry[:, :, None] * lry[:, None, :]
    # Broadcast-sum forms of the batched tiny matmuls.
    y_n = (w_n[:, :, None, :] * hinv_n[:, None, :, :]).sum(-1)   # (N, 6, 3)
    diag_corr = (
        y_n[:, :, None, :] * w_n[:, None, :, :]
    ).sum(-1).reshape(-1, 36)
    diag_corr = _segsum_frame_rows(diag_corr, fi, f).reshape(f, 6, 6)

    chi_sum = jnp.sum(chi * w)
    nobs = jnp.sum((w > 0).astype(jnp.int32))
    if psum_axis is not None:
        h_pp = jax.lax.psum(h_pp, psum_axis)
        b_p = jax.lax.psum(b_p, psum_axis)
        diag_corr = jax.lax.psum(diag_corr, psum_axis)
        chi_sum = jax.lax.psum(chi_sum, psum_axis)
        nobs = jax.lax.psum(nobs, psum_axis)

    h_pp_d = h_pp + damping * eye6
    s_diag = h_pp_d - diag_corr
    # Gauge: pose 0's preconditioner block is identity (its CG coords are
    # projected out anyway).
    s_diag = s_diag.at[0].set(eye6)
    precond = _inv6x6(s_diag)

    sys = _ReducedSystem(
        h_pp_d=h_pp_d, b_p=b_p, h_ll_inv=h_ll_inv, b_l=b_l,
        w_rows_x=wrx, w_rows_y=wry, l_rows_x=lrx, l_rows_y=lry,
        frame_idx=jnp.where(problem.obs_mask, problem.frame_idx, 0),
        lm_idx=jnp.where(problem.obs_mask, problem.lm_idx, 0),
        precond=precond,
    )
    mask_f = jnp.where(problem.obs_mask, 1.0, 0.0)
    return sys, mask_f, chi_sum, nobs


def _coupling_apply(sys: _ReducedSystem, mask_f: Array, v: Array,
                    num_lm: int, psum_axis: Optional[str],
                    lm_degree=None) -> Array:
    """(W Hll^-1 W^T) v, matrix-free in O(N).

    v is (F, 6) replicated; the return is (F, 6) (psum'ed over the lm axis
    when sharded — each shard holds a disjoint set of landmarks and their
    observations, so the per-shard results sum to the global product).
    """
    vf = _gather_frame_rows(v, sys.frame_idx)                 # (N, 6)
    # u_n = W_n^T v_f = lrx (wrx . v) + lry (wry . v)  (3,)
    dx_ = jnp.sum(sys.w_rows_x * vf, axis=1) * mask_f
    dy_ = jnp.sum(sys.w_rows_y * vf, axis=1) * mask_f
    u = sys.l_rows_x * dx_[:, None] + sys.l_rows_y * dy_[:, None]  # (N, 3)
    n = u.shape[0]
    s_l = _segsum_lm(u, sys.lm_idx, mask_f > 0, num_lm, lm_degree)  # (L, 3)
    # broadcast-mul + reduce, NOT einsum: XLA fuses the broadcast form into
    # its neighbours, and this runs once per CG iteration.
    m_l = (sys.h_ll_inv * s_l[:, None, :]).sum(-1)                 # (L, 3)
    mn = _gather_lm(m_l, sys.lm_idx, n, lm_degree)                 # (N, 3)
    # y_n = W_n m = wrx (lrx . m) + wry (lry . m)  (6,)
    cx = jnp.sum(sys.l_rows_x * mn, axis=1) * mask_f
    cy = jnp.sum(sys.l_rows_y * mn, axis=1) * mask_f
    y = sys.w_rows_x * cx[:, None] + sys.w_rows_y * cy[:, None]    # (N, 6)
    out = _segsum_frame_rows(y, sys.frame_idx, sys.h_pp_d.shape[0])
    if psum_axis is not None:
        out = jax.lax.psum(out, psum_axis)
    return out


def _gauge(v: Array) -> Array:
    """Project pose 0's coordinates out (dx_0 = 0 gauge clamp)."""
    return v.at[0].set(0.0)


def _solve_pose_cg(sys: _ReducedSystem, mask_f: Array, num_lm: int,
                   cg_iterations: int, cg_tolerance: float,
                   psum_axis: Optional[str],
                   lm_degree=None) -> Tuple[Array, Array]:
    """Preconditioned CG on S dx = -b_reduced over (F, 6) vectors."""

    def s_apply(v):
        v = _gauge(v)
        hv = (sys.h_pp_d * v[:, None, :]).sum(-1)
        cv = _coupling_apply(sys, mask_f, v, num_lm, psum_axis, lm_degree)
        return _gauge(hv - cv)

    def m_apply(v):
        return _gauge((sys.precond * v[:, None, :]).sum(-1))

    # rhs = -(b_p - W Hll^-1 b_l): fold b_l through the coupling path once.
    # Reuse _coupling_apply structure on b_l directly:
    m_l = (sys.h_ll_inv * sys.b_l[:, None, :]).sum(-1)
    mn = _gather_lm(m_l, sys.lm_idx, sys.w_rows_x.shape[0], lm_degree)
    cx = jnp.sum(sys.l_rows_x * mn, axis=1) * mask_f
    cy = jnp.sum(sys.l_rows_y * mn, axis=1) * mask_f
    y = sys.w_rows_x * cx[:, None] + sys.w_rows_y * cy[:, None]
    b_red = _segsum_frame_rows(y, sys.frame_idx, sys.b_p.shape[0])
    if psum_axis is not None:
        b_red = jax.lax.psum(b_red, psum_axis)
    rhs = _gauge(-(sys.b_p - b_red))

    rhs_norm = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)
    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = m_apply(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(carry):
        it, _, r, _, rz = carry
        # rz <= 0 or non-finite: the f32 system lost positive-definiteness
        # (degenerate geometry) — stop with the best iterate instead of
        # diverging into NaN.
        return (
            (it < cg_iterations)
            & (jnp.sum(r * r) > cg_tolerance ** 2 * rhs_norm)
            & (rz > 0.0)
            & jnp.isfinite(rz)
        )

    def body(carry):
        it, x, r, p, rz = carry
        sp = s_apply(p)
        denom = jnp.sum(p * sp)
        alpha = jnp.where(denom > 0.0, rz / jnp.where(denom == 0.0, 1.0, denom), 0.0)
        x = x + alpha * p
        r = r - alpha * sp
        z = m_apply(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        return it + 1, x, r, p, rz_new

    _, x, r, _, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), x0, r0, p0, rz0))
    rel = jnp.sqrt(jnp.sum(r * r) / rhs_norm)
    return x, rel


def sparse_ba_step(
    camera_matrix: Array,
    problem: SparseBAProblem,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    psum_axis: Optional[str] = None,
    lm_degree=None,
) -> Tuple[SparseBAProblem, SparseBAStats]:
    """One LM/GN step. Memory O(N + F + L); no (F, L) densification.

    Single-device numerical reference; with ``psum_axis`` it is the
    shard-local body of :func:`make_sharded_sparse_ba_step`.
    """
    l = problem.landmarks.shape[0]
    sys, mask_f, chi_sum, nobs = _build_reduced(
        camera_matrix, problem, damping, kernel_threshold, psum_axis,
        lm_degree,
    )
    dx_p, cg_rel = _solve_pose_cg(
        sys, mask_f, l, cg_iterations, cg_tolerance, psum_axis, lm_degree
    )
    # Back-substitute landmarks: dx_l = -Hll^-1 (b_l + W^T dx_p), O(N).
    vf = _gather_frame_rows(dx_p, sys.frame_idx)
    dx_ = jnp.sum(sys.w_rows_x * vf, axis=1) * mask_f
    dy_ = jnp.sum(sys.w_rows_y * vf, axis=1) * mask_f
    u = sys.l_rows_x * dx_[:, None] + sys.l_rows_y * dy_[:, None]
    wt_dx = _segsum_lm(u, sys.lm_idx, mask_f > 0, l, lm_degree)
    dx_l = -(sys.h_ll_inv * (sys.b_l + wt_dx)[:, None, :]).sum(-1)

    new_poses = se3.v2t_euler(dx_p) @ problem.poses
    new_landmarks = problem.landmarks + dx_l
    stats = SparseBAStats(chi=chi_sum, num_obs=nobs, cg_residual=cg_rel)
    return problem._replace(poses=new_poses, landmarks=new_landmarks), stats


@functools.partial(
    jax.jit, static_argnames=("cg_iterations", "lm_degree")
)
def _jitted_step(camera_matrix, problem, damping, kernel_threshold,
                 cg_iterations, cg_tolerance, lm_degree=None):
    return sparse_ba_step(
        camera_matrix, problem, damping=damping,
        kernel_threshold=kernel_threshold, cg_iterations=cg_iterations,
        cg_tolerance=cg_tolerance, lm_degree=lm_degree,
    )


def refine_sparse(
    camera_matrix: Array,
    problem: SparseBAProblem,
    num_iterations: int = 10,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    pack: bool = True,
) -> Tuple[SparseBAProblem, SparseBAStats]:
    """Iterative refinement: host loop over one jitted step (same protocol
    as bundle_adjustment.refine — one compile, reused per iteration).

    ``pack=True`` (default) repacks the observations into the fixed-degree
    lm-major layout first (:func:`pack_problem`) so the LM-side stages run
    scatter-free; the returned problem keeps the CALLER's observation
    layout with the refined poses/landmarks swapped in.
    """
    dmp = jnp.asarray(damping, jnp.float32)
    kt = jnp.asarray(kernel_threshold, jnp.float32)
    tol = jnp.asarray(cg_tolerance, jnp.float32)
    work, degree = (pack_problem(problem) if pack else (problem, None))
    stats = SparseBAStats(
        chi=jnp.zeros(()), num_obs=jnp.zeros((), jnp.int32),
        cg_residual=jnp.zeros(()),
    )
    for _ in range(num_iterations):
        work, stats = _jitted_step(
            camera_matrix, work, dmp, kt, int(cg_iterations), tol,
            lm_degree=degree,
        )
    return (
        problem._replace(poses=work.poses, landmarks=work.landmarks),
        stats,
    )


# --- distribution over the lm mesh axis ----------------------------------


def partition_observations(
    n_shards: int,
    num_landmarks: int,
    frame_idx: np.ndarray,
    lm_idx: np.ndarray,
    uv: np.ndarray,
    obs_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side shard layout: landmarks block-partition over ``n_shards``;
    each observation moves to its landmark's shard with the lm index
    rebased to shard-local coordinates. Shards pad to a common count.

    Returns (frame_idx, local_lm_idx, uv, mask) with leading shard axis
    flattened to shard-major order — reshape to (n_shards, cap, ...) or
    feed directly to the sharded step — plus the per-shard landmark count.
    """
    live = obs_mask.astype(bool)
    l_per = -(-num_landmarks // n_shards)
    shard_of = lm_idx // l_per
    counts = [
        int(np.sum(live & (shard_of == s))) for s in range(n_shards)
    ]
    cap = max(max(counts), 1)
    fi = np.zeros((n_shards, cap), np.int32)
    li = np.zeros((n_shards, cap), np.int32)
    uvs = np.zeros((n_shards, cap, 2), np.float32)
    msk = np.zeros((n_shards, cap), bool)
    for s in range(n_shards):
        sel = live & (shard_of == s)
        n = int(np.sum(sel))
        fi[s, :n] = frame_idx[sel]
        li[s, :n] = lm_idx[sel] - s * l_per
        uvs[s, :n] = uv[sel]
        msk[s, :n] = True
    return (
        fi.reshape(-1),
        li.reshape(-1),
        uvs.reshape(-1, 2),
        msk.reshape(-1),
        l_per,
    )


def partition_observations_packed(
    n_shards: int,
    num_landmarks: int,
    frame_idx: np.ndarray,
    lm_idx: np.ndarray,
    uv: np.ndarray,
    obs_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Shard layout + fixed-degree lm-major packing in one host pass.

    The sharded twin of :func:`pack_problem`: landmarks block-partition
    over ``n_shards`` (l_per per shard) and each shard's observations land
    in packed slots ``(local_lm * degree + rank)`` with a GLOBAL degree
    (max per-landmark observation count), so inside every shard the
    LM-side CG stages are reshape-reduces/broadcasts instead of scatters
    (``pack_problem`` docstring). Returns (frame_idx, local_lm_idx, uv, mask) in
    shard-major order plus (l_per, degree); feed ``degree`` to
    :func:`make_sharded_sparse_ba_step` as ``lm_degree``.
    """
    live = obs_mask.astype(bool)
    l_per = -(-num_landmarks // n_shards)
    counts = np.bincount(lm_idx[live], minlength=num_landmarks)
    degree = max(int(counts.max()) if counts.size else 1, 1)
    cap = l_per * degree
    fi = np.zeros((n_shards, cap), np.int32)
    li = np.tile(
        np.repeat(np.arange(l_per, dtype=np.int32), degree)[None], (n_shards, 1)
    )
    uvs = np.zeros((n_shards, cap, 2), np.float32)
    msk = np.zeros((n_shards, cap), bool)
    order = np.argsort(lm_idx[live], kind="stable")
    lm_sorted = lm_idx[live][order]
    rank = np.arange(len(lm_sorted)) - np.searchsorted(
        lm_sorted, lm_sorted, side="left"
    )
    shard = lm_sorted // l_per
    slot = (lm_sorted - shard * l_per) * degree + rank
    fi[shard, slot] = frame_idx[live][order]
    uvs[shard, slot] = uv[live][order]
    msk[shard, slot] = True
    return (
        fi.reshape(-1),
        li.reshape(-1),
        uvs.reshape(-1, 2),
        msk.reshape(-1),
        l_per,
        degree,
    )


def make_sharded_sparse_ba_step(
    mesh: Mesh,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    lm_axis: str = "lm",
    lm_degree=None,
):
    """Build the jitted landmark-sharded sparse BA step.

    Inputs: poses replicated; landmarks (L_pad, 3) sharded over ``lm_axis``
    (L_pad = shards * l_per from :func:`partition_observations`);
    observation arrays (N_pad,) sharded over ``lm_axis`` in the shard-major
    layout partition_observations produces (each shard's entries reference
    ONLY its local landmarks, lm indices shard-local). With ``lm_degree``
    the observations must instead come from
    :func:`partition_observations_packed` (per-shard fixed-degree lm-major
    slots) — the scatter-free layout every shard's LM stages then use.

    Collectives per step: one psum of (F,6,6)+(F,6)+(F,6,6) at assembly and
    one (F, 6) psum per CG matvec — all O(F).
    """

    def local_step(camera_matrix, poses, landmarks, frame_idx, lm_idx, uv,
                   obs_mask):
        problem = SparseBAProblem(
            poses=poses, landmarks=landmarks, frame_idx=frame_idx,
            lm_idx=lm_idx, uv=uv, obs_mask=obs_mask,
        )
        new_p, stats = sparse_ba_step(
            camera_matrix, problem, damping=damping,
            kernel_threshold=kernel_threshold, cg_iterations=cg_iterations,
            cg_tolerance=cg_tolerance, psum_axis=lm_axis,
            lm_degree=lm_degree,
        )
        return new_p.poses, new_p.landmarks, stats

    in_specs = (
        P(),            # camera matrix
        P(),            # poses replicated
        P(lm_axis),     # landmarks
        P(lm_axis),     # frame_idx
        P(lm_axis),     # lm_idx (shard-local)
        P(lm_axis),     # uv
        P(lm_axis),     # obs_mask
    )
    out_specs = (P(), P(lm_axis), P())

    sharded = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs
    )

    @jax.jit
    def step(camera_matrix, problem: SparseBAProblem):
        poses, landmarks, stats = sharded(
            camera_matrix, problem.poses, problem.landmarks,
            problem.frame_idx, problem.lm_idx, problem.uv, problem.obs_mask,
        )
        return problem._replace(poses=poses, landmarks=landmarks), stats

    return step
