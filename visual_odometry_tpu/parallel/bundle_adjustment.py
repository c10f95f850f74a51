"""Distributed bundle adjustment via landmark-sharded Schur complement.

This subsystem has NO reference counterpart — the reference never refines
jointly over poses and landmarks (its map is the raw last-observation
positions, PointCloud.h:52-66). It is the framework's scaling story per
BASELINE.json's north star and SURVEY.md §5/§7: couple per-shard tracking
through a global refinement whose landmark work is embarrassingly parallel
and whose only cross-chip traffic is one small ``psum`` per iteration.

Problem: minimize the robust reprojection error
    sum_{f,l} rho( || pi(K, X_f, p_l) - z_{f,l} ||^2 )
over camera poses X_f (world->camera) and landmark positions p_l, with a
dense masked observation grid z (F, L, 2).

Levenberg-Marquardt-damped Gauss-Newton step with Schur complement:
  * per-observation Jacobians: J_pose (2,6) exactly as the PICP solver
    (picp_solver.cpp:37-52 structure: Jp K [I | -skew(p_cam)]), and
    J_lm = Jp K R_f (2,3);
  * landmark blocks H_ll (L,3,3), coupling blocks W (F,L,6,3) and the pose
    system are accumulated locally per landmark shard;
  * the reduced pose system
        S  = H_pp + lambda I - sum_l W_l Hll_l^-1 W_l^T     (6F, 6F)
        b~ = b_p - sum_l W_l Hll_l^-1 b_l
    is psum'ed over the ``lm`` mesh axis (the ONLY collective) and solved
    replicated on every chip (F is small; the landmark count is the axis
    that scales);
  * landmark updates back-substitute locally:
        dx_l = -Hll_l^-1 (b_l + W_l^T dx_p).

Gauge: pose 0 is held fixed (its 6x6 block in S is replaced by the
identity and its residual zeroed) — the monocular scale gauge is handled
by LM damping on the landmark blocks.

Pose updates use the same Euler chart as tracking:
``X <- v2tEuler(dx) X`` (utils.h:73-78).

The single-device entry point :func:`ba_step` is the numerical reference;
:func:`make_sharded_ba_step` wraps it in ``shard_map`` over a (dp, lm)
mesh — ``dp`` batches independent sequences, ``lm`` shards landmarks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import se3

Array = jnp.ndarray


class BAProblem(NamedTuple):
    """A bundle-adjustment instance (one sequence)."""

    poses: Array          # (F, 4, 4) world->camera
    landmarks: Array      # (L, 3) world coords
    observations: Array   # (F, L, 2) pixel measurements
    obs_mask: Array       # (F, L) bool


class BAStats(NamedTuple):
    chi: Array            # () total robust chi^2
    num_obs: Array        # () int32 live observations


def _residuals_and_jacobians(
    camera_matrix: Array, poses: Array, landmarks: Array, observations: Array, obs_mask: Array,
    kernel_threshold: float,
):
    """All per-observation quantities, batched over the full (F, L) grid.

    Written as explicit broadcast arithmetic (the same component expansion
    as ops/pallas/frame_kernel.py) instead of batched (2,3)x(3,3) einsums,
    so XLA fuses it elementwise.
    Returns the Jacobian x/y rows separately: j_pose_x/y (F, L, 6),
    j_lm_x/y (F, L, 3).
    """
    r = poses[:, :3, :3]                       # (F, 3, 3)
    t = poses[:, :3, 3]                        # (F, 3)
    k = camera_matrix
    wx, wy, wz = landmarks[:, 0], landmarks[:, 1], landmarks[:, 2]  # (L,)

    def fo(i):  # (F, 1) pose scalars broadcast against (L,)
        return r[:, i // 3, i % 3][:, None]

    px = fo(0) * wx + fo(1) * wy + fo(2) * wz + t[:, 0][:, None]   # (F, L)
    py = fo(3) * wx + fo(4) * wy + fo(5) * wz + t[:, 1][:, None]
    pz = fo(6) * wx + fo(7) * wy + fo(8) * wz + t[:, 2][:, None]

    hx = k[0, 0] * px + k[0, 1] * py + k[0, 2] * pz
    hy = k[1, 0] * px + k[1, 1] * py + k[1, 2] * pz
    hz = k[2, 0] * px + k[2, 1] * py + k[2, 2] * pz

    safe_z = jnp.where(hz == 0.0, 1.0, hz)
    iz = 1.0 / safe_z
    u = hx * iz
    v = hy * iz
    in_front = pz > 1e-3
    ex = u - observations[..., 0]
    ey = v - observations[..., 1]

    # A = Jp K (2, 3) per observation, expanded by component.
    iz2 = iz * iz
    a00 = k[0, 0] * iz - k[2, 0] * hx * iz2
    a01 = k[0, 1] * iz - k[2, 1] * hx * iz2
    a02 = k[0, 2] * iz - k[2, 2] * hx * iz2
    a10 = k[1, 0] * iz - k[2, 0] * hy * iz2
    a11 = k[1, 1] * iz - k[2, 1] * hy * iz2
    a12 = k[1, 2] * iz - k[2, 2] * hy * iz2

    # J_pose = [A | A skew(-p_cam)]:
    # skew(-p) = [[0, pz, -py], [-pz, 0, px], [py, -px, 0]]
    jx3 = a01 * (-pz) + a02 * py
    jx4 = a00 * pz + a02 * (-px)
    jx5 = a00 * (-py) + a01 * px
    jy3 = a11 * (-pz) + a12 * py
    jy4 = a10 * pz + a12 * (-px)
    jy5 = a10 * (-py) + a11 * px
    j_pose_x = jnp.stack([a00, a01, a02, jx3, jx4, jx5], -1)   # (F, L, 6)
    j_pose_y = jnp.stack([a10, a11, a12, jy3, jy4, jy5], -1)

    # J_lm = A R_f (2, 3): contract A's 3-axis with R rows, expanded.
    def rr(i, j):
        return r[:, i, j][:, None]

    j_lm_x = jnp.stack(
        [
            a00 * rr(0, 0) + a01 * rr(1, 0) + a02 * rr(2, 0),
            a00 * rr(0, 1) + a01 * rr(1, 1) + a02 * rr(2, 1),
            a00 * rr(0, 2) + a01 * rr(1, 2) + a02 * rr(2, 2),
        ],
        -1,
    )                                                           # (F, L, 3)
    j_lm_y = jnp.stack(
        [
            a10 * rr(0, 0) + a11 * rr(1, 0) + a12 * rr(2, 0),
            a10 * rr(0, 1) + a11 * rr(1, 1) + a12 * rr(2, 1),
            a10 * rr(0, 2) + a11 * rr(1, 2) + a12 * rr(2, 2),
        ],
        -1,
    )

    chi = ex * ex + ey * ey                      # (F, L)
    lam = jnp.where(
        chi > kernel_threshold, jnp.sqrt(kernel_threshold / jnp.maximum(chi, 1e-30)), 1.0
    )
    w = obs_mask.astype(ex.dtype) * in_front.astype(ex.dtype) * lam
    return ex, ey, j_pose_x, j_pose_y, j_lm_x, j_lm_y, w, chi


def _assemble(camera_matrix, poses, landmarks, observations, obs_mask, kernel_threshold):
    ex, ey, jpx, jpy, jlx, jly, w, chi = _residuals_and_jacobians(
        camera_matrix, poses, landmarks, observations, obs_mask, kernel_threshold
    )
    ww = w[..., None]
    # H_pp[f] = Σ_l w (jxᵀjx + jyᵀjy): batched (6, L)x(L, 6) matmuls.
    h_pp = jnp.einsum("flj,fli->fij", jpx, jpx * ww) + jnp.einsum(
        "flj,fli->fij", jpy, jpy * ww
    )                                                           # (F, 6, 6)
    b_p = jnp.einsum("fli,fl->fi", jpx, ex * w) + jnp.einsum("fli,fl->fi", jpy, ey * w)
    # H_ll[l] = Σ_f w (kxᵀkx + kyᵀky): batched (3, F)x(F, 3) over L.
    h_ll = jnp.einsum("flj,fli->lij", jlx, jlx * ww) + jnp.einsum(
        "flj,fli->lij", jly, jly * ww
    )                                                           # (L, 3, 3)
    b_l = jnp.einsum("fli,fl->li", jlx, ex * w) + jnp.einsum("fli,fl->li", jly, ey * w)
    # W[f, l] = w (jxᵀ⊗kx + jyᵀ⊗ky): broadcast outer products, no matmul.
    w_pl = (jpx * ww)[..., :, None] * jlx[..., None, :] + (jpy * ww)[..., :, None] * jly[
        ..., None, :
    ]                                                           # (F, L, 6, 3)
    stats = BAStats(
        chi=jnp.sum(chi * w), num_obs=jnp.sum((w > 0).astype(jnp.int32))
    )
    return h_pp, b_p, h_ll, b_l, w_pl, stats


def _inv3x3(m: Array) -> Array:
    """Closed-form batched 3x3 inverse (adjugate / det).

    The adjugate form is pure fused elementwise math over the batch, where
    ``jnp.linalg.inv`` runs a pivoted LU per tiny matrix.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
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
    return adj * inv_det[..., None, None]


def _schur_contributions(h_ll, b_l, w_pl, damping):
    """Per-landmark-shard pieces of the reduced pose system.

    Returns the inverse landmark blocks, the reduced coupling as one
    (6F, 6F) matrix (a single MXU matmul over the 3L contraction axis) and
    the reduced rhs.
    """
    f = w_pl.shape[0]
    l = h_ll.shape[0]
    h_ll_d = h_ll + damping * jnp.broadcast_to(jnp.eye(3, dtype=h_ll.dtype), h_ll.shape)
    h_ll_inv = _inv3x3(h_ll_d)                               # (L, 3, 3)
    # Y[f, l] = W[f, l] Hll_l^-1 (F, L, 6, 3): broadcast-sum over the inner
    # 3-axis instead of a batched tiny matmul.
    y = jnp.sum(
        w_pl[..., :, :, None] * h_ll_inv[None, :, None, :, :], axis=-2
    )
    # S_red(6F, 6F) = Ym Wmᵀ with the (l, k) axes flattened to one 3L
    # contraction — a plain matmul instead of a 6-index einsum.
    ym = jnp.transpose(y, (0, 2, 1, 3)).reshape(6 * f, 3 * l)
    wm = jnp.transpose(w_pl, (0, 2, 1, 3)).reshape(6 * f, 3 * l)
    s_red = ym @ wm.T
    b_red = jnp.einsum("flik,lk->fi", y, b_l)                # (F, 6)
    return h_ll_inv, s_red, b_red


def _solve_pose_system(h_pp, b_p, s_red, b_red, damping, fix_first: bool = True):
    f = h_pp.shape[0]
    big4 = (-s_red).reshape(f, 6, f, 6)
    idx = jnp.arange(f)
    big4 = big4.at[idx, :, idx, :].add(
        h_pp + damping * jnp.broadcast_to(jnp.eye(6, dtype=h_pp.dtype), h_pp.shape)
    )
    big = big4.reshape(6 * f, 6 * f)
    rhs = (b_p - b_red).reshape(6 * f)
    if fix_first:
        # Gauge: clamp pose 0 (dx_0 = 0).
        mask = jnp.arange(6 * f) >= 6
        big = jnp.where(mask[:, None] & mask[None, :], big, 0.0)
        big = big + jnp.diag(jnp.where(mask, 0.0, 1.0))
        rhs = jnp.where(mask, rhs, 0.0)
    dx = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(big), -rhs)
    return dx.reshape(f, 6)


def ba_step(
    camera_matrix: Array,
    problem: BAProblem,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    fix_first: bool = True,
) -> Tuple[BAProblem, BAStats]:
    """One LM/GN step on a single device (numerical reference)."""
    h_pp, b_p, h_ll, b_l, w_pl, stats = _assemble(
        camera_matrix, problem.poses, problem.landmarks,
        problem.observations, problem.obs_mask, kernel_threshold,
    )
    h_ll_inv, s_red, b_red = _schur_contributions(h_ll, b_l, w_pl, damping)
    dx_p = _solve_pose_system(h_pp, b_p, s_red, b_red, damping, fix_first)
    # Back-substitute landmarks: dx_l = -Hll^-1 (b_l + W^T dx_p)
    wt_dx = jnp.einsum("flij,fi->lj", w_pl, dx_p)
    dx_l = -jnp.einsum("lij,lj->li", h_ll_inv, b_l + wt_dx)

    new_poses = se3.v2t_euler(dx_p) @ problem.poses
    new_landmarks = problem.landmarks + dx_l
    return problem._replace(poses=new_poses, landmarks=new_landmarks), stats


def make_sharded_ba_step(
    mesh: Mesh,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    lm_axis: str = "lm",
    dp_axis: Optional[str] = "dp",
):
    """Build the jitted multi-chip BA step over a (dp, lm) mesh.

    Input arrays carry a leading batch axis (sequences) sharded over
    ``dp_axis``; landmarks/observations are sharded over ``lm_axis``.
    Returns ``step(camera_matrix, problem) -> (problem, stats)``.
    """

    def local_step(camera_matrix, poses, landmarks, observations, obs_mask):
        # Everything below runs per (dp shard, lm shard); psum over lm
        # assembles the global reduced system.
        h_pp, b_p, h_ll, b_l, w_pl, stats = _assemble(
            camera_matrix, poses, landmarks, observations, obs_mask, kernel_threshold
        )
        h_ll_inv, s_red, b_red = _schur_contributions(h_ll, b_l, w_pl, damping)
        h_pp = jax.lax.psum(h_pp, lm_axis)
        b_p = jax.lax.psum(b_p, lm_axis)
        s_red = jax.lax.psum(s_red, lm_axis)
        b_red = jax.lax.psum(b_red, lm_axis)
        dx_p = _solve_pose_system(h_pp, b_p, s_red, b_red, damping)
        wt_dx = jnp.einsum("flij,fi->lj", w_pl, dx_p)
        dx_l = -jnp.einsum("lij,lj->li", h_ll_inv, b_l + wt_dx)
        new_poses = se3.v2t_euler(dx_p) @ poses
        stats = BAStats(
            chi=jax.lax.psum(stats.chi, lm_axis),
            num_obs=jax.lax.psum(stats.num_obs, lm_axis),
        )
        return new_poses, landmarks + dx_l, stats

    # Per-sequence function vmapped over the dp batch inside each shard.
    def batched(camera_matrix, poses, landmarks, observations, obs_mask):
        return jax.vmap(local_step, in_axes=(None, 0, 0, 0, 0))(
            camera_matrix, poses, landmarks, observations, obs_mask
        )

    dp = dp_axis if dp_axis else None
    in_specs = (
        P(),                      # camera matrix replicated
        P(dp),                    # poses (B, F, 4, 4)
        P(dp, lm_axis),           # landmarks (B, L, 3)
        P(dp, None, lm_axis),     # observations (B, F, L, 2)
        P(dp, None, lm_axis),     # obs mask (B, F, L)
    )
    out_specs = (P(dp), P(dp, lm_axis), P(dp))

    sharded = jax.shard_map(batched, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    @jax.jit
    def step(camera_matrix, problem: BAProblem) -> Tuple[BAProblem, BAStats]:
        poses, landmarks, stats = sharded(
            camera_matrix,
            problem.poses,
            problem.landmarks,
            problem.observations,
            problem.obs_mask,
        )
        return problem._replace(poses=poses, landmarks=landmarks), stats

    return step


@jax.jit
def _jitted_step(camera_matrix, problem, damping, kernel_threshold):
    return ba_step(camera_matrix, problem, damping, kernel_threshold)


def refine(
    camera_matrix: Array,
    problem: BAProblem,
    num_iterations: int = 10,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
) -> Tuple[BAProblem, BAStats]:
    """Iterative refinement: host loop over one jitted LM/GN step.

    One step compiles once and is reused every iteration; wrapping the whole
    loop in a single fori_loop program instead compiles for minutes and
    forces materialization of the big (F, L, 6, 3) coupling intermediates
    between iterations.
    """
    dmp = jnp.asarray(damping, jnp.float32)
    kt = jnp.asarray(kernel_threshold, jnp.float32)
    stats = BAStats(chi=jnp.zeros(()), num_obs=jnp.zeros((), jnp.int32))
    for _ in range(num_iterations):
        problem, stats = _jitted_step(camera_matrix, problem, dmp, kt)
    return problem, stats
