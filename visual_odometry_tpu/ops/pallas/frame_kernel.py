"""The tracking frame loop as one Pallas kernel, compiled through Triton.

The scan form of the pipeline (models/pipeline._track) runs every frame as
a ``lax.scan`` step holding a data-dependent Gauss-Newton ``while_loop``.
On a GPU each GN round of that loop is a handful of small kernel launches
plus a copy of the loop predicate back to the host, with a few kB of work
per round. Here the whole frame loop — world join, Gauss-Newton PICP and
mid-point triangulation — runs inside ONE Pallas program per sequence: an
in-kernel ``fori_loop`` over frames carrying the 12-float pose in
registers, with the GN rounds as an in-kernel ``while_loop`` (same early
exit and ``min_iterations`` contract as ``ops/picp.solve``). Under ``vmap``
the program count becomes the batch, so B independent sequences run as B
blocks spread over the card's SMs (parallel/multiseq).

Reference semantics reproduced (same contracts as models/pipeline.frame_step,
citations therein): the join of vo_complete.cpp:52-66, the solver of
picp_solver.cpp:25-112, the triangulation of utils.cpp:36-134 and the
query-order first-wins correspondence re-encoding of utils.cpp:98.

How the world join avoids gathers inside the kernel. Frame i's world
points are frame i-1's triangulation at the first-wins source lane of each
correspondence. Which source lanes are candidates is pose-independent
(:func:`join_candidates`, plain XLA outside the kernel), and so are the
candidate lanes' pixel rows, which the wrapper gathers ahead of the kernel.
Only the triangulation itself depends on the carried pose, so the kernel
recomputes it for the candidate lanes from those pre-gathered rows: D
extra triangulations per frame (D = ``VOConfig.fused_join_depth``) instead
of a cross-lane gather from registers, which Triton cannot express. The
first tracked frame's sources are known before the kernel starts (the
bootstrap or a resumed state's carried triangulation), so the caller
passes its joined source points in.

First-wins depth: the reference takes the first *successfully
triangulated* hit (vo_complete.cpp:55-63). The chains reproduce that
exactly while no target has more than ``depth`` candidates. This is NOT
assumed silently: :func:`join_candidates` computes one extra level and
flags every lane whose multiplicity exceeds ``depth``
(``JoinCandidates.overflow``); the pipeline surfaces the per-frame count
as ``FrameOutput.join_overflow`` and the product entry points raise on it
(pipeline.FusedJoinDepthError).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

Array = jnp.ndarray

# Rays closer to parallel than this are rejected (ops/triangulation._DET_EPS).
_DET_EPS = 1e-12
# Scalar-parameter row layout (see track_frames): 64 floats.
_N_SCAL = 64
_EYE12 = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
# Warps per program. Measured on an H100 (700 W): 4 warps beat 1 and 2 by
# ~2x at 128 slots and tie 8 at 1024; 16 is slower (PERF.md).
_NUM_WARPS = 4


class JoinCandidates(NamedTuple):
    """Static first-wins candidate chains for the frame-to-frame world join.

    ``idx[i, d, j']`` is the d-th smallest source lane j of frame i-1's
    correspondences with ``src_idx2[j] == dst_idx1[j']``; ``ok`` marks
    existing candidates (target lane valid AND a d-th source exists).
    ``overflow`` marks lanes with more than D candidates, where the
    depth-limited chain can no longer guarantee the reference's
    first-successfully-triangulated join (vo_complete.cpp:55-63)."""

    idx: Array       # (F, D, S) int32 candidate source lane (0 where absent)
    ok: Array        # (F, D, S) bool candidate exists
    overflow: Array  # (F, S) bool multiplicity > D on this lane


def _join_one(src_idx2, src_valid, dst_idx1, dst_valid, depth):
    s = src_idx2.shape[0]
    lanes = jnp.arange(s, dtype=jnp.int32)
    none = jnp.int32(s)
    seg = jnp.where(src_valid, src_idx2, s)   # invalid sources -> dropped
    tgt = jnp.where(dst_valid, dst_idx1, s)
    prev = jnp.full((s + 1,), -1, jnp.int32)
    found, cands = [], []
    for _ in range(depth + 1):
        # Level d: per target, the smallest source lane after level d-1's.
        take = src_valid & (lanes > prev[seg])
        level = jax.ops.segment_min(
            jnp.where(take, lanes, none), seg, num_segments=s + 1
        )
        level = jnp.minimum(level, none)
        c = level[tgt]
        found.append((c < none) & dst_valid)
        cands.append(c)
        prev = level
    return JoinCandidates(
        idx=jnp.stack([jnp.where(f, c, 0) for f, c in zip(found, cands)][:depth]),
        ok=jnp.stack(found[:depth]),
        overflow=found[depth],
    )


def join_candidates(
    src_idx2: Array,   # (F, S) previous frame's correspondence targets
    src_valid: Array,  # (F, S) bool
    dst_idx1: Array,   # (F, S) current frame's reference-side indices
    dst_valid: Array,  # (F, S) bool
    depth: int,
) -> JoinCandidates:
    """Precompute the world-join candidate chains (pure index arithmetic).

    For output lane j' of step i, candidate d is the d-th smallest source
    lane j with ``src_idx2[i, j] == dst_idx1[i, j']`` among valid source
    lanes — the static part of the reference's first-wins join
    (vo_complete.cpp:55-63); the dynamic part (skip candidates whose
    triangulation failed) happens in the tracking kernel. Each level is
    one segment-min over the source lanes keyed by target, so the cost is
    O(D * S) per frame. One extra level feeds ``overflow``.
    """
    return jax.vmap(functools.partial(_join_one, depth=depth))(
        src_idx2.astype(jnp.int32), src_valid,
        dst_idx1.astype(jnp.int32), dst_valid,
    )


def first_valid_join(
    tri: Array,         # (S, 3) source triangulation
    tri_ok: Array,      # (S,) bool
    idx: Array,         # (D, S) candidate source lanes
    ok: Array,          # (D, S) bool
) -> Tuple[Array, Array]:
    """Source points of the first successfully-triangulated candidate.

    The join of a frame whose source triangulation is known before the
    kernel runs (the first tracked frame). Returns ((S, 3) points in the
    source frame's coordinates — the kernel moves them with the carried
    pose, exactly as it moves the sources it triangulates itself — and
    (S,) bool)."""
    have = jnp.zeros(idx.shape[1], bool)
    out = jnp.zeros((idx.shape[1], 3), tri.dtype)
    for d in range(idx.shape[0]):
        ok_d = ok[d] & tri_ok[idx[d]]
        take = ok_d & ~have
        out = jnp.where(take[:, None], tri[idx[d]], out)
        have = have | ok_d
    return out, have


# --- in-kernel math on (S,) lane vectors and scalars --------------------


def _inv3(m):
    """Scalar-form 3x3 inverse via adjugate. m is a 9-tuple, row-major."""
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    return tuple(x * inv_det for x in (A, B, C, D, E, F, G, H, I))


def _mat3mul(m, n):
    """Row-major 9-tuple 3x3 product m @ n."""
    return tuple(
        m[3 * r] * n[c] + m[3 * r + 1] * n[3 + c] + m[3 * r + 2] * n[6 + c]
        for r in range(3) for c in range(3)
    )


def _mat3vec(m, v):
    return tuple(
        m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2]
        for r in range(3)
    )


def _transpose3(m):
    return (m[0], m[3], m[6], m[1], m[4], m[7], m[2], m[5], m[8])


def _rot(p):
    """The rotation block of a row-major 12-tuple [R|t]."""
    return (p[0], p[1], p[2], p[4], p[5], p[6], p[8], p[9], p[10])


def _linearize(k, pose, wx, wy, wz, mx, my, wgt_in, z_near, z_far, cols,
               rows, kt, keep_out):
    """Projection, robust weights and the projection Jacobian rows
    (picp_solver.cpp:25-96, the same expansion as ops/picp.linearize)."""
    r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = pose
    px = r00 * wx + r01 * wy + r02 * wz + t0
    py = r10 * wx + r11 * wy + r12 * wz + t1
    pz = r20 * wx + r21 * wy + r22 * wz + t2
    hx = k[0] * px + k[1] * py + k[2] * pz
    hy = k[3] * px + k[4] * py + k[5] * pz
    hz = k[6] * px + k[7] * py + k[8] * pz
    iz = 1.0 / jnp.where(hz == 0.0, 1.0, hz)
    u = hx * iz
    v = hy * iz
    # hz > 1e-6: minimum-depth guard (see ops/picp.linearize) — at
    # z_near == 0 a point at the pinhole passes the frustum test but its
    # 1/z^2 Jacobian terms overflow f32 and NaN-poison H.
    valid = (
        (pz <= z_far) & (pz >= z_near) & (hz > 1e-6)
        & (u >= 0.0) & (u <= cols - 1.0)
        & (v >= 0.0) & (v <= rows - 1.0)
    )
    ex = u - mx
    ey = v - my
    chi = ex * ex + ey * ey
    is_out = chi > kt
    lam = jnp.where(is_out, jnp.sqrt(kt / jnp.maximum(chi, 1e-30)), 1.0)
    live = wgt_in * valid.astype(jnp.float32)
    w = live * jnp.where(is_out, keep_out, 1.0) * lam
    iz2 = iz * iz
    a = (
        k[0] * iz - k[6] * hx * iz2, k[1] * iz - k[7] * hx * iz2,
        k[2] * iz - k[8] * hx * iz2,
        k[3] * iz - k[6] * hy * iz2, k[4] * iz - k[7] * hy * iz2,
        k[5] * iz - k[8] * hy * iz2,
    )
    inl = live * (1.0 - is_out.astype(jnp.float32))
    stats = (
        jnp.sum(chi * inl),
        jnp.sum(chi * live * is_out.astype(jnp.float32)),
        jnp.sum(inl),
    )
    return (px, py, pz), a, ex, ey, w, stats


def _normal_sums(jx, jy, ex, ey, w):
    """H's upper triangle and b as lane reductions."""
    n = len(jx)
    h = {}
    for i in range(n):
        for j in range(i, n):
            h[(i, j)] = jnp.sum(w * (jx[i] * jx[j] + jy[i] * jy[j]))
    b = tuple(jnp.sum(w * (jx[i] * ex + jy[i] * ey)) for i in range(n))
    return h, b


def _gn_se3(num_iterations, min_iterations, k, pose0, wx, wy, wz, mx, my,
            wgt_in, z_near, z_far, cols, rows, kt, keep_out, damping, tol,
            min_inl):
    """The Gauss-Newton loop over SE(3) on the Euler chart, in-kernel.

    Returns 12 pose scalars then chi_in, chi_out, n_in. The solve is the
    damped 6x6 system via a Jacobi-scaled 3x3-block Schur complement in
    scalars: with S = diag(M)^(-1/2), solve (S M S) y = -S b, dx = S y —
    algebraically the reference's solve, and the unit diagonal keeps every
    adjugate cofactor O(1). ``min_inl`` is the inlier floor of
    picp_solver.cpp:103-107: a round below it applies no update and ends
    the loop. ``min_iterations`` keeps the tolerance exit from firing
    earlier (same contract as ``ops.picp.solve``).
    """

    def cond(carry):
        it, active = carry[0], carry[13]
        return (it < num_iterations) & ((active > 0.5) | (it < min_iterations))

    def body(carry):
        it, pose = carry[0], carry[1:13]
        (px, py, pz), a, ex, ey, w, stats = _linearize(
            k, pose, wx, wy, wz, mx, my, wgt_in, z_near, z_far, cols, rows,
            kt, keep_out,
        )
        a00, a01, a02, a10, a11, a12 = a
        jx = (a00, a01, a02,
              a01 * (-pz) + a02 * py, a00 * pz + a02 * (-px),
              a00 * (-py) + a01 * px)
        jy = (a10, a11, a12,
              a11 * (-pz) + a12 * py, a10 * pz + a12 * (-px),
              a10 * (-py) + a11 * px)
        hm, bv = _normal_sums(jx, jy, ex, ey, w)

        md = tuple(hm[(i, i)] + damping for i in range(6))
        sc = tuple(jax.lax.rsqrt(jnp.maximum(m, 1e-30)) for m in md)

        def se(i, j):
            return hm[(min(i, j), max(i, j))] * sc[i] * sc[j]

        one = jnp.ones_like(md[0])
        A = (one, se(0, 1), se(0, 2),
             se(0, 1), one, se(1, 2),
             se(0, 2), se(1, 2), one)
        B = (se(0, 3), se(0, 4), se(0, 5),
             se(1, 3), se(1, 4), se(1, 5),
             se(2, 3), se(2, 4), se(2, 5))
        D = (one, se(3, 4), se(3, 5),
             se(3, 4), one, se(4, 5),
             se(3, 5), se(4, 5), one)
        r1 = (-bv[0] * sc[0], -bv[1] * sc[1], -bv[2] * sc[2])
        r2 = (-bv[3] * sc[3], -bv[4] * sc[4], -bv[5] * sc[5])
        Ai = _inv3(A)
        Bt = _transpose3(B)
        S = tuple(d - s for d, s in zip(D, _mat3mul(Bt, _mat3mul(Ai, B))))
        Si = _inv3(S)
        t_r2 = tuple(x - y for x, y in zip(r2, _mat3vec(Bt, _mat3vec(Ai, r1))))
        x2 = _mat3vec(Si, t_r2)
        t_r1 = tuple(x - y for x, y in zip(r1, _mat3vec(B, x2)))
        x1 = _mat3vec(Ai, t_r1)
        y = x1 + x2
        enough = stats[2] >= min_inl
        dx = tuple(jnp.where(enough, y[i] * sc[i], 0.0) for i in range(6))
        dx2 = sum(d * d for d in dx)

        # Euler-chart update X <- v2tEuler(dx) X (utils.h:73-78).
        sa, ca = jnp.sin(dx[3]), jnp.cos(dx[3])
        sb, cb = jnp.sin(dx[4]), jnp.cos(dx[4])
        sg, cg = jnp.sin(dx[5]), jnp.cos(dx[5])
        rd = (
            cb * cg, -cb * sg, sb,
            ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb,
            sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb,
        )
        r_new = _mat3mul(rd, _rot(pose))
        t_new = tuple(
            a_ + b_ for a_, b_ in zip(
                _mat3vec(rd, (pose[3], pose[7], pose[11])), dx[:3]
            )
        )
        return (
            it + 1,
            r_new[0], r_new[1], r_new[2], t_new[0],
            r_new[3], r_new[4], r_new[5], t_new[1],
            r_new[6], r_new[7], r_new[8], t_new[2],
            (enough & (dx2 > tol)).astype(jnp.float32),
        ) + stats

    zero = jnp.float32(0.0)
    init = (jnp.int32(0),) + pose0 + (jnp.float32(1.0), zero, zero, zero)
    out = jax.lax.while_loop(cond, body, init)
    return out[1:13] + out[14:17]


def _gn_se2(num_iterations, min_iterations, k, c, c_inv, pose0, wx, wy, wz,
            mx, my, wgt_in, z_near, z_far, cols, rows, kt, keep_out, damping,
            tol, min_inl):
    """The planar (conjugated-SE(2)) Gauss-Newton loop, in-kernel.

    The 3-DoF twin of :func:`_gn_se3`, replicating ``ops.picp_se2.solve_se2``
    (the est_SE2 branch): increments d = (dx, dy, dtheta) act on the
    world-in-camera pose conjugated through the camera mount,
    ``X <- c^-1 T(d) c X``. ``c``/``c_inv`` are the mount [R|t] and its
    inverse as row-major 12-tuples. With q = c X p the point in robot
    coords, d(p_cam)/dd = c_R^T [e_x | e_y | skew(e_z) q], whose camera-
    coord columns are row0(c_R), row1(c_R) and qx*row1 - qy*row0.
    """
    cr0 = (c[0], c[1], c[2])
    cr1 = (c[4], c[5], c[6])
    c_r, ci_r = _rot(c), _rot(c_inv)
    c_t = (c[3], c[7], c[11])
    ci_t = (c_inv[3], c_inv[7], c_inv[11])

    def cond(carry):
        it, active = carry[0], carry[13]
        return (it < num_iterations) & ((active > 0.5) | (it < min_iterations))

    def body(carry):
        it, pose = carry[0], carry[1:13]
        (px, py, pz), a, ex, ey, w, stats = _linearize(
            k, pose, wx, wy, wz, mx, my, wgt_in, z_near, z_far, cols, rows,
            kt, keep_out,
        )
        qx = c[0] * px + c[1] * py + c[2] * pz + c[3]
        qy = c[4] * px + c[5] * py + c[6] * pz + c[7]
        ctx = tuple(qx * b_ - qy * a_ for a_, b_ in zip(cr0, cr1))
        cols3 = (cr0, cr1, ctx)
        jx = tuple(a[0] * m[0] + a[1] * m[1] + a[2] * m[2] for m in cols3)
        jy = tuple(a[3] * m[0] + a[4] * m[1] + a[5] * m[2] for m in cols3)
        hm, bv = _normal_sums(jx, jy, ex, ey, w)

        md = tuple(hm[(i, i)] + damping for i in range(3))
        sc = tuple(jax.lax.rsqrt(jnp.maximum(m, 1e-30)) for m in md)

        def se(i, j):
            return hm[(min(i, j), max(i, j))] * sc[i] * sc[j]

        one = jnp.ones_like(md[0])
        A = (one, se(0, 1), se(0, 2),
             se(0, 1), one, se(1, 2),
             se(0, 2), se(1, 2), one)
        y = _mat3vec(_inv3(A), tuple(-bv[i] * sc[i] for i in range(3)))
        enough = stats[2] >= min_inl
        dx = tuple(jnp.where(enough, y[i] * sc[i], 0.0) for i in range(3))
        dx2 = sum(d * d for d in dx)

        # Conjugated update X <- c^-1 T(d) c X (picp_se2.one_round).
        sth, cth = jnp.sin(dx[2]), jnp.cos(dx[2])
        zero = 0.0 * cth
        tr = (cth, -sth, zero, sth, cth, zero, zero, zero, 1.0 + zero)
        incr_r = _mat3mul(ci_r, _mat3mul(tr, c_r))
        trc = _mat3vec(tr, c_t)
        trc = (trc[0] + dx[0], trc[1] + dx[1], trc[2])
        incr_t = tuple(a_ + b_ for a_, b_ in zip(_mat3vec(ci_r, trc), ci_t))
        r_new = _mat3mul(incr_r, _rot(pose))
        t_new = tuple(
            a_ + b_ for a_, b_ in zip(
                _mat3vec(incr_r, (pose[3], pose[7], pose[11])), incr_t
            )
        )
        return (
            it + 1,
            r_new[0], r_new[1], r_new[2], t_new[0],
            r_new[3], r_new[4], r_new[5], t_new[1],
            r_new[6], r_new[7], r_new[8], t_new[2],
            (enough & (dx2 > tol)).astype(jnp.float32),
        ) + stats

    zero = jnp.float32(0.0)
    init = (jnp.int32(0),) + pose0 + (jnp.float32(1.0), zero, zero, zero)
    out = jax.lax.while_loop(cond, body, init)
    return out[1:13] + out[14:17]


def _triangulate(pose, ik, u1, v1, u2, v2, valid):
    """Mid-point triangulation in the previous frame's coordinates
    (utils.cpp:36-76; ops/triangulation contract). ``pose`` maps the
    previous camera into the current one. Returns (x, y, z, ok) with the
    coordinates zeroed where not ok."""
    rt = _transpose3(_rot(pose))
    it = tuple(-x for x in _mat3vec(rt, (pose[3], pose[7], pose[11])))
    ir_ik = _mat3mul(rt, ik)
    d1x = ik[0] * u1 + ik[1] * v1 + ik[2]
    d1y = ik[3] * u1 + ik[4] * v1 + ik[5]
    d1z = ik[6] * u1 + ik[7] * v1 + ik[8]
    d2x = ir_ik[0] * u2 + ir_ik[1] * v2 + ir_ik[2]
    d2y = ir_ik[3] * u2 + ir_ik[4] * v2 + ir_ik[5]
    d2z = ir_ik[6] * u2 + ir_ik[7] * v2 + ir_ik[8]
    a00 = d1x * d1x + d1y * d1y + d1z * d1z
    a01 = -(d1x * d2x + d1y * d2y + d1z * d2z)
    a11 = d2x * d2x + d2y * d2y + d2z * d2z
    b0 = d1x * it[0] + d1y * it[1] + d1z * it[2]
    b1 = -(d2x * it[0] + d2y * it[1] + d2z * it[2])
    det = a00 * a11 - a01 * a01
    safe_det = jnp.where(jnp.abs(det) < _DET_EPS, 1.0, det)
    s0 = (a11 * b0 - a01 * b1) / safe_det
    s1 = (a00 * b1 - a01 * b0) / safe_det
    vx = 0.5 * (s0 * d1x + it[0] + s1 * d2x)
    vy = 0.5 * (s0 * d1y + it[1] + s1 * d2y)
    vz = 0.5 * (s0 * d1z + it[2] + s1 * d2z)
    # Finiteness guard: a non-finite "valid" triangulation would
    # NaN-poison the next frame's GN reductions through inf * 0.
    ok = (
        valid & (s0 >= 0.0) & (s1 >= 0.0) & (jnp.abs(det) >= _DET_EPS)
        & (jnp.abs(vx) < 1e18) & (jnp.abs(vy) < 1e18) & (jnp.abs(vz) < 1e18)
    )
    # where(), not multiply-by-mask: garbage lanes may be non-finite.
    return (
        jnp.where(ok, vx, 0.0), jnp.where(ok, vy, 0.0),
        jnp.where(ok, vz, 0.0), ok,
    )


def _kernel(
    num_iterations,
    min_iterations,
    depth,
    planar,
    scal_ref,   # (64,): params, K, K^-1, entry pose (+ mount and inverse)
    w0_ref,     # (4, S): first frame's joined source x/y/z + have rows
    pix_ref,    # (F, 5, S): prev u/v, cur u/v, corr-valid rows
    src_ref,    # (F, D, 5, S): frame i-1's rows at frame i's candidates
    tri_ref,    # out (F, 4, S): triangulation x/y/z/ok rows
    stat_ref,   # out (F, 16): pose [R|t], chi_in, chi_out, n_in, n_corr
):
    """One sequence's whole tracking loop (one program; vmap adds more)."""
    f = pix_ref.shape[0]
    z_near, z_far = scal_ref[0], scal_ref[1]
    cols, rows = scal_ref[2], scal_ref[3]
    kt, keep_out = scal_ref[4], scal_ref[5]
    damping, tol = scal_ref[6], scal_ref[7]
    warm, min_inl = scal_ref[8], scal_ref[9]
    k = tuple(scal_ref[10 + j] for j in range(9))
    ik = tuple(scal_ref[19 + j] for j in range(9))
    pose_in = tuple(scal_ref[28 + j] for j in range(12))
    if planar:
        mount = tuple(scal_ref[40 + j] for j in range(12))
        mount_inv = tuple(scal_ref[52 + j] for j in range(12))

    def frame_body(i, pose):
        u1, v1 = pix_ref[i, 0, :], pix_ref[i, 1, :]
        u2, v2 = pix_ref[i, 2, :], pix_ref[i, 3, :]
        cvalid = pix_ref[i, 4, :] > 0.5

        # ---- world join (vo_complete.cpp:52-66) ----
        # Frame i-1's triangulation at each candidate lane, recomputed
        # under the carried pose, first valid candidate wins; the first
        # frame's sources come in precomputed (its candidate rows are all
        # invalid, so no candidate overrides them).
        sx, sy, sz = w0_ref[0, :], w0_ref[1, :], w0_ref[2, :]
        have = (i == 0) & (w0_ref[3, :] > 0.5)
        for d in range(depth):
            tx, ty, tz, ok_d = _triangulate(
                pose, ik, src_ref[i, d, 0, :], src_ref[i, d, 1, :],
                src_ref[i, d, 2, :], src_ref[i, d, 3, :],
                src_ref[i, d, 4, :] > 0.5,
            )
            take = ok_d & ~have
            sx = jnp.where(take, tx, sx)
            sy = jnp.where(take, ty, sy)
            sz = jnp.where(take, tz, sz)
            have = have | take
        # tri_in_prev = x_curr * tri (vo_complete.cpp:159).
        wx = pose[0] * sx + pose[1] * sy + pose[2] * sz + pose[3]
        wy = pose[4] * sx + pose[5] * sy + pose[6] * sz + pose[7]
        wz = pose[8] * sx + pose[9] * sy + pose[10] * sz + pose[11]
        weight = have.astype(jnp.float32)

        # ---- PICP Gauss-Newton (picp_solver.cpp:98-112, early exit) ----
        # Sanitize dead slots like ops.picp.solve: 0 * NaN = NaN would
        # poison the H/b reductions.
        gwx = jnp.where(have, wx, 1.0)
        gwy = jnp.where(have, wy, 1.0)
        gwz = jnp.where(have, wz, 1.0)
        gmx = jnp.where(have, u2, 0.0)
        gmy = jnp.where(have, v2, 0.0)
        pose0 = tuple(jnp.where(warm > 0.5, pose[j], _EYE12[j]) for j in range(12))
        if planar:
            final = _gn_se2(
                num_iterations, min_iterations, k, mount, mount_inv, pose0,
                gwx, gwy, gwz, gmx, gmy, weight, z_near, z_far, cols, rows,
                kt, keep_out, damping, tol, min_inl,
            )
        else:
            final = _gn_se3(
                num_iterations, min_iterations, k, pose0,
                gwx, gwy, gwz, gmx, gmy, weight, z_near, z_far, cols, rows,
                kt, keep_out, damping, tol, min_inl,
            )
        new_pose = final[:12]

        # ---- this frame's triangulation, prev-frame coords ----
        ntx, nty, ntz, new_ok = _triangulate(new_pose, ik, u1, v1, u2, v2, cvalid)
        tri_ref[i, 0, :] = ntx
        tri_ref[i, 1, :] = nty
        tri_ref[i, 2, :] = ntz
        tri_ref[i, 3, :] = new_ok.astype(jnp.float32)
        for j, val in enumerate(final + (jnp.sum(weight),)):
            stat_ref[i, j] = val
        return new_pose

    jax.lax.fori_loop(0, f, frame_body, pose_in)


def track_frames(
    camera_matrix: Array,     # (3, 3)
    cam_params: Array,        # (4,) z_near, z_far, cols, rows
    x_init: Array,            # (4, 4) carried pose entering the loop
    w0_points: Array,         # (S, 3) first frame's joined source points
    w0_valid: Array,          # (S,) bool
    cand: JoinCandidates,     # (F-1, D, S) join chains of frames 1..F-1
    prev_al: Array,           # (F, S, 2) reference pixels, lane-aligned
    cur_al: Array,            # (F, S, 2) current pixels, lane-aligned
    corr_valid: Array,        # (F, S) bool
    num_iterations: int,
    kernel_threshold: float,
    damping: float,
    tolerance: float,
    keep_outliers: bool = False,
    warm_start: bool = False,
    min_num_inliers: float = 0.0,
    min_iterations: int = 1,
    planar: bool = False,
    cam_in_robot: "Array | None" = None,
    interpret: bool = False,
) -> Tuple[Array, Array, Array, Array]:
    """Run the whole F-frame tracking loop in one kernel launch.

    Callers pre-gather the pixel rows (``prev_al[i] = prev_pts[i][idx1[i]]``,
    ``cur_al[i] = cur_pts[i][idx2[i]]``), precompute the join chains with
    :func:`join_candidates` and the first frame's join with
    :func:`first_valid_join`. Returns (poses (F, 4, 4), tri_points
    (F, S, 3), tri_valid (F, S), stats (F, 4) = [chi_inliers,
    chi_outliers, num_inliers, num_solver_corr]) — the contract of
    scanning models/pipeline.frame_step with merge_map=False. vmap over a
    leading axis runs one program per sequence.

    S is padded to a power of two (Triton's block sizes); padded lanes are
    invalid and sliced off. ``planar=True`` runs the conjugated-SE(2)
    solver with ``cam_in_robot`` as the mount (None = identity); callers
    planarize ``x_init``.
    """
    from .. import se3

    f, s = corr_valid.shape
    depth = cand.idx.shape[1]
    sp = max(16, 1 << (s - 1).bit_length())
    f32 = jnp.float32

    pix = jnp.concatenate(
        [
            jnp.swapaxes(prev_al, -1, -2).astype(f32),
            jnp.swapaxes(cur_al, -1, -2).astype(f32),
            corr_valid.astype(f32)[:, None, :],
        ],
        axis=1,
    )                                                     # (F, 5, S)
    # Frame i-1's rows at frame i's candidate lanes; the validity row
    # folds in whether the candidate exists.
    src = jnp.take_along_axis(
        pix[:-1, None, :, :], cand.idx[:, :, None, :], axis=-1
    )                                                     # (F-1, D, 5, S)
    src = src.at[:, :, 4].multiply(cand.ok.astype(f32))
    src = jnp.concatenate([jnp.zeros((1,) + src.shape[1:], f32), src])
    w0 = jnp.concatenate(
        [w0_points.T.astype(f32), w0_valid.astype(f32)[None]]
    )                                                     # (4, S)
    if sp != s:
        pad = [(0, 0)] * 2
        pix = jnp.pad(pix, pad + [(0, sp - s)])
        src = jnp.pad(src, pad + [(0, 0), (0, sp - s)])
        w0 = jnp.pad(w0, [(0, 0), (0, sp - s)])

    mount = jnp.eye(4, dtype=f32) if cam_in_robot is None else jnp.asarray(
        cam_in_robot, f32
    )
    scal = jnp.concatenate(
        [
            cam_params.astype(f32),
            jnp.stack([
                jnp.asarray(kernel_threshold, f32),
                jnp.asarray(1.0 if keep_outliers else 0.0, f32),
                jnp.asarray(damping, f32),
                jnp.asarray(tolerance, f32),
                jnp.asarray(1.0 if warm_start else 0.0, f32),
                jnp.asarray(min_num_inliers, f32),
            ]),
            camera_matrix.reshape(9).astype(f32),
            jnp.linalg.inv(camera_matrix).reshape(9).astype(f32),
            x_init[:3, :4].reshape(12).astype(f32),
            mount[:3, :4].reshape(12),
            se3.inverse(mount)[:3, :4].reshape(12),
        ]
    )
    assert scal.shape == (_N_SCAL,), scal.shape

    tri, stats = pl.pallas_call(
        functools.partial(
            _kernel, int(num_iterations), int(min_iterations), depth,
            bool(planar),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((f, 4, sp), f32),
            jax.ShapeDtypeStruct((f, 16), f32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="vo_frame_loop",
    )(scal, w0, pix, src)

    pose_rows = stats[:, :12].reshape(f, 3, 4)
    bottom = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0, 1.0], f32), (f, 1, 4))
    poses = jnp.concatenate([pose_rows, bottom], axis=1)
    tri_pts = jnp.swapaxes(tri[:, :3, :s], -1, -2)
    tri_ok = tri[:, 3, :s] > 0.5
    return poses, tri_pts, tri_ok, stats[:, 12:16]
