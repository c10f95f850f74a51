"""Sequence-parallel tracking: chunked VO + pose-graph scale stitching.

The reference's frame loop is strictly serial with a carried pose
(``/root/reference/src/apps/vo_complete.cpp:150-179``) — the "long
sequence" axis of this workload (SURVEY.md §5). The way to parallelize ONE
long sequence is the VO analogue of context parallelism:

  1. split the F-frame sequence into C overlapping chunks;
  2. track every chunk INDEPENDENTLY (each chunk re-runs the two-view
     bootstrap of vo_complete.cpp:95-148 on its own first frame pair) —
     a ``vmap`` over chunks on one chip, or chunks sharded across the
     mesh's sequence axis with zero cross-device traffic during tracking;
  3. stitch the per-chunk relative-pose streams back into one trajectory.

Stitching is where the pose-graph lives. Monocular VO is scale-free
(SURVEY.md §6 gotcha 3): each chunk's bootstrap fixes an ARBITRARY scale,
so consecutive chunks agree on the relative rotations over their overlap
but differ by one scalar scale. For every chunk boundary we estimate that
scale as the masked median of translation-norm ratios over the overlap's
shared PICP poses (the same median-of-ratios estimator the reference's
evaluation uses for its global scale, ``evaluate.cpp:43``), chain the
scales cumulatively, and splice each chunk's exclusive pose range —
discarding every chunk's noisier 8-point bootstrap poses, which the
previous chunk's PICP poses cover.

The landmark map is folded exactly like the serial pipeline
(models/pipeline._run): each chunk's triangulations are rescaled into the
global scale, transformed into frame-0 coords via the stitched chains and
merged in observation order with ONE sort-based ``merge_stream`` pass.
Appearances are opaque landmark keys carried verbatim (PointCloud.h:56
semantics), so re-observations of a landmark across different chunks
dedup exactly.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import landmark_map, pipeline
from ..models.landmark_map import LandmarkMap
from ..ops import epipolar, matching, se3
from ..ops.camera import Camera
from ..utils.config import VOConfig

Array = jnp.ndarray

_EPS = 1e-8
# Overlap poses whose translation norm is below this fraction of the
# overlap's largest norm carry no usable scale information (pure-rotation /
# stationary frames: the norms are solver noise, their ratio is garbage).
_MOTION_FRACTION = 0.2
# Absolute translation-norm floor for a pose to count as "moving" in the
# scale-ratio fallback: converged-GN noise on stationary frames is ~1e-7,
# real per-frame baselines are >= 1e-2 at any sane monocular scale.
_MIN_MOTION = 1e-4


class StitchError(RuntimeError):
    """A chunk boundary's monocular stitch scale is unobservable.

    Raised when a boundary's overlap yields zero usable scale samples —
    neither shared valid triangulations nor moving poses — so the median
    ratio (and every downstream chunk's gauge) would be arbitrary. The
    chunked analogue of the serial bootstrap's hard failure
    (pipeline.BootstrapError / epipolar_utils.cpp:104-108)."""


class PoseGraphDiagnostics(NamedTuple):
    scales: Array           # (C,) cumulative per-chunk scale (chunk 0 = 1)
    rot_consistency: Array  # (C-1,) mean trace(I - Ra^T Rb) over each overlap
    num_ratio_obs: Array    # (C-1,) int32 usable ratio samples per boundary
    join_overflow: Array    # () int32 total fused world-join depth overflows
    #   across all chunks/frames (pipeline.FrameOutput.join_overflow summed;
    #   0 on the scan backend). run_sequence_chunked hard-errors on nonzero.


def plan_chunks(
    num_frames: int,
    num_chunks: int,
    overlap: int,
    scores: Optional[np.ndarray] = None,
    slack: int = 0,
) -> Tuple[Tuple[int, ...], int]:
    """Static chunking plan: (chunk start frames, chunk length).

    Chunks are stride-spaced with the LAST chunk end-aligned, so every
    frame is covered and consecutive chunks share >= ``overlap`` frames.
    ``overlap`` must be >= 3: each boundary needs at least one shared
    PICP-tracked relative pose (local pose index >= 2 in both chunks) for
    the scale estimate.

    With ``scores`` (one two-view bootstrap-conditioning score per
    consecutive frame pair, see :func:`bootstrap_scores`) and ``slack`` > 0,
    every chunk is lengthened by ``slack`` frames and its start slides
    EARLIER by up to ``slack`` to the best-scoring bootstrap pair in its
    window. Sliding back only grows the overlaps, so coverage and the
    >=overlap guarantee are preserved; the payoff is that no chunk is
    forced to bootstrap inside a pure-rotation / stationary segment, where
    the 8-point translation (and hence the chunk's monocular scale) is
    degenerate (E = Rᵀskew(t) -> 0 as t -> 0).
    """
    if num_chunks < 1:
        raise ValueError("num_chunks must be >= 1")
    if num_chunks == 1:
        return (0,), num_frames
    if overlap < 3:
        raise ValueError("overlap must be >= 3 (need shared PICP poses)")
    slack = max(int(slack), 0)
    stride = -(-(num_frames - overlap) // num_chunks)  # ceil
    chunk_len = stride + overlap + slack
    if chunk_len < 4 or chunk_len > num_frames:
        raise ValueError(
            f"cannot split {num_frames} frames into {num_chunks} chunks "
            f"with overlap {overlap} + slack {slack} (chunk_len={chunk_len})"
        )
    nominal = [c * stride for c in range(num_chunks - 1)]
    nominal.append(num_frames - chunk_len)
    starts = []
    for c, nom in enumerate(nominal):
        nom = max(nom, 0)
        if scores is None or slack == 0 or c == 0:
            # chunk 0 anchors the global frame at frame 0.
            starts.append(nom)
            continue
        if c == num_chunks - 1:
            # The last chunk may only slide LATER: sliding earlier would
            # leave the final frames uncovered. Sliding later keeps its
            # overlap with the previous chunk >= ``overlap`` (the nominal
            # overlap includes the slack) and past-the-end frames are
            # handled by the clamped gather (repeated last frame, inert).
            window = range(nom, min(nom + slack, num_frames - 4) + 1)
        else:
            window = range(max(nom - slack, 0), nom + 1)
        starts.append(max(window, key=lambda s: float(scores[s])))
    if any(b <= a for a, b in zip(starts, starts[1:])):
        raise ValueError("chunk starts not increasing; use fewer chunks")
    return tuple(starts), chunk_len


@jax.jit
def bootstrap_scores(
    points: Array,        # (F, S, 2)
    appearances: Array,   # (F, S, D)
    masks: Array,         # (F, S)
    match_radius: Array = 0.1,
) -> Array:
    """Two-view bootstrap-conditioning score per consecutive frame pair.

    Masked median homography transfer residual
    (ops/epipolar.homography_transfer_residuals) over the pair's appearance
    matches: ~0 for pure-rotation / stationary pairs (degenerate monocular
    bootstrap), large when there is real parallax. Pairs with < 8 usable
    matches score 0 (the 8-point algorithm needs them,
    epipolar_utils.cpp:104-108).
    """

    def one(p1, a1, m1, p2, a2, m2):
        corr = matching.match_appearances(a1, m1, a2, m2, match_radius)
        res, ok = epipolar.homography_transfer_residuals(
            corr.idx1, corr.idx2, corr.valid, p1, p2, m1, m2
        )
        med, cnt = _masked_median(res, ok)
        return jnp.where(cnt >= 8, med, 0.0)

    return jax.vmap(one)(
        points[:-1], appearances[:-1], masks[:-1],
        points[1:], appearances[1:], masks[1:],
    )


def _masked_median(values: Array, valid: Array) -> Tuple[Array, Array]:
    """(median over valid entries | 1.0 if none, count). Static-size sort."""
    cnt = jnp.sum(valid.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, values.dtype)
    sorted_vals = jnp.sort(jnp.where(valid, values, big))
    idx = jnp.maximum(cnt - 1, 0) // 2
    med = sorted_vals[idx]
    return jnp.where(cnt > 0, med, jnp.ones((), values.dtype)), cnt


def _scale_translations(poses: Array, s: Array) -> Array:
    """Scale the translation part of a (..., 4, 4) pose stack by scalar s."""
    return poses.at[..., :3, 3].multiply(s)


@functools.partial(
    jax.jit,
    static_argnames=("config", "use_known_da", "starts", "chunk_len", "num_frames"),
)
def _track_and_stitch(
    camera: Camera,
    config: VOConfig,
    cpoints: Array,        # (C, L, S, 2) chunked frames
    capps: Array,          # (C, L, S, D)
    cmasks: Array,         # (C, L, S)
    cids: Array,           # (C, L, S)
    starts: Tuple[int, ...],
    chunk_len: int,
    num_frames: int,
    use_known_da: bool,
) -> Tuple[Array, LandmarkMap, PoseGraphDiagnostics]:
    c = len(starts)
    length = chunk_len
    s_slots = config.n_slots
    d = capps.shape[-1]

    # --- 1. track every chunk independently (batched / sharded) ---
    def one(p, a, m, i):
        return pipeline._track(camera, config, p, a, m, i, use_known_da)

    x_init_c, outs_c, init_tri0 = jax.vmap(one)(cpoints, capps, cmasks, cids)

    # Per-chunk LOCAL relative-pose trajectories, entries 0..L-1:
    # entry 0 = identity, entry 1 = the chunk's bootstrap, then PICP poses.
    eye = jnp.broadcast_to(jnp.eye(4, dtype=cpoints.dtype), (c, 1, 4, 4))
    trajs = jnp.concatenate([eye, x_init_c[:, None], outs_c.pose], axis=1)

    # --- 2. chain the per-boundary scales (pose-graph scale alignment) ---
    # Scale observable: over the overlap both chunks triangulate the SAME
    # measurement pairs (correspondences depend only on the frame data, so
    # triangulation slots align exactly across chunks), and a frame's
    # triangulation lives in the previous frame's camera coords at the
    # chunk's LOCAL bootstrap scale — so each shared landmark's norm ratio
    # IS the boundary's scale ratio. That gives O(overlap * landmarks)
    # samples per boundary and stays observable through stationary /
    # pure-rotation overlap frames (where the pose-translation-ratio
    # estimator, kept below as a fallback, has zero usable samples).
    scales = [jnp.ones((), cpoints.dtype)]
    rot_errs = []
    counts = []
    for ci in range(1, c):
        ov_lo = starts[ci] + 2                 # first shared PICP entry
        ov_hi = min(starts[ci - 1] + length, num_frames)  # one past the overlap
        ja, jb = ov_lo - starts[ci - 1] - 2, 2 - 2
        n_ov = ov_hi - ov_lo
        tri_a = jax.lax.slice_in_dim(outs_c.tri_points[ci - 1], ja, ja + n_ov, axis=0)
        tri_b = jax.lax.slice_in_dim(outs_c.tri_points[ci], jb, jb + n_ov, axis=0)
        ok_a = jax.lax.slice_in_dim(outs_c.tri_valid[ci - 1], ja, ja + n_ov, axis=0)
        ok_b = jax.lax.slice_in_dim(outs_c.tri_valid[ci], jb, jb + n_ov, axis=0)
        lna = jnp.linalg.norm(tri_a, axis=-1).reshape(-1)
        lnb = jnp.linalg.norm(tri_b, axis=-1).reshape(-1)
        lok = (ok_a & ok_b).reshape(-1) & (lnb > _EPS)
        lm_ratio, lm_cnt = _masked_median(lna / jnp.maximum(lnb, _EPS), lok)

        a = jax.lax.slice_in_dim(
            trajs[ci - 1], ov_lo - starts[ci - 1], ov_hi - starts[ci - 1], axis=0
        )
        b = jax.lax.slice_in_dim(trajs[ci], 2, ov_hi - starts[ci], axis=0)
        na = jnp.linalg.norm(a[:, :3, 3], axis=-1)
        nb = jnp.linalg.norm(b[:, :3, 3], axis=-1)
        # Pose-ratio fallback: stationary overlap frames carry no scale
        # information — their norms are solver noise, so gate RELATIVE to
        # the overlap's real motion, not with an absolute epsilon.
        # Absolute floor on top of the relative gate: on a fully stationary
        # overlap max(na) is pure solver noise (~1e-7) and the relative
        # gate alone would pass noise samples; filtering them lets
        # num_ratio_obs honestly report 0 so run_sequence_chunked can
        # raise StitchError instead of stitching with a noise ratio.
        pok = (
            (na > jnp.maximum(_MOTION_FRACTION * jnp.max(na), _MIN_MOTION))
            & (nb > jnp.maximum(_MOTION_FRACTION * jnp.max(nb), _MIN_MOTION))
        )
        p_ratio, p_cnt = _masked_median(na / jnp.maximum(nb, _EPS), pok)

        ratio = jnp.where(lm_cnt >= 8, lm_ratio, p_ratio)
        cnt = jnp.where(lm_cnt >= 8, lm_cnt, p_cnt)
        scales.append(scales[-1] * ratio)
        # Rotations are scale-free: their overlap disagreement is the
        # stitching-quality diagnostic (same e_theta form as evaluate.cpp:34).
        rtr = jnp.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
        rot_errs.append(
            jnp.mean(3.0 - jnp.trace(rtr, axis1=-2, axis2=-1))
        )
        counts.append(cnt)

    # --- 3. splice the global relative-pose trajectory ---
    # Chunk ci owns global pose entries [e_ci, e_{ci+1}) where e_0 = 0 and
    # e_ci = starts[ci-1] + L (the first frame past the previous chunk);
    # every chunk's own entries start at local index e_ci - starts[ci] >= 2,
    # i.e. bootstrap poses of chunks >= 1 are never used.
    pieces = []
    for ci in range(c):
        lo = 0 if ci == 0 else min(starts[ci - 1] + length, num_frames)
        hi = num_frames if ci == c - 1 else min(starts[ci] + length, num_frames)
        seg = jax.lax.slice_in_dim(
            trajs[ci], lo - starts[ci], hi - starts[ci], axis=0
        )
        pieces.append(_scale_translations(seg, scales[ci]))
    trajectory = jnp.concatenate(pieces, axis=0)

    # --- 4. fold ONE global landmark map from all chunks' observations ---
    # chains[j] maps frame-j camera coords -> frame-0 coords (globally
    # scaled), exactly the serial pipeline's ``history`` chain.
    inv_rel = jax.vmap(se3.inverse)(trajectory[1:])
    chains = jnp.concatenate(
        [
            jnp.eye(4, dtype=cpoints.dtype)[None],
            jax.lax.associative_scan(jnp.matmul, inv_rel),
        ],
        axis=0,
    )  # (F, 4, 4)

    stream_pts = [init_tri0.points[0]]     # chunk 0 bootstrap, frame-0 coords
    stream_apps = [init_tri0.apps[0]]
    stream_mask = [init_tri0.valid[0]]
    for ci in range(c):
        # The chunk's tracked frames it is responsible for: global frames
        # [max(e_ci, starts[ci]+2), e_{ci+1}); outs index j tracks global
        # frame starts[ci] + 2 + j, its triangulation lives in the PREVIOUS
        # frame's coords at the chunk's LOCAL scale.
        lo = max(
            0 if ci == 0 else min(starts[ci - 1] + length, num_frames),
            starts[ci] + 2,
        )
        hi = num_frames if ci == c - 1 else min(starts[ci] + length, num_frames)
        j0, j1 = lo - starts[ci] - 2, hi - starts[ci] - 2
        tri = jax.lax.slice_in_dim(outs_c.tri_points[ci], j0, j1, axis=0)
        apps = jax.lax.slice_in_dim(outs_c.tri_apps[ci], j0, j1, axis=0)
        ok = jax.lax.slice_in_dim(outs_c.tri_valid[ci], j0, j1, axis=0)
        ch = jax.lax.slice_in_dim(chains, lo - 1, hi - 1, axis=0)
        tri_world = jax.vmap(se3.transform_points)(ch, tri * scales[ci])
        stream_pts.append(tri_world.reshape(-1, 3))
        stream_apps.append(apps.reshape(-1, d))
        stream_mask.append(ok.reshape(-1))
    final_map = landmark_map.merge_stream(
        jnp.concatenate(stream_pts),
        jnp.concatenate(stream_apps),
        jnp.concatenate(stream_mask),
        config.map_capacity,
    )

    join_ovf = jnp.sum(outs_c.join_overflow)
    if c > 1:
        diags = PoseGraphDiagnostics(
            scales=jnp.stack(scales),
            rot_consistency=jnp.stack(rot_errs),
            num_ratio_obs=jnp.stack(counts),
            join_overflow=join_ovf,
        )
    else:
        diags = PoseGraphDiagnostics(
            scales=jnp.ones((1,), cpoints.dtype),
            rot_consistency=jnp.zeros((0,), cpoints.dtype),
            num_ratio_obs=jnp.zeros((0,), jnp.int32),
            join_overflow=join_ovf,
        )
    return trajectory, final_map, diags


@functools.partial(jax.jit, static_argnames=("starts", "chunk_len"))
def _chunk(frames: Array, starts: Tuple[int, ...], chunk_len: int) -> Array:
    f = frames.shape[0]
    # Clamped gather: a slack-extended chunk may nominally run past the end
    # of the sequence; the repeated last frame has zero parallax, so its
    # poses/triangulations are inert and the splice discards them anyway.
    idx = np.minimum(np.add.outer(np.asarray(starts), np.arange(chunk_len)), f - 1)
    return frames[idx]


def refine_stitched(
    camera: Camera,
    config: VOConfig,
    trajectory: Array,
    map_state: LandmarkMap,
    points: Array,
    appearances: Array,
    masks: Array,
    num_iterations: int = 5,
    mesh: Optional[Mesh] = None,
) -> Tuple[Array, LandmarkMap]:
    """Pose-graph/BA relaxation of a stitched chunked trajectory.

    The per-boundary scale stitch is statistical; its residual (~1% scale
    error per boundary) moves position RMSE within a +-0.02 band of the
    serial result depending on the chunk count. Bundle adjustment over the
    stitched trajectory + merged map absorbs exactly that disagreement:
    every chunk's poses are re-coupled through the shared landmarks, so
    the boundary seams (and the per-chunk scale-chain noise) relax away.
    Measured on example_data: every chunk count in 2..6 converges to RMSE
    0.1407 after 5 iterations (serial tracking: 0.141, reference baseline
    0.1453 — evaluate.cpp:43-53 metric).

    Honors ``config.refine_backend`` exactly like the serial path
    (apps.run_vo_complete): "dense" builds the (F, L) observation grid and
    runs the direct-Schur BA (parallel/bundle_adjustment), "sparse" the COO
    matrix-free Schur-CG path (parallel/sparse_ba) — required for
    large-map chunked runs. With ``mesh`` the reduction runs sharded over
    its ``lm`` axis; a sequence-parallel mesh without an ``lm`` axis (the
    documented ('dp',)-only SP mesh) refines single-device instead of
    raising a KeyError inside the sharded BA step.
    """
    import numpy as np_mod

    from ..models import landmark_map as lm_mod
    from ..models import refinement

    refine_fn = (
        refinement.refine_trajectory_sparse
        if config.refine_backend == "sparse"
        else refinement.refine_trajectory
    )
    ba_mesh = mesh if mesh is not None and "lm" in mesh.axis_names else None
    rel, map_pts, map_apps, _ = refine_fn(
        np_mod.asarray(camera.camera_matrix),
        np_mod.asarray(trajectory),
        map_state,
        np_mod.asarray(points),
        np_mod.asarray(appearances),
        np_mod.asarray(masks),
        num_iterations=num_iterations,
        damping=config.refine_damping,
        kernel_threshold=config.kernel_threshold,
        mesh=ba_mesh,
    )
    cap = config.map_capacity
    l = len(map_pts)
    refined_map = lm_mod.LandmarkMap(
        points=jnp.zeros((cap, 3), jnp.float32).at[:l].set(jnp.asarray(map_pts)),
        appearances=jnp.full(
            (cap, map_apps.shape[-1]), jnp.inf, jnp.float32
        ).at[:l].set(jnp.asarray(map_apps)),
        valid=jnp.zeros((cap,), bool).at[:l].set(True),
        count=jnp.asarray(l, jnp.int32),
    )
    return jnp.asarray(rel), refined_map


def run_sequence_chunked(
    camera: Camera,
    config: VOConfig,
    points: Array,        # (F, S, 2)
    appearances: Array,   # (F, S, D)
    masks: Array,         # (F, S)
    num_chunks: int,
    overlap: int = 10,
    slack: Optional[int] = None,
    ids: Optional[Array] = None,
    mesh: Optional[Mesh] = None,
    sp_axis: str = "dp",
    refine_iterations: int = 0,
) -> Tuple[Array, LandmarkMap, PoseGraphDiagnostics]:
    """vo_complete over ONE sequence, tracked as ``num_chunks`` parallel chunks.

    Same output contract as ``pipeline.run_sequence`` (relative-pose
    trajectory (F, 4, 4), landmark map in frame-0 coords) up to the
    monocular gauge: the global scale is chunk 0's bootstrap scale and
    per-boundary scale alignment is statistical, so expect slightly looser
    (but metric-equivalent after the evaluation's median-ratio correction)
    trajectories than the serial scan in exchange for ~C x less sequential
    depth. Chunk starts slide within ``slack`` frames (default
    min(8, overlap)) to the best-conditioned bootstrap pair per
    :func:`bootstrap_scores`. With ``mesh``, the chunk axis is sharded over
    ``sp_axis`` (sequence parallelism: zero cross-device traffic during
    tracking, one tiny all-gather of per-chunk pose streams for the stitch).
    ``refine_iterations`` > 0 follows the stitch with :func:`refine_stitched`
    (BA relaxation of the boundary seams).
    """
    f = points.shape[0]
    use_known_da = ids is not None
    if num_chunks == 1:
        # Exact serial parity (and identical numerics: no vmap axis).
        id_arr = jnp.full(masks.shape, -1, jnp.int32) if ids is None else ids
        trajectory, final_map, outs = pipeline._run(
            camera, config, points, appearances, masks, id_arr, use_known_da
        )
        diags = PoseGraphDiagnostics(
            scales=jnp.ones((1,), points.dtype),
            rot_consistency=jnp.zeros((0,), points.dtype),
            num_ratio_obs=jnp.zeros((0,), jnp.int32),
            join_overflow=jnp.sum(outs.join_overflow),
        )
        pipeline.check_join_overflow(outs)
        if refine_iterations > 0:
            trajectory, final_map = refine_stitched(
                camera, config, trajectory, final_map, points, appearances,
                masks, num_iterations=refine_iterations, mesh=mesh,
            )
        return trajectory, final_map, diags

    scores = None
    if slack is None or slack > 0:
        scores = np.asarray(bootstrap_scores(points, appearances, masks))
    if slack is None:
        # A chunk's start window must be able to escape any degenerate
        # (stationary / pure-rotation) segment: size the slack to the
        # longest below-threshold score run, floored at 8.
        good = scores[scores > 0]
        thr = 0.4 * (np.median(good) if good.size else 0.0)
        bad = (scores < thr).astype(np.int64)
        run = int(
            max(
                (len(list(g)) for k, g in itertools.groupby(bad) if k),
                default=0,
            )
        )
        slack = max(8, min(run + 2, max(f // max(num_chunks, 1) - 2, 4)))
    starts, chunk_len = plan_chunks(f, num_chunks, overlap, scores, slack)
    if ids is None:
        ids = jnp.full(masks.shape, -1, jnp.int32)
    # Chunk 0's bootstrap anchors the whole trajectory at frame 0: enforce
    # the same <8-correspondence hard error as the serial path
    # (epipolar_utils.cpp:104-108) instead of silently anchoring a garbage
    # 8-point solution. Later chunks' bootstraps only seed their local
    # tracking and are discarded by the splice (their failure shows up in
    # the per-boundary diagnostics below).
    s0 = int(starts[0])
    pipeline.check_bootstrap(
        config,
        pipeline.FrameData(points[s0], appearances[s0], masks[s0], ids[s0]),
        pipeline.FrameData(
            points[s0 + 1], appearances[s0 + 1], masks[s0 + 1], ids[s0 + 1]
        ),
        use_known_da,
    )
    cp = _chunk(points, starts, chunk_len)
    ca = _chunk(appearances, starts, chunk_len)
    cm = _chunk(masks, starts, chunk_len)
    ci = _chunk(ids, starts, chunk_len)
    if mesh is not None:
        spec = NamedSharding(mesh, P(sp_axis))
        cp, ca, cm, ci = (jax.device_put(x, spec) for x in (cp, ca, cm, ci))
    trajectory, final_map, diags = _track_and_stitch(
        camera, config, cp, ca, cm, ci, starts, chunk_len, f, use_known_da
    )
    # A boundary with ZERO usable scale observations (no shared valid
    # triangulations AND no moving overlap poses) has an UNDEFINED stitch
    # scale; the median would silently return an arbitrary value and
    # corrupt every downstream chunk's gauge — hard error instead.
    # Fused world-join exactness guard (pipeline.FusedJoinDepthError).
    if int(np.asarray(diags.join_overflow)):
        raise pipeline.FusedJoinDepthError(
            f"{int(np.asarray(diags.join_overflow))} correspondence lanes "
            "exceeded the fused world-join chain depth across the chunks; "
            "raise VOConfig.fused_join_depth or use scan_backend='xla'."
        )
    ratio_obs = np.asarray(diags.num_ratio_obs)
    if ratio_obs.size and (ratio_obs == 0).any():
        bad = [int(i) for i in np.nonzero(ratio_obs == 0)[0]]
        raise StitchError(
            f"chunk boundaries {bad} produced zero scale observations "
            "(no shared valid triangulations in the overlap and no moving "
            "overlap poses); the monocular stitch scale is undefined — "
            "increase chunk_overlap or reduce num_chunks"
        )
    if refine_iterations > 0:
        trajectory, final_map = refine_stitched(
            camera, config, trajectory, final_map, points, appearances, masks,
            num_iterations=refine_iterations, mesh=mesh,
        )
    return trajectory, final_map, diags
