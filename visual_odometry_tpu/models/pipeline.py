"""The end-to-end monocular VO pipeline as ONE jitted program.

Re-design of ``vo_complete``
(``/root/reference/src/apps/vo_complete.cpp:68-186``) and ``vo_daKnown``
(``/root/reference/src/tests/vo_daKnown.cpp``). The reference drives every
frame from a host loop (vo_complete.cpp:150-179) with per-frame kd-tree
builds, O(N*M) correspondence joins and a 100-iteration host GN loop; here
the *entire* sequence after the two-frame initialization is a single
``lax.scan`` whose body fuses:

  match -> lookup-join -> PICP (fori_loop) -> triangulate -> map merge

so the whole trajectory is computed in one device program with zero host
round-trips. On a GPU the frame loop runs as one Pallas kernel instead of
the scan (ops/pallas/frame_kernel, ``VOConfig.scan_backend``); the scan is
its reference and the CPU path. All shapes are static (``VOConfig.n_slots`` measurement slots
per frame, ``VOConfig.map_capacity`` landmarks) with validity masks.

Data-flow invariants preserved from the reference (SURVEY.md §6):
  1. poses are "previous camera expressed in current camera frame"
     (vo_complete.cpp:128, epipolar_utils.h:36-43);
  2. ``point_lookup`` re-encodes correspondences_world: lookup[m] = slot of
     the triangulated point observed at measurement m of the *reference*
     frame, -1 if none — the static-shape form of the (meas_idx, world_idx)
     pairs of utils.cpp:98 after the frame swap at vo_complete.cpp:144-146;
  3. triangulation always happens in the PREVIOUS frame's camera coords and
     only previously-triangulated points constrain the next pose
     (README.md:9, vo_complete.cpp:159-172);
  4. ``history`` chains current-frame coords back to frame 0
     (vo_complete.cpp:147,175-176): map points are stored in frame-0 camera
     coords until the final robot-frame transform.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import epipolar, matching, picp, picp_se2, se3, triangulation
from ..ops.camera import Camera
from ..utils.config import VOConfig
from . import landmark_map
from .landmark_map import LandmarkMap

Array = jnp.ndarray


class FrameData(NamedTuple):
    """One padded measurement frame on device."""

    points: Array       # (S, 2)
    appearances: Array  # (S, D)
    mask: Array         # (S,) bool
    ids: Array          # (S,) int32 ground-truth landmark ids (-1 on padding)


class VOState(NamedTuple):
    """Scan carry between frames."""

    ref: FrameData        # previous frame's measurements
    point_lookup: Array   # (S,) int32: ref meas idx -> triangulated slot | -1
    tri_points: Array     # (S, 3) triangulated points, previous-frame coords
    tri_valid: Array      # (S,) bool
    x_curr: Array         # (4, 4) pose of frame k-1 in frame k
    history: Array        # (4, 4) maps frame k-1 coords -> frame 0 coords
    map: LandmarkMap


class FrameOutput(NamedTuple):
    pose: Array           # (4, 4) relative pose appended to the trajectory
    num_matches: Array    # () int32 image-image correspondences
    num_solver_corr: Array  # () int32 correspondences seen by PICP
    num_inliers: Array    # () int32 PICP inliers at the last GN round
    chi_inliers: Array    # () float32
    tri_points: Array     # (S, 3) this frame's triangulation, prev-frame coords
    tri_apps: Array       # (S, D) triangulated appearances (landmark keys)
    tri_valid: Array      # (S,) bool
    join_overflow: Array  # () int32 lanes whose world-join duplicate-target
    #   multiplicity exceeded fused_join_depth this frame. Always 0 on the
    #   scan backend (its lookup join is exact at any multiplicity); a
    #   nonzero count on the fused kernel means the depth-limited chain
    #   can no longer guarantee vo_complete.cpp:55-63 first-wins semantics
    #   — the product entry points raise FusedJoinDepthError on it.


def match_by_ids(
    ids1: Array, mask1: Array, ids2: Array, mask2: Array
) -> matching.Correspondences:
    """Ground-truth data association by landmark id.

    Mirrors ``extract_correspondences_images`` of vo_daKnown.cpp:19-33:
    pairs (ref idx, curr idx) for every id present in both frames, emitted
    in reference-index order (the reference exploits id-sorted files; ids
    are unique per frame so an equality matrix + argmax is equivalent).
    """
    s = ids1.shape[0]
    eq = (ids1[:, None] == ids2[None, :]) & mask1[:, None] & mask2[None, :]
    found = jnp.any(eq, axis=1)
    idx2 = jnp.argmax(eq, axis=1).astype(jnp.int32)
    slots = jnp.arange(s, dtype=jnp.int32)
    return matching.Correspondences(idx1=slots, idx2=idx2, valid=found)


def _match(config: VOConfig, use_known_da: bool, ref: FrameData, cur: FrameData):
    if use_known_da:
        return match_by_ids(ref.ids, ref.mask, cur.ids, cur.mask)
    return matching.match_appearances(
        ref.appearances, ref.mask, cur.appearances, cur.mask, config.match_radius
    )


def _lookup_from_corr(corr: matching.Correspondences, tri_ok: Array, n_slots: int) -> Array:
    """Scatter (meas idx in frame 2) -> correspondence slot, first-wins.

    The reference's join scans correspondences in order and takes the first
    hit (vo_complete.cpp:55-63); scatter-min over the slot index reproduces
    that because slots are emitted in query order.
    """
    big = jnp.int32(n_slots + 1)
    slots = jnp.arange(n_slots, dtype=jnp.int32)
    vals = jnp.where(corr.valid & tri_ok, slots, big)
    safe_tgt = jnp.where(corr.valid & tri_ok, corr.idx2, n_slots)
    lut = jnp.full((n_slots,), big, jnp.int32).at[safe_tgt].min(vals, mode="drop")
    return jnp.where(lut <= n_slots, lut, -1).astype(jnp.int32)


class FusedJoinDepthError(RuntimeError):
    """The fused backend's world-join chain depth was exceeded.

    Raised when a tracked frame has a measurement targeted by more than
    ``VOConfig.fused_join_depth`` same-frame correspondences
    (``FrameOutput.join_overflow`` > 0): beyond that multiplicity the
    precomputed candidate chains (ops/pallas/frame_kernel.join_candidates)
    can no longer guarantee the reference's first-successfully-triangulated
    join semantics (vo_complete.cpp:55-63). Fix: raise
    ``VOConfig.fused_join_depth`` to at least the reported multiplicity
    bound (restores exactness at one extra triangulation per level) or run
    ``scan_backend="xla"`` (exact at any multiplicity)."""


def check_join_overflow(outs: FrameOutput) -> None:
    """Host-side guard: raise :class:`FusedJoinDepthError` if any tracked
    frame overflowed the fused world-join chain depth.

    Costs one scalar fetch (forces completion of the tracking program);
    throughput harnesses that queue many programs back-to-back can defer it
    (``validate=False`` on the sequence runners) after checking the
    workload once.
    """
    import numpy as np

    total = int(np.asarray(jnp.sum(outs.join_overflow)))
    if total:
        per_frame = np.asarray(outs.join_overflow).reshape(-1)
        worst = int(per_frame.max())
        frames = np.nonzero(per_frame)[0][:8].tolist()
        raise FusedJoinDepthError(
            f"{total} correspondence lanes across frames {frames}... exceeded "
            f"the fused world-join chain depth (worst frame: {worst} lanes); "
            "first-wins join semantics (vo_complete.cpp:55-63) are not "
            "guaranteed past it. Raise VOConfig.fused_join_depth or use "
            "scan_backend='xla'."
        )


class BootstrapError(RuntimeError):
    """The two-view bootstrap cannot produce a usable initialization.

    The analogue of the reference's hard exits: < 8
    correspondences aborts ``estimate_fundamental``
    (epipolar_utils.cpp:104-108) and unreadable inputs abort the app
    (vo_complete.cpp:95-107)."""


class BootstrapDiagnostics(NamedTuple):
    """Conditioning of the two-view bootstrap pair (no reference counterpart
    beyond the <8 abort; the degeneracy score is this framework's own)."""

    num_correspondences: Array  # () int32 valid matches between the frames
    degeneracy_score: Array     # () f32 median homography transfer residual
    #   (~0 => the pair is homography-explained: pure rotation / stationary /
    #   planar-only, so the 8-point translation and monocular scale are
    #   meaningless; see ops/epipolar.homography_transfer_residuals)


# Below this median transfer residual (in the [-1,1]-normalized image frame)
# a frame pair is considered homography-explained. Measured: real-parallax
# pairs on example_data score ~1e-2, synthetic pure-rotation pairs < 1e-6;
# 1e-4 sits two orders of magnitude from both.
DEGENERACY_THRESHOLD = 1e-4


@functools.partial(jax.jit, static_argnames=("config", "use_known_da"))
def bootstrap_diagnostics(
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    use_known_da: bool = False,
) -> BootstrapDiagnostics:
    """Match the bootstrap pair and score its two-view conditioning."""
    corr = _match(config, use_known_da, frame0, frame1)
    res, ok = epipolar.homography_transfer_residuals(
        corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points, frame0.mask, frame1.mask,
    )
    big = jnp.asarray(jnp.inf, res.dtype)
    cnt = jnp.sum(ok.astype(jnp.int32))
    med = jnp.sort(jnp.where(ok, res, big))[jnp.maximum(cnt - 1, 0) // 2]
    # cnt == 0 means no residual was measured at all — report NaN (distinct
    # from a true ~0 homography-explained score) so callers can tell
    # "degenerate pair" apart from "nothing to assess".
    return BootstrapDiagnostics(
        num_correspondences=jnp.sum(corr.valid.astype(jnp.int32)),
        degeneracy_score=jnp.where(cnt > 0, med, jnp.nan),
    )


def check_bootstrap(
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    use_known_da: bool = False,
    min_correspondences: int = 8,
    degeneracy_threshold: float = DEGENERACY_THRESHOLD,
) -> BootstrapDiagnostics:
    """Host-side bootstrap guard for the serial pipeline's first pair.

    Raises :class:`BootstrapError` when fewer than ``min_correspondences``
    matches exist (the 8-point algorithm's hard floor — the reference
    exits, epipolar_utils.cpp:104-108) and warns when the pair is
    homography-explained (degenerate monocular bootstrap; the chunked
    runner avoids such pairs via ``posegraph.bootstrap_scores``, the
    serial pipeline has no alternative pair to pick). Returns the
    diagnostics either way so apps can log them.
    """
    import warnings

    d = bootstrap_diagnostics(config, frame0, frame1, use_known_da)
    n = int(d.num_correspondences)
    if n < min_correspondences:
        raise BootstrapError(
            f"two-view bootstrap needs >= {min_correspondences} "
            f"correspondences, got {n} (reference aborts here, "
            "epipolar_utils.cpp:104-108)"
        )
    import math

    score = float(d.degeneracy_score)
    if math.isnan(score):
        warnings.warn(
            "too few correspondences survived the homography fit to assess "
            "bootstrap degeneracy (no transfer residuals measured)",
            RuntimeWarning,
            stacklevel=2,
        )
    elif score < degeneracy_threshold:
        warnings.warn(
            f"bootstrap pair is homography-explained (median transfer "
            f"residual {score:.2e} < {degeneracy_threshold:.0e}): pure "
            "rotation / stationary / planar-only motion makes the 8-point "
            "translation and the monocular scale degenerate",
            RuntimeWarning,
            stacklevel=2,
        )
    return d


def initialize(
    camera: Camera,
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    use_known_da: bool = False,
    corr: "matching.Correspondences | None" = None,
) -> Tuple[VOState, Array]:
    """Two-frame bootstrap: match, 8-point init, triangulate, seed the map.

    Mirrors vo_complete.cpp:95-148. Returns (state, x_init) where x_init is
    the frame-0-in-frame-1 pose (trajectory entry 1; entry 0 is identity).
    ``corr`` lets callers supply the bootstrap-pair correspondences (the
    fused runner also needs them to seed the frame-2 join chain).
    """
    s = config.n_slots
    if corr is None:
        corr = _match(config, use_known_da, frame0, frame1)
    x_init = epipolar.estimate_transform(
        camera.camera_matrix, corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points, frame0.mask, frame1.mask,
    )
    if config.planar:
        # Planarize the two-view init so the whole trajectory stays in the
        # conjugated SE(2) subgroup the solver moves in (ops/picp_se2).
        mount = config.planar_mount()
        c = jnp.eye(4, dtype=x_init.dtype) if mount is None else jnp.asarray(mount)
        x_init = se3.inverse(c) @ se3.project_se2(c @ x_init @ se3.inverse(c)) @ c
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, x_init, corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points,
    )
    # Triangulated appearances come from the SECOND frame (utils.cpp:127).
    tri_apps = frame1.appearances[corr.idx2]

    map_state = LandmarkMap.empty(
        config.map_capacity, frame0.appearances.shape[-1], tri.dtype
    )
    map_state = landmark_map.update(map_state, tri, tri_apps, ok)

    state = VOState(
        ref=frame1,
        point_lookup=_lookup_from_corr(corr, ok, s),
        tri_points=tri,
        tri_valid=ok,
        x_curr=x_init,
        history=se3.inverse(x_init),
        map=map_state,
    )
    return state, x_init


def frame_step(
    camera: Camera,
    config: VOConfig,
    state: VOState,
    frame: FrameData,
    use_known_da: bool = False,
    corr: "matching.Correspondences | None" = None,
    merge_map: bool = True,
) -> Tuple[VOState, FrameOutput]:
    """Track one new frame (the body of vo_complete.cpp:150-179).

    ``corr`` lets callers supply precomputed (ref, frame) correspondences:
    matching depends only on the two frames' appearances — not on the
    carried pose — so the sequence runners hoist it out of the sequential
    scan into one batched vmap over all consecutive pairs (a single MXU
    matmul batch instead of F-2 small sequential kernel chains).

    ``merge_map=False`` skips the in-scan landmark-map merge; the map never
    feeds back into tracking, so the sequence runners instead emit each
    frame's triangulation (FrameOutput.tri_*) and fold the whole stream
    with ONE post-scan ``landmark_map.merge_stream`` pass.
    """
    s = config.n_slots
    if corr is None:
        corr = _match(config, use_known_da, state.ref, frame)

    # Join image-image matches with the previous triangulation via the
    # lookup (replaces the O(N*M) scan of vo_complete.cpp:52-66).
    world_slot = jnp.where(corr.valid, state.point_lookup[jnp.where(corr.valid, corr.idx1, 0)], -1)
    has_world = corr.valid & (world_slot >= 0)
    safe_slot = jnp.where(has_world, world_slot, 0)
    solver_weight = (has_world & state.tri_valid[safe_slot]).astype(frame.points.dtype)

    # Model points: previous triangulation moved into the previous camera's
    # frame (vo_complete.cpp:159: X_curr * triangulated).
    tri_in_prev = se3.transform_points(state.x_curr, state.tri_points)
    world_points = tri_in_prev[safe_slot]
    measured = frame.points[jnp.where(corr.valid, corr.idx2, 0)]

    # Solver start: identity each frame (vo_complete.cpp:161), or the
    # previous relative pose as a constant-velocity warm start.
    if config.warm_start:
        solver_cam = camera.with_pose(state.x_curr)
    else:
        solver_cam = camera.with_pose(jnp.eye(4, dtype=world_points.dtype))
    if config.planar:
        solved_cam, stats = picp_se2.solve_se2(
            solver_cam,
            world_points,
            measured,
            solver_weight,
            config.gn_iterations,
            kernel_threshold=config.kernel_threshold,
            damping=config.damping,
            keep_outliers=config.keep_outliers,
            tolerance=config.gn_tolerance,
            cam_in_robot=config.planar_mount(),
            min_num_inliers=config.min_num_inliers,
            min_iterations=config.gn_min_iterations,
        )
    else:
        solved_cam, stats = picp.solve(
            solver_cam,
            world_points,
            measured,
            solver_weight,
            config.gn_iterations,
            kernel_threshold=config.kernel_threshold,
            damping=config.damping,
            keep_outliers=config.keep_outliers,
            tolerance=config.gn_tolerance,
            min_num_inliers=config.min_num_inliers,
            min_iterations=config.gn_min_iterations,
        )
    pose = solved_cam.world_in_camera  # frame k-1 expressed in frame k

    # Re-triangulate the pair (prev, curr) in prev-frame coords.
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, pose, corr.idx1, corr.idx2, corr.valid,
        state.ref.points, frame.points,
    )
    tri_apps = frame.appearances[corr.idx2]

    if merge_map:
        # Map merge in frame-0 coords (vo_complete.cpp:175).
        tri_world = se3.transform_points(state.history, tri)
        new_map = landmark_map.update(state.map, tri_world, tri_apps, ok)
    else:
        new_map = state.map

    new_state = VOState(
        ref=frame,
        point_lookup=_lookup_from_corr(corr, ok, s),
        tri_points=tri,
        tri_valid=ok,
        x_curr=pose,
        history=state.history @ se3.inverse(pose),
        map=new_map,
    )
    out = FrameOutput(
        pose=pose,
        num_matches=jnp.sum(corr.valid.astype(jnp.int32)),
        num_solver_corr=jnp.sum(solver_weight).astype(jnp.int32),
        num_inliers=stats.num_inliers,
        chi_inliers=stats.chi_inliers,
        tri_points=tri,
        tri_apps=tri_apps,
        tri_valid=ok,
        join_overflow=jnp.zeros((), jnp.int32),
    )
    return new_state, out


def _batched_match(
    config: VOConfig, use_known_da: bool, frames: FrameData, prev: FrameData
) -> matching.Correspondences:
    """All consecutive-pair correspondences at once.

    ``prev`` holds frames k-1 and ``frames`` holds frames k, stacked along
    the leading axis; the result feeds the scan as xs. One batched gram
    matmul replaces the per-step matcher (vo_complete.cpp:156's per-frame
    kd-tree build+query, hoisted because DA is pose-independent).
    """
    if use_known_da:
        return jax.vmap(match_by_ids)(prev.ids, prev.mask, frames.ids, frames.mask)
    return matching.match_appearances_batch(
        prev.appearances, prev.mask, frames.appearances, frames.mask,
        radius=config.match_radius,
    )


class InitTriangulation(NamedTuple):
    """The two-view bootstrap's triangulated observations (map-stream head)."""

    points: Array  # (S, 3) in frame-0 camera coords
    apps: Array    # (S, D) appearance keys (second frame's, utils.cpp:127)
    valid: Array   # (S,) bool


def _resolve_scan_backend(config: VOConfig) -> str:
    """"auto" runs the fused frame-loop kernel on a GPU and the scan
    elsewhere; "fused_interpret" is the same kernel through the Pallas
    interpreter (the CPU-testable form of the fused path)."""
    if config.scan_backend == "auto":
        return "fused" if jax.default_backend() == "gpu" else "xla"
    return config.scan_backend


def _run_fused(
    camera: Camera,
    config: VOConfig,
    x_curr: Array,
    w0: Tuple[Array, Array],
    cand,
    overflow0: Array,
    prev: FrameData,
    cur: FrameData,
    corr_all: matching.Correspondences,
    interpret: bool,
) -> FrameOutput:
    """The whole frame loop as ONE kernel launch (ops/pallas/frame_kernel).

    Everything pose-independent is batched over frames here: the
    lane-aligned pixel rows, triangulated appearances and match counts.
    The caller supplies the world-join chains of frames 1.. (``cand``) and
    the first frame's joined source points (``w0``), since only it knows
    where the step before the first comes from: the bootstrap pair for a
    fresh sequence, the carried ``point_lookup`` for a resumed one.
    ``overflow0`` is the first frame's join-overflow lane flags.
    """
    from ..ops.pallas import frame_kernel

    cam_params = jnp.stack(
        [camera.z_near, camera.z_far, camera.cols, camera.rows]
    )
    safe1 = jnp.where(corr_all.valid, corr_all.idx1, 0)[..., None]
    safe2 = jnp.where(corr_all.valid, corr_all.idx2, 0)[..., None]
    poses, tri_all, tri_ok_all, solver_stats = frame_kernel.track_frames(
        camera.camera_matrix,
        cam_params,
        x_curr,
        w0[0],
        w0[1],
        cand,
        jnp.take_along_axis(prev.points, safe1, axis=1),
        jnp.take_along_axis(cur.points, safe2, axis=1),
        corr_all.valid,
        config.gn_iterations,
        config.kernel_threshold,
        config.damping,
        config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
        keep_outliers=config.keep_outliers,
        warm_start=config.warm_start,
        min_num_inliers=config.min_num_inliers,
        min_iterations=config.gn_min_iterations,
        planar=config.planar,
        cam_in_robot=config.planar_mount(),
        interpret=interpret,
    )
    overflow = jnp.concatenate([overflow0[None], cand.overflow])
    return FrameOutput(
        pose=poses,
        num_matches=jnp.sum(corr_all.valid.astype(jnp.int32), axis=1),
        num_solver_corr=solver_stats[:, 3].astype(jnp.int32),
        num_inliers=solver_stats[:, 2].astype(jnp.int32),
        chi_inliers=solver_stats[:, 0],
        tri_points=tri_all,
        tri_apps=jnp.take_along_axis(cur.appearances, safe2, axis=1),
        tri_valid=tri_ok_all,
        join_overflow=jnp.sum(overflow.astype(jnp.int32), axis=1),
    )


def _track(
    camera: Camera,
    config: VOConfig,
    points: Array,
    appearances: Array,
    masks: Array,
    ids: Array,
    use_known_da: bool,
) -> Tuple[Array, FrameOutput, InitTriangulation]:
    """Bootstrap + track all frames; no landmark-map fold.

    Returns (x_init, per-frame outputs for frames 2.., the bootstrap
    triangulation). Shared by :func:`_run` (which folds the map) and the
    chunk-parallel pose-graph runner (parallel/posegraph), which stitches
    many `_track` results and folds ONE global map.
    """
    f0 = FrameData(points[0], appearances[0], masks[0], ids[0])
    f1 = FrameData(points[1], appearances[1], masks[1], ids[1])
    corr01 = _match(config, use_known_da, f0, f1)
    state, x_init = initialize(camera, config, f0, f1, use_known_da, corr=corr01)
    # ``initialize`` seeds an empty map with exactly the bootstrap
    # triangulation (compacted to the front, incoming order), so its first
    # n_slots rows ARE the bootstrap observations in frame-0 coords.
    s = config.n_slots
    init_tri = InitTriangulation(
        points=state.map.points[:s],
        apps=state.map.appearances[:s],
        valid=state.map.valid[:s],
    )

    rest = FrameData(points[2:], appearances[2:], masks[2:], ids[2:])
    prev = FrameData(points[1:-1], appearances[1:-1], masks[1:-1], ids[1:-1])
    corr_all = _batched_match(config, use_known_da, rest, prev)

    backend = _resolve_scan_backend(config)
    if backend in ("fused", "fused_interpret"):
        from ..ops.pallas import frame_kernel

        # Step i's world join looks up step i-1's correspondence targets
        # (the bootstrap pair's for the first tracked frame).
        src_idx2 = jnp.concatenate(
            [corr01.idx2[None], corr_all.idx2[:-1]], axis=0
        )
        src_valid = jnp.concatenate(
            [corr01.valid[None], corr_all.valid[:-1]], axis=0
        )
        cand = frame_kernel.join_candidates(
            src_idx2, src_valid, corr_all.idx1, corr_all.valid,
            config.fused_join_depth,
        )
        w0 = frame_kernel.first_valid_join(
            state.tri_points, state.tri_valid, cand.idx[0], cand.ok[0]
        )
        outs = _run_fused(
            camera, config, state.x_curr, w0,
            jax.tree.map(lambda x: x[1:], cand), cand.overflow[0],
            prev, rest, corr_all, backend == "fused_interpret",
        )
    else:

        def body(carry, xs):
            frame, corr = xs
            return frame_step(
                camera, config, carry, frame, use_known_da, corr=corr, merge_map=False
            )

        state, outs = jax.lax.scan(body, state, (rest, corr_all))

    return x_init, outs, init_tri


@functools.partial(jax.jit, static_argnames=("config", "use_known_da"))
def _run(
    camera: Camera,
    config: VOConfig,
    points: Array,
    appearances: Array,
    masks: Array,
    ids: Array,
    use_known_da: bool,
) -> Tuple[Array, LandmarkMap, FrameOutput]:
    x_init, outs, init_tri = _track(
        camera, config, points, appearances, masks, ids, use_known_da
    )

    # Landmark-map merge, hoisted out of the scan: the map never feeds back
    # into tracking (vo_complete.cpp:175 only accumulates it), so the
    # per-frame scatter merge becomes (a) one associative_scan for the
    # frame->frame-0 chains (vo_complete.cpp:176), (b) one batched point
    # transform, (c) one sort-based merge over the whole observation stream.
    inv_poses = jax.vmap(se3.inverse)(outs.pose)
    chains = jax.lax.associative_scan(
        jnp.matmul,
        jnp.concatenate([se3.inverse(x_init)[None], inv_poses[:-1]], axis=0),
    )  # chains[j] maps frame j+1 coords -> frame 0 coords
    tri_world = jax.vmap(se3.transform_points)(chains, outs.tri_points)
    d = appearances.shape[-1]
    stream_pts = jnp.concatenate([init_tri.points, tri_world.reshape(-1, 3)])
    stream_apps = jnp.concatenate(
        [init_tri.apps, outs.tri_apps.reshape(-1, d)]
    )
    stream_mask = jnp.concatenate([init_tri.valid, outs.tri_valid.reshape(-1)])
    final_map = landmark_map.merge_stream(
        stream_pts, stream_apps, stream_mask, config.map_capacity
    )

    trajectory = jnp.concatenate(
        [jnp.eye(4, dtype=points.dtype)[None], x_init[None], outs.pose], axis=0
    )
    return trajectory, final_map, outs


def run_sequence(
    camera: Camera,
    config: VOConfig,
    points: Array,        # (F, S, 2)
    appearances: Array,   # (F, S, D)
    masks: Array,         # (F, S) bool
    validate: bool = True,
) -> Tuple[Array, LandmarkMap, FrameOutput]:
    """Full vo_complete pipeline over a stacked sequence, in one jit.

    Returns (trajectory (F, 4, 4) of relative poses — entry 0 identity,
    entry 1 the epipolar init, then one PICP pose per frame — the final
    map in frame-0 camera coords, and per-frame diagnostics).

    ``validate`` runs :func:`check_join_overflow` on the result (fused
    backend join-exactness guard — a scalar fetch, so it forces
    completion); pass False only from throughput harnesses that queue many
    programs asynchronously AND have validated the workload once.
    """
    ids = jnp.full(masks.shape, -1, jnp.int32)
    out = _run(camera, config, points, appearances, masks, ids, False)
    if validate:
        check_join_overflow(out[2])
    return out


@functools.partial(jax.jit, static_argnames=("config", "use_known_da"))
def continue_sequence(
    camera: Camera,
    config: VOConfig,
    state: VOState,
    points: Array,        # (F', S, 2) frames to process
    appearances: Array,
    masks: Array,
    ids: Array,
    use_known_da: bool = False,
) -> Tuple[VOState, FrameOutput]:
    """Resume tracking from a carried state (checkpoint/resume support).

    Scanning the same frames in one call or across several calls with the
    carried state in between produces identical results — the carry is the
    complete pipeline state (utils/checkpoint.py round-trips it).

    On the fused backend the resumed frames run through the SAME
    one-kernel-launch path as ``run_sequence``: the first resumed frame's
    world join comes straight from the carried ``point_lookup`` (which
    already folds first-wins AND triangulation validity, so it reproduces
    the scan join exactly), later frames use the standard candidate
    chains, and the per-frame map merges collapse into ONE
    ``merge_stream`` pass seeded with the carried map's live entries
    (identical slot layout to iterating ``landmark_map.update``: entries
    keep first-observation order, every re-observation's LAST position
    wins). Split-vs-one-shot equality on the fused backend: poses, map
    layout and the carried lookup are exact; map POSITIONS agree to ~1e-5
    — the frame-0 gauge chains are tree-reduced (``associative_scan`` over
    f32 matmuls, non-associative), so a split re-associates the products
    at the boundary (tests/test_checkpoint.py).
    """
    frames = FrameData(points, appearances, masks, ids)
    # Previous-frame stack: the carried reference frame, then frames 0..F'-2.
    prev = jax.tree.map(
        lambda r, xs: jnp.concatenate([r[None], xs[:-1]], axis=0), state.ref, frames
    )
    corr_all = _batched_match(config, use_known_da, frames, prev)

    backend = _resolve_scan_backend(config)
    if backend in ("fused", "fused_interpret"):
        from ..ops.pallas import frame_kernel

        s = config.n_slots
        # First resumed frame: the carried lookup IS the join (slot of the
        # first successfully-triangulated first-wins source, or -1).
        valid_0 = corr_all.valid[0]
        slot0 = state.point_lookup[jnp.where(valid_0, corr_all.idx1[0], 0)]
        has0 = valid_0 & (slot0 >= 0)
        safe0 = jnp.where(has0, slot0, 0)
        w0 = (state.tri_points[safe0], has0 & state.tri_valid[safe0])
        cand = frame_kernel.join_candidates(
            corr_all.idx2[:-1], corr_all.valid[:-1],
            corr_all.idx1[1:], corr_all.valid[1:],
            config.fused_join_depth,
        )
        outs = _run_fused(
            camera, config, state.x_curr, w0, cand,
            jnp.zeros((s,), bool),  # the lookup join is exact
            prev, frames, corr_all, backend == "fused_interpret",
        )

        # Fold the map once: carried live entries head the stream (their
        # slot order = insertion order), then every resumed frame's
        # triangulation in frame-0 coords.
        inv_poses = jax.vmap(se3.inverse)(outs.pose)
        chains = jax.lax.associative_scan(
            jnp.matmul,
            jnp.concatenate([state.history[None], inv_poses[:-1]], axis=0),
        )  # chains[j] maps tracked frame j's PREVIOUS frame coords -> frame 0
        tri_world = jax.vmap(se3.transform_points)(chains, outs.tri_points)
        d = appearances.shape[-1]
        new_map = landmark_map.merge_stream(
            jnp.concatenate([state.map.points, tri_world.reshape(-1, 3)]),
            jnp.concatenate([state.map.appearances, outs.tri_apps.reshape(-1, d)]),
            jnp.concatenate([state.map.valid, outs.tri_valid.reshape(-1)]),
            config.map_capacity,
        )

        last = jax.tree.map(lambda x: x[-1], frames)
        corr_last = jax.tree.map(lambda x: x[-1], corr_all)
        new_state = VOState(
            ref=last,
            point_lookup=_lookup_from_corr(corr_last, outs.tri_valid[-1], s),
            tri_points=outs.tri_points[-1],
            tri_valid=outs.tri_valid[-1],
            x_curr=outs.pose[-1],
            history=chains[-1] @ se3.inverse(outs.pose[-1]),
            map=new_map,
        )
        return new_state, outs

    def body(carry, xs):
        frame, corr = xs
        return frame_step(camera, config, carry, frame, use_known_da, corr=corr)

    return jax.lax.scan(body, state, (frames, corr_all))


@functools.partial(jax.jit, static_argnames=("config",))
def relocalize_frame(
    camera: Camera,
    config: VOConfig,
    map_state: LandmarkMap,
    frame: FrameData,
    x_init: Array,
) -> Tuple[Array, "picp.PICPStats", Array]:
    """Map-scale re-localization: query ONE frame against the global map.

    The database is the whole landmark map (``map_capacity`` rows), the
    queries are one frame's descriptors, and the matches feed the standard
    PICP solve for the camera-from-map pose. Same best-match semantics as
    frame-to-frame association at map scale (eigen_kdtree.h:90-115 /
    brute_force_search.h:22-41: exact nearest within the strict 0.1
    radius); the reference has no relocalization mode — its matcher only
    ever sees consecutive frame pairs (vo_complete.cpp:156).

    ``x_init`` is the pose prior the Gauss-Newton solve starts from (e.g.
    the last tracked pose before a loss, or identity near the map origin).
    Returns (camera-from-map-coords pose (4, 4), solver stats,
    num_matches).
    """
    dist, idx = matching.best_match(
        frame.appearances, frame.mask, map_state.appearances, map_state.valid
    )
    r2 = jnp.asarray(config.match_radius, dist.dtype) ** 2
    valid = frame.mask & (dist < r2)
    world = map_state.points[jnp.where(valid, idx, 0)]
    solved, stats = picp.solve(
        camera.with_pose(x_init),
        world,
        frame.points,
        valid.astype(frame.points.dtype),
        config.gn_iterations,
        kernel_threshold=config.kernel_threshold,
        damping=config.damping,
        keep_outliers=config.keep_outliers,
        tolerance=config.gn_tolerance,
        min_num_inliers=config.min_num_inliers,
        min_iterations=config.gn_min_iterations,
    )
    return (
        solved.world_in_camera,
        stats,
        jnp.sum(valid.astype(jnp.int32)),
    )


def run_sequence_known_da(
    camera: Camera,
    config: VOConfig,
    points: Array,
    appearances: Array,
    masks: Array,
    ids: Array,
    validate: bool = True,
) -> Tuple[Array, LandmarkMap, FrameOutput]:
    """vo_daKnown pipeline: data association by ground-truth landmark id."""
    out = _run(camera, config, points, appearances, masks, jnp.asarray(ids), True)
    if validate:
        check_join_overflow(out[2])
    return out
