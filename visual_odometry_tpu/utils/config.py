"""Configuration for the VO pipelines.

The reference hardcodes every knob across its apps (SURVEY.md §5 "Config /
flag system"); here they live in one frozen dataclass whose defaults
reproduce ``vo_complete``:

  * ``gn_iterations=100``            (vo_complete.cpp:163)
  * ``kernel_threshold=10000``       (vo_complete.cpp:139; solver default is
                                      1000, picp_solver.cpp:13)
  * ``damping=1.0``                  (picp_solver.cpp:10)
  * ``match_radius=0.1``             (vo_complete.cpp:38)
  * ``min_num_inliers=0``            (picp_solver.cpp:11)

``vo_daKnown`` parity is ``VOConfig(gn_iterations=1000)`` with known DA
(vo_daKnown.cpp:149-150).

Static-shape knobs (``n_slots``, ``map_capacity``) have no reference
counterpart — they are the pad-to-max sizes of the compiled programs. The
fused frame-loop kernel pads ``n_slots`` to a power of two, so powers of
two waste no lanes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VOConfig:
    # --- static shapes (compile-time) ---
    n_slots: int = 128          # measurement slots per frame (max meas count)
    map_capacity: int = 1024    # landmark-map capacity

    # --- solver ---
    gn_iterations: int = 100
    kernel_threshold: float = 10000.0
    damping: float = 1.0
    min_num_inliers: int = 0
    keep_outliers: bool = False
    # Early-exit tolerance on ||dx||^2 per GN round. The reference burns its
    # full fixed budget (vo_complete.cpp:163); GN converges quadratically,
    # so this tolerance reproduces the converged result with ~10x fewer
    # sequential rounds. Set to 0.0 for the reference's exact fixed-budget
    # behavior.
    gn_tolerance: float = 1e-12
    # Minimum GN rounds before the tolerance exit may fire. 1 preserves
    # the plain early-exit semantics; with warm_start, raise to ~3 so a
    # small first step near the prior (not yet converged) cannot end the
    # solve prematurely.
    gn_min_iterations: int = 1
    # Start each frame's GN from the previous relative pose (constant-
    # velocity prior) instead of the reference's identity start
    # (vo_complete.cpp:161). Measured on example_data: the robust kernel
    # re-classifies inliers at the warm pose and converges to a DIFFERENT
    # fixed point than the identity start — e_theta ~5e-5 vs 2.7e-6 even
    # with gn_min_iterations raised to 20 — so the reference's identity
    # start is also the accurate one here. Kept as an experimentation
    # knob; pair with gn_min_iterations >= 3 so the tolerance exit cannot
    # fire on the small first step near the prior.
    warm_start: bool = False

    # --- data association ---
    match_radius: float = 0.1

    # --- estimation group (reference branch est_SE2, README.md:13) ---
    # planar=True constrains the per-frame solve to SE(2) increments acting
    # in the robot plane (ops/picp_se2). cam_in_robot is the camera mount
    # pose as a nested tuple (hashable: the config is a static jit arg);
    # None = identity mount. Use VOConfig.with_planar_mount() to set it
    # from a (4, 4) array.
    planar: bool = False
    cam_in_robot: "tuple | None" = None

    def planar_mount(self):
        """The (4, 4) float32 mount matrix, or None."""
        if self.cam_in_robot is None:
            return None
        import numpy as np

        return np.asarray(self.cam_in_robot, np.float32)

    def with_planar_mount(self, cam_in_robot) -> "VOConfig":
        """Enable SE(2) estimation with the given camera-mount pose."""
        import numpy as np

        mount = tuple(tuple(float(x) for x in row) for row in np.asarray(cam_in_robot))
        return self.replace(planar=True, cam_in_robot=mount)

    # --- sequence parallelism (parallel/posegraph; no reference
    # counterpart) --- track the sequence as num_chunks overlapping chunks
    # in parallel and stitch them with per-boundary monocular-scale
    # alignment. 1 = the serial reference-parity scan. Each boundary's
    # scale is the median norm ratio of the two chunks' slot-aligned
    # overlap triangulations (pose-translation ratios as fallback).
    num_chunks: int = 1
    chunk_overlap: int = 10

    # --- global refinement (no reference counterpart; models/refinement) ---
    # LM/GN bundle-adjustment iterations run over the whole trajectory+map
    # after tracking. 0 disables (reference-parity pipeline).
    refine_iterations: int = 0
    refine_damping: float = 1.0
    # BA formulation: "dense" builds the (F, L) observation grid (exact
    # direct Schur solve — right for reference-sized problems), "sparse"
    # uses the COO + matrix-free Schur-CG path (parallel/sparse_ba) whose
    # memory is O(#observations) — required beyond ~10^4 landmarks.
    refine_backend: str = "dense"

    # --- numerics ---
    # All device arithmetic is float32, matching the reference's typedefs
    # (defs.h:7-29); there is deliberately no dtype knob — GN/eigh numerics
    # in this pipeline do not survive bf16, and f64 buys nothing (the
    # reference itself is f32 end to end).
    # Frame-loop backend for the sequence runners: "fused" = the whole
    # frame loop (join + GN + triangulation) as ONE Pallas kernel compiled
    # through Triton (ops/pallas/frame_kernel), "xla" = lax.scan over
    # frame_step, "fused_interpret" = the fused kernel through the Pallas
    # interpreter (CPU tests), "auto" = fused on a GPU, xla elsewhere — for
    # both the SE(3) and the planar (est_SE2) estimation groups.
    scan_backend: str = "auto"
    # First-wins depth of the fused kernel's world-join candidate chains
    # (ops/pallas/frame_kernel.join_candidates). Exact reference semantics
    # whenever no measurement is the target of more than this many same-
    # frame correspondences whose earlier candidates ALL failed
    # triangulation; measured multiplicity on the reference dataset is 1,
    # so 2 carries a spare level. NOT a silent assumption: the chain
    # builder flags lanes whose multiplicity exceeds the depth
    # (FrameOutput.join_overflow) and the sequence runners hard-error on
    # them (pipeline.FusedJoinDepthError) — raise this knob to the
    # reported bound to restore exactness, or use scan_backend="xla".
    fused_join_depth: int = 2

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = VOConfig()

# Accuracy-first preset: tracking + global bundle-adjustment refinement.
# Beats every reference metric robustly (RMSE_map ~0.105 vs 0.184,
# e_theta ~1.4e-6 vs 5.3e-6 on example_data).
ACCURATE_CONFIG = VOConfig(refine_iterations=15)
