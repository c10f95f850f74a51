"""Roofline accounting: analytic work models and the device peaks table.

For each hot stage this module pairs an analytic resource model (matmul
FLOPs, vector element-ops, device-memory bytes — counted from the code, see
the *_model functions) with a measured time, and reports

  * achieved GB/s, matmul GFLOP/s and vector Gop/s,
  * ``roofline_fraction`` = t_speed_of_light / t_measured, where the
    speed-of-light time is max(bytes/BW, matmul/peak, vector/peak) — the
    fraction of the binding resource's peak the stage actually sustains.

Peaks come from :data:`PEAKS`, keyed by ``jax.Device.device_kind``; a device
missing from the table is an error (:func:`peaks`), never a default. All
matmuls here run in float32 at "highest" precision (no TF32), so the matmul
peak is the card's float32 rate outside the tensor cores.

The models count *useful* work only and are deliberately simple — each is
a lower bound on the true op count, so every fraction reported against
them is a lower bound on the real utilization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    matmul_flops: float    # f32 matmul peak at "highest" precision, FLOP/s
    vector_ops: float      # f32 element-ops/s (FMA = 1 op)
    hbm_bw: float          # bytes/s
    source: str


# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit:
# 67 TFLOP/s float32 outside the tensor cores (FMA = 2 FLOPs, so 33.5e12
# element-ops/s at FMA = 1), 3.35 TB/s HBM3. A card set below 700 W cannot
# hold these clocks; report its power limit beside any fraction.
_H100_SXM = ChipSpec(
    name="h100_sxm",
    matmul_flops=67e12,
    vector_ops=33.5e12,
    hbm_bw=3.35e12,
    source="NVIDIA H100 SXM data sheet (dense, 700 W)",
)

PEAKS: Dict[str, ChipSpec] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks(device_kind: str) -> ChipSpec:
    """The peak table entry for ``jax.devices()[0].device_kind``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet rates to utils/roofline.PEAKS"
        ) from None


@dataclasses.dataclass(frozen=True)
class KernelModel:
    """Analytic resource footprint of one kernel invocation."""

    name: str
    matmul_flops: float
    vector_ops: float
    hbm_bytes: float

    def speed_of_light_s(self, chip: ChipSpec) -> float:
        return max(
            self.matmul_flops / chip.matmul_flops,
            self.vector_ops / chip.vector_ops,
            self.hbm_bytes / chip.hbm_bw,
        )

    def report(self, measured_s: float, chip: ChipSpec) -> Dict[str, float]:
        sol = self.speed_of_light_s(chip)
        return {
            f"{self.name}_time_us": measured_s * 1e6,
            f"{self.name}_gbps": self.hbm_bytes / measured_s / 1e9,
            f"{self.name}_matmul_gflops": self.matmul_flops / measured_s / 1e9,
            f"{self.name}_vector_gops": self.vector_ops / measured_s / 1e9,
            f"{self.name}_roofline_fraction": sol / measured_s,
        }


# --- analytic models (op counts from the kernel code, cited per term) ----


def matcher_model(q: int, k: int, d: int = 10) -> KernelModel:
    """Dense top-1 matcher (ops/matching.best_match).

    Gram matmul (Q, D) x (D, K) -> 2*Q*K*D FLOPs (the zero pad of the
    descriptor axis is not counted). Vector: distance assembly + (min,
    first-argmin) ~= 6 ops per (q, k) cell. Bytes: queries + database
    once, plus norms and the (dist, idx) outputs.
    """
    return KernelModel(
        name="matcher",
        matmul_flops=2.0 * q * k * d,
        vector_ops=6.0 * q * k,
        hbm_bytes=4.0 * (q * d + k * d + q + k + 2 * q),
    )


# Hand count of the GN loop's per-point per-round element ops
# (ops/pallas/frame_kernel._gn_se3): projection+K 36, perspective/validity
# 26, error/robust-kernel 16, Jp*K coefficients 24, J columns 18, 21 H sums
# x 4 ops + 6 b sums x 4 + 3 stat sums x 2 = 114, 30 lane reductions ~30.
# Total ~264; the O(1) Schur solve + Euler update (~350 scalar ops/round)
# is excluded (vanishes per point for N >= 128).
GN_OPS_PER_POINT_ROUND = 264.0
# Mid-point triangulation per lane (frame_kernel._triangulate).
TRI_OPS_PER_POINT = 80.0


def picp_model(n: int, rounds: int) -> KernelModel:
    """``rounds`` Gauss-Newton rounds over ``n`` correspondences: vector
    work only; bytes are the (3+2+1) input rows read once."""
    return KernelModel(
        name="picp",
        matmul_flops=0.0,
        vector_ops=GN_OPS_PER_POINT_ROUND * n * rounds,
        hbm_bytes=4.0 * 6 * n,
    )


def frame_model(frames: int, s: int, depth: int, rounds: int) -> KernelModel:
    """The frame-loop kernel (ops/pallas/frame_kernel.py), per launch.

    Per frame: ``depth`` triangulations of the join candidates and one of
    the frame itself (TRI_OPS_PER_POINT each), the chain select and pose
    transform ~(6*depth + 18) per lane, and the GN rounds. Bytes: the
    (5 + 5*depth) input rows and 4 output rows of S f32 per frame.
    """
    per_frame = s * (
        (depth + 1) * TRI_OPS_PER_POINT
        + 6.0 * depth + 18.0
        + GN_OPS_PER_POINT_ROUND * rounds
    )
    return KernelModel(
        name="frame",
        matmul_flops=0.0,
        vector_ops=frames * per_frame,
        hbm_bytes=frames * 4.0 * (5 + 5 * depth + 4) * s,
    )


def sparse_ba_model(n: int, f: int, l: int, cg_iters: int) -> KernelModel:
    """One LM iteration of the packed sparse Schur-CG BA
    (parallel/sparse_ba.sparse_ba_step with lm_degree set).

    The step is bandwidth-bound: every stage streams (N, R)
    per-observation row blocks. Byte counts are LOWER bounds — only operands that must cross
    HBM at least once are counted, assuming XLA fuses every elementwise
    chain (intermediates that a fusion keeps in registers are free, the
    segment-sum reshape-reduce reads its input once):

      * assembly (_build_reduced): per-obs inputs uv/idx/mask ~5N reads;
        the four sqrt-weighted Jacobian row blocks written then re-read by
        the outer products (2 * 18N); pose/landmark outer products
        written+read through the segment sums (2 * 45N); the
        preconditioner's coupling correction (w_n 18N written+read, y_n/
        diag 2 * 54N) — ~220N floats, plus 2 * 9L for H_ll/its inverse.
      * each CG matvec (_coupling_apply + the H_pp diagonal term): the row
        blocks re-read (18N), the landmark-stage intermediates u/mn
        (2 * 3N write+read), mask (N), h_ll_inv (9L) — ~31N + 9L floats.
      * back-substitution: one more matvec-shaped pass (~31N + 9L).

    Vector ops (FMA = 1): assembly ~320/obs (projection+Jacobians ~110,
    outers 45+9, preconditioner correction ~150), matvec ~45/obs. No
    matmul: the 6-wide pose blocks are far too small for one, which is
    why the formulation is segment sums (module docstring).
    """
    floats = (220.0 * n + 18.0 * l) + (cg_iters + 1) * (31.0 * n + 9.0 * l)
    return KernelModel(
        name="sparse_ba",
        matmul_flops=0.0,
        vector_ops=320.0 * n + (cg_iters + 1) * 45.0 * n,
        hbm_bytes=4.0 * floats,
    )
