"""Headline benchmark: the vo_complete tracking program on one GPU.

    python bench.py

One process on one card. The workload is the reference-shaped dataset made
from a seed (utils/dataset_gen: 121 frames, 1000 landmarks, <= 115
measurements per frame, 128 slots). The run first checks accuracy against
the generator's ground truth — a fast but wrong program fails — then times
the tracking program (``pipeline.run_sequence``, the program the
``vo_complete`` CLI runs) and batched serving of 64 such sequences
(``multiseq.run_sequences_batched``), each call ended by
``jax.block_until_ready``; the reported time is the median of the steady
calls. Prints one JSON line naming the device and the card's power limit.
Exits non-zero, printing no result, without a GPU or when a check fails.
"""

import json
import sys
import time

import numpy as np

SEED = 0
REPS = 20
SERVING_BATCH = 64
# Ground-truth guard for the seeded drive (see chip_smoke.py): a working
# tracker lands at e_theta ~1e-6..1e-5 and position RMSE ~0.05..0.3 m.
E_THETA_MAX = 2e-5
RMSE_MAX = 0.6


def main() -> int:
    import jax

    import visual_odometry_tpu  # noqa: F401  (precision and cache policy)
    from visual_odometry_tpu.models import pipeline
    from visual_odometry_tpu.ops.camera import Camera
    from visual_odometry_tpu.parallel import multiseq
    from visual_odometry_tpu.utils import dataset_gen, evaluation, io, profiling
    from visual_odometry_tpu.utils.config import DEFAULT_CONFIG

    dev = profiling.require_gpu()
    card = profiling.card_info()
    cam = Camera.create(
        dataset_gen.K, rows=dataset_gen.HEIGHT, cols=dataset_gen.WIDTH,
        z_near=dataset_gen.Z_NEAR, z_far=dataset_gen.Z_FAR,
    )
    sims = [
        dataset_gen.simulate(seed=SEED + i, **dataset_gen.REFERENCE_SHAPE)
        for i in range(SERVING_BATCH)
    ]
    seqs = [dataset_gen.padded_sequence(s, DEFAULT_CONFIG.n_slots) for s in sims]
    one = jax.device_put(seqs[0])
    batch = jax.device_put(tuple(np.stack([q[j] for q in seqs]) for j in range(3)))
    frames = int(one[2].shape[0])

    # Guard: the workload validated once (join overflow) and accurate; its
    # first call compiles.
    t0 = time.perf_counter()
    traj, _, _ = jax.block_until_ready(pipeline.run_sequence(cam, DEFAULT_CONFIG, *one))
    first = time.perf_counter() - t0
    res = evaluation.evaluate(
        io.robot_trajectory(np.asarray(traj), dataset_gen.CAM_IN_ROBOT),
        io.gt_poses_se3(sims[0].gt),
    )
    fin = np.isfinite(res.orientation_errors)
    e_theta = float(np.abs(res.orientation_errors[fin]).mean())
    if not (e_theta < E_THETA_MAX and res.rmse_position < RMSE_MAX):
        raise AssertionError(f"accuracy: e_theta {e_theta} rmse {res.rmse_position}")

    _, steady, _ = profiling.timed(
        lambda: pipeline.run_sequence(cam, DEFAULT_CONFIG, *one, validate=False),
        reps=REPS,
    )
    s_first, s_steady, _ = profiling.timed(
        lambda: multiseq.run_sequences_batched(
            cam, DEFAULT_CONFIG, *batch, validate=False),
        reps=5,
    )
    print(json.dumps({
        "metric": "vo_pipeline_throughput",
        "value": frames / steady,
        "unit": "frames/s",
        "steady_s": steady,
        "compile_s": first - steady,
        "serving_batch": SERVING_BATCH,
        "serving_frames_per_s": SERVING_BATCH * frames / s_steady,
        "serving_compile_s": s_first - s_steady,
        "e_theta": e_theta,
        "rmse_pos": float(res.rmse_position),
        "peak_bytes": int(dev.memory_stats().get("peak_bytes_in_use", 0)),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
