"""Scaling-efficiency evidence: sharded runs do no duplicated tracking work.

On the virtual CPU mesh wall-clock is capped by the host's physical cores
(parallel/scaling.py docstring), so these tests pin down the property that
governs scaling on real cards: the compiled per-device work partition.
"""

import jax
import numpy as np
import pytest

from visual_odometry_tpu.parallel import scaling


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices")
    return d


def test_dp_sharding_partitions_work_exactly(devices):
    """dp tracker: per-device compiled FLOPs at n devices == total/n
    (partition_efficiency 1.0) — the sharded run duplicates nothing."""
    rows = scaling.measure_dp_scaling(
        devices, [1, 2, 8], seqs_total=8, frames=10, n_slots=32,
        gn_iterations=5, reps=1,
    )
    assert [r["n_devices"] for r in rows] == [1, 2, 8]
    for r in rows[1:]:
        assert r["partition_efficiency"] >= 0.95, r
    # Absolute check, independent of the ratio helper: 8-way shard does
    # 1/8 of the single-device FLOPs per device.
    f1, f8 = rows[0]["flops_per_device"], rows[2]["flops_per_device"]
    np.testing.assert_allclose(f8, f1 / 8, rtol=0.05)


def test_sp_chunking_bounded_redundancy(devices):
    """Chunked (sequence-parallel) tracker: per-device work is the chunk's
    share plus the overlap redundancy — far below duplicating the
    sequence, and within the (chunk_len / exclusive_frames) bound."""
    frames, n, overlap = 24, 4, 4
    rows = scaling.measure_sp_scaling(
        devices, [1, n], frames=frames, n_slots=32, overlap=overlap,
        gn_iterations=5, reps=1,
    )
    f1 = rows[0]["flops_per_device"]
    fn = rows[1]["flops_per_device"]
    # Not duplicated: each device does well under half the serial work.
    assert fn < 0.5 * f1, (fn, f1)
    # Bounded redundancy: chunk_len/frames plus stitch overhead margin.
    from visual_odometry_tpu.parallel import posegraph

    _, chunk_len = posegraph.plan_chunks(frames, n, overlap, None, 0)
    assert fn <= 1.4 * f1 * chunk_len / frames, (fn, f1, chunk_len)


def test_dp_outputs_stay_sharded(devices):
    """The trajectories produced by the dp-sharded tracker keep the batch
    axis sharded over the mesh — nothing is gathered/replicated."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from visual_odometry_tpu.parallel import multiseq
    from visual_odometry_tpu.utils import synthetic
    from visual_odometry_tpu.utils.config import VOConfig

    config = VOConfig(n_slots=32, map_capacity=64, gn_iterations=5)
    camera = synthetic.default_camera()
    batch = [
        synthetic.generate_tracking_sequence(np.random.default_rng(s), 8, 32)
        for s in range(8)
    ]
    pts = jnp.asarray(np.stack([b[0] for b in batch]))
    apps = jnp.asarray(np.stack([b[1] for b in batch]))
    masks = jnp.asarray(np.stack([b[2] for b in batch]))
    mesh = Mesh(np.asarray(devices[:8]), ("dp",))
    traj, _, _ = multiseq.run_sequences_batched(
        camera, config, pts, apps, masks, mesh=mesh
    )
    sharding = traj.sharding
    assert sharding.is_equivalent_to(
        NamedSharding(mesh, P("dp")), traj.ndim
    ), sharding
