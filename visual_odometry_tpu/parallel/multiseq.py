"""Data-parallel tracking: many sequences in flight on one device or a mesh.

The reference processes one sequence in one thread; the frame loop is
inherently serial (SURVEY.md §7 "hard parts"), so tracking throughput
scales by batch parallelism over independent sequences (or keyframe
windows of one long sequence). The whole vo_complete program
(models/pipeline._run) is vmapped over a leading batch axis:
pose-independent stages (pair matching, join candidates, gathers, the map
fold) batch into bigger XLA kernels, and on the fused backend the frame
loop kernel (ops/pallas/frame_kernel) runs one Pallas program per
sequence, so B sequences occupy B of the card's SMs at once.

Across devices the batch axis is sharded over the ``dp`` mesh axis with
``shard_map`` (zero cross-device communication: sequences are
independent, and each device runs its shard of the batch as one local
program).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import pipeline
from ..models.landmark_map import LandmarkMap
from ..ops.camera import Camera
from ..utils.config import VOConfig

Array = jnp.ndarray


def _run_local(camera: Camera, config: VOConfig, points, appearances, masks):
    ids = jnp.full(masks.shape, -1, jnp.int32)

    def one(p, a, m, i):
        return pipeline._run(camera, config, p, a, m, i, False)

    return jax.vmap(one)(points, appearances, masks, ids)


_run_batch = jax.jit(_run_local, static_argnames=("config",))


@functools.lru_cache(maxsize=None)
def _sharded_fn(mesh: Mesh, dp_axis: str, config: VOConfig):
    spec = P(dp_axis)

    @jax.jit
    def sharded(camera, points, appearances, masks):
        return jax.shard_map(
            lambda c, p, a, m: _run_local(c, config, p, a, m),
            mesh=mesh,
            in_specs=(P(), spec, spec, spec),
            out_specs=spec,
            # Pallas calls don't annotate varying mesh axes on their
            # outputs; per-shard independence is the whole design (no
            # collectives), so the check buys nothing.
            check_vma=False,
        )(camera, points, appearances, masks)

    return sharded


def run_sequences_batched(
    camera: Camera,
    config: VOConfig,
    points: Array,        # (B, F, S, 2)
    appearances: Array,   # (B, F, S, D)
    masks: Array,         # (B, F, S)
    mesh: Optional[Mesh] = None,
    dp_axis: str = "dp",
    validate: bool = True,
) -> Tuple[Array, LandmarkMap, pipeline.FrameOutput]:
    """Track B sequences at once; returns batched (trajectories, maps, outs).

    The frame loop runs on ``config.scan_backend`` exactly as in
    :func:`pipeline.run_sequence`, per sequence. With ``mesh`` the batch
    axis is sharded over ``dp_axis`` (B must divide by the axis size).
    ``validate`` runs the fused world-join exactness guard on the result
    (pipeline.check_join_overflow — a scalar fetch); throughput harnesses
    that queue batches asynchronously can defer it after checking the
    workload once.
    """
    if mesh is None:
        out = _run_batch(camera, config, points, appearances, masks)
    else:
        b, n_dev = points.shape[0], mesh.shape[dp_axis]
        if b % n_dev:
            raise ValueError(f"batch {b} does not divide over {n_dev} devices")
        ns = NamedSharding(mesh, P(dp_axis))
        out = _sharded_fn(mesh, dp_axis, config)(
            camera,
            jax.device_put(points, ns),
            jax.device_put(appearances, ns),
            jax.device_put(masks, ns),
        )
    if validate:
        pipeline.check_join_overflow(out[2])
    return out
