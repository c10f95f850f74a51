"""Device-mesh helpers.

The reference is single-threaded C++ with no communication layer
(SURVEY.md §2 "Parallelism ... none"); this framework's distribution axes
are (per BASELINE.json's north star and SURVEY.md §5):

  * ``dp``  — data parallel over sequences / keyframe windows;
  * ``lm``  — model-state parallel over landmark blocks (the axis the
              distributed bundle adjustment and the sharded matcher
              reduce over).

Collectives are XLA's (``psum``/``all_gather``/``ppermute``) via
``shard_map`` over a :class:`jax.sharding.Mesh`; on GPUs XLA hands them to
NCCL. The mesh follows the algorithm alone: the cards of one host are
joined all to all, so no device order is better than another.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = ("dp", "lm"),
    dp_size: Optional[int] = None,
) -> Mesh:
    """Build a (dp, lm) mesh over the first ``n_devices`` devices.

    ``dp_size`` defaults to the largest power-of-two divisor <= sqrt(n):
    landmark sharding usually wants the larger share of the mesh since the
    landmark axis is the big one.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if dp_size is None:
        dp_size = 1
        while n_devices % (dp_size * 2) == 0 and dp_size * dp_size * 4 <= n_devices:
            dp_size *= 2
    if n_devices % dp_size:
        raise ValueError(f"dp_size {dp_size} does not divide {n_devices}")
    arr = np.asarray(devices).reshape(dp_size, n_devices // dp_size)
    return Mesh(arr, axis_names)


def single_axis_mesh(n_devices: Optional[int] = None, name: str = "lm") -> Mesh:
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.asarray(devices[:n_devices]), (name,))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-process JAX (the NCCL/MPI-init analog).

    Call once per process before building meshes; ``jax.devices()`` then
    spans every process's devices. Pass all three arguments (coordinator
    ``host:port``, process count, this process's id) where nothing in the
    environment describes the cluster. Returns the global device count.
    No-op if already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
    return len(jax.devices())


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int, fill=0):
    """Pad ``x`` so shape[axis] divides ``multiple`` (sharding needs equal shards)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill), n
