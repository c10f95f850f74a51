"""Sharded appearance matching: landmark database split across chips.

Scales the dense matcher (``ops/matching.py``) past one device's memory:
the database (map / keyframe descriptors) is sharded over the ``lm`` mesh
axis, queries are replicated, each device computes its local top-1 via the
gram-trick matmul, and a single ``psum``-style min-reduction combines
(distance, global index) pairs. This is the multi-chip form of the
kd-tree replacement mandated by BASELINE.json (SURVEY.md §2, native ledger
item 4) — no reference counterpart exists (the reference is single-thread).

The combine encodes (distance, index) into one f32-ordered key pair and
uses ``jax.lax.pmin`` twice (on distance, then on index among distance
winners), giving the same first-minimum tie-break as a serial scan over
shards in order.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import matching

Array = jnp.ndarray

_BIG = 3.4e38  # Python literal: a module-level device scalar blocks XLA constant folding


def sharded_best_match(
    mesh: Mesh,
    db: Array,          # (L, D) database descriptors, sharded over 'lm'
    db_mask: Array,     # (L,)
    queries: Array,     # (Q, D) replicated
    q_mask: Array,      # (Q,)
    radius: float = 0.1,
    axis: str = "lm",
) -> Tuple[Array, Array]:
    """Global top-1 match per query -> (global db index | -1, sq distance).

    Semantics match ``ops.matching``: strict ``d^2 < radius^2`` acceptance,
    first global minimum wins ties.
    """
    l_total = db.shape[0]
    n_shards = mesh.shape[axis]
    if l_total % n_shards:
        raise ValueError(f"database size {l_total} not divisible by mesh axis {n_shards}")
    l_local = l_total // n_shards

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
    )
    def _match(db_s, db_mask_s, q, qm):
        dist, idx_local = matching.best_match(q, qm, db_s, db_mask_s)
        shard = jax.lax.axis_index(axis)
        idx_global = idx_local + shard * l_local
        # Min-reduce (distance, index) over the landmark axis: first take
        # the winning distance everywhere, then the smallest index among
        # shards that achieved it (serial first-min tie-break).
        best_dist = jax.lax.pmin(dist, axis)
        idx_cand = jnp.where(dist == best_dist, idx_global, jnp.int32(2**31 - 1))
        best_idx = jax.lax.pmin(idx_cand, axis)
        return best_dist, best_idx

    best_dist, best_idx = _match(db, db_mask, queries, q_mask)
    r2 = jnp.asarray(radius, best_dist.dtype) ** 2
    accept = q_mask & (best_dist < r2)
    return jnp.where(accept, best_idx, -1), best_dist


def replicate(mesh: Mesh, x: Array) -> Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_rows(mesh: Mesh, x: Array, axis: str = "lm") -> Array:
    return jax.device_put(x, NamedSharding(mesh, P(axis)))
