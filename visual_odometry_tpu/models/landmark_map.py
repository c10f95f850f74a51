"""Fixed-capacity landmark map with exact-appearance merge, on device.

Re-design of ``PointCloudVector::update``
(``/root/reference/include/PointCloud.h:52-66``): the reference linearly
scans the whole map per incoming point (O(map x new) on the host, the
hottest non-solver loop per SURVEY.md §3.1); here the merge is one
(new x capacity) equality matrix + argmax + two scatters, entirely inside
jit. Appearance identity is EXACT float equality (PointCloud.h:56 —
appearances act as opaque landmark keys, SURVEY.md §6 gotcha 4); they are
carried verbatim and never recomputed, so exact equality is well defined
even in float32.

Merge semantics preserved exactly:
  * an incoming point whose appearance equals an existing entry's REPLACES
    that entry's position (first match in insertion order);
  * otherwise it is APPENDED, in incoming order;
  * appearances are never modified.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..ops import se3

Array = jnp.ndarray


class LandmarkMap(NamedTuple):
    points: Array       # (C, 3)
    appearances: Array  # (C, D)
    valid: Array        # (C,) bool
    count: Array        # () int32 number of live entries (prefix of slots)

    @classmethod
    def empty(cls, capacity: int, appearance_dim: int = 10, dtype=jnp.float32) -> "LandmarkMap":
        return cls(
            points=jnp.zeros((capacity, 3), dtype),
            # Padding appearance is +inf-ish and unique-ish; real appearances
            # can never equal it so empty slots never absorb an update.
            appearances=jnp.full((capacity, appearance_dim), jnp.inf, dtype),
            valid=jnp.zeros((capacity,), bool),
            count=jnp.zeros((), jnp.int32),
        )


def update(map_state: LandmarkMap, points: Array, appearances: Array, mask: Array) -> LandmarkMap:
    """Merge a cloud into the map (PointCloud.h:52-66 semantics).

    Args:
      points: (N, 3) incoming positions.
      appearances: (N, D) incoming appearance keys (exact-match identity).
      mask: (N,) live incoming entries.

    Incoming entries beyond remaining capacity are dropped (the reference
    grows unboundedly; our capacity is a config knob sized to the dataset).
    """
    cap = map_state.points.shape[0]
    # (N, C) exact-equality: all D components equal AND the slot is live.
    eq = jnp.all(appearances[:, None, :] == map_state.appearances[None, :, :], axis=-1)
    eq = eq & map_state.valid[None, :] & mask[:, None]
    found = jnp.any(eq, axis=1)                      # (N,)
    match_idx = jnp.argmax(eq, axis=1).astype(jnp.int32)  # first match

    # Replace matched entries' positions. Two live incoming entries can only
    # target the same map slot if they share an appearance key (excluded by
    # construction: keys are unique landmark identities).
    safe_idx = jnp.where(found, match_idx, cap)  # cap == dropped
    new_points = map_state.points.at[safe_idx].set(points, mode="drop")

    # Append the rest, in incoming order, at count + running offset.
    append = mask & ~found
    offsets = jnp.cumsum(append.astype(jnp.int32)) - 1   # (N,)
    pos = jnp.where(append, map_state.count + offsets, cap)
    pos = jnp.where(pos < cap, pos, cap)  # overflow -> dropped
    new_points = new_points.at[pos].set(points, mode="drop")
    new_apps = map_state.appearances.at[pos].set(appearances, mode="drop")
    new_valid = map_state.valid.at[pos].set(True, mode="drop")
    n_appended = jnp.sum((append & (pos < cap)).astype(jnp.int32))
    return LandmarkMap(
        points=new_points,
        appearances=new_apps,
        valid=new_valid,
        count=map_state.count + n_appended,
    )


def transform(map_state: LandmarkMap, pose: Array) -> LandmarkMap:
    """Apply an isometry to all points (PointCloud.h:77-82); appearances kept."""
    return map_state._replace(points=se3.transform_points(pose, map_state.points))


def compact(map_state: LandmarkMap) -> Tuple[Array, Array]:
    """Host-side helper: live (points, appearances) in insertion order."""
    import numpy as np

    valid = np.asarray(map_state.valid)
    return np.asarray(map_state.points)[valid], np.asarray(map_state.appearances)[valid]


def merge_stream(
    points: Array, appearances: Array, mask: Array, capacity: int
) -> LandmarkMap:
    """Fold a TIME-ORDERED observation stream into a map in ONE batched pass.

    Equivalent to iterating :func:`update` over the stream (for the
    unique-key-per-frame data the tracker produces), but O(1) in the number
    of frames: a scatter-heavy sequential merge becomes sort -> group ->
    select, the standard accelerator form of key-wise aggregation.

      * group: rows with bit-identical appearance keys (exact float
        equality, PointCloud.h:56 — -0.0 is canonicalized to +0.0 first so
        bit equality == float equality on real data);
      * per group, the FINAL position is the LAST observation's (each
        re-observation replaces the stored position, PointCloud.h:56-59);
      * groups enter the map in FIRST-observation order (append order,
        PointCloud.h:61-63), truncated at ``capacity``.

    Args:
      points: (T, 3) stream of observed positions, time-ordered.
      appearances: (T, D) appearance keys.
      mask: (T,) live rows.
      capacity: map capacity (static).
    """
    import jax

    t, d = appearances.shape
    dtype = points.dtype
    big = jnp.int32(2**31 - 1)

    apps_c = appearances + jnp.zeros((), dtype)  # -0.0 -> +0.0
    keys = jax.lax.bitcast_convert_type(apps_c, jnp.int32)  # (T, D)
    keys = jnp.where(mask[:, None], keys, big)
    time = jnp.where(mask, jnp.arange(t, dtype=jnp.int32), jnp.int32(t))

    # Sort 1: group identical keys, time-ascending within each group,
    # payloads (points, mask) carried THROUGH the sort instead of a
    # keys-plus-row-index sort followed by payload gathers.
    s = jax.lax.sort(
        tuple(keys[:, i] for i in range(d))
        + (time, points[:, 0], points[:, 1], points[:, 2], mask),
        num_keys=d + 1,
    )
    skeys = jnp.stack(s[:d], axis=1)
    stime = s[d]
    spts = jnp.stack(s[d + 1:d + 4], axis=1)
    smask = s[d + 4]

    new_group = jnp.concatenate(
        [jnp.ones((1,), bool), jnp.any(skeys[1:] != skeys[:-1], axis=1)]
    )
    # Per row, its group's LAST observation position (groups are
    # time-ascending runs): a reverse segmented fill — the run's final row
    # propagates backwards to every member. No segment-max scatter, no
    # gather (both serialize on the scalar core).
    last_of_run = jnp.concatenate([new_group[1:], jnp.ones((1,), bool)])

    def fill(a, b):
        # In a reverse scan the SECOND argument is the block nearer the
        # row itself (lower index); its boundary flag takes priority —
        # verified against the [3,3,3,6,6,6] oracle.
        (vx, vy, vz, r1), (wx, wy, wz, r2) = a, b
        return (
            jnp.where(r2, wx, vx),
            jnp.where(r2, wy, vy),
            jnp.where(r2, wz, vz),
            r1 | r2,
        )

    fx, fy, fz, _ = jax.lax.associative_scan(
        fill, (spts[:, 0], spts[:, 1], spts[:, 2], last_of_run), reverse=True
    )

    is_entry = new_group & smask  # one row per real landmark (the first obs)
    order_key = jnp.where(is_entry, stime, jnp.int32(t + 1))

    # Sort 2: entries by first-observation time = the reference append
    # order (lax.sort is stable: ties keep sort-1 order, as the previous
    # explicit row-index tiebreak did), again payload-carrying.
    s2 = jax.lax.sort(
        (order_key, fx, fy, fz, is_entry)
        + tuple(skeys[:, i] for i in range(d)),
        num_keys=1,
    )
    pts_out = jnp.stack(s2[1:4], axis=1)
    entry_out = s2[4]
    keys_out = jnp.stack(s2[5:5 + d], axis=1)

    if t >= capacity:
        pts_out = pts_out[:capacity]
        keys_out = keys_out[:capacity]
        entry_out = entry_out[:capacity]
    else:
        pad = capacity - t
        pts_out = jnp.pad(pts_out, ((0, pad), (0, 0)))
        keys_out = jnp.pad(keys_out, ((0, pad), (0, 0)), constant_values=big)
        entry_out = jnp.pad(entry_out, (0, pad))

    apps_out = jax.lax.bitcast_convert_type(keys_out, dtype)
    apps_out = jnp.where(entry_out[:, None], apps_out, jnp.asarray(jnp.inf, dtype))
    pts_out = jnp.where(entry_out[:, None], pts_out, jnp.zeros((), dtype))
    count = jnp.sum(entry_out.astype(jnp.int32))
    return LandmarkMap(
        points=pts_out, appearances=apps_out, valid=entry_out, count=count
    )
