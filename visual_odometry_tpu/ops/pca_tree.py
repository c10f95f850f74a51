"""Batched PCA-split tree: the kd-tree as static-shape array code.

The reference's data-association structure is a pointer-chasing binary tree
that recursively splits a point set at the masked mean along the covariance's
largest eigenvector (``/root/reference/include/eigen_kdtree.h:18-38``,
``split.h:8-34``, ``eigen_covariance.h:5-43``). Pointer recursion is the
wrong shape for an accelerator, but the *split geometry* itself vectorizes
perfectly:

  * building level ``l`` means computing a masked mean/covariance for each of
    the ``2^l`` nodes **simultaneously** — one one-hot matmul for the means,
    one einsum for the covariances, one vmapped ``eigh`` for the
    principal axes;
  * a point's leaf assignment is a *code*: at each level, project onto the
    node's principal axis and compare against the node's mean projection —
    the bit sequence of those comparisons is the root-to-leaf path.

The result is a flat, static-shape tree: ``axes (2^L - 1, D)`` and
``thresholds (2^L - 1,)`` indexed by heap order (node of level ``l`` with
in-level code ``c`` lives at ``2^l - 1 + c``). Everything jits; depth ``L``
is the only static parameter (the reference instead splits until a leaf holds
< 10 points, vo_complete.cpp:35 — with N points, ``L ≈ log2(N / 10)``).

Query semantics mirror the reference exactly:

  * :func:`best_match_fast` descends ONE side at every node — approximate,
    like ``TreeNode_::bestMatchFast`` (eigen_kdtree.h:75-85): it misses a
    true neighbour that sits across a split plane.
  * the exact search ``bestMatchFull`` (eigen_kdtree.h:90-115) visits both
    sides whenever the query ball straddles the plane and therefore returns
    the brute-force answer — here that IS the dense matcher
    (:func:`visual_odometry_tpu.ops.matching.match_appearances`), which is
    exact by construction; no tree needed.
  * :func:`fast_radius_search` is the analogue of ``fastSearch``
    (eigen_kdtree.h:40-52): all within-radius points of the one leaf the
    query descends to.

The dense matcher remains the production path (SURVEY.md §2 native ledger
item 4); this module exists for (a) API parity with the reference's
approximate-search surface, (b) the exact-vs-approximate cross-check test
(eigen_kdtree_test.cpp:42-67), and (c) candidate pruning at map sizes where
the dense N×M matrix stops being free.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import stats

Array = jnp.ndarray

_BIG = 3.4e38  # Python literal: a module-level device scalar blocks XLA constant folding


class PCATree(NamedTuple):
    """Flat heap-ordered PCA-split tree over a padded point set.

    ``axes[k]`` / ``thresholds[k]`` define node ``k``'s split plane
    (heap index ``k = 2^l - 1 + code``). ``codes[i]`` is point ``i``'s leaf
    id in ``[0, 2^levels)``; dead slots (mask 0) carry code ``-1``.
    """

    axes: Array        # (2^L - 1, D)
    thresholds: Array  # (2^L - 1,)
    codes: Array       # (N,) int32, -1 for dead slots
    levels: int        # static depth L


def build_tree(points: Array, mask: Array, levels: int) -> PCATree:
    """Build all ``2^levels - 1`` split planes level-synchronously.

    Per level: one-hot node membership (N, 2^l) -> masked per-node mean via
    a single matmul, per-node covariance via one einsum, vmapped ``eigh``
    for the principal axes (eigen_kdtree.h:27-29 semantics, computed for
    every node of the level at once).
    """
    n, d = points.shape
    codes = jnp.where(mask, 0, -1).astype(jnp.int32)
    all_axes = []
    all_thr = []
    for level in range(levels):
        nb = 1 << level
        node_ids = jnp.arange(nb, dtype=jnp.int32)
        member = (codes[:, None] == node_ids[None, :]).astype(points.dtype)  # (N, nb)
        count = jnp.sum(member, axis=0)  # (nb,)
        safe = jnp.maximum(count, 1.0)
        mean = (member.T @ points) / safe[:, None]  # (nb, D)
        centered = points[:, None, :] - mean[None, :, :]  # (N, nb, D)
        cov = jnp.einsum("nb,nbi,nbj->bij", member, centered, centered)
        cov = cov / jnp.maximum(count - 1.0, 1.0)[:, None, None]
        axis = stats.largest_eigenvector(cov)  # (nb, D)
        thr = jnp.sum(mean * axis, axis=-1)  # (nb,) mean projection = plane offset
        all_axes.append(axis)
        all_thr.append(thr)
        # Descend: each live point compares its projection on ITS node's axis.
        own = jnp.clip(codes, 0, nb - 1)
        proj = jnp.sum(points * axis[own], axis=-1)
        bit = (proj > thr[own]).astype(jnp.int32)
        codes = jnp.where(codes >= 0, codes * 2 + bit, -1)
    return PCATree(
        axes=jnp.concatenate(all_axes, axis=0),
        thresholds=jnp.concatenate(all_thr, axis=0),
        codes=codes,
        levels=levels,
    )


def descend(tree: PCATree, queries: Array) -> Array:
    """Leaf code of each query under one-sided descent (eigen_kdtree.h:75-85).

    Static unrolled loop of ``levels`` projection steps; each step is a
    gather of (axis, threshold) by heap index plus one dot per query.
    """
    code = jnp.zeros(queries.shape[:-1], dtype=jnp.int32)
    for level in range(tree.levels):
        node = (1 << level) - 1 + code
        axis = tree.axes[node]
        thr = tree.thresholds[node]
        bit = (jnp.sum(queries * axis, axis=-1) > thr).astype(jnp.int32)
        code = code * 2 + bit
    return code


def best_match_fast(
    tree: PCATree,
    db_points: Array,
    queries: Array,
    q_mask: Array,
    radius: float,
) -> Tuple[Array, Array]:
    """Approximate nearest neighbour: brute force within the query's own leaf.

    Mirrors ``bestMatchFast`` (eigen_kdtree.h:75-85 ->
    brute_force_search.h:22-41): descend one side per level, then leaf-local
    best match with a STRICT ``distance² < radius²`` acceptance. Returns
    ``(index (Q,), found (Q,))``; like the reference it can miss a true
    neighbour lying across a split plane.
    """
    q_codes = descend(tree, queries)  # (Q,)
    d = _pairwise_sq(queries, db_points)  # (Q, N)
    same_leaf = q_codes[:, None] == tree.codes[None, :]  # dead db slots are -1
    d = jnp.where(same_leaf, d, _BIG)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.min(d, axis=1)
    r2 = jnp.asarray(radius, d.dtype) ** 2
    found = q_mask & (best < r2)
    return idx, found


def fast_radius_search(
    tree: PCATree,
    db_points: Array,
    queries: Array,
    q_mask: Array,
    radius: float,
) -> Array:
    """All within-radius db points in the query's own leaf, as a (Q, N) mask.

    Mirrors ``fastSearch`` (eigen_kdtree.h:40-52): one-sided descent, then
    the leaf's brute-force radius scan (strict ``<``,
    brute_force_search.h:3-20).
    """
    q_codes = descend(tree, queries)
    d = _pairwise_sq(queries, db_points)
    r2 = jnp.asarray(radius, d.dtype) ** 2
    return (
        (q_codes[:, None] == tree.codes[None, :])
        & (d < r2)
        & q_mask[:, None]
    )


def _pairwise_sq(a: Array, b: Array) -> Array:
    a2 = jnp.sum(a * a, -1)
    b2 = jnp.sum(b * b, -1)
    gram = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * gram, 0.0)
