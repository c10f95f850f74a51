"""Appearance-based data association as a dense batched top-1 matcher.

Replacement for the reference's PCA-split kd-tree stack
(``/root/reference/include/eigen_kdtree.h``, ``brute_force_search.h``,
``split.h``, ``eigen_covariance.h``) and the per-frame glue
``compute_correspondences_images`` (``/root/reference/src/apps/vo_complete.cpp:12-49``).

A pointer-chasing kd-tree is the wrong shape for an accelerator; per
SURVEY.md §2 (native ledger item 4) we instead compute the full pairwise
squared-distance matrix with the gram trick — ``||a-b||² = ||a||² + ||b||²
- 2 a·bᵀ`` — whose inner product is one matmul, then take a masked argmin. This is *exact*:
``TreeNode_::bestMatchFull`` (eigen_kdtree.h:90-115) prunes only subtrees
that provably cannot contain a within-radius point, so its answer equals the
brute-force nearest neighbour within the radius
(``bruteForceBestMatch``, brute_force_search.h:22-41).

Semantics preserved exactly:
  * the id component is excluded from the metric — here ids are array
    indices, so appearances are matched directly (README.md:11);
  * a match requires squared distance STRICTLY below radius²
    (brute_force_search.h:31-37: ``best_squared_norm = norm*norm`` with
    strict ``<``); the reference radius is 0.1 (vo_complete.cpp:38);
  * the kd-tree is built over whichever frame has MORE points and queried
    from the smaller one, with output pairs fixed up to stay
    (frame-1 idx, frame-2 idx) and emitted in query order
    (vo_complete.cpp:15-46; SURVEY.md §6 gotcha 5).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

# Python literal, NOT jnp.float32(...): a module-level device scalar becomes
# a runtime operand of every program that captures it, which blocks XLA from
# folding the masking select into the argmin fusion (measured 15x slower on
# the batched pair matcher).
_BIG = 3.4e38


class Correspondences(NamedTuple):
    """Fixed-size correspondence set, ordered by query index.

    ``idx1[s]``/``idx2[s]`` index into frame 1 / frame 2 point arrays; slot
    ``s`` is live iff ``valid[s]``. The slot order matches the reference's
    push_back order (query-index order, vo_complete.cpp:37-46), which
    downstream scatter/first-wins logic relies on.
    """

    idx1: Array   # (S,) int32
    idx2: Array   # (S,) int32
    valid: Array  # (S,) bool


def pairwise_sq_dists(a: Array, b: Array) -> Array:
    """(N, D), (M, D) -> (N, M) squared euclidean distances via the gram trick.

    The descriptor axis is zero-padded to a width of 128 before the gram
    matmul: XLA's "dot strength reduction" can otherwise lower a small-K
    batched dot to a dilated CONVOLUTION (observed when this op is
    batched inside the tracking program: the D=10 gram became a
    window-119 conv at highest precision, ~30x slower than the padded
    matmul). Zero columns leave every distance bit-identical.
    """
    a2 = jnp.sum(a * a, -1)
    b2 = jnp.sum(b * b, -1)
    pad = -a.shape[-1] % 128
    if pad:
        # Norms are computed on the unpadded rows (identical reduction
        # order as before); the gram's zero columns contribute exact 0.0.
        a = jnp.pad(a, ((0, 0), (0, pad)))
        b = jnp.pad(b, ((0, 0), (0, pad)))
    gram = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    dist = a2[:, None] + b2[None, :] - 2.0 * gram
    return jnp.maximum(dist, 0.0)


def radius_search(
    queries: Array,
    q_mask: Array,
    db: Array,
    db_mask: Array,
    radius: float = 0.1,
) -> Array:
    """All-matches-within-radius as a dense boolean matrix (Q, K).

    The masked equivalent of the kd-tree radius queries
    ``fullSearch``/``bruteForceSearch`` (eigen_kdtree.h:54-70,
    brute_force_search.h:3-20): entry (q, k) is True iff both slots are
    live and ``||a_q - b_k||^2 < radius^2`` (strict, matching the
    reference's ``< squared_norm``).
    """
    d = pairwise_sq_dists(queries, db)
    r2 = jnp.asarray(radius, d.dtype) ** 2
    return (d < r2) & q_mask[:, None] & db_mask[None, :]


def best_match(
    queries: Array,
    q_mask: Array,
    db: Array,
    db_mask: Array,
) -> Tuple[Array, Array]:
    """Top-1 nearest database row per query -> (sq_distance, index).

    The dense form of the kd-tree best-match queries (``bestMatchFull``,
    eigen_kdtree.h:90-115 / ``bruteForceBestMatch``,
    brute_force_search.h:22-41): the (Q, K) distance matrix (gram matmul)
    and its first-argmin. First index wins ties, masked queries return
    _BIG, masked database rows never win.
    """
    d = pairwise_sq_dists(queries, db)
    d = jnp.where(q_mask[:, None] & db_mask[None, :], d, _BIG)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    return jnp.min(d, axis=1), idx


def match_appearances(
    app1: Array,
    mask1: Array,
    app2: Array,
    mask2: Array,
    radius: float = 0.1,
) -> Correspondences:
    """Frame-to-frame data association; returns (frame-1 idx, frame-2 idx) pairs.

    Args:
      app1: (N1, D) appearance descriptors of frame 1 (padded).
      mask1: (N1,) validity of frame-1 slots.
      app2/mask2: same for frame 2.
      radius: match radius in appearance space (reference: 0.1).

    The output has S = N2 slots ordered by query index. Which side queries
    depends on the *valid counts* (smaller side queries, ties -> frame 1 is
    the kd side, matching std::minmax at vo_complete.cpp:15-33); both
    variants are computed branchlessly from the same distance matrix and
    selected with ``where`` — the distance matrix is the entire cost anyway.
    """
    if app1.shape[0] != app2.shape[0]:
        raise ValueError("padded frames must share a slot count for static shapes")
    n = app1.shape[0]
    r2 = jnp.asarray(radius, app1.dtype) ** 2
    slots = jnp.arange(n, dtype=jnp.int32)

    n1 = jnp.sum(mask1.astype(jnp.int32))
    n2 = jnp.sum(mask2.astype(jnp.int32))
    kd_is_1 = n1 >= n2  # frame 1 has >= points -> tree over frame 1

    d = pairwise_sq_dists(app1, app2)  # (N1, N2): rows frame 1, cols frame 2
    d = jnp.where(mask1[:, None] & mask2[None, :], d, _BIG)
    # Variant A: kd = frame 1, query = frame 2 (one slot per frame-2 point).
    best1 = jnp.argmin(d, axis=0).astype(jnp.int32)  # (N2,)
    best1_d = jnp.min(d, axis=0)
    # Variant B: kd = frame 2, query = frame 1 (one slot per frame-1 point).
    best2 = jnp.argmin(d, axis=1).astype(jnp.int32)  # (N1,)
    best2_d = jnp.min(d, axis=1)

    idx1 = jnp.where(kd_is_1, best1, slots)
    idx2 = jnp.where(kd_is_1, slots, best2)
    best_d = jnp.where(kd_is_1, best1_d, best2_d)
    query_mask = jnp.where(kd_is_1, mask2, mask1)
    valid = query_mask & (best_d < r2)
    return Correspondences(idx1=idx1, idx2=idx2, valid=valid)


def match_appearances_batch(
    app1: Array,    # (B, N, D)
    mask1: Array,   # (B, N)
    app2: Array,    # (B, N, D)
    mask2: Array,   # (B, N)
    radius: float = 0.1,
) -> Correspondences:
    """Batch of frame-pair associations (one sequence's hoisted matcher):
    a vmap of :func:`match_appearances`."""
    return jax.vmap(functools.partial(match_appearances, radius=radius))(
        app1, mask1, app2, mask2
    )
