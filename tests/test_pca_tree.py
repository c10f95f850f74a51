"""PCA-split tree: exact-vs-approximate cross-checks.

The port of ``eigen_kdtree_test.cpp:42-67``: validate the one-sided
(`bestMatchFast`-style) search against the exact dense search per query.
"""

import numpy as np
import jax.numpy as jnp

from visual_odometry_tpu.ops import matching, pca_tree


def _random_set(rng, n, d=10):
    pts = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    mask = np.ones(n, bool)
    return jnp.asarray(pts), jnp.asarray(mask)


def test_codes_partition_points(rng):
    pts, mask = _random_set(rng, 256)
    tree = pca_tree.build_tree(pts, mask, levels=4)
    codes = np.asarray(tree.codes)
    assert codes.min() >= 0 and codes.max() < 16
    # The PCA split at the mean is roughly balanced at every level.
    counts = np.bincount(codes, minlength=16)
    assert counts.max() < 256 // 2


def test_dead_slots_get_code_minus_one(rng):
    pts, _ = _random_set(rng, 64)
    mask = jnp.asarray(np.arange(64) < 40)
    tree = pca_tree.build_tree(pts, mask, levels=3)
    codes = np.asarray(tree.codes)
    assert (codes[40:] == -1).all()
    assert (codes[:40] >= 0).all()


def test_fast_match_agrees_with_exact_in_same_leaf(rng):
    """Whenever fast finds a match, it is the exact NN restricted to the leaf."""
    db, db_mask = _random_set(rng, 200)
    q, q_mask = _random_set(rng, 64)
    tree = pca_tree.build_tree(db, db_mask, levels=3)
    idx, found = pca_tree.best_match_fast(tree, db, q, q_mask, radius=0.8)
    codes = np.asarray(tree.codes)
    q_codes = np.asarray(pca_tree.descend(tree, q))
    dbn = np.asarray(db)
    qn = np.asarray(q)
    for i in range(64):
        leaf = np.where(codes == q_codes[i])[0]
        if len(leaf) == 0:
            assert not bool(found[i])
            continue
        d = np.sum((dbn[leaf] - qn[i]) ** 2, axis=1)
        if bool(found[i]):
            assert int(idx[i]) == leaf[int(np.argmin(d))]
            assert d.min() < 0.8**2
        else:
            assert d.min() >= 0.8**2


def test_fast_vs_full_cross_check(rng):
    """Port of eigen_kdtree_test: fast matches the full search on most queries.

    The reference's test prints FAST Correct / Not Correct per query; here we
    assert the agreement is the overwhelming majority (one-sided descent only
    errs when the NN straddles a split plane).
    """
    db, db_mask = _random_set(rng, 500, d=3)
    # queries are the db points themselves, like eigen_kdtree_test.cpp:42-46
    tree = pca_tree.build_tree(db, db_mask, levels=4)
    idx_fast, found_fast = pca_tree.best_match_fast(tree, db, db, db_mask, 0.2)
    # Exact answer: each point's NN within radius is itself (distance 0).
    assert bool(found_fast.all())
    np.testing.assert_array_equal(np.asarray(idx_fast), np.arange(500))

    # Perturbed queries: compare against the exact dense search.
    q = db + jnp.asarray(
        np.random.default_rng(7).normal(0, 0.01, (500, 3)).astype(np.float32)
    )
    idx_fast, found_fast = pca_tree.best_match_fast(tree, db, q, db_mask, 0.2)
    d = np.asarray(matching.pairwise_sq_dists(q, db))
    exact_idx = d.argmin(1)
    exact_found = d.min(1) < 0.2**2
    agree = (np.asarray(found_fast) == exact_found) & (
        ~exact_found | (np.asarray(idx_fast) == exact_idx)
    )
    assert agree.mean() > 0.9


def test_fast_radius_is_subset_of_full_radius(rng):
    db, db_mask = _random_set(rng, 128)
    q, q_mask = _random_set(rng, 32)
    tree = pca_tree.build_tree(db, db_mask, levels=3)
    fast = np.asarray(pca_tree.fast_radius_search(tree, db, q, q_mask, 0.9))
    full = np.asarray(matching.radius_search(q, q_mask, db, db_mask, 0.9))
    assert (fast <= full).all()  # every fast hit is a true within-radius hit
    assert fast.sum() > 0


def test_build_and_query_jit(rng):
    import jax

    db, db_mask = _random_set(rng, 64)
    q, q_mask = _random_set(rng, 16)

    @jax.jit
    def go(db, db_mask, q, q_mask):
        tree = pca_tree.build_tree(db, db_mask, levels=3)
        return pca_tree.best_match_fast(tree, db, q, q_mask, 0.5)

    idx, found = go(db, db_mask, q, q_mask)
    assert idx.shape == (16,)
    assert found.dtype == jnp.bool_
