import numpy as np
import jax.numpy as jnp

from visual_odometry_tpu.ops import matching


def _oracle(app1, mask1, app2, mask2, radius=0.1):
    """Literal port of the kd-side selection + bruteForceBestMatch semantics
    (vo_complete.cpp:12-49, brute_force_search.h:22-41)."""
    n1, n2 = int(mask1.sum()), int(mask2.sum())
    kd_is_1 = n1 >= n2
    kd_app, kd_mask = (app1, mask1) if kd_is_1 else (app2, mask2)
    q_app, q_mask = (app2, mask2) if kd_is_1 else (app1, mask1)
    pairs = []
    for qi in range(len(q_app)):
        if not q_mask[qi]:
            continue
        best, best_d = None, radius * radius
        for ki in range(len(kd_app)):
            if not kd_mask[ki]:
                continue
            d = float(((kd_app[ki] - q_app[qi]) ** 2).sum())
            if d < best_d:
                best, best_d = ki, d
        if best is not None:
            pairs.append((best, qi) if kd_is_1 else (qi, best))
    return pairs


def _run(app1, mask1, app2, mask2, radius=0.1):
    corr = matching.match_appearances(
        jnp.asarray(app1), jnp.asarray(mask1), jnp.asarray(app2), jnp.asarray(mask2), radius
    )
    got = [
        (int(a), int(b))
        for a, b, v in zip(np.array(corr.idx1), np.array(corr.idx2), np.array(corr.valid))
        if v
    ]
    return got


def test_matches_oracle_exact_duplicated_appearances(rng):
    # Landmark-style data: frame 2 shares most appearances with frame 1 exactly.
    n = 64
    base = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    perm = rng.permutation(n)
    app2 = base[perm].copy()
    app2[:10] = rng.uniform(-1, 1, (10, 10))  # 10 unmatched newcomers
    mask = np.ones(n, bool)
    got = _run(base, mask, app2, mask)
    expected = _oracle(base, mask, app2, mask)
    assert sorted(got) == sorted(expected)
    assert len(got) >= n - 12


def test_query_side_follows_counts(rng):
    n = 32
    app = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    mask1 = np.ones(n, bool)
    mask2 = np.ones(n, bool)
    mask2[20:] = False  # frame 2 smaller -> queries come from frame 2
    app2 = app.copy()
    got = _run(app, mask1, app2, mask2)
    expected = _oracle(app, mask1, app2, mask2)
    assert sorted(got) == sorted(expected)
    # every valid frame-2 point matches itself
    assert sorted(got) == [(i, i) for i in range(20)]

    # Now frame 1 smaller: queries from frame 1.
    got = _run(app, mask2, app2, mask1)
    expected = _oracle(app, mask2, app2, mask1)
    assert sorted(got) == sorted(expected)


def test_radius_is_strict(rng):
    app1 = np.zeros((8, 10), np.float32)
    app2 = np.zeros((8, 10), np.float32)
    mask = np.zeros(8, bool)
    mask[:1] = True
    # distance exactly == radius must NOT match (strict <, brute_force_search.h:35)
    app2[0, 0] = 0.1
    assert _run(app1, mask, app2, mask, radius=0.1) == []
    app2[0, 0] = 0.0999
    assert _run(app1, mask, app2, mask, radius=0.1) == [(0, 0)]


def test_padded_slots_never_match(rng):
    app1 = rng.uniform(-1, 1, (16, 10)).astype(np.float32)
    app2 = app1.copy()
    mask1 = np.ones(16, bool)
    mask2 = np.ones(16, bool)
    mask1[8:] = False
    got = _run(app1, mask1, app2, mask2)
    assert all(a < 8 for a, _ in got)
