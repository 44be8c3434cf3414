"""Synthetic MovieLens-like rating graphs for tests and the chip smoke run.

The port's copy of ``synthetic_ratings`` and ``synthetic_graph`` from
``stargcn_tpu/data/synthetic.py``.  For the same arguments and seed the
output is byte-identical to the JAX package's: the same NumPy
``RandomState`` draws in the same order.
"""

from __future__ import annotations

import numpy as np

from stargcn_tpu_torch.graph import CSRMat, HeterGraph


def synthetic_ratings(num_users=943, num_items=1682, num_edges=100_000,
                      rating_values=(1, 2, 3, 4, 5), seed=0,
                      popularity_skew=0.8):
    """COO rating triples with skewed item popularity (unique pairs)."""
    rng = np.random.RandomState(seed)
    target = min(num_edges, num_users * num_items // 2)
    # Zipf-ish item popularity, uniform users.
    item_w = 1.0 / np.arange(1, num_items + 1) ** popularity_skew
    item_w /= item_w.sum()
    if target > 2_000_000:
        # Vectorised dedup for large graphs.
        keys = np.empty(0, np.int64)
        while keys.size < target:
            n = int((target - keys.size) * 1.6) + 1024
            u = rng.randint(0, num_users, n).astype(np.int64)
            i = rng.choice(num_items, n, p=item_w).astype(np.int64)
            keys = np.unique(np.concatenate([keys, u * num_items + i]))
        keys = rng.permutation(keys)[:target]
        users = keys // num_items
        items = keys % num_items
    else:
        # First-occurrence order; kept draw-for-draw identical to the JAX
        # package so the two give the same graph.
        users = np.empty(0, np.int64)
        items = np.empty(0, np.int64)
        seen = set()
        while users.size < target:
            n = (target - users.size) * 2
            u = rng.randint(0, num_users, n)
            i = rng.choice(num_items, n, p=item_w)
            keys = u.astype(np.int64) * num_items + i
            fresh = []
            for k in keys:
                if k not in seen:
                    seen.add(k)
                    fresh.append(k)
                if len(seen) >= target:
                    break
            fresh = np.asarray(fresh, np.int64)
            users = np.concatenate([users, fresh // num_items])
            items = np.concatenate([items, fresh % num_items])
        users, items = users[:target], items[:target]
    # Ratings correlated with a latent user/item quality, clipped to levels.
    uq = rng.normal(3.5, 1.0, num_users)
    iq = rng.normal(0.0, 0.7, num_items)
    raw = uq[users] + iq[items] + rng.normal(0, 0.6, target)
    vals = np.clip(np.round(raw), min(rating_values),
                   max(rating_values)).astype(np.float32)
    return users.astype(np.int32), items.astype(np.int32), vals


def synthetic_graph(num_users=943, num_items=1682, num_edges=100_000,
                    rating_values=(1, 2, 3, 4, 5), seed=0, feat_dim=8):
    """An in-memory ``HeterGraph`` with MovieLens-like statistics; every
    user and item has at least one edge."""
    rng = np.random.RandomState(seed)
    users, items, vals = synthetic_ratings(
        num_users, num_items, num_edges, rating_values, seed)
    # Ensure full coverage: add one edge per empty user/item.
    have_u = np.zeros(num_users, bool)
    have_u[users] = True
    have_i = np.zeros(num_items, bool)
    have_i[items] = True
    extra_u = np.nonzero(~have_u)[0]
    extra_i_for_u = rng.randint(0, num_items, extra_u.size)
    extra_i = np.nonzero(~have_i)[0]
    extra_u_for_i = rng.randint(0, num_users, extra_i.size)
    users = np.concatenate([users, extra_u, extra_u_for_i]).astype(np.int32)
    items = np.concatenate([items, extra_i_for_u, extra_i]).astype(np.int32)
    vals = np.concatenate([
        vals, rng.choice(rating_values, extra_u.size + extra_i.size)
    ]).astype(np.float32)
    # De-dup (keep first occurrence).
    keys = users.astype(np.int64) * num_items + items
    _, first = np.unique(keys, return_index=True)
    first = np.sort(first)
    users, items, vals = users[first], items[first], vals[first]

    csr = CSRMat.from_coo(users, items, vals, num_users, num_items,
                          multi_link=np.asarray(rating_values, np.float32))
    return HeterGraph(
        features={
            "user": rng.normal(size=(num_users, feat_dim)).astype(np.float32),
            "movie": rng.normal(size=(num_items, feat_dim)).astype(np.float32),
        },
        csr_mat_dict={("user", "movie"): csr})
