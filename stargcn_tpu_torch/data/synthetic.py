"""Synthetic MovieLens-like data for tests and the chip smoke run.

The port's copy of ``stargcn_tpu/data/synthetic.py``: in-memory rating
graphs (``synthetic_graph``, and ``synthetic_structured_graph`` with
planted affinity), and writers of small on-disk datasets in the exact
GroupLens file formats (``write_ml100k_format``, ``write_ml1m_format``,
``write_ml10m_format``), so ``data.movielens.LoadData`` runs without any
archive.  For the same arguments and seed the output is byte-identical to
the JAX package's: the same NumPy ``RandomState`` draws in the same order.
"""

from __future__ import annotations

import os

import numpy as np

from stargcn_tpu_torch.data.movielens import (GENRES_ML_1M, GENRES_ML_10M,
                                              GENRES_ML_100K)
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


def write_ml1m_format(dirname, num_users=40, num_items=25, num_edges=900,
                      seed=0):
    """Write a synthetic dataset in exact ml-1m file format (users.dat,
    movies.dat, ratings.dat with '::' separators)."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirname, exist_ok=True)
    occupations = list(range(0, 5))
    with open(os.path.join(dirname, "users.dat"), "w") as f:
        for uid in range(1, num_users + 1):
            f.write(f"{uid}::{'MF'[rng.randint(2)]}::{rng.randint(18, 60)}"
                    f"::{occupations[rng.randint(5)]}::00000\n")
    with open(os.path.join(dirname, "movies.dat"), "w") as f:
        for mid in range(1, num_items + 1):
            genres = "|".join(
                rng.choice(GENRES_ML_1M, rng.randint(1, 3), replace=False))
            year = rng.randint(1950, 2000)
            f.write(f"{mid}::Movie {mid} ({year})::{genres}\n")
    users, items, vals = synthetic_ratings(num_users, num_items, num_edges,
                                           seed=seed)
    users = np.concatenate([users, np.arange(num_users),
                            rng.randint(0, num_users, num_items)])
    items = np.concatenate([items, rng.randint(0, num_items, num_users),
                            np.arange(num_items)])
    vals = np.concatenate([vals, rng.choice([1, 2, 3, 4, 5],
                                            num_users + num_items)])
    keys = users.astype(np.int64) * num_items + items
    _, first = np.unique(keys, return_index=True)
    first = np.sort(first)
    with open(os.path.join(dirname, "ratings.dat"), "w") as f:
        for j in first:
            f.write(f"{users[j] + 1}::{items[j] + 1}::{int(vals[j])}"
                    "::978300760\n")


def write_ml10m_format(dirname, num_users=30, num_items=20, num_edges=500,
                       seed=0):
    """Write a synthetic dataset in exact ml-10m file format (no users.dat;
    half-star ratings; IMAX genre present)."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "movies.dat"), "w") as f:
        for mid in range(1, num_items + 1):
            genres = "|".join(
                rng.choice(GENRES_ML_10M, rng.randint(1, 3), replace=False))
            f.write(f"{mid}::Movie {mid} ({rng.randint(1950, 2005)})"
                    f"::{genres}\n")
    users, items, _ = synthetic_ratings(num_users, num_items, num_edges,
                                        seed=seed)
    users = np.concatenate([users, np.arange(num_users),
                            rng.randint(0, num_users, num_items)])
    items = np.concatenate([items, rng.randint(0, num_items, num_users),
                            np.arange(num_items)])
    keys = users.astype(np.int64) * num_items + items
    _, first = np.unique(keys, return_index=True)
    first = np.sort(first)
    half_stars = np.asarray([0.5, 1, 1.5, 2, 2.5, 3, 3.5, 4, 4.5, 5])
    with open(os.path.join(dirname, "ratings.dat"), "w") as f:
        for j in first:
            v = half_stars[rng.randint(10)]
            f.write(f"{users[j] + 1}::{items[j] + 1}::{v}::978300760\n")


def write_ml100k_format(dirname, num_users=50, num_items=30, num_edges=1200,
                        seed=0):
    """Write a synthetic dataset in exact ml-100k file format (u.user, u.item,
    u1.base, u1.test) so the real parser path is testable offline."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirname, exist_ok=True)
    occupations = ["engineer", "artist", "doctor", "student"]
    with open(os.path.join(dirname, "u.user"), "w") as f:
        for uid in range(1, num_users + 1):
            f.write(f"{uid}|{rng.randint(18, 70)}|"
                    f"{'MF'[rng.randint(2)]}|"
                    f"{occupations[rng.randint(len(occupations))]}|00000\n")
    with open(os.path.join(dirname, "u.item"), "w") as f:
        for mid in range(1, num_items + 1):
            genres = np.zeros(len(GENRES_ML_100K), np.int32)
            genres[rng.randint(len(genres))] = 1
            year = rng.randint(1950, 2000)
            f.write(f"{mid}|Movie {mid} ({year})|01-Jan-{year}||"
                    "http://example.com|"
                    + "|".join(map(str, genres)) + "\n")
    users, items, vals = synthetic_ratings(
        num_users, num_items, num_edges, seed=seed)
    # ensure coverage of all ids (drop-unseen would otherwise shrink maps)
    users = np.concatenate([users, np.arange(num_users)])
    items = np.concatenate([items, rng.randint(0, num_items, num_users)])
    vals = np.concatenate([vals, rng.choice([1, 2, 3, 4, 5], num_users)])
    users2 = np.concatenate([users, rng.randint(0, num_users, num_items)])
    items2 = np.concatenate([items, np.arange(num_items)])
    vals2 = np.concatenate([vals, rng.choice([1, 2, 3, 4, 5], num_items)])
    keys = users2.astype(np.int64) * num_items + items2
    _, first = np.unique(keys, return_index=True)
    first = np.sort(first)
    users2, items2, vals2 = users2[first], items2[first], vals2[first]
    n = users2.size
    n_test = max(1, n // 5)
    perm = rng.permutation(n)
    ts = 880000000
    for fname, sel in [("u1.base", perm[n_test:]), ("u1.test", perm[:n_test])]:
        with open(os.path.join(dirname, fname), "w") as f:
            for j in sel:
                f.write(f"{users2[j] + 1}\t{items2[j] + 1}\t"
                        f"{int(vals2[j])}\t{ts}\n")


def synthetic_structured_graph(num_users=943, num_items=1682,
                               num_edges=100_000, groups=8,
                               in_group_p=0.85, seed=0, feat_dim=8):
    """A rating graph with PLANTED affinity structure.

    Users and items carry latent groups; ``in_group_p`` of the edges
    connect matching groups, and in-group edges rate {4, 5} while
    out-group ones rate {1, 2}.  A model trained on the ratings can
    therefore learn the affinity that generated the EDGES — which is
    what sampled-candidate ranking measures — unlike :func:`synthetic_graph`, whose edge placement is
    independent of its ratings (there, held-out positives are
    statistically identical to non-edges and NO trained model can beat
    chance)."""
    rng = np.random.RandomState(seed)
    gu = rng.randint(0, groups, num_users)
    gi = rng.randint(0, groups, num_items)
    users = np.empty(0, np.int64)
    items = np.empty(0, np.int64)
    target = min(num_edges, num_users * num_items // 3)
    items_by_group = [np.nonzero(gi == g)[0] for g in range(groups)]
    while users.size < target:
        n = (target - users.size) * 2 + 64
        u = rng.randint(0, num_users, n)
        in_g = rng.uniform(size=n) < in_group_p
        i = rng.randint(0, num_items, n)
        # redirect in-group draws to an item of the user's group
        for g in range(groups):
            sel = in_g & (gu[u] == g)
            pool = items_by_group[g]
            if pool.size:
                i[sel] = pool[rng.randint(0, pool.size, int(sel.sum()))]
        keys = np.unique(u.astype(np.int64) * num_items + i)
        both = np.unique(np.concatenate(
            [users * num_items + items, keys]))
        both = rng.permutation(both)[:target]
        users, items = both // num_items, both % num_items
    in_group = gu[users] == gi[items]
    vals = np.where(in_group, rng.choice([4.0, 5.0], users.size),
                    rng.choice([1.0, 2.0], users.size)).astype(np.float32)
    # coverage: every node needs >= 1 edge
    have_u = np.zeros(num_users, bool)
    have_u[users] = True
    have_i = np.zeros(num_items, bool)
    have_i[items] = True
    extra_u = np.nonzero(~have_u)[0]
    extra_i = np.nonzero(~have_i)[0]
    users = np.concatenate(
        [users, extra_u, rng.randint(0, num_users, extra_i.size)])
    items = np.concatenate(
        [items, rng.randint(0, num_items, extra_u.size), extra_i])
    vals = np.concatenate(
        [vals, rng.choice([1.0, 2.0, 3.0, 4.0, 5.0],
                          extra_u.size + extra_i.size)]).astype(np.float32)
    keys = users.astype(np.int64) * num_items + items
    _, first = np.unique(keys, return_index=True)
    first = np.sort(first)
    users, items, vals = users[first], items[first], vals[first]
    csr = CSRMat.from_coo(users.astype(np.int32), items.astype(np.int32),
                          vals, num_users, num_items,
                          multi_link=np.array([1, 2, 3, 4, 5], np.float32))
    return HeterGraph(
        features={
            "user": rng.normal(size=(num_users, feat_dim)).astype(np.float32),
            "movie": rng.normal(
                size=(num_items, feat_dim)).astype(np.float32),
        },
        csr_mat_dict={("user", "movie"): csr})
