"""The benchmark's own rating graphs, made from a seed.

A graph has the published node and rating counts of its data set and the
shapes that the program's work depends on:

* every user has at least ``min_user_ratings`` ratings (MovieLens kept only
  such users), and user activity beyond that floor is log-normal, so a few
  users rate thousands of items; the degrees are the same for every seed,
  dealt to the users in the seed's order;
* item popularity falls off as ``rank ** -item_skew``, over items in a
  random order;
* a rating is a latent score (user bias + item bias + noise) rounded to the
  configuration's own grid of levels and clipped to it, so every level
  holds edges;
* 10% of the edges are the test split and another 10% the valid split.

Everything is vectorised numpy; the ML-10M graph takes a few seconds.  The
same seed gives the same graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A rating graph: edge ``e`` joins ``user[e]`` and ``item[e]`` with
    rating ``levels[level[e]]``; ``test`` and ``valid`` index the edges of
    those splits."""

    num_users: int
    num_items: int
    levels: np.ndarray          # (R,) float32 rating values, ascending
    user: np.ndarray            # (E,) int32
    item: np.ndarray            # (E,) int32
    level: np.ndarray           # (E,) int64 index into levels
    test: np.ndarray            # (E // 10,) int64 edge indices
    valid: np.ndarray           # (E // 10,) int64 edge indices

    @property
    def num_edges(self) -> int:
        return int(self.user.size)

    @property
    def rating(self) -> np.ndarray:
        return self.levels[self.level]

    def train_mask(self) -> np.ndarray:
        """Bool over the edges: neither test nor valid."""
        m = np.ones(self.num_edges, bool)
        m[self.test] = False
        m[self.valid] = False
        return m


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, int(stream)]))


def user_degrees(rng, num_users, num_edges, floor, sigma, cap):
    """Per-user rating counts: ``floor`` plus a log-normal share of the
    rest, each at most ``cap``, summing to ``num_edges`` exactly."""
    extra = num_edges - floor * num_users
    if extra < 0 or num_users * cap < num_edges:
        raise ValueError("no degree sequence fits these counts")
    w = rng.lognormal(0.0, sigma, num_users)
    deg = np.full(num_users, floor, np.int64)
    left = extra
    free = np.ones(num_users, bool)
    while left > 0:
        share = w * free
        add = np.floor(share / share.sum() * left).astype(np.int64)
        room = cap - deg
        add = np.minimum(add, room)
        if add.sum() == 0:
            # Whole shares are all zero: one each to the heaviest free users.
            order = np.argsort(-share)[:left]
            add = np.zeros_like(deg)
            add[order] = 1
            add = np.minimum(add, room)
        deg += add
        left -= int(add.sum())
        free = deg < cap
    return deg


def distinct_items(rng, deg, item_p, num_items):
    """For each user ``u``, ``deg[u]`` distinct items drawn by popularity
    ``item_p``: draw, drop repeats, draw again for what is missing; the
    last few missing slots take uniform items."""
    cdf = np.cumsum(item_p)
    cdf /= cdf[-1]
    need_users = np.repeat(np.arange(deg.size, dtype=np.int64), deg)
    main = np.empty(0, np.int64)       # sorted keys u * num_items + i
    extra = np.empty(0, np.int64)      # sorted keys of the later rounds
    have = np.zeros(deg.size, np.int64)
    for rnd in range(64):
        if need_users.size == 0:
            break
        if rnd < 48:
            items = np.minimum(np.searchsorted(
                cdf, rng.random(need_users.size), side="right"),
                num_items - 1)
        else:
            items = rng.integers(0, num_items, need_users.size)
        new = np.unique(need_users * num_items + items)
        for old in (main, extra):
            if old.size:
                pos = np.minimum(np.searchsorted(old, new), old.size - 1)
                new = new[old[pos] != new]
        # A user's new items beyond its need are dropped, lowest ids kept.
        u = new // num_items
        start = np.searchsorted(u, u, side="left")
        rank = np.arange(u.size) - start
        new = new[rank < (deg - have)[u]]
        have += np.bincount(new // num_items, minlength=deg.size)
        if rnd == 0:
            main = new
        else:
            extra = np.sort(np.concatenate([extra, new]))
        need_users = np.repeat(np.arange(deg.size, dtype=np.int64),
                               deg - have)
    else:
        raise RuntimeError("could not draw distinct items")
    keys = np.sort(np.concatenate([main, extra]))
    return keys // num_items, keys % num_items


def generate(spec: dict, seed: int) -> Graph:
    """The graph of a configuration's ``graph`` group (``num_users``,
    ``num_items``, ``num_ratings``, ``levels``, ``min_user_ratings``,
    ``user_sigma``, ``max_user_share``, ``item_skew``, and the rating
    model ``user_bias_sd``, ``item_bias_sd``, ``noise_sd``, ``mean``)
    from ``seed``."""
    nu, ni, ne = spec["num_users"], spec["num_items"], spec["num_ratings"]
    levels = np.asarray(spec["levels"], np.float32)
    rng = rng_for(seed, 0)
    cap = int(spec["max_user_share"] * ni)
    # Every seed gets the same multiset of user degrees (drawn once from a
    # fixed stream), dealt to the users in its own order, so the seed
    # changes which users and items are heavy, not how much work there is.
    deg = rng.permutation(user_degrees(
        rng_for(0, 1), nu, ne, spec["min_user_ratings"], spec["user_sigma"],
        cap))
    item_p = np.arange(1, ni + 1, dtype=np.float64) ** -spec["item_skew"]
    item_p = item_p[rng.permutation(ni)]
    item_p /= item_p.sum()
    users, items = distinct_items(rng, deg, item_p, ni)
    # The rating: a latent score on the configuration's grid.
    ub = rng.normal(0.0, spec["user_bias_sd"], nu)
    ib = rng.normal(0.0, spec["item_bias_sd"], ni)
    raw = spec["mean"] + ub[users] + ib[items] + rng.normal(
        0.0, spec["noise_sd"], users.size)
    step = float(levels[1] - levels[0])
    level = np.clip(np.rint((raw - levels[0]) / step), 0,
                    levels.size - 1).astype(np.int64)
    # Edges in a random order, then the split.
    order = rng.permutation(users.size)
    users, items, level = users[order], items[order], level[order]
    perm = rng.permutation(users.size)
    n_test = users.size // 10
    return Graph(num_users=nu, num_items=ni, levels=levels,
                 user=users.astype(np.int32), item=items.astype(np.int32),
                 level=level, test=np.sort(perm[:n_test]),
                 valid=np.sort(perm[n_test:2 * n_test]))


def describe(g: Graph) -> dict:
    """The level histogram (share of edges per level, %) and the user and
    item degree quantiles (0, 50, 90, 99, 100%)."""
    hist = np.bincount(g.level, minlength=g.levels.size) / g.num_edges
    q = [0, 50, 90, 99, 100]
    du = np.bincount(g.user, minlength=g.num_users)
    di = np.bincount(g.item, minlength=g.num_items)
    return {
        "levels": {f"{v:g}": round(float(h) * 100, 2)
                   for v, h in zip(g.levels, hist)},
        "user_degree_q": [int(x) for x in np.percentile(du, q)],
        "item_degree_q": [int(x) for x in np.percentile(di, q)],
    }
