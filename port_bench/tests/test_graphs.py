import json
import os

import numpy as np
import pytest

from port_bench import graphs

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spec(name, **kw):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return dict(json.load(f)["graph"], **kw)


@pytest.mark.parametrize("name", ["ml10m", "ml1m"])
def test_every_level_and_user_floor(name):
    # The configuration's own level grid at a tenth of its users.
    s = spec(name)
    s = dict(s, num_users=s["num_users"] // 10,
             num_ratings=s["num_ratings"] // 10)
    g = graphs.generate(s, 2**31 + 99)
    assert g.num_edges == s["num_ratings"]
    hist = np.bincount(g.level, minlength=len(s["levels"]))
    assert (hist > 0).all(), hist
    assert len(s["levels"]) == (10 if name == "ml10m" else 5)
    deg = np.bincount(g.user, minlength=g.num_users)
    assert deg.min() >= s["min_user_ratings"]
    assert deg.max() > 5 * np.median(deg)           # a heavy tail
    keys = g.user.astype(np.int64) * g.num_items + g.item
    assert np.unique(keys).size == g.num_edges       # no pair twice


def test_seed_gives_the_graph():
    s = spec("ml1m", num_users=400, num_items=300, num_ratings=20000)
    a, b = graphs.generate(s, 5), graphs.generate(s, 5)
    c = graphs.generate(s, 6)
    for f in ("user", "item", "level", "test", "valid"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.item, c.item)


def test_split():
    g = graphs.generate(spec("ml1m", num_users=400, num_items=300,
                             num_ratings=20000), 7)
    assert g.test.size == g.valid.size == g.num_edges // 10
    assert np.intersect1d(g.test, g.valid).size == 0
    assert g.train_mask().sum() == g.num_edges - 2 * g.test.size


def test_describe():
    g = graphs.generate(spec("ml1m", num_users=400, num_items=300,
                             num_ratings=20000), 7)
    d = graphs.describe(g)
    assert abs(sum(d["levels"].values()) - 100) < 0.1
    assert d["user_degree_q"][0] >= 20
