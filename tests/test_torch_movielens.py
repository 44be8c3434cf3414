"""The port's MovieLens data layer against the JAX package's: the fixture
writers (byte-identical files), ``LoadData`` on ml-100k / ml-1m / ml-10m
archives, transductive and inductive (items 20% / 90%, users 20% / 50%),
``load_glove`` and the hashed title embeddings, the published invariants,
and ``fetch`` / ``ensure_movielens`` with ``urllib.request.urlopen``
monkeypatched to serve a fixture archive (nothing touches the network).
Every array must be equal, dtype included."""

import filecmp
import hashlib
import io
import os
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

from stargcn_tpu.data import movielens as jml
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.data.invariants import PUBLISHED as J_PUBLISHED
from stargcn_tpu_torch.data import download, invariants
from stargcn_tpu_torch.data import movielens as tml
from stargcn_tpu_torch.data import synthetic as tsyn

WRITERS = {"ml-100k": ("write_ml100k_format", "ml-100k"),
           "ml-1m": ("write_ml1m_format", "ml-1m"),
           "ml-10m": ("write_ml10m_format", "ml-10M100K")}
SPLITS = {
    "transductive": {},
    "item-20-90": dict(use_inductive=True, inductive_key="item",
                       inductive_node_frac=20, inductive_edge_frac=90),
    "user-20-50": dict(use_inductive=True, inductive_key="user",
                       inductive_node_frac=20, inductive_edge_frac=50),
}
# Large enough that 20% of each node type has more than 10 ratings.
SIZES = {"ml-100k": dict(num_users=50, num_items=30, num_edges=1200),
         "ml-1m": dict(num_users=40, num_items=25, num_edges=900),
         "ml-10m": dict(num_users=30, num_items=20, num_edges=500)}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """One data root per package, each holding all three archives written
    by that package's writer with the same arguments."""
    roots = {}
    for pkg, syn in (("jax", jsyn), ("torch", tsyn)):
        root = tmp_path_factory.mktemp(pkg)
        for name, (writer, sub) in WRITERS.items():
            getattr(syn, writer)(str(root / sub), seed=4, **SIZES[name])
        roots[pkg] = str(root)
    return roots


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writers_write_identical_files(archives, name):
    sub = WRITERS[name][1]
    files = sorted(os.listdir(os.path.join(archives["jax"], sub)))
    assert files == sorted(os.listdir(os.path.join(archives["torch"], sub)))
    assert len(files) >= 2
    for f in files:
        assert filecmp.cmp(os.path.join(archives["jax"], sub, f),
                           os.path.join(archives["torch"], sub, f),
                           shallow=False), f


def test_writer_defaults_and_other_seeds_identical(tmp_path):
    for name, (writer, _) in WRITERS.items():
        for seed in (0, 11):
            a, b = tmp_path / f"j{name}{seed}", tmp_path / f"t{name}{seed}"
            getattr(jsyn, writer)(str(a), seed=seed)
            getattr(tsyn, writer)(str(b), seed=seed)
            for f in os.listdir(a):
                assert (a / f).read_bytes() == (b / f).read_bytes(), (name, f)


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(WRITERS))
def test_load_data_matches_jax(archives, name, split):
    """The graph arrays, both feature tables, the split pairs and values,
    and the inductive node ids."""
    kw = SPLITS[split]
    want = jml.LoadData(name, root=archives["jax"], seed=5, **kw)
    got = tml.LoadData(name, root=archives["torch"], seed=5, **kw)
    jc, tc = want.graph["user", "movie"], got.graph["user", "movie"]
    for field in ("ind_ptr", "end_points", "values", "row_ids", "col_ids",
                  "multi_link"):
        _same(getattr(tc, field), getattr(jc, field), field)
    for key in ("user", "movie"):
        _same(got.graph.features[key], want.graph.features[key], key)
        _same(got.graph.node_ids[key], want.graph.node_ids[key], key)
    for segment in ("valid_data", "test_data"):
        for part, g, w in zip(("pairs", "values"), getattr(got, segment),
                              getattr(want, segment)):
            _same(g, w, f"{segment} {part}")
    assert got.test_data[1].size > 0 and got.valid_data[1].size > 0
    if kw:
        for ids in ("inductive_train_ids", "inductive_valid_ids",
                    "inductive_test_ids"):
            _same(getattr(got, ids), getattr(want, ids), ids)
        # every test pair belongs to a held-out test node
        axis = 0 if kw["inductive_key"] == "user" else 1
        assert np.isin(got.test_data[0][axis],
                       got.inductive_test_ids).all()
    assert repr(got).splitlines()[-1] == repr(want).splitlines()[-1]
    got.graph.check_consistency()
    got.graph.check_continous_node_ids()


def test_load_data_seed_changes_the_split(archives):
    a = tml.LoadData("ml-1m", root=archives["torch"], seed=5,
                     **SPLITS["item-20-90"])
    b = tml.LoadData("ml-1m", root=archives["torch"], seed=6,
                     **SPLITS["item-20-90"])
    assert not np.array_equal(a.inductive_test_ids, b.inductive_test_ids)


@pytest.mark.parametrize("title", [
    "Toy Story (1995)", "Schindler's List", "", "123 456",
    "A", "Supercalifragilistic Expialidocious", "Ã©tÃ© naÃ¯ve"])
def test_hashed_title_embedding_matches_jax(title):
    _same(tml._hashed_title_embedding(title),
          jml._hashed_title_embedding(title), title)


@pytest.fixture
def glove_file(tmp_path):
    """A GloVe-format file: a multi-word token, a malformed line, a line
    too short to be a vector."""
    rng = np.random.RandomState(0)
    lines = []
    for tok in ("movie", "toy", "story", ". . .", "list", "schindler's"):
        lines.append(tok + " " + " ".join(f"{v:.5f}"
                                          for v in rng.randn(12)))
    lines.insert(2, "broken " + " ".join(["x"] * 12))
    lines.append("short 1 2 3")
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def test_load_glove_matches_jax(glove_file):
    got, want = tml.load_glove(glove_file), jml.load_glove(glove_file)
    assert sorted(got) == sorted(want)
    assert ". . ." in got and "broken" not in got
    for tok in want:
        _same(got[tok], want[tok], tok)


def test_title_features_from_glove_match_jax(archives, glove_file):
    want = jml.LoadData("ml-100k", root=archives["jax"], seed=5,
                        glove_path=glove_file)
    got = tml.LoadData("ml-100k", root=archives["torch"], seed=5,
                       glove_path=glove_file)
    _same(got.item_features, want.item_features, "movie features")
    assert got.item_features.shape[1] == 12 + 1 + len(tml.GENRES_ML_100K)
    assert (tml.GENRES_ML_100K, tml.GENRES_ML_1M, tml.GENRES_ML_10M) == (
        jml.GENRES_ML_100K, jml.GENRES_ML_1M, jml.GENRES_ML_10M)


def test_invariants_match_and_gate():
    assert invariants.PUBLISHED == J_PUBLISHED
    for name, exp in invariants.PUBLISHED.items():
        invariants.validate_loaded(
            name, num_ratings=exp["ratings"], num_users=exp["users"],
            num_items=exp["items"], num_levels=exp["levels"])
        for field in ("num_ratings", "num_users", "num_items",
                      "num_levels"):
            kw = dict(num_ratings=exp["ratings"], num_users=exp["users"],
                      num_items=exp["items"], num_levels=exp["levels"])
            kw[field] += 1
            with pytest.raises(invariants.DataInvariantError,
                               match="published"):
                invariants.validate_loaded(name, **kw)
    vec = np.zeros(invariants.GLOVE_DIM, np.float32)
    with pytest.raises(invariants.DataInvariantError, match="tokens"):
        invariants.validate_glove({"a": vec})
    big = dict.fromkeys(range(invariants.GLOVE_MIN_TOKENS), vec[:10])
    with pytest.raises(invariants.DataInvariantError, match="10-dim"):
        invariants.validate_glove(big)
    invariants.validate_glove(dict.fromkeys(
        range(invariants.GLOVE_MIN_TOKENS), vec))


def test_fixture_counts_only_warn(archives, caplog):
    """A fixture's counts differ from the published ones: ``LoadData``
    logs a warning and goes on."""
    with caplog.at_level("WARNING"):
        tml.LoadData("ml-1m", root=archives["torch"], seed=5)
    assert "published" in caplog.text


def test_invariants_cli(archives):
    with pytest.raises(invariants.DataInvariantError):
        invariants._main(["ml-1m", archives["torch"]])


# --------------------------------- download ---------------------------------


@pytest.fixture(scope="module")
def ml100k_zip_bytes(tmp_path_factory):
    """An ml-100k.zip: the port's fixture files under 'ml-100k/'."""
    src = tmp_path_factory.mktemp("zipsrc") / "ml-100k"
    tsyn.write_ml100k_format(str(src), num_users=30, num_items=20,
                             num_edges=600, seed=3)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for fname in sorted(os.listdir(src)):
            zf.write(src / fname, arcname=f"ml-100k/{fname}")
    return buf.getvalue()


def _serve(monkeypatch, payload, fail_first=0):
    """``urlopen`` stub: fail the first ``fail_first`` calls, then serve
    ``payload``.  Returns the list of URLs asked for."""
    calls = []

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(url, timeout=None):
        calls.append(url)
        if len(calls) <= fail_first:
            raise urllib.error.URLError("no network in this test")
        return _Resp(payload)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    return calls


def test_fetch_retries_hashes_and_keeps_no_part_file(tmp_path, monkeypatch):
    payload = b"hello" * 100
    calls = _serve(monkeypatch, payload, fail_first=2)
    dest = tmp_path / "f.bin"
    out = download.fetch("http://x/f.bin", str(dest), retries=5,
                         backoff_s=0.0,
                         sha1=hashlib.sha1(payload).hexdigest())
    assert out == str(dest) and dest.read_bytes() == payload
    assert len(calls) == 3 and download.sha1_of(out) == hashlib.sha1(
        payload).hexdigest()
    assert [p for p in os.listdir(tmp_path) if ".part" in p] == []
    # a kept file is not fetched again
    download.fetch("http://x/f.bin", str(dest), sha1=download.sha1_of(out))
    assert len(calls) == 3
    with pytest.raises(OSError, match="sha1 mismatch"):
        download.fetch("http://x/g.bin", str(tmp_path / "g.bin"),
                       sha1="0" * 40, retries=2, backoff_s=0.0)
    assert not (tmp_path / "g.bin").exists()
    _serve(monkeypatch, b"", fail_first=100)
    with pytest.raises(urllib.error.URLError):
        download.fetch("http://x/h.bin", str(tmp_path / "h.bin"),
                       retries=2, backoff_s=0.0)


def test_ensure_movielens_then_load(tmp_path, monkeypatch, ml100k_zip_bytes):
    assert download.MOVIELENS_ARCHIVES == __import__(
        "stargcn_tpu.data.download",
        fromlist=["MOVIELENS_ARCHIVES"]).MOVIELENS_ARCHIVES
    calls = _serve(monkeypatch, ml100k_zip_bytes)
    root = str(tmp_path / "data")
    data_dir = download.ensure_movielens("ml-100k", root, backoff_s=0.0)
    assert os.path.isfile(os.path.join(data_dir, "u1.base"))
    assert calls == [download.MOVIELENS_ARCHIVES["ml-100k"][1]]
    assert download.ensure_movielens("ml-100k", root) == data_dir
    assert len(calls) == 1
    data = tml.LoadData("ml-100k", root=root, seed=5)
    assert np.isin(data.test_data[1], [1, 2, 3, 4, 5]).all()
    # LoadData fetches a missing archive itself
    data = tml.LoadData("ml-100k", root=str(tmp_path / "auto"), seed=5)
    assert data.test_data[1].size > 0 and len(calls) == 2


def test_load_data_without_archive(tmp_path, monkeypatch):
    calls = _serve(monkeypatch, b"")
    monkeypatch.setenv("STARGCN_AUTO_DOWNLOAD", "0")
    with pytest.raises(FileNotFoundError, match="STARGCN_AUTO_DOWNLOAD"):
        tml.LoadData("ml-1m", root=str(tmp_path / "none"), seed=5)
    assert not calls
    monkeypatch.delenv("STARGCN_AUTO_DOWNLOAD")
    monkeypatch.setattr(download, "fetch", lambda *a, **k: (
        _ for _ in ()).throw(urllib.error.URLError("no network")))
    with pytest.raises(FileNotFoundError, match="files.grouplens.org"):
        tml.LoadData("ml-1m", root=str(tmp_path / "none"), seed=5)


def test_bad_archive_and_glove_and_cli(tmp_path, monkeypatch, capsys,
                                       ml100k_zip_bytes):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("wrong-dir/u.user", "1|20|M|artist|00000\n")
    _serve(monkeypatch, buf.getvalue())
    with pytest.raises(FileNotFoundError, match="expected"):
        download.ensure_movielens("ml-100k", str(tmp_path / "bad"),
                                  backoff_s=0.0)
    assert not os.path.exists(tmp_path / "bad" / "ml-100k")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("glove.840B.300d.txt",
                    "movie " + " ".join(["0.1"] * 300) + "\n")
    _serve(monkeypatch, buf.getvalue())
    path = download.ensure_glove(str(tmp_path), backoff_s=0.0)
    assert tml.load_glove(path)["movie"].shape == (300,)
    assert download.ensure_glove(str(tmp_path)) == path
    _serve(monkeypatch, ml100k_zip_bytes)
    download._main(["ml-100k", str(tmp_path / "cli")])
    out = capsys.readouterr().out.strip()
    assert out.endswith("ml-100k")
    assert os.path.isfile(os.path.join(out, "u1.base"))
