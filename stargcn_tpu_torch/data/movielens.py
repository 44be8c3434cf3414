"""MovieLens dataset loading, feature generation and splits.

The port's copy of ``stargcn_tpu/data/movielens.py``: ``LoadData`` parses
ml-100k / ml-1m / ml-10m archives already extracted under a data root,
builds user features (age/50, gender, occupation one-hot) and movie
features (title embedding mean, (year-1950)/100, genre one-hots), the
user-movie ``CSRMat`` with ``multi_link`` = the unique rating values, and
a transductive or inductive train/valid/test split.  One
``np.random.RandomState(seed)`` is consumed in the JAX class's order, so the
same archive and seed give the same graph, features and splits in both
packages.

* Title embeddings use GloVe-840B-300d when a vector file is given
  (``glove_path=`` or ``$STARGCN_GLOVE_PATH``), else a deterministic 300-d
  feature-hashing embedding.  No shipped config projects features
  (``USE_FEA_PROJ: false``), so ratings do not depend on either.
* The valid split's values are the valid pairs' ratings.
* The inductive per-node edge split takes one shuffled pass over the
  nodes, with each held-out node's edges gathered from one sort.
* A missing archive is fetched by ``data/download.py`` unless
  ``STARGCN_AUTO_DOWNLOAD=0``; where that fails, ``LoadData`` raises a
  ``FileNotFoundError`` naming the archive to place there.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from stargcn_tpu_torch.graph import CSRMat, HeterGraph

GENRES_ML_100K = [
    "unknown", "Action", "Adventure", "Animation", "Children", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
GENRES_ML_1M = [
    "Action", "Adventure", "Animation", "Children", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
GENRES_ML_10M = GENRES_ML_1M + ["IMAX"]

_DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "datasets")


def _hashed_title_embedding(title: str, dim: int = 300) -> np.ndarray:
    """Deterministic per-token hashed embedding, averaged over tokens: the
    stand-in for the mean GloVe-840B-300d title embedding when no vector
    file is available.  Each token seeds a ``RandomState`` from its first 8
    bytes and draws a fixed unit-variance vector."""
    tokens = re.findall(r"[A-Za-z']+", title.lower())
    if not tokens:
        return np.zeros(dim, np.float32)
    out = np.zeros(dim, np.float64)
    for tok in tokens:
        seed = np.frombuffer(
            tok.encode("utf-8").ljust(8, b"\0")[:8], dtype=np.uint64)[0]
        rng = np.random.RandomState(int(seed % (2**32)))
        out += rng.normal(0, 1.0, dim)
    return (out / len(tokens)).astype(np.float32)


def load_glove(path: str) -> dict[str, np.ndarray]:
    """Load a GloVe-format text file into a token -> vector dict.

    The real ``glove.840B.300d.txt`` contains multi-word tokens (e.g.
    ``. . .``), so the vector is parsed from the RIGHT: the dimension
    is fixed by the first well-formed line, after which each line's
    last ``dim`` fields are the vector and everything before them the
    token.  Lines that still fail to parse are skipped.
    """
    table = {}
    dim = None
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 10:
                continue
            try_dim = dim if dim is not None else len(parts) - 1
            try:
                vec = np.asarray(parts[-try_dim:], dtype=np.float32)
            except ValueError:
                continue
            # Latch dim only AFTER a successful parse: a corrupt or
            # multi-word first line must not poison the dimension and
            # silently drop every later line.
            dim = try_dim
            table[" ".join(parts[:-dim])] = vec
    return table


class LoadData:
    """Load a MovieLens dataset and build graph + splits.

    Args: ``name`` in {'ml-100k','ml-1m','ml-10m'}; ``root``, the data
    root holding the extracted archive (default ``$STARGCN_DATA_ROOT`` or
    ``<repo>/datasets``); ``use_inductive``, ``test_ratio``,
    ``val_ratio``, ``inductive_key`` ('user'|'item'),
    ``inductive_node_frac`` / ``inductive_edge_frac`` (percent),
    ``glove_path``, ``seed``.
    """

    MOVIELENS = ("ml-100k", "ml-1m", "ml-10m")

    def __init__(self, name, root=None, use_inductive=False, test_ratio=0.2,
                 val_ratio=0.1, inductive_key="item",
                 inductive_node_frac=20, inductive_edge_frac=90,
                 glove_path=None, seed=123):
        if name not in self.MOVIELENS:
            raise ValueError(f"unknown MovieLens dataset {name!r}; one of "
                             f"{self.MOVIELENS}")
        self._name = name
        self._rng = np.random.RandomState(seed=seed)
        root = root or os.environ.get("STARGCN_DATA_ROOT", _DEFAULT_ROOT)
        sub = {"ml-100k": "ml-100k", "ml-1m": "ml-1m",
               "ml-10m": "ml-10M100K"}[name]
        self._data_path = os.path.join(root, sub)
        if not os.path.isdir(self._data_path):
            # Download on first use; opt out with STARGCN_AUTO_DOWNLOAD=0.
            if os.environ.get("STARGCN_AUTO_DOWNLOAD", "1") != "0":
                from stargcn_tpu_torch.data.download import ensure_movielens
                try:
                    self._data_path = ensure_movielens(name, root)
                except Exception as e:
                    raise FileNotFoundError(
                        f"MovieLens raw data not found at {self._data_path} "
                        f"and downloading failed ({e!r}). Place the "
                        "extracted GroupLens archive there (ml-100k.zip / "
                        "ml-1m.zip / ml-10m.zip from files.grouplens.org)."
                    ) from e
            else:
                raise FileNotFoundError(
                    f"MovieLens raw data not found at {self._data_path} "
                    "and STARGCN_AUTO_DOWNLOAD=0; place the extracted "
                    "GroupLens archive there (ml-100k.zip / ml-1m.zip / "
                    "ml-10m.zip from files.grouplens.org).")
        self._glove_path = glove_path or os.environ.get("STARGCN_GLOVE_PATH")

        self.user_info = self._load_raw_user_info()
        self.movie_info = self._load_raw_movie_info()

        if name == "ml-100k":
            # The canonical u1 split.
            all_train = self._load_raw_rates(
                os.path.join(self._data_path, "u1.base"), "\t")
            test_info = self._load_raw_rates(
                os.path.join(self._data_path, "u1.test"), "\t")
            all_rating = _concat_ratings(all_train, test_info)
        else:
            all_rating = self._load_raw_rates(
                os.path.join(self._data_path, "ratings.dat"), "::")
            all_train = test_info = None

        self.user_info = _drop_unseen(self.user_info,
                                      set(all_rating["user_id"].tolist()))
        self.movie_info = _drop_unseen(self.movie_info,
                                       set(all_rating["movie_id"].tolist()))

        self.user_features = self._process_user_fea()
        self.item_features = self._process_movie_fea()

        self.global_user_id_map = {
            int(e): i for i, e in enumerate(self.user_info["id"])}
        self.global_movie_id_map = {
            int(e): i for i, e in enumerate(self.movie_info["id"])}

        u_idx = np.asarray([self.global_user_id_map[int(e)]
                            for e in all_rating["user_id"]], np.int32)
        m_idx = np.asarray([self.global_movie_id_map[int(e)]
                            for e in all_rating["movie_id"]], np.int32)
        vals = np.asarray(all_rating["rating"], np.float32)
        self.uniq_ratings = np.unique(vals)

        all_csr = CSRMat.from_coo(
            u_idx, m_idx, vals, self.num_user, self.num_item,
            multi_link=self.uniq_ratings)
        # Soft gate against the published dataset invariants
        # (data/invariants.py): fixture-scale data legitimately differs,
        # so log rather than raise here; the hard gate is the pre-flight
        # CLI.
        from stargcn_tpu_torch.data.invariants import (DataInvariantError,
                                                       validate_loaded)
        try:
            validate_loaded(name, num_ratings=all_csr.nnz,
                            num_users=self.num_user,
                            num_items=self.num_item,
                            num_levels=len(self.uniq_ratings))
        except DataInvariantError as e:
            logging.warning("dataset invariant check: %s", e)
        self._graph = HeterGraph(
            features={self.name_user: self.user_features,
                      self.name_item: self.item_features},
            csr_mat_dict={(self.name_user, self.name_item): all_csr})

        self._use_inductive = use_inductive
        if not use_inductive:
            self._build_transductive_split(
                all_rating, all_train, test_info, test_ratio, val_ratio,
                u_idx, m_idx, vals)
        else:
            self._build_inductive_split(inductive_key, inductive_node_frac,
                                        inductive_edge_frac)

    # ------------------------------ splits ----------------------------------

    def _build_transductive_split(self, all_rating, all_train, test_info,
                                  test_ratio, val_ratio, u_idx, m_idx, vals):
        n = len(all_rating["rating"])
        if self._name == "ml-100k":
            n_train = len(all_train["rating"])
            train_sel = np.arange(n_train)
            test_sel = np.arange(n_train, n)
        else:
            num_test = int(np.ceil(n * test_ratio))
            shuffled = self._rng.permutation(n)
            test_sel = shuffled[:num_test]
            train_sel = shuffled[num_test:]
        num_valid = int(np.ceil(train_sel.size * val_ratio))
        shuffled = self._rng.permutation(train_sel.size)
        valid_sel = train_sel[shuffled[:num_valid]]

        def pack(sel):
            return (np.stack([u_idx[sel], m_idx[sel]]).astype(np.int32),
                    vals[sel])

        self._test_data = pack(test_sel)
        self._valid_data = pack(valid_sel)

    def _build_inductive_split(self, inductive_key, node_frac, edge_frac):
        self._inductive_node_frac = node_frac
        self._inductive_edge_frac = edge_frac
        key = {"item": self.name_item, "user": self.name_user}[inductive_key]
        self._inductive_key = key
        all_ids = self._graph.node_ids[key]
        train_val_ids, self._inductive_test_ids, self._test_data = \
            self._gen_inductive_data(all_ids)
        self._inductive_train_ids, self._inductive_valid_ids, \
            self._valid_data = self._gen_inductive_data(train_val_ids)
        total = (np.unique(self._inductive_train_ids).size
                 + np.unique(self._inductive_valid_ids).size
                 + np.unique(self._inductive_test_ids).size)
        assert total == all_ids.size

    def _gen_inductive_data(self, node_ids):
        """Split nodes into train/held-out + hidden edge pairs.

        Shuffle the nodes (one ``permutation``); in that order, a node
        with <= 10 edges stays in train, any other node is held out and
        ``edge_frac``% (floored) of its edges, chosen by one
        ``permutation`` of its degree, become eval pairs, until
        ``node_frac``% of the nodes (rounded up) are held out.  The
        remaining nodes stay in train.
        """
        csr = self._graph[self.name_user, self.name_item]
        on_rows = self._inductive_key == self.name_user
        degrees = csr.row_degrees if on_rows else csr.col_degrees
        pair_ids = csr.node_pair_ids  # (2, nnz) [user_id; movie_id]
        key_axis = 0 if on_rows else 1
        order = np.argsort(pair_ids[key_axis], kind="stable")
        sorted_pairs = pair_ids[:, order]
        starts = np.searchsorted(sorted_pairs[key_axis],
                                 np.arange(degrees.size))
        ends = np.searchsorted(sorted_pairs[key_axis],
                               np.arange(degrees.size) + 1)

        shuffled = self._rng.permutation(node_ids)
        test_num = int(np.ceil(node_ids.size / 100.0
                               * self._inductive_node_frac))
        test_ids, train_ids, eval_pairs = [], [], []
        count, idx = 0, -1
        for idx, node in enumerate(shuffled):
            node = int(node)
            deg = int(degrees[node])
            if deg == 0:
                raise ValueError(f"node {node} has no rating")
            if deg <= 10:
                train_ids.append(node)
            else:
                test_ids.append(node)
                count += 1
                node_pairs = sorted_pairs[:, starts[node]:ends[node]]
                perm = self._rng.permutation(deg)
                chosen = int(np.floor(deg / 100.0 * self._inductive_edge_frac))
                eval_pairs.append(node_pairs[:, perm[:chosen]])
            if count == test_num:
                break
        if idx + 1 >= node_ids.size:
            raise ValueError("not enough nodes with more than 10 ratings "
                             "to hold out")
        test_ids = np.asarray(test_ids, np.int32)
        train_ids = np.concatenate([np.asarray(train_ids, np.int32),
                                    shuffled[idx + 1:]]).astype(np.int32)
        assert node_ids.size == train_ids.size + test_ids.size
        pairs = np.hstack(eval_pairs).astype(np.int32)
        values = self._graph.fetch_edges_by_id(
            self.name_user, self.name_item, pairs)
        return train_ids, test_ids, (pairs, values)

    # ---------------------------- raw parsing --------------------------------

    def _load_raw_rates(self, path, sep):
        """user \\t movie \\t rating \\t timestamp (or '::'-separated)."""
        users, movies, ratings = [], [], []
        with open(path, "r", encoding="latin-1") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(sep)
                users.append(int(parts[0]))
                movies.append(int(parts[1]))
                ratings.append(float(parts[2]))
        return {"user_id": np.asarray(users, np.int32),
                "movie_id": np.asarray(movies, np.int32),
                "rating": np.asarray(ratings, np.float32)}

    def _load_raw_user_info(self):
        """ml-100k: 'id|age|gender|occupation|zip'; ml-1m:
        'id::gender::age::occupation::zip'; ml-10m: ids from ratings."""
        if self._name == "ml-100k":
            ids, ages, genders, occs = [], [], [], []
            with open(os.path.join(self._data_path, "u.user"),
                      encoding="latin-1") as f:
                for line in f:
                    p = line.strip().split("|")
                    if len(p) < 5:
                        continue
                    ids.append(int(p[0])); ages.append(float(p[1]))
                    genders.append(p[2]); occs.append(p[3])
            return {"id": np.asarray(ids, np.int32),
                    "age": np.asarray(ages, np.float32),
                    "gender": genders, "occupation": occs}
        if self._name == "ml-1m":
            ids, ages, genders, occs = [], [], [], []
            with open(os.path.join(self._data_path, "users.dat"),
                      encoding="latin-1") as f:
                for line in f:
                    p = line.strip().split("::")
                    if len(p) < 5:
                        continue
                    ids.append(int(p[0])); genders.append(p[1])
                    ages.append(float(p[2])); occs.append(p[3])
            return {"id": np.asarray(ids, np.int32),
                    "age": np.asarray(ages, np.float32),
                    "gender": genders, "occupation": occs}
        # ml-10m: no user file
        ratings = self._load_raw_rates(
            os.path.join(self._data_path, "ratings.dat"), "::")
        return {"id": np.unique(ratings["user_id"]).astype(np.int32)}

    def _load_raw_movie_info(self):
        if self._name == "ml-100k":
            genres = GENRES_ML_100K
            ids, titles, genre_rows = [], [], []
            with open(os.path.join(self._data_path, "u.item"),
                      encoding="latin-1") as f:
                for line in f:
                    p = line.rstrip("\n").split("|")
                    if len(p) < 5 + len(genres):
                        continue
                    ids.append(int(p[0])); titles.append(p[1])
                    genre_rows.append([float(x) for x in p[5:5 + len(genres)]])
            return {"id": np.asarray(ids, np.int32), "title": titles,
                    "genres": np.asarray(genre_rows, np.float32),
                    "genre_names": genres}
        genres = GENRES_ML_1M if self._name == "ml-1m" else GENRES_ML_10M
        genre_map = {g: i for i, g in enumerate(genres)}
        genre_map["Children's"] = genre_map["Children"]
        genre_map["Childrens"] = genre_map["Children"]
        ids, titles, genre_rows = [], [], []
        with open(os.path.join(self._data_path, "movies.dat"),
                  encoding="latin-1") as f:
            for line in f:
                p = line.strip().split("::")
                if len(p) < 3:
                    continue
                ids.append(int(p[0])); titles.append(p[1])
                row = np.zeros(len(genres), np.float32)
                for g in p[2].split("|"):
                    if g in genre_map:
                        row[genre_map[g]] = 1.0
                    elif "unknown" in genre_map:
                        row[genre_map["unknown"]] = 1.0
                genre_rows.append(row)
        return {"id": np.asarray(ids, np.int32), "title": titles,
                "genres": np.asarray(genre_rows, np.float32),
                "genre_names": genres}

    # ------------------------------ features ---------------------------------

    def _process_user_fea(self):
        """[age/50, gender==F, occupation one-hot]; ml-10m: a single
        zero."""
        if self._name == "ml-10m":
            return np.zeros((len(self.user_info["id"]), 1), np.float32)
        n = len(self.user_info["id"])
        occ_names = sorted(set(self.user_info["occupation"]))
        occ_map = {o: i for i, o in enumerate(occ_names)}
        occ = np.zeros((n, len(occ_names)), np.float32)
        occ[np.arange(n),
            [occ_map[o] for o in self.user_info["occupation"]]] = 1.0
        age = np.asarray(self.user_info["age"], np.float32)[:, None] / 50.0
        gender = np.asarray(
            [1.0 if g == "F" else 0.0 for g in self.user_info["gender"]],
            np.float32)[:, None]
        return np.concatenate([age, gender, occ], axis=1)

    def _process_movie_fea(self):
        """[title embedding, (year-1950)/100, genres]."""
        titles = self.movie_info["title"]
        n = len(titles)
        # An empty parse result means the file was unusable: fall back
        # to the hashed embedding path rather than emitting all-zero
        # title vectors.
        glove = (load_glove(self._glove_path) or None
                 if self._glove_path else None)
        if self._glove_path and glove is None:
            logging.warning("glove file %s parsed to an empty table; "
                            "using hashed title embeddings",
                            self._glove_path)
        dim = (len(next(iter(glove.values()))) if glove else 300)
        emb = np.zeros((n, dim), np.float32)
        years = np.zeros((n, 1), np.float32)
        pat = re.compile(r"(.+)\s*\((\d+)\)")
        for i, title in enumerate(titles):
            m = pat.match(title)
            text, year = (m.groups() if m else (title, 1950))
            years[i] = float(year)
            if glove is not None:
                toks = [t for t in re.findall(r"[A-Za-z']+", text.lower())
                        if t in glove]
                emb[i] = (np.mean([glove[t] for t in toks], axis=0)
                          if toks else 0.0)
            else:
                emb[i] = _hashed_title_embedding(text)
        return np.concatenate(
            [emb, (years - 1950.0) / 100.0, self.movie_info["genres"]],
            axis=1).astype(np.float32)

    # ------------------------------ accessors --------------------------------

    @property
    def graph(self):
        return self._graph

    @property
    def name_user(self):
        return "user"

    @property
    def name_item(self):
        return "movie"

    @property
    def num_user(self):
        return len(self.user_info["id"])

    @property
    def num_item(self):
        return len(self.movie_info["id"])

    @property
    def valid_data(self):
        return self._valid_data

    @property
    def test_data(self):
        return self._test_data

    @property
    def inductive_train_ids(self):
        return self._inductive_train_ids

    @property
    def inductive_valid_ids(self):
        return self._inductive_valid_ids

    @property
    def inductive_test_ids(self):
        return self._inductive_test_ids

    def __repr__(self):
        lines = [f"LoadData(name={self._name})", repr(self._graph),
                 f"#Val/Test edges: {self._valid_data[1].size}"
                 f"/{self._test_data[1].size}"]
        if self._use_inductive:
            lines.append(
                f"Inductive {self._inductive_key}: node "
                f"{self._inductive_node_frac}% edge "
                f"{self._inductive_edge_frac}% — train/valid/test nodes "
                f"{self.inductive_train_ids.size}/"
                f"{self.inductive_valid_ids.size}/"
                f"{self.inductive_test_ids.size}")
        return "\n".join(lines)


def _concat_ratings(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _drop_unseen(info, keep_ids):
    mask = np.asarray([int(i) in keep_ids for i in info["id"]])
    out = {}
    for k, v in info.items():
        if k == "genre_names":
            out[k] = v
        elif isinstance(v, list):
            out[k] = [x for x, m in zip(v, mask) if m]
        else:
            out[k] = np.asarray(v)[mask]
    return out
