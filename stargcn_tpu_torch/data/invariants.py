"""Published MovieLens dataset invariants: hard gates for real data.

The port's copy of ``stargcn_tpu/data/invariants.py``.  The counts are the
ones GroupLens publishes for each dataset, after restricting to rated users
and movies:

==========  ==========  ======  =======  =============
dataset     ratings     users   items    rating levels
==========  ==========  ======  =======  =============
ml-100k        100,000     943    1,682  5  (1..5)
ml-1m        1,000,209   6,040    3,706  5  (1..5)
ml-10m      10,000,054  69,878   10,677  10 (0.5..5.0)
==========  ==========  ======  =======  =============

(ml-1m ships 3,883 movie entries and ml-10m 10,681, but only rated movies
enter the graph: 3,706 / 10,677.)  GroupLens publishes no archive
checksums, so the gates are on parsed counts, where a truncated or
mis-delimited file cannot hide.

Usage: ``validate_loaded(name, ...)`` raises on mismatch;
``python -m stargcn_tpu_torch.data.invariants <name> [root]`` is the
pre-flight CLI.
"""

from __future__ import annotations

PUBLISHED = {
    "ml-100k": {"ratings": 100_000, "users": 943, "items": 1_682,
                "levels": 5, "train_u1": 80_000, "test_u1": 20_000},
    "ml-1m": {"ratings": 1_000_209, "users": 6_040, "items": 3_706,
              "levels": 5},
    "ml-10m": {"ratings": 10_000_054, "users": 69_878, "items": 10_677,
               "levels": 10},
}

# glove.840B.300d.txt: 300-dim vectors; 2,196,017 lines in the published
# file.  The gate is a safe lower bound, not exact, since the parser
# skips malformed lines.
GLOVE_DIM = 300
GLOVE_MIN_TOKENS = 2_000_000


class DataInvariantError(ValueError):
    """A parsed real dataset violates its published invariants."""


def validate_loaded(name: str, *, num_ratings: int, num_users: int,
                    num_items: int, num_levels: int) -> None:
    """Raise :class:`DataInvariantError` if the parsed counts differ
    from the published ones for ``name``."""
    exp = PUBLISHED[name]
    got = {"ratings": num_ratings, "users": num_users,
           "items": num_items, "levels": num_levels}
    bad = {k: (got[k], exp[k]) for k in got if got[k] != exp[k]}
    if bad:
        detail = ", ".join(f"{k}: parsed {g} != published {e}"
                           for k, (g, e) in bad.items())
        raise DataInvariantError(
            f"{name} parse violates published invariants ({detail}); "
            "the archive is likely truncated or mis-extracted — delete "
            "the dataset directory and re-download")


def validate_glove(table: dict) -> None:
    """Raise if a parsed GloVe table can't be the real 840B.300d."""
    if len(table) < GLOVE_MIN_TOKENS:
        raise DataInvariantError(
            f"glove table has {len(table)} tokens, expected >= "
            f"{GLOVE_MIN_TOKENS} (real glove.840B.300d.txt)")
    dim = len(next(iter(table.values())))
    if dim != GLOVE_DIM:
        raise DataInvariantError(
            f"glove vectors are {dim}-dim, expected {GLOVE_DIM}")


def _main(argv=None):
    """Pre-flight CLI: parse a real dataset and hard-check it."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("name", choices=sorted(PUBLISHED))
    p.add_argument("root", nargs="?", default=None)
    args = p.parse_args(argv)

    from stargcn_tpu_torch.data.movielens import LoadData

    data = LoadData(args.name, root=args.root)
    csr = data.graph[data.name_user, data.name_item]
    validate_loaded(args.name, num_ratings=csr.nnz,
                    num_users=csr.shape[0], num_items=csr.shape[1],
                    num_levels=len(csr.multi_link))
    print(f"{args.name}: OK — {csr.nnz} ratings, {csr.shape[0]} users, "
          f"{csr.shape[1]} items, {len(csr.multi_link)} rating levels")


if __name__ == "__main__":
    _main()
