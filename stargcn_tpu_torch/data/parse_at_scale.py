"""The MovieLens parse at ML-1M's full scale, timed.

    python -m stargcn_tpu_torch.data.parse_at_scale [OUT_DIR]
        [--num_users 6040 --num_items 3952 --num_edges 1000209]

The port of ``scripts/parse_at_scale.py``: writes an archive in ML-1M's
exact file formats and at its scale (6,040 users x 3,952 movies, 1,000,209
``::``-delimited ratings, with ``users.dat`` and ``movies.dat``;
``data/synthetic.py:write_ml1m_format``, seed 0), then reads it through
``data/movielens.py:LoadData`` (the parser, the feature builders, the graph
and the transductive split, 10% test and 10% valid) and prints one JSON
line: the write and parse seconds, ratings parsed a second, the graph's
counts and the process's peak resident memory.  ``OUT_DIR`` defaults to a
temporary directory, removed afterwards.  Host work only: it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time


def run(root, num_users=6040, num_items=3952, num_edges=1_000_209):
    """Write the archive under ``root`` and parse it; the JSON dict."""
    from stargcn_tpu_torch.data.movielens import LoadData
    from stargcn_tpu_torch.data.synthetic import write_ml1m_format

    t0 = time.time()
    write_ml1m_format(os.path.join(root, "ml-1m"), num_users=num_users,
                      num_items=num_items, num_edges=num_edges, seed=0)
    write_s = time.time() - t0
    with open(os.path.join(root, "ml-1m", "ratings.dat")) as f:
        n_lines = sum(1 for _ in f)

    t0 = time.time()
    data = LoadData("ml-1m", root=root, test_ratio=0.1, val_ratio=0.1)
    parse_s = time.time() - t0
    csr = data.graph[data.name_user, data.name_item]
    return {
        "archive_ratings": n_lines,
        "write_s": write_s,
        "parse_and_build_s": parse_s,
        "ratings_per_s": n_lines / parse_s,
        "num_users": int(data.num_user),
        "num_items": int(data.num_item),
        "graph_nnz": int(csr.nnz),
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--num_users", type=int, default=6040)
    p.add_argument("--num_items", type=int, default=3952)
    p.add_argument("--num_edges", type=int, default=1_000_209)
    args = p.parse_args(argv)
    root = args.out_dir or tempfile.mkdtemp(prefix="parse_at_scale_")
    try:
        out = run(root, args.num_users, args.num_items, args.num_edges)
    finally:
        if args.out_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
