"""The paper's experiment matrix: every shipped config, its best test RMSE
beside the published one.

    python -m stargcn_tpu_torch.train.reproduce --data_root DIR [--out DIR]
        [--parity] [--configs NAME,...] [--max_iter N] [--device cpu]

The port of ``scripts/reproduce_paper.sh`` and ``scripts/data_parity.sh``.
``--data_root`` holds the extracted GroupLens archives::

    DIR/ml-100k/     (u.user, u.item, u1.base, u1.test, u.data)
    DIR/ml-1m/       (users.dat, movies.dat, ratings.dat)
    DIR/ml-10M100K/  (movies.dat, ratings.dat)

1. Pre-flight: each dataset that the chosen configs read is parsed and held
   to its published counts (``data/invariants.py``), so that a truncated or
   mis-extracted archive fails here and not as a wrong RMSE hours later.
   A dataset whose directory is absent fails too: nothing is downloaded.
2. Each config (the 15 of ``configs/``; with ``--parity`` the three
   transductive ones) trains through the train CLI (``python -m
   stargcn_tpu_torch.train``, ``--inductive`` for an inductive config) in
   a process of its own, with ``--save_dir OUT/<config>``; its output goes
   to ``OUT/<config>.out``, whose last ``result:`` line gives the row.
3. ``OUT/summary.tsv``: ``config``, ``best_iter``, ``best_valid_rmse``,
   ``best_test_rmse`` (the last block's) and ``paper_rmse`` (0.895 / 0.832 /
   0.770 for the transductive ML-100k / ML-1M / ML-10M configs,
   ``tables3-4`` for the inductive ones: the paper's Tables 3 and 4).
   With ``--parity`` also ``OUT/parity.md``, the markdown table of the three
   datasets.  Nothing is written outside ``OUT`` (default
   ``runs/paper_repro``, with ``--parity`` ``runs/data_parity``).

``--configs`` takes a subset by name, ``--max_iter`` caps every run (a
rehearsal; the paper's numbers need the configs' own ``MAX_ITER``),
``--no_preflight`` skips step 1 for archives that are not the published
ones (the test fixtures), and ``--device`` goes to every run (default
``cuda``).  A config's run that outlasts ``TIMEOUT_S`` (a day) is killed
and fails the driver.
"""

from __future__ import annotations

import argparse
import ast
import datetime
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(ROOT, "configs")
PAPER_RMSE = {"transductive_ml_100k": "0.895",
              "transductive_ml_1m": "0.832",
              "transductive_ml_10m": "0.770"}
PARITY = {"ml-100k": "transductive_ml_100k", "ml-1m": "transductive_ml_1m",
          "ml-10m": "transductive_ml_10m"}
ARCHIVE_DIRS = {"ml-100k": "ml-100k", "ml-1m": "ml-1m",
                "ml-10m": "ml-10M100K"}
# A config's run longer than this is killed (the paper's ML-10M configs
# take hours on the card).
TIMEOUT_S = 24 * 3600
HEADER = "config\tbest_iter\tbest_valid_rmse\tbest_test_rmse\tpaper_rmse\n"


def paper_target(name):
    return PAPER_RMSE.get(name, "tables3-4")


def config_names(parity=False):
    """The shipped configs by name (``--parity``: the transductive three)."""
    if parity:
        return list(PARITY.values())
    return sorted(f[:-4] for f in os.listdir(CONFIG_DIR)
                  if f.endswith(".yml"))


def dataset_of(name):
    """The ``DATASET.NAME`` that config ``name`` reads."""
    from stargcn_tpu_torch.utils import cfg_from_file

    return cfg_from_file(os.path.join(CONFIG_DIR, f"{name}.yml")).DATASET.NAME


def preflight(datasets, data_root, log=print):
    """Parse each dataset and hold it to its published counts; raises
    ``FileNotFoundError`` for an absent archive and
    ``invariants.DataInvariantError`` for one that breaks its counts."""
    from stargcn_tpu_torch.data.invariants import validate_loaded
    from stargcn_tpu_torch.data.movielens import LoadData

    for name in datasets:
        path = os.path.join(data_root, ARCHIVE_DIRS[name])
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"{name}: no extracted archive at {path} (nothing is "
                "downloaded; place the GroupLens archive there)")
        log(f"=== pre-flight: {name} invariants ===")
        data = LoadData(name, root=data_root)
        csr = data.graph[data.name_user, data.name_item]
        validate_loaded(name, num_ratings=csr.nnz, num_users=csr.shape[0],
                        num_items=csr.shape[1],
                        num_levels=len(csr.multi_link))
        log(f"{name}: OK — {csr.nnz} ratings, {csr.shape[0]} users, "
            f"{csr.shape[1]} items, {len(csr.multi_link)} rating levels")


def train_argv(name, data_root, save_dir, max_iter=None, device="cuda"):
    """The train CLI's arguments for config ``name``."""
    argv = ["--cfg", os.path.join(CONFIG_DIR, f"{name}.yml"),
            "--data_root", data_root, "--save_dir", save_dir,
            "--device", device]
    if name.startswith("inductive_"):
        argv.append("--inductive")
    if max_iter is not None:
        argv += ["--max_iter", str(max_iter)]
    return argv


def last_result(text):
    """The last ``result: {...}`` of a train CLI's output, or ``{}``."""
    found = re.findall(r"result: (\{.*\})", text)
    return ast.literal_eval(found[-1]) if found else {}


def summary_row(name, result):
    """One line of ``summary.tsv`` from a train CLI ``result``."""
    test = result.get("best_test_rmse")
    test_s = f"{test[-1]:.4f}" if test else "n/a"
    return (f"{name}\t{result.get('best_iter', -1)}\t"
            f"{result.get('best_valid_rmse', float('nan')):.4f}\t"
            f"{test_s}\t{paper_target(name)}\n")


def train_config(name, data_root, out, max_iter=None, device="cuda",
                 log=print, timeout_s=TIMEOUT_S):
    """Run config ``name`` through the train CLI in a process of its own;
    returns its ``result``.  A run that fails, or outlasts ``timeout_s``
    seconds (the child is then killed), raises with the end of its
    output."""
    log(f"=== {name} ===")
    env = dict(os.environ, STARGCN_AUTO_DOWNLOAD="0",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out_path = os.path.join(out, f"{name}.out")
    with open(out_path, "w") as f:
        try:
            code = subprocess.run(
                [sys.executable, "-m", "stargcn_tpu_torch.train",
                 *train_argv(name, data_root, os.path.join(out, name),
                             max_iter, device)],
                cwd=out, env=env, stdout=f, stderr=subprocess.STDOUT,
                timeout=timeout_s).returncode
        except subprocess.TimeoutExpired:
            code = f"no code: killed after {timeout_s} s"
    with open(out_path) as f:
        text = f.read()
    if code != 0:
        raise RuntimeError(f"{name}: the train CLI exited with "
                           f"{code}:\n{text[-3000:]}")
    return last_result(text)


def parity_table(rows):
    """The markdown table of ``--parity``: ``rows`` maps dataset to its
    ``summary_row`` fields."""
    lines = [f"## Real-data RMSE parity "
             f"({datetime.datetime.now(datetime.timezone.utc):%Y-%m-%dT%H:%MZ}"
             ", python -m stargcn_tpu_torch.train.reproduce --parity)", "",
             "| dataset | best test RMSE | paper |", "|---|---|---|"]
    for ds, fields in rows.items():
        lines.append(f"| {ds} | {fields[3]} | {fields[4]} |")
    return "\n".join(lines) + "\n"


def run(data_root, out=None, parity=False, configs=None, max_iter=None,
        device="cuda", check=True, log=print, timeout_s=TIMEOUT_S):
    """The whole run; returns ``{config: result}``.  ``timeout_s``: each
    config's limit (``train_config``)."""
    names = configs or config_names(parity)
    unknown = set(names) - set(config_names())
    if unknown:
        raise ValueError(f"no such config: {sorted(unknown)}")
    out = os.path.abspath(out or os.path.join(
        ROOT, "runs", "data_parity" if parity else "paper_repro"))
    data_root = os.path.abspath(data_root)
    datasets = sorted({dataset_of(n) for n in names})
    if check:
        preflight(datasets, data_root, log)
    os.makedirs(out, exist_ok=True)
    summary = os.path.join(out, "summary.tsv")
    with open(summary, "w") as f:
        f.write(HEADER)
    results = {}
    for name in names:
        results[name] = train_config(name, data_root, out, max_iter, device,
                                     log, timeout_s)
        with open(summary, "a") as f:
            f.write(summary_row(name, results[name]))
    with open(summary) as f:
        log("==== paper reproduction summary ====\n" + f.read())
    if parity:
        table = parity_table({
            ds: summary_row(name, results[name]).rstrip("\n").split("\t")
            for ds, name in PARITY.items() if name in results})
        with open(os.path.join(out, "parity.md"), "w") as f:
            f.write(table)
        log(table)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--parity", action="store_true",
                   help="the three transductive configs and parity.md")
    p.add_argument("--configs", default=None,
                   help="comma-separated config names (default: all)")
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_preflight", action="store_true",
                   help="skip the published-count checks (fixtures)")
    args = p.parse_args(argv)
    run(args.data_root, args.out, args.parity,
        args.configs.split(",") if args.configs else None, args.max_iter,
        args.device, check=not args.no_preflight)
    return 0


if __name__ == "__main__":
    sys.exit(main())
