"""MovieLens and GloVe archive download and extraction, on the stdlib alone
(``urllib`` + ``zipfile``).

The port's copy of ``stargcn_tpu/data/download.py``:

- atomic download: stream to a ``.part`` temp file, rename on success,
  so an interrupted fetch never leaves a truncated archive that a later
  run mistakes for complete;
- optional sha1 verification (GroupLens publishes no checksums, so the
  default is no check);
- exponential backoff between attempts;
- atomic extraction via ``zipfile`` into the dataset root.

``LoadData`` calls ``ensure_movielens`` only when the extracted directory
is absent and ``STARGCN_AUTO_DOWNLOAD`` is not ``0``.  Where there is no
network every attempt fails and ``LoadData`` raises a
``FileNotFoundError`` saying where to place the archive instead.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import time
import urllib.request
import zipfile

log = logging.getLogger(__name__)

# (zip name, URL, extracted subdir); the extracted subdir names are fixed
# by the archives themselves.
MOVIELENS_ARCHIVES = {
    "ml-100k": ("ml-100k.zip",
                "https://files.grouplens.org/datasets/movielens/ml-100k.zip",
                "ml-100k"),
    "ml-1m": ("ml-1m.zip",
              "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
              "ml-1m"),
    "ml-10m": ("ml-10m.zip",
               "https://files.grouplens.org/datasets/movielens/ml-10m.zip",
               "ml-10M100K"),
}


def sha1_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def fetch(url: str, dest: str, *, sha1: str | None = None,
          retries: int = 5, timeout: float = 30.0,
          backoff_s: float = 1.0) -> str:
    """Download ``url`` to ``dest`` atomically with bounded retries.

    Returns ``dest``.  An existing file with a matching hash (or any
    existing file when no hash is given) is kept as-is.  Raises the
    last error after ``retries`` failed attempts.
    """
    if os.path.exists(dest) and (sha1 is None or sha1_of(dest) == sha1):
        return dest
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    # Per-process temp name: concurrent trainers (multi-host runs share
    # a filesystem) must not delete each other's in-flight .part files.
    part = f"{dest}.part.{os.getpid()}"
    last_err: Exception | None = None
    for attempt in range(max(1, retries)):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            log.info("downloading %s -> %s (attempt %d/%d)",
                     url, dest, attempt + 1, retries)
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(part, "wb") as f:
                while True:
                    block = r.read(1 << 20)
                    if not block:
                        break
                    f.write(block)
            if sha1 is not None and sha1_of(part) != sha1:
                raise OSError(f"sha1 mismatch for {url}")
            os.replace(part, dest)
            return dest
        except Exception as e:  # URLError / OSError / timeout
            last_err = e
            log.warning("download attempt %d failed: %s", attempt + 1, e)
        finally:
            if os.path.exists(part):
                os.remove(part)
    raise last_err if last_err is not None else OSError("no attempts")


# The title vectors: fetched explicitly (a 2 GB archive) by ensure_glove or
# the CLI below, and read through ``STARGCN_GLOVE_PATH``.
GLOVE_ARCHIVE = ("glove.840B.300d.zip",
                 "https://nlp.stanford.edu/data/glove.840B.300d.zip",
                 "glove.840B.300d.txt")


def _extract_atomic(archive: str, root: str, member: str) -> str:
    """Extract ``archive`` so that ``root/member`` (a file or
    directory) appears ATOMICALLY: extract into a per-process temp
    sibling and rename into place.  An interrupted extraction can
    therefore never leave a partial ``root/member`` that a later run's
    existence check mistakes for complete — the same failure mode the
    ``.part`` download protocol prevents, one step later."""
    final = os.path.join(root, member)
    tmp_root = os.path.join(root, f".extract.{os.getpid()}")
    os.makedirs(tmp_root, exist_ok=True)
    try:
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(tmp_root)
        tmp_member = os.path.join(tmp_root, member)
        if not os.path.exists(tmp_member):
            raise FileNotFoundError(
                f"archive {archive} did not contain the expected "
                f"'{member}'")
        try:
            os.rename(tmp_member, final)
        except OSError:
            if not os.path.exists(final):  # lost a concurrent race?
                raise
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
    return final


def ensure_glove(root: str, *, retries: int = 5,
                 backoff_s: float = 1.0) -> str:
    """Return the path of ``glove.840B.300d.txt`` under ``root``,
    downloading + extracting the Stanford archive if absent."""
    zip_name, url, txt_name = GLOVE_ARCHIVE
    txt_path = os.path.join(root, txt_name)
    if os.path.isfile(txt_path):
        return txt_path
    archive = fetch(url, os.path.join(root, zip_name),
                    retries=retries, backoff_s=backoff_s)
    log.info("extracting %s", archive)
    return _extract_atomic(archive, root, txt_name)


def ensure_movielens(name: str, root: str, *, retries: int = 5,
                     backoff_s: float = 1.0) -> str:
    """Return the extracted dataset directory for ``name`` under
    ``root``, downloading + extracting the GroupLens archive if absent."""
    zip_name, url, subdir = MOVIELENS_ARCHIVES[name]
    data_dir = os.path.join(root, subdir)
    if os.path.isdir(data_dir):
        return data_dir
    archive = fetch(url, os.path.join(root, zip_name),
                    retries=retries, backoff_s=backoff_s)
    log.info("extracting %s", archive)
    return _extract_atomic(archive, root, subdir)


def _main(argv=None):
    """CLI pre-fetch: ``python -m stargcn_tpu_torch.data.download
    <ml-100k|ml-1m|ml-10m|all|glove> [root]``."""
    import argparse

    from stargcn_tpu_torch.data.movielens import _DEFAULT_ROOT

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what",
                   choices=sorted(MOVIELENS_ARCHIVES) + ["all", "glove"])
    # Same default root LoadData resolves (<repo>/datasets) — a
    # cwd-relative default would pre-fetch where training never looks.
    p.add_argument("root", nargs="?",
                   default=os.environ.get("STARGCN_DATA_ROOT",
                                          _DEFAULT_ROOT))
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.what == "glove":
        print(ensure_glove(args.root))
    else:
        names = (sorted(MOVIELENS_ARCHIVES) if args.what == "all"
                 else [args.what])
        for name in names:
            print(ensure_movielens(name, args.root))


if __name__ == "__main__":
    _main()
