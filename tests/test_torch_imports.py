"""The port stands alone: importing every module of ``stargcn_tpu_torch``
pulls in no ``jax``, ``flax``, ``optax`` or ``stargcn_tpu``, and
``chip_smoke.py`` imports none of them either.  Checked in a fresh
interpreter, since this test process has the JAX package loaded."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stargcn_tpu")

_PROBE = """
import importlib, pkgutil, sys
import stargcn_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in {forbidden!r})
print(len([n for n in sys.modules if n.startswith("stargcn_tpu_torch.")]))
print(",".join(bad))
"""


def test_port_imports_no_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True).stdout.splitlines()
    assert int(out[0]) >= 15, "not every module was imported"
    assert out[1] == "", f"forbidden modules imported: {out[1]}"


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & set(FORBIDDEN), roots
    assert "stargcn_tpu_torch" in roots


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Where there is no CUDA device, or no port beside it, the script
    exits non-zero and prints no result."""
    import shutil

    import torch

    runs = [(ROOT, os.path.join(ROOT, "chip_smoke.py"))]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    runs.append((str(tmp_path), str(alone)))
    for cwd, script in runs:
        if cwd == ROOT and torch.cuda.is_available():
            continue
        p = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0, (cwd, p.stdout)
        assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout


SCRIPT_TWINS = ("stargcn_tpu_torch.probes.ell_crossover_sweep",
           "stargcn_tpu_torch.train.beyond_hbm",
           "stargcn_tpu_torch.train.reproduce",
           "stargcn_tpu_torch.data.parse_at_scale")


def test_script_twins_import_alone():
    """The twins of the JAX package's scripts, each imported first in a
    fresh interpreter, pull in nothing of JAX nor of the JAX package."""
    probe = ("import importlib, sys\n"
             f"for name in {SCRIPT_TWINS!r}:\n"
             "    importlib.import_module(name)\n"
             "print(','.join(sorted(n for n in sys.modules\n"
             f"      if n.split('.')[0] in {set(FORBIDDEN)!r})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "", f"forbidden modules imported: {out}"
