"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level names compared
whole)."""

import os
import subprocess
import sys

from port_bench.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "stargcn_tpu")


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after("import port_bench.reference.model, "
                        "port_bench.reference.train")
    assert "stargcn_tpu_torch" not in tops
    assert not set(FORBIDDEN) & set(tops)


def test_a_toy_run_loads_no_jax():
    code = (
        "from port_bench import harness\n"
        "from port_bench.tests.conftest import toy_overrides\n"
        "doc = harness.load_json('configs', 'ml10m.json')\n"
        "r = harness.run('ml10m.train', 11, 0.2, False, device='cpu',\n"
        "                **toy_overrides(doc))\n"
        "assert r['attempted'] > 0\n")
    tops = loaded_after(code)
    assert "stargcn_tpu_torch" in tops
    assert not set(FORBIDDEN) & set(tops), tops
