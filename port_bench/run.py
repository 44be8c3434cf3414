"""Run one cell of the benchmark once and print its result.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository, on a machine with the CUDA
cards the cell asks for.  The last line of standard output is the result
(one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit); the line before it describes the
graph.  The compared numbers are also the last lines of standard error.
Without the cards, or if JAX or the JAX package was loaded, it exits with
a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# The program builds its kernels and host extension into
# ``stargcn_tpu_torch/_build/`` inside the checkout, which serves every
# later run there; it uses no other build or kernel cache.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.NoDevice as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
