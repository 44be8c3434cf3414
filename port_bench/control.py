"""The readings the check's limits are set from, at a cell's own size on
the card (the benchmark's own runs do not run this):

* ``program``: the program against the reference, one reading a seed;
* ``control``: the reference with TF32 on (its float32 products on the
  card's TF32 path, the next precision below the configurations' float32
  with TF32 off), put in the program's place, against the reference;
* ``fault:<name>``: the program with a planted fault against the
  reference: ``unchanged`` (the optimiser step leaves every parameter and
  moment as it was) and ``half_batch`` (the second half of each batch left
  out, the loss a mean over the rest).  ``unchanged`` reads 1 on
  ``grad_gap`` and ``change_gap`` by construction, so ``main`` runs
  ``half_batch`` alone.

    python3 port_bench/control.py --workload ml10m.train --seeds 12 \
        --control_seeds 3 --fault_seeds 3

Prints one JSON line a reading, and the largest and smallest reading of
each number by kind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import check, harness  # noqa: E402


def unchanged(trainer):
    """The optimiser step returns the gradient norm and changes nothing."""
    opt = trainer.opt

    def step(grads, keep=None):
        return torch.sqrt(opt.global_sq_norm(grads))

    opt.step = step


def half_batch(trainer):
    """Each step's loss is a mean over the first half of its batch."""
    orig = trainer._loss_and_grads

    def loss_and_grads(ints, flts, noise, rmask):
        flts = flts.clone()
        flts[1, flts.shape[1] // 2:] = 0.0
        return orig(ints, flts, noise, rmask)

    trainer._loss_and_grads = loss_and_grads


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}


def readings(workload, seed, kinds, device="cuda", max_iter=10,
             graph_override=None, cfg_override=None, traffic_override=None):
    """``{kind: compared numbers}`` for one seed: ``program``, and where
    asked ``control`` and each fault."""
    cell = harness.Cell(workload, seed, device, graph_override,
                        cfg_override, traffic_override=traffic_override)
    out = {}
    cell.build(max_iter=max_iter)
    prog = cell.program_side()
    cell.free_program(keep_data=True)
    ref = cell.reference_side()
    out["program"] = check.compare(prog, ref)
    notes = {"program": check.worst_leaves(prog, ref)}
    if "control" in kinds:
        tf32 = cell.reference_side(allow_tf32=True)
        out["control"] = check.compare(tf32, ref)
        notes["control"] = check.worst_leaves(tf32, ref)
    for name, fault in FAULTS.items():
        if f"fault:{name}" not in kinds:
            continue
        cell.build(fault=fault, max_iter=max_iter)
        broken = cell.program_side()
        cell.free_program(keep_data=True)
        out[f"fault:{name}"] = check.compare(broken, cell.reference_side())
    out["notes"] = notes
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--fault_seeds", type=int, default=3)
    ap.add_argument("--first_seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    by_kind = {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        kinds = {"program"}
        if k < args.control_seeds:
            kinds.add("control")
        if k < args.fault_seeds:
            kinds.add("fault:half_batch")
        res = readings(args.workload, seed, kinds)
        notes = res.pop("notes")
        if k == 0:
            print(json.dumps({"seed": seed, "worst_leaves": notes}),
                  flush=True)
        for kind, nums in res.items():
            print(json.dumps({"seed": seed, "kind": kind, **nums}),
                  flush=True)
            for name, v in nums.items():
                by_kind.setdefault(kind, {}).setdefault(name, []).append(v)
    for kind, nums in by_kind.items():
        for name, vs in nums.items():
            print(f"{kind} {name}: max {max(vs)!r} min {min(vs)!r} "
                  f"n {len(vs)}", flush=True)


if __name__ == "__main__":
    main()
