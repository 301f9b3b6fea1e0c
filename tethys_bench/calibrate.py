"""The readings that the limits of ``correct`` are set from, for one cell,
on the card, at the cell's own sizes.

    python3 -m tethys_bench.calibrate --workload <cell> --seeds 11 12 ... \
        [--control 12] [--half 4] [--out calibrate.jsonl]

For every seed, in one process (the job is built once; each seed loads its
own weights and starts the optimizer afresh): the program's first three
steps through its loop against the plain reference (the lower readings).
For the first ``--control`` seeds (default: all) also the control, the
reference computed as a float8 training step computes it (every
product's operands in e4m3, its output's gradient in e5m2; one step below
the bfloat16 the configurations state), and for the first
``--half`` the fault of half the batch left out (the reference on the
first half of each batch, the mean over it), each against the float32
reference (the upper readings).  Every number of ``compare.NUMBERS`` is
read on each side.  A step that returns its state unchanged reads 1 on
``delta_gap`` by the measure and needs no run.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tethys_bench import compare, harness
from tethys_bench import traffic as traffic_lib
from tethys_bench.reference import common as ref_common


def against(cell, seed, pool, device, ref, **kw) -> dict:
    """The readings of a reference variant against ``ref``."""
    other = harness.reference_steps(cell, seed, pool, device, **kw)
    start = {n: t.cpu() for n, t in harness.weights_lib.draw(
        harness.families.get(cell.config["family"]).reference.param_spec(
            cell.config), seed, device).items()}
    moved = set(ref["grads"])
    return compare.readings(
        other["losses"], ref["losses"], other["grads"], ref["grads"],
        harness.deltas(other["params"], start, set(other["grads"])),
        harness.deltas(ref["params"], start, moved))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=None,
                   help="seeds that also read the control (default: all)")
    p.add_argument("--half", type=int, default=3,
                   help="seeds that also read the half-batch fault")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    controls = len(args.seeds) if args.control is None else args.control
    print(f"card: {harness.card_name_and_limit()}", file=sys.stderr)
    spans = harness.Spans()
    program = None
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if program is None:
            program = harness.Program(cell, seed, device, spans)
        else:
            program.load_weights(seed)
        pool = traffic_lib.pool(cell.traffic, cell.config, seed)[:3]
        clock = harness.Clock()
        program.run(pool, 0, 3, seed, clock)
        evidence = program.evidence(clock.losses)
        t1 = time.perf_counter()
        ref = harness.reference_steps(cell, seed, pool, device)
        t2 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed,
                "program": harness.check(cell, seed, evidence, ref, device),
                "losses": {"program": evidence["losses"],
                           "reference": ref["losses"]},
                "seconds": {"program": t1 - t0, "reference": t2 - t1}}
        if i < controls:
            line["control"] = against(cell, seed, pool, device, ref,
                                      prec=ref_common.Precision("float8"))
        if i < args.half:
            line["half"] = against(cell, seed, pool, device, ref,
                                   rows=cell.traffic["batch"] // 2)
        line["seconds"]["all"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX side are loaded: {found}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
