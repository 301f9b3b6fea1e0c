"""Convergence check: f32 against bf16 master weights (and bf16 Adam
moments), the twin of scripts/convergence_check.py.

    python -m tethys_tpu_torch.scripts.convergence_check [--steps 100] \\
        [--family whisper] [--model base] [--device cuda|cpu]

The single-card capacity mode ``--master_dtype bfloat16`` keeps the master
weights and Keras Adam's moments in bf16; rounding the moments is a known
silent-quality trap.  So this runs ``--steps`` steps of the training
bench's step (scripts/bench.py's ``build_family_step``: the bench's fixed
batch, bf16 compute, dropout on) under both master dtypes, on identical
data and generators (``dp.step_generator(0, i)`` for step i), prints each
run's summary to stderr and one JSON record to stdout: the first and last
losses, the largest relative loss gap over the back half, a verdict
("match" when that gap is below 0.02 and both curves fall, "diverged" when
one does not fall, else "gap"), every fifth loss of each curve and the
device.  ``--device cpu`` runs the plain versions, for small runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.scripts import bench
from tethys_tpu_torch.utils.device import require_cuda


def run_curve(master_dtype: str, family: str, steps: int, model: str,
              device) -> list:
    """The losses of ``steps`` bench steps under ``master_dtype``."""
    args = bench.parse_args(["--model", model, "--family", family,
                             "--master_dtype", master_dtype,
                             "--device", device.type])
    job, batch, probe, _, _, _ = bench.build_family_step(args, family,
                                                         device)
    state, losses = job.state, []
    t0 = time.perf_counter()
    for i in range(steps):
        state, loss = job.step_fn(state, batch, dp.step_generator(0, i))
        losses.append(loss)
    values = [float(v) for v in torch.stack(losses).float().cpu()]
    probe(state).item()
    print(f"{master_dtype}: {steps} steps in "
          f"{time.perf_counter() - t0:.0f}s, loss {values[0]:.4f} -> "
          f"{values[-1]:.4f}", file=sys.stderr, flush=True)
    return values


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--family", default="whisper")
    p.add_argument("--model", default="base")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = torch.device("cpu") if args.device == "cpu" else require_cuda()

    f32 = run_curve("float32", args.family, args.steps, args.model, device)
    bf16 = run_curve("bfloat16", args.family, args.steps, args.model, device)

    # Relative loss gap over the back half of the run (after warm-up).
    half = args.steps // 2
    max_gap = max(abs(a - b) / max(abs(a), 1e-9)
                  for a, b in zip(f32[half:], bf16[half:]))
    both_decreasing = f32[-1] < f32[0] and bf16[-1] < bf16[0]
    verdict = ("match" if max_gap < 0.02 and both_decreasing
               else "diverged" if not both_decreasing else "gap")
    record = {
        "metric": f"{args.family}_{args.model}_bf16_master_convergence",
        "steps": args.steps,
        "f32_first_last": [round(f32[0], 4), round(f32[-1], 4)],
        "bf16_first_last": [round(bf16[0], 4), round(bf16[-1], 4)],
        "max_rel_gap_back_half": round(max_gap, 4),
        "verdict": verdict,
        "f32_curve_every5": [round(v, 4) for v in f32[::5]],
        "bf16_curve_every5": [round(v, 4) for v in bf16[::5]],
        "backend": device.type,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
