"""The comparison that decides ``correct`` for a training cell.

The program's first three steps (the first steps of the warm-up, through
the window's own loop, on three distinct batches) against the plain
reference's three steps from the same weights, batches and seeds:

- ``loss_gap``: the largest of the three steps' |loss - reference loss| /
  |reference loss|;
- ``grad_gap``: the first gradient as the optimizer took it, the program's
  worked out from its Adam state after one step (m / (1 - b1)); over the
  leaves, the largest gap of the two norms, |‖g‖ - ‖g_ref‖|, over the
  larger of the reference leaf's norm and the median leaf's;
- ``delta_gap``: the same of each leaf's change after three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others, such as a key projection's bias under the
  softmax, move under Adam by round-off alone);
- ``grad_gap_median`` and ``delta_gap_median``: the median over the
  leaves of the gaps that ``grad_gap`` and ``delta_gap`` take the largest
  of.

A cell compares the numbers its limits file names (see PERF.md for why a
cell leaves one out); the others are printed for the record.

The program and the reference have to move the same leaves: a leaf that
only one side moves makes the run incorrect whatever the numbers say.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            tensors.items()}


def _median(values: List[float]) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


def _gap(value: float, ref: float, scale: float) -> float:
    """|value - ref| / scale, infinite where either side is not finite."""
    gap = abs(value - ref) / max(scale, 1e-30)
    return gap if gap == gap else float("inf")


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    median = _median([ref[n] for n in names])
    return {n: _gap(prog[n], ref[n], max(ref[n], median)) for n in names}


def _worst(gaps: Dict[str, float]):
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(prog_losses, ref_losses, prog_grads, ref_grads,
             prog_deltas, ref_deltas) -> dict:
    """The three numbers (and the leaf that set each), or
    ``{"leaves": ...}`` when the two sides moved different leaves."""
    moved_p, moved_r = set(prog_grads), set(ref_grads)
    if moved_p != moved_r:
        return {"leaves": sorted(moved_p ^ moved_r)[:8]}
    loss_gaps = [_gap(p, r, abs(r)) for p, r in zip(prog_losses,
                                                     ref_losses)]
    g_p, g_r = _norms(prog_grads), _norms(ref_grads)
    names = sorted(moved_r)
    grad_gaps = _gaps(g_p, g_r, names)
    grad_gap, grad_leaf = _worst(grad_gaps)
    floor = 1e-3 * _median([g_r[n] for n in names])
    kept = [n for n in names if g_r[n] >= floor]
    d_p = _norms({n: prog_deltas[n] for n in kept})
    d_r = _norms({n: ref_deltas[n] for n in kept})
    delta_gaps = _gaps(d_p, d_r, kept)
    delta_gap, delta_leaf = _worst(delta_gaps)
    return {"loss_gap": max(loss_gaps), "grad_gap": grad_gap,
            "delta_gap": delta_gap,
            "grad_gap_median": _median(list(grad_gaps.values())),
            "delta_gap_median": _median(list(delta_gaps.values())),
            "loss_gaps": loss_gaps, "grad_leaf": grad_leaf,
            "delta_leaf": delta_leaf, "leaves_left_out": len(names) - len(kept)}


NUMBERS = ("loss_gap", "grad_gap", "delta_gap", "grad_gap_median",
           "delta_gap_median")


def judge(reading: dict, limits: dict) -> dict:
    """{number: (value, limit)} of the numbers ``limits`` names, and
    whether every one is within its limit; a run whose sides moved
    different leaves is not correct."""
    if "leaves" in reading:
        return {"correct": False, "numbers": {
            "leaves_moved_by_one_side": (float(len(reading["leaves"])),
                                         0.0)}}
    if not limits or not set(limits) <= set(NUMBERS):
        raise ValueError(f"limits name unknown numbers: {sorted(limits)}")
    numbers = {k: (reading[k], limits[k]) for k in NUMBERS if k in limits}
    ok = all(v <= lim for v, lim in numbers.values())
    return {"correct": ok, "numbers": numbers}
