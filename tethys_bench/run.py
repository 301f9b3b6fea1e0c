"""Run one cell of the benchmark once.

    python3 -m tethys_bench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout on a machine with the cell's NVIDIA cards.
Prints the run's progress and, as its last lines on standard error, each
number the correctness check compared beside its limit; the last line of
standard output is one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), the compared numbers last under ``checked``.  Exits with 1
and prints no result when there is no card or too few, and when a module
of JAX, jaxlib, flax or the JAX package is loaded once the window has
closed.

Caches stay inside the checkout, at fixed paths: the program builds its
kernels into ``tethys_tpu_torch/_build/``, and Triton's, the torch
extensions' and the NVRTC kernels' caches go under ``.bench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
_CACHE = _ROOT / ".bench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(_CACHE / _sub)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if str(_ROOT) not in sys.path:
        sys.path.insert(0, str(_ROOT))
    import torch

    from tethys_bench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    print(f"card: {harness.card_name_and_limit()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX side are loaded: {found}",
              file=sys.stderr)
        return 1
    for name, item in result["checked"].items():
        print(f"{name} {item['value']!r} limit {item['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
