"""Flags shared by the job CLIs (jobs/_common.py).

The reference's ``--num_batches`` and ``--batch_size``, the JAX jobs'
``--dtype``, and ``--device`` (cuda: the kernels on one GPU; cpu: the plain
versions, for small runs).  The JAX jobs' parallel and capacity flags are
accepted so that they can be refused, each with an error that names where
it waits in ROADMAP.md; none is ignored.
"""

from __future__ import annotations

import argparse

# flag -> (argparse keywords, the value that is supported, where it waits)
REFUSED = {
    "tp": (dict(type=int, default=1), 1,
           "queue 1 item 7 (tensor parallelism)"),
    "sp": (dict(type=int, default=1), 1,
           "queue 1 item 7 (sequence parallelism)"),
    "pp": (dict(type=int, default=1), 1,
           "queue 1 item 7 (pipeline parallelism)"),
    "remat": (dict(action="store_true"), False,
              "queue 1 item 7 (activation checkpointing)"),
    "remat_layers": (dict(action="store_true"), False,
                     "queue 1 item 7 (per-layer remat)"),
    "grad_accum": (dict(type=int, default=1), 1,
                   "queue 1 item 7 (gradient accumulation)"),
    "resume": (dict(action="store_true"), False,
               "queue 1 item 4 (checkpoint restore)"),
    "master_dtype": (dict(type=str, default="float32",
                          choices=["float32", "bfloat16"]), "float32",
                     "queue 1 item 7 (bf16 master weights)"),
    "microbatches": (dict(type=int, default=2), 2,
                     "queue 1 item 7 (pipeline microbatches)"),
    "jax_profile": (dict(type=str, default=None, metavar="DIR"), None,
                    "queue 1 item 6 (profiler trace)"),
}
# Every JAX job takes --jax_profile (its jobs/_common.py).
EVERY_JOB = ("jax_profile",)


def add_common_flags(parser: argparse.ArgumentParser,
                     num_batches_default: int, batch_size_default: int,
                     refused=()) -> None:
    """The shared flags, and the JAX job's unported flags: ``EVERY_JOB``
    and those in ``refused``."""
    parser.add_argument(
        "--num_batches", type=int, default=num_batches_default,
        help=f"num_batches per replica, default is set {num_batches_default}")
    parser.add_argument(
        "--batch_size", type=int, default=batch_size_default,
        help=f"batch size per replica, default is set {batch_size_default}")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (master weights stay float32)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda: the kernels on one GPU; cpu: the plain "
                             "versions")
    for flag in dict.fromkeys(EVERY_JOB + tuple(refused)):
        parser.add_argument(f"--{flag}", **REFUSED[flag][0])


def parse(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, refusing every unported flag set to another value than the
    supported one (exit code 2, the ROADMAP item in the message)."""
    args = parser.parse_args(argv)
    for flag, (_, supported, where) in REFUSED.items():
        value = getattr(args, flag, supported)
        if value != supported:
            parser.error(f"--{flag} {value} is not ported yet (ROADMAP.md, "
                         f"{where})")
    return args


def job_device(args: argparse.Namespace):
    """The card (require_cuda: no CPU fallback) or, asked for, the CPU."""
    from tethys_tpu_torch.utils.device import require_cuda

    return require_cuda() if args.device == "cuda" else "cpu"
