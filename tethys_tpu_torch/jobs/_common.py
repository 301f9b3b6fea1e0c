"""Flags shared by the job CLIs (jobs/_common.py).

The reference's ``--num_batches`` and ``--batch_size``, the JAX jobs'
``--dtype``, ``--resume`` (restore the job's newest checkpoint) and
``--jax_profile DIR`` (a profiler trace of the run, utils/tracing.py), and
``--device`` (cuda: the kernels on the process's GPU; cpu: the plain
versions, for small runs).  ``start_distributed`` joins the job's process
group (``parallel/mesh.initialize_distributed``: torchrun's env or a
TF_CONFIG that names several processes) for the dist jobs.  The JAX jobs'
parallel and capacity flags are accepted so that they can be refused, each
with an error that names where it waits in ROADMAP.md; none is ignored.
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
    "master_dtype": (dict(type=str, default="float32",
                          choices=["float32", "bfloat16"]), "float32",
                     "queue 1 item 7 (bf16 master weights)"),
    "microbatches": (dict(type=int, default=2), 2,
                     "queue 1 item 7 (pipeline microbatches)"),
}


def add_common_flags(parser: argparse.ArgumentParser,
                     num_batches_default: int, batch_size_default: int,
                     refused=()) -> None:
    """The shared flags, and the JAX job's unported flags in ``refused``."""
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
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint (extension)")
    parser.add_argument(
        "--jax_profile", type=str, default=None, metavar="DIR",
        help="write a torch.profiler trace of the training run to DIR")
    for flag in refused:
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


def start_distributed(args: argparse.Namespace) -> int:
    """Joins the job's process group, if its env names one (nccl on the
    card, gloo with ``--device cpu``), prints it and returns the number of
    replicas."""
    from tethys_tpu_torch.parallel import mesh

    mesh.initialize_distributed(device=args.device)
    if mesh.group_up():
        import torch.distributed as dist

        print(f"process group: {dist.get_backend()}, rank {mesh.rank()} of "
              f"{mesh.world_size()}")
    return mesh.world_size()


def job_device(args: argparse.Namespace):
    """This process's card (require_cuda: ``cuda:<local_rank>``, no CPU
    fallback) or, asked for, the CPU.  Under a process group of several
    ranks, rank 0 builds the kernel library first while the others wait
    at a barrier, so a cold build runs once and not once a rank."""
    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.utils import kernel_lib
    from tethys_tpu_torch.utils.device import require_cuda

    if args.device != "cuda":
        return "cpu"
    device = require_cuda()
    if mesh.world_size() > 1:
        if mesh.rank() == 0:
            kernel_lib.build()
        mesh.barrier()
    return device
