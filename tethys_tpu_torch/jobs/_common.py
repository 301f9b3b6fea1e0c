"""Flags shared by the job CLIs (jobs/_common.py).

The reference's ``--num_batches`` and ``--batch_size``, the JAX jobs'
``--dtype``, ``--resume`` (restore the job's newest checkpoint) and
``--jax_profile DIR`` (a profiler trace of the run with the program's
spans on its timeline, and the spans' own file; utils/tracing.py), and
``--device`` (cuda: the kernels on the process's GPU; cpu: the plain
versions, for small runs); the CLIs with parallel flags also take
``--backend`` (the process group's: nccl on the card and gloo on the CPU
by default; gloo lets several ranks share one card).
``start_distributed`` joins the job's process group
(``parallel/mesh.initialize_distributed``: torchrun's env or a TF_CONFIG
that names several processes) for the dist jobs.  The JAX jobs'
single-card capacity flags (``CAPACITY``: --remat, --remat_layers,
--grad_accum, --master_dtype) are taken by the CLIs whose JAX twins take
them, the parallel flags (``PARALLEL``) by the CLIs whose JAX twins take
them: --tp and --sp by whisper_dist and wav2vec2_dist, --pp and
--microbatches by whisper_dist; the tensorsize jobs' parallel flags
(``REFUSED``: their JAX twins take none) are accepted so that they can be
refused, each with an error that names ROADMAP.md; none is ignored.
"""

from __future__ import annotations

import argparse

# flag -> argparse keywords, with the JAX CLI's help (jobs/whisper_dist.py).
PARALLEL = {
    "tp": dict(type=int, default=1,
               help="tensor-parallel degree over a 2-D (data, model) mesh "
                    "(extension; reference is DP-only)"),
    "sp": dict(type=int, default=1,
               help="sequence-parallel degree over a (data, seq) mesh: "
                    "encoder time axis sharded (extension)"),
    "pp": dict(type=int, default=1,
               help="pipeline-parallel degree over a (data, stage) mesh: "
                    "encoder layer stack GPipe-pipelined (extension)"),
    "microbatches": dict(type=int, default=2,
                         help="microbatches per step under --pp"),
}
# The tensorsize jobs: their JAX twins take no parallel flag.
TENSORSIZE_WHERE = ("queue 1 item 7 (the JAX tensorsize jobs take no "
                    "parallel flag)")
# flag -> the value that is supported (the default: the flag unset)
REFUSED = {"tp": 1, "sp": 1, "pp": 1, "microbatches": 2}
# flag -> argparse keywords, with the JAX CLI's help (jobs/whisper_dist.py).
CAPACITY = {
    "remat": dict(action="store_true",
                  help="checkpoint the forward pass (medium/large HBM)"),
    "remat_layers": dict(action="store_true",
                         help="per-layer nn.remat (holds only layer-boundary "
                              "activations; the capacity mode for "
                              "medium/large — stronger than --remat)"),
    "grad_accum": dict(type=int, default=1,
                       help="accumulate N microbatches per optimizer step "
                            "(extension; batch_size must divide by N)"),
    "master_dtype": dict(type=str, default="float32",
                         choices=["float32", "bfloat16"],
                         help="master param/Adam-moment dtype; bfloat16 is "
                              "the single-chip capacity mode for "
                              "medium/large (pair with --remat_layers)"),
}


def add_common_flags(parser: argparse.ArgumentParser,
                     num_batches_default: int, batch_size_default: int,
                     refused=(), capacity=(), parallel=()) -> None:
    """The shared flags, the parallel flags its JAX twin does not take in
    ``refused`` (each refusal naming TENSORSIZE_WHERE), its capacity flags
    in ``capacity`` and its parallel flags in ``parallel``."""
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
        help="write a torch.profiler trace of the training run, with the "
             "program's spans (utils/tracing.py) on its timeline, to DIR as "
             "trace_<pid>.json, and the spans with their summary as "
             "spans_<pid>.json")
    for flag in refused:
        parser.add_argument(f"--{flag}", **PARALLEL[flag])
    for flag in capacity:
        parser.add_argument(f"--{flag}", **CAPACITY[flag])
    for flag in parallel:
        parser.add_argument(f"--{flag}", **PARALLEL[flag])
    if parallel:
        parser.add_argument(
            "--backend", type=str, default=None, choices=["nccl", "gloo"],
            help="process group backend (default: nccl on the card, gloo on "
                 "the CPU; gloo lets several ranks share one card)")
    parser.tethys_refused = {flag: REFUSED[flag] for flag in refused}
    parser.tethys_parallel = tuple(parallel)


def parse(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse; refuse two of the CLI's --tp, --sp and --pp above 1 (its JAX
    twin's error) where it takes a parallel flag, then every unported flag
    set to another value than the supported one (exit code 2, the ROADMAP
    item in the message)."""
    args = parser.parse_args(argv)
    refused = getattr(parser, "tethys_refused", {})
    parallel = getattr(parser, "tethys_parallel", ())
    flags = [f for f in ("tp", "sp", "pp") if hasattr(args, f)]
    if parallel and sum(getattr(args, f) > 1 for f in flags) > 1:
        names = [f"--{f}" for f in flags]
        parser.error(f"{', '.join(names[:-1])} and {names[-1]} are "
                     "mutually exclusive")
    for flag, supported in refused.items():
        value = getattr(args, flag)
        if value != supported:
            parser.error(f"--{flag} {value} is not ported yet (ROADMAP.md, "
                         f"{TENSORSIZE_WHERE})")
    return args


def start_distributed(args: argparse.Namespace) -> int:
    """Joins the job's process group, if its env names one (nccl on the
    card, gloo with ``--device cpu``), prints it and returns the number of
    replicas."""
    from tethys_tpu_torch.parallel import mesh

    mesh.initialize_distributed(device=args.device,
                                backend=getattr(args, "backend", None))
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
