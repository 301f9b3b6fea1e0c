"""The process group and the job identity (tethys_tpu/parallel/mesh.py).

``initialize_distributed()`` is the twin of the JAX package's: one process
per replica, joined from torchrun's env (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, as JAX puts ``JAX_COORDINATOR_ADDRESS``
first), else from a Kubeflow-style TF_CONFIG that names more than one
process (``cluster_spec_from_tf_config``: chief first, the chief's address
as the rendezvous), else standalone with no group, as the reference's dist
scripts run without TF_CONFIG.  ``group_up``, ``rank``, ``world_size``,
``local_rank``, ``barrier`` and ``broadcast_object`` read or use the group
and fall back to one process without it.

``job_identity()`` reproduces job_name.py's ``<task_type>_<index>`` naming
(reference job_name.py:1-15) from TF_CONFIG when present, else from the
rank (0 in a single process).

The 2-D layouts (the JAX meshes of parallel/tp.py, sp.py and pp.py): over
a world of n processes, ``make_2d_mesh(model_parallel)``,
``make_seq_mesh(seq_parallel)`` and ``make_pp_mesh(pipeline_parallel)`` lay
the ranks out as JAX reshapes its devices to (n // inner, inner): rank r
has data coordinate r // inner and inner ("model", "seq" or "stage")
coordinate r % inner.  A replica is one inner group, the unit that holds a
whole set of parameters; the gradients and the logged loss are summed over
the data group only.  The (data, stage) layout also holds this rank's
stage-to-stage hops: one two-rank group for each adjacent pair (s, s + 1)
of each replica (``Layout.hops``).  ``make_data_mesh()`` is the layout of
plain data parallelism (inner 1).  Without a process group every layout is
a world of one, and has no groups.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

_TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def _parse_tf_config():
    raw = os.environ.get("TF_CONFIG")
    if not raw:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


def group_up() -> bool:
    """Whether this process has joined a process group."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return torch.distributed.get_rank() if group_up() else 0


def world_size() -> int:
    """The number of replicas (1 without a group)."""
    return torch.distributed.get_world_size() if group_up() else 1


def local_rank() -> int:
    """The card of this process on its host: torchrun's ``LOCAL_RANK``,
    else 0 (a Kubeflow pod holds one card)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def barrier() -> None:
    """Every rank waits here for the others (nothing without a group)."""
    if not group_up():
        return
    dist = torch.distributed
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (itself without a group)."""
    if not group_up():
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def job_identity() -> Tuple[str, int]:
    """(task_type, task_index) for log/JCT file naming."""
    tf_config = _parse_tf_config()
    if tf_config:
        task = tf_config.get("task", {})
        task_type = task.get("type") or "worker"
        task_index = int(task.get("index") or 0)
        return task_type, task_index
    return "worker", rank()


def cluster_spec_from_tf_config(tf_config: dict
                                ) -> Optional[Tuple[str, int, int]]:
    """(coordinator_address, num_processes, process_id) from a TF_CONFIG,
    or None for a single-process config.  Chief first, then the other task
    types sorted, each with its own id range."""
    cluster = tf_config.get("cluster", {})
    types = sorted(cluster.keys(), key=lambda t: (t != "chief", t))
    hosts = [h for t in types for h in cluster.get(t, [])]
    if len(hosts) <= 1:
        return None
    task = tf_config.get("task", {})
    task_type = task.get("type") or "worker"
    task_index = int(task.get("index") or 0)
    offset = 0
    for t in types:
        if t == task_type:
            break
        offset += len(cluster.get(t, []))
    return hosts[0], len(hosts), offset + task_index


def multi_process_spec() -> Optional[Tuple[str, int, int]]:
    """The TF_CONFIG cluster spec of this job when it names > 1 process."""
    tf_config = _parse_tf_config()
    return cluster_spec_from_tf_config(tf_config) if tf_config else None


def initialize_distributed(timeout_s: int = 120,
                           backend: Optional[str] = None,
                           device: str = "cuda") -> None:
    """Join the job's process group when a cluster spec exists (module
    doc); return at once when the group is already up.

    ``backend`` defaults to ``nccl`` for a job on the card (``device``
    "cuda", the card ``cuda:<local_rank>`` set first) and to ``gloo`` for
    one on the CPU.  ``timeout_s`` bounds the rendezvous and every
    collective, as the reference's 120 s collective-op hardening does
    (wav2vec2_dist.py:1463-1471)."""
    if group_up():
        return
    if all(os.environ.get(k) for k in _TORCHRUN_ENV):
        init = dict(init_method="env://")
    else:
        spec = multi_process_spec()
        if spec is None:
            return
        coordinator, num_processes, process_id = spec
        init = dict(init_method=f"tcp://{coordinator}",
                    world_size=num_processes, rank=process_id)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        torch.cuda.set_device(local_rank())
    torch.distributed.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **init)


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up."""
    if group_up():
        torch.distributed.destroy_process_group()


class Layout(NamedTuple):
    """This process's place in a (data, inner) layout of the world.

    ``axis`` names the inner axis as the JAX mesh does ("model" for tensor
    parallelism, "seq" for sequence parallelism, "stage" for pipeline
    parallelism, "data" when there is none, inner 1).  ``data_group`` and
    ``inner_group`` are the process groups of this rank's data and inner
    groups, None where the group holds one rank (its collectives are the
    identity).  ``hops``: under "stage", the two-rank groups this rank
    shares with the stage before it and the stage after it, (previous,
    next), None at either end."""
    axis: str
    data: int                 # data replicas (the data group's size)
    inner: int                # ranks of one replica
    data_rank: int            # this rank's data coordinate, r // inner
    inner_rank: int           # this rank's inner coordinate, r % inner
    data_group: Any = None
    inner_group: Any = None
    hops: Tuple[Any, Any] = (None, None)


def _new_groups(rank_lists: List[List[int]], me: int):
    """Every rank makes every group, in the same order (as
    ``torch.distributed.new_group`` requires); returns this rank's."""
    mine = None
    for ranks in rank_lists:
        group = torch.distributed.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def _layout(axis: str, inner: int) -> Layout:
    n, me = world_size(), rank()
    if n % inner != 0:
        name = {"model": "tp", "seq": "seq", "stage": "pp"}.get(axis, axis)
        raise ValueError(f"{n} devices not divisible by {name}={inner}")
    data = n // inner
    data_group = inner_group = None
    if group_up():
        world = torch.distributed.group.WORLD
        # A group that spans the world is the world's own (a world of one
        # included, whose SUM over one rank the data-parallel step keeps).
        if inner == 1:
            data_group = world
        elif data > 1:
            data_group = _new_groups(
                [[d * inner + i for d in range(data)] for i in range(inner)],
                me)
        if data == 1:
            inner_group = world if inner > 1 else None
        elif inner > 1:
            inner_group = _new_groups(
                [[d * inner + i for i in range(inner)] for d in range(data)],
                me)
    hops = (None, None)
    if group_up() and axis == "stage" and inner > 1:
        hops = _hop_groups(data, inner, me)
    return Layout(axis, data, inner, me // inner, me % inner, data_group,
                  inner_group, hops)


def _hop_groups(data: int, stages: int, me: int):
    """(previous, next): this rank's two-rank groups with the stage before
    and the stage after it in its replica, of the groups every rank makes
    in the same order, pair (s, s + 1) of replica d at d * (stages - 1) +
    s."""
    prev = nxt = None
    for d in range(data):
        for s in range(stages - 1):
            pair = [d * stages + s, d * stages + s + 1]
            group = torch.distributed.new_group(pair)
            if me == pair[0]:
                nxt = group
            elif me == pair[1]:
                prev = group
    return prev, nxt


def make_data_mesh() -> Layout:
    """Plain data parallelism: one replica a rank."""
    return _layout("data", 1)


def make_2d_mesh(model_parallel: int = 2) -> Layout:
    """The (data, model) layout of tensor parallelism (JAX
    ``tp.make_2d_mesh``)."""
    return _layout("model", model_parallel)


def make_seq_mesh(seq_parallel: int = 4) -> Layout:
    """The (data, seq) layout of sequence parallelism (JAX
    ``sp.make_seq_mesh``)."""
    return _layout("seq", seq_parallel)


def make_pp_mesh(pipeline_parallel: int = 2) -> Layout:
    """The (data, stage) layout of pipeline parallelism (JAX
    ``pp.make_pp_mesh``): rank r at stage r % S of replica r // S, with its
    hops (``Layout.hops``)."""
    return _layout("stage", pipeline_parallel)
