"""Job identity from the cluster spec (tethys_tpu/parallel/mesh.py).

``job_identity()`` reproduces job_name.py's ``<task_type>_<index>`` naming
(reference job_name.py:1-15) from a Kubeflow-style TF_CONFIG when present,
else from the torch.distributed rank (0 in a single process).
``cluster_spec_from_tf_config`` is the plain-Python parser the multi-process
runtime will use (ROADMAP.md, queue 1 item 5); today the training job uses
it to refuse a multi-host spec.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple


def _parse_tf_config():
    raw = os.environ.get("TF_CONFIG")
    if not raw:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


def _rank() -> int:
    import torch

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def job_identity() -> Tuple[str, int]:
    """(task_type, task_index) for log/JCT file naming."""
    tf_config = _parse_tf_config()
    if tf_config:
        task = tf_config.get("task", {})
        task_type = task.get("type") or "worker"
        task_index = int(task.get("index") or 0)
        return task_type, task_index
    return "worker", _rank()


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
