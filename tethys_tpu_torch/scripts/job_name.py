"""Print ``<task_type>_<index>`` for log and artifact naming
(scripts/job_name.py).

    python -m tethys_tpu_torch.scripts.job_name

From a Kubeflow-style TF_CONFIG when there is one, else from the
torch.distributed rank when a process group is initialised, else
``worker_0`` (``parallel/mesh.job_identity``).
"""

from __future__ import annotations

from tethys_tpu_torch.parallel.mesh import job_identity


def main() -> str:
    task_type, task_index = job_identity()
    name = f"{task_type}_{task_index}"
    print(name)
    return name


if __name__ == "__main__":
    main()
