"""Print ``<task_type>_<index>`` for log and artifact naming
(scripts/job_name.py).

    python -m tethys_tpu_torch.scripts.job_name

As the JAX script and the reference's job_name.py:1-15 do: TF_CONFIG's
``task.type`` and ``task.index`` as they stand (``None`` where one is
missing; malformed JSON raises), else ``worker_<rank>``, the
torch.distributed rank (0 without a process group).
"""

from __future__ import annotations

import json
import os

from tethys_tpu_torch.parallel.mesh import rank


def main() -> str:
    tf_config = json.loads(os.environ.get("TF_CONFIG") or "{}")
    task = tf_config.get("task", {})
    job_name, task_index = task.get("type"), task.get("index")
    if not tf_config:
        job_name, task_index = "worker", rank()
    name = f"{job_name}_{task_index}"
    print(name)
    return name


if __name__ == "__main__":
    main()
