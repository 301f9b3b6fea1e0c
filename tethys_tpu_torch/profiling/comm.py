"""The collective report of a data-parallel job (tethys_tpu/profiling/
hlo_comm.py's file).

The JAX job sums the payload of every collective in the train step's
compiled HLO.  The port's step issues its collectives itself, so the bytes
are what it hands to each kind each step (``dp.make_train_step``'s
``collective_bytes``): the data group's gradient buckets and loss
(``all-reduce``) and, under a (data, model) or (data, seq) layout, the
model's own collectives (ops/sharding.py: the row-parallel sums, the
gathered channels, K and V or logits, the shard norms of the clips) and
the replicated gradients' broadcast over the model or seq group
(``broadcast``); under a (data, stage) layout the pipeline's hops
(``collective-permute``, the kind JAX's report gives its ppermute) and
the stage and data groups' gradient sums (``all-reduce``,
parallel/pp.py).  The file, ``<task>_<idx>_collectives.txt`` beside the
JCT file, has the JAX file's format: ``kind,bytes_per_step``, one line per
kind, then ``total``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from tethys_tpu_torch.utils.artifacts import read_model_name, result_dir


def write_collective_report(bytes_by_kind: Dict[str, int], task_type: str,
                            task_index: int,
                            out_dir: Optional[str] = None) -> Optional[str]:
    """Write ``<task>_<idx>_collectives.txt``; returns its path, or None
    when there is no run name (``model.txt``) or the write fails."""
    if out_dir is None:
        name = read_model_name()
        if name is None:
            return None
        out_dir = os.path.join(result_dir(), name)
    path = os.path.join(out_dir, f"{task_type}_{task_index}_collectives.txt")
    try:
        with open(path, "w") as f:
            f.write("kind,bytes_per_step\n")
            for kind, nbytes in sorted(bytes_by_kind.items()):
                f.write(f"{kind},{nbytes}\n")
            f.write(f"total,{sum(bytes_by_kind.values())}\n")
        return path
    except OSError as e:
        print(f"collective report write failed: {e}")
        return None
