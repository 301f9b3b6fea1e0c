"""Record points of the activation census (profiling/tensorsize.py).

flax's ``capture_intermediates`` records the output of every module call.
The census of the port sees the modules it calls as modules through forward
hooks.  The layers it runs through functions (Whisper's convs, fc1, fc2,
token embedding, lm_head and the ``model`` dict; Wav2Vec2's feature
projection dropout) call ``record`` where flax would have called a module.
``record`` does nothing unless a census is running, so a training or
serving step pays one test of a global per site.

Two class attributes tell the census how a JAX module's return value
differs from the port's: ``census_pair`` (the JAX module returns
``(output, cache)``, so flax names the output ``.../__call__/0/0``) and
``census_skip`` (dict keys the port returns beyond the JAX contract, left
out of the census).
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

_records: Optional[List[tuple]] = None


def active() -> bool:
    return _records is not None


def record(module, value: Any, name: Optional[str] = None,
           channels_first: bool = False) -> None:
    """Record ``value`` as the output of one call of ``module`` (of its
    child ``name``, when flax has a module there and the port does not).
    ``channels_first``: ``value`` is [B, C, T], which flax holds as
    [B, T, C]."""
    if _records is not None:
        _records.append((module, name, value, channels_first))


@contextlib.contextmanager
def capturing():
    """Collects (module, name, value, channels_first) in call order, the
    forward hooks' records and ``record``'s alike."""
    global _records
    if _records is not None:
        raise RuntimeError("a census is already running")
    _records = []
    try:
        yield _records
    finally:
        _records = None
