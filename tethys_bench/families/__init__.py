"""How each model family meets the program and its plain reference: a
configuration file's ``family`` names one of these modules, which
provides ``build_job``, ``reference``, ``step_flops``, ``kernel_work``
and ``RESILIENT``."""

from __future__ import annotations

import importlib
import re


def get(name: str):
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"bad model family name {name!r}")
    return importlib.import_module(f"tethys_bench.families.{name}")
