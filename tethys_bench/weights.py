"""Random weights from the run's seed, drawn on the device.

One ``torch.Generator`` on the device seeded with the run's seed draws one
flat uniform buffer for every uniform initialiser and one flat normal
buffer for every normal one, in the order of the reference's parameter
list; each parameter is then a scaled slice.  The program and the
reference are both handed these weights; the same seed on the same device
gives the same ones.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def draw(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``spec``'s (name, shape, initialiser)."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(int(np.prod(shape)) for _, shape, init in spec
                       if init[0] in kinds)
             for kind, kinds in (("u", ("glorot", "uniform")),
                                 ("n", ("normal",)))}
    flat = {"u": torch.rand(sizes["u"], generator=generator, device=device),
            "n": torch.randn(sizes["n"], generator=generator, device=device)}
    used = {"u": 0, "n": 0}
    out = {}
    for name, shape, init in spec:
        kind, n = init[0], int(np.prod(shape))
        if kind in ("glorot", "uniform"):
            u = flat["u"][used["u"]:used["u"] + n].view(shape)
            used["u"] += n
            bound = (6.0 / (init[1] + init[2])) ** 0.5 if kind == "glorot" \
                else init[1]
            out[name] = (u * 2.0 - 1.0) * bound
        elif kind == "normal":
            out[name] = flat["n"][used["n"]:used["n"] + n].view(shape).clone()
            used["n"] += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "const":
            out[name] = torch.full(shape, float(init[1]), device=device)
        else:
            raise ValueError(f"{name}: unknown initialiser {init!r}")
    return out
