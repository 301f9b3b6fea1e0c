"""The control of each cell comes out not correct: the plain reference
put in the program's place as a float8 training step (every product's
operands in e4m3, its output's gradient in e5m2; one step below the
bfloat16 the configurations state), held to the
cell's own limits, at tiny sizes on the CPU.  (On the card, at the cells'
sizes, ``calibrate.py`` reads it; PERF.md gives those readings.)"""

import json
from pathlib import Path

import pytest
import torch

from tethys_bench import calibrate, compare, harness, traffic
from tethys_bench.reference import common
from tethys_bench.tests import tiny

torch.set_num_threads(2)
LIMITS = Path(__file__).resolve().parents[1] / "limits"
CELLS = {"whisper-base.train.b128": "whisper",
         "wav2vec2-base.pretrain.clip2s.b250": "wav2vec2"}


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_cells_limits(name, seed):
    with open(LIMITS / f"{name}.json") as fh:
        limits = json.load(fh)
    cell = tiny.cell(CELLS[name])
    pool = traffic.pool(cell.traffic, cell.config, seed)[:3]
    ref = harness.reference_steps(cell, seed, pool, "cpu")
    reading = calibrate.against(cell, seed, pool, "cpu", ref,
                                prec=common.Precision("float8"))
    assert not compare.judge(reading, limits)["correct"], reading


def test_control_rounds_operands_and_output_gradients():
    """The control's product: operands in float8 e4m3, the gradient of its
    output in float8 e5m2, each with one scale a tensor; float32 leaves
    both alone."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(6, 7, generator=gen, requires_grad=True)
    w = torch.randn(3, 7, generator=gen)
    up = torch.randn(6, 3, generator=gen)
    fp8 = common.Precision("float8")
    common.linear(x, w, None, fp8).backward(up)
    scale = up.abs().max() / 57344.0
    g8 = (up / scale).to(torch.float8_e5m2).float() * scale
    wscale = w.abs().max() / 448.0
    w8 = (w / wscale).to(torch.float8_e4m3fn).float() * wscale
    assert torch.allclose(x.grad, g8 @ w8, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(x.grad, up @ w8, rtol=1e-3, atol=1e-3)
    x.grad = None
    common.linear(x, w, None, common.FLOAT32).backward(up)
    assert torch.equal(x.grad, up @ w)
