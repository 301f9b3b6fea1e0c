"""The benchmark's FLOP formulas (work.py) against PyTorch's own count of
the plain reference's forward and backward, at tiny sizes on the CPU.

``FlopCounterMode`` bills a grouped convolution's weight gradient
``groups`` times; here each product of a convolution's backward costs what
its forward costs, as work.py counts it.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from tethys_bench import traffic, weights, work
from tethys_bench.reference import common, wav2vec2, whisper
from tethys_bench.tests import tiny


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                   _padding, _dilation, transposed, _output_padding,
                   _groups, output_mask, out_shape=None, **kwargs):
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def _counted(module, cfg, tr) -> float:
    params = weights.draw(module.param_spec(cfg), 3, "cpu")
    batch = tuple(torch.from_numpy(a) for a in traffic.pool(tr, cfg, 3)[0])
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward})
    with counter:
        module.loss_and_grads(params, batch, common.step_generator(3, 0),
                              cfg, block_rows=tr["reference_rows"])
    return float(counter.get_total_flops())


@pytest.mark.parametrize("labels", [20, 33])
def test_whisper_formula_equals_counter(labels):
    cfg = tiny.config("whisper")
    tr = dict(tiny.WHISPER_TRAFFIC, label_len=labels)
    want = _counted(whisper, cfg, tr)
    got = work.whisper_step_flops(cfg, tr["batch"], tr["frames"], labels)
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("samples", [1600, 2401])
def test_wav2vec2_formula_equals_counter(samples):
    cfg = tiny.config("wav2vec2")
    tr = dict(tiny.WAV2VEC2_TRAFFIC, samples=samples)
    want = _counted(wav2vec2, cfg, tr)
    got = work.wav2vec2_step_flops(cfg, tr["batch"], samples)
    assert got == pytest.approx(want, rel=1e-9)
