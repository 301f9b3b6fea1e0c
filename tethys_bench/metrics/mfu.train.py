"""mfu.train: a step's model FLOPs (forward and backward, nothing
recomputed; work.py's formula from the configuration and the traffic's
shapes) over the plain window's wall time a step, over the card's dense
bf16 peak, in percent.

Layer: model step; source: host_clock; moves: train_audio_s_per_s."""

from tethys_bench.work import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.reading is None or ctx.wall_s <= 0.0:
        return None
    return (ctx.step_flops() / (ctx.wall_s / ctx.steps) / PEAK_BF16_FLOPS
            * 100.0)
