"""group_norm_roofline: the least time of a step's GroupNorm work, forward
and backward (csrc/gn_stats.cu and gn_apply.cu after each convolution of
the feature encoder, work.py) over those kernels' device time a step, in
percent.

Layer: kernels; source: device_trace; moves: train_audio_s_per_s."""


def read(ctx):
    work = ctx.kernel_work("group_norm")
    if ctx.reading is None or not work:
        return None
    seconds = ctx.reading.by_group_s["group_norm"] / ctx.steps
    if seconds <= 0.0:
        return None
    return sum(w.seconds() for w in work) / seconds * 100.0
