"""flash_roofline: the least time of a step's flash work (csrc/flash_fwd.cu
and flash_bwd.cu at the sites the port's gate sends them, work.py) over
those kernels' device time a step, in percent.

Layer: kernels; source: device_trace; moves: train_audio_s_per_s."""


def read(ctx):
    work = ctx.kernel_work("flash")
    if ctx.reading is None or not work:
        return None
    seconds = ctx.reading.by_group_s["flash"] / ctx.steps
    if seconds <= 0.0:
        return None
    return sum(w.seconds() for w in work) / seconds * 100.0
