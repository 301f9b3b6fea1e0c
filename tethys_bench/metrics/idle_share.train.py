"""idle_share.train: the share of the traced window in which no operation
ran on the device (1 - the union of the device's intervals / the window),
in percent: the idle share that the result line's ``busy_s`` and
``window_s`` give.

Layer: device; source: device_trace; moves: train_audio_s_per_s."""


def read(ctx):
    if ctx.reading is None or ctx.reading.window_s <= 0.0:
        return None
    return (1.0 - ctx.reading.busy_s / ctx.reading.window_s) * 100.0
