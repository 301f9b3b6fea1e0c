"""elementwise_ms.train: device milliseconds a step of every kernel that
is not a product (cuBLAS, cuDNN), a flash or GroupNorm kernel, the
optimizer's, or the input's copy to the card: casts, copies, layout
changes, softmax, GELU, dropout, norms and the losses (``ops/*``).

Layer: ops; source: device_trace; moves: train_audio_s_per_s."""


def read(ctx):
    if ctx.reading is None:
        return None
    return ctx.reading.by_group_s["elementwise"] / ctx.steps * 1e3
