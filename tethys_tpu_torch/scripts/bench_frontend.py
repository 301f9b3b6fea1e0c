"""Audio frontend timing: the fused log-mel kernel against the rfft path, on
the card (the twin of scripts/bench_frontend.py).

    python -m tethys_tpu_torch.scripts.bench_frontend [--batch 16] \\
        [--seconds 30] [--iters 20] [--n_mels 80] [--device cuda]

Draws a [batch, seconds * 16000] waveform as the JAX script does (numpy
seed 0), puts it on the device, and times two functions of it, each
framing included: ``unfused_ms`` is ``audio.frontend.extract_fbank_features``
(framing, window, ``torch.fft.rfft``, power, mel product, log: one launch
each) and ``fused_ms`` is ``audio.logmel.fused_log_mel`` (csrc/logmel.cu,
which frames the waveform itself).  After a warm-up call, ``--iters`` calls
run back to back on the current stream between two CUDA events.  Prints one
JSON line, metric ``frontend_logmel_ms_per_batch``, with ``unfused_ms``,
``fused_ms``, ``speedup`` (unfused over fused), ``max_abs_diff`` (the two
outputs' largest difference, log domain) and ``device`` (the card's name
and power limit).  The JAX script's ``xla_ms`` is ``unfused_ms`` here: no
XLA runs.  ``--n_mels 128`` is whisper-large-v3's frontend (the JAX
script has 80 only).  ``--device cpu`` runs both on the CPU, where the fused function
takes its plain version (host clock; the numbers are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tethys_tpu_torch.audio.frontend import extract_fbank_features
from tethys_tpu_torch.audio.logmel import fused_log_mel
from tethys_tpu_torch.utils.device import card_name_and_power, require_cuda

SAMPLE_RATE = 16000


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seconds", type=int, default=30)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device("cpu") if args.device == "cpu" else require_cuda()
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal(
        (args.batch, args.seconds * SAMPLE_RATE)).astype(np.float32)).to(device)

    def timed(fn) -> float:
        fn()  # warm-up
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / args.iters
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        return (time.perf_counter() - t0) / args.iters * 1e3

    with torch.inference_mode():
        def unfused():
            return extract_fbank_features(wave, n_mels=args.n_mels)

        def fused():
            return fused_log_mel(wave, n_mels=args.n_mels)

        unfused_ms = timed(unfused)
        fused_ms = timed(fused)
        diff = (fused() - unfused()).abs().max()
    result = {
        "metric": "frontend_logmel_ms_per_batch",
        "batch": args.batch, "seconds": args.seconds, "iters": args.iters,
        "n_mels": args.n_mels,
        "unfused_ms": unfused_ms, "fused_ms": fused_ms,
        "speedup": unfused_ms / fused_ms, "max_abs_diff": diff.item(),
        "device": (card_name_and_power() if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
