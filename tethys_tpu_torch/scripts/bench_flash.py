"""Kernel-level timing of the flash attention forward and backward, on the
card (the twin of scripts/bench_flash.py).

    python -m tethys_tpu_torch.scripts.bench_flash [--bh 128] [--t 1536] \\
        [--kv_len 1500] [--rate 0.1] [--iters 50] [--tq TQ] [--dtype bfloat16]

Times ``ops.flash_attention.flash_attention_fwd`` and
``flash_attention_bwd`` (the kernels of csrc/flash_fwd.cu and
csrc/flash_bwd.cu) at whisper-encoder shapes: q [bh, tq, 64], k and v
[bh, t, 64] with the keys at or past ``--kv_len`` masked, inputs drawn as
the JAX script draws them (numpy seed 0: q, k, v, do; q and k times 0.3;
dropout seed 7).  The backward takes o and lse from one forward at the same
rate.  After a warm-up call, ``--iters`` back-to-back launches run on the
current stream between two CUDA events; one stream runs them in order.
Prints the JAX script's two lines, ``flash_fwd ... ms/call (bh=... tq=...
t=... rate=...)`` and the same for ``flash_bwd``.  At ``--t 2560 --kv_len
2560`` the backward covers the keys the TPU splits across its two
several-block kernels.  ``--device cpu`` runs the plain versions on the CPU
(host clock); its numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tethys_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
)
from tethys_tpu_torch.utils.device import card_name_and_power, require_cuda

HEAD_DIM = 64
SEED = 7


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bh", type=int, default=128)      # B*H (whisper-base: 16*8)
    p.add_argument("--t", type=int, default=1536)      # padded KV length
    p.add_argument("--tq", type=int, default=None)     # query length (default t)
    p.add_argument("--kv_len", type=int, default=1500)
    p.add_argument("--rate", type=float, default=0.1)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    tq = args.tq or args.t
    device = torch.device("cpu") if args.device == "cpu" else require_cuda()
    dtype = getattr(torch, args.dtype)
    rng = np.random.default_rng(0)

    def draw(shape, scale=None):
        x = torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)
        return x if scale is None else x * scale

    q = draw((args.bh, tq, HEAD_DIM), 0.3)
    k = draw((args.bh, args.t, HEAD_DIM), 0.3)
    v = draw((args.bh, args.t, HEAD_DIM))
    do = draw((args.bh, tq, HEAD_DIM))
    o, lse = flash_attention_fwd(q, k, v, args.kv_len, args.rate, SEED)

    def fwd():
        return flash_attention_fwd(q, k, v, args.kv_len, args.rate, SEED)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, args.kv_len,
                                   args.rate, SEED)

    def run(name, fn) -> float:
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
            dt = start.elapsed_time(end) / args.iters
        else:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            dt = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{name:12s} {dt:8.3f} ms/call   "
              f"(bh={args.bh} tq={tq} t={args.t} rate={args.rate})",
              flush=True)
        return dt

    result = {
        "flash_fwd_ms": run("flash_fwd", fwd),
        "flash_bwd_ms": run("flash_bwd", bwd),
        "bh": args.bh, "tq": tq, "t": args.t, "kv_len": args.kv_len,
        "rate": args.rate, "iters": args.iters, "dtype": args.dtype,
        "backend": device.type,
        "device": (card_name_and_power() if device.type == "cuda" else "cpu"),
    }
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
