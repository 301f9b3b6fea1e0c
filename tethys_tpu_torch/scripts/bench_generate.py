"""Serving benchmark: batched greedy decoding with the KV cache, on the card
(the twin of scripts/bench_generate.py).

    python -m tethys_tpu_torch.scripts.bench_generate --batch_size 16 \\
        --length 128 --model base --dtype bfloat16 --iters 20

Random weights from ``--seed``, a batch of seeded random 30 s log-mel
inputs; ``greedy_generate`` runs encode, the cross-KV precompute (int8 by
default, ``--kv_quant none`` keeps the compute dtype) and exactly
``--length`` decode steps (random weights never emit EOS at step 1).  Each
timed call is bracketed by ``torch.cuda.synchronize()``.  As in JAX, decode
time is the generate time minus the encode time; where that subtraction
fails (decode under 5% of generate) the whole generate time stands in and
``decode_is_whole_generate_lower_bound`` says so.  Prints one JSON line:

    {"metric": "whisper_base_decode_tokens_per_sec_per_chip", "value": ...}

Set ``TETHYS_FUSED_QKV=1`` to run every projection through the fused
projection kernels.  ``--device cpu`` runs the plain versions on the CPU;
its numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from tethys_tpu_torch.models.whisper import (
    create_whisper_model,
    greedy_generate,
    make_chunked_greedy,
)
from tethys_tpu_torch.utils.device import card_name_and_power, require_cuda


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--length", type=int, default=128)
    p.add_argument("--model", default="base")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--kv_quant", default="int8", choices=["none", "int8"],
                   help="int8 cross-KV caches with f32 per-column scales "
                        "(the default, as in JAX), or none")
    p.add_argument("--early_stop_chunk", type=int, default=None,
                   help="read the done flag every C decode steps and stop "
                        "after a global EOS; must divide --length")
    p.add_argument("--host_chunk", type=int, default=None,
                   help="the same stop through make_chunked_greedy; reports "
                        "chunks_run")
    p.add_argument("--force_eos", action="store_true",
                   help="make every batch row identical and declare the "
                        "first emitted token EOS (global EOS at step 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--no_fused_decode", action="store_true",
                   help="not ported: the plain decode is not a path on the "
                        "card")
    args = p.parse_args(argv)
    if args.no_fused_decode:
        p.error("--no_fused_decode is not ported: on the card every decode "
                "step runs the decode kernel; the plain decode runs only on "
                "CPU tensors")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device("cpu") if args.device == "cpu" else require_cuda()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    model, config = create_whisper_model(
        args.model, device=device, seed=args.seed, compute_dtype=args.dtype,
        kv_quant=args.kv_quant)
    frames = 2 * config.n_ctx
    rng = np.random.default_rng(args.seed)
    features = torch.from_numpy(rng.standard_normal(
        (args.batch_size, config.n_mels, frames), dtype=np.float32)).to(device)

    if args.force_eos:
        features = features[:1].expand_as(features).contiguous()
        probe, _ = greedy_generate(model, features[:1], max_length=2)
        model.config = dataclasses.replace(config,
                                           eos_token_id=int(probe[0, 1]))

    if args.host_chunk is not None:
        gen = make_chunked_greedy(model, args.length, args.host_chunk)
    else:
        def gen(feats):
            return greedy_generate(model, feats, max_length=args.length,
                                   early_stop_chunk=args.early_stop_chunk)
    encode = torch.inference_mode()(model.encode)

    _, length = gen(features)          # warm-up
    n_decoded = int(length) - 1
    encode(features)

    def timed(fn) -> float:
        total = 0.0
        for _ in range(args.iters):
            sync()
            t0 = time.perf_counter()
            fn(features)
            sync()
            total += time.perf_counter() - t0
        return total / args.iters

    dt_total = timed(gen)
    dt_encode = timed(encode)
    dt_decode = dt_total - dt_encode
    subtraction_failed = dt_decode < 0.05 * dt_total
    if subtraction_failed:
        dt_decode = dt_total
    audio_seconds = frames * 160 / 16000 * args.batch_size
    result = {
        "metric": f"whisper_{args.model}_decode_tokens_per_sec_per_chip",
        "value": n_decoded * args.batch_size / dt_decode,
        "unit": "tokens/sec/chip",
        "per_token_latency_ms": dt_decode / max(n_decoded, 1) * 1e3,
        "encode_ms": dt_encode * 1e3,
        "rtf_e2e": audio_seconds / dt_total,
        **({"decode_is_whole_generate_lower_bound": True}
           if subtraction_failed else {}),
        "batch_size": args.batch_size,
        "decode_len": n_decoded,
        "dtype": args.dtype,
        "kv_quant": args.kv_quant,
        "backend": device.type,
        "device": (card_name_and_power() if device.type == "cuda" else "cpu"),
        **({"host_chunk": args.host_chunk, "chunks_run": gen.chunks_run}
           if args.host_chunk is not None else {}),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
