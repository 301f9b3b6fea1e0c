"""Analytic decode floor per Whisper size and batch on the card (the twin
of scripts/decode_floor.py).

Greedy decode is a pure memory stream: per token each decoder layer
streams its weights (once, shared by the batch), the cross-attention K/V
caches (scaled by the batch), and the growing self-attention K/V cache.
The floor is those bytes over the card's memory rate; the int8 columns
show what halving the cross stream (and the weights) can save at best.
Compare it with the measured ms/token of ``scripts/bench_generate`` to see
how far decode is from the card's memory rate.

    python -m tethys_tpu_torch.scripts.decode_floor [--hbm_gbps 3350] \\
        [--length 128] [--sizes base medium large]

One JSON line a (size, batch), batches 8, 16 and 32.  The default rate is
the H100 SXM's HBM3, 3.35 TB/s, the bound of the kernel table in PERF.md.
"""

from __future__ import annotations

import argparse
import json

SIZES = {
    "base":   dict(L=6,  E=512,  ff=2048, V=51865),
    "medium": dict(L=24, E=1024, ff=4096, V=51865),
    # large-v1/v2 vocab is 51865; 51866 is v3's (extra <|yue|> token).
    "large":  dict(L=32, E=1280, ff=5120, V=51865),
    "large-v3": dict(L=32, E=1280, ff=5120, V=51866),
}
H100_HBM_GBPS = 3350.0


def floor_row(size: str, batch: int, hbm_gbps: float, tk: int = 1500,
              length: int = 128, dtype_bytes: int = 2) -> dict:
    s = SIZES[size]
    L, E, ff, V = s["L"], s["E"], s["ff"], s["V"]
    # Decoder weights streamed once per token (the cross K/V projections
    # run once per generate, so they are left out):
    dec_w = L * (4 * E * E + 2 * E * E + 2 * E * ff) + V * E
    w_bytes = dec_w * dtype_bytes
    cross = L * 2 * E * tk * dtype_bytes * batch
    self_kv = L * 2 * E * (length / 2) * dtype_bytes * batch  # average fill
    total = w_bytes + cross + self_kv
    floor_ms = total / (hbm_gbps * 1e9) * 1e3
    int8_total = total - cross / 2
    return {
        "size": size, "batch": batch,
        "weights_mb": round(w_bytes / 1e6, 1),
        "cross_mb": round(cross / 1e6, 1),
        "self_mb": round(self_kv / 1e6, 1),
        "total_mb_per_token": round(total / 1e6, 1),
        "floor_ms_per_token": round(floor_ms, 3),
        "int8_cross_floor_ms": round(int8_total / (hbm_gbps * 1e9) * 1e3, 3),
        "int8_saving_pct": round(cross / 2 / total * 100, 1),
        # The floor if the decoder weights also streamed int8 (not
        # implemented; it frames what quantizing the weights could save).
        "int8_w_and_cross_floor_ms": round(
            (total - cross / 2 - w_bytes / 2) / (hbm_gbps * 1e9) * 1e3, 3),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hbm_gbps", type=float, default=H100_HBM_GBPS,
                   help="the card's memory rate, GB/s (H100 SXM HBM3)")
    p.add_argument("--length", type=int, default=128)
    p.add_argument("--sizes", nargs="+", default=["base", "medium", "large"],
                   choices=sorted(SIZES), help="sizes to print")
    args = p.parse_args(argv)
    rows = []
    for size in args.sizes:
        for batch in (8, 16, 32):
            rows.append(floor_row(size, batch, args.hbm_gbps,
                                  length=args.length))
            print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
