"""What bounds the flash kernels' routes on the card.

JSON lines, one a reading:

- ``card``: the card's name and power limit, its SM count and top clock.
- ``sass``: for each instantiation of the wgmma kernels in csrc/flash_fwd.cu
  and csrc/flash_bwd.cu (``cuobjdump -sass`` of the built library), the
  instructions by class, and for the keep-bit loop (the loop that holds
  the Philox rounds' IMAD.WIDE.U32) its instructions per Philox4x32-10 call
  and per keep bit: a static count of a loop that draws one 32-bit word,
  8 calls, so what one call runs where Tk % 4 == 0.
- ``times``: the attention rows of the main path (whisper-base b16's
  encoder self-attention and cross-attention, the flash bench's long
  shape), each route, the plain versions and SDPA forward and backward,
  and beside them variants built from the routes' own sources and
  launched on the same inputs: ``no_philox`` (each keep word a few integer
  operations on its counter: the Philox rounds gone, everything else as
  it is), and for the backward ``no_dq`` (dq's product and its additions
  into the f32 buffer gone) and ``no_passes`` (the delta / zero pass and
  dq's cast gone).  Where a variant is faster, what it removed is on the
  kernel's critical path.  ``issue_ms``: the keep bits' Philox
  instructions over the card's issue rate (4 warp instructions a clock an
  SM at the top clock), the least time the bits take.

    python -m tethys_tpu_torch.scripts.flash_probe [--out FILE]

Needs a CUDA card, nvcc and cuobjdump (CUDA_HOME, default
/usr/local/cuda).  Times: CUDA events behind a device spin, median of 30.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys

import torch

from tethys_tpu_torch.ops import flash_attention as fa
from tethys_tpu_torch.ops.dropout import dropout_scale, dropout_threshold
from tethys_tpu_torch.scripts.dropout_probe import (
    _tool,
    event_ms,
    sass_functions,
    sass_loops,
)
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import card_name_and_power

SEED = 4321
RATE = 0.1
PHILOX_CALLS_A_WORD = 8   # keep_bits<32> on whole counters
# (label, B*H, Tq, Tk, rate): whisper-base b16's encoder self-attention
# (rates 0 and the training rate), its cross-attention, and the flash
# bench's long shape past the TPU's one-block backward.
ROWS = (
    ("self, rate 0", 32, 1500, 1500, 0.0),
    ("self", 128, 1500, 1500, RATE),
    ("cross", 128, 100, 1500, RATE),
    ("long, rate 0", 16, 2560, 2560, 0.0),
)
# Variants of each source: {name: [(old, new), ...]}, each old text once
# in the source.
CHEAP_BITS = ("__device__ __forceinline__ uint32_t probe_bits(uint64_t n, "
              "uint32_t seed, uint32_t threshold) {\n  return (uint32_t)n * "
              "0x9E3779B9u ^ seed ^ threshold;\n}\n")
FWD_VARIANTS = {
    "no_philox": [("words[w] = tethys::keep_bits<32>(",
                   "words[w] = probe_bits("),
                  ("namespace {\n", "namespace {\n" + CHEAP_BITS)],
}
BWD_VARIANTS = {
    "no_philox": FWD_VARIANTS["no_philox"],
    "no_dq": [("hp::wgmma_ss_m64n64k16<1, 1>(dq_acc, a, b, kk != 0);", ";"),
              ("    dq_out(t);\n  };", "  };")],
    "no_passes": [("  int err = is_bf16 ? launch_prep<bf16>(o, dout, delta, "
                   "dq_acc, rows, D, s)\n                    : "
                   "launch_prep<float>(o, dout, delta, dq_acc, rows, D, s);\n"
                   "  if (err) return err;\n", "  int err = 0;\n"),
                  ("  if (err || !is_bf16) return err;\n", "  return err;\n")],
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="also write the lines here")
    return p.parse_args(argv)


def card() -> dict:
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout
    return {"reading": "card", "gpu": card_name_and_power(),
            "sms": props.multi_processor_count,
            "max_sm_clock_mhz": float(clock.split()[0])}


def sass_rows(lib_path: str) -> list:
    rows = []
    for name, code in sorted(sass_functions(lib_path, "wgmma_kernel").items()):
        if "flash" not in name:
            continue
        ops = collections.Counter(op for _, op, _ in code)
        row = {"reading": "sass", "function": name,
               "instructions": len(code),
               "hgmma": sum(n for op, n in ops.items()
                            if op.startswith("HGMMA")),
               "mufu_ex2": ops["MUFU.EX2"],
               "imad_wide_u32": ops["IMAD.WIDE.U32"]}
        draws = [loop for loop in sass_loops(code)
                 if loop.count("IMAD.WIDE.U32") >= 20 * PHILOX_CALLS_A_WORD]
        if draws:
            loop = min(draws, key=len)
            row.update(
                keep_loop=len(loop),
                per_philox_call=len(loop) / PHILOX_CALLS_A_WORD,
                per_keep_bit=len(loop) / (4 * PHILOX_CALLS_A_WORD),
                loop_opcodes=dict(collections.Counter(loop).most_common(8)))
        rows.append(row)
    return rows


def build_variants(out_dir) -> dict:
    """Each variant of flash_fwd.cu and flash_bwd.cu in its own library
    (nvcc with the port's flags, all at once): {(source, name): CDLL}."""
    procs = {}
    for source, variants in (("flash_fwd", FWD_VARIANTS),
                             ("flash_bwd", BWD_VARIANTS)):
        src = (kernel_lib.CSRC_DIR / f"{source}.cu").read_text()
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{source} variant {name}: {old!r} is "
                                       "not in the source once")
                text = text.replace(old, new)
            cu = out_dir / f"{source}_{name}.cu"
            cu.write_text(text)
            lib = out_dir / f"{source}_{name}.so"
            procs[source, name] = (lib, subprocess.Popen(
                [_tool("nvcc"), *kernel_lib.NVCC_FLAGS, "-shared", "-I",
                 str(kernel_lib.CSRC_DIR), "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key}: nvcc failed\n{report[-4000:]}")
        so = ctypes.CDLL(str(lib))
        if key[0] == "flash_fwd":
            so.tethys_flash_fwd_dropout.argtypes = \
                kernel_lib.FLASH_FWD_DROPOUT.argtypes
            so.tethys_flash_fwd.argtypes = kernel_lib.FLASH_FWD.argtypes
        else:
            so.tethys_flash_bwd.argtypes = kernel_lib.FLASH_BWD.argtypes
        built[key] = so
    return built


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def fwd_call(so, q, k, v, rate):
    """A call of ``so``'s forward on the wgmma route (outputs allocated
    once)."""
    bh, tq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, k.shape[1], d, k.shape[1], 1)
    route = fa.ROUTES.index("wgmma")
    stream = kernel_lib.stream_handle(q)

    def run():
        if rate:
            _check(so.tethys_flash_fwd_dropout(
                *args, SEED, dropout_threshold(rate), dropout_scale(rate),
                route, stream), "forward variant")
        else:
            _check(so.tethys_flash_fwd(*args, route, stream),
                   "forward variant")
    return run


def bwd_call(so, q, k, v, o, lse, do, rate):
    """A call of ``so``'s backward on the wgmma route."""
    bh, tq, d = q.shape
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((bh, tq, d), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, k.shape[1], d, k.shape[1], 1, int(rate > 0), SEED,
            dropout_threshold(rate) if rate else 0,
            float(1 - rate) if rate else 1.0,
            dropout_scale(rate) if rate else 1.0, fa.ROUTES.index("wgmma"),
            kernel_lib.stream_handle(q))

    def run():
        _check(so.tethys_flash_bwd(*args), "backward variant")
    return run


def time_rows(variants: dict, sass: list, gpu: dict) -> list:
    philox = {r["function"]: r.get("per_philox_call") for r in sass}
    rows = []
    for label, bh, tq, tk, rate in ROWS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = (torch.randn(bh, tq, 64, generator=gen, device="cuda")
             * 0.125).bfloat16()
        k, v = (torch.randn(bh, tk, 64, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        do = torch.randn(bh, tq, 64, generator=gen, device="cuda").bfloat16()
        o, lse = fa.flash_fwd_cuda(q, k, v, tk, rate, SEED)
        row = {"reading": "times", "shape": label, "bh": bh, "tq": tq,
               "tk": tk, "rate": rate}
        for route in ("wgmma", "mma"):
            row[f"fwd_{route}_ms"] = event_ms(lambda: fa.flash_fwd_cuda(
                q, k, v, tk, rate, SEED, route=route))
            row[f"bwd_{route}_ms"] = event_ms(lambda: fa.flash_bwd_cuda(
                q, k, v, o, lse, do, tk, rate, SEED, route=route))
        for (source, name), so in variants.items():
            if name == "no_philox" and not rate:
                continue
            if source == "flash_fwd":
                row[f"fwd_{name}_ms"] = event_ms(fwd_call(so, q, k, v, rate))
            else:
                row[f"bwd_{name}_ms"] = event_ms(
                    bwd_call(so, q, k, v, o, lse, do, rate))
        row["fwd_plain_ms"] = event_ms(lambda: fa.plain_flash_fwd(
            q, k, v, tk, rate, SEED))
        row["bwd_plain_ms"] = event_ms(lambda: fa.plain_flash_bwd(
            q, k, v, o, lse, do, tk, rate, SEED))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_lib = torch.nn.functional.scaled_dot_product_attention(
            leaves[0][None], leaves[1][None], leaves[2][None],
            dropout_p=rate, scale=1.0)[0]
        row["fwd_sdpa_ms"] = event_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], dropout_p=rate, scale=1.0))
        row["bwd_sdpa_ms"] = event_ms(lambda: torch.autograd.grad(
            o_lib, leaves, do, retain_graph=True))
        if rate:
            # Philox calls of the keep bits: whole 128-key tiles of every
            # 128-row (forward) or 64-row (backward) block, as drawn.
            rows_f = -(-tq // 128) * 128
            rows_b = -(-tq // 64) * 64
            cols = -(-tk // 128) * 128
            issue = 4 * gpu["sms"] * gpu["max_sm_clock_mhz"] * 1e3  # /ms
            for kind, n_rows in (("fwd", rows_f), ("bwd", rows_b)):
                per_call = philox.get(next(
                    (f for f in philox if f"{kind}_wgmma_kernelILi64ELb1E" in f),
                    ""))
                if per_call:
                    calls = bh * n_rows * cols / 4
                    row[f"{kind}_philox_calls"] = calls
                    row[f"{kind}_issue_ms"] = calls * per_call / 32 / issue
        rows.append(row)
        del leaves, o_lib
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = kernel_lib.build()
    out_dir = lib.parent / "flash_probe"
    out_dir.mkdir(exist_ok=True)
    gpu = card()
    variants = build_variants(out_dir)
    sass = sass_rows(str(lib))
    rows = [gpu] + sass + time_rows(variants, sass, gpu)
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
