"""What bounds csrc/dropout.cu on the card.

Three readings, one JSON line each:

- ``sass``: the kernel's SASS (``cuobjdump -sass`` of the built library),
  for each dtype's instantiation and each loop of it, the instructions a
  dropped element by class.  A static count over every path of the loop
  body (the whole tensor's slot arithmetic and a window's; vector, pair
  and element accesses), so above what one slot runs.
- ``census``: the dropout launches one bench step of each family makes,
  by shape and dtype (scripts/bench.py's step at batch 1, bf16; the
  counts do not depend on the batch).
- ``times``: the kernel at the main path's shapes, on its plan's grid,
  on one wave of the card and on one slot a thread, and beside two
  variants built from its own source and launched on its plan: ``no_philox``,
  whose Philox4x32-10 call is replaced by a few integer operations on the
  counter (loads, keep test, scale and stores as they are), and
  ``no_load``, whose load is replaced by a value made from the slot's
  index (Philox, keep test, scale and stores as they are); beside them
  ``copy_`` and ``torch.mul`` of the same bytes, ``F.dropout`` and the
  byte bound.  Where ``no_philox`` reads ``copy_``'s time and the kernel
  more, the Philox rounds' instructions are what the kernel pays beyond
  moving its bytes.

    python -m tethys_tpu_torch.scripts.dropout_probe [--out FILE]

Needs a CUDA card, nvcc and cuobjdump (CUDA_HOME, default
/usr/local/cuda).  Times: CUDA events behind a device spin, median of 30.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from tethys_tpu_torch.ops import dropout
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import card_name_and_power

RATE = 0.1
SEED = 4321
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
W = dropout.Window
# (label, shape, window, dtype): the whole tensors of whisper-base b16's
# encoder and wav2vec2-base b32's FFN, a row and a column shard, and the
# attention probabilities' head and row windows at T = 99.
ROWS = (
    ("whole", (16, 1500, 512), W(), torch.bfloat16),
    ("whole", (16, 1500, 512), W(), torch.float32),
    ("whole", (32, 99, 3072), W(), torch.bfloat16),
    ("row shard", (16, 750, 512), W(row0=750, rows=1500), torch.bfloat16),
    ("column shard", (16, 1500, 256), W(col0=256, cols=512), torch.bfloat16),
    ("head window", (8, 6 * 99, 99), W(row0=6 * 99, rows=12 * 99),
     torch.bfloat16),
    ("row window", (8, 12, 49, 99), W(row0=50, rows=99), torch.bfloat16),
)
# Variants of csrc/dropout.cu: (text in the source, its replacement).
VARIANTS = {
    "no_philox": (
        "tethys::philox4x32_10(c0 + c, seed)",
        "make_uint4((uint32_t)(c0 + c) ^ seed, (uint32_t)(c0 + c) + seed, "
        "seed - (uint32_t)(c0 + c), ~(uint32_t)(c0 + c) ^ seed)"),
    "no_load": (
        "copy_slot<T, kVec>(x + s.x0, v, width, s.lo, s.hi);",
        "for (int e = 0; e < kVec; ++e) "
        "v[e] = tethys::from_f32<T>((float)(w + e));"),
}
SASS_CLASSES = {
    "int": ("IMAD", "IADD", "LOP", "SHF", "ISETP", "LEA", "SEL", "PRMT",
            "IABS", "IMNMX", "VIMNMX", "SGXT", "BMSK", "POPC", "FLO", "ULDC",
            "UMOV", "UIADD", "UIMAD", "ULOP", "USHF", "USEL"),
    "fp": ("FMUL", "FADD", "FFMA", "FSEL", "FSETP", "F2F", "F2FP", "I2F",
           "F2I", "HADD", "HMUL", "HFMA"),
    "mem": ("LDG", "STG", "LD.", "ST.", "LDS", "STS", "LDL", "STL", "LDC"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None,
                   help="also write the JSON lines to this file")
    return p.parse_args(argv)


def event_ms(fn, reps: int = 30) -> float:
    """Median device time of one call over reps, each queued behind a
    device spin so the events time the device's work."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _tool(name: str) -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        name)


def sass_functions(lib_path: str, key: str) -> dict:
    """{function: [(address, opcode)]} of every function of the library
    whose mangled name holds ``key``."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", lib_path],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    funcs, cur = {}, None
    inst = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            cur = funcs.setdefault(name, []) if key in name else None
            continue
        m = inst.search(line) if cur is not None else None
        if m:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_loops(code: list) -> list:
    """The instructions of each loop, largest first: the span from a
    backward branch's target to the branch."""
    loops = []
    for addr, op, args in code:
        target = re.match(r"\s*(0x[0-9a-f]+)", args)
        if op.startswith("BRA") and target and int(target.group(1),
                                                   16) <= addr:
            start = int(target.group(1), 16)
            loops.append([op for a, op, _ in code if start <= a <= addr])
    return sorted(loops, key=len, reverse=True)


def sass_rows(lib_path: str) -> list:
    """For each instantiation and each of its loops, instructions a dropped
    element by class; ``philox`` counts IMAD.WIDE.U32 and LOP3.LUT."""
    rows = []
    for name, code in sorted(sass_functions(lib_path,
                                            "dropout_kernel").items()):
        elems = dropout.VEC_BYTES // (2 if "bfloat16" in name else 4)
        for loop in sass_loops(code)[:3]:
            ops = collections.Counter(loop)
            classes = collections.Counter()
            for op, n in ops.items():
                kind = next((k for k, prefixes in SASS_CLASSES.items()
                             if op.startswith(prefixes)), "other")
                classes[kind] += n
            rows.append({
                "reading": "sass", "function": name,
                "instructions": len(code), "loop": len(loop),
                "elements_a_slot": elems,
                "per_element": len(loop) / elems,
                "integer_per_element": classes["int"] / elems,
                "philox_per_element": (ops["IMAD.WIDE.U32"]
                                       + ops["LOP3.LUT"]) / elems,
                "classes": dict(classes), "opcodes": dict(ops.most_common())})
    return rows


def census_rows() -> list:
    """The dropout launches of one bench step a family, by shape."""
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.scripts import bench

    launches = collections.Counter()
    launch = dropout._dropout

    def counted(x, rate, seed, window):
        launches[f"{list(x.shape)} {str(x.dtype)[6:]}"] += 1
        return launch(x, rate, seed, window)

    rows = []
    dropout._dropout = counted
    try:
        for family in ("whisper", "wav2vec2"):
            args = bench.parse_args(["--model", "base", "--batch_size", "1",
                                     "--family", family])
            job, batch = bench.build_family_step(args, family,
                                                 torch.device("cuda"))[:2]
            launches.clear()
            job.step_fn(job.state, batch, dp.step_generator(0, 0))
            torch.cuda.synchronize()
            rows.append({"reading": "census", "family": f"{family}-base",
                         "launches": sum(launches.values()),
                         "by_shape": dict(launches)})
            del job, batch
    finally:
        dropout._dropout = launch
    torch.cuda.empty_cache()
    return rows


def registers(ptxas_report: str) -> dict:
    """{instantiation: registers a thread} of dropout_kernel, from nvcc's
    -Xptxas=-v report."""
    return dict(re.findall(
        r"Function properties for \S*dropout_kernelI(\w+?)EEv\S*\n[^\n]*\n"
        r"[^\n]*Used (\d+) registers", ptxas_report))


def build_variants(out_dir) -> dict:
    """Each VARIANTS source built into its own library (nvcc with the
    port's flags, all at once): {name: (CDLL, registers report)}."""
    src = (kernel_lib.CSRC_DIR / "dropout.cu").read_text()
    procs = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               "csrc/dropout.cu once")
        cu = out_dir / f"dropout_{name}.cu"
        cu.write_text(src.replace(old, new))
        lib = out_dir / f"dropout_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_tool("nvcc"), *kernel_lib.NVCC_FLAGS, "-shared", "-I",
             str(kernel_lib.CSRC_DIR), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{report}")
        so = ctypes.CDLL(str(lib))
        so.tethys_dropout.argtypes = kernel_lib.DROPOUT.argtypes
        built[name] = (so, registers(report))
    return built


def launcher(so, x, y, launches, blocks=None):
    """A call of ``so``'s tethys_dropout on x into y over ``launches``, on
    each launch's grid or on ``blocks(launch)`` blocks."""
    elem = x.element_size()

    def run():
        for p in launches:
            err = so.tethys_dropout(
                x.data_ptr() + p.offset * elem, y.data_ptr() + p.offset * elem,
                p.numel, *p.segments, blocks(p) if blocks else p.blocks,
                int(p.vectors), SEED, dropout.dropout_threshold(RATE),
                dropout.dropout_scale(RATE), int(x.dtype == torch.bfloat16),
                kernel_lib.stream_handle(x))
            if err != 0:
                raise RuntimeError(f"tethys_dropout: CUDA error {err}")

    return run


def time_rows(variants: dict) -> list:
    """Each ROWS entry: the kernel through dropout_cuda, the library's
    kernel on one wave of the card and on one slot a thread (the two grids
    ops/dropout.plan chooses between), the variants on the plan's grid,
    copy_, torch.mul and F.dropout."""
    rows = []
    for label, shape, window, dtype in ROWS:
        x = torch.randn(shape, device="cuda").to(dtype)
        y = torch.empty_like(x)
        want = dropout.plain_dropout(x, RATE, SEED, window)
        if not torch.equal(dropout.dropout_cuda(x, RATE, SEED, window), want):
            raise AssertionError(f"{label} {list(shape)}: the kernel is not "
                                 "its plain version")
        row = {"reading": "times", "route": label, "shape": list(shape),
               "window": list(window), "dtype": str(dtype)[6:],
               "bound_ms": 2 * x.numel() * x.element_size()
               / HBM_BYTES_PER_S * 1e3,
               "kernel_ms": event_ms(lambda: dropout.dropout_cuda(
                   x, RATE, SEED, window))}
        launches = dropout.launch_plan(x, window, y)
        row["plan_blocks"] = [p.blocks for p in launches]
        wave = int(np.prod(dropout.occupancy(torch.cuda.current_device(),
                                             int(dtype == torch.bfloat16))))
        grids = {"one_wave": lambda p: min(wave, -(-p.slots
                                                  // dropout.THREADS)),
                 "one_slot_a_thread": lambda p: -(-p.slots
                                                  // dropout.THREADS)}
        for name, blocks in grids.items():
            run = launcher(kernel_lib.library(), x, y, launches, blocks)
            y.zero_()
            run()
            if not torch.equal(y, want):
                raise AssertionError(f"{label} {list(shape)} on {name}: not "
                                     "its plain version")
            row[f"{name}_ms"] = event_ms(run)
        for name, (so, _) in variants.items():
            row[f"{name}_ms"] = event_ms(launcher(so, x, y, launches))
        row["copy_ms"] = event_ms(lambda: y.copy_(x))
        row["mul_ms"] = event_ms(lambda: torch.mul(x, 1.1))
        row["F.dropout_ms"] = event_ms(lambda: F.dropout(x, RATE))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("dropout_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = kernel_lib.build()
    out_dir = lib.parent / "probe"
    out_dir.mkdir(exist_ok=True)
    variants = build_variants(out_dir)
    rows = [{"reading": "card", "gpu": card_name_and_power(),
             "variant_registers": {n: r for n, (_, r) in variants.items()},
             "registers": registers((lib.parent / "build.log").read_text())}]
    rows += sass_rows(str(lib))
    rows += time_rows(variants)
    rows += census_rows()
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
