"""One run of one cell: set-up, the measured window, the trace, the check.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``);
its limits for ``correct`` are ``limits/<cell>.json``, and each per-layer
metric is read by ``metrics/<metric>.py``.  Nothing here knows a cell by
name.

Set-up (``setup_s``, from the start of the process to the first timed
dispatch): the program's job is built as its training CLIs build it, the
benchmark's weights (drawn on the device from the seed) are loaded into
it, the traffic's pool of batches is drawn, and the job is driven through
the program's own loop (``train/loop.run_training``) for the warm-up
steps, on the cell's shapes.  The first three warm-up steps are the ones
the reference follows: the program's Adam state after the first and its
weights after the third are kept (moved to the host before the window).

The window: one more call of the loop, closed-loop and pipelined one step
deep as the loop runs, for as many steps as fill ``--seconds`` at the
warm-up's pace.  A hook of the loop stamps the benchmark's clock as each
step completes (its loss fetched).  With ``--trace 1`` the window is two
calls of ``trace_steps`` steps each: the first, plain, for the host spans
and the step time; the second under ``torch.profiler``.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from tethys_bench import compare, families, traffic as traffic_lib
from tethys_bench import trace as trace_lib
from tethys_bench import weights as weights_lib
from tethys_bench.reference import common as ref_common

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tethys_tpu")
GIB = 2 ** 30


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, benchmark: Optional[dict] = None):
        bench = benchmark or _json(ROOT / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(ROOT / configs[self.workload["config"]]["file"])
        self.traffic = _json(BENCH_DIR / "traffic"
                             / f"{self.workload['traffic']}.json")
        limits = BENCH_DIR / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @classmethod
    def of(cls, name: str, config: dict, traffic: dict, limits: dict,
           end_to_end=(), per_layer=()) -> "Cell":
        """A cell from its parts (the tests' tiny cells)."""
        cell = cls.__new__(cls)
        cell.workload = {"name": name, "chips": 1}
        cell.name, cell.chips = name, 1
        cell.config, cell.traffic, cell.limits = config, traffic, limits
        cell.end_to_end, cell.per_layer = list(end_to_end), list(per_layer)
        return cell


class Spans:
    """Host seconds spent inside each wrapped call, while ``on``."""

    def __init__(self):
        self.on = False
        self.seconds: Dict[str, float] = {}

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args):
            if not self.on:
                return fn(*args)
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
        return wrapped


class Clock:
    """The loop's step hook: the benchmark's clock at each completion."""

    def __init__(self):
        self.stamps: List[float] = []
        self.losses: Dict[int, float] = {}

    def hook(self, step, loss, duration, aux):
        self.stamps.append(time.perf_counter())
        self.losses[step] = loss


class CardSampler:
    """``nvidia-smi`` sampling the card's SM clock, power and temperature
    every second beside the window (one process, ended with it)."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", "-lms", "1000", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {}
        cols = list(zip(*rows))
        return {name: [min(c), statistics.median(c), max(c)]
                for name, c in zip(("sm_mhz", "power_w", "temp_c"), cols)}


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def check_config(job_config, config: dict) -> None:
    """The job's configuration holds every value the file states."""
    import dataclasses

    have = dataclasses.asdict(job_config)
    for key, want in config.items():
        if key in have:
            got = have[key]
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                raise ValueError(f"the program runs {key}={got!r}, the "
                                 f"configuration states {want!r}")


class Program:
    """The program's job with the benchmark's weights, its wrapped entry
    points, and what the first three steps left for the check."""

    def __init__(self, cell: Cell, seed: int, device, spans: Spans,
                 fault: Optional[str] = None):
        self.cell, self.device, self.fault = cell, device, fault
        self.family = families.get(cell.config["family"])
        self.job = self.family.build_job(cell.config, cell.traffic, device)
        check_config(self.job.config, cell.config)
        self.load_weights(seed)
        self.spans = spans
        self.calls = 0
        self.first_m: Dict[str, torch.Tensor] = {}
        self.third_params: Dict[str, torch.Tensor] = {}
        self.step_fn = spans.wrap("step_fn", self._step)
        self.prepare = spans.wrap("prepare_batch", self._prepare)
        if fault == "unchanged":
            self.job.state.optimizer.step = lambda closure=None: None

    def load_weights(self, seed: int) -> None:
        drawn = weights_lib.draw(self.family.reference.param_spec(
            self.cell.config), seed, self.device)
        self.job.state.model.load_state_dict(drawn, strict=True)
        del drawn
        self.job.state.optimizer.state.clear()
        self.calls = 0

    def _prepare(self, batch):
        if self.fault == "half":
            batch = tuple(a[:a.shape[0] // 2] for a in batch)
        return self.job.prepare_batch(batch)

    def _step(self, state, batch, generator):
        out = self.job.step_fn(state, batch, generator)
        if self.calls == 0:
            opt = state.optimizer
            self.first_m = {n: opt.state[p]["m"].detach().clone()
                            for n, p in state.model.named_parameters()
                            if "m" in opt.state[p]}
        elif self.calls == 2:
            self.third_params = {n: p.detach().clone() for n, p in
                                 state.model.named_parameters()}
        self.calls += 1
        return out

    def run(self, pool, start: int, steps: int, seed: int, clock: Clock):
        from tethys_tpu_torch.train.loop import run_training

        return run_training(
            self.step_fn, traffic_lib.Feed(pool, start), self.job.state,
            seed, max_iterations=steps, prepare_batch=self.prepare,
            resilient=self.family.RESILIENT, step_hooks=(clock.hook,))

    def evidence(self, losses: Dict[int, float]) -> dict:
        """What the first three steps left, on the host."""
        b1 = self.cell.config["optimizer"]["b1"]
        return {
            "losses": [losses.get(i, float("nan")) for i in range(3)],
            "grads": {n: (m.float() / (1.0 - b1)).cpu()
                      for n, m in self.first_m.items()},
            "params": {n: p.float().cpu()
                       for n, p in self.third_params.items()},
        }

    def close(self) -> None:
        del self.job
        self.first_m, self.third_params = {}, {}
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference_steps(cell: Cell, seed: int, pool, device,
                    prec: ref_common.Precision = ref_common.FLOAT32,
                    rows: int = 0) -> dict:
    """The plain reference's first three steps from the benchmark's
    weights: each step's loss, the first gradient as Adam took it, and the
    weights after the third step.  ``rows``: only the first rows of each
    batch, as their own batch (a fault)."""
    family = families.get(cell.config["family"])
    config, opt = cell.config, cell.config["optimizer"]
    ref_common.f32_matmuls()
    params = weights_lib.draw(family.reference.param_spec(config), seed,
                              device)
    adam = ref_common.KerasAdam(opt["lr"], opt["eps"], opt["b1"], opt["b2"],
                                opt.get("clipnorm"))
    losses, first = [], None
    for step in range(3):
        batch = tuple(torch.from_numpy(a).to(device) for a in pool[step])
        loss, grads = family.reference.loss_and_grads(
            params, batch, ref_common.step_generator(seed, step), config,
            prec, cell.traffic["reference_rows"], rows)
        if opt.get("global_clip"):
            ref_common.clip_by_global_norm(list(grads.values()),
                                           opt["global_clip"])
        adam.step(params, grads)                 # clips grads in place
        if first is None:
            first = {n: g.detach().cpu() for n, g in grads.items()}
        losses.append(loss)
        del grads
    return {"losses": losses, "grads": first,
            "params": {n: p.cpu() for n, p in params.items()}}


def deltas(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor],
           names) -> Dict[str, torch.Tensor]:
    return {n: after[n] - before[n] for n in names}


def check(cell: Cell, seed: int, prog: dict, ref: dict, device) -> dict:
    """The readings of the program's evidence against the reference's."""
    family = families.get(cell.config["family"])
    start = {n: t.cpu() for n, t in weights_lib.draw(
        family.reference.param_spec(cell.config), seed, device).items()}
    moved = set(ref["grads"])
    return compare.readings(
        prog["losses"], ref["losses"], prog["grads"], ref["grads"],
        deltas(prog["params"], start, moved & set(prog["params"])),
        deltas(ref["params"], start, moved))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, fault: Optional[str] = None,
             log=print) -> dict:
    """One run; returns the result line (a dict) without printing it."""
    traffic, config = cell.traffic, cell.config
    on_card = torch.device(device).type == "cuda"
    spans = Spans()
    program = Program(cell, seed, device, spans, fault)
    pool = traffic_lib.pool(traffic, config, seed)
    warm = Clock()
    program.run(pool, 0, traffic["warmup_steps"], seed, warm)
    evidence = program.evidence(warm.losses)
    gaps = [b - a for a, b in zip(warm.stamps, warm.stamps[1:])]
    pace = statistics.median(gaps[len(gaps) // 2:]) if gaps else 1.0
    if traced:
        steps = traffic["trace_steps"]
    else:
        steps = max(traffic["min_steps"], math.ceil(seconds / pace))
    log(f"warm-up: {len(warm.stamps)} steps, pace {pace * 1e3:.3f} ms; "
        f"window: {steps} steps", file=sys.stderr)

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sampler = CardSampler() if on_card and not traced else None
    clock = Clock()
    spans.on = True
    calls_before = program.calls
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    program.run(pool, traffic["warmup_steps"], steps, seed, clock)
    if on_card:
        torch.cuda.synchronize()
    spans.on = False
    attempted = program.calls - calls_before
    window_s = (clock.stamps[-1] if clock.stamps else time.perf_counter()) \
        - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    card = sampler.stop() if sampler else {}

    metrics, device_info, breakdown = {}, {}, None
    if traced:
        reading = None
        if on_card:
            reading = _traced_window(program, pool, steps, seed)
        context = Context(cell, steps, window_s, spans.seconds, reading,
                          program.family)
        for metric in cell.per_layer:
            value = context.metric(metric["name"])
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        if reading is not None:
            device_info = {"busy_s": reading.busy_s,
                           "window_s": reading.window_s}
            breakdown = {"device_ops": reading.device_ops,
                         "idle_gaps": reading.idle_gaps}
    else:
        intervals = sorted(b - a for a, b in zip(clock.stamps,
                                                 clock.stamps[1:]))
        audio = traffic_lib.audio_seconds(traffic)
        log(f"window: {len(clock.stamps)} steps completed of {attempted} "
            f"in {window_s:.4f} s; {len(intervals)} step intervals",
            file=sys.stderr)
        log("step intervals ms, in order: " + json.dumps(
            [round((b - a) * 1e3, 3) for a, b in zip(clock.stamps,
                                                     clock.stamps[1:])]),
            file=sys.stderr)
        if card:
            log(f"card during the window (min, median, max): "
                f"{json.dumps(card)}", file=sys.stderr)
        values = {
            "train_audio_s_per_s": len(clock.stamps) * audio / window_s,
            "train_step_ms_p90": (statistics.quantiles(
                intervals, n=10)[-1] * 1e3 if len(intervals) >= 2
                else float("nan")),
            "train_peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": metric["unit"]}

    program.close()
    del pool[3:]
    ref = reference_steps(cell, seed, pool, device)
    reading = check(cell, seed, evidence, ref, device)
    if any(v != v for v in evidence["losses"]):
        reading = {"leaves": ["a first step failed"]}
    verdict = compare.judge(reading, cell.limits)
    log("readings: " + json.dumps(reading), file=sys.stderr)
    result = {
        "correct": verdict["correct"],
        "attempted": attempted,
        "failed": attempted - len(clock.stamps),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak, **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in verdict["numbers"].items()}
    return result


def _traced_window(program: Program, pool, steps: int, seed: int):
    """``steps`` more steps under ``torch.profiler`` (CPU and CUDA)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    start = program.cell.traffic["warmup_steps"] + steps
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(trace_lib.WINDOW):
            program.run(pool, start, steps, seed, Clock())
            torch.cuda.synchronize()
    return trace_lib.read(prof)


class Context:
    """What a per-layer metric's reader may read: the cell, the plain
    window's steps, wall seconds and host spans, and the traced window's
    device reading (None where nothing was traced)."""

    def __init__(self, cell: Cell, steps: int, wall_s: float,
                 spans: Dict[str, float], reading, family):
        self.cell, self.steps, self.wall_s = cell, steps, wall_s
        self.spans, self.reading, self.family = spans, reading, family

    def step_flops(self) -> float:
        return self.family.step_flops(self.cell.config, self.cell.traffic)

    def kernel_work(self, kernel: str):
        return self.family.kernel_work(self.cell.config,
                                       self.cell.traffic).get(kernel)

    def metric(self, name: str) -> Optional[float]:
        import importlib.util

        path = BENCH_DIR / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"tethys_bench.metrics.{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read(self)
