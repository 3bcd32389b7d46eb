"""One run of one cell: set-up, the measured window (or the traced one),
the port's state freed, then the comparison with the plain reference.

`run(cell, seed, seconds, trace, device, t_start)` returns the result line
as a dict (its last key, `compared`, holds each compared number beside its
limit). It does not look for a chip: `run.py` does that first, and the
tests drive this on the CPU at small sizes."""

from __future__ import annotations

import cProfile
import os
import pstats
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from sam_bench import spec
from sam_bench import trace as tracing


@dataclass
class Context:
    torch: Any
    device: Any
    cell: spec.Cell
    seed: int
    problem: Any = None  # the generator's inputs
    reference: Any = None  # the reference's problem module
    # the port's objects (freed by the runner's release)
    graph: Any = None
    start: Any = None
    params: Any = None
    index: Dict = field(default_factory=dict)
    type_keys: Dict = field(default_factory=dict)
    # what the window or the traced run produced
    histories: List[List[float]] = field(default_factory=list)
    states: List[Any] = field(default_factory=list)
    trace: Optional[tracing.Trace] = None
    setup_stats: Optional[pstats.Stats] = None
    failed: int = 0

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.on_cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.on_cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.on_cuda else 0

    def empty_cache(self):
        if self.on_cuda:
            self.torch.cuda.empty_cache()


def power_limit_w(index: int) -> Optional[float]:
    """The card's power limit from nvidia-smi (a roofline share is against
    the 700 W peaks), None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(index)], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def build_kernels() -> tuple:
    """Build the port's CUDA kernel and host libraries that are not built
    yet, as a checkout's first run does: (whether any was missing, seconds).
    The time is part of set-up; the result line reports it apart too."""
    from gtsam_petercdev_torch.ops import build, build_host

    missing = [n for mod in (build, build_host) for n in mod.SOURCES
               if not os.path.exists(mod.library_path(n))]
    t0 = time.perf_counter()
    build.build_all()
    build_host.build_all()
    return bool(missing), time.perf_counter() - t0


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None) -> dict:
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    runner = spec.module("runners", cell.traffic["runner"])
    ctx = Context(torch, dev, cell, seed)
    ctx.problem = spec.module("generators", cell.config["generator"]).make(cell.config, seed)
    ctx.reference = spec.module("reference", cell.config["reference"])
    built, build_s = build_kernels() if ctx.on_cuda else (False, 0.0)

    if trace:  # the traced run's set-up under cProfile, for the host-side readers
        prof = cProfile.Profile()
        prof.enable()
        try:
            runner.setup(ctx)
        finally:
            prof.disable()
        ctx.setup_stats = pstats.Stats(prof)
    else:
        runner.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    first_peak = ctx.peak_bytes()

    metrics: Dict[str, dict] = {}
    if trace:
        attempted = runner.traced(ctx)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = runner.window(ctx, seconds)
        attempted = e2e["_solves"]
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    memory_peak = max(first_peak, ctx.peak_bytes())
    t_window = time.perf_counter()
    runner.release(ctx)

    numbers = runner.check(ctx)
    t_check = time.perf_counter()
    print(f"sam_bench: {cell.name} seed {seed}: set-up {setup_s:.3f} s "
          f"({'with' if built else 'no'} kernel build, {build_s:.3f} s), "
          f"{'traced' if trace else 'measured'} window and readers "
          f"{t_window - t_start - setup_s:.3f} s, reference and comparison "
          f"{t_check - t_window:.3f} s", file=sys.stderr)
    compared = {k: {"value": v, "limit": float(cell.limits[k])} for k, v in numbers.items()}
    correct = ctx.failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    device_info = {"platform": "gpu" if ctx.on_cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if ctx.on_cuda else "cpu",
                   "count": cell.chips if ctx.on_cuda else 0,
                   "memory_peak_bytes": int(memory_peak)}
    if trace:
        tr = ctx.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
    if ctx.on_cuda:
        device_info["power_limit_w"] = power_limit_w(dev.index or 0)
    out = dict(correct=bool(correct), attempted=int(attempted), failed=int(ctx.failed),
               metrics=metrics, device=device_info)
    if trace:
        out["breakdown"] = tracing.breakdown(ctx.trace)
    out["kernel_build"] = {"built": built, "seconds": build_s}
    out["compared"] = compared
    return out
