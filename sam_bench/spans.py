"""The port's own spans and counters (`gtsam_petercdev_torch/utils/timing.py`),
read in one more whole solve of the cell's graph with the port's tracing on,
under torch.profiler (CPU and CUDA), memoised on the run's context.

The join, on the profiler's clock (the port stamps its spans in the
Unix-epoch nanoseconds torch.profiler stamps host events in):

- a device operation (kernel, copy, memset) is joined to the runtime call
  that launched it by CUPTI correlation id (kineto's `correlation_id()` on
  both: on the H100 it joined every operation, the port's K1-K4 launched
  through ctypes too; `linked_correlation_id()` joined none), and
  attributed to the innermost span open at that call's host start;
- an idle stretch of the device (no operation running) is attributed to the
  innermost span open when the device ran dry, as `trace.py` labels it
  with the host op open then.

Every metric is per LM iteration (the port's `lm.iterations` counter), so
the layers add up against iter_ms. Against a port without the tracing
(no `timing.enable`), or where the profile holds no device operation, the
readers return None."""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from sam_bench import roofline

OUTSIDE = "(no span)"  # device work or idle time outside every span
NOT_JOINED = "(not joined)"  # device work whose launching call was not found
LM_SELF = ("lm.iteration", "lm.trial")  # LM's own code: its reads, retract, error


@dataclass
class Joined:
    counters: Dict[str, int] = field(default_factory=dict)
    labels: set = field(default_factory=set)  # span labels the solve recorded
    # seconds by innermost span label, then by device operation name
    device_s: Dict[str, Dict[str, float]] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)  # by innermost span label
    under_lm_s: float = 0.0  # device seconds joined to a span inside an lm.iteration
    busy_s: float = 0.0  # union of the device operations' intervals
    window_s: float = 0.0  # first to last event of the profile
    edge_idle_s: Tuple[float, float] = (0.0, 0.0)  # idle before the first, after the last op

    @property
    def iterations(self) -> int:
        return self.counters.get("lm.iterations", 0)

    def device_total_s(self) -> float:
        return sum(s for ops in self.device_s.values() for s in ops.values())


class SpanIndex:
    """The innermost span open at a time: the last span started at or
    before it, or the nearest of its enclosing spans still open then."""

    def __init__(self, spans: List[Tuple[str, int, int, int]]):
        self.spans = spans
        self.order = sorted(range(len(spans)), key=lambda i: (spans[i][2], i))
        self.starts = [spans[i][2] for i in self.order]
        self.under_lm = []
        for label, parent, _, _ in spans:  # a parent precedes its children
            self.under_lm.append(label == "lm.iteration"
                                 or (parent >= 0 and self.under_lm[parent]))

    def at(self, t: int) -> int:
        p = bisect.bisect_right(self.starts, t) - 1
        i = self.order[p] if p >= 0 else -1
        while i >= 0:
            _, parent, _, end = self.spans[i]
            if end == 0 or end > t:
                return i
            i = parent
        return -1

    def label(self, i: int) -> str:
        return self.spans[i][0] if i >= 0 else OUTSIDE


def _is_runtime_call(name: str) -> bool:
    """A CUDA API call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), not an operator."""
    return name.startswith("cu") and "::" not in name


def events(prof):
    """(host runtime calls [(name, start_ns, correlation id)], device
    operations [(name, start_ns, end_ns, correlation id)], first and last ns
    of the profile) of a finished torch.profiler profile."""
    from torch.autograd import DeviceType

    host, dev = [], []
    t0, t1 = None, None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        t0 = start if t0 is None else min(t0, start)
        t1 = end if t1 is None else max(t1, end)
        if e.device_type() == DeviceType.CPU:
            if _is_runtime_call(e.name()):
                host.append((e.name(), start, e.correlation_id()))
        else:
            dev.append((e.name(), start, end, e.correlation_id()))
    return host, dev, t0 or 0, t1 or 0


def join(spans, host, dev, t0: int, t1: int, counters=None) -> Joined:
    """Attribute each device operation and each idle stretch to a span."""
    idx = SpanIndex(spans)
    out = Joined(counters=dict(counters or {}), labels={s[0] for s in spans},
                 window_s=(t1 - t0) * 1e-9)
    launch = {corr: start for _, start, corr in host}
    device_s = defaultdict(lambda: defaultdict(float))
    for name, s, e, corr in dev:
        if corr not in launch:
            device_s[NOT_JOINED][name] += (e - s) * 1e-9
            continue
        i = idx.at(launch[corr])
        device_s[idx.label(i)][name] += (e - s) * 1e-9
        if i >= 0 and idx.under_lm[i]:
            out.under_lm_s += (e - s) * 1e-9
    out.device_s = {k: dict(v) for k, v in device_s.items()}
    busy = []
    for s, e in sorted((s, e) for _, s, e, _ in dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    out.busy_s = sum(e - s for s, e in busy) * 1e-9
    idle = defaultdict(float)
    if busy:
        gaps = [(t0, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])] \
            + [(busy[-1][1], t1)]
        for s, e in gaps:
            if e > s:
                idle[idx.label(idx.at(s))] += (e - s) * 1e-9
        out.edge_idle_s = (max(0, busy[0][0] - t0) * 1e-9, max(0, t1 - busy[-1][1]) * 1e-9)
    out.idle_s = dict(idle)
    return out


def record(ctx) -> Optional[Joined]:
    """The joined spans of one more whole solve, memoised on the context;
    None against a port without `timing.enable`, or without a graph."""
    if "_port_spans" in ctx.__dict__:
        return ctx.__dict__["_port_spans"]
    ctx.__dict__["_port_spans"] = None
    from gtsam_petercdev_torch.utils import timing

    if ctx.graph is None or not hasattr(timing, "enable"):
        return None
    from torch.profiler import ProfilerActivity, profile

    from sam_bench import spec

    runner = spec.module("runners", ctx.cell.traffic["runner"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.on_cuda else [])
    ctx.sync()
    timing.tictoc_reset()
    timing.reset_counters()
    timing.enable()
    try:
        with profile(activities=acts) as prof:
            runner._solve(ctx)
    finally:
        timing.disable()
    spans, counters = timing.spans(), timing.counters()
    timing.tictoc_reset()
    host, dev, t0, t1 = events(prof)
    del prof
    out = join(spans, host, dev, t0, t1, counters)
    ctx.__dict__["_port_spans"] = out
    total = out.device_total_s()
    print(f"sam_bench: spans: {len(spans)} spans, counters {counters}; {len(dev)} device "
          f"ops, {total:.6f} s (busy {out.busy_s:.6f} s of "
          f"{out.window_s:.6f} s; idle before the first op {out.edge_idle_s[0]:.6f} s, after "
          f"the last {out.edge_idle_s[1]:.6f} s), under lm.iteration {out.under_lm_s:.6f} s, "
          f"not joined {sum(out.device_s.get(NOT_JOINED, {}).values()):.6f} s", file=sys.stderr)
    return out


def _per_iter(ctx, counter: str) -> Optional[float]:
    rec = record(ctx)
    if rec is None or rec.iterations == 0:
        return None
    return rec.counters.get(counter, 0) / rec.iterations


def _ms_per_iter(ctx, label: str, idle: bool, keep=lambda name: True) -> Optional[float]:
    rec = record(ctx)
    if rec is None or rec.iterations == 0 or rec.busy_s <= 0:
        return None
    labels = LM_SELF if label == "lm" else (label,)
    if not any(lb in rec.labels for lb in labels):
        return None
    if idle:
        s = sum(rec.idle_s.get(lb, 0.0) for lb in labels)
    else:
        s = sum(t for lb in labels for name, t in rec.device_s.get(lb, {}).items() if keep(name))
    return s * 1e3 / rec.iterations


def lm_trials_per_iter(ctx):
    """LM's damped trials (solves, rejected ones included) an iteration."""
    return _per_iter(ctx, "lm.trials")


def bad_pivot_trials_per_iter(ctx):
    """Trials rejected for clamped pivots an iteration."""
    return _per_iter(ctx, "lm.bad_pivot_trials")


def host_reads_per_iter(ctx):
    """LM's device-to-host scalar reads (the error, the pivot count, the
    linearized decrease) an iteration."""
    return _per_iter(ctx, "host_reads")


def device_ms_linearize(ctx):
    return _ms_per_iter(ctx, "linearize", idle=False)


def idle_ms_linearize(ctx):
    return _ms_per_iter(ctx, "linearize", idle=True)


def idle_ms_lm(ctx):
    """Idle time under LM's own code (the self time of lm.iteration and
    lm.trial: its reads, the retract, the error)."""
    return _ms_per_iter(ctx, "lm", idle=True)


def device_ms_multifrontal_glue(ctx):
    """Device time under the multifrontal span other than K1-K4's."""
    return _ms_per_iter(ctx, "multifrontal", idle=False,
                        keep=lambda name: not roofline.is_bucket_kernel(name))


def idle_ms_multifrontal(ctx):
    return _ms_per_iter(ctx, "multifrontal", idle=True)


def device_ms_schur(ctx):
    return _ms_per_iter(ctx, "schur", idle=False)


def idle_ms_schur(ctx):
    return _ms_per_iter(ctx, "schur", idle=True)
