"""torch.profiler over whole solves, reduced to what the per-layer metrics
and the result line read: device intervals, kernel launches, kernel time by
name, and what the host was doing while the device sat idle."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Trace:
    window_s: float = 0.0  # first to last event of the profiled stretch
    busy_s: float = 0.0  # union of the device's operation intervals
    kernels: int = 0  # CUDA kernel launches (copies and fills left out)
    device_ops: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # s, count
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # s by host op
    iterations: int = 0  # LM iterations of the profiled solve
    bucket_launches: Dict[str, int] = field(default_factory=dict)  # the port's counters

    def kernel_seconds(self, match) -> float:
        return sum(s for name, (s, _) in self.device_ops.items() if match(name))


def _raw(prof):
    """[(is_device, name, start_ns, end_ns)] of a finished profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.device_type() != DeviceType.CPU, e.name(), start, start + e.duration_ns()))
    return out


def _union(intervals: List[Tuple[int, int]]):
    """Merged [start, end) intervals of sorted input."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_label(host, starts, t) -> str:
    """The innermost host op running at t, runtime calls (cuda*) last."""
    i = bisect.bisect_right(starts, t) - 1
    best = best_runtime = None
    for j in range(i, max(i - 64, -1), -1):
        _, name, s, e = host[j]
        if e >= t:
            if not name.startswith("cuda"):
                best = name
                break
            best_runtime = best_runtime or name
    return best or best_runtime or "(host between ops)"


def reduce(prof) -> Trace:
    ev = _raw(prof)
    if not ev:
        return Trace()
    dev = sorted((s, e, n) for is_dev, n, s, e in ev if is_dev)
    host = sorted((ev_ for ev_ in ev if not ev_[0]), key=lambda x: x[2])
    t0 = min(x[2] for x in ev)
    t1 = max(x[3] for x in ev)
    tr = Trace(window_s=(t1 - t0) * 1e-9)
    if not dev:
        return tr
    ops = defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        ops[n][0] += (e - s) * 1e-9
        ops[n][1] += 1
    tr.device_ops = {n: (v[0], v[1]) for n, v in ops.items()}
    tr.kernels = sum(c for n, (_, c) in tr.device_ops.items() if not n.startswith(_NOT_KERNELS))
    busy = _union([(s, e) for s, e, _ in dev])
    tr.busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle stretches: before the first device op, between ops, after the last
    gaps = [(t0, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])] \
        + [(busy[-1][1], t1)]
    starts = [h[2] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        if e > s:
            idle[_host_label(host, starts, s)] += (e - s) * 1e-9
    tr.idle_by_host = dict(idle)
    return tr


def profiled(fn, ctx, reps: int = 2):
    """fn() `reps` times, each under its own torch.profiler (CPU and CUDA);
    returns (outputs, the Trace and port counters of the run with the most
    kernel launches — the profiler can drop a share of a long run's events)."""
    from torch.profiler import ProfilerActivity, profile

    from gtsam_petercdev_torch.ops import cholesky

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.on_cuda else [])
    outs, best = [], None
    for _ in range(reps):
        cholesky.reset_launch_counts()
        with profile(activities=acts) as p:
            out = fn()
            ctx.sync()
        outs.append(out)
        tr = reduce(p)
        tr.bucket_launches = cholesky.launch_counts()
        del p
        if best is None or tr.kernels > best[0].kernels:
            best = (tr, out)
    return outs, best


def breakdown(tr: Trace, top: int = 10) -> dict:
    ops = sorted(((n[:160], s) for n, (s, _) in tr.device_ops.items()), key=lambda r: -r[1])
    gaps = sorted(((n[:160], s) for n, s in tr.idle_by_host.items()), key=lambda r: -r[1])
    return {"device_ops": [list(r) for r in ops[:top]],
            "idle_gaps": [list(r) for r in gaps[:top]]}
