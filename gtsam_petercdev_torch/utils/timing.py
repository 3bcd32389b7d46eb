"""Hierarchical scoped timers — the gttic/gttoc analog — and the port's
tracing: spans at its layer boundaries and counters of its work.

Port of gtsam_petercdev_tpu/utils/timing.py. Reference:
gtsam/base/timing.h:148,268-274 — nested TimingOutline tree with wall time,
call counts, min/max, printed by tictoc_print. `tic(label)` is a context
manager; the tree is global (like the reference) and `tictoc_print` /
`tictoc_reset` mirror the reference API.

Two kinds of span write to the one tree:

- `tic(label)`, always on. CUDA work is asynchronous, so a span that ends
  while the card still runs what it launched would time the enqueue: when
  CUDA has been initialized in the process, the end of every `tic`
  synchronizes the card before it reads the clock, so its wall time
  includes its device work. That serializes whatever it times.
- `span(label)`, the hot path's. Off by default, as GTSAM's timing without
  ENABLE_TIMING: then it returns one shared null context and reads no
  clock. On (`enable()`), it also records (label, parent span index, t0_ns,
  t1_ns) in a list that `spans()` returns and `tictoc_reset()` clears. It
  never synchronizes the card: its interval is what the host did, and the
  device's time comes from a profiler trace joined to it. Its clock is
  `time.time_ns()`, the Unix-epoch nanoseconds torch.profiler stamps host
  events in, so a span and the profiler's events share one time axis.

Counters (`count`, `counters`, `reset_counters`) are always on: an int add.
`host_read(t)` is `t.item()` counted under "host_reads": a device-to-host
scalar read drains the card's queue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class TimingOutline:
    label: str
    wall: float = 0.0
    n: int = 0
    t_min: float = float("inf")
    t_max: float = 0.0
    children: Dict[str, "TimingOutline"] = field(default_factory=dict)

    def add(self, dt: float):
        self.wall += dt
        self.n += 1
        self.t_min = min(self.t_min, dt)
        self.t_max = max(self.t_max, dt)

    def child(self, label: str) -> "TimingOutline":
        if label not in self.children:
            self.children[label] = TimingOutline(label)
        return self.children[label]

    def print(self, indent: int = 0, out=None):
        import sys

        out = out or sys.stdout
        if self.label != "_root_":
            avg = self.wall / max(self.n, 1)
            out.write(
                f"{'  ' * indent}{self.label}: {self.wall:.4f}s "
                f"({self.n} calls, avg {avg * 1e3:.3f}ms, "
                f"min {self.t_min * 1e3:.3f}ms, max {self.t_max * 1e3:.3f}ms)\n"
            )
            indent += 1
        for c in self.children.values():
            c.print(indent, out)


_root = TimingOutline("_root_")
_stack = [_root]
_enabled = False
_spans: List[list] = []  # [label, parent index (-1: none), t0_ns, t1_ns (0: open)]
_open: List[int] = []  # indices of the open spans, innermost last
_counters: Dict[str, int] = {}


@contextmanager
def tic(label: str):
    """Scoped timer: with tic("linearize"): ... (gttic/gttoc). It
    synchronizes the card at its end; use `span` on the hot path."""
    node = _stack[-1].child(label)
    _stack.append(node)
    t0 = time.perf_counter()
    try:
        yield node
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        node.add(time.perf_counter() - t0)
        _stack.pop()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("label", "node", "index")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.node = _stack[-1].child(self.label)
        _stack.append(self.node)
        self.index = len(_spans)
        _spans.append([self.label, _open[-1] if _open else -1, time.time_ns(), 0])
        _open.append(self.index)
        return None

    def __exit__(self, *exc):
        rec = _spans[self.index]
        rec[3] = time.time_ns()
        _open.pop()
        _stack.pop()
        self.node.add((rec[3] - rec[2]) * 1e-9)
        return False


def span(label: str):
    """with span("linearize"): ... — a host span of the port's hot path,
    recorded only while tracing is enabled; it never synchronizes."""
    return _Span(label) if _enabled else _NULL_SPAN


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def spans() -> List[Tuple[str, int, int, int]]:
    """The recorded spans in the order they opened: (label, index of the
    enclosing span or -1, start ns, end ns; 0 while open)."""
    return [tuple(s) for s in _spans]


def count(name: str, n: int = 1):
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters():
    _counters.clear()


def host_read(t):
    """t.item() (a Python number passes through), counted as "host_reads"."""
    count("host_reads")
    return t.item() if isinstance(t, torch.Tensor) else t


def tictoc_print(out=None):
    _root.print(out=out)


def tictoc_reset():
    global _root, _stack
    _root = TimingOutline("_root_")
    _stack = [_root]
    _spans.clear()
    _open.clear()


def tictoc_get(path: str) -> Optional[TimingOutline]:
    """Look up a node by slash path, e.g. "optimize/linearize"."""
    node = _root
    for part in path.split("/"):
        node = node.children.get(part)
        if node is None:
            return None
    return node
