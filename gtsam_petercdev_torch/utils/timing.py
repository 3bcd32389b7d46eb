"""Hierarchical scoped timers — the gttic/gttoc analog.

Port of gtsam_petercdev_tpu/utils/timing.py. Reference:
gtsam/base/timing.h:148,268-274 — nested TimingOutline tree with wall time,
call counts, min/max, printed by tictoc_print. `tic(label)` is a context
manager; the tree is global (like the reference) and `tictoc_print` /
`tictoc_reset` mirror the reference API.

CUDA work is asynchronous, so a span that ends while the card still runs
what it launched would time the enqueue: when CUDA has been initialized in
the process, the end of every span synchronizes the card before it reads
the clock, so a span's wall time includes its device work.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

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


@contextmanager
def tic(label: str):
    """Scoped timer: with tic("linearize"): ... (gttic/gttoc)."""
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


def tictoc_print(out=None):
    _root.print(out=out)


def tictoc_reset():
    global _root, _stack
    _root = TimingOutline("_root_")
    _stack = [_root]


def tictoc_get(path: str) -> Optional[TimingOutline]:
    """Look up a node by slash path, e.g. "optimize/linearize"."""
    node = _root
    for part in path.split("/"):
        node = node.children.get(part)
        if node is None:
            return None
    return node
