"""DiscreteSearch: exact k-best assignments of a discrete factor graph.

Port of gtsam_petercdev_tpu/discrete/search.py. Reference:
gtsam/discrete/DiscreteSearch.{h,cpp} — best-first search over the
elimination order returning the K most-probable explanations. The heuristic
for a partial assignment is the product of each factor's maximum over its
unassigned variables (restricted to the assigned ones) — an admissible,
monotone bound, so the A* emission order is exactly the true descending
probability order and the first K complete assignments are the exact K best.

The search is host work over numpy tables: each factor's table is read off
the graph's device once per call.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gtsam_petercdev_torch.discrete.discrete import DiscreteFactorGraph


@dataclass
class SearchSolution:
    assignment: Dict[int, int]
    value: float  # unnormalized probability


def k_best(
    graph: DiscreteFactorGraph,
    K: int,
    ordering: Optional[Sequence[int]] = None,
    max_expansions: int = 1_000_000,
) -> List[SearchSolution]:
    """Return the exact K best assignments, best first (DiscreteSearch::run).

    Best-first over partial assignments in elimination order with the
    admissible per-factor max-completion bound; raises if the search
    frontier exceeds `max_expansions` node expansions (the reference's
    search is likewise exponential in the worst case).
    """
    keys = list(ordering) if ordering is not None else graph.all_keys()
    factors = [(f.keys, f.table.cpu().numpy()) for f in graph.factors]

    def bound(partial: Dict[int, int]) -> float:
        b = 1.0
        for fkeys, tab in factors:
            sub = tab[tuple(partial[k] if k in partial else slice(None) for k in fkeys)]
            b *= float(np.max(sub)) if getattr(sub, "ndim", 0) else float(sub)
        return b

    # heap of (-bound, tiebreak, depth, partial); depth == len(keys) is a
    # complete assignment whose bound IS its exact value
    counter = itertools.count()
    heap: List[Tuple[float, int, int, Dict[int, int]]] = [(-bound({}), next(counter), 0, {})]
    out: List[SearchSolution] = []
    expansions = 0
    while heap and len(out) < K:
        negb, _, depth, partial = heapq.heappop(heap)
        if depth == len(keys):
            out.append(SearchSolution(partial, -negb))
            continue
        expansions += 1
        if expansions > max_expansions:
            raise RuntimeError(f"DiscreteSearch exceeded {max_expansions} expansions")
        var = keys[depth]
        for v in range(graph.cards[var]):
            p2 = dict(partial)
            p2[var] = v
            heapq.heappush(heap, (-bound(p2), next(counter), depth + 1, p2))
    return out
