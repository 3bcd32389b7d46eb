"""Concurrent filtering and smoothing — the reference's two-solver design.

Port of gtsam_petercdev_tpu/nonlinear/concurrent.py. Reference:
gtsam_unstable/nonlinear/ConcurrentFilteringAndSmoothing.{h,cpp} (the
synchronize() protocol), ConcurrentBatchFilter.{h,cpp},
ConcurrentBatchSmoother.{h,cpp}, ConcurrentIncrementalFilter.h:30 and
ConcurrentIncrementalSmoother.h:

  * The FILTER owns the recent sliding window and runs at sensor rate.
  * The SMOOTHER owns the full history and refines in the background.
  * synchronize() exchanges information through the SEPARATOR (the boundary
    variables): the filter hands over out-of-lag states and the factors on
    them, with a summarized (marginal) factor of its remaining information
    on the separator; the smoother returns its own marginal on the
    separator, which the filter holds as a prior.

Each side summarizes ONLY its own factors, never the summarization it got
from the other side, so nothing is counted twice (ConcurrentBatchFilter.cpp
marginalize / ConcurrentBatchSmoother.cpp presync). The incremental pair
runs each half as an ISAM2 and does the same exchange by tree surgery:
factor removal and marginalize_leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.fixed_lag import _add_rows, _expired, marginalize_keys
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_petercdev_torch.nonlinear.values import Values


def _merge_graphs(device, *graphs: Optional[NonlinearFactorGraph]) -> NonlinearFactorGraph:
    out = NonlinearFactorGraph(device=device)
    for g in graphs:
        if g is not None:
            g._materialize()
            out.batches.extend(g.batches)
    return out


def _summarize_onto(graph: NonlinearFactorGraph, values: Values,
                    separator: Sequence[int]) -> NonlinearFactorGraph:
    """Marginal of `graph` onto the separator keys as a container-factor
    graph (the reference's summarization by marginal factors)."""
    graph._materialize()
    sep = set(int(k) for k in separator)
    all_keys = set()
    for b in graph.batches:
        all_keys.update(int(k) for k in b.keys.reshape(-1))
    drop = sorted(all_keys - sep)
    if not drop:
        return _merge_graphs(graph.device, graph)
    return marginalize_keys(graph, values, drop, device=graph.device)[0]


def _split(graph: NonlinearFactorGraph, old: Set[int]):
    """Per batch of `graph`: (batch, rows touching an old key, the others)."""
    graph._materialize()
    for b in graph.batches:
        touches = np.array([any(int(k) in old for k in row) for row in b.keys], dtype=bool)
        yield b, np.where(touches)[0], np.where(~touches)[0]


def _new_separator_keys(b, rows, old: Set[int], seen: Set[int], separator: List[int]) -> None:
    """Append the keys of rows of b that are not old, in order, once."""
    for r in rows:
        for k in b.keys[r]:
            k = int(k)
            if k not in old and k not in seen:
                seen.add(k)
                separator.append(k)


class ConcurrentBatchSmoother:
    """Full-history smoother half (ConcurrentBatchSmoother.h:40) on `device`."""

    def __init__(self, lm_params: Optional[optimizers.LMParams] = None,
                 *, device: DeviceLike = "cuda"):
        self.lm_params = lm_params or optimizers.LMParams(max_iterations=20)
        self.graph = NonlinearFactorGraph(device=device)
        self.device = self.graph.device
        self.values = Values(device=self.device)
        self.filter_summarization: Optional[NonlinearFactorGraph] = None
        self.separator: List[int] = []

    def update(self) -> optimizers.OptimizerResult:
        """Optimize the history and the filter's summarized prior
        (ConcurrentBatchSmoother::update)."""
        full = _merge_graphs(self.device, self.graph, self.filter_summarization)
        if not full.batches or len(self.values) == 0:
            return optimizers.OptimizerResult(self.values, 0.0, 0, True)
        res = optimizers.levenberg_marquardt(full, self.values, self.lm_params, device=self.device)
        self.values = res.values
        return res

    def summarize(self) -> NonlinearFactorGraph:
        """Marginal of the smoother's OWN factors on the separator
        (getSmootherSummarizedFactors)."""
        if not self.separator:
            return NonlinearFactorGraph(device=self.device)
        return _summarize_onto(self.graph, self.values, self.separator)


class ConcurrentBatchFilter:
    """Sensor-rate filter half (ConcurrentBatchFilter.h:44) on `device`."""

    def __init__(self, lag: float, lm_params: Optional[optimizers.LMParams] = None,
                 *, device: DeviceLike = "cuda"):
        self.lag = float(lag)
        self.lm_params = lm_params or optimizers.LMParams(max_iterations=15)
        self.graph = NonlinearFactorGraph(device=device)
        self.device = self.graph.device
        self.values = Values(device=self.device)
        self.timestamps: Dict[int, float] = {}
        self.smoother_summarization: Optional[NonlinearFactorGraph] = None

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_values: Optional[Values] = None,
        timestamps: Optional[Dict[int, float]] = None,
    ) -> optimizers.OptimizerResult:
        if new_values is not None:
            for k in new_values.keys():
                self.values.insert(k, new_values.type_of(k), new_values.at(k))
        if timestamps:
            self.timestamps.update({int(k): float(t) for k, t in timestamps.items()})
        if new_factors is not None:
            new_factors._materialize()
            self.graph.batches.extend(new_factors.batches)
        full = _merge_graphs(self.device, self.graph, self.smoother_summarization)
        res = optimizers.levenberg_marquardt(full, self.values, self.lm_params, device=self.device)
        self.values = res.values
        return res


def synchronize(filter: ConcurrentBatchFilter, smoother: ConcurrentBatchSmoother) -> None:
    """The ConcurrentFilteringAndSmoothing.h synchronize exchange:

    1. The filter finds its out-of-lag keys and the separator (the in-lag
       keys of the factors that touch them).
    2. Those factors move to the smoother with the old keys' estimates.
    3. The filter summarizes its REMAINING own factors onto the separator
       for the smoother; the old keys leave the filter.
    4. The smoother re-optimizes and returns its own separator marginal,
       which the filter holds as its prior."""
    old = {k for k in _expired(filter.timestamps, filter.lag) if k in filter.values}
    if not old:  # still refresh the smoother and exchange the priors
        smoother.filter_summarization = _summarize_onto(
            filter.graph, filter.values, smoother.separator) if smoother.separator else None
        smoother.update()
        if smoother.separator:
            filter.smoother_summarization = smoother.summarize()
        return

    keep = NonlinearFactorGraph(device=filter.device)
    separator: List[int] = []
    seen: Set[int] = set()
    for b, move, stay in _split(filter.graph, old):
        if len(move):
            _add_rows(smoother.graph, b, move)
            _new_separator_keys(b, move, old, seen, separator)
        if len(stay):
            _add_rows(keep, b, stay)
    for k in sorted(old) + separator:
        if k not in smoother.values:
            smoother.values.insert(k, filter.values.type_of(k), filter.values.at(k))
    # the separator is the CURRENT boundary: earlier separator keys that just
    # went out of lag are now inside the smoother
    smoother.separator = sorted((set(smoother.separator) | set(separator)) - old)

    filter.graph = keep
    smoother.filter_summarization = _summarize_onto(keep, filter.values, smoother.separator)
    new_values = Values(device=filter.device)
    for k in filter.values.keys():
        if int(k) not in old:
            new_values.insert(k, filter.values.type_of(k), filter.values.at(k))
    filter.values = new_values
    for k in old:
        filter.timestamps.pop(k, None)

    # the smoother refines and hands back its separator marginal; the filter
    # adopts its (better) separator estimates
    smoother.update()
    filter.smoother_summarization = smoother.summarize()
    for k in smoother.separator:
        if k in filter.values:
            filter.values.update(k, smoother.values.at(k))


class ConcurrentIncrementalSmoother:
    """Background smoother on the incremental Bayes-tree engine: between
    synchronizations its updates are iSAM2 updates; at each synchronize the
    filter's summarized prior is swapped by factor removal
    (ISAM2.remove_factors), not a batch rebuild. The ISAM2 runs on
    `device` (default "cuda"; the host engine, `isam_params.engine_backend`
    "numpy", needs device="cpu" and raises ValueError on any other)."""

    def __init__(self, isam_params: Optional[ISAM2Params] = None,
                 *, device: DeviceLike = "cuda"):
        self.isam = ISAM2(dataclasses.replace(isam_params or ISAM2Params(relinearize_skip=1),
                                              device=device))
        self.device = self.isam.device
        self.graph = NonlinearFactorGraph(device=self.device)  # OWN history factors
        self.separator: List[int] = []
        self._summ_units: List[Tuple[int, int]] = []

    @property
    def values(self) -> Values:
        return self.isam.calculate_estimate()

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_values: Optional[Values] = None,
        new_summarization: Optional[NonlinearFactorGraph] = None,
    ) -> None:
        if self._summ_units and new_summarization is not None:
            self.isam.remove_factors(self._summ_units)
            self._summ_units = []
        for g in (new_factors, new_summarization):
            if g is not None:
                g._materialize()
        if new_factors is not None and new_factors.batches:
            self.graph._materialize()
            self.graph.batches.extend(new_factors.batches)
            self.isam.update(new_factors, new_values)
        elif new_values is not None and len(new_values):
            self.isam.update(None, new_values)
        if new_summarization is not None and new_summarization.batches:
            self._summ_units = list(self.isam.update(new_summarization, None).new_factor_units)
        for _ in range(2):
            self.isam.update(force_relinearize=True)

    def summarize(self) -> NonlinearFactorGraph:
        """Marginal of the smoother's OWN factors on the separator."""
        if not self.separator:
            return NonlinearFactorGraph(device=self.device)
        return _summarize_onto(self.graph, self.values, self.separator)


class ConcurrentIncrementalFilter:
    """Sensor-rate filter running as iSAM2 (ConcurrentIncrementalFilter.h:30)
    on `device` (default "cuda"; the host engine, `isam_params.engine_backend=
    "numpy"`, needs device="cpu"). Moved-out factors leave the tree by unit
    removal; moved-out variables are dropped by a marginalization that
    keeps no message; the smoother's separator marginal is held as a
    removable prior."""

    def __init__(self, lag: float, isam_params: Optional[ISAM2Params] = None,
                 extra_iterations: int = 2, *, device: DeviceLike = "cuda"):
        self.lag = float(lag)
        self.isam = ISAM2(dataclasses.replace(isam_params or ISAM2Params(relinearize_skip=1),
                                              device=device))
        self.device = self.isam.device
        self.extra_iterations = int(extra_iterations)
        self.graph = NonlinearFactorGraph(device=self.device)
        # per batch of `graph`, per row: the row's engine units
        self._batch_units: List[List[List[Tuple[int, int]]]] = []
        self.timestamps: Dict[int, float] = {}
        self._prior_units: List[Tuple[int, int]] = []

    @property
    def values(self) -> Values:
        return self.isam.calculate_estimate()

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_values: Optional[Values] = None,
        timestamps: Optional[Dict[int, float]] = None,
    ) -> None:
        if timestamps:
            self.timestamps.update({int(k): float(t) for k, t in timestamps.items()})
        if new_factors is not None:
            new_factors._materialize()
        if new_factors is not None and new_factors.batches:
            units = list(self.isam.update(new_factors, new_values).new_factor_units)
            self.graph._materialize()
            off = 0
            for b in new_factors.batches:
                # a factor wider than the block dimension is several engine
                # units, one per row block, block-major within the batch
                n = b.size * self.isam.row_blocks(b.ftype)
                self.graph.batches.append(b)
                self._batch_units.append([units[off + r : off + n : b.size]
                                          for r in range(b.size)])
                off += n
        elif new_values is not None and len(new_values):
            self.isam.update(None, new_values)
        # extra relinearized passes: the batch filter iterates LM to
        # convergence each update; a couple of forced iSAM2 passes close
        # most of the nonlinear gap at window sizes
        for _ in range(self.extra_iterations):
            self.isam.update(force_relinearize=True)


def synchronize_incremental(filter: ConcurrentIncrementalFilter,
                            smoother: ConcurrentIncrementalSmoother) -> None:
    """The synchronize() exchange for the incremental pair: the batch
    pair's separator protocol, done by tree surgery instead of re-solves."""
    est = filter.values
    old = {k for k in _expired(filter.timestamps, filter.lag) if k in est}
    if not old:
        if smoother.separator:
            smoother.update(new_summarization=_summarize_onto(filter.graph, est,
                                                              smoother.separator))
            _install_smoother_prior(filter, smoother)
        return

    move_graph = NonlinearFactorGraph(device=filter.device)
    keep = NonlinearFactorGraph(device=filter.device)
    keep_units: List[List[List[Tuple[int, int]]]] = []
    moved_units: List[Tuple[int, int]] = []
    separator: List[int] = []
    seen: Set[int] = set()
    for (b, move, stay), units in zip(_split(filter.graph, old), filter._batch_units):
        if len(move):
            _add_rows(move_graph, b, move)
            moved_units.extend(u for r in move for u in units[r])
            _new_separator_keys(b, move, old, seen, separator)
        if len(stay):
            _add_rows(keep, b, stay)
            keep_units.append([units[r] for r in stay])

    # values moving to the smoother (old and separator estimates)
    mv = Values(device=filter.device)
    sm_est = smoother.values if smoother.isam.engine is not None else Values(device=filter.device)
    for k in sorted(old) + separator:
        if k not in sm_est and k in est:
            mv.insert(k, est.type_of(k), est.at(k))
    smoother.separator = sorted(set(separator) | (set(smoother.separator) - old))

    # filter surgery: the moved information out, the old variables dropped
    # by a marginalization that keeps no message (their information now
    # lives in the smoother, and the separator must NOT become fixed), then
    # the refreshed smoother prior back in
    filter.isam.remove_factors(moved_units)
    filter.isam.marginalize_leaves(sorted(old), keep_messages=False)
    filter.graph = keep
    filter._batch_units = keep_units
    for k in old:
        filter.timestamps.pop(k, None)

    smoother.update(move_graph, mv,
                    new_summarization=_summarize_onto(keep, est, smoother.separator))
    _install_smoother_prior(filter, smoother)


def _install_smoother_prior(filter: ConcurrentIncrementalFilter,
                            smoother: ConcurrentIncrementalSmoother) -> None:
    if filter._prior_units:
        filter.isam.remove_factors(filter._prior_units)
        filter._prior_units = []
    summ = smoother.summarize()
    if summ.batches:
        filter._prior_units = list(filter.isam.update(summ, None).new_factor_units)
