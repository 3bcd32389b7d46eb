"""Equality / inequality-constrained nonlinear optimization.

Port of gtsam_petercdev_tpu/constrained/constrained.py (reference: gtsam/
constrained/: NonlinearEqualityConstraint.h, NonlinearInequalityConstraint.h
and the penalty-function building blocks). Constraints are explicit
residual specs and the outer loops are the two classic schemes:

- `penalty_optimize`: quadratic penalty, mu <- mu * rate each outer
  iteration.
- `augmented_lagrangian_optimize`: multiplier estimates lambda absorb the
  constraint so mu stays bounded. The AL term mu/2 ||g(x) + lambda/mu||^2
  is a constraint residual shifted by lambda/mu, so every inner solve is the
  port's LM on an ordinary weighted graph (any solver; "multifrontal" runs
  the bucket kernels).

Inequalities g(x) <= 0 use the max(0, g) slack with the active set chosen
by `torch.maximum`.

As every residual of the port, a constraint's g(xs, params) is written
over leading batch dims: xs are the variables of many constraints stacked
([G, ...] per slot), params theirs stacked, and it returns [G, dim].
Constraints of one kind that share one g callable, var_types, dim and the
presence of params are staged as one factor batch (the JAX package stages a
batch per constraint); the shifts and multipliers stay on the device, and
each outer iteration reads one number, the largest violation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core.tree import tree_map, tree_stack
from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass
class EqualityConstraint:
    """g(xs, params) = 0 (dim-dimensional)."""

    name: str
    var_types: Tuple[str, ...]
    dim: int
    g: Callable[[Tuple[Any, ...], Any], torch.Tensor]
    keys: Sequence[int]
    params: Any = None


@dataclass
class InequalityConstraint:
    """g(xs, params) <= 0 elementwise (dim-dimensional)."""

    name: str
    var_types: Tuple[str, ...]
    dim: int
    g: Callable[[Tuple[Any, ...], Any], torch.Tensor]
    keys: Sequence[int]
    params: Any = None


@dataclass
class PenaltyParams:
    mu_initial: float = 1.0
    mu_rate: float = 10.0
    max_outer_iterations: int = 12
    constraint_tol: float = 1e-6
    inner: Optional[optimizers.LMParams] = None


@dataclass
class _Group:
    """Constraints staged as one factor batch: the first one's spec, every
    member's keys [G, K] and params stacked on the device."""

    spec: Any
    keys: np.ndarray
    params: Any

    @property
    def inequality(self) -> bool:
        return isinstance(self.spec, InequalityConstraint)


def _groups(constraints, graph: NonlinearFactorGraph) -> List[_Group]:
    """Constraints grouped by (kind, g, var_types, dim, params or not), in
    the order each group first appears."""
    members = {}
    for c in constraints:
        tag = (type(c), c.g, tuple(c.var_types), c.dim, c.params is None)
        members.setdefault(tag, []).append(c)
    out = []
    for cs in members.values():
        keys = np.asarray([list(c.keys) for c in cs], dtype=np.uint64)
        params = tree_stack([graph._to_device(c.params) for c in cs],
                            lambda xs: torch.stack(xs, dim=0))
        out.append(_Group(cs[0], keys, params))
    return out


def _constraint_factor(group: _Group, uid: int) -> FactorType:
    """FactorType whose residual is g(x) + shift (the dual shift lambda/mu;
    zero for the plain penalty). `uid` keeps groups that share a display
    name apart: batches are told apart by FactorType name."""
    c = group.spec

    def residual(xs, params):
        r = c.g(xs, params["user"])
        if group.inequality:
            # active when violated or pushed by the multiplier
            r = torch.maximum(r, -params["shift"])
        return r + params["shift"]

    return FactorType(name=f"Constraint_{c.name}_{uid}", var_types=tuple(c.var_types),
                      resid_dim=c.dim, residual=residual)


def _augment(aug: NonlinearFactorGraph, graph: NonlinearFactorGraph, groups, mu: float,
             duals) -> NonlinearFactorGraph:
    """Refill `aug` with the objective's factor batches (shared with
    `graph`, not copied) and one mu-weighted batch of constraint factors a
    group. The
    same `aug` serves every outer iteration: its structure does not change,
    so the multifrontal solver plans it once."""
    graph._materialize()
    aug.batches = list(graph.batches)
    aug._pending = {}
    sqrt_mu = float(np.sqrt(mu))
    for gi, (grp, lam) in enumerate(zip(groups, duals)):
        n, dim = lam.shape
        info = sqrt_mu * torch.eye(dim, dtype=aug.dtype, device=aug.device)
        aug.add_batch(_constraint_factor(grp, gi), grp.keys,
                      {"user": grp.params, "shift": lam / mu}, info.expand(n, dim, dim))
    return aug


def _constraint_values(groups, values: Values):
    """Raw (unclipped) g(x) per group, [G, dim] each: used for the dual
    update."""
    out = []
    for grp in groups:
        xs = []
        for k, t in enumerate(grp.spec.var_types):
            rows = torch.as_tensor(values.rows(grp.keys[:, k], t), dtype=torch.int64)
            rows = rows.to(values.device)
            xs.append(tree_map(lambda a: a[rows], values.params(t)))
        out.append(grp.spec.g(tuple(xs), grp.params))
    return out


def _violation(groups, raw) -> float:
    """The largest |violation| over every constraint (inequalities count
    only where g > 0): one device read."""
    worst = [torch.amax(torch.abs(torch.clamp(g, min=0.0) if grp.inequality else g))
             for grp, g in zip(groups, raw)]
    return float(torch.amax(torch.stack(worst)))


def _zero_duals(groups, values: Values):
    return [torch.zeros((len(grp.keys), grp.spec.dim), dtype=values.dtype,
                        device=values.device) for grp in groups]


def penalty_optimize(
    graph: NonlinearFactorGraph,
    constraints: Sequence,
    values: Values,
    params: Optional[PenaltyParams] = None,
    *,
    device: DeviceLike = "cuda",
):
    """Quadratic-penalty method: solve min f + mu/2 ||g||^2, mu increasing.
    Runs on `device` (graph and values must live there)."""
    params = params or PenaltyParams()
    aug = NonlinearFactorGraph(device=graph.device, dtype=graph.dtype)
    groups = _groups(constraints, aug)
    zeros = _zero_duals(groups, values)
    mu = params.mu_initial
    result = None
    for _ in range(params.max_outer_iterations):
        _augment(aug, graph, groups, mu, zeros)
        result = optimizers.levenberg_marquardt(aug, values, params.inner, device=device)
        values = result.values
        if _violation(groups, _constraint_values(groups, values)) < params.constraint_tol:
            break
        mu *= params.mu_rate
    return result


def augmented_lagrangian_optimize(
    graph: NonlinearFactorGraph,
    constraints: Sequence,
    values: Values,
    params: Optional[PenaltyParams] = None,
    *,
    device: DeviceLike = "cuda",
):
    """Augmented Lagrangian (method of multipliers): lambda_{k+1} = lambda_k +
    mu g(x_k); mu grows only when the violation stalls (above a quarter of
    the previous one). Runs on `device` (graph and values must live there);
    the multipliers take the Values' dtype."""
    params = params or PenaltyParams()
    aug = NonlinearFactorGraph(device=graph.device, dtype=graph.dtype)
    groups = _groups(constraints, aug)
    duals = _zero_duals(groups, values)
    mu = params.mu_initial
    prev_viol = None
    result = None
    for _ in range(params.max_outer_iterations):
        _augment(aug, graph, groups, mu, duals)
        result = optimizers.levenberg_marquardt(aug, values, params.inner, device=device)
        values = result.values
        raw = _constraint_values(groups, values)
        max_v = _violation(groups, raw)
        if max_v < params.constraint_tol:
            break
        # the dual update reads the RAW g: for an inequality, lam <- max(lam +
        # mu g, 0) must see g < 0, so that a multiplier on a constraint that
        # became inactive decays back to 0
        duals = [torch.clamp(lam + mu * g, min=0.0) if grp.inequality else lam + mu * g
                 for grp, lam, g in zip(groups, duals, raw)]
        if prev_viol is not None and max_v > 0.25 * prev_viol:
            mu *= params.mu_rate
        prev_viol = max_v
    return result
