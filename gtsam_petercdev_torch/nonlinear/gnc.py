"""Graduated Non-Convexity robust optimization.

Port of gtsam_petercdev_tpu/nonlinear/gnc.py. Reference:
gtsam/nonlinear/GncOptimizer.h:183-320 + GncParams.h — an outer loop
around GN that anneals a surrogate robust cost (TLS or Geman-McClure) via
the control parameter mu, recomputing per-factor weights and re-solving the
weighted least-squares problem each round; the inlier threshold barcSq
comes from the chi-squared quantile (internal/ChiSquaredInverse.h).

The per-factor weights are device tensors, one [N] per factor batch; the
weight updates are the closed-form TLS / GM rules evaluated on a whole
batch at once. The inner solve is dense, as in the JAX package: the
weighted system is assembled into (H, g) (`linear/solve.assemble_dense`)
and solved by `dense_solve(H, g, 1e-9)`. Each outer iteration reads a few
scalars back (the costs, the largest residual, the weights' distance from
binary).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, check_graph_values
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import (
    LinearBatch,
    NonlinearFactorGraph,
    _whiten,
)
from gtsam_petercdev_torch.nonlinear.values import Values


def chi_squared_quantile(dof: float, alpha: float) -> float:
    """Inverse chi-squared CDF (the cephes-backed ChiSquaredInverse analog,
    gtsam/nonlinear/internal/ChiSquaredInverse.h). Host computation (scipy):
    set-up scalar work."""
    from scipy.stats import chi2

    return float(chi2.ppf(alpha, dof))


@dataclass
class GncParams:
    loss_type: str = "tls"  # "tls" | "gm"
    max_iterations: int = 100  # outer GNC iterations
    mu_step: float = 1.4
    relative_cost_tol: float = 1e-5
    weights_tol: float = 1e-4
    alpha: float = 0.99  # chi-squared inlier quantile
    barc_sq: Optional[float] = None  # override the chi2-derived threshold
    known_inliers: Dict[int, np.ndarray] = field(default_factory=dict)
    # known_inliers[batch_index] = bool [N] mask of factors pinned to w=1
    inner: optimizers.OptimizerParams = field(
        default_factory=lambda: optimizers.OptimizerParams(max_iterations=10)
    )
    verbose: bool = False


@dataclass
class GncResult:
    values: Values
    weights: List[torch.Tensor]  # per batch [N] final weights (device)
    inliers: List[np.ndarray]  # per batch [N] bool (weight > 0.5)
    iterations: int
    error: float


def _factor_sq_residuals(graph: NonlinearFactorGraph, values: Values) -> List[torch.Tensor]:
    """Per-factor whitened squared residual norms r2, per batch."""
    out = []
    for batch in graph.batches:
        _, rows_dev = graph._batch_rows(batch, values)
        xs = graph._gather(values, batch, rows_dev)
        r_w = _whiten(batch.sqrt_info, batch.ftype.residual(xs, batch.params))
        out.append(torch.sum(r_w * r_w, dim=-1))
    return out


def _weighted_assemble(graph: NonlinearFactorGraph, values: Values, weights):
    """Dense (H, g) with each factor's rows scaled by sqrt(w), and the
    linearized graph (its type counts unflatten the solution)."""
    lg = graph.linearize(values)
    for i, lb in enumerate(lg.batches):
        sw = torch.sqrt(torch.clamp(weights[i], min=0.0))[:, None]
        lg.batches[i] = LinearBatch(
            var_types=lb.var_types,
            rows=lb.rows,
            A=tuple(Ak * sw[..., None] for Ak in lb.A),
            b=lb.b * sw,
            sign=lb.sign,
            rows_dev=lb.rows_dev,
        )
    H, g = linsolve.assemble_dense(lg)
    return H, g, lg


def _weighted_error(graph: NonlinearFactorGraph, values: Values, weights) -> torch.Tensor:
    r2s = _factor_sq_residuals(graph, values)
    return sum(
        graph.batches[i].sign * 0.5 * torch.sum(weights[i] * r2) for i, r2 in enumerate(r2s)
    )


def _update_weights_tls(r2, mu, barc_sq):
    upper = (mu + 1.0) / mu * barc_sq
    lower = mu / (mu + 1.0) * barc_sq
    mid = torch.sqrt(barc_sq * mu * (mu + 1.0) / torch.clamp(r2, min=1e-30)) - mu
    return torch.where(
        r2 >= upper, 0.0, torch.where(r2 <= lower, 1.0, torch.clamp(mid, 0.0, 1.0))
    )


def _update_weights_gm(r2, mu, barc_sq):
    w = (mu * barc_sq) / (r2 + mu * barc_sq)
    return w * w


def gnc(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[GncParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> GncResult:
    """GncOptimizer::optimize: the initial weighted solve at unit weights,
    mu from the largest residual (initializeMu), then rounds of weight
    update + weighted solve until the TLS weights are binary (after the
    first round) or the GM mu is annealed to 1."""
    check_graph_values(graph, values, device)
    params = params or GncParams()
    graph._materialize()
    values._materialize()
    dev = graph.device

    # per-batch inlier thresholds from factor dimension
    barcs = [
        params.barc_sq
        if params.barc_sq is not None
        else chi_squared_quantile(batch.ftype.resid_dim, params.alpha)
        for batch in graph.batches
    ]
    # the pinned factors' masks, uploaded once
    pins = {
        i: torch.as_tensor(np.asarray(m, dtype=bool)).to(dev)
        for i, m in params.known_inliers.items()
    }

    def inner_solve(v, w):
        """Weighted GN iterations at fixed weights (the reference's
        baseOptimizer step, GncOptimizer.h:250)."""
        err = float(_weighted_error(graph, v, w))
        for _ in range(params.inner.max_iterations):
            H, g, lg = _weighted_assemble(graph, v, w)
            x = linsolve.dense_solve(H, g, 1e-9)
            del H
            v_new = v.retract(linsolve.unflatten_delta(lg, x))
            new_err = float(_weighted_error(graph, v_new, w))
            if not np.isfinite(new_err) or new_err > err:
                break
            v = v_new
            if optimizers.check_convergence(params.inner, err, new_err):
                err = new_err
                break
            err = new_err
        return v, err

    # initial solve at unit weights
    weights = [torch.ones((b.size,), dtype=torch.float64, device=dev) for b in graph.batches]
    values, cost = inner_solve(values, weights)

    # initialize mu from the max residual (GncOptimizer::initializeMu)
    r2s = _factor_sq_residuals(graph, values)
    r2max = float(torch.stack([torch.max(r2) for r2 in r2s]).max()) if r2s else 1.0
    if params.loss_type == "tls":
        denom = 2.0 * r2max / max(barcs) - 1.0
        mu = 1e-6 if denom <= 0 else 1.0 / denom
        upd = _update_weights_tls
    else:
        mu = max(1.0, 2.0 * r2max / max(barcs))
        upd = _update_weights_gm

    it = 0
    for it in range(1, params.max_iterations + 1):
        r2s = _factor_sq_residuals(graph, values)
        new_weights = []
        for i, r2 in enumerate(r2s):
            w = upd(r2, mu, barcs[i])
            if i in pins:
                w = torch.where(pins[i], 1.0, w)
            new_weights.append(w)

        weights = new_weights
        values, cost = inner_solve(values, weights)
        if params.verbose:
            print(f"GNC iter {it}: mu={mu:.3e} cost={cost:.6e}")

        # convergence (GncOptimizer::checkConvergence): GM -> mu annealed to
        # 1; TLS -> all weights binary (checkWeightsConvergence), one read.
        # A plain cost/weight-delta test would fire spuriously at iteration 1
        # while the anneal has not yet begun.
        if params.loss_type == "gm":
            if mu <= 1.0 + 1e-9:
                break
        else:
            gap = float(torch.stack([torch.max(torch.abs(w - torch.round(w))) for w in weights]).max())
            if gap < params.weights_tol and it > 1:
                break
        mu = mu * params.mu_step if params.loss_type == "tls" else max(1.0, mu / params.mu_step)

    inliers = [(w > 0.5).cpu().numpy() for w in weights]
    return GncResult(values, weights, inliers, it, float(cost))
