"""Batch nonlinear optimizers: Gauss-Newton and Levenberg-Marquardt.

Port of gtsam_petercdev_tpu/nonlinear/optimizers.py (GN, LM; the dogleg,
NCG, PCG and mixed-precision variants come with later slices). The loop is
NonlinearOptimizer::defaultOptimize's: stop when the error drops below
error_tol, or the absolute/relative decrease falls below the tolerances.
LM linearizes once per outer iteration, then adjusts lambda until the
damped step reduces the true cost with model fidelity
rho = costChange / linearizedCostChange >= min_model_fidelity; a trial whose
factorization clamped pivots is rejected and re-damped.

Solvers: "dense" (exact dense Cholesky), "multifrontal" (the sparse
supernodal solve of inference/elimination.py, whose bucket kernels run on
the card) and "schur" (bundle adjustment: batched landmark elimination and
a dense reduced camera solve, sfm/schur.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass
class OptimizerParams:
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    solver: str = "dense"  # dense | multifrontal | schur
    verbose: bool = False


@dataclass
class LMParams(OptimizerParams):
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper_bound: float = 1e5
    lambda_lower_bound: float = 0.0
    diagonal_damping: bool = False
    min_model_fidelity: float = 1e-3
    max_try_iterations: int = 30


@dataclass
class OptimizerResult:
    values: Values
    error: float
    iterations: int
    converged: bool
    error_history: List[float] = field(default_factory=list)


def check_convergence(params: OptimizerParams, old: float, new: float) -> bool:
    """NonlinearOptimizer checkConvergence semantics."""
    if new <= params.error_tol:
        return True
    decrease = old - new
    if abs(decrease) <= params.absolute_error_tol:
        return True
    if old > 0 and abs(decrease) <= params.relative_error_tol * old:
        return True
    return False


def _build_fns(graph: NonlinearFactorGraph, params: OptimizerParams):
    """(err_fn, retract_fn, solve) closed over the graph structure."""
    graph._materialize()
    damping = getattr(params, "diagonal_damping", False)

    def err_fn(values: Values):
        return graph.error(values)

    def retract_fn(values: Values, delta):
        return values.retract(delta)

    if params.solver == "dense":
        if any(
            b.constrained_mask is not None and b.constrained_mask.any()
            for b in graph.batches
        ):
            raise NotImplementedError(
                "exact equality constraints need the constrained solve, not ported yet"
            )

        def solve(values, lam, cache):
            if cache.get("Hg") is None:
                lg = graph.linearize(values)
                cache["Hg"] = linsolve.assemble_dense(lg)
                cache["lg"] = lg
            H, g = cache["Hg"]
            x = linsolve.dense_solve(H, g, lam, diagonal_damping=damping)
            # linearized cost change of the UNdamped model:
            # 0.5||r||^2 - 0.5||r - J d||^2 = g.d - 0.5 d^T H d
            lin_decrease = torch.dot(g, x) - 0.5 * torch.dot(x, H @ x)
            return linsolve.unflatten_delta(cache["lg"], x), lin_decrease

    elif params.solver == "multifrontal":
        from gtsam_petercdev_torch.inference import elimination

        def solve(values, lam, cache):
            return elimination.solve_linearized(
                graph, values, lam, diagonal_damping=damping, cache=cache
            )

    elif params.solver == "schur":
        from gtsam_petercdev_torch.sfm import schur

        def solve(values, lam, cache):
            return schur.solve_linearized(
                graph, values, lam, diagonal_damping=damping, cache=cache
            )

    else:
        raise ValueError(f"unknown solver {params.solver}")

    return err_fn, retract_fn, solve


def _check_device(graph: NonlinearFactorGraph, values: Values, device: DeviceLike):
    dev = resolve_device(device)
    for what, d in (("graph", graph.device), ("values", values.device)):
        if d.type != dev.type:
            raise ValueError(f"{what} is on {d}, optimizer asked for {dev}")


def gauss_newton(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[OptimizerParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Plain GN: linearize -> solve -> retract."""
    _check_device(graph, values, device)
    params = params or OptimizerParams()
    err_fn, retract_fn, solve = _build_fns(graph, params)
    err = float(err_fn(values))
    history = [err]
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        delta, _ = solve(values, 0.0, {})
        values = retract_fn(values, delta)
        new_err = float(err_fn(values))
        history.append(new_err)
        if params.verbose:
            print(f"GN iter {it}: error {err:.6e} -> {new_err:.6e}")
        if check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
    return OptimizerResult(values, err, it, converged, history)


def levenberg_marquardt(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[LMParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Trust-region LM (LevenbergMarquardtOptimizer::tryLambda)."""
    _check_device(graph, values, device)
    params = params or LMParams()
    err_fn, retract_fn, solve = _build_fns(graph, params)
    err = float(err_fn(values))
    history = [err]
    lam = params.lambda_initial
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        cache = {}
        accepted = False
        for _try in range(params.max_try_iterations):
            delta, lin_decrease = solve(values, lam, cache)
            bad = cache.pop("bad_pivots", None)
            if bad is not None and int(bad) > 0:
                # (H + lam D) indefinite at this lambda: the factorization
                # clamped pivots, so the step is garbage — reject the trial
                # and re-damp (the IndeterminantLinearSystemException retry)
                if params.verbose:
                    print(f"LM iter {it} lam={lam:.2e}: {int(bad)} bad pivots, re-damping")
                lam *= params.lambda_factor
                if lam > params.lambda_upper_bound:
                    break
                continue
            new_values = retract_fn(values, delta)
            new_err = float(err_fn(new_values))
            cost_change = err - new_err
            lin_dec = float(lin_decrease)
            rho = cost_change / lin_dec if lin_dec > 1e-15 else -1.0
            if params.verbose:
                print(f"LM iter {it} lam={lam:.2e}: {err:.6e} -> {new_err:.6e} rho={rho:.3f}")
            if cost_change > 0 and rho >= params.min_model_fidelity:
                values = new_values
                lam = max(lam / params.lambda_factor, params.lambda_lower_bound)
                accepted = True
                break
            lam *= params.lambda_factor
            if lam > params.lambda_upper_bound:
                break
        if not accepted:
            converged = True  # cannot decrease further (reference: stop)
            break
        history.append(new_err)
        if check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
    return OptimizerResult(values, err, it, converged, history)
