"""Batch nonlinear optimizers: Gauss-Newton, Levenberg-Marquardt, Powell's
dogleg, nonlinear conjugate gradients and mixed-precision Gauss-Newton.

Port of gtsam_petercdev_tpu/nonlinear/optimizers.py. The loop is
NonlinearOptimizer::defaultOptimize's: stop when the error drops below
error_tol, or the absolute/relative decrease falls below the tolerances.
LM linearizes once per outer iteration, then adjusts lambda until the
damped step reduces the true cost with model fidelity
rho = costChange / linearizedCostChange >= min_model_fidelity; a trial whose
factorization clamped pivots is rejected and re-damped.

Solvers: "dense" (exact dense Cholesky), "pcg" (matrix-free block-Jacobi
CG, linear/solve.py), "multifrontal" (the sparse supernodal solve of
inference/elimination.py, whose bucket kernels run on the card) and "schur"
(bundle adjustment: batched landmark elimination and a dense reduced camera
solve, sfm/schur.py) and "partitioned" (the separator-Schur solve of
parallel/partition.py: P parts folded onto the device, ranks of the
default process group joined by all_reduce).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import DeviceLike, check_graph_values, resolve_device
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass
class OptimizerParams:
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    solver: str = "dense"  # dense | pcg | multifrontal | schur | partitioned
    pcg_tol: float = 1e-10
    pcg_max_iters: int = 1000
    verbose: bool = False
    # solver="partitioned": the part count P (None: the default process
    # group's ranks, 1 without one)
    partition_devices: Optional[int] = None


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
class DoglegParams(OptimizerParams):
    delta_initial: float = 1.0  # trust-region radius Delta0
    delta_min: float = 1e-7


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

    elif params.solver == "pcg":

        def solve(values, lam, cache):
            if cache.get("lg") is None:
                cache["lg"] = graph.linearize(values)
            lg = cache["lg"]
            delta = linsolve.pcg_solve(lg, lam=lam, diagonal_damping=damping,
                                       tol=params.pcg_tol, max_iters=params.pcg_max_iters)
            return delta, linsolve.linearized_decrease(lg, delta)

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

    elif params.solver == "partitioned":
        from gtsam_petercdev_torch.parallel import partition

        if damping:
            raise ValueError('solver="partitioned" damps with lam * I (diagonal_damping=False)')

        def solve(values, lam, cache):
            return partition.solve_linearized(
                graph, values, lam, cache=cache, n_parts=params.partition_devices
            )

    else:
        raise ValueError(
            f"unknown solver {params.solver!r}: dense, pcg, multifrontal, schur or partitioned"
        )

    return err_fn, retract_fn, solve


def gauss_newton(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[OptimizerParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Plain GN: linearize -> solve -> retract."""
    check_graph_values(graph, values, device)
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
    check_graph_values(graph, values, device)
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


def dogleg(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[DoglegParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Powell's dogleg trust-region method (DoglegOptimizerImpl): blend the
    Gauss-Newton point with the steepest-descent Cauchy point inside a trust
    radius Delta; adapt Delta from the model fidelity rho (>= 0.75 grow,
    < 0.25 shrink). One dense (H, g) per iteration; retries at a shrunk
    Delta reuse it."""
    check_graph_values(graph, values, device)
    params = params or DoglegParams()
    graph._materialize()

    def dogleg_step(H, g, radius: float):
        dx_n = linsolve.dense_solve(H, g, 1e-10)  # Gauss-Newton point
        alpha = torch.dot(g, g) / torch.clamp(torch.dot(g, H @ g), min=1e-30)
        dx_u = alpha * g  # Cauchy (steepest-descent) point
        n_n = torch.linalg.norm(dx_n)
        n_u = torch.linalg.norm(dx_u)
        # tau solving ||dx_u + tau (dx_n - dx_u)|| = Delta (ComputeBlend)
        d = dx_n - dx_u
        a = torch.dot(d, d)
        b = 2.0 * torch.dot(dx_u, d)
        c = torch.dot(dx_u, dx_u) - radius**2
        disc = torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0.0))
        tau = (-b + disc) / torch.clamp(2 * a, min=1e-30)
        blended = dx_u + torch.clamp(tau, 0.0, 1.0) * d
        dx = torch.where(
            n_n <= radius,
            dx_n,
            torch.where(n_u >= radius, (radius / torch.clamp(n_u, min=1e-30)) * dx_u, blended),
        )
        lin_decrease = torch.dot(g, dx) - 0.5 * torch.dot(dx, H @ dx)
        return dx, lin_decrease, torch.linalg.norm(dx)

    err = float(graph.error(values))
    history = [err]
    radius = params.delta_initial
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        lg = graph.linearize(values)
        H, g = linsolve.assemble_dense(lg)
        accepted = False
        while radius >= params.delta_min:
            dx, lin_dec, dx_norm = dogleg_step(H, g, radius)
            new_values = values.retract(linsolve.unflatten_delta(lg, dx))
            new_err = float(graph.error(new_values))
            rho = (err - new_err) / max(float(lin_dec), 1e-30)
            if params.verbose:
                print(f"DL iter {it} Delta={radius:.2e}: {err:.6e} -> {new_err:.6e} rho={rho:.3f}")
            if rho >= 0.75:
                radius = max(radius, 3.0 * float(dx_norm))
            elif rho < 0.25:
                radius *= 0.5
            if new_err < err:
                values = new_values
                accepted = True
                break
        if not accepted:
            converged = True
            break
        history.append(new_err)
        if check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
    return OptimizerResult(values, err, it, converged, history)


def nonlinear_conjugate_gradient(
    graph: NonlinearFactorGraph,
    values: Values,
    params: Optional[OptimizerParams] = None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Manifold nonlinear CG with the Fletcher-Reeves beta and a
    backtracking line search (NonlinearConjugateGradientOptimizer)."""
    check_graph_values(graph, values, device)
    params = params or OptimizerParams()
    graph._materialize()

    def grad(v):  # the NEGATIVE gradient direction J^T b
        return linsolve.gradient(graph.linearize(v))

    def dot(a, b):
        return sum(float(torch.vdot(a[t].reshape(-1), b[t].reshape(-1))) for t in a)

    err = float(graph.error(values))
    history = [err]
    g = grad(values)
    d = g
    gg = dot(g, g)
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        step = 1.0
        accepted = False
        for _ in range(30):
            new_values = values.retract({t: step * d[t] for t in d})
            new_err = float(graph.error(new_values))
            if new_err < err:
                accepted = True
                break
            step *= 0.5
        if not accepted:
            converged = True
            break
        values = new_values
        history.append(new_err)
        if check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
        g_new = grad(values)
        gg_new = dot(g_new, g_new)
        beta = gg_new / max(gg, 1e-30)  # Fletcher-Reeves
        d = {t: g_new[t] + beta * d[t] for t in d}
        g, gg = g_new, gg_new
    return OptimizerResult(values, err, it, converged, history)


def gauss_newton_mixed_precision(
    graph_dev: NonlinearFactorGraph,
    graph_host: NonlinearFactorGraph,
    values_host: Values,
    params: Optional[OptimizerParams] = None,
    lam: float = 1e-5,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    """Mixed-precision iterative-refinement Gauss-Newton: the whitened
    residual (the GN right-hand side), the retract and the error run in
    float64 on the host CPU; the Jacobians and the multifrontal
    factorization run in float32 on `device`, through the bucket kernels.
    High-precision residual, low-precision correction solve: the iteration
    reaches the float64 optimum though the card never leaves float32.

    graph_dev: the float32 graph on `device`; graph_host / values_host:
    float64 twins of the same problem on the CPU (the same factor-batch
    order). The host half is the algorithm, not a fallback: graph_dev must
    be on `device`, the host pair on the CPU."""
    from gtsam_petercdev_torch.inference import elimination

    dev = resolve_device(device)
    if graph_dev.device.type != dev.type:
        raise ValueError(f"graph_dev is on {graph_dev.device}, optimizer asked for {dev}")
    for what, d_ in (("graph_host", graph_host.device), ("values_host", values_host.device)):
        if d_.type != "cpu":
            raise ValueError(f"{what} is on {d_}; the host half runs on the CPU")
    params = params or OptimizerParams()
    graph_dev._materialize()
    graph_host._materialize()
    values_host._materialize()

    structure = elimination.graph_structure(graph_dev, values_host)
    counts = {t: values_host._count(t) for t in values_host.types()}
    offs = elimination.type_offsets(counts)
    types = sorted(counts)
    dims = {t: manifold.get(t).dim for t in types}
    d = max(dims.values())
    n = sum(counts.values())
    var_dims = np.full(n, d, dtype=np.int64)
    for t in types:
        var_dims[offs[t] : offs[t] + counts[t]] = dims[t]
    plan = elimination.build_plan_for_graph(structure, n, d, max_buckets_per_level=4)
    maps = elimination.build_numeric_maps(plan, structure, var_dims=var_dims)

    def dev_step(values_h: Values, b64):
        v32 = Values(values_h._params, values_h._index, values_h._type_keys,
                     device=graph_dev.device, dtype=graph_dev.dtype)
        lg = graph_dev.linearize(v32)
        Ab = tuple((lb.A, b.to(graph_dev.device, graph_dev.dtype))
                   for lb, b in zip(lg.batches, b64))
        return elimination.multifrontal_solve(maps, Ab, lam)

    err = float(graph_host.error(values_host))
    history = [err]
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        b64 = [lb.b for lb in graph_host.linearize(values_host).batches]
        x = dev_step(values_host, b64).to("cpu", torch.float64)
        values_host = values_host.retract(
            {t: x[offs[t] : offs[t] + counts[t], : dims[t]] for t in types})
        new_err = float(graph_host.error(values_host))
        history.append(new_err)
        if params.verbose:
            print(f"GN-mixed iter {it}: {err:.6e} -> {new_err:.6e}")
        if check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
    return OptimizerResult(values_host, err, it, converged, history)
