"""Levenberg-Marquardt as GTSAM's LevenbergMarquardtOptimizer runs it, with
the settings the benchmark passes to the port (LM_SETTINGS).

Each outer iteration linearizes once, then damps H + lambda I until a trial
lowers the error with model fidelity rho = cost change / linearized cost
change >= min_model_fidelity; a trial whose Cholesky fails is rejected and
re-damped. The loop stops at max_iterations, when no trial is accepted, or
when the absolute or relative decrease falls below its tolerance."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

LM_SETTINGS = dict(
    lambda_initial=1e-5,
    lambda_factor=10.0,
    lambda_upper_bound=1e5,
    lambda_lower_bound=0.0,
    diagonal_damping=False,
    min_model_fidelity=1e-3,
    max_try_iterations=30,
    relative_error_tol=1e-5,
    absolute_error_tol=1e-5,
    error_tol=0.0,
)


@dataclass
class LMResult:
    state: Any
    history: List[float] = field(default_factory=list)
    iterations: int = 0
    trials: int = 0  # damped solves, rejected ones included


def _converged(s: dict, old: float, new: float) -> bool:
    if new <= s["error_tol"]:
        return True
    decrease = old - new
    if abs(decrease) <= s["absolute_error_tol"]:
        return True
    return old > 0 and abs(decrease) <= s["relative_error_tol"] * old


def levenberg_marquardt(problem, state, max_iterations: int, settings: dict = LM_SETTINGS):
    s = settings
    err = float(problem.error(state))
    history = [err]
    lam = s["lambda_initial"]
    it = trials = 0
    for it in range(1, max_iterations + 1):
        lin = problem.linearize(state)
        accepted = False
        for _ in range(s["max_try_iterations"]):
            delta, lin_decrease, ok = problem.solve(lin, lam)
            trials += 1
            if not ok:
                lam *= s["lambda_factor"]
                if lam > s["lambda_upper_bound"]:
                    break
                continue
            new_state = problem.retract(state, delta)
            new_err = float(problem.error(new_state))
            cost_change = err - new_err
            lin_dec = float(lin_decrease)
            rho = cost_change / lin_dec if lin_dec > 1e-15 else -1.0
            if cost_change > 0 and rho >= s["min_model_fidelity"]:
                state = new_state
                lam = max(lam / s["lambda_factor"], s["lambda_lower_bound"])
                accepted = True
                break
            lam *= s["lambda_factor"]
            if lam > s["lambda_upper_bound"]:
                break
        del lin
        if not accepted:
            break
        history.append(new_err)
        if _converged(s, err, new_err):
            break
        err = new_err
    return LMResult(state, history, it, trials)
