"""Active-set LP / QP solvers, on the host.

Port of gtsam_petercdev_tpu/constrained/qp.py, which is host numpy in the
JAX package too: this module is a numpy copy of it, line for line (no
torch, no device), as the port keeps MFAS in sfm/translation.py. Reference:
gtsam_unstable/linear/QPSolver.{h,cpp} and LPSolver.{h,cpp} — primal
active-set methods, with LPInitSolver's two-phase feasible-point search.
The problems are small and the active-set loop is data-dependent; each
iteration is one KKT solve.

  solve_qp:  min 0.5 x'Gx + g'x   s.t. CE x = ce,  CI x >= ci
  solve_lp:  min c'x              s.t. CE x = ce,  CI x >= ci
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class QPResult:
    x: np.ndarray
    iterations: int
    active: np.ndarray  # indices of active inequality constraints
    converged: bool


def _kkt_solve(G, g, A, b):
    """Solve min 0.5 x'Gx - g'x s.t. A x = b via the KKT system; returns
    (x, lambdas)."""
    n = G.shape[0]
    m = A.shape[0] if A is not None and A.size else 0
    if m == 0:
        return np.linalg.solve(G, g), np.zeros(0)
    KKT = np.block([[G, A.T], [A, np.zeros((m, m))]])
    rhs = np.concatenate([g, b])
    try:
        sol = np.linalg.solve(KKT, rhs)
    except np.linalg.LinAlgError:
        sol = np.linalg.lstsq(KKT, rhs, rcond=None)[0]
    return sol[:n], sol[n:]


def solve_qp(
    G,
    g,
    CE=None,
    ce=None,
    CI=None,
    ci=None,
    x0: Optional[np.ndarray] = None,
    max_iter: int = 100,
    tol: float = 1e-10,
) -> QPResult:
    """Primal active-set QP (QPSolver.cpp iterate/identifyLeavingConstraint
    semantics). G must be positive definite."""
    G = np.asarray(G, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    n = G.shape[0]
    CE = np.zeros((0, n)) if CE is None else np.asarray(CE, dtype=np.float64)
    ce = np.zeros(0) if ce is None else np.asarray(ce, dtype=np.float64)
    CI = np.zeros((0, n)) if CI is None else np.asarray(CI, dtype=np.float64)
    ci = np.zeros(0) if ci is None else np.asarray(ci, dtype=np.float64)

    if x0 is None:
        # feasible start: solve the equality-only problem, then push into
        # the feasible region via the phase-1 LP if needed
        x, _ = _kkt_solve(G, -g, CE, ce)
        if CI.shape[0] and (CI @ x - ci).min() < -tol:
            x = _phase1(CE, ce, CI, ci)
    else:
        x = np.asarray(x0, dtype=np.float64).copy()

    W: list = []  # working set: active inequality indices
    viol = CI @ x - ci if CI.shape[0] else np.zeros(0)
    W = [int(i) for i in np.where(np.abs(viol) < tol)[0]]

    for it in range(1, max_iter + 1):
        A = np.vstack([CE, CI[W]]) if (CE.shape[0] or W) else None
        b = np.concatenate([ce, ci[W]]) if (CE.shape[0] or W) else None
        # direction subproblem at x: min 0.5 p'Gp + grad'p with
        # A p = b - A x (the residual RHS self-corrects an infeasible
        # equality start instead of freezing its violation)
        grad = G @ x + g
        p, lam = _kkt_solve(
            G, -grad, A, (b - A @ x) if A is not None else None
        )
        if np.linalg.norm(p) < tol:
            # KKT at p=0: grad = -A' lam, i.e. true multipliers are -lam;
            # optimality needs them >= 0 for active inequalities
            lam_ineq = -lam[CE.shape[0]:]
            if lam_ineq.size == 0 or lam_ineq.min() >= -tol:
                return QPResult(x, it, np.asarray(sorted(W)), True)
            W.pop(int(np.argmin(lam_ineq)))
            continue
        # step length: nearest blocking inactive constraint
        alpha = 1.0
        block = -1
        for i in range(CI.shape[0]):
            if i in W:
                continue
            den = CI[i] @ p
            if den < -tol:
                a = (ci[i] - CI[i] @ x) / den
                if a < alpha:
                    alpha, block = a, i
        x = x + alpha * p
        if block >= 0:
            W.append(block)
    return QPResult(x, max_iter, np.asarray(sorted(W)), False)


def _phase1(CE, ce, CI, ci, max_iter: int = 200):
    """Feasible point via the auxiliary problem min sum(s) s.t.
    CI x + s >= ci, s >= 0, CE x = ce (LPInitSolver.h:40 semantics),
    solved as a QP with a tiny regularizer."""
    n = CE.shape[1] if CE.size else CI.shape[1]
    mi = CI.shape[0]
    # vars z = [x; s]
    G = np.eye(n + mi) * 1e-8
    G[n:, n:] += np.eye(mi) * 1e-8
    g = np.concatenate([np.zeros(n), np.ones(mi)])  # minimize sum s
    CEz = np.hstack([CE, np.zeros((CE.shape[0], mi))]) if CE.size else None
    CIz = np.vstack(
        [
            np.hstack([CI, np.eye(mi)]),  # CI x + s >= ci
            np.hstack([np.zeros((mi, n)), np.eye(mi)]),  # s >= 0
        ]
    )
    ciz = np.concatenate([ci, np.zeros(mi)])
    s0 = np.maximum(ci - 0.0, 0.0) + 1.0
    z0 = np.concatenate([np.zeros(n), s0])
    res = solve_qp(G, g, CEz, ce if CE.size else None, CIz, ciz, x0=z0,
                   max_iter=max_iter)
    return res.x[:n]


@dataclass
class LPResult:
    x: np.ndarray
    iterations: int
    converged: bool


def solve_lp(
    c,
    CE=None,
    ce=None,
    CI=None,
    ci=None,
    max_iter: int = 200,
) -> LPResult:
    """LP by the active-set method on a vanishing-regularization QP
    sequence (LPSolver semantics; the reference's simplex-style active set
    is the epsilon -> 0 limit). Converges for LPs with a bounded optimum."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    x = None
    eps = 1e-2
    it_total = 0
    for _ in range(3):
        G = np.eye(n) * eps
        res = solve_qp(G, c, CE, ce, CI, ci, x0=x, max_iter=max_iter)
        x = res.x
        it_total += res.iterations
        eps *= 1e-2
    return LPResult(x, it_total, res.converged)
