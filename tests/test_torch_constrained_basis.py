"""The port's constrained optimization and function bases against the JAX
package's (constrained/constrained.py, constrained/qp.py, basis/*).

Inputs come from np.random.default_rng(seed) (or are the JAX tests' own
problems) and go through both packages; the port runs on the CPU in float64.
Tolerances: the basis tables and weight rows atol 1e-12 (points, the
differentiation matrix and the quadrature weights equal: the same numpy);
FitBasis coefficients and the evaluation-factor solves 1e-9 (the JAX test's
1e-8 against the truth); the penalty and augmented-Lagrangian solutions 1e-9
against the JAX package's with the same outer and inner iteration counts;
the grouped constraint staging against the per-constraint staging 1e-12;
solve_qp and solve_lp equal to the JAX package's (the same host numpy). The
JAX tests mirrored: tests/test_basis_constrained.py and tests/test_lp_qp.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch import basis as t_basis
from gtsam_petercdev_torch import constrained as t_con
from gtsam_petercdev_torch.constrained import constrained as t_con_mod
from gtsam_petercdev_torch.constrained import qp as t_qp
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert
from gtsam_petercdev_tpu import basis as j_basis
from gtsam_petercdev_tpu import constrained as j_con
from gtsam_petercdev_tpu.constrained import qp as j_qp
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

F64 = torch.float64
TAB_TOL = 1e-12
LM_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- bases ------------------------------------------------------------------------------


@pytest.mark.parametrize("N,a,b", [(1, -1.0, 1.0), (5, 0.0, 2.0), (12, -1.0, 1.0), (32, 0.0, 999.0)])
def test_chebyshev_tables_match_jax(N, a, b):
    np.testing.assert_array_equal(t_basis.chebyshev2_points(N, a, b), j_basis.chebyshev2_points(N, a, b))
    np.testing.assert_array_equal(t_basis.chebyshev2_differentiation_matrix(N, a, b),
                                  j_basis.chebyshev2_differentiation_matrix(N, a, b))
    np.testing.assert_array_equal(t_basis.chebyshev2_integration_weights(N, a, b),
                                  j_basis.chebyshev2_integration_weights(N, a, b))
    rng = np.random.default_rng(N)
    x = np.r_[rng.uniform(a, b, 7), t_basis.chebyshev2_points(N, a, b)[: min(N, 3)]]  # exact hits
    for name in ("chebyshev2_weights", "chebyshev2_derivative_weights", "chebyshev1_weights"):
        tw = getattr(t_basis, name)(N, torch.tensor(x), a, b)
        jw = getattr(j_basis, name)(N, jnp.asarray(x), a, b)
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=TAB_TOL * max(1, N))


@pytest.mark.parametrize("N", [1, 4, 5])
def test_fourier_rows_match_jax(N):
    x = np.random.default_rng(N).uniform(-4, 4, 9)
    for name in ("fourier_weights", "fourier_derivative_weights"):
        np.testing.assert_allclose(getattr(t_basis, name)(N, torch.tensor(x)).numpy(),
                                   np.asarray(getattr(j_basis, name)(N, jnp.asarray(x))),
                                   rtol=0, atol=TAB_TOL)


class TestChebyshev2:
    def test_interpolation_exact_polynomial(self):
        N = 8
        pts = t_basis.chebyshev2_points(N)
        f = lambda x: 3.0 * x ** 5 - x ** 3 + 2 * x - 0.5
        xq = torch.tensor([-0.77, -0.1, 0.33, 0.9], dtype=F64)
        W = t_basis.chebyshev2_weights(N, xq)
        np.testing.assert_allclose((W @ torch.tensor(f(pts))).numpy(), f(xq.numpy()), rtol=1e-10)

    def test_interpolation_at_node_is_exact_hit(self):
        pts = t_basis.chebyshev2_points(6)
        W = t_basis.chebyshev2_weights(6, torch.tensor(pts[2]))
        np.testing.assert_allclose(W.numpy(), np.eye(6)[2], atol=1e-12)

    def test_derivative_weights(self):
        pts = t_basis.chebyshev2_points(12)
        w = t_basis.chebyshev2_derivative_weights(12, torch.tensor(0.4, dtype=F64))
        assert float(w @ torch.tensor(np.exp(pts))) == pytest.approx(np.exp(0.4), rel=1e-8)

    def test_chebyshev1_rows(self):
        w = t_basis.chebyshev1_weights(4, torch.tensor(0.5, dtype=F64))
        np.testing.assert_allclose(w.numpy(), [1.0, 0.5, -0.5, -1.0], atol=1e-12)


class TestFourier:
    def test_derivative_is_grad(self):
        c = torch.tensor([0.1, -0.4, 0.9, 0.2, -0.3], dtype=F64)
        x = torch.tensor(0.3, dtype=F64, requires_grad=True)
        (t_basis.fourier_weights(5, x) @ c).backward()
        d = t_basis.fourier_derivative_weights(5, x.detach()) @ c
        assert float(d) == pytest.approx(float(x.grad), rel=1e-10)


class TestFitBasis:
    @pytest.mark.parametrize("N,weights", [(14, "chebyshev2_weights"), (7, "fourier_weights")])
    def test_fit_matches_jax(self, N, weights):
        # each basis on its own domain (the normal equations' conditioning)
        xs = np.linspace(-1, 1, 40) if weights.startswith("cheb") else \
            np.linspace(0, 2 * np.pi, 40, endpoint=False)
        f = lambda x: np.exp(np.sin(2 * x))
        tfit = t_basis.FitBasis(xs, f(xs), N, getattr(t_basis, weights), device="cpu")
        jfit = j_basis.FitBasis(xs, f(xs), N, getattr(j_basis, weights))
        np.testing.assert_allclose(tfit.coefficients.numpy(), np.asarray(jfit.coefficients),
                                   rtol=0, atol=LM_TOL)
        xq = np.asarray([-0.5, 0.0, 0.62]) if weights.startswith("cheb") else np.asarray([0.3, 2.0, 5.5])
        np.testing.assert_allclose(tfit(xq).numpy(), np.asarray(jfit(xq)), rtol=0, atol=LM_TOL)
        if weights == "chebyshev2_weights":
            np.testing.assert_allclose(tfit(xq).numpy(), f(xq), atol=1e-4)

    @pytest.mark.parametrize("solver", ["dense", "multifrontal"])
    def test_evaluation_factor_in_graph(self, solver):
        """Fit 3 Fourier coefficients through the nonlinear pipeline; the
        graph carried across by convert ("BasisEval3_fourier_weights" on a
        Vector3 registered on first use)."""
        N = 3
        c_true = np.array([1.0, 0.5, -0.2])
        xs = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        ys = np.asarray(j_basis.fourier_weights(N, jnp.asarray(xs)) @ jnp.asarray(c_true))
        jft = j_basis.evaluation_factor(N, j_basis.fourier_weights)
        jg, jv = JGraph(), JValues()
        jv.insert(0, f"Vector{N}", jnp.zeros(N))
        jg.add_batch(jft, np.zeros((16, 1)), {"x": jnp.asarray(xs), "y": jnp.asarray(ys)},
                     np.ones((16, 1, 1)))
        jr = j_opt.gauss_newton(jg, jv)
        tg = convert.graph_from_arrays([(jft.name, np.zeros((16, 1), np.int64),
                                         {"x": xs, "y": ys}, np.ones((16, 1, 1)))], device="cpu")
        tv = convert.values_from_arrays({f"Vector{N}": (np.array([0]), np.zeros((1, N)))},
                                        device="cpu")
        tr = t_opt.gauss_newton(tg, tv, t_opt.OptimizerParams(solver=solver), device="cpu")
        np.testing.assert_allclose(tr.values.at(0).numpy(), np.asarray(jr.values.at(0)), rtol=0,
                                   atol=LM_TOL)
        np.testing.assert_allclose(tr.values.at(0).numpy(), c_true, atol=1e-8)


# --- constrained -------------------------------------------------------------------------


def _sum0(xs, p):
    return torch.sum(xs[0], dim=-1, keepdim=True)


def _x0cap(cap):
    return lambda xs, p: xs[0][..., :1] - cap


def _norm_r(xs, p):
    """||x|| - r, r the constraint's params."""
    return torch.sqrt(torch.sum(xs[0] * xs[0], dim=-1, keepdim=True)) - p[..., None]


def _jax_norm_r(xs, p):
    return (jnp.sqrt(jnp.sum(xs[0] * xs[0])) - p)[None]


def _points(targets, start):
    """Point3 variables 0..n-1 with unit priors at `targets`, both packages."""
    jg, jv, tg, tv = JGraph(), JValues(), TGraph(device="cpu"), TValues(device="cpu")
    for i, (tgt, s) in enumerate(zip(targets, start)):
        jv.insert(i, "Point3", jnp.asarray(s))
        tv.insert(i, "Point3", np.asarray(s))
        jg.add(j_factors.prior_factor("Point3"), [i], jnp.asarray(tgt), j_noise.isotropic(3, 1.0))
        tg.add(t_factors.prior_factor("Point3"), [i], np.asarray(tgt), np.eye(3))
    return jg, jv, tg, tv


def _solve_both(method, jcons, tcons, targets, start, **kw):
    jg, jv, tg, tv = _points(targets, start)
    jr = getattr(j_con, method)(jg, jcons, jv, j_con.PenaltyParams(**kw))
    tr = getattr(t_con, method)(tg, tcons, tv, t_con.PenaltyParams(**kw), device="cpu")
    np.testing.assert_allclose(tr.values.params("Point3").numpy(),
                               np.asarray(jr.values.params("Point3")), rtol=0, atol=LM_TOL)
    assert tr.iterations == jr.iterations
    return tr


ONE = ([[1.0, 1.0, 1.0]], [[0.0, 0.0, 0.0]])


class TestConstrained:
    """The JAX tests' problems: min ||x - (1, 1, 1)||^2 under one constraint."""

    def test_equality_penalty(self):
        jc = j_con.EqualityConstraint("sum0", ("Point3",), 1, lambda xs, p: jnp.sum(xs[0])[None], [0])
        tc = t_con.EqualityConstraint("sum0", ("Point3",), 1, _sum0, [0])
        tr = _solve_both("penalty_optimize", [jc], [tc], *ONE, mu_rate=10.0)
        x = tr.values.at(0).numpy()
        assert abs(x.sum()) < 1e-4
        np.testing.assert_allclose(x, [0.0, 0.0, 0.0], atol=1e-3)

    def test_equality_augmented_lagrangian(self):
        jc = j_con.EqualityConstraint("sum0", ("Point3",), 1, lambda xs, p: jnp.sum(xs[0])[None], [0])
        tc = t_con.EqualityConstraint("sum0", ("Point3",), 1, _sum0, [0])
        tr = _solve_both("augmented_lagrangian_optimize", [jc], [tc], *ONE, constraint_tol=1e-8)
        x = tr.values.at(0).numpy()
        assert abs(x.sum()) < 1e-7
        np.testing.assert_allclose(x, [0.0, 0.0, 0.0], atol=1e-6)

    @pytest.mark.parametrize("cap,active", [(0.2, True), (5.0, False)])
    def test_inequality(self, cap, active):
        jc = j_con.InequalityConstraint("x0cap", ("Point3",), 1,
                                        lambda xs, p: (xs[0][0] - cap)[None], [0])
        tc = t_con.InequalityConstraint("x0cap", ("Point3",), 1, _x0cap(cap), [0])
        tr = _solve_both("augmented_lagrangian_optimize", [jc], [tc], *ONE)
        x = tr.values.at(0).numpy()
        if active:
            assert x[0] <= 0.2 + 1e-5
            np.testing.assert_allclose(x[1:], [1.0, 1.0], atol=1e-6)
        else:
            np.testing.assert_allclose(x, [1, 1, 1], atol=1e-6)


def _sphere_problem(n=6, seed=0):
    """n Point3 variables with priors off a sphere of radius 2 and one
    ||x_i|| = 2 constraint each (phase 15 f)'s shape, small)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    targets = u * rng.uniform(1.5, 2.5, (n, 1))
    start = targets + rng.normal(size=(n, 3)) * 0.1
    return targets, start, np.full(n, 2.0)


@pytest.mark.parametrize("method", ["penalty_optimize", "augmented_lagrangian_optimize"])
def test_many_constraints_match_jax(method):
    """Three nonlinear equality constraints: the JAX package stages one batch
    each, the port one batch for all (one g): the same solution."""
    targets, start, r = _sphere_problem(n=3)
    jcons = [j_con.EqualityConstraint("norm", ("Point3",), 1, _jax_norm_r, [i], r[i])
             for i in range(len(r))]
    tcons = [t_con.EqualityConstraint("norm", ("Point3",), 1, _norm_r, [i], r[i])
             for i in range(len(r))]
    tr = _solve_both(method, jcons, tcons, targets, start, constraint_tol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(tr.values.params("Point3").numpy(), axis=1), r,
                               atol=1e-3 if method == "penalty_optimize" else 1e-7)


@pytest.mark.parametrize("method", ["penalty_optimize", "augmented_lagrangian_optimize"])
@pytest.mark.parametrize("kind", ["equality", "inequality"])
def test_grouped_staging_equals_per_constraint(method, kind):
    """Constraints sharing one g stage as one factor batch; each with its own
    g callable (a distinct wrapper) as a batch each: the same solution, and
    the augmented graph has one constraint batch against n."""
    targets, start, r = _sphere_problem(n=8, seed=1)
    cls = t_con.EqualityConstraint if kind == "equality" else t_con.InequalityConstraint
    shared = [cls("norm", ("Point3",), 1, _norm_r, [i], r[i]) for i in range(len(r))]
    split = [cls("norm", ("Point3",), 1, functools.partial(_norm_r), [i], r[i])
             for i in range(len(r))]
    out = {}
    for name, cons in (("shared", shared), ("split", split)):
        _, _, tg, tv = _points(targets, start)
        aug = TGraph(device="cpu")
        groups = t_con_mod._groups(cons, aug)
        assert len(groups) == (1 if name == "shared" else len(r))
        t_con_mod._augment(aug, tg, groups, 10.0, t_con_mod._zero_duals(groups, tv))
        assert len(aug.batches) == len(tg.batches) + len(groups)
        out[name] = getattr(t_con, method)(tg, cons, tv, t_con.PenaltyParams(constraint_tol=1e-8),
                                           device="cpu")
    a, b = out["shared"], out["split"]
    assert a.iterations == b.iterations
    np.testing.assert_allclose(a.values.params("Point3").numpy(),
                               b.values.params("Point3").numpy(), rtol=0, atol=1e-12)


def test_multifrontal_inner_solver():
    """The inner LM on the multifrontal route lands where the dense one does."""
    targets, start, r = _sphere_problem(n=10, seed=2)
    cons = [t_con.EqualityConstraint("norm", ("Point3",), 1, _norm_r, [i], r[i])
            for i in range(len(r))]
    res = {}
    for solver in ("dense", "multifrontal"):
        _, _, tg, tv = _points(targets, start)
        res[solver] = t_con.augmented_lagrangian_optimize(
            tg, cons, tv, t_con.PenaltyParams(constraint_tol=1e-8,
                                              inner=t_opt.LMParams(solver=solver)), device="cpu")
    np.testing.assert_allclose(res["multifrontal"].values.params("Point3").numpy(),
                               res["dense"].values.params("Point3").numpy(), rtol=0, atol=LM_TOL)


# --- the host QP / LP ---------------------------------------------------------------------

QPS = {
    "nocedal_16_4": dict(G=2 * np.eye(2), g=np.array([-2.0, -5.0]),
                         CI=np.array([[1.0, -2.0], [-1.0, -2.0], [-1.0, 2.0], [1.0, 0.0],
                                      [0.0, 1.0]]),
                         ci=np.array([-2.0, -6.0, -2.0, 0.0, 0.0])),
    "equality_only": dict(G=np.eye(2), g=np.zeros(2), CE=np.array([[1.0, 1.0]]), ce=np.array([2.0])),
    "inactive": dict(G=np.eye(2), g=np.array([-1.0, -1.0]), CI=np.eye(2), ci=np.zeros(2)),
    "infeasible_start": dict(G=np.eye(3), g=np.array([1.0, -2.0, 0.5]), CI=np.eye(3),
                             ci=np.array([0.5, 0.5, 0.5]), CE=np.array([[1.0, 1.0, 1.0]]),
                             ce=np.array([3.0])),
}
QP_TRUTH = {"nocedal_16_4": [1.4, 1.7], "equality_only": [1.0, 1.0], "inactive": [1.0, 1.0]}


@pytest.mark.parametrize("name", sorted(QPS))
def test_solve_qp_matches_jax(name):
    t, j = t_qp.solve_qp(**QPS[name]), j_qp.solve_qp(**QPS[name])
    np.testing.assert_array_equal(t.x, j.x)
    assert (t.iterations, t.converged) == (j.iterations, j.converged)
    np.testing.assert_array_equal(t.active, j.active)
    if name in QP_TRUTH:
        np.testing.assert_allclose(t.x, QP_TRUTH[name], atol=1e-8)


LPS = {
    "basic": (dict(c=np.array([-1.0, -1.0]),
                   CI=np.array([[-1.0, -2.0], [-4.0, -2.0], [1.0, 0.0], [0.0, 1.0]]),
                   ci=np.array([-4.0, -12.0, 0.0, 0.0])), [8.0 / 3.0, 2.0 / 3.0]),
    "with_equality": (dict(c=np.array([1.0, 0.0]), CE=np.array([[1.0, 1.0]]), ce=np.array([1.0]),
                           CI=np.eye(2), ci=np.zeros(2)), [0.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(LPS))
def test_solve_lp_matches_jax(name):
    kw, truth = LPS[name]
    t, j = t_qp.solve_lp(**kw), j_qp.solve_lp(**kw)
    np.testing.assert_array_equal(t.x, j.x)
    assert (t.iterations, t.converged) == (j.iterations, j.converged)
    np.testing.assert_allclose(t.x, truth, atol=1e-5)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_basis.FitBasis(np.linspace(-1, 1, 10), np.zeros(10), 4, t_basis.chebyshev2_weights)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_basis.chebyshev2_weights(4, 0.3)
    _, _, tg, tv = _points(*ONE)
    tc = t_con.EqualityConstraint("sum0", ("Point3",), 1, _sum0, [0])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_con.penalty_optimize(tg, [tc], tv)
