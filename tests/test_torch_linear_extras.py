"""The port's linear extras against the JAX package's: the exact constrained
solve (linear/qr.py, the dense solver's constrained branch,
slam/factors.nonlinear_equality), the subgraph preconditioner, the power
methods, the Kalman filter / RTS smoother / manifold EKF and the sampler.

Inputs come from np.random.default_rng(seed) and go through both packages;
the port runs on the CPU in float64. Tolerances: solve_lse and the
constrained LM atol / rel 1e-10; SubgraphSolver's solution atol 1e-8; the
power methods rel 1e-8 against JAX (the same iteration) and against
numpy.linalg.eigvalsh at their own tolerance; KF / RTS / EKF rel 1e-12; a
batch of tracks against the tracks one at a time rel 1e-13. The tests of
tests/test_constrained_qr.py, tests/test_kalman.py,
test_multifrontal.py::test_subgraph_solver_matches_dense and
test_geometry_breadth.py::test_sampler_covariance are mirrored on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.linear import kalman as t_kalman
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.linear import qr as t_qr
from gtsam_petercdev_torch.linear import sampler as t_sampler
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.linear import spectral as t_spectral
from gtsam_petercdev_torch.linear import subgraph as t_subgraph
from gtsam_petercdev_torch.nonlinear import ekf as t_ekf
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.linear import kalman as j_kalman
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.linear import qr as j_qr
from gtsam_petercdev_tpu.linear import spectral as j_spectral
from gtsam_petercdev_tpu.linear import subgraph as j_subgraph
from gtsam_petercdev_tpu.nonlinear import ekf as j_ekf
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors
from test_torch_factor_graph import jax_to_arrays

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


# --- the exact constrained solve ------------------------------------------------------


def _constrained_toy(pkg="torch"):
    """A 3-pose chain, pose 0 pinned EXACTLY (NonlinearEquality semantics),
    in either package."""
    if pkg == "torch":
        graph, values, f = TGraph(device="cpu"), TValues(device="cpu"), t_factors
        noise_, arr = t_noise, np.asarray
    else:
        graph, values, f, noise_, arr = JGraph(), JValues(), j_factors, j_noise, jnp.asarray
    eq_sqrt, eq_mask = noise_.constrained_all(3)
    odo = noise_.diagonal_sigmas(np.array([0.2, 0.2, 0.1]))
    anchor = np.array([1.0, 2.0, 0.3])
    graph.add(f.prior_factor("Pose2"), [0], arr(anchor), eq_sqrt, constrained_mask=eq_mask)
    graph.add(f.between_factor("Pose2"), [0, 1], arr([2.0, 0.0, 0.0]), odo)
    graph.add(f.between_factor("Pose2"), [1, 2], arr([2.0, 0.0, np.pi / 2]), odo)
    for k, x in ((0, [0.5, 1.0, 0.2]), (1, [2.3, 0.1, -0.2]), (2, [4.1, 0.1, np.pi / 2 + 0.1])):
        values.insert(k, "Pose2", arr(x))
    return graph, values, anchor


def _at(values, k):
    return np.asarray(values.at(k))


def test_lse_matches_kkt_oracle(rng):
    """Nullspace LSE = the direct KKT solve on a random dense problem."""
    D, m, nc = 9, 30, 4
    A = rng.standard_normal((m, D))
    b = rng.standard_normal(m)
    C = rng.standard_normal((nc, D))
    d = rng.standard_normal(nc)
    H, g = A.T @ A, A.T @ b
    x, _ = t_qr.solve_lse(t64(H), t64(g), t64(C), t64(d))
    KKT = np.block([[H, C.T], [C, np.zeros((nc, nc))]])
    x_ref = np.linalg.solve(KKT, np.concatenate([g, d]))[:D]
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-9)
    np.testing.assert_allclose(C @ x.numpy(), d, atol=1e-10)


@pytest.mark.parametrize("lam, damping", [(0.0, False), (1e-3, False), (0.5, True)])
def test_solve_lse_matches_jax(lam, damping):
    rng = np.random.default_rng(7)
    D, m, nc = 12, 40, 5
    A = rng.standard_normal((m, D))
    C = rng.standard_normal((nc, D))
    H, g, d = A.T @ A, A.T @ rng.standard_normal(m), rng.standard_normal(nc)
    xj, lj = j_qr.solve_lse(*map(jnp.asarray, (H, g, C, d)), lam, diagonal_damping=damping)
    xt, lt = t_qr.solve_lse(*map(t64, (H, g, C, d)), lam, diagonal_damping=damping)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    np.testing.assert_allclose(C @ xt.numpy(), d, atol=1e-10)
    # a redundant constraint (the pinv branch): still feasible. The null
    # space then holds a direction QR picks by rounding, so the optimum
    # within it is the implementation's, not compared with JAX's
    C2, d2 = np.vstack([C, C[0] + C[1]]), np.append(d, d[0] + d[1])
    x2, _ = t_qr.solve_lse(*map(t64, (H, g, C2, d2)), lam, diagonal_damping=damping)
    np.testing.assert_allclose(C2 @ x2.numpy(), d2, atol=1e-10)


def test_constraint_exact_vs_penalty():
    """The sigma==0 pin holds to ~1e-12 on the exact path; the penalty
    version of the same problem agrees on the free poses."""
    graph, values, anchor = _constrained_toy()
    res = t_opt.gauss_newton(graph, values, t_opt.OptimizerParams(solver="dense"), device="cpu")
    np.testing.assert_allclose(_at(res.values, 0), anchor, atol=1e-10)

    graph_p = TGraph(device="cpu")
    pen = t_noise.diagonal_sigmas(np.array([0.0, 0.0, 0.0]))  # mu = 1e4
    odo = t_noise.diagonal_sigmas(np.array([0.2, 0.2, 0.1]))
    graph_p.add(t_factors.prior_factor("Pose2"), [0], anchor, pen)
    graph_p.add(t_factors.between_factor("Pose2"), [0, 1], np.array([2.0, 0.0, 0.0]), odo)
    graph_p.add(t_factors.between_factor("Pose2"), [1, 2], np.array([2.0, 0.0, np.pi / 2]), odo)
    v2 = TValues(device="cpu")
    for i, x in [(0, [0.5, 1.0, 0.2]), (1, [2.3, 0.1, -0.2]), (2, [4.1, 0.1, 1.67])]:
        v2.insert(i, "Pose2", np.asarray(x))
    res_p = t_opt.gauss_newton(graph_p, v2, t_opt.OptimizerParams(solver="dense"), device="cpu")
    np.testing.assert_allclose(_at(res.values, 1), _at(res_p.values, 1), atol=1e-5)


def test_constrained_lm():
    """LM on the exact path converges and keeps the pin exact."""
    graph, values, anchor = _constrained_toy()
    res = t_opt.levenberg_marquardt(graph, values, t_opt.LMParams(solver="dense"), device="cpu")
    assert res.converged
    np.testing.assert_allclose(_at(res.values, 0), anchor, atol=1e-9)


def test_constrained_lm_matches_jax():
    """The constrained LM (and GN) histories and estimates = the JAX
    package's (1e-10)."""
    jg, jv, anchor = _constrained_toy("jax")
    tg, tv, _ = _constrained_toy()
    jres = j_opt.levenberg_marquardt(jg, jv, j_opt.LMParams(solver="dense"))
    tres = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver="dense"), device="cpu")
    assert len(tres.error_history) == len(jres.error_history)
    np.testing.assert_allclose(tres.error_history, jres.error_history, rtol=1e-10, atol=1e-14)
    for k in range(3):
        np.testing.assert_allclose(_at(tres.values, k), _at(jres.values, k), atol=1e-10)
    # the assembled constrained system itself
    H, g, C, d = t_qr.assemble_constrained(tg.linearize(tv))
    Hj, gj, Cj, dj = j_qr.assemble_constrained(jg.linearize(jv))
    for a, b in ((H, Hj), (g, gj), (C, Cj), (d, dj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    assert t_qr.has_constraints(tg.linearize(tv))


def test_partial_row_constraint():
    """constrained_sigmas: only the sigma==0 rows are exact."""
    sqrt_info, mask = t_noise.constrained_sigmas(np.array([0.0, 0.5, 0.1]))
    assert mask.tolist() == [True, False, False]
    np.testing.assert_allclose(sqrt_info[0, 0], 1.0)
    np.testing.assert_allclose(sqrt_info[1, 1], 2.0)
    graph = TGraph(device="cpu")
    anchor = np.array([1.0, 2.0, 0.3])
    graph.add(t_factors.prior_factor("Pose2"), [0], anchor, sqrt_info, constrained_mask=mask)
    odo = t_noise.diagonal_sigmas(np.array([0.2, 0.2, 0.1]))
    graph.add(t_factors.between_factor("Pose2"), [0, 1], np.array([2.0, 0.0, 0.0]), odo)
    soft = t_noise.diagonal_sigmas(np.array([0.1, 0.1, 0.1]))
    graph.add(t_factors.prior_factor("Pose2"), [0], np.array([5.0, 5.0, 1.0]), soft)
    values = TValues(device="cpu")
    values.insert(0, "Pose2", np.array([0.9, 1.9, 0.25]))
    values.insert(1, "Pose2", np.array([3.0, 2.0, 0.3]))
    res = t_opt.gauss_newton(graph, values, t_opt.OptimizerParams(solver="dense"), device="cpu")
    p0 = _at(res.values, 0)
    assert abs(p0[0] - 1.0) < 1e-6 or abs(p0[1] - 2.0) > 1e-3


def test_qr_solve_rank_deficient(rng):
    """qr_solve returns the minimum-norm solution on a singular system."""
    A = rng.standard_normal((6, 4))
    A[:, 3] = A[:, 0]  # exact rank deficiency
    b = A @ rng.standard_normal(4)
    x = t_qr.qr_solve(t64(A), t64(b)).numpy()
    np.testing.assert_allclose(A @ x, b, atol=1e-9)
    np.testing.assert_allclose(x, np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-8)
    np.testing.assert_allclose(x, np.asarray(j_qr.qr_solve(jnp.asarray(A), jnp.asarray(b))),
                               atol=1e-10)


def test_nonlinear_equality_helper():
    ft, sq, mask = t_factors.nonlinear_equality("Pose2")
    jft, jsq, jmask = j_factors.nonlinear_equality("Pose2")
    assert ft.name == jft.name
    np.testing.assert_array_equal(sq, np.asarray(jsq))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    graph = TGraph(device="cpu")
    anchor = np.array([0.7, -0.3, 0.2])
    graph.add(ft, [0], anchor, sq, constrained_mask=mask)
    odo = t_noise.diagonal_sigmas(np.array([0.2, 0.2, 0.1]))
    graph.add(t_factors.between_factor("Pose2"), [0, 1], np.array([1.0, 0.0, 0.0]), odo)
    v = TValues(device="cpu")
    v.insert(0, "Pose2", np.array([0.5, 0.0, 0.0]))
    v.insert(1, "Pose2", np.array([1.5, 0.0, 0.0]))
    res = t_opt.gauss_newton(graph, v, t_opt.OptimizerParams(solver="dense"), device="cpu")
    np.testing.assert_allclose(_at(res.values, 0), anchor, atol=1e-9)


# --- the subgraph preconditioner ------------------------------------------------------


@pytest.fixture(scope="module")
def toy12():
    jg, jv = ge._toy_pose3_problem(n_poses=12, dtype=jnp.float64)
    va, fa = jax_to_arrays(jg, jv)
    tg = convert.graph_from_arrays(fa, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    return jg.linearize(jv), tg.linearize(tv)


def test_subgraph_solver_matches_dense(toy12):
    """SubgraphSolver (tree-preconditioned PCG over multifrontal_factor /
    multifrontal_apply) reaches the damped dense solution."""
    _, lg = toy12
    x = t_subgraph.SubgraphSolver(lg).solve(lam=1e-6)
    H, g = t_solve.assemble_dense(lg)
    x_ref = np.linalg.solve(H.numpy() + 1e-6 * np.eye(H.shape[0]), g.numpy())
    np.testing.assert_allclose(t_solve.flatten_delta(lg, x).numpy(), x_ref, atol=1e-8)


def test_subgraph_solver_matches_jax(toy12):
    """The port's SubgraphSolver = the JAX package's on the same system
    (solution 1e-8); the trees are equal where every edge weight is equal
    bit for bit (else an ulp can pick another tree)."""
    jlg, lg = toy12
    jsol, tsol = j_subgraph.SubgraphSolver(jlg), t_subgraph.SubgraphSolver(lg)
    xj, xt = jsol.solve(lam=1e-6), tsol.solve(lam=1e-6)
    np.testing.assert_allclose(xt["Pose3"].numpy(), np.asarray(xj["Pose3"]), atol=1e-8)
    wj = [np.asarray(jnp.sum(lb.b * lb.b, axis=-1)) for lb in jlg.batches]
    wt = [torch.sum(lb.b * lb.b, dim=-1).numpy() for lb in lg.batches]
    if all(np.array_equal(a, b) for a, b in zip(wj, wt)):
        for a, b in zip(t_subgraph.build_subgraph(lg), j_subgraph.build_subgraph(jlg)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aug", [0.0, 0.5])
def test_build_subgraph_spans_and_augments(aug):
    """The tree spans the variables (n - 1 edges plus the unary factors);
    augmentation adds that share of the tree's size of the strongest
    off-tree edges; Kruskal on equal-by-construction weights = JAX's."""
    rng = np.random.default_rng(5)
    n, E = 30, 80
    u, v = rng.integers(0, n, E), rng.integers(0, n, E)
    u[: n - 1], v[: n - 1] = np.arange(n - 1), np.arange(1, n)  # connected
    w = rng.random(E).round(2)  # ties: the stable order decides
    np.testing.assert_array_equal(t_subgraph.kruskal_max_spanning_tree(n, u, v, w),
                                  j_subgraph.kruskal_max_spanning_tree(n, u, v, w))
    jg, jv = ge._toy_pose3_problem(n_poses=12, dtype=jnp.float64)
    va, fa = jax_to_arrays(jg, jv)
    lg = convert.graph_from_arrays(fa, device="cpu").linearize(
        convert.values_from_arrays(va, device="cpu"))
    masks = t_subgraph.build_subgraph(lg, t_subgraph.SubgraphBuilderParams(aug))
    n_bin = sum(int(m.sum()) for m, lb in zip(masks, lg.batches) if len(lb.var_types) == 2)
    assert n_bin == min(11 + int(aug * 11), 12)  # 12 edges: 11 odometry, a closure
    assert all(m.all() for m, lb in zip(masks, lg.batches) if len(lb.var_types) == 1)


# --- power methods ------------------------------------------------------------------------


def _spd(rng, n=12):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.concatenate([[10.0, 6.0], np.linspace(0.5, 4.0, n - 3), [0.1]])
    return (Q * ev) @ Q.T, ev


def test_power_methods_match_jax_and_eigvalsh():
    """Each method = the JAX package's (the same iteration: equal iteration
    counts, eigenvalue rel 1e-8); the plain method and the spectral shift
    through it = eigvalsh's extreme eigenvalues (rel 1e-8). The accelerated
    method iterates unit vectors (w = A v - beta v_prev, normalized), and
    with beta estimated (the JAX package's lambda_1^2 / 4) every
    eigenvalue's recurrence root has modulus lambda_1 / 2: it need not
    converge, and is held to JAX, and to eigvalsh where it converged."""
    rng = np.random.default_rng(11)
    A, _ = _spd(rng)
    n = A.shape[0]
    v0 = rng.standard_normal(n)
    At, Aj = t64(A), jnp.asarray(A)
    tmv, jmv = (lambda v: At @ v), (lambda v: Aj @ v)
    ev = np.linalg.eigvalsh(A)
    for name, kw, exact in (("power_method", {}, True),
                            ("accelerated_power_method", {"beta": 1.0}, False),
                            ("accelerated_power_method", {}, False)):
        rt = getattr(t_spectral, name)(tmv, t64(v0), tol=1e-10, max_iters=3000, **kw)
        rj = getattr(j_spectral, name)(jmv, jnp.asarray(v0), tol=1e-10, max_iters=3000, **kw)
        assert rt.iterations == int(rj.iterations) and rt.converged == bool(rj.converged)
        np.testing.assert_allclose(float(rt.eigenvalue), float(rj.eigenvalue), rtol=1e-8)
        if exact or rt.converged:
            assert rt.converged
            np.testing.assert_allclose(float(rt.eigenvalue), ev[-1], rtol=1e-8)
    rt = t_spectral.min_eigenvalue_shifted(tmv, n, t64(v0), tol=1e-10, max_iters=5000)
    rj = j_spectral.min_eigenvalue_shifted(jmv, n, jnp.asarray(v0), tol=1e-10, max_iters=5000)
    np.testing.assert_allclose(float(rt.eigenvalue), float(rj.eigenvalue), rtol=1e-8)
    assert rt.iterations == int(rj.iterations) and rt.converged == bool(rj.converged)
    if rt.converged:
        np.testing.assert_allclose(float(rt.eigenvalue), ev[0], rtol=1e-6)
    # the shift trick itself, by the plain method: lambda_min = eigvalsh's
    shift = 1.01 * ev[-1]
    low = t_spectral.power_method(lambda v: shift * v - At @ v, t64(v0), tol=1e-12,
                                  max_iters=5000)
    assert low.converged
    np.testing.assert_allclose(shift - float(low.eigenvalue), ev[0], rtol=1e-8)


# --- Kalman filter, RTS smoother, EKF -------------------------------------------------------


def test_kf_constant_position():
    """testKalmanFilter.cpp's example: unit motion, repeated measurement."""
    I2 = torch.eye(2, dtype=F64)
    s = t_kalman.init(torch.zeros(2, dtype=F64), 0.01 * I2)
    expected = [[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]
    for t in range(3):
        s = t_kalman.predict(s, I2, I2, t64([1.0, 0.0]), 0.01 * I2)
        s = t_kalman.update(s, I2, t64(expected[t]), 0.01 * I2)
        np.testing.assert_allclose(s.mean.numpy(), expected[t], atol=1e-9)
    assert float(s.cov[0, 0]) < 0.01


def test_kf_variance_growth_and_reduction():
    s = t_kalman.init(torch.zeros(1, dtype=F64), t64([[1.0]]))
    s2 = t_kalman.predict(s, torch.eye(1, dtype=F64), Q=t64([[0.5]]))
    assert float(s2.cov[0, 0]) == 1.5
    s3 = t_kalman.update(s2, torch.eye(1, dtype=F64), t64([0.0]), t64([[1.5]]))
    np.testing.assert_allclose(float(s3.cov[0, 0]), 0.75, atol=1e-12)


def _cv_model(dt=0.1):
    """A 2D constant-velocity model: state (x, y, vx, vy), position measured."""
    F = np.eye(4)
    F[0, 2] = F[1, 3] = dt
    Q = np.diag([1e-4, 1e-4, 1e-2, 1e-2])
    H = np.eye(2, 4)
    R = 0.05 * np.eye(2)
    return F, Q, H, R


def _run_filter(kal, F, Q, H, R, z, x0, P0, stack):
    """Filter a [T, ..., 2] measurement sequence, then smooth; returns the
    filtered, predicted and smoothed states."""
    s = kal.init(x0, P0)
    mf, Pf, mp, Pp = [], [], [], []
    for t in range(z.shape[0]):
        sp = kal.predict(s, F, Q=Q)
        s = kal.update(sp, H, z[t], R)
        mp.append(sp.mean), Pp.append(sp.cov), mf.append(s.mean), Pf.append(s.cov)
    filt = kal.GaussianState(stack(mf), stack(Pf))
    pred = kal.GaussianState(stack(mp), stack(Pp))
    Fs = stack([F] * z.shape[0])
    return filt, pred, kal.smooth_rts(filt, pred, Fs)


def _tracks(rng, T, B):
    F, _, _, _ = _cv_model()
    x = np.zeros((B, 4))
    x[:, 2:] = rng.normal(size=(B, 2))
    zs = []
    for _ in range(T):
        x = x @ F.T + rng.normal(size=(B, 4)) * [0.01, 0.01, 0.1, 0.1]
        zs.append(x[:, :2] + rng.normal(size=(B, 2)) * 0.2)
    return np.stack(zs)


def test_rts_smoother_reduces_variance():
    rng = np.random.default_rng(0)
    T = 20
    x_true = np.cumsum(rng.normal(size=T) * 0.3)
    z = x_true + rng.normal(size=T) * 0.7
    I1 = torch.eye(1, dtype=F64)
    filt, _, sm = _run_filter(t_kalman, I1, t64([[0.1]]), I1, t64([[0.5]]), t64(z[:, None]),
                              torch.zeros(1, dtype=F64), t64([[1.0]]), torch.stack)
    assert np.all(sm.cov.numpy()[:, 0, 0] <= filt.cov.numpy()[:, 0, 0] + 1e-12)
    rmse_f = np.sqrt(np.mean((filt.mean.numpy()[:, 0] - x_true) ** 2))
    rmse_s = np.sqrt(np.mean((sm.mean.numpy()[:, 0] - x_true) ** 2))
    assert rmse_s <= rmse_f * 1.25
    np.testing.assert_allclose(sm.mean.numpy()[-1], filt.mean.numpy()[-1], atol=1e-12)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_kf_rts_match_jax_and_a_batch_of_tracks_equals_the_tracks_one_at_a_time():
    rng = np.random.default_rng(2)
    T, B = 30, 5
    F, Q, H, R = _cv_model()
    z = _tracks(rng, T, B)
    x0, P0 = np.zeros(4), np.eye(4)
    jout = [_run_filter(j_kalman, *map(jnp.asarray, (F, Q, H, R)), jnp.asarray(z[:, b]),
                        jnp.asarray(x0), jnp.asarray(P0), jnp.stack) for b in range(2)]
    tb = _run_filter(t_kalman, *map(t64, (F, Q, H, R)), t64(z),
                     t64(np.broadcast_to(x0, (B, 4))), t64(np.broadcast_to(P0, (B, 4, 4))),
                     torch.stack)
    for b in range(B):
        one = _run_filter(t_kalman, *map(t64, (F, Q, H, R)), t64(z[:, b]), t64(x0), t64(P0),
                          torch.stack)
        for st_b, st_1 in zip(tb, one):
            assert _rel(st_b.mean[:, b].numpy(), st_1.mean.numpy()) <= 1e-13
            assert _rel(st_b.cov[:, b].numpy(), st_1.cov.numpy()) <= 1e-13
        if b < 2:
            for st_t, st_j in zip(one, jout[b]):
                assert _rel(st_t.mean.numpy(), st_j.mean) <= 1e-12
                assert _rel(st_t.cov.numpy(), st_j.cov) <= 1e-12


def _ekf_run(pkg, steps=10):
    """tests/test_kalman.py::test_ekf_pose2_localization's loop, in either
    package; returns the belief and the true pose."""
    rng = np.random.default_rng(1)
    if pkg == "torch":
        ekf, pose2, arr = t_ekf, t_pose2, t64
    else:
        ekf, pose2, arr = j_ekf, j_pose2, (lambda a: jnp.asarray(a, dtype=jnp.float64))
    x = arr([0.0, 0.0, 0.0])
    belief = ekf.ManifoldBelief(x, arr(0.01 * np.eye(3)))
    odo = arr([1.0, 0.0, 0.1])
    Q, R = arr(0.001 * np.eye(3)), arr(0.01 * np.eye(2))
    for _ in range(steps):
        x = pose2.compose(x, odo)
        belief = ekf.predict(belief, "Pose2", lambda p: pose2.compose(p, odo), Q)
        z = x[:2] + arr(rng.normal(size=2) * 0.01)
        belief = ekf.update(belief, "Pose2", lambda p: p[:2], z, R)
    return belief, x


def test_ekf_pose2_localization():
    belief, x = _ekf_run("torch")
    err = t_pose2.local(belief.value, x).numpy()
    assert np.linalg.norm(err) < 0.15, err
    assert float(torch.trace(belief.cov)) < 0.1


def test_ekf_matches_jax():
    tb, _ = _ekf_run("torch")
    jb, _ = _ekf_run("jax")
    assert _rel(tb.value.numpy(), jb.value) <= 1e-12
    assert _rel(tb.cov.numpy(), jb.cov) <= 1e-12


# --- the sampler ----------------------------------------------------------------------------


def test_sampler_covariance():
    gen = torch.Generator().manual_seed(0)
    sig = t64([0.5, 2.0, 1.0])
    eps = t_sampler.sample_diagonal(gen, sig, shape=(20000,))
    assert eps.shape == (20000, 3)
    cov = np.cov(eps.numpy().T)
    np.testing.assert_allclose(np.diag(cov), sig.numpy() ** 2, rtol=0.1)
    R = t64([[2.0, 0.5, 0], [0, 1.0, -0.3], [0, 0, 4.0]])
    eps2 = t_sampler.sample_sqrt_info(gen, R, shape=(40000,))
    cov2 = np.cov(eps2.numpy().T)
    Sigma = np.linalg.inv(R.numpy().T @ R.numpy())
    np.testing.assert_allclose(cov2, Sigma, atol=0.05 * np.abs(Sigma).max() + 0.005)


def test_sqrt_info_transform_matches_jax_formula():
    """Given the same standard normal draws, the port's transform = the JAX
    formula solve(broadcast R, z) (1e-13); a batched R alike."""
    rng = np.random.default_rng(4)
    R = np.triu(rng.normal(size=(6, 6))) + 3 * np.eye(6)
    z = rng.normal(size=(7, 5, 6))
    ref = np.asarray(jnp.linalg.solve(jnp.broadcast_to(jnp.asarray(R), (7, 5, 6, 6)),
                                      jnp.asarray(z)[..., None])[..., 0])
    np.testing.assert_allclose(t_sampler.sqrt_info_transform(t64(R), t64(z)).numpy(), ref,
                               atol=1e-13)
    Rb = R + rng.normal(size=(5, 6, 6)) * 0.1
    refb = np.asarray(jnp.linalg.solve(jnp.broadcast_to(jnp.asarray(Rb), (7, 5, 6, 6)),
                                       jnp.asarray(z)[..., None])[..., 0])
    np.testing.assert_allclose(t_sampler.sqrt_info_transform(t64(Rb), t64(z)).numpy(), refb,
                               atol=1e-13)
