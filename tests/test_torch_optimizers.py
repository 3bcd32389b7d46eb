"""What the port's first slice deferred, against the JAX package: the
quaternion / Pose2 helpers, `linear/solve.py`'s block diagonal, linear
error and PCG, the `solver="pcg"` LM, `inference/kernels.py`'s forward
solve and triangular inverse, the multifrontal solve's log-determinant and
its factor / apply split, dogleg, nonlinear CG and mixed-precision
Gauss-Newton.

Same numpy inputs (made from a seed) in both packages, the port on the
CPU in float64. Tolerances: geometry and the linear algebra on one system
atol 1e-12 / rel 1e-10 (the same operations in another order); iterative
results (PCG deltas, optimizer histories) rel 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.inference import kernels as t_kern
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.models import ba_synth as t_synth
from gtsam_petercdev_torch.models import bundle_adjustment as t_ba
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.geometry import so3 as j_so3
from gtsam_petercdev_tpu.inference import elimination as j_elim
from gtsam_petercdev_tpu.inference import kernels as j_kern
from gtsam_petercdev_tpu.linear import solve as j_solve
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from test_torch_factor_graph import both, jax_linearize, pose2_problem, pose3_rings


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(name):
    """A graph as numpy arrays. "pose2": 20 poses, 6 loop closures, its
    between measurements perturbed by N(0, 0.05^2), so the optimum's error
    stands well above rounding and histories compare relatively."""
    if name == "pose3_rings":
        return pose3_rings()
    rng = np.random.default_rng(42)
    values, factors = pose2_problem(rng, 20, 6)
    factors = [(n, k, p + rng.normal(size=p.shape) * 0.05 if n.startswith("Between") else p, si)
               for n, k, p, si in factors]
    return values, factors


def _flat(d):
    return np.concatenate([np.asarray(d[t]).reshape(-1) for t in sorted(d)])


# --- geometry helpers ------------------------------------------------------------


def test_quaternion_rpy_and_pose2_helpers_match_jax():
    """so3.to_quaternion / from_quaternion / rpy (each Shepperd branch) and
    pose2.bearing / range_to equal JAX's (atol 1e-12); the round trip
    returns the rotation."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)) * 2.0
    w[:4] = [[np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, np.pi - 1e-3], [0, 0, 0]]
    R = t_so3.expmap(torch.tensor(w))
    Rj = jnp.asarray(R.numpy())
    q = t_so3.to_quaternion(R)
    np.testing.assert_allclose(q.numpy(), np.asarray(j_so3.to_quaternion(Rj)), atol=1e-12)
    np.testing.assert_allclose(t_so3.from_quaternion(q).numpy(), R.numpy(), atol=1e-12)
    qr = rng.normal(size=(16, 4))
    np.testing.assert_allclose(t_so3.from_quaternion(torch.tensor(qr)).numpy(),
                               np.asarray(j_so3.from_quaternion(jnp.asarray(qr))), atol=1e-12)
    np.testing.assert_allclose(t_so3.rpy(R).numpy(), np.asarray(j_so3.rpy(Rj)), atol=1e-12)
    p, pt = rng.normal(size=(16, 3)), rng.normal(size=(16, 2)) * 5
    for name in ("bearing", "range_to"):
        np.testing.assert_allclose(
            getattr(t_pose2, name)(torch.tensor(p), torch.tensor(pt)).numpy(),
            np.asarray(getattr(j_pose2, name)(jnp.asarray(p), jnp.asarray(pt))), atol=1e-12)


# --- linear/solve.py ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["pose2", "pose3_rings"])
def test_block_diagonal_error_and_pcg_match_jax(name):
    """hessian_block_diagonal and the linear error (atol 1e-12 / rel 1e-10)
    and the damped block-Jacobi pcg_solve delta (rel 1e-8), in both damping
    modes, equal JAX's; the delta solves the dense system; the generic pcg
    with the same operator gives the same delta; flatten_arrays lists
    every batch's (A, b)."""
    jg, jv, tg, tv = both(*_problem(name))
    jl, tl = jax_linearize(jg, jv), tg.linearize(tv)
    assert [(a, b) for a, b in tl.flatten_arrays()] == [(lb.A, lb.b) for lb in tl.batches]
    bj, bt = j_solve.hessian_block_diagonal(jl), t_solve.hessian_block_diagonal(tl)
    for t in bt:
        assert _rel(bt[t], bj[t]) < 1e-10
    rng = np.random.default_rng(1)
    delta = {t: rng.normal(size=(n, b.shape[-1])) for t, (n, b) in
             ((t, (tl.type_counts[t], bt[t])) for t in bt)}
    ej = j_solve.error(jl, {t: jnp.asarray(v) for t, v in delta.items()})
    et = t_solve.error(tl, {t: torch.tensor(v) for t, v in delta.items()})
    assert abs(float(et) - float(ej)) <= 1e-10 * abs(float(ej))
    H, g = t_solve.assemble_dense(tl)
    for lam, damping in ((1e-3, False), (0.1, True)):
        xj = j_solve.pcg_solve(jl, lam, damping)
        xt = t_solve.pcg_solve(tl, lam, damping)
        assert _rel(_flat(xt), _flat(xj)) < 1e-8
        xd = t_solve.dense_solve(H, g, lam, diagonal_damping=damping)
        assert _rel(t_solve.flatten_delta(tl, xt), xd) < 1e-6
    Minv = {t: torch.linalg.inv(bt[t] + 1e-3 * torch.eye(bt[t].shape[-1], dtype=H.dtype))
            for t in bt}
    xg = t_solve.pcg(lambda v: {t: x + 1e-3 * v[t] for t, x in t_solve.hvp(tl, v).items()},
                     t_solve.gradient(tl),
                     lambda r: {t: torch.einsum("nij,nj->ni", Minv[t], r[t]) for t in r},
                     tol=1e-10)
    assert _rel(_flat(xg), _flat(t_solve.pcg_solve(tl, 1e-3))) < 1e-8


def test_lm_pcg_solver_matches_jax():
    """levenberg_marquardt with solver="pcg" follows JAX's history (rel
    1e-8) and its first step is the multifrontal step (rel 1e-6)."""
    jg, jv, tg, tv = both(*_problem("pose2"))
    params = dict(solver="pcg", max_iterations=8)
    jr = j_opt.levenberg_marquardt(jg, jv, j_opt.LMParams(**params))
    tr = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(**params), device="cpu")
    assert tr.iterations == jr.iterations
    np.testing.assert_allclose(tr.error_history, jr.error_history, rtol=1e-8)
    dp, _ = t_opt._build_fns(tg, t_opt.LMParams(solver="pcg"))[2](tv, 1e-5, {})
    dm, _ = t_elim.solve_linearized(tg, tv, 1e-5)
    assert _rel(_flat(dp), _flat(dm)) < 1e-6


# --- inference/kernels.py and the multifrontal factor / apply --------------------------


def test_forward_solve_and_tri_lower_inv_match_jax():
    """forward_solve_bucket and tri_lower_inv on the factor of a random SPD
    bucket equal JAX's (atol 1e-12) and invert L."""
    rng = np.random.default_rng(2)
    B, nf, ns, d = 5, 3, 2, 6
    m = (nf + ns) * d
    A = rng.normal(size=(B, m, m))
    F = torch.tensor(A @ A.transpose(0, 2, 1) / m + np.eye(m))
    out = t_kern.partial_cholesky(F, torch.zeros(B, m, dtype=torch.float64), nf, d)
    L, Linv = out["L"], out["Linv"]
    rhs = rng.normal(size=(B, nf * d))
    yt = t_kern.forward_solve_bucket(L, Linv, torch.tensor(rhs), nf, d)
    yj = j_kern.forward_solve_bucket(jnp.asarray(L.numpy()), jnp.asarray(Linv.numpy()),
                                     jnp.asarray(rhs), nf, d)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-12)
    np.testing.assert_allclose((L @ yt[..., None])[..., 0].numpy(), rhs, atol=1e-12)
    Zt = t_kern.tri_lower_inv(L, Linv, nf, d)
    Zj = j_kern.tri_lower_inv(jnp.asarray(L.numpy()), jnp.asarray(Linv.numpy()), nf, d)
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=1e-12)
    np.testing.assert_allclose((Zt @ L).numpy(), np.broadcast_to(np.eye(nf * d), Zt.shape),
                               atol=1e-12)


def _ba_rig():
    data = t_synth.make_synthetic_ba(8, 60, 4, seed=1, dtype=np.float64)
    return t_ba.build_ba_graph(data, device="cpu")


@pytest.mark.parametrize("name", ["pose2", "pose3_rings", "ba_rig"])
def test_factor_apply_equals_solve_and_logdet(name):
    """multifrontal_factor then multifrontal_apply of J^T b gives the delta
    multifrontal_solve gives (rel 1e-10; the BA rig mixes 9- and 3-dim
    variables, padded to d = 9); return_logdet gives slogdet of the dense
    damped H (rel 1e-10) and JAX's log-determinant."""
    if name == "ba_rig":
        tg, tv = _ba_rig()
        lam = 1e-3
    else:
        jg, jv, tg, tv = both(*_problem(name))
        lam = 1e-3 if name == "pose2" else 0.0
    lg = tg.linearize(tv)
    _, maps = t_elim._graph_plan(tg, lg)
    Ab = tuple((lb.A, lb.b) for lb in lg.batches)
    x, stats = t_elim.multifrontal_solve(maps, Ab, lam, return_logdet=True)
    d = maps.plan.d
    g = t_solve.gradient(lg)
    r = torch.cat([torch.nn.functional.pad(g[t], (0, d - g[t].shape[1])) for t in sorted(g)])
    chol = t_elim.multifrontal_factor(maps, Ab, lam)
    assert len(chol) == len(maps.buckets)
    xa = t_elim.multifrontal_apply(maps, chol, r)
    assert _rel(xa, x) < 1e-10
    assert _rel(t_elim.multifrontal_apply(maps, chol, 2.0 * r), 2.0 * x) < 1e-10
    H, _ = t_solve.assemble_dense(lg)
    sign, ld = torch.linalg.slogdet(H + lam * torch.eye(H.shape[0], dtype=H.dtype))
    # the padded fake dims of 3-dim points carry identity + lam pivots
    n_fake = sum(n * (d - (9 if t == "SfmCamera" else 3 if t == "Point3" else d))
                 for t, n in lg.type_counts.items())
    assert float(sign) == 1.0
    assert abs(float(stats["logdet"]) - float(ld) - n_fake * np.log1p(lam)) <= 1e-10 * abs(float(ld))
    if name != "ba_rig":
        jl = jax_linearize(jg, jv)
        t = next(iter(jl.type_counts))
        plan = j_elim.build_plan_for_graph([(lb.rows, t) for lb in jl.batches],
                                           jl.type_counts[t], d)
        jmaps = j_elim.build_numeric_maps(plan, jl)
        _, js = jax.jit(lambda Ab: j_elim._multifrontal_solve_impl(
            jmaps, Ab, lam, return_logdet=True))(tuple((lb.A, lb.b) for lb in jl.batches))
        assert abs(float(stats["logdet"]) - float(js["logdet"])) <= 1e-10 * abs(float(ld))


def test_clear_plan_cache_forgets_plans():
    """clear_plan_cache drops every graph's cached plan; the next solve
    plans anew and gives the same delta."""
    _, _, tg, tv = both(*_problem("pose2"))
    d1, _ = t_elim.solve_linearized(tg, tv, 1e-3)
    assert tg.__dict__.get("_mf_plans")
    t_elim.clear_plan_cache()
    assert not tg.__dict__.get("_mf_plans")
    d2, _ = t_elim.solve_linearized(tg, tv, 1e-3)
    assert _rel(_flat(d2), _flat(d1)) == 0.0


# --- optimizers -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pose2", "pose3_rings"])
def test_dogleg_and_ncg_histories_match_jax(name):
    """dogleg (two trust radii) and nonlinear CG: the port's error
    histories equal JAX's (rel 1e-8); dogleg reaches Gauss-Newton's error
    (GN stops on its relative tolerance, so dogleg may end lower)."""
    jg, jv, tg, tv = both(*_problem(name))
    for radius in (1.0, 1e-2):
        jr = j_opt.dogleg(jg, jv, j_opt.DoglegParams(delta_initial=radius, max_iterations=50))
        tr = t_opt.dogleg(tg, tv, t_opt.DoglegParams(delta_initial=radius, max_iterations=50),
                          device="cpu")
        assert len(tr.error_history) == len(jr.error_history)
        np.testing.assert_allclose(tr.error_history, jr.error_history, rtol=1e-8)
    gn = t_opt.gauss_newton(tg, tv, t_opt.OptimizerParams(max_iterations=20), device="cpu")
    assert tr.error <= gn.error * (1 + 1e-8)
    jr = j_opt.nonlinear_conjugate_gradient(jg, jv, j_opt.OptimizerParams(max_iterations=30))
    tr = t_opt.nonlinear_conjugate_gradient(tg, tv, t_opt.OptimizerParams(max_iterations=30),
                                            device="cpu")
    assert len(tr.error_history) == len(jr.error_history) and tr.error < tr.error_history[0]
    np.testing.assert_allclose(tr.error_history, jr.error_history, rtol=1e-8)


def _square(dtype):
    """The JAX test's 4-pose square with a loop closure and a noisy start
    (tests/test_optimizers_extra.py)."""
    rng = np.random.default_rng(7)
    gt = [np.array([0.0, 0.0, 0.0]), np.array([2.0, 0.0, np.pi / 2]),
          np.array([2.0, 2.0, np.pi]), np.array([0.0, 2.0, -np.pi / 2])]
    graph, values = TGraph(device="cpu", dtype=dtype), TValues(device="cpu", dtype=dtype)
    for i, p in enumerate(gt):
        eps = torch.tensor(rng.normal(size=3) * 0.2)
        values.insert(i, "Pose2", t_pose2.retract(torch.tensor(p), eps) if i else p)
    graph.add(t_factors.prior_factor("Pose2"), [0], gt[0], t_noise.isotropic(3, 0.01, np.float64))
    for i in range(4):
        j = (i + 1) % 4
        graph.add(t_factors.between_factor("Pose2"), [i, j],
                  t_pose2.between(torch.tensor(gt[i]), torch.tensor(gt[j])),
                  t_noise.isotropic(3, 0.1, np.float64))
    return graph, values


@pytest.mark.parametrize("name", ["square", "pose3_rings"])
def test_mixed_precision_reaches_f64_optimum(name):
    """float32 factorization (the graph on the device) + float64 residual
    and retract on the host reach the float64 Gauss-Newton optimum, as the
    JAX test holds it (<= ref + 1e-10); the state stays float64."""
    if name == "square":
        g64, v64 = _square(torch.float64)
        g32, _ = _square(torch.float32)
    else:
        va, fa = pose3_rings()
        from gtsam_petercdev_torch.utils import convert

        g64 = convert.graph_from_arrays(fa, device="cpu")
        v64 = convert.values_from_arrays(va, device="cpu")
        g32 = convert.graph_from_arrays(fa, device="cpu", dtype=torch.float32)
    ref = t_opt.gauss_newton(g64, v64, t_opt.OptimizerParams(max_iterations=20), device="cpu")
    res = t_opt.gauss_newton_mixed_precision(g32, g64, v64,
                                             t_opt.OptimizerParams(max_iterations=20),
                                             device="cpu")
    assert res.error <= ref.error + 1e-10
    assert res.values.dtype == torch.float64 and res.values.device.type == "cpu"


def test_new_optimizers_raise_without_cuda():
    """No CPU fallback: dogleg, NCG and mixed precision default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, v = _square(torch.float64)
    for fn in (t_opt.dogleg, t_opt.nonlinear_conjugate_gradient):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(g, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_opt.gauss_newton_mixed_precision(g, g, v)
