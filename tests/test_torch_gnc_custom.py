"""The port's GNC and custom / linear-container factors against the JAX
package's (nonlinear/gnc.py, nonlinear/custom.py).

Inputs come from np.random.default_rng(seed) (or are the JAX tests' own
scenes) and go through both packages; the port runs on the CPU in float64
unless stated. Tolerances: chi2 quantiles equal (both scipy); the TLS / GM
weight rules atol 1e-15; GNC weights and poses atol 1e-9 with equal outer
iterations (the same dense inner solve, rounding apart); the custom factor's
LM solution atol 1e-8; a float32 custom linearization within 1e-5 (rel) of
the float64 one; the linear-container GN atol 1e-10 (JAX) and 1e-8 ([3.5,
3.5]); a carried graph's error and residuals rel 1e-12. The JAX tests
mirrored: tests/test_smart_marginals_gnc.py (GNC, chi2) and
tests/test_utils_extra.py (TestCustomFactor, TestLinearContainer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.nonlinear import custom as t_custom
from gtsam_petercdev_torch.nonlinear import fixed_lag as t_fixed_lag
from gtsam_petercdev_torch.nonlinear import gnc as t_gnc
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.nonlinear import custom as j_custom
from gtsam_petercdev_tpu.nonlinear import fixed_lag as j_fixed_lag
from gtsam_petercdev_tpu.nonlinear import gnc as j_gnc
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- chi2 and the weight rules ---------------------------------------------------


@pytest.mark.parametrize("dof,alpha", [(3, 0.99), (6, 0.99), (1, 0.95), (12, 0.9)])
def test_chi_squared_quantile(dof, alpha):
    q = t_gnc.chi_squared_quantile(dof, alpha)
    assert q == j_gnc.chi_squared_quantile(dof, alpha)
    if (dof, alpha) == (3, 0.99):
        assert abs(q - 11.345) < 0.01, q  # standard tables


@pytest.mark.parametrize("rule", ["tls", "gm"])
def test_weight_rules(rule):
    rng = np.random.default_rng(3)
    r2 = np.concatenate([rng.exponential(20.0, size=200), [0.0, 1e-40, 1e6]])
    for mu in (1e-4, 0.05, 1.0, 3.7, 250.0):
        for barc in (7.81, 16.81):
            j = getattr(j_gnc, f"_update_weights_{rule}")(jnp.asarray(r2), jnp.asarray(mu),
                                                         jnp.asarray(barc))
            t = getattr(t_gnc, f"_update_weights_{rule}")(torch.tensor(r2), mu, barc)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-15)


# --- GNC on the JAX test's Pose2 chain with a wrong loop closure -------------------


def _chain_outlier_scene(n=6, sigma=0.05):
    """tests/test_smart_marginals_gnc.py's scene: a Pose2 chain (start drawn
    from seed 5), skip connections i -> i+2, a wrong closure 0 -> 5."""
    rng = np.random.default_rng(5)
    gt = [np.array([float(i), 0.0, 0.0]) for i in range(n)]
    init = [np.asarray(j_pose2.retract(jnp.asarray(p), jnp.asarray(rng.normal(size=3) * 0.1)))
            for p in gt]
    between = lambda a, b: np.asarray(j_pose2.between(jnp.asarray(gt[a]), jnp.asarray(gt[b])))
    fs = [("Prior", [0], gt[0], 0.01)]
    fs += [("Between", [i, i + 1], between(i, i + 1), sigma) for i in range(n - 1)]
    fs += [("Between", [i, i + 2], between(i, i + 2), 0.05) for i in range(4)]
    fs.append(("Between", [0, 5], np.array([1.0, 3.0, 1.5]), 0.05))
    return init, fs, gt


def _both_graphs(init, fs, type_name="Pose2"):
    jg, jv = JGraph(), JValues()
    tg, tv = TGraph(device="cpu"), TValues(device="cpu")
    for k, p in enumerate(init):
        jv.insert(k, type_name, jnp.asarray(p))
        tv.insert(k, type_name, p)
    for kind, keys, m, s in fs:
        jf = getattr(j_factors, kind.lower() + "_factor")(type_name)
        tf = getattr(t_factors, kind.lower() + "_factor")(type_name)
        jg.add(jf, keys, jnp.asarray(m), j_noise.isotropic(3, s, jnp.float64))
        tg.add(tf, keys, m, np.eye(3) / s)
    return jg, jv, tg, tv


@pytest.mark.parametrize("loss,pinned", [("tls", "none"), ("tls", "odometry"), ("gm", "odometry")])
def test_gnc_pose2_chain(loss, pinned):
    init, fs, gt = _chain_outlier_scene()
    jg, jv, tg, tv = _both_graphs(init, fs)
    known = {"none": {}, "odometry": {0: np.array([True]), 1: np.arange(10) < 5}}[pinned]
    jr = j_gnc.gnc(jg, jv, j_gnc.GncParams(loss_type=loss, known_inliers=known))
    tr = t_gnc.gnc(tg, tv, t_gnc.GncParams(loss_type=loss,
                                           known_inliers=convert.gnc_known_inliers(known)),
                   device="cpu")
    assert tr.iterations == jr.iterations
    for a, b in zip(tr.weights, jr.weights):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    for a, b in zip(tr.inliers, jr.inliers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.values.params("Pose2").numpy(),
                               np.asarray(jr.values.params("Pose2")), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.error, jr.error, rtol=1e-6, atol=1e-12)
    if loss == "tls":
        # the JAX test's claims: the wrong closure rejected, the chain kept
        assert tr.weights[1][-1] < 0.5
        for i, p in enumerate(gt):
            assert np.abs(tr.values.params("Pose2")[i].numpy() - p).max() < 0.05


def test_gnc_batch_order_matches_jax():
    """known_inliers is keyed by batch index: staging three factor families
    (prior, between, robust between) in an interleaved order gives the same
    batches, in the same order and with the same rows, as the JAX package's
    graph (`_materialize`'s staging order)."""
    from gtsam_petercdev_torch.linear import noise as t_noise

    rng = np.random.default_rng(8)
    jg, tg = JGraph(), TGraph(device="cpu")
    for _ in range(12):
        kind = ("Between", "Prior", "BetweenRobust")[rng.integers(3)]
        a = int(rng.integers(5))
        m = rng.normal(size=3) * 0.1
        if kind == "Prior":
            jg.add(j_factors.prior_factor("Pose2"), [a], jnp.asarray(m), jnp.eye(3))
            tg.add(t_factors.prior_factor("Pose2"), [a], m, np.eye(3))
        else:
            robust = kind == "BetweenRobust"
            jg.add(j_factors.between_factor("Pose2"), [a, a + 1], jnp.asarray(m), jnp.eye(3),
                   j_noise.huber(1.0) if robust else None)
            tg.add(t_factors.between_factor("Pose2"), [a, a + 1], m, np.eye(3),
                   t_noise.huber(1.0) if robust else None)
    jg._materialize()
    tg._materialize()
    assert len(tg.batches) == len(jg.batches) == 3
    for bj, bt in zip(jg.batches, tg.batches):
        assert bt.ftype.name == bj.ftype.name
        assert (bt.robust is None) == (bj.robust is None)
        np.testing.assert_array_equal(bt.keys, np.asarray(bj.keys))
        np.testing.assert_allclose(bt.params.numpy(), np.asarray(bj.params), rtol=0, atol=0)


def test_gnc_on_outlier_sphere():
    """sphere_rings_outliers at a small size: port GNC-TLS (the prior and the
    odometry pinned) against the JAX package's, and the weights < 0.5 pick
    the corrupted loop closures."""
    va, plain, _, truth, outliers = synthetic.sphere_rings_outliers(3, 6, seed=0, share=0.2)
    from test_torch_factor_graph import jax_from_arrays

    jg, jv = jax_from_arrays(va, plain)
    tg = convert.graph_from_arrays(plain, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    known = {0: np.ones(1, dtype=bool), 1: np.ones(len(plain[1][1]), dtype=bool)}
    jr = j_gnc.gnc(jg, jv, j_gnc.GncParams(known_inliers=known))
    tr = t_gnc.gnc(tg, tv, t_gnc.GncParams(known_inliers=known), device="cpu")
    assert tr.iterations == jr.iterations
    for a, b in zip(tr.weights, jr.weights):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    p, q = tr.values.params("Pose3"), jr.values.params("Pose3")
    np.testing.assert_allclose(p.R.numpy(), np.asarray(q.R), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(q.t), rtol=0, atol=1e-9)
    flagged = np.flatnonzero(tr.weights[2].numpy() < 0.5)
    np.testing.assert_array_equal(flagged, outliers)


# --- custom factors ---------------------------------------------------------------


def _range_err_jax(xs, params):
    (p,) = xs
    return (jnp.sqrt(p[0] ** 2 + p[1] ** 2) - params)[None]


def _range_err_torch(xs, params):
    (p,) = xs
    return (torch.sqrt(p[0] ** 2 + p[1] ** 2) - params)[None]


def test_custom_factor_range_to_origin():
    """tests/test_utils_extra.py::TestCustomFactor: a custom Pose2 range
    factor under LM, port against the JAX package."""
    jft = j_custom.custom_factor("RangeToOrigin", ("Pose2",), 1, _range_err_jax)
    tft = t_custom.custom_factor("RangeToOrigin", ("Pose2",), 1, _range_err_torch)
    jg, jv = JGraph(), JValues()
    tg, tv = TGraph(device="cpu"), TValues(device="cpu")
    jv.insert(0, "Pose2", j_pose2.make(2.0, 1.0, 0.3))
    tv.insert(0, "Pose2", np.array([2.0, 1.0, 0.3]))
    jg.add(jft, [0], jnp.asarray(5.0), j_noise.isotropic(1, 0.1, jnp.float64))
    tg.add(tft, [0], 5.0, np.eye(1) / 0.1)
    jr = j_opt.levenberg_marquardt(jg, jv)
    tr = t_opt.levenberg_marquardt(tg, tv, device="cpu")
    p = tr.values.at(0).numpy()
    assert np.hypot(p[0], p[1]) == pytest.approx(5.0, abs=1e-6)
    np.testing.assert_allclose(p, np.asarray(jr.values.at(0)), rtol=0, atol=1e-8)
    assert tr.iterations == jr.iterations


def test_custom_factor_float32_linearization():
    """A float32 custom factor linearizes in float32 (the callback vmapped
    inside one forward-mode call over the batch), within float32 rounding
    of the float64 linearization."""
    rng = np.random.default_rng(4)
    starts = rng.normal(size=(7, 3)) + np.array([2.0, 1.0, 0.0])
    ranges = rng.uniform(3.0, 6.0, size=7)
    ft = t_custom.custom_factor("RangeToOrigin", ("Pose2",), 1, _range_err_torch)
    out = {}
    for dt in (torch.float32, torch.float64):
        g, v = TGraph(device="cpu", dtype=dt), TValues(device="cpu", dtype=dt)
        v.insert_batch(range(7), "Pose2", starts)
        g.add_batch(ft, np.arange(7)[:, None], ranges, np.broadcast_to(np.eye(1) * 10, (7, 1, 1)))
        lb = g.linearize(v).batches[0]
        assert lb.A[0].dtype == dt and lb.b.dtype == dt and g.error(v).dtype == dt
        out[dt] = (lb.A[0].double(), lb.b.double())
    for a, b in zip(out[torch.float32], out[F64]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def _pose3_between_err(xs, measured):
    """One Pose3 between factor's residual through the port's own functions
    (no analytic Jacobian: forward mode over the batch)."""
    x1, x2 = xs
    return t_pose3.local(measured, t_pose3.between(x1, x2))


def test_custom_pose3_between_matches_builtin():
    """The sphere's between factors re-expressed as a custom factor reach
    the built-in batch's error (LM, the multifrontal solver, both run to
    tolerance 1e-10): the phase-14 d) check at a small size (port only).
    The built-in factor linearizes without the chart's Local term (the
    GTSAM-compatible Jacobian), so its fixed point sits a little above the
    cost's minimum (rel 5.3e-6 here): the custom factor, differentiated
    through its cost, ends at or below it, within rel 1e-4."""
    va, fa = synthetic.sphere_rings(4, 5, seed=0)
    g_ref = convert.graph_from_arrays(fa, device="cpu")
    v0 = convert.values_from_arrays(va, device="cpu")
    ft = t_custom.custom_factor("CustomBetweenPose3", ("Pose3", "Pose3"), 6, _pose3_between_err)
    g_cus = convert.graph_from_arrays(fa[:1], device="cpu")
    name, keys, (R, t), info = fa[1]
    g_cus.add_batch(ft, keys, t_pose3.Pose3(torch.tensor(R), torch.tensor(t)), info)
    p = t_opt.LMParams(solver="multifrontal", relative_error_tol=1e-10, absolute_error_tol=1e-10)
    r_ref = t_opt.levenberg_marquardt(g_ref, v0, p, device="cpu")
    r_cus = t_opt.levenberg_marquardt(g_cus, v0, p, device="cpu")
    assert float(g_cus.error(v0)) == pytest.approx(float(g_ref.error(v0)), rel=1e-12)
    assert r_cus.error <= r_ref.error and r_cus.error == pytest.approx(r_ref.error, rel=1e-4)


# --- linear containers --------------------------------------------------------------


def test_linear_container_gn():
    """tests/test_utils_extra.py::TestLinearContainer: A x = b at x0 -> GN
    to x0 + A^-1 b = [3.5, 3.5], port against the JAX package."""
    A = np.array([[2.0, 0.0], [0.0, 4.0]])
    b, x0 = np.array([1.0, 2.0]), np.array([3.0, 3.0])
    jft = j_custom.linear_container_factor(("Point2",), 2)
    tft = t_custom.linear_container_factor(("Point2",), 2)
    assert tft.name == jft.name == "LinearContainerPoint2_2"
    jg, jv = JGraph(), JValues()
    tg, tv = TGraph(device="cpu"), TValues(device="cpu")
    jv.insert(0, "Point2", jnp.zeros(2))
    tv.insert(0, "Point2", np.zeros(2))
    jg.add(jft, [0], {"A": (jnp.asarray(A),), "b": jnp.asarray(b), "x0": (jnp.asarray(x0),)},
           j_noise.unit(2, jnp.float64))
    tg.add(tft, [0], {"A": (A,), "b": b, "x0": (x0,)}, np.eye(2))
    jr = j_opt.gauss_newton(jg, jv)
    tr = t_opt.gauss_newton(tg, tv, device="cpu")
    np.testing.assert_allclose(tr.values.at(0).numpy(), [3.5, 3.5], atol=1e-8)
    np.testing.assert_allclose(tr.values.at(0).numpy(), np.asarray(jr.values.at(0)), atol=1e-10)


def test_linear_containers_carried_by_name():
    """A JAX graph holding both linear-container forms (the custom
    "LinearContainerPose3_Pose3_6" and the fixed-lag
    "LinearContainer[Pose3,Pose3]12") carried across by name: the port's
    error and every batch's whitened residuals equal the JAX package's."""
    rng = np.random.default_rng(11)
    va, fa = synthetic.sphere_rings(2, 3, seed=2)
    from test_torch_factor_graph import jax_from_arrays

    jg, jv = jax_from_arrays(va, fa)
    (Rs, ts) = va["Pose3"][1]
    x0 = lambda k: (Rs[k], ts[k])
    from gtsam_petercdev_tpu.geometry import pose3 as j_pose3

    jx0 = lambda k: j_pose3.Pose3(jnp.asarray(Rs[k]), jnp.asarray(ts[k]))
    A1, A2, bb = rng.normal(size=(6, 6)), rng.normal(size=(6, 6)), rng.normal(size=6)
    jg.add(j_custom.linear_container_factor(("Pose3", "Pose3"), 6), [1, 4],
           {"A": (jnp.asarray(A1), jnp.asarray(A2)), "b": jnp.asarray(bb), "x0": (jx0(2), jx0(3))},
           jnp.eye(6))
    sqrtH, rhs = np.triu(rng.normal(size=(12, 12))) + 3 * np.eye(12), rng.normal(size=12)
    jg.add(j_fixed_lag.linear_container_factor(("Pose3", "Pose3"), 12), [0, 5],
           ((jx0(0), jx0(5)), jnp.asarray(sqrtH), jnp.asarray(rhs)), jnp.eye(12))
    jg._materialize()
    arrays = []
    for b in jg.batches:
        params = jax.tree_util.tree_map(np.asarray, b.params)
        if b.ftype.name.startswith("LinearContainer["):
            x0s, sH, r = params
            params = (tuple(tuple(x) for x in x0s), sH, r)
        elif b.ftype.name.startswith("LinearContainer"):
            params = dict(params, x0=tuple(tuple(x) for x in params["x0"]))
        arrays.append((b.ftype.name, np.asarray(b.keys), params, np.asarray(b.sqrt_info)))
    names = [a[0] for a in arrays]
    assert "LinearContainerPose3_Pose3_6" in names and "LinearContainer[Pose3,Pose3]12" in names
    tg = convert.graph_from_arrays(arrays, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    assert isinstance(convert.factor_type("LinearContainer[Pose3,Pose3]12"),
                      type(t_fixed_lag.linear_container_factor(("Pose3", "Pose3"), 12)))
    # each batch's whitened residuals (the JAX package's error terms)
    total = 0.0
    for bj, bt in zip(jg.batches, tg.batches):
        jr = jg._batch_terms(bj, jv)
        jx = jg._gather(jv, bj, jr)
        rj = jax.jit(jax.vmap(lambda x, p, R: R @ bj.ftype.residual(x, p)))(jx, bj.params, bj.sqrt_info)
        _, rows = tg._batch_rows(bt, tv)
        rt = bt.sqrt_info @ bt.ftype.residual(tg._gather(tv, bt, rows), bt.params)[..., None]
        np.testing.assert_allclose(rt[..., 0].numpy(), np.asarray(rj), rtol=1e-12, atol=1e-10)
        total += 0.5 * float(jnp.sum(rj * rj))
    assert float(tg.error(tv)) == pytest.approx(total, rel=1e-12)


def test_linear_container_gn_step_equals_linear_solve():
    """Each factor of a sphere linearized at the start and wrapped in a
    linear container: one GN step equals the multifrontal step of the
    original linearization (the phase-14 d) check at a small size; rel
    1e-10)."""
    from gtsam_petercdev_torch.inference import elimination

    va, fa = synthetic.sphere_rings(3, 5, seed=1)
    g = convert.graph_from_arrays(fa, device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    step, _ = elimination.solve_linearized(g, v, 0.0)
    gc = t_custom.linear_container_graph(g, v)
    r = t_opt.gauss_newton(gc, v, t_opt.OptimizerParams(solver="multifrontal", max_iterations=1),
                           device="cpu")
    moved = v.local(r.values)["Pose3"]
    rel = ((moved - step["Pose3"]).abs().max() / step["Pose3"].abs().max()).item()
    assert rel < 1e-10, rel


def test_gnc_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    init, fs, _ = _chain_outlier_scene()
    _, _, tg, tv = _both_graphs(init, fs)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gnc.gnc(tg, tv)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.gnc_weights([np.ones(3)])
    assert convert.gnc_weights([np.ones(3)], device="cpu")[0].dtype == F64
