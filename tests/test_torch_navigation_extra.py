"""The port's Unit3, AHRS, attitude / magnetometer / barometric /
constant-velocity factors and scenarios against the JAX package.

Inputs come from np.random.default_rng(seed) and go through both packages;
the port runs on the CPU in float64. Tolerances: Unit3 and one gyro step
atol 1e-14, 1,000 gyro samples rel 1e-12, a batch of streams against the
streams one at a time rel 1e-13, whitened residuals and Jacobians atol
1e-10, a scenario's noisy samples rel 1e-14. The tests of
tests/test_navigation_extra.py are mirrored here on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_torch.geometry import unit3 as t_unit3
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.navigation import ahrs as t_ahrs
from gtsam_petercdev_torch.navigation import extra_factors as t_extra
from gtsam_petercdev_torch.navigation import preintegration as t_pre
from gtsam_petercdev_torch.navigation import scenario as t_sc
from gtsam_petercdev_torch.navigation.navstate import NavState
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.slam.factors import prior_factor
from gtsam_petercdev_tpu.geometry import unit3 as j_unit3
from gtsam_petercdev_tpu.navigation import ahrs as j_ahrs
from gtsam_petercdev_tpu.navigation import extra_factors as j_extra
from gtsam_petercdev_tpu.navigation import preintegration as j_pre
from gtsam_petercdev_tpu.navigation import scenario as j_sc
from test_torch_navigation import assert_tree_rel, check_factor_against_jax, rand_rot, to_np

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs: PyTorch's CPU bmm on a
    few small matrices costs milliseconds a call across threads (2.7 ms
    against 0.01 ms on one, for [2, 9, 9]), and preintegration is a loop of
    them; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


# --- Unit3 ------------------------------------------------------------------------


def _unit3_points(rng, n=24):
    p = rng.normal(size=(n, 3))
    # axis-aligned (ties in |p_k| decide the basis), diagonal and tiny components
    p[:8] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, -1], [1, 1, 0], [0, -1, -1],
             [1, 1, 1], [1e-9, 1.0, 1e-9]]
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def test_unit3_basis_retract_local_against_jax():
    rng = np.random.default_rng(0)
    p = _unit3_points(rng)
    xi = rng.normal(size=(len(p), 2))
    xi[0] = 0.0
    xi[1] = [1e-13, 0.0]
    np.testing.assert_array_equal(t_unit3.basis(t64(p)).numpy(), np.asarray(j_unit3.basis(jnp.asarray(p))))
    np.testing.assert_allclose(t_unit3.retract(t64(p), t64(xi)).numpy(),
                               np.asarray(j_unit3.retract(jnp.asarray(p), jnp.asarray(xi))),
                               atol=1e-14, rtol=0)
    q = _unit3_points(rng)[::-1].copy()
    q[0] = p[0]                       # sin_t = 0 at theta = 0
    q[1] = -p[1]                      # antipodal
    q[2] = -p[2] + 1e-8 * np.array([1.0, 0.0, 0.0])  # near-antipodal
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(t_unit3.local(t64(p), t64(q)).numpy(),
                               np.asarray(j_unit3.local(jnp.asarray(p), jnp.asarray(q))),
                               atol=1e-14, rtol=0)
    # local inverts retract away from the antipode
    r = t_unit3.retract(t64(p[3:]), t64(xi[3:] * 0.3))
    np.testing.assert_allclose(t_unit3.local(t64(p[3:]), r).numpy(), xi[3:] * 0.3, atol=1e-12)


def test_unit3_local_tangents_finite_at_zero_angle():
    """Forward-mode tangents of local at q = p (sin_t = 0) stay finite."""
    p = t64(_unit3_points(np.random.default_rng(1))[:6])
    J = torch.func.jacfwd(lambda x: t_unit3.local(p, t_unit3.retract(p, x)))(torch.zeros(6, 2, dtype=F64))
    assert torch.isfinite(J).all()


# --- AHRS: gyro preintegration -------------------------------------------------------------


def _gyro(rng, lead, n):
    return rng.normal(size=lead + (n, 3)) * 0.4, 0.005 + 0.01 * rng.random(size=lead + (n,))


def test_integrate_rotation_one_step():
    rng = np.random.default_rng(2)
    cov = np.eye(3) * 1e-4
    om, dts = _gyro(rng, (), 4)
    bias = rng.normal(size=3) * 0.02
    jpre = j_ahrs.preintegrate_rotation(jnp.asarray(cov), jnp.asarray(om[:3]), jnp.asarray(dts[:3]),
                                        jnp.asarray(bias))
    tpre = t_ahrs.PreintegratedRotation(*(t64(a) for a in to_np(tuple(jpre))))
    jn = j_ahrs.integrate_rotation(jpre, jnp.asarray(cov), jnp.asarray(om[3]), jnp.asarray(dts[3]))
    tn = t_ahrs.integrate_rotation(tpre, t64(cov), t64(om[3]), t64(dts[3]))
    for name, a, b in zip(t_ahrs.PreintegratedRotation._fields, tn, jn):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-14, rtol=0, err_msg=name)


def test_preintegrate_rotation_1000_samples():
    rng = np.random.default_rng(3)
    cov = np.eye(3) * 1e-4
    om, dts = _gyro(rng, (), 1000)
    bias = rng.normal(size=3) * 0.02
    jpre = j_ahrs.preintegrate_rotation(jnp.asarray(cov), jnp.asarray(om), jnp.asarray(dts), jnp.asarray(bias))
    tpre = t_ahrs.preintegrate_rotation(t64(cov), t64(om), t64(dts), t64(bias))
    assert_tree_rel(tpre, tuple(jpre), 1e-12)


def test_preintegrate_rotation_batch_equals_single_streams():
    rng = np.random.default_rng(4)
    cov = np.eye(3) * 1e-4
    om, dts = _gyro(rng, (4,), 120)
    batch = t_ahrs.preintegrate_rotation(t64(cov), t64(om), t64(dts))
    assert batch.deltaT.shape == (4,)
    for k in range(4):
        one = t_ahrs.preintegrate_rotation(t64(cov), t64(om[k]), t64(dts[k]))
        assert_tree_rel(tuple(f[k] for f in batch), one, 1e-13)


# --- factors: whitened residuals and Jacobians against the JAX package -------------------


def _extra_case(name, truth, rng):
    """(xs, params, sqrt_info) for n = 5 factors, random or at the truth."""
    n = 5
    R = rand_rot(rng, n)
    iso = lambda d, s: np.broadcast_to(np.eye(d) / s, (n, d, d)).copy()
    if name == "AHRSFactor":
        om, dts = _gyro(rng, (n,), 30)
        pre = t_ahrs.preintegrate_rotation(torch.eye(3, dtype=F64) * 1e-4, t64(om), t64(dts),
                                           t64(rng.normal(size=(n, 3)) * 0.01))
        bias = rng.normal(size=(n, 3)) * 0.01
        Rj = (t64(R) @ t_ahrs.bias_corrected_deltaR(pre, t64(bias))).numpy() if truth else rand_rot(rng, n)
        info = np.linalg.cholesky(np.linalg.inv(pre.cov.numpy())).transpose(0, 2, 1)
        return [R, Rj, bias], to_np(tuple(pre)), info
    if name in ("Rot3AttitudeFactor", "Pose3AttitudeFactor"):
        bRef = rng.normal(size=(n, 3))
        bRef[0] = [0.0, 0.0, 1.0]
        bRef /= np.linalg.norm(bRef, axis=-1, keepdims=True)
        nZ = np.einsum("nij,nj->ni", R, bRef) if truth else rng.normal(size=(n, 3))
        xs = [R] if name.startswith("Rot3") else [(R, rng.normal(size=(n, 3)))]
        return xs, {"nZ": nZ, "bRef": bRef}, iso(2, 0.1)
    if name in ("MagFactor", "MagPoseFactor"):
        direction = rng.normal(size=(n, 3))
        scale, bias = 1.0 + rng.random(n), rng.normal(size=(n, 3)) * 0.1
        dn = direction / np.linalg.norm(direction, axis=-1, keepdims=True)
        meas = (scale[:, None] * np.einsum("nji,nj->ni", R, dn) + bias if truth
                else rng.normal(size=(n, 3)))
        xs = [R] if name == "MagFactor" else [(R, rng.normal(size=(n, 3)))]
        return xs, {"measured": meas, "scale": scale, "direction": direction, "bias": bias}, iso(3, 0.2)
    if name == "MagFactorCalib":
        direction = rng.normal(size=(n, 3))
        scale, bias = 1.0 + rng.random((n, 1)), rng.normal(size=(n, 3)) * 0.1
        dn = direction / np.linalg.norm(direction, axis=-1, keepdims=True)
        meas = (scale * np.einsum("nji,nj->ni", R, dn) + bias if truth else rng.normal(size=(n, 3)))
        return [scale, bias], {"measured": meas, "nRb": R, "direction": direction}, iso(3, 0.2)
    if name == "BarometricFactor":
        t, b = rng.normal(size=(n, 3)) * 10, rng.normal(size=(n, 1))
        h = t[:, 2:3] + b if truth else rng.normal(size=(n, 1))
        return [(R, t), b], h, iso(1, 0.3)
    if name == "ConstantVelocityFactor":
        t1, v1, dt = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), 0.1 + rng.random(n)
        if truth:
            x2 = (R, t1 + v1 * dt[:, None], v1)
        else:
            x2 = (rand_rot(rng, n), rng.normal(size=(n, 3)), rng.normal(size=(n, 3)))
        return [(R, t1, v1), x2], {"dt": dt}, iso(9, 0.3)
    raise KeyError(name)


EXTRA_FACTORS = {
    "AHRSFactor": (j_ahrs.ahrs_factor, t_ahrs.ahrs_factor),
    "Rot3AttitudeFactor": (j_extra.rot3_attitude_factor, t_extra.rot3_attitude_factor),
    "Pose3AttitudeFactor": (j_extra.pose3_attitude_factor, t_extra.pose3_attitude_factor),
    "MagFactor": (j_extra.mag_factor, t_extra.mag_factor),
    "MagPoseFactor": (j_extra.mag_pose_factor, t_extra.mag_pose_factor),
    "MagFactorCalib": (j_extra.mag_factor_calibration, t_extra.mag_factor_calibration),
    "BarometricFactor": (j_extra.barometric_factor, t_extra.barometric_factor),
    "ConstantVelocityFactor": (j_extra.constant_velocity_factor, t_extra.constant_velocity_factor),
}


@pytest.mark.parametrize("name", list(EXTRA_FACTORS))
def test_extra_factor_residual_and_jacobians(name):
    """At random points and at the exact truth (residual 0, every Jacobian
    finite), in one batch: the first 5 factors random, the last 5 exact."""
    rng = np.random.default_rng(5)
    rnd, tru = _extra_case(name, False, rng), _extra_case(name, True, rng)
    cat = lambda a, b: jax.tree_util.tree_map(lambda x, y: np.concatenate([x, y]), a, b)
    xs, params, info = (cat(a, b) for a, b in zip(rnd, tru))
    jft, tft = (make() for make in EXTRA_FACTORS[name])
    assert (tft.name, tft.var_types, tft.resid_dim) == (jft.name, jft.var_types, jft.resid_dim)
    r = check_factor_against_jax(name, xs, params, info, jft, tft, tft.var_types)
    np.testing.assert_allclose(r[5:].numpy(), 0.0, atol=1e-9)


# --- scenarios -----------------------------------------------------------------------


def test_measured_series_same_samples_as_jax():
    """One seed gives the JAX package's noisy samples (the accelerometer's
    noise drawn first), for both scenario kinds."""
    jp, tp = j_pre.default_params(), t_pre.default_params(device="cpu")
    bias = np.array([0.05, -0.03, 0.04, 2e-3, -1e-3, 1.5e-3])
    pairs = [
        (j_sc.constant_twist([0, 0, 0.05], [10.0, 0, 0]),
         t_sc.constant_twist([0, 0, 0.05], [10.0, 0, 0], device="cpu")),
        (j_sc.AcceleratingScenario(*(jnp.asarray(x, dtype=jnp.float64) for x in
                                     (np.eye(3), [1.0, 2, 3], [1.0, 0, 0], [0.3, 0.1, 0], [0.1, -0.2, 0.3]))),
         t_sc.AcceleratingScenario(*(t64(x) for x in
                                     (np.eye(3), [1.0, 2, 3], [1.0, 0, 0], [0.3, 0.1, 0], [0.1, -0.2, 0.3])))),
    ]
    for js, ts in pairs:
        ja = j_sc.ScenarioRunner(js, jp, 0.005, bias).measured_series(0.5, np.random.default_rng(9))
        ta = t_sc.ScenarioRunner(ts, tp, 0.005, bias).measured_series(0.5, np.random.default_rng(9))
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=1e-14)
        # the nav states at the sample times, batched over the time axis
        tt = np.arange(5) * 0.1
        jn = jax.vmap(js.nav_state)(jnp.asarray(tt))
        tn = ts.nav_state(t64(tt))
        for a, b in zip(tn, jn):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-13, rtol=0)


class TestAttitudeFactor:
    def test_zero_error_at_truth(self):
        ft = t_extra.rot3_attitude_factor()
        R = t_so3.expmap(t64([0.1, -0.2, 0.3]))
        bRef = t64([0.0, 0.0, 1.0])
        nZ = t_so3.rotate(R, bRef)
        r = ft.residual((R,), {"nZ": nZ, "bRef": bRef})
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-12)

    def test_optimization_aligns_attitude(self):
        ft = t_extra.rot3_attitude_factor()
        graph = NonlinearFactorGraph(device="cpu")
        values = Values(device="cpu")
        values.insert(0, "Rot3", t_so3.expmap(t64([0.3, -0.2, 0.0])))
        z = t64([0.0, 0.0, 1.0])
        graph.add(ft, [0], {"nZ": z, "bRef": z}, t_noise.isotropic(2, 0.25, np.float64))
        res = t_opt.levenberg_marquardt(graph, values, device="cpu")
        R = res.values.at(0).numpy()
        np.testing.assert_allclose(R @ [0, 0, 1], [0, 0, 1], atol=1e-6)

    def test_pose3_variant_jacobian(self):
        ft = t_extra.pose3_attitude_factor()
        p = t_pose3.expmap(t64([0.1, 0.2, -0.1, 1.0, 2.0, 3.0]))
        params = {"nZ": t64([0.0, 0.1, 0.99]) / np.sqrt(0.1**2 + 0.99**2), "bRef": t64([0.0, 0.0, 1.0])}
        r = ft.residual((p,), params)
        assert r.shape == (2,)
        assert torch.isfinite(r).all()


class TestMagFactor:
    def test_zero_at_truth_and_recovery(self):
        R_true = t_so3.expmap(t64([0.0, 0.0, 0.7]))
        direction = t64([0.4, 0.5, -0.77])
        direction = direction / torch.linalg.norm(direction)
        scale = t64(25000.0)
        bias = t64([10.0, -5.0, 3.0])
        measured = scale * t_so3.unrotate(R_true, direction) + bias
        r = t_extra.mag_factor().residual(
            (R_true,), {"measured": measured, "scale": scale, "direction": direction, "bias": bias})
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-8)

    def test_calibration_recovery(self):
        nRb = t_so3.expmap(t64([0.1, 0.2, 0.3]))
        nRb2 = t_so3.expmap(t64([-0.3, 0.5, 0.1]))
        direction = t64([0.0, 1.0, 0.0])
        scale_true, bias_true = 2.5, np.array([0.1, -0.2, 0.05])
        ft = t_extra.mag_factor_calibration()
        graph = NonlinearFactorGraph(device="cpu")
        values = Values(device="cpu")
        values.insert(0, "Vector1", t64([1.0]))
        values.insert(1, "Vector3", torch.zeros(3, dtype=F64))
        for R in (nRb, nRb2):
            m = scale_true * t_so3.unrotate(R, direction) + t64(bias_true)
            graph.add(ft, [0, 1], {"measured": m, "nRb": R, "direction": direction},
                      t_noise.isotropic(3, 1.0, np.float64))
        res = t_opt.gauss_newton(graph, values, device="cpu")
        assert float(res.values.at(0)[0]) == pytest.approx(scale_true, abs=1e-8)
        np.testing.assert_allclose(res.values.at(1).numpy(), bias_true, atol=1e-8)


class TestBarometric:
    def test_residual_and_solve(self):
        ft = t_extra.barometric_factor()
        graph = NonlinearFactorGraph(device="cpu")
        values = Values(device="cpu")
        values.insert(0, "Pose3", t_pose3.identity(device="cpu"))
        values.insert(1, "Vector1", torch.zeros(1, dtype=F64))
        target = t_pose3.Pose3(torch.eye(3, dtype=F64), t64([0.0, 0.0, 5.0]))
        graph.add(ft, [0, 1], t64([5.0]), t_noise.isotropic(1, 0.1, np.float64))
        graph.add(prior_factor("Pose3"), [0], target, t_noise.isotropic(6, 1.0, np.float64))
        graph.add(prior_factor("Vector1"), [1], torch.zeros(1, dtype=F64), t_noise.isotropic(1, 0.01, np.float64))
        res = t_opt.levenberg_marquardt(graph, values, device="cpu")
        z = float(res.values.at(0).t[2]) + float(res.values.at(1)[0])
        assert z == pytest.approx(5.0, abs=1e-2)


class TestConstantVelocity:
    def test_zero_at_consistent_pair(self):
        ft = t_extra.constant_velocity_factor()
        v = t64([1.0, 2.0, 0.5])
        x1 = NavState(torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64), v)
        x2 = NavState(x1.R, x1.t + v * 0.5, v)
        r = ft.residual((x1, x2), {"dt": t64(0.5)})
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-12)


class TestAHRS:
    def test_preintegrated_rotation_matches_closed_form(self):
        w, dt, n = np.array([0.1, -0.3, 0.2]), 0.01, 100
        pim = t_ahrs.preintegrate_rotation(torch.eye(3, dtype=F64) * 1e-6, t64(np.tile(w, (n, 1))),
                                           torch.full((n,), dt, dtype=F64))
        np.testing.assert_allclose(pim.deltaR.numpy(), t_so3.expmap(t64(w * n * dt)).numpy(), atol=1e-9)
        assert float(pim.deltaT) == pytest.approx(1.0)
        cov = pim.cov.numpy()
        assert np.all(np.linalg.eigvalsh(cov) >= 0)
        assert cov[0, 0] > 0

    def test_ahrs_factor_zero_at_truth(self):
        w, n, dt = np.array([0.0, 0.0, 0.5]), 50, 0.02
        pim = t_ahrs.preintegrate_rotation(torch.eye(3, dtype=F64) * 1e-6, t64(np.tile(w, (n, 1))),
                                           torch.full((n,), dt, dtype=F64))
        Rj = t_so3.expmap(t64(w * n * dt))
        r = t_ahrs.ahrs_factor().residual((t_so3.identity(device="cpu"), Rj, torch.zeros(3, dtype=F64)), pim)
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-9)

    def test_ahrs_factor_bias_correction_firstorder(self):
        w, bias = np.array([0.2, 0.1, -0.3]), np.array([0.01, -0.02, 0.005])
        n, dt = 100, 0.01
        pim = t_ahrs.preintegrate_rotation(torch.eye(3, dtype=F64) * 1e-8, t64(np.tile(w + bias, (n, 1))),
                                           torch.full((n,), dt, dtype=F64))
        Rj = t_so3.expmap(t64(w * n * dt))
        r = t_ahrs.ahrs_factor().residual((t_so3.identity(device="cpu"), Rj, t64(bias)), pim)
        assert float(torch.linalg.norm(r)) < 1e-4


class TestScenario:
    def test_constant_twist_circle(self):
        w, v = 0.3, 2.0
        sc = t_sc.constant_twist([0, 0, w], [v, 0, 0], device="cpu")
        s = sc.nav_state(2 * np.pi / w)
        np.testing.assert_allclose(s.t.numpy(), [0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(s.R.numpy(), np.eye(3), atol=1e-6)

    def test_runner_prediction_matches_scenario(self):
        sc = t_sc.constant_twist([0, 0, 0.2], [1.5, 0, 0], device="cpu")
        params = t_pre.default_params(g=9.81, accel_sigma=0.0, gyro_sigma=0.0, integration_sigma=0.0,
                                      device="cpu")
        runner = t_sc.ScenarioRunner(sc, params, dt=1e-3)
        predicted = runner.predict(runner.integrate(1.0), sc.nav_state(0.0))
        expected = sc.nav_state(1.0)
        np.testing.assert_allclose(predicted.R.numpy(), expected.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(predicted.t.numpy(), expected.t.numpy(), atol=1e-3)
        np.testing.assert_allclose(predicted.v.numpy(), expected.v.numpy(), atol=1e-3)

    def test_accelerating_scenario(self):
        sc = t_sc.AcceleratingScenario(R0=torch.eye(3, dtype=F64), t0=torch.zeros(3, dtype=F64),
                                       v0=t64([1.0, 0.0, 0.0]), a_n=t64([0.3, 0.0, 0.0]),
                                       w_b=torch.zeros(3, dtype=F64))
        params = t_pre.default_params(accel_sigma=0.0, gyro_sigma=0.0, integration_sigma=0.0, device="cpu")
        runner = t_sc.ScenarioRunner(sc, params, dt=1e-3)
        T = 2.0
        predicted = runner.predict(runner.integrate(T), sc.nav_state(0.0))
        np.testing.assert_allclose(predicted.t.numpy(), [1.0 * T + 0.5 * 0.3 * T * T, 0, 0], atol=1e-3)

    def test_monte_carlo_covariance_consistent(self):
        sc = t_sc.constant_twist([0, 0, 0.1], [1.0, 0, 0], device="cpu")
        params = t_pre.default_params(accel_sigma=0.05, gyro_sigma=0.005, integration_sigma=0.0, device="cpu")
        runner = t_sc.ScenarioRunner(sc, params, dt=0.01)
        pim = runner.integrate(0.5)
        est = runner.estimate_covariance(0.5, runs=60, initial=sc.nav_state(0.0), seed=3)
        ana = pim.cov.numpy()
        for i in range(3):
            assert est[i, i] == pytest.approx(ana[i, i], rel=0.6)


# --- no card, no run ---------------------------------------------------------------


@pytest.mark.parametrize("entry", [
    lambda: t_unit3.identity(),
    lambda: t_ahrs.rotation_init(),
    lambda: t_sc.constant_twist([0, 0, 0.1], [1.0, 0, 0]),
])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
