"""The port's navigation (NavState, IMU preintegration, IMU / combined-IMU /
GPS factors, the IMU + GPS drive) against the JAX package.

Inputs come from np.random.default_rng(seed) and go through both packages;
the port runs on the CPU in float64. Tolerances: one integration step and
the chart atol 1e-14, 1,000 samples rel 1e-12, a batch of streams against
the streams one at a time rel 1e-13, bias correction / predict / error atol
1e-12, whitened residuals and Jacobians atol 1e-10, solved graphs atol 1e-8.
The tests of tests/test_navigation.py are mirrored here on the port.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.models import imu_gps
from gtsam_petercdev_torch.navigation import factors as t_navf
from gtsam_petercdev_torch.navigation import navstate as t_ns
from gtsam_petercdev_torch.navigation import preintegration as t_pre
from gtsam_petercdev_torch.nonlinear import factor_graph as t_fg
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2Params
from gtsam_petercdev_torch.nonlinear.optimizers import LMParams as TLMParams
from gtsam_petercdev_torch.nonlinear.optimizers import OptimizerParams as TOptParams
from gtsam_petercdev_torch.nonlinear.optimizers import gauss_newton as t_gauss_newton
from gtsam_petercdev_torch.nonlinear.optimizers import levenberg_marquardt as t_levenberg_marquardt
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam.factors import prior_factor as t_prior_factor
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.geometry import so3 as j_so3
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.navigation import ahrs as j_ahrs
from gtsam_petercdev_tpu.navigation import extra_factors as j_extra
from gtsam_petercdev_tpu.navigation import factors as j_navf
from gtsam_petercdev_tpu.navigation import navstate as j_ns
from gtsam_petercdev_tpu.navigation import preintegration as j_pre
from gtsam_petercdev_tpu.nonlinear import factor_graph as j_fg
from gtsam_petercdev_tpu.nonlinear.optimizers import OptimizerParams as JOptParams
from gtsam_petercdev_tpu.nonlinear.optimizers import gauss_newton as j_gauss_newton
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam.factors import prior_factor as j_prior_factor

F64 = torch.float64
G = 9.81


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


# --- carrying values and graphs between the packages ---------------------------


def to_np(tree):
    """A JAX or torch tree (dicts, NamedTuples, arrays) as numpy, tuples kept
    as plain tuples in field order (the convert format)."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_np(x) for x in tree)
    if torch.is_tensor(tree):
        return tree.detach().numpy()
    return np.asarray(tree)


def to_t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


_J_LAYOUTS = {"Pose3": j_pose3.Pose3, "NavState": j_ns.NavState}
_J_NAV = {make().name: make for make in (
    j_navf.imu_factor, j_navf.combined_imu_factor, j_navf.gps_factor, j_ahrs.ahrs_factor,
    j_extra.rot3_attitude_factor, j_extra.pose3_attitude_factor, j_extra.mag_factor,
    j_extra.mag_pose_factor, j_extra.mag_factor_calibration, j_extra.barometric_factor,
    j_extra.constant_velocity_factor)}


def _j_layout(t, p):
    p = jax.tree_util.tree_map(jnp.asarray, p)
    return _J_LAYOUTS[t](*p) if t in _J_LAYOUTS else p


def _j_params(name, ft, p):
    p = jax.tree_util.tree_map(jnp.asarray, p)
    if name in ("ImuFactor", "CombinedImuFactor"):
        return dict(p, pim=j_pre.PIM(*p["pim"]))
    if name == "AHRSFactor":
        return j_ahrs.PreintegratedRotation(*p)
    if name in _J_NAV:
        return p
    return _j_layout(ft.var_types[0], p)


def jax_from_arrays(values_arrays, factor_arrays):
    """The JAX package's (graph, values) from the carry-across format."""
    values = JValues()
    for t, (keys, p) in values_arrays.items():
        values.insert_batch(np.asarray(keys), t, _j_layout(t, p))
    graph = j_fg.NonlinearFactorGraph()
    for name, keys, p, info in factor_arrays:
        ft = _J_NAV[name]() if name in _J_NAV else j_prior_factor(name[len("Prior"):])
        graph.add_batch(ft, np.asarray(keys), _j_params(name, ft, p), np.asarray(info))
    return graph, values


def jax_to_arrays(jgraph, jvalues):
    """A JAX (graph, values) read out as numpy in the carry-across format."""
    jgraph._materialize()
    values = {t: (np.asarray(jvalues.type_keys(t)), to_np(jvalues.params(t)))
              for t in jvalues.types()}
    factors = [(b.ftype.name, np.asarray(b.keys), to_np(b.params), np.asarray(b.sqrt_info))
               for b in jgraph.batches]
    return values, factors


def port_from_arrays(values_arrays, factor_arrays):
    return (convert.graph_from_arrays(factor_arrays, device="cpu"),
            convert.values_from_arrays(values_arrays, device="cpu"))


def values_np(values, types):
    """{key: flat float64 value} of a Values of either package."""
    out = {}
    for t in types:
        leaves = [np.asarray(to_np(x)).reshape(len(values.type_keys(t)), -1)
                  for x in (values.params(t) if isinstance(values.params(t), tuple)
                            else (values.params(t),))]
        flat = np.concatenate(leaves, axis=1)
        for k, row in zip(values.type_keys(t), flat):
            out[int(k)] = row
    return out


def assert_tree_close(port, ref, atol=0.0, rtol=0.0):
    for a, b in zip(jax.tree_util.tree_leaves(to_np(port)), jax.tree_util.tree_leaves(to_np(ref))):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def assert_tree_rel(port, ref, rel):
    """Each leaf within rel x that leaf's largest entry."""
    for a, b in zip(jax.tree_util.tree_leaves(to_np(port)), jax.tree_util.tree_leaves(to_np(ref))):
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


# --- random inputs ---------------------------------------------------------------------


def rand_rot(rng, n, scale=0.5):
    return np.array(j_so3.expmap(jnp.asarray(rng.normal(size=(n, 3)) * scale)))


def imu_stream(rng, n, lead=()):
    acc = rng.normal(size=lead + (n, 3)) * 0.5 + np.array([0.0, 0.0, G])
    omega = rng.normal(size=lead + (n, 3)) * 0.3
    dts = 0.004 + 0.002 * rng.random(size=lead + (n,))
    return acc, omega, dts


@pytest.fixture(scope="module")
def params_pair():
    return j_pre.default_params(), t_pre.default_params(device="cpu")


# --- NavState ----------------------------------------------------------------------------


def test_navstate_retract_local_against_jax():
    rng = np.random.default_rng(0)
    n = 16
    R = rand_rot(rng, n, 1.0)
    R[0] = np.eye(3)
    a = (R, rng.normal(size=(n, 3)), rng.normal(size=(n, 3)))
    xi = rng.normal(size=(n, 9))
    xi[1] = 0.0
    xi[2, :3] = [np.pi - 1e-7, 0.0, 0.0]  # near the antipode of the chart
    jb = jax.jit(j_ns.retract)(j_ns.NavState(*map(jnp.asarray, a)), jnp.asarray(xi))
    tb = t_ns.retract(t_ns.NavState(*to_t(a)), torch.tensor(xi))
    assert_tree_close(tb, jb, atol=1e-14)
    jl = jax.jit(j_ns.local)(j_ns.NavState(*map(jnp.asarray, a)), jb)
    tl = t_ns.local(t_ns.NavState(*to_t(a)), tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-14, rtol=0)
    np.testing.assert_allclose(tl.numpy()[:, 3:], xi[:, 3:], atol=1e-12)


def test_navstate_and_bias_registered():
    from gtsam_petercdev_torch.core import manifold
    assert manifold.get("NavState").dim == 9
    assert manifold.get("ConstantBias").dim == 6
    x = t_ns.identity(device="cpu")
    z = manifold.get("NavState").local(x, manifold.get("NavState").retract(x, torch.ones(9, dtype=F64)))
    np.testing.assert_allclose(z.numpy(), np.ones(9), atol=1e-14)


# --- preintegration -----------------------------------------------------------------


def test_integrate_measurement_one_step(params_pair):
    jp, tp = params_pair
    rng = np.random.default_rng(1)
    bias = rng.normal(size=6) * 0.05
    # a PIM part-way through an interval: integrate 3 samples, then compare one more
    acc, om, dts = imu_stream(rng, 4)
    tpim = t_pre.preintegrate(tp, torch.tensor(acc[:3]), torch.tensor(om[:3]), torch.tensor(dts[:3]),
                              torch.tensor(bias))
    jpim = j_pre.PIM(*map(jnp.asarray, to_np(tuple(tpim))))
    jnext = jax.jit(lambda p, a, w, dt: j_pre.integrate_measurement(p, jp, a, w, dt))(
        jpim, jnp.asarray(acc[3]), jnp.asarray(om[3]), jnp.asarray(dts[3]))
    tnext = t_pre.integrate_measurement(tpim, tp, torch.tensor(acc[3]), torch.tensor(om[3]),
                                        torch.tensor(dts[3]))
    for name, a, b in zip(t_pre.PIM._fields, tnext, jnext):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-14, rtol=0, err_msg=name)


def test_preintegrate_1000_samples(params_pair):
    jp, tp = params_pair
    rng = np.random.default_rng(2)
    acc, om, dts = imu_stream(rng, 1000)
    bias = rng.normal(size=6) * 0.05
    jpim = j_pre.preintegrate(jp, jnp.asarray(acc), jnp.asarray(om), jnp.asarray(dts),
                              jnp.asarray(bias))
    tpim = t_pre.preintegrate(tp, torch.tensor(acc), torch.tensor(om), torch.tensor(dts),
                              torch.tensor(bias))
    assert_tree_rel(tpim, tuple(jpim), 1e-12)


def test_preintegrate_batch_equals_single_streams(params_pair):
    _, tp = params_pair
    rng = np.random.default_rng(3)
    acc, om, dts = imu_stream(rng, 150, lead=(4,))
    bias = rng.normal(size=(4, 6)) * 0.05
    batch = t_pre.preintegrate(tp, torch.tensor(acc), torch.tensor(om), torch.tensor(dts),
                               torch.tensor(bias))
    assert batch.deltaT.shape == (4,) and batch.cov.shape == (4, 9, 9)
    for k in range(4):
        one = t_pre.preintegrate(tp, torch.tensor(acc[k]), torch.tensor(om[k]),
                                 torch.tensor(dts[k]), torch.tensor(bias[k]))
        assert_tree_rel(tuple(f[k] for f in batch), one, 1e-13)


@pytest.fixture(scope="module")
def pim_pair(params_pair):
    jp, tp = params_pair
    rng = np.random.default_rng(4)
    acc, om, dts = imu_stream(rng, 200, lead=(5,))
    tpim = t_pre.preintegrate(tp, torch.tensor(acc), torch.tensor(om), torch.tensor(dts),
                              torch.tensor(rng.normal(size=(5, 6)) * 0.02))
    return j_pre.PIM(*map(jnp.asarray, to_np(tuple(tpim)))), tpim


def _rand_states(rng, n):
    return (rand_rot(rng, n), rng.normal(size=(n, 3)) * 3, rng.normal(size=(n, 3)))


def test_bias_correction_predict_and_error_against_jax(params_pair, pim_pair):
    jp, tp = params_pair
    jpim, tpim = pim_pair
    rng = np.random.default_rng(5)
    bias = rng.normal(size=(5, 6)) * 0.03
    si, sj = _rand_states(rng, 5), _rand_states(rng, 5)
    jxi = jax.jit(jax.vmap(j_pre.bias_corrected_delta))(jpim, jnp.asarray(bias))
    np.testing.assert_allclose(t_pre.bias_corrected_delta(tpim, torch.tensor(bias)).numpy(),
                               np.asarray(jxi), atol=1e-12, rtol=0)
    jst = jax.jit(jax.vmap(lambda p, s, b: j_pre.predict(p, jp, s, b)))(
        jpim, j_ns.NavState(*map(jnp.asarray, si)), jnp.asarray(bias))
    tst = t_pre.predict(tpim, tp, t_ns.NavState(*to_t(si)), torch.tensor(bias))
    assert_tree_close(tst, jst, atol=1e-12)
    jerr = jax.jit(jax.vmap(lambda p, a, b, c: j_pre.compute_error(p, jp, a, b, c)))(
        jpim, j_ns.NavState(*map(jnp.asarray, si)), j_ns.NavState(*map(jnp.asarray, sj)),
        jnp.asarray(bias))
    terr = t_pre.compute_error(tpim, tp, t_ns.NavState(*to_t(si)), t_ns.NavState(*to_t(sj)),
                               torch.tensor(bias))
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), atol=1e-12, rtol=0)
    jcov = jax.jit(jax.vmap(lambda p: j_navf.combined_covariance(p, jp)))(jpim)
    np.testing.assert_allclose(t_navf.combined_covariance(tpim, tp).numpy(), np.asarray(jcov),
                               atol=1e-14, rtol=0)


# --- mirrors of tests/test_navigation.py ------------------------------------------------


def _constant_twist_scenario(T=1.0, dt=1e-3):
    """Body angular rate w, constant nav-frame acceleration A (closed form),
    on the port (tests/test_navigation.py's scenario)."""
    w = torch.tensor([0.1, -0.2, 0.3], dtype=F64)
    A = torch.tensor([0.3, 0.1, -0.2], dtype=F64)
    g = torch.tensor([0.0, 0.0, -G], dtype=F64)
    n = int(T / dt)
    ts = torch.tensor(np.arange(n) * dt)
    Rs = t_so3.expmap(ts[:, None] * w[None, :])
    acc_b = t_so3.unrotate(Rs, (A - g)[None, :])
    omega_b = w.expand(n, 3)
    dts = torch.full((n,), dt, dtype=F64)
    v0 = torch.tensor([0.5, -0.1, 0.2], dtype=F64)
    RT = t_so3.expmap(w * T)
    pT = v0 * T + 0.5 * A * T * T
    vT = v0 + A * T
    return (acc_b, omega_b, dts), (v0, t_ns.NavState(RT, pT, vT))


def test_preintegration_matches_closed_form(params_pair):
    _, params = params_pair
    (acc, om, dts), (v0, want) = _constant_twist_scenario()
    pim = t_pre.preintegrate(params, acc, om, dts)
    state0 = t_ns.NavState(torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64), v0)
    got = t_pre.predict(pim, params, state0, torch.zeros(6, dtype=F64))
    np.testing.assert_allclose(got.R.numpy(), want.R.numpy(), atol=2e-4)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(got.v.numpy(), want.v.numpy(), atol=2e-3)


def test_bias_correction_first_order(params_pair):
    _, params = params_pair
    (acc, om, dts), _ = _constant_twist_scenario(T=0.5)
    db = torch.tensor([2e-3, -1e-3, 1e-3, -5e-4, 8e-4, 3e-4], dtype=F64)
    # both bias points integrate in one batched pass
    both = t_pre.preintegrate(params, acc.expand(2, -1, -1), om.expand(2, -1, -1),
                              dts.expand(2, -1), torch.stack([torch.zeros(6, dtype=F64), db]))
    xi = t_pre.bias_corrected_delta(both, db)
    np.testing.assert_allclose(xi[0].numpy(), xi[1].numpy(), atol=5e-6)


def test_covariance_monte_carlo():
    """pim.cov matches the sample covariance of preintegration outputs under
    measurement noise; the 400 noisy streams integrate as one batch."""
    accel_sigma, gyro_sigma = 0.1, 0.02
    params = t_pre.default_params(accel_sigma=accel_sigma, gyro_sigma=gyro_sigma,
                                  integration_sigma=0.0, device="cpu")
    (acc, om, dts), _ = _constant_twist_scenario(T=0.5, dt=1e-2)
    pim = t_pre.preintegrate(params, acc, om, dts)
    rng = np.random.default_rng(0)
    runs, n = 400, acc.shape[0]
    dt = float(dts[0])
    acc_n = acc + torch.tensor(rng.normal(size=(runs, n, 3))) * accel_sigma / np.sqrt(dt)
    om_n = om + torch.tensor(rng.normal(size=(runs, n, 3))) * gyro_sigma / np.sqrt(dt)
    p = t_pre.preintegrate(params, acc_n, om_n, dts.expand(runs, n))
    samples = torch.cat([t_so3.logmap(t_so3.between(pim.deltaR, p.deltaR)), p.deltaP - pim.deltaP,
                         p.deltaV - pim.deltaV], dim=-1)
    mc_cov = np.cov(samples.numpy().T)
    np.testing.assert_allclose(np.diag(mc_cov), np.diag(pim.cov.numpy()), rtol=0.25)


def _three_state_chain(params):
    """tests/test_navigation.py's IMU chain in the carry-across format: a
    prior on the first state, one IMU factor over the closed-form scenario's
    1,000 samples, the second state perturbed (seed 3); the PIM and the true
    second state from the port's preintegration."""
    rng = np.random.default_rng(3)
    (acc, om, dts), (v0, _) = _constant_twist_scenario(T=1.0, dt=1e-3)
    pim = t_pre.preintegrate(params, acc, om, dts)
    state0 = t_ns.NavState(torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64), v0)
    s1 = t_pre.predict(pim, params, state0, torch.zeros(6, dtype=F64))
    p1 = t_pose3.retract(t_pose3.Pose3(s1.R, s1.t), torch.tensor(rng.normal(size=6) * 0.05))
    v1 = s1.v + torch.tensor(rng.normal(size=3) * 0.05)
    X, V, B = 0, 10, 20
    one = lambda *a: a[0][None] if len(a) == 1 else tuple(x[None] for x in a)
    values = {"Pose3": (np.array([X, X + 1]), to_np((torch.stack([state0.R, p1.R]),
                                                      torch.stack([state0.t, p1.t])))),
              "Vector3": (np.array([V, V + 1]), to_np(torch.stack([v0, v1]))),
              "ConstantBias": (np.array([B]), np.zeros((1, 6)))}
    info = j_noise.gaussian_covariance(pim.cov.numpy() + 1e-12 * np.eye(9))
    factors = [
        ("PriorPose3", np.array([[X]]), to_np(one(state0.R, state0.t)), t_noise.isotropic(6, 1e-4, np.float64)[None]),
        ("PriorVector3", np.array([[V]]), to_np(one(v0)), t_noise.isotropic(3, 1e-4, np.float64)[None]),
        ("PriorConstantBias", np.array([[B]]), np.zeros((1, 6)), t_noise.isotropic(6, 1e-3, np.float64)[None]),
        ("ImuFactor", np.array([[X, V, X + 1, V + 1, B]]),
         {"pim": to_np(one(*pim)), "n_gravity": to_np(one(params.n_gravity))}, info[None]),
    ]
    return values, factors, s1


def _gn_pair(jg, jv, tg, tv, iters):
    tight = dict(max_iterations=iters, relative_error_tol=1e-14, absolute_error_tol=1e-14)
    jres = j_gauss_newton(jg, jv, JOptParams(solver="dense", **tight))
    tres = t_gauss_newton(tg, tv, TOptParams(solver="multifrontal", **tight), device="cpu")
    return jres, tres


def test_imu_factor_graph_recovers_trajectory(params_pair):
    """The JAX test's 3-state chain, carried across as numpy: the port's
    multifrontal GN meets the JAX package's dense GN and the truth."""
    va, fa, state1 = _three_state_chain(params_pair[1])
    jg, jv = jax_from_arrays(va, fa)
    tg, tv = port_from_arrays(va, fa)
    jres, tres = _gn_pair(jg, jv, tg, tv, 8)
    np.testing.assert_allclose(tres.error_history[0], jres.error_history[0], rtol=1e-12)
    assert tres.error < 1e-8
    got, want = values_np(tres.values, tv.types()), values_np(jres.values, jv.types())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-8)
    np.testing.assert_allclose(tres.values.at(1).t.numpy(), state1.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(tres.values.at(11).numpy(), state1.v.numpy(), atol=1e-5)


def test_gps_factor():
    graph = t_fg.NonlinearFactorGraph(device="cpu")
    values = TValues(device="cpu")
    p = t_pose3.Pose3(torch.eye(3, dtype=F64), torch.tensor([1.0, 2.0, 3.0], dtype=F64))
    values.insert(0, "Pose3", t_pose3.retract(p, torch.tensor([0.1, 0, 0, 0.2, -0.1, 0.3], dtype=F64)))
    graph.add(t_navf.gps_factor(), [0], torch.tensor([1.0, 2.0, 3.0], dtype=F64),
              t_noise.isotropic(3, 0.01, np.float64))
    graph.add(t_prior_factor("Pose3"), [0], p, t_noise.isotropic(6, 10.0, np.float64))
    res = t_gauss_newton(graph, values, TOptParams(max_iterations=20), device="cpu")
    np.testing.assert_allclose(res.values.at(0).t.numpy(), [1.0, 2.0, 3.0], atol=1e-4)


# --- factors: whitened residuals and Jacobians against the JAX package ------------------


def _imu_points(rng, n, pim_j, truth, combined):
    """Random (or exact-truth) variable values for n IMU factors."""
    Ri, ti, vi = _rand_states(rng, n)
    bi = rng.normal(size=(n, 6)) * 0.02
    if truth:
        p = j_pre.PreintegrationParams(None, None, None, jnp.asarray([0.0, 0.0, -G]))
        sj = jax.jit(jax.vmap(lambda pm, s, b: j_pre.predict(pm, p, s, b)))(
            pim_j, j_ns.NavState(*map(jnp.asarray, (Ri, ti, vi))), jnp.asarray(bi))
        Rj, tj, vj = (np.asarray(a) for a in sj)
        bj = bi.copy()
    else:
        Rj, tj, vj = _rand_states(rng, n)
        bj = rng.normal(size=(n, 6)) * 0.02
    xs = [(Ri, ti), vi, (Rj, tj), vj, bi] + ([bj] if combined else [])
    return xs


def _nav_case(name, truth, rng, pim_pair):
    """(factor name, xs numpy, params numpy, sqrt_info) for n = 5 factors."""
    n = 5
    jpim, tpim = pim_pair
    if name in ("ImuFactor", "CombinedImuFactor"):
        combined = name == "CombinedImuFactor"
        xs = _imu_points(rng, n, jpim, truth, combined)
        params = {"pim": to_np(tuple(tpim)), "n_gravity": np.tile([0.0, 0.0, -G], (n, 1))}
        d = 15 if combined else 9
        cov = np.asarray(jax.vmap(lambda p: j_navf.combined_covariance(p, j_pre.default_params()))(jpim))
        info = j_noise.gaussian_covariance(cov[:, :d, :d])
        return xs, params, info
    if name == "GPSFactor":
        R, t, _ = _rand_states(rng, n)
        meas = t.copy() if truth else t + rng.normal(size=(n, 3))
        return [(R, t)], meas, np.broadcast_to(np.eye(3) / 0.5, (n, 3, 3)).copy()
    if name == "PriorVector3":
        v = rng.normal(size=(n, 3))
        meas = v.copy() if truth else v + rng.normal(size=(n, 3))
        return [v], meas, np.broadcast_to(np.eye(3) / 0.1, (n, 3, 3)).copy()
    raise KeyError(name)


_JITTED = {}


def check_factor_against_jax(name, xs, params, info, jft, tft, var_types):
    def jlay(t, x):
        return _J_LAYOUTS[t](*map(jnp.asarray, x)) if t in _J_LAYOUTS else jnp.asarray(x)

    def tlay(t, x):
        return convert._LAYOUTS[t](*to_t(x)) if t in convert._LAYOUTS else torch.tensor(x)

    jxs = tuple(jlay(t, x) for t, x in zip(var_types, xs))
    txs = tuple(tlay(t, x) for t, x in zip(var_types, xs))
    jp = _j_params(name, jft, params)
    tp = convert._PARAM_LAYOUTS.get(name, lambda p: p)(params)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tp)
    if jft.name not in _JITTED:  # one compile per factor type and shape
        _JITTED[jft.name] = jax.jit(lambda x, p, s: j_fg.residual_and_jac(jft, None, x, p, s))
    jr, jJ = _JITTED[jft.name](jxs, jp, jnp.asarray(info))
    tr, tJ = t_fg.residual_and_jac(tft, None, txs, tp, torch.tensor(info))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-10, rtol=0)
    assert len(tJ) == len(jJ)
    for a, b in zip(tJ, jJ):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0)
    return tr


NAV_FACTORS = {
    "ImuFactor": (j_navf.imu_factor, t_navf.imu_factor),
    "CombinedImuFactor": (j_navf.combined_imu_factor, t_navf.combined_imu_factor),
    "GPSFactor": (j_navf.gps_factor, t_navf.gps_factor),
    "PriorVector3": (j_navf.velocity_prior, t_navf.velocity_prior),
}


@pytest.mark.parametrize("truth", [False, True], ids=["random", "truth"])
@pytest.mark.parametrize("name", list(NAV_FACTORS))
def test_nav_factor_residual_and_jacobians(name, truth, pim_pair):
    rng = np.random.default_rng(6)
    xs, params, info = _nav_case(name, truth, rng, pim_pair)
    jft, tft = (make() for make in NAV_FACTORS[name])
    assert tft.name == jft.name and tft.var_types == jft.var_types
    assert tft.resid_dim == jft.resid_dim
    r = check_factor_against_jax(name, xs, params, info, jft, tft, tft.var_types)
    if truth:
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-8)


def test_velocity_prior_and_vector3_prior_share_a_batch():
    """velocity_prior and prior_factor("Vector3") are both "PriorVector3":
    a graph stages them in one batch, and its error is the same whichever
    was added first (their residuals are the same, v - measured)."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(4, 3))
    meas = v + rng.normal(size=(4, 3))
    info = t_noise.isotropic(3, 0.2, np.float64)
    values = TValues(device="cpu").insert_batch(np.arange(4), "Vector3", torch.tensor(v))
    errs = []
    for order in ((t_navf.velocity_prior(), t_prior_factor("Vector3")),
                  (t_prior_factor("Vector3"), t_navf.velocity_prior())):
        g = t_fg.NonlinearFactorGraph(device="cpu")
        for i in range(4):
            g.add(order[i % 2], [i], torch.tensor(meas[i]), info)
        errs.append(float(g.error(values)))
        assert len(g.batches) == 1
    want = 0.5 * np.sum((np.einsum("ij,nj->ni", info, v - meas)) ** 2)
    np.testing.assert_allclose(errs, [want, want], rtol=1e-14)


# --- the drive ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drive20():
    return synthetic.imu_gps_drive(20, 50, seed=0, device="cpu")


def test_imu_gps_drive_layout(drive20):
    va, fa, truth = drive20
    assert [f[0] for f in fa] == ["PriorPose3", "PriorVector3", "PriorConstantBias",
                                  "CombinedImuFactor", "GPSFactor"]
    assert fa[3][1].shape == (19, 6) and fa[3][3].shape == (19, 15, 15)
    assert truth["imu"]["acc"].shape == (19, 50, 3)
    assert {t: len(k) for t, (k, _) in va.items()} == {"Pose3": 20, "Vector3": 20, "ConstantBias": 20}
    # the drive's PIMs are one batched pass: interval 7 integrated alone is the same
    params = t_pre.default_params(device="cpu")
    one = t_pre.preintegrate(params, *(torch.tensor(truth["imu"][k][7]) for k in ("acc", "omega", "dts")))
    assert_tree_rel(tuple(f[7] for f in fa[3][2]["pim"]), one, 1e-13)


@pytest.fixture(scope="module")
def drive20_gn(drive20):
    """The 20-keyframe drive solved from its start by the JAX package's dense
    GN and the port's multifrontal GN on the CPU: (ports graph, JAX result,
    port result)."""
    va, fa, _ = drive20
    jg, jv = jax_from_arrays(va, fa)
    tg, tv = port_from_arrays(va, fa)
    return (tg, tv) + _gn_pair(jg, jv, tg, tv, 6)


def test_imu_gps_drive_gn_against_jax(drive20, drive20_gn):
    """The 20-keyframe drive: the JAX package's dense GN and the port's
    multifrontal GN on the CPU reach the same values (atol 1e-8)."""
    _, _, truth = drive20
    tg, tv, jres, tres = drive20_gn
    np.testing.assert_allclose(tres.error_history[0], jres.error_history[0], rtol=1e-12)
    got, want = values_np(tres.values, tv.types()), values_np(jres.values, tv.types())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-8)
    assert imu_gps.ate(tres.values, truth) < 1.0


@pytest.fixture(scope="module")
def drive20_isam2(drive20):
    """The port's ISAM2 on the CPU over the 20-keyframe drive, one update a
    keyframe (IMUKittiExampleGPS's loop, models/imu_gps.py) at ISAM2Params()
    defaults, block_dim unset: d = 6 and the 15-row CombinedImuFactor in
    three row blocks. (run, its estimate after update 6)."""
    va, fa, truth = drive20
    snap = {}
    run = imu_gps.run_imu_gps_isam2(
        va, fa, truth, device="cpu",
        step_cb=lambda k, isam, res: snap.setdefault(k, isam.calculate_estimate()) if k == 5 else None)
    return run, snap[5]


def test_isam2_on_the_drive(drive20, drive20_gn, drive20_isam2):
    """The port's ISAM2 over the 20-keyframe drive (drive20_isam2): finite,
    no bad pivots; its first 6 updates equal to a run at block_dim 15 (no
    row blocks; rel 1e-9); batch LM of its final graph from its estimate
    meets the batch GN optimum from the drive's start (rel 1e-6), no higher
    than its final error. (Its final error is not within 1e-3 of that
    optimum: at the default relinearize threshold 0.1 and skip 10, ISAM2
    keeps linearization points up to 0.1 off; the JAX package's ISAM2 gives
    the same final error on this loop: test_isam2_matches_jax_on_the_drive.)"""
    va, fa, truth = drive20
    run, est6 = drive20_isam2
    assert run.isam.row_blocks(t_navf.combined_imu_factor()) == 3
    assert all(int(u.bad_pivots) == 0 for u in run.updates)
    wide = imu_gps.run_imu_gps_isam2(va, fa, truth, 6, params=ISAM2Params(device="cpu", block_dim=15),
                                     device="cpu")
    a, b = values_np(est6, va), values_np(wide.estimate(), va)
    scale = max(np.abs(x).max() for x in b.values())
    assert max(np.abs(a[k] - b[k]).max() for k in b) <= 1e-9 * scale
    est = run.estimate()
    err = float(run.graph.error(est))
    assert np.isfinite(err)
    for t in est.types():
        assert all(torch.isfinite(x).all() for x in jax.tree_util.tree_leaves(est.params(t)))
    optimum = drive20_gn[3].error
    from_est = t_levenberg_marquardt(run.graph, est, TLMParams(
        solver="multifrontal", max_iterations=20, relative_error_tol=1e-10, absolute_error_tol=1e-10),
        device="cpu")
    assert abs(from_est.error - optimum) <= 1e-6 * optimum, (from_est.error_history, optimum)
    assert err >= optimum * (1 - 1e-9)
    assert imu_gps.ate(est, truth) < 1.0


def test_isam2_split_factor_linearized_once(monkeypatch):
    """ISAM2 linearizes a factor split into row blocks once, whole, when it
    is added and when it is relinearized (update 10, relinearize_skip 10),
    never a row block on its own. The row-block families survive a
    checkpoint: a relinearizing update after the reload equals the same
    update without it."""
    from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
    from gtsam_petercdev_torch.utils import serialization

    va, fa, truth = synthetic.imu_gps_drive(12, 10, seed=1, device="cpu")
    names = []
    real = t_isam2.residual_and_jac
    monkeypatch.setattr(t_isam2, "residual_and_jac",
                        lambda ftype, *a: names.append(ftype.name) or real(ftype, *a))
    run = imu_gps.run_imu_gps_isam2(va, fa, truth, 11, device="cpu")
    assert run.updates[9].n_relinearized > 0
    assert names.count("CombinedImuFactor") > 10 and not any("@rows" in n for n in names)
    assert len(run.isam._families) == 3
    back = serialization.isam2_from_bytes(serialization.isam2_to_bytes(run.isam), device="cpu")
    assert {g: (ft.name, fam) for g, (ft, fam) in back._families.items()} == \
        {g: (ft.name, fam) for g, (ft, fam) in run.isam._families.items()}
    x, v, b = (truth["keys"][c][11] for c in "xvb")
    ests = []
    for isam in (run.isam, back):
        new = TValues(device="cpu")
        new.insert(x, "Pose3", t_pose3.Pose3(torch.tensor(truth["R"][11]), torch.tensor(truth["t"][11])))
        new.insert(v, "Vector3", torch.tensor(truth["v"][11]))
        new.insert(b, "ConstantBias", torch.zeros(6, dtype=F64))
        names.clear()
        res = isam.update(convert.graph_from_arrays(imu_gps.keyframe_rows(fa, 11), device="cpu"),
                          new, force_relinearize=True)
        assert res.n_relinearized > 0 and not any("@rows" in n for n in names)
        ests.append(values_np(isam.calculate_estimate(), va))
    scale = max(np.abs(e).max() for e in ests[0].values())
    assert max(np.abs(ests[1][k] - ests[0][k]).max() for k in ests[0]) <= 1e-12 * scale


def _isam2_reference_tool():
    """tools/imu_isam2_reference.py as a module: its `jax_run` is the JAX
    package's ISAM2 on IMUKittiExampleGPS's loop."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "imu_isam2_reference.py"
    spec = importlib.util.spec_from_file_location("imu_isam2_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_isam2_matches_jax_on_the_drive(drive20, drive20_isam2):
    """The same 20 updates through the JAX package's ISAM2 (block_dim 15: it
    takes no factor wider than its block) and the port's (d = 6, row
    blocks), relinearizing at updates 10 and 20: the same final error (rel
    1e-9) and estimate (1e-9 x its largest entry)."""
    va, fa, truth = drive20
    run, _ = drive20_isam2
    tool = _isam2_reference_tool()
    jest = tool.jax_run(va, fa, truth, len(truth["keys"]["x"]))
    assert sum(u.n_relinearized for u in run.updates) > 0
    e_port = float(run.graph.error(run.estimate()))
    e_jax = float(tool.jax_graph(imu_gps.drive_rows(fa, len(truth["keys"]["x"]))).error(jest))
    assert abs(e_port - e_jax) <= 1e-9 * e_jax, (e_port, e_jax)
    a, b = values_np(run.estimate(), va), values_np(jest, va)
    scale = max(np.abs(x).max() for x in b.values())
    assert max(np.abs(a[k] - b[k]).max() for k in b) <= 1e-9 * scale


def test_isam2_reference_file():
    """tests/data/imu_isam2_reference.json (tools/imu_isam2_reference.py),
    against which chip_smoke.py phase 12 c) gates the card's ISAM2: it is
    that phase's loop; on one tree ordering (the proxy COLAMD) the port's
    ISAM2 on the CPU and the JAX package's end within rel 1e-9, and the
    port's own AMD ordering within 1e-9 of that; each package on its own
    ordering within 1e-3 (where their trees part, the wildfire stops
    elsewhere); the optimum lies below every ISAM2 error and within 1e-9
    of its LM run and the GN polish after it."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ref = json.loads((root / cs.NAV_ISAM2_REF).read_text())
    assert (ref["drive_keyframes"], ref["isam2_keyframes"], ref["rate_hz"], ref["seed"]) == \
        (cs.NAV_KEYFRAMES, cs.NAV_ISAM2_KEYFRAMES, cs.NAV_RATE, cs.SEED)
    assert ref["bias_walk"] == list(synthetic.DRIVE_BIAS_WALK)
    px = ref["proxy_ordering"]
    assert px["port_rel_jax"] <= 1e-9 and px["port_rel_port_own_ordering"] <= 1e-9
    assert ref["port_rel_jax"] <= cs.NAV_ORDERING_GATE
    opt = ref["optimum"]
    errors = [ref["port_cpu_isam2_error"], ref["jax_isam2_error"], px["port_cpu_isam2_error"],
              px["jax_isam2_error"]]
    assert all(e > opt for e in errors)
    assert all(abs(e - opt) <= 1e-9 * opt for e in [ref["optimum_lm_error"]] + ref["optimum_gn_history"])
    np.testing.assert_allclose(ref["jax_isam2_over_optimum"], ref["jax_isam2_error"] / opt, rtol=1e-15)
    np.testing.assert_allclose(ref["jax_isam2_proxy_over_optimum"], px["jax_isam2_error"] / opt,
                               rtol=1e-15)


# --- carrying a JAX navigation graph across --------------------------------------------


def test_convert_carries_every_navigation_factor(pim_pair):
    """A graph of every navigation factor type, built by the JAX package and
    read out as numpy, rebuilt in the port: the same error (rel 1e-12)."""
    rng = np.random.default_rng(8)
    jpim, _ = pim_pair
    jp = j_pre.default_params()
    g = j_fg.NonlinearFactorGraph()
    v = JValues()
    R = rand_rot(rng, 12)
    for i in range(4):
        v.insert(i, "Pose3", j_pose3.Pose3(jnp.asarray(R[i]), jnp.asarray(rng.normal(size=3))))
        v.insert(10 + i, "Vector3", jnp.asarray(rng.normal(size=3)))
        v.insert(20 + i, "ConstantBias", jnp.asarray(rng.normal(size=6) * 0.02))
        v.insert(30 + i, "Rot3", jnp.asarray(R[4 + i]))
        v.insert(40 + i, "NavState", j_ns.NavState(jnp.asarray(R[8 + i]), jnp.asarray(rng.normal(size=3)),
                                                   jnp.asarray(rng.normal(size=3))))
    v.insert(50, "Vector1", jnp.asarray([1.3]))
    cov = np.asarray(jax.vmap(lambda p: j_navf.combined_covariance(p, jp))(jpim))
    for i in range(3):
        pim_i = jax.tree_util.tree_map(lambda a: a[i], jpim)
        prm = {"pim": pim_i, "n_gravity": jp.n_gravity}
        g.add(j_navf.imu_factor(), [i, 10 + i, i + 1, 11 + i, 20 + i], prm,
              j_noise.gaussian_covariance(cov[i, :9, :9]))
        g.add(j_navf.combined_imu_factor(), [i, 10 + i, i + 1, 11 + i, 20 + i, 21 + i], prm,
              j_noise.gaussian_covariance(cov[i]))
        rot = j_ahrs.preintegrate_rotation(jp.gyro_cov, jnp.asarray(rng.normal(size=(20, 3)) * 0.2),
                                           jnp.full((20,), 0.01))
        g.add(j_ahrs.ahrs_factor(), [30 + i, 31 + i, 10 + i], rot,
              j_noise.gaussian_covariance(np.asarray(rot.cov)))
        g.add(j_extra.constant_velocity_factor(), [40 + i, 41 + i], {"dt": jnp.asarray(0.5)},
              j_noise.isotropic(9, 0.3, jnp.float64))
    for i in range(4):
        d = rng.normal(size=3)
        g.add(j_navf.gps_factor(), [i], jnp.asarray(rng.normal(size=3)), j_noise.isotropic(3, 0.5, jnp.float64))
        g.add(j_navf.velocity_prior(), [10 + i], jnp.asarray(rng.normal(size=3)),
              j_noise.isotropic(3, 0.2, jnp.float64))
        att = {"nZ": jnp.asarray(d / np.linalg.norm(d)), "bRef": jnp.asarray([0.0, 0.0, 1.0])}
        g.add(j_extra.rot3_attitude_factor(), [30 + i], att, j_noise.isotropic(2, 0.1, jnp.float64))
        g.add(j_extra.pose3_attitude_factor(), [i], att, j_noise.isotropic(2, 0.1, jnp.float64))
        mag = {"measured": jnp.asarray(rng.normal(size=3)), "scale": jnp.asarray(1.5),
               "direction": jnp.asarray(rng.normal(size=3)), "bias": jnp.asarray(rng.normal(size=3) * 0.1)}
        g.add(j_extra.mag_factor(), [30 + i], mag, j_noise.isotropic(3, 0.2, jnp.float64))
        g.add(j_extra.mag_pose_factor(), [i], mag, j_noise.isotropic(3, 0.2, jnp.float64))
        g.add(j_extra.mag_factor_calibration(), [50, 10 + i],
              {"measured": jnp.asarray(rng.normal(size=3)), "nRb": jnp.asarray(R[i]),
               "direction": jnp.asarray(rng.normal(size=3))}, j_noise.isotropic(3, 0.2, jnp.float64))
        g.add(j_extra.barometric_factor(), [i, 50], jnp.asarray([rng.normal()]),
              j_noise.isotropic(1, 0.3, jnp.float64))
        g.add(j_prior_factor("ConstantBias"), [20 + i], jnp.zeros(6), j_noise.isotropic(6, 0.1, jnp.float64))
    va, fa = jax_to_arrays(g, v)
    assert {f[0] for f in fa} >= set(convert._NAVIGATION)
    tg, tv = port_from_arrays(va, fa)
    g._materialize()
    np.testing.assert_allclose(float(tg.error(tv)), float(jax.jit(g.error)(v)), rtol=1e-12)
    # and batch by batch
    for jb, tb in zip(g.batches, tg.batches):
        assert jb.ftype.name == tb.ftype.name


# --- no card, no run -------------------------------------------------------------------


@pytest.mark.parametrize("entry", [
    lambda: t_pre.default_params(),
    lambda: t_pre.pim_init(),
    lambda: t_ns.identity(),
    lambda: synthetic.imu_gps_drive(3, 10),
])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
