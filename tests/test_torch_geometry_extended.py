"""The port's extended geometry and the factors on it against the JAX
package's: core/manifold.py's extended registrations, geometry/sim3.py,
essential.py and extra.py, sam/factors.py, slam/extra_factors.py and their
carry-across by utils/convert.py.

Inputs come from np.random.default_rng(seed) (or are the JAX tests' own
scenes, or utils/synthetic's phase-15 scenes cut small) and go through both
packages; the port runs on the CPU in float64 unless stated. Tolerances:
the geometry functions atol 1e-12 (SO(n)'s expmap, torch.linalg.matrix_exp
against jax.scipy.linalg.expm, 1e-12 too); the fundamental matrix rebuilt
from its parameters and its epipolar errors 1e-12 (the SVD's singular
vectors may differ in sign); every new factor's residual, whitened
Jacobians and rhs through a carried-across graph atol 1e-12, its error rel
1e-12; LM results atol 1e-9; a float32 Sim3 linearization within 1e-4
(rel) of the float64 one. The JAX tests mirrored: tests/
test_geometry_extended.py, the geometry-extras part of tests/
test_geometry_breadth.py and tests/test_slam_extra.py's classes up to
TestPlanarProjection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.core import manifold as t_manifold
from gtsam_petercdev_torch.geometry import essential as t_ess
from gtsam_petercdev_torch.geometry import extra as t_extra
from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.geometry import sim3 as t_sim3
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_torch.geometry import unit3 as t_unit3
from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.linear import solve as t_linsolve
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.sam import factors as t_sam
from gtsam_petercdev_torch.slam import extra_factors as t_extra_f
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.basis import chebyshev as j_cheb
from gtsam_petercdev_tpu.basis import fit as j_fit
from gtsam_petercdev_tpu.core import manifold as j_manifold
from gtsam_petercdev_tpu.geometry import essential as j_ess
from gtsam_petercdev_tpu.geometry import extra as j_extra
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.geometry import sim3 as j_sim3
from gtsam_petercdev_tpu.geometry import so3 as j_so3
from gtsam_petercdev_tpu.linear import solve as j_linsolve
from gtsam_petercdev_tpu.nonlinear import factor_graph as j_fg
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.sam import factors as j_sam
from gtsam_petercdev_tpu.slam import extra_factors as j_extra_f
from gtsam_petercdev_tpu.slam import factors as j_factors

F64 = torch.float64
GEO_TOL = 1e-12
LM_TOL = 1e-9
# the tangent offset at which the JAX side's Jacobians are taken: its Unit3
# retract and local take jnp.linalg.norm of a zero vector at the zero
# tangent, whose forward-mode derivative is NaN in JAX (every factor on a
# Unit3, EssentialMatrix or OrientedPlane3 value linearizes to NaN there);
# 1e-30 away the derivative is the exact one to rounding
JAX_EPS = 1e-30
# factors whose JAX Jacobians take seconds to compile (the Sim3 series)
HEAVY = ("BetweenSim3", "PriorSim3")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, atol):
    for x, y in zip(jax.tree_util.tree_leaves(_np(a)), jax.tree_util.tree_leaves(_np(b))):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


# --- random values of each type (numpy, the convert layout) ----------------------------

_J_LAYOUTS = {"Pose3": j_pose3.Pose3, "Sim3": j_sim3.Sim3, "EssentialMatrix": j_ess.EssentialMatrix,
              "OrientedPlane3": j_ess.OrientedPlane3, "Line3": j_ess.Line3}


def _rot(rng, n, s=0.6):
    return t_so3.expmap(torch.tensor(rng.normal(size=(n, 3)) * s)).numpy()


def _unit(rng, n):
    u = rng.normal(size=(n, 3))
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def _rand(t, n, rng):
    if t == "Pose2":
        return np.c_[rng.normal(size=(n, 2)) * 2, rng.uniform(-3, 3, n)]
    if t in ("Point2", "Point3"):
        return rng.normal(size=(n, int(t[-1]))) * 3
    if t == "Rot3":
        return _rot(rng, n)
    if t == "Pose3":
        return _rot(rng, n), rng.normal(size=(n, 3)) * 2
    if t == "Sim3":
        return _rot(rng, n), rng.normal(size=(n, 3)) * 2, np.exp(rng.normal(size=n) * 0.3)
    if t == "EssentialMatrix":
        return _rot(rng, n, 0.2), _unit(rng, n)
    if t == "OrientedPlane3":
        return _unit(rng, n), rng.normal(size=n) * 2
    if t == "Line3":
        return _rot(rng, n), rng.normal(size=n), rng.normal(size=n)
    if t == "Unit3":
        return _unit(rng, n)
    if t.startswith("Vector"):
        return rng.normal(size=(n, int(t[6:])))
    raise KeyError(t)


def _jlayout(t, arr):
    if t in _J_LAYOUTS:
        return _J_LAYOUTS[t](*(jnp.asarray(a) for a in arr))
    return jnp.asarray(arr)


def _near(val, rng, t):
    """A value of type t near `val` (numpy layout), for measurements."""
    m = t_manifold.get(t)
    tv = convert._layout(t, tuple(torch.tensor(a) for a in val) if isinstance(val, tuple)
                         else torch.tensor(val))
    n = (tv[0] if isinstance(tv, tuple) else tv).shape[0]
    return _np(m.retract(tv, torch.tensor(rng.normal(size=(n, m.dim)) * 0.1)))


# --- 1. the extended registrations -------------------------------------------------------

EXTENDED = ["Sim3", "Unit3", "EssentialMatrix", "OrientedPlane3", "Line3"]


@pytest.mark.parametrize("t", EXTENDED)
def test_extended_registrations(t):
    rng = np.random.default_rng(EXTENDED.index(t))
    jm, tm = j_manifold.get(t), t_manifold.get(t)
    assert tm.dim == jm.dim
    a, b = _rand(t, 6, rng), _near(_rand(t, 6, rng), rng, t)
    xi = rng.normal(size=(6, tm.dim)) * 0.3
    ta = convert._layout(t, _t(a))
    _close(tm.retract(ta, torch.tensor(xi)), jm.retract(_jlayout(t, a), jnp.asarray(xi)), GEO_TOL)
    _close(tm.local(ta, convert._layout(t, _t(b))), jm.local(_jlayout(t, a), _jlayout(t, b)), GEO_TOL)
    _close(tm.identity(F64, "cpu"), jm.identity(jnp.float64), 0.0)
    for op in ("compose", "inverse", "between", "expmap", "logmap"):
        assert (getattr(tm, op) is None) == (getattr(jm, op) is None)


# --- 2. Sim3 ------------------------------------------------------------------------------


def test_sim3_functions_match_jax():
    rng = np.random.default_rng(0)
    xi1, xi2 = rng.normal(size=(8, 7)) * 0.4, rng.normal(size=(8, 7)) * 0.3
    p = rng.normal(size=(8, 3))
    ja, jb = j_sim3.expmap(jnp.asarray(xi1)), j_sim3.expmap(jnp.asarray(xi2))
    ta, tb = t_sim3.expmap(torch.tensor(xi1)), t_sim3.expmap(torch.tensor(xi2))
    _close(ta, ja, GEO_TOL)
    for fn in ("compose", "between", "local"):
        _close(getattr(t_sim3, fn)(ta, tb), getattr(j_sim3, fn)(ja, jb), GEO_TOL)
    for fn in ("inverse", "logmap", "matrix"):
        _close(getattr(t_sim3, fn)(ta), getattr(j_sim3, fn)(ja), GEO_TOL)
    _close(t_sim3.retract(ta, torch.tensor(xi2)), j_sim3.retract(ja, jnp.asarray(xi2)), GEO_TOL)
    _close(t_sim3.transform_from(ta, torch.tensor(p)), j_sim3.transform_from(ja, jnp.asarray(p)),
           GEO_TOL)
    # the series itself, term for term
    _close(t_sim3._W(torch.tensor(xi1[:, :3]), torch.tensor(xi1[:, 6])),
           j_sim3._W(jnp.asarray(xi1[:, :3]), jnp.asarray(xi1[:, 6])), GEO_TOL)


def test_sim3_group_axioms(rng):
    xi1, xi2 = torch.tensor(rng.normal(size=7) * 0.3), torch.tensor(rng.normal(size=7) * 0.3)
    g1, g2 = t_sim3.expmap(xi1), t_sim3.expmap(xi2)
    np.testing.assert_allclose(t_sim3.logmap(g1).numpy(), xi1.numpy(), atol=1e-9)
    e = t_sim3.compose(g1, t_sim3.inverse(g1))
    np.testing.assert_allclose(e.R.numpy(), np.eye(3), atol=1e-9)
    np.testing.assert_allclose(e.t.numpy(), 0, atol=1e-9)
    np.testing.assert_allclose(float(e.s), 1.0, atol=1e-9)
    p = torch.tensor(rng.normal(size=3))
    lhs = t_sim3.transform_from(t_sim3.compose(g1, g2), p)
    rhs = t_sim3.transform_from(g1, t_sim3.transform_from(g2, p))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-9)
    np.testing.assert_allclose(float(t_sim3.compose(g1, g2).s), float(g1.s) * float(g2.s),
                               atol=1e-12)


def test_sim3_retract_local_roundtrip(rng):
    m = t_manifold.get("Sim3")
    g = t_sim3.expmap(torch.tensor(rng.normal(size=7) * 0.4))
    xi = torch.tensor(rng.normal(size=7) * 0.2)
    np.testing.assert_allclose(m.local(g, m.retract(g, xi)).numpy(), xi.numpy(), atol=1e-9)


def test_unit3_retract_local_roundtrip(rng):
    for _ in range(5):
        p = t_unit3.normalize(torch.tensor(rng.normal(size=3)))
        xi = torch.tensor(rng.normal(size=2) * 0.4)
        q = t_unit3.retract(p, xi)
        np.testing.assert_allclose(float(torch.linalg.norm(q)), 1.0, atol=1e-12)
        np.testing.assert_allclose(t_unit3.local(p, q).numpy(), xi.numpy(), atol=1e-9)


# --- 3. EssentialMatrix, OrientedPlane3, Line3 ------------------------------------------------


def test_essential_plane_line_functions_match_jax():
    rng = np.random.default_rng(1)
    R, t = _rot(rng, 6, 0.3), rng.normal(size=(6, 3))
    jE, tE = j_ess.essential_from_pose(jnp.asarray(R), jnp.asarray(t)), \
        t_ess.essential_from_pose(torch.tensor(R), torch.tensor(t))
    _close(tE, jE, GEO_TOL)
    _close(t_ess.essential_matrix(tE), j_ess.essential_matrix(jE), GEO_TOL)
    pA, pB = rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    _close(t_ess.epipolar_error(tE, torch.tensor(pA), torch.tensor(pB)),
           j_ess.epipolar_error(jE, jnp.asarray(pA), jnp.asarray(pB)), GEO_TOL)
    c = rng.normal(size=(4, 6))
    jp = j_ess.plane_from_coeffs(*(jnp.asarray(x) for x in c))
    tp = t_ess.plane_from_coeffs(*(torch.tensor(x) for x in c))
    _close(tp, jp, GEO_TOL)
    pt = rng.normal(size=(6, 3))
    _close(t_ess.plane_transform(tp, torch.tensor(R), torch.tensor(t)),
           j_ess.plane_transform(jp, jnp.asarray(R), jnp.asarray(t)), GEO_TOL)
    _close(t_ess.plane_distance(tp, torch.tensor(pt)), j_ess.plane_distance(jp, jnp.asarray(pt)),
           GEO_TOL)
    a, b = rng.normal(size=2)
    jl = j_ess.Line3(jnp.asarray(R[0]), jnp.asarray(a), jnp.asarray(b))
    tl = t_ess.Line3(torch.tensor(R[0]), torch.tensor(a), torch.tensor(b))
    lam = rng.normal(size=5)
    _close(t_ess.line_point(tl, torch.tensor(lam)), j_ess.line_point(jl, jnp.asarray(lam)), GEO_TOL)
    for fn in ("essential_identity", "plane_identity", "line_identity"):
        _close(getattr(t_ess, fn)(F64, "cpu"), getattr(j_ess, fn)(jnp.float64), 0.0)


def test_essential_epipolar_constraint(rng):
    R = t_so3.expmap(torch.tensor(rng.normal(size=3) * 0.2))
    t = t_unit3.normalize(torch.tensor(rng.normal(size=3)))
    E = t_ess.EssentialMatrix(R, t)
    xb = torch.tensor(np.r_[rng.normal(size=2), rng.uniform(2, 5)])
    xa = t_so3.rotate(R, xb) + t
    err = float(t_ess.epipolar_error(E, xa[:2] / xa[2], xb[:2] / xb[2]))
    assert abs(err) < 1e-9


def test_plane_transform_invariant_distance(rng):
    pl = t_ess.plane_from_coeffs(*(torch.tensor(x, dtype=F64) for x in (0.1, 0.5, 1.0, -2.0)))
    point = torch.tensor(rng.normal(size=3))
    pose = t_pose3.expmap(torch.tensor(rng.normal(size=6) * 0.4))
    d1 = float(t_ess.plane_distance(pl, point))
    d2 = float(t_ess.plane_distance(t_ess.plane_transform(pl, pose.R, pose.t),
                                    t_pose3.transform_to(pose, point)))
    np.testing.assert_allclose(d1, d2, atol=1e-9)


def test_line3_retract_local(rng):
    l = t_ess.Line3(t_so3.expmap(torch.tensor(rng.normal(size=3))), torch.tensor(0.3, dtype=F64),
                    torch.tensor(-0.2, dtype=F64))
    xi = torch.tensor(rng.normal(size=4) * 0.3)
    np.testing.assert_allclose(t_ess.line_local(l, t_ess.line_retract(l, xi)).numpy(), xi.numpy(),
                               atol=1e-9)


# --- 4. geometry extras -------------------------------------------------------------------------


def test_spherical_camera_matches_jax():
    xi = np.array([0.1, -0.2, 0.3, 1.0, 2.0, 3.0])
    jp, tp = j_pose3.expmap(jnp.asarray(xi)), t_pose3.expmap(torch.tensor(xi))
    point = np.array([2.0, -1.0, 4.0])
    b = t_extra.spherical_project(tp, torch.tensor(point))
    _close(b, j_extra.spherical_project(jp, jnp.asarray(point)), GEO_TOL)
    np.testing.assert_allclose(float(torch.linalg.norm(b)), 1.0, atol=1e-12)
    depth = float(torch.linalg.norm(t_pose3.transform_to(tp, torch.tensor(point))))
    back = t_extra.spherical_backproject(tp, b, depth)
    np.testing.assert_allclose(back.numpy(), point, atol=1e-9)
    _close(back, j_extra.spherical_backproject(jp, jnp.asarray(b.numpy()), depth), GEO_TOL)
    measured = t_unit3.normalize(b + 0.05)
    _close(t_extra.spherical_reprojection_error(tp, torch.tensor(point), measured),
           j_extra.spherical_reprojection_error(jp, jnp.asarray(point),
                                                jnp.asarray(measured.numpy())), GEO_TOL)
    np.testing.assert_allclose(
        t_extra.spherical_reprojection_error(tp, torch.tensor(point), b).numpy(), 0.0, atol=1e-12)


def _fundamental_scene():
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    R = np.asarray(j_so3.expmap(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.array([1.0, 0.2, -0.1])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return K, R, t, tx @ R


def test_fundamental_matrix_matches_jax():
    rng = np.random.default_rng(3)
    K, R, t, E = _fundamental_scene()
    jF = j_extra.fundamental_from_essential(jnp.asarray(K), jnp.asarray(E), jnp.asarray(K))
    tF = t_extra.fundamental_from_essential(torch.tensor(K), torch.tensor(E), torch.tensor(K))
    _close(tF, jF, GEO_TOL)
    X = rng.standard_normal((5, 3)) * 2 + np.array([0, 0, 6.0])
    X2 = X @ R.T + t
    p1, p2 = (X @ K.T)[:, :2] / X[:, 2:], (X2 @ K.T)[:, :2] / X2[:, 2:]
    te = t_extra.epipolar_error(tF, torch.tensor(p1), torch.tensor(p2))
    _close(te, j_extra.epipolar_error(jF, jnp.asarray(p1), jnp.asarray(p2)), GEO_TOL)
    assert np.abs(te.numpy()).max() < 1e-6
    # the parameters' singular vectors may differ in sign: compare F rebuilt
    tU, ts, tV = t_extra.fundamental_params(tF)
    jU, js, jV = j_extra.fundamental_params(jF)
    np.testing.assert_allclose(float(ts), float(js), rtol=0, atol=GEO_TOL)
    tF2, jF2 = t_extra.fundamental_matrix(tU, ts, tV), j_extra.fundamental_matrix(jU, js, jV)
    _close(tF2, jF2, GEO_TOL)
    for U in (tU, tV):
        np.testing.assert_allclose(torch.linalg.det(U).numpy(), 1.0, atol=1e-12)
    Fn, F2n = tF.numpy() / np.linalg.norm(tF.numpy()), tF2.numpy() / np.linalg.norm(tF2.numpy())
    assert min(np.abs(F2n - Fn).max(), np.abs(F2n + Fn).max()) < 1e-8
    xi = rng.normal(size=7) * 0.1
    tr = t_extra.fundamental_retract(tU, ts, tV, torch.tensor(xi))
    jr = j_extra.fundamental_retract(jU, js, jV, jnp.asarray(xi))
    _close(t_extra.fundamental_matrix(*tr), j_extra.fundamental_matrix(*jr), GEO_TOL)


def test_sim2_group_ops_match_jax():
    g = t_extra.sim2(0.4, [1.0, -2.0], 1.5, device="cpu")
    h = t_extra.sim2(-0.2, [0.3, 0.7], 0.8, device="cpu")
    jg, jh = j_extra.sim2(0.4, [1.0, -2.0], 1.5), j_extra.sim2(-0.2, [0.3, 0.7], 0.8)
    p = torch.tensor([2.0, 3.0], dtype=F64)
    lhs = t_extra.sim2_transform_from(t_extra.sim2_compose(g, h), p)
    rhs = t_extra.sim2_transform_from(g, t_extra.sim2_transform_from(h, p))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-12)
    back = t_extra.sim2_transform_from(t_extra.sim2_inverse(g), t_extra.sim2_transform_from(g, p))
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-12)
    _close(t_extra.sim2_compose(g, h), j_extra.sim2_compose(jg, jh), GEO_TOL)
    _close(t_extra.sim2_inverse(g), j_extra.sim2_inverse(jg), GEO_TOL)
    _close(lhs, j_extra.sim2_transform_from(j_extra.sim2_compose(jg, jh), jnp.asarray(p.numpy())),
           GEO_TOL)
    _close(t_extra.sim2_identity(F64, "cpu"), j_extra.sim2_identity(), 0.0)


@pytest.mark.parametrize("n", [3, 4, 5])
def test_son_matches_jax(n):
    rng = np.random.default_rng(n)
    xi = rng.standard_normal(t_extra.son_dim(n)) * 0.3
    xi2 = rng.standard_normal(t_extra.son_dim(n)) * 0.2
    R = t_extra.son_expmap(torch.tensor(xi), n)
    _close(R, j_extra.son_expmap(jnp.asarray(xi), n), GEO_TOL)  # matrix_exp against expm
    np.testing.assert_allclose((R.T @ R).numpy(), np.eye(n), atol=1e-10)
    Rj = np.asarray(j_extra.son_expmap(jnp.asarray(xi), n))
    _close(t_extra.son_logmap(torch.tensor(Rj), n), j_extra.son_logmap(jnp.asarray(Rj), n), GEO_TOL)
    np.testing.assert_allclose(t_extra.son_logmap(R, n).numpy(), xi, atol=1e-6)
    X = t_extra.son_hat(torch.tensor(xi), n)
    _close(X, j_extra.son_hat(jnp.asarray(xi), n), 0.0)
    np.testing.assert_allclose(t_extra.son_vee(X, n).numpy(), xi, atol=1e-12)
    R2 = np.asarray(j_extra.son_retract(jnp.asarray(Rj), jnp.asarray(xi2), n))
    _close(t_extra.son_retract(torch.tensor(Rj), torch.tensor(xi2), n), R2, GEO_TOL)
    _close(t_extra.son_local(torch.tensor(Rj), torch.tensor(R2), n),
           j_extra.son_local(jnp.asarray(Rj), jnp.asarray(R2), n), GEO_TOL)
    # batched: a stack of elements at once, each equal to its own call
    xs = rng.standard_normal((3, t_extra.son_dim(n))) * 0.3
    Rs = t_extra.son_expmap(torch.tensor(xs), n)
    _close(t_extra.son_logmap(Rs, n)[1], t_extra.son_logmap(Rs[1], n), 1e-15)


def test_son_hat_reference_parity():
    """The hard-coded SOn::Hat matrices of the reference's testSOn.cpp."""
    v = torch.arange(1.0, 11.0, dtype=F64)
    exp4 = np.array([[0, -6, 5, 3], [6, 0, -4, -2], [-5, 4, 0, 1], [-3, 2, -1, 0]], dtype=float)
    np.testing.assert_allclose(t_extra.son_hat(v[:6], 4).numpy(), exp4)
    exp5 = np.array([[0, -10, 9, 7, -4], [10, 0, -8, -6, 3], [-9, 8, 0, 5, -2], [-7, 6, -5, 0, 1],
                     [4, -3, 2, -1, 0]], dtype=float)
    np.testing.assert_allclose(t_extra.son_hat(v, 5).numpy(), exp5)
    np.testing.assert_allclose(t_extra.son_vee(torch.tensor(exp5), 5).numpy(), v.numpy())


# --- 5-7. every new factor: residual, Jacobians, carry-across -----------------------------


def _planar_params(rng, n, vals=None):
    Rbc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    return {"landmark": np.c_[rng.uniform(4, 6, n), rng.normal(size=(n, 2))],
            "cal": np.tile([100.0, 100.0, 0.0, 320.0, 240.0], (n, 1)),
            "body_P_cam_R": np.broadcast_to(Rbc, (n, 3, 3)).copy(),
            "body_P_cam_t": rng.normal(size=(n, 3)) * 0.1, "measured": rng.normal(size=(n, 2))}


# name -> (JAX factor type, numpy params of n factors (rng, n, the values))
FACTORS = {
    "RangePose2Point2": (lambda: j_sam.range_factor("Pose2", "Point2"),
                         lambda rng, n, v: rng.uniform(1, 3, n)),
    "RangePose3Point3": (lambda: j_sam.range_factor("Pose3", "Point3"),
                         lambda rng, n, v: rng.uniform(1, 3, n)),
    "BearingPose2Point2": (j_sam.bearing_factor_2d, lambda rng, n, v: rng.uniform(-3, 3, n)),
    "BearingRangePose2Point2": (j_sam.bearing_range_factor_2d,
                                lambda rng, n, v: np.c_[rng.uniform(-3, 3, n), rng.uniform(1, 3, n)]),
    "BearingPose3Point3": (j_sam.bearing_factor_3d, lambda rng, n, v: _unit(rng, n)),
    "FrobeniusFactor": (j_extra_f.frobenius_factor, lambda rng, n, v: None),
    "FrobeniusBetweenFactor": (j_extra_f.frobenius_between_factor, lambda rng, n, v: _rot(rng, n)),
    "KarcherMeanFactor3": (lambda: j_extra_f.karcher_mean_factor(3), lambda rng, n, v: None),
    "PoseRotationPrior": (j_extra_f.pose_rotation_prior, lambda rng, n, v: _rot(rng, n)),
    "PoseTranslationPrior": (j_extra_f.pose_translation_prior,
                             lambda rng, n, v: rng.normal(size=(n, 3))),
    "RotateFactor": (j_extra_f.rotate_factor,
                     lambda rng, n, v: {"p": rng.normal(size=(n, 3)), "z": rng.normal(size=(n, 3))}),
    "RotateDirectionsFactor": (j_extra_f.rotate_directions_factor,
                               lambda rng, n, v: {"p": rng.normal(size=(n, 3)),
                                                  "z": rng.normal(size=(n, 3))}),
    "EssentialMatrixFactor": (j_extra_f.essential_matrix_factor,
                              lambda rng, n, v: {"pA": rng.normal(size=(n, 2)),
                                                 "pB": rng.normal(size=(n, 2))}),
    "EssentialMatrixConstraint": (j_extra_f.essential_matrix_constraint,
                                  lambda rng, n, v: _rand("EssentialMatrix", n, rng)),
    "OrientedPlane3Factor": (j_extra_f.oriented_plane3_factor,
                             lambda rng, n, v: _rand("OrientedPlane3", n, rng)),
    "OrientedPlane3DirectionPrior": (j_extra_f.oriented_plane3_direction_prior,
                                     lambda rng, n, v: _near(v[0], rng, "OrientedPlane3")),
    "ReferenceFrameFactor": (j_extra_f.reference_frame_factor, lambda rng, n, v: None),
    "PlanarProjectionFactor": (j_extra_f.planar_projection_factor, _planar_params),
    "AntiBetweenPose2": (lambda: j_extra_f.anti_factor(j_factors.between_factor("Pose2")),
                         lambda rng, n, v: _rand("Pose2", n, rng)),
    "AntiBetweenPose3": (lambda: j_extra_f.anti_factor(j_factors.between_factor("Pose3")),
                         lambda rng, n, v: _near(v[0], rng, "Pose3")),
    "BetweenSim3": (lambda: j_factors.between_factor("Sim3"),
                    lambda rng, n, v: _near(v[0], rng, "Sim3")),
    "PriorSim3": (lambda: j_factors.prior_factor("Sim3"), lambda rng, n, v: _near(v[0], rng, "Sim3")),
    "PriorEssentialMatrix": (lambda: j_factors.prior_factor("EssentialMatrix"),
                             lambda rng, n, v: _near(v[0], rng, "EssentialMatrix")),
    "PriorOrientedPlane3": (lambda: j_factors.prior_factor("OrientedPlane3"),
                            lambda rng, n, v: _near(v[0], rng, "OrientedPlane3")),
    "PriorLine3": (lambda: j_factors.prior_factor("Line3"), lambda rng, n, v: _near(v[0], rng, "Line3")),
    "PriorUnit3": (lambda: j_factors.prior_factor("Unit3"), lambda rng, n, v: _near(v[0], rng, "Unit3")),
    "BasisEval8_chebyshev2_weights": (
        lambda: j_fit.evaluation_factor(8, j_cheb.chebyshev2_weights),
        lambda rng, n, v: {"x": rng.uniform(-1, 1, n), "y": rng.normal(size=n)}),
}


def _one_batch(name, n=4, seed=0):
    """A graph of one batch of `name` (n factors, each on its own variables)
    and its values, as convert's numpy arrays and as JAX objects."""
    rng = np.random.default_rng(seed)
    jft = FACTORS[name][0]()
    vals, keys = [], []
    for k, t in enumerate(jft.var_types):
        vals.append(_rand(t, n, rng))
        keys.append(100 * k + np.arange(n))
    params = FACTORS[name][1](rng, n, vals)
    d = jft.resid_dim
    L = np.tril(rng.normal(size=(n, d, d)) * 0.2) + np.eye(d) * rng.uniform(0.5, 2.0, (n, d, 1))
    keys = np.stack(keys, axis=1)
    varrays = {}
    for k, t in enumerate(jft.var_types):
        ks, vs = varrays.get(t, (np.zeros(0, np.int64), None))
        varrays[t] = (np.r_[ks, keys[:, k]], vals[k] if vs is None else jax.tree_util.tree_map(
            lambda a, b: np.concatenate([a, b]), vs, vals[k]))
    jv = JValues()
    for t, (ks, vs) in varrays.items():
        jv.insert_batch(ks, t, _jlayout(t, vs))
    if name.startswith("Anti") or name.startswith(("Prior", "Between")) or \
            name in ("EssentialMatrixConstraint", "OrientedPlane3Factor",
                     "OrientedPlane3DirectionPrior"):
        t_meas = {"EssentialMatrixConstraint": "EssentialMatrix"}.get(name, jft.var_types[-1])
        jparams = _jlayout(t_meas, params)
    else:
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
    sign = -1.0 if name.startswith("Anti") else 1.0
    jg = JGraph().add_batch(jft, keys, jparams, L, sign=sign)
    return jg, jv, [(name, keys, params, L)], varrays, sign


_JAX_LIN = {}  # (factor name, eps) -> the jitted JAX linearization


def _jax_linearize(jft, xs, params, L, eps=JAX_EPS):
    """The JAX package's whitened Jacobians and rhs of one batch: its
    FactorType's residual (or linearize_residual) composed with its
    manifolds' retracts, jax.jacfwd at the tangent eps * 1, jitted and
    vmapped over the factors (the package's own linearize is eager and
    differentiates at 0; see the module docstring for eps)."""
    dims = [j_manifold.get(t).dim for t in jft.var_types]
    rets = [j_manifold.get(t).retract for t in jft.var_types]
    offs = np.cumsum([0] + dims)

    def one(xs1, p1, L1):
        def f(delta):
            xr = tuple(r(x, delta[offs[k]:offs[k + 1]]) for k, (r, x) in enumerate(zip(rets, xs1)))
            res = (jft.linearize_residual(xr, xs1, p1) if jft.linearize_residual is not None
                   else jft.residual(xr, p1))
            return L1 @ res

        return jax.jacfwd(f)(jnp.full(offs[-1], eps)), -f(jnp.zeros(offs[-1]))

    key = (jft.name, eps)
    if key not in _JAX_LIN:
        _JAX_LIN[key] = jax.jit(jax.vmap(one))
    J, b = _JAX_LIN[key](xs, params, jnp.asarray(L))
    return [np.asarray(J[..., offs[k]:offs[k + 1]]) for k in range(len(dims))], np.asarray(b)


def _jax_error(jg, jv):
    """The JAX package's graph error from its factors' residuals, jitted
    and vmapped per batch (its own `error` runs eagerly: seconds a call)."""
    total = 0.0
    for i, b in enumerate(jg.batches):
        key = (b.ftype.name, "residual")
        if key not in _JAX_LIN:
            _JAX_LIN[key] = jax.jit(jax.vmap(b.ftype.residual))
        r = np.einsum("nij,nj->ni", b.sqrt_info, np.asarray(_JAX_LIN[key](_jax_batch_xs(jg, jv, i),
                                                                          b.params)))
        total += b.sign * 0.5 * float(np.sum(r * r))
    return total


def _jax_batch_xs(jg, jv, i=0):
    b = jg.batches[i]
    return tuple(jax.tree_util.tree_map(lambda a, r=jnp.asarray(jv.rows(b.keys[:, k], t)): a[r],
                                        jv.params(t))
                 for k, t in enumerate(b.ftype.var_types))


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_factor_residual_and_linearization_match_jax(name):
    jg, jv, farrays, varrays, sign = _one_batch(name)
    tg = convert.graph_from_arrays(farrays, device="cpu")
    tg.batches[0].sign = sign
    tv = convert.values_from_arrays(varrays, device="cpu")
    tb, jb = tg.batches[0], jg.batches[0]
    assert tb.ftype.name == name and tb.ftype.var_types == jb.ftype.var_types
    xs_j = _jax_batch_xs(jg, jv)
    xs_t = tuple(tree for tree in tg._gather(tv, tb, tg._batch_rows(tb, tv)[1]))
    key = (name, "residual")
    if key not in _JAX_LIN:
        _JAX_LIN[key] = jax.jit(jax.vmap(jb.ftype.residual))
    _close(tb.ftype.residual(xs_t, tb.params), _JAX_LIN[key](xs_j, jb.params), GEO_TOL)
    np.testing.assert_allclose(float(tg.error(tv)), _jax_error(jg, jv), rtol=1e-12)
    tl = tg.linearize(tv).batches[0]
    if name not in HEAVY:  # Sim3's Jacobians: test_scene_lm_matches_jax["sim3"]
        JA, jbv = _jax_linearize(jb.ftype, xs_j, jb.params, jb.sqrt_info)
        for ta, ja in zip(tl.A, JA):
            np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=GEO_TOL)
        np.testing.assert_allclose(tl.b.numpy(), jbv, rtol=0, atol=GEO_TOL)
    assert tl.sign == sign


def test_singular_points_follow_jax():
    """A range at zero distance and a bearing at +-pi: the forward-mode
    derivatives are the JAX package's, NaN included."""
    for name, x, p, meas in (("RangePose2Point2", [1.0, 2.0, 0.3], [1.0, 2.0], 1.0),
                             ("BearingPose2Point2", [0.0, 0.0, 0.0], [-1.0, 0.0], np.pi),
                             ("BearingRangePose2Point2", [0.0, 0.0, 0.0], [0.0, 0.0], [0.0, 1.0])):
        farrays = [(name, np.array([[0, 1]]), np.asarray(meas, float)[None], np.eye(
            FACTORS[name][0]().resid_dim)[None])]
        varrays = {"Pose2": (np.array([0]), np.array([x])), "Point2": (np.array([1]), np.array([p]))}
        jft = FACTORS[name][0]()
        jg = JGraph().add_batch(jft, np.array([[0, 1]]), jnp.asarray(meas, dtype=jnp.float64)[None],
                                np.eye(jft.resid_dim)[None])
        jv = JValues()
        jv.insert(0, "Pose2", jnp.asarray(x))
        jv.insert(1, "Point2", jnp.asarray(p))
        tl = convert.graph_from_arrays(farrays, device="cpu").linearize(
            convert.values_from_arrays(varrays, device="cpu"))
        jl = jg.linearize(jv)
        for ta, ja in zip(tl.batches[0].A, jl.batches[0].A):
            np.testing.assert_array_equal(np.isnan(ta.numpy()), np.isnan(np.asarray(ja)))
            ok = ~np.isnan(ta.numpy())
            np.testing.assert_allclose(ta.numpy()[ok], np.asarray(ja)[ok], rtol=0, atol=GEO_TOL)
        np.testing.assert_allclose(tl.batches[0].b.numpy(), np.asarray(jl.batches[0].b), rtol=0,
                                   atol=GEO_TOL)


def test_sim3_graph_keeps_float32():
    va, fa = synthetic.sim3_sphere(3, 4, seed=0)
    lin = {}
    for dt in (np.float32, np.float64):
        g = convert.graph_from_arrays(fa, device="cpu", dtype=dt)
        lin[dt] = g.linearize(convert.values_from_arrays(va, device="cpu", dtype=dt))
    for l32, l64 in zip(lin[np.float32].batches, lin[np.float64].batches):
        assert l32.b.dtype == torch.float32 and all(a.dtype == torch.float32 for a in l32.A)
        for a32, a64 in zip(l32.A, l64.A):
            scale = a64.abs().max().item()
            assert (a32.double() - a64).abs().max().item() <= 1e-4 * scale


# --- the JAX tests' scenes (test_geometry_extended, test_slam_extra) -------------------------


def _graphs():
    return JGraph(), JValues(), TGraph(device="cpu"), TValues(device="cpu")


def _add(jg, tg, jft, tft, keys, jparams, tparams, info, **kw):
    jg.add(jft, keys, jparams, info, **kw)
    tg.add(tft, keys, tparams, info, **kw)


def _lm_both(jg, jv, tg, tv, jax_lm=False, **kw):
    """The port's LM, dense and multifrontal, alike to LM_TOL; with jax_lm
    the JAX package's LM (dense) too: error histories rel 1e-9, values
    LM_TOL. The mirrored tests hold the port to the JAX tests' truths; the
    JAX LM runs in the scene tests (its compiles take seconds a graph)."""
    trs = [t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver=s, **kw), device="cpu")
           for s in ("dense", "multifrontal")]
    refs = trs[:1]
    if jax_lm:
        jr = j_opt.levenberg_marquardt(jg, jv, j_opt.LMParams(**kw))
        np.testing.assert_allclose(trs[0].error_history, jr.error_history, rtol=1e-9, atol=1e-12)
        refs = [jr]
    for tr in trs:
        for ref in refs:
            np.testing.assert_allclose(tr.error, ref.error, rtol=1e-9, atol=1e-12)
            for t in tv.types():
                _close(tr.values.params(t), _jlayout(t, jax.tree_util.tree_map(
                    np.asarray, ref.values.params(t))), LM_TOL)
    return trs[0]


def test_bearing_range_localization():
    """A robot at an unknown Pose2 localizes a landmark from bearing + range
    (PlanarSLAMExample pattern): LM of both packages."""
    gt_pose, gt_lm = np.array([0.5, 0.2, 0.3]), np.array([2.0, 1.0])
    c, s = np.cos(0.3), np.sin(0.3)
    d = gt_lm - gt_pose[:2]
    bearing = np.arctan2(-s * d[0] + c * d[1], c * d[0] + s * d[1])
    jg, jv, tg, tv = _graphs()
    for v in (jv, tv):
        v.insert(0, "Pose2", np.zeros(3) if v is tv else jnp.zeros(3, dtype=jnp.float64))
        v.insert(1, "Point2", np.array([1.0, 0.0]) if v is tv else jnp.asarray([1.0, 0.0]))
    _add(jg, tg, j_factors.prior_factor("Pose2"), t_factors.prior_factor("Pose2"), [0],
         jnp.asarray(gt_pose), gt_pose, np.eye(3) / 1e-3)
    meas = np.array([bearing, np.linalg.norm(d)])
    _add(jg, tg, j_sam.bearing_range_factor_2d(), t_sam.bearing_range_factor_2d(), [0, 1],
         jnp.asarray(meas), meas, np.diag([1 / 0.01, 1 / 0.05]))
    tr = _lm_both(jg, jv, tg, tv, max_iterations=50)
    np.testing.assert_allclose(tr.values.at(1).numpy(), gt_lm, atol=1e-3)


def test_range_only_trilateration():
    gt_lm = np.array([1.0, 2.0])
    poses = [np.array([0.0, 0.0, 0.0]), np.array([3.0, 0.0, 0.0]), np.array([0.0, 4.0, 0.0])]
    jg, jv, tg, tv = _graphs()
    for i, p in enumerate(poses):
        jv.insert(i, "Pose2", jnp.asarray(p))
        tv.insert(i, "Pose2", p)
        _add(jg, tg, j_factors.prior_factor("Pose2"), t_factors.prior_factor("Pose2"), [i],
             jnp.asarray(p), p, np.eye(3) / 1e-4)
    jv.insert(10, "Point2", jnp.asarray([0.5, 0.5]))
    tv.insert(10, "Point2", np.array([0.5, 0.5]))
    for i, p in enumerate(poses):
        r = np.linalg.norm(gt_lm - p[:2])
        _add(jg, tg, j_sam.range_factor("Pose2", "Point2"), t_sam.range_factor("Pose2", "Point2"),
             [i, 10], jnp.asarray(r), np.asarray(r), np.eye(1) / 0.01)
    tr = _lm_both(jg, jv, tg, tv, max_iterations=60)
    np.testing.assert_allclose(tr.values.at(10).numpy(), gt_lm, atol=1e-3)


class TestFrobenius:
    def test_between_zero_at_truth(self):
        R1 = t_so3.expmap(torch.tensor([0.1, 0.2, 0.3], dtype=F64))
        R12 = t_so3.expmap(torch.tensor([-0.2, 0.1, 0.4], dtype=F64))
        r = t_extra_f.frobenius_between_factor().residual((R1, t_so3.compose(R1, R12)), R12)
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-12)

    def test_optimize_rotation_chain(self):
        rng = np.random.default_rng(1)
        true = [np.eye(3)]
        for _ in range(4):
            true.append(true[-1] @ _rot(rng, 1, 0.4)[0])
        jg, jv, tg, tv = _graphs()
        for i, R in enumerate(true):
            eps = _rot(rng, 1, 0.1)[0] if i else np.eye(3)
            jv.insert(i, "Rot3", jnp.asarray(R @ eps))
            tv.insert(i, "Rot3", R @ eps)
        _add(jg, tg, j_factors.prior_factor("Rot3"), t_factors.prior_factor("Rot3"), [0],
             jnp.asarray(true[0]), true[0], np.eye(3) / 0.001)
        for i in range(4):
            m = true[i].T @ true[i + 1]
            _add(jg, tg, j_extra_f.frobenius_between_factor(), t_extra_f.frobenius_between_factor(),
                 [i, i + 1], jnp.asarray(m), m, np.eye(9) / 0.1)
        tr = _lm_both(jg, jv, tg, tv)
        for i, R in enumerate(true):
            assert float(torch.linalg.norm(t_so3.local(tr.values.at(i), torch.tensor(R)))) < 1e-5


class TestKarcherMean:
    def test_gauge_constraint(self):
        Rs = tuple(t_so3.expmap(torch.tensor(w, dtype=F64))
                   for w in ([0.1, 0, 0], [-0.1, 0, 0], [0, 0, 0]))
        r = t_extra_f.karcher_mean_factor(3).residual(Rs, None)
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-12)


class TestPosePriors:
    def test_rotation_and_translation_priors(self):
        R_target = np.asarray(j_so3.expmap(jnp.asarray([0.2, -0.1, 0.3])))
        jg, jv, tg, tv = _graphs()
        jv.insert(0, "Pose3", j_pose3.Pose3(jnp.eye(3), jnp.asarray([1.0, 2.0, 3.0])))
        tv.insert(0, "Pose3", t_pose3.Pose3(torch.eye(3, dtype=F64), torch.tensor([1.0, 2.0, 3.0])))
        _add(jg, tg, j_extra_f.pose_rotation_prior(), t_extra_f.pose_rotation_prior(), [0],
             jnp.asarray(R_target), R_target, np.eye(3) / 0.1)
        t_target = np.array([5.0, 0.0, 0.0])
        _add(jg, tg, j_extra_f.pose_translation_prior(), t_extra_f.pose_translation_prior(), [0],
             jnp.asarray(t_target), t_target, np.eye(3) / 0.1)
        tr = _lm_both(jg, jv, tg, tv)
        p = tr.values.at(0)
        np.testing.assert_allclose(p.R.numpy(), R_target, atol=1e-6)
        np.testing.assert_allclose(p.t.numpy(), t_target, atol=1e-6)


class TestRotate:
    def test_rotate_factor_recovery(self):
        R_true = t_so3.expmap(torch.tensor([0.3, 0.2, -0.4], dtype=F64))
        rng = np.random.default_rng(7)
        jg, jv, tg, tv = _graphs()
        jv.insert(0, "Rot3", jnp.eye(3))
        tv.insert(0, "Rot3", np.eye(3))
        for _ in range(5):
            z = rng.normal(size=3)
            p = t_so3.rotate(R_true, torch.tensor(z)).numpy()
            _add(jg, tg, j_extra_f.rotate_factor(), t_extra_f.rotate_factor(), [0],
                 {"p": jnp.asarray(p), "z": jnp.asarray(z)}, {"p": p, "z": z}, np.eye(3) / 0.01)
        tr = _lm_both(jg, jv, tg, tv)
        assert float(torch.linalg.norm(t_so3.local(tr.values.at(0), R_true))) < 1e-6

    def test_rotate_directions(self):
        R_true = t_so3.expmap(torch.tensor([0.1, 0.5, -0.2], dtype=F64))
        z = torch.tensor([0.0, 0.0, 1.0], dtype=F64)
        r = t_extra_f.rotate_directions_factor().residual(
            (R_true,), {"p": t_so3.rotate(R_true, z), "z": z})
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-10)


class TestEssential:
    def test_epipolar_zero(self):
        R = t_so3.expmap(torch.tensor([0.05, -0.03, 0.1], dtype=F64))
        t = torch.tensor([1.0, 0.2, -0.1], dtype=F64)
        P2 = torch.tensor([0.3, -0.2, 2.0], dtype=F64)
        P1 = t_so3.rotate(R, P2) + t
        r = t_extra_f.essential_matrix_factor().residual(
            (t_ess.essential_from_pose(R, t),), {"pA": (P1 / P1[2])[:2], "pB": (P2 / P2[2])[:2]})
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-10)

    def test_constraint_zero_at_truth(self):
        p1 = t_pose3.expmap(torch.tensor([0.1, 0, 0, 0, 0, 0], dtype=F64))
        p2 = t_pose3.expmap(torch.tensor([0.1, 0.2, 0, 1.0, 0.5, -0.2], dtype=F64))
        rel = t_pose3.between(p1, p2)
        r = t_extra_f.essential_matrix_constraint().residual(
            (p1, p2), t_ess.essential_from_pose(rel.R, rel.t))
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-10)


class TestOrientedPlane:
    def test_factor_zero_at_truth(self):
        plane = t_ess.plane_from_coeffs(*(torch.tensor(x, dtype=F64) for x in (0.0, 0.0, 1.0, -2.0)))
        pose = t_pose3.expmap(torch.tensor([0.0, 0.0, 0.3, 1.0, -0.5, 0.1], dtype=F64))
        measured = t_ess.plane_transform(plane, pose.R, pose.t)
        r = t_extra_f.oriented_plane3_factor().residual((pose, plane), measured)
        np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-10)


class TestReferenceFrame:
    def test_recovery_of_transform(self):
        xi = np.array([0.2, -0.1, 0.3, 1.0, 2.0, -0.5])
        T_true = t_pose3.expmap(torch.tensor(xi))
        rng = np.random.default_rng(3)
        jg, jv, tg, tv = _graphs()
        jv.insert(100, "Pose3", j_pose3.identity(jnp.float64))
        tv.insert(100, "Pose3", t_pose3.identity(F64, "cpu"))
        for i in range(4):
            local = rng.normal(size=3) * 2.0
            glob = t_pose3.transform_from(T_true, torch.tensor(local)).numpy()
            for key, p in ((i, glob), (10 + i, local)):
                jv.insert(key, "Point3", jnp.asarray(p))
                tv.insert(key, "Point3", p)
                _add(jg, tg, j_factors.prior_factor("Point3"), t_factors.prior_factor("Point3"),
                     [key], jnp.asarray(p), p, np.eye(3) / 0.01)
            _add(jg, tg, j_extra_f.reference_frame_factor(), t_extra_f.reference_frame_factor(),
                 [i, 100, 10 + i], None, None, np.eye(3) / 0.05)
        tr = _lm_both(jg, jv, tg, tv)
        assert float(torch.linalg.norm(t_pose3.local(tr.values.at(100), T_true))) < 1e-4


class TestAntiFactor:
    def _graphs(self):
        v = TValues(device="cpu")
        v.insert(0, "Pose2", np.array([0.0, 0.0, 0.0]))
        v.insert(1, "Pose2", np.array([1.1, 0.1, 0.05]))
        meas = np.array([1.0, 0.0, 0.0])
        bf = t_factors.between_factor("Pose2")
        g1, g2 = TGraph(device="cpu"), TGraph(device="cpu")
        for g in (g1, g2):
            g.add(t_factors.prior_factor("Pose2"), [0], t_pose2.identity(F64, "cpu"), np.eye(3) / 0.1)
            g.add(t_factors.prior_factor("Pose2"), [1], meas, np.eye(3) / 0.5)
        g2.add(bf, [0, 1], meas, np.eye(3) / 0.2)
        g2.add(t_extra_f.anti_factor(bf), [0, 1], meas, np.eye(3) / 0.2, sign=-1.0)
        return g1, g2, v

    def test_information_cancellation_dense(self):
        """prior + between + anti-between == prior alone (dense H, g equal),
        as in the JAX package."""
        g1, g2, v = self._graphs()
        H1, gg1 = t_linsolve.assemble_dense(g1.linearize(v))
        H2, gg2 = t_linsolve.assemble_dense(g2.linearize(v))
        np.testing.assert_allclose(H1.numpy(), H2.numpy(), atol=1e-10)
        np.testing.assert_allclose(gg1.numpy(), gg2.numpy(), atol=1e-10)
        jg, jv, farrays, varrays, _ = _one_batch("AntiBetweenPose2")
        jb = jg.batches[0]
        JA, jbv = _jax_linearize(jb.ftype, _jax_batch_xs(jg, jv), jb.params, jb.sqrt_info)
        rows = tuple(jv.rows(jb.keys[:, k], t) for k, t in enumerate(jb.ftype.var_types))
        jl = j_fg.LinearizedGraph(  # the package's assembly of the sign, on its blocks
            [j_fg.LinearBatch(jb.ftype.var_types, rows, tuple(jnp.asarray(a) for a in JA),
                              jnp.asarray(jbv), sign=-1.0)],
            {t: jv._count(t) for t in jv.types()})
        jH, jgv = j_linsolve.assemble_dense(jl)
        tg = convert.graph_from_arrays(farrays, device="cpu")
        tg.batches[0].sign = -1.0
        tH, tgv = t_linsolve.assemble_dense(tg.linearize(convert.values_from_arrays(varrays,
                                                                                    device="cpu")))
        np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=0, atol=GEO_TOL)
        np.testing.assert_allclose(tgv.numpy(), np.asarray(jgv), rtol=0, atol=GEO_TOL)

    def test_information_cancellation_multifrontal(self):
        """The sign rides into the multifrontal pool: the same damped step."""
        g1, g2, v = self._graphs()
        d1, _ = t_elim.solve_linearized(g1, v, 1e-3)
        d2, _ = t_elim.solve_linearized(g2, v, 1e-3)
        np.testing.assert_allclose(d2["Pose2"].numpy(), d1["Pose2"].numpy(), rtol=0, atol=1e-12)


class TestPlanarProjection:
    def test_zero_at_truth(self):
        ft = t_extra_f.planar_projection_factor()
        rng = np.random.default_rng(0)
        params = {k: torch.tensor(v[0]) for k, v in _planar_params(rng, 1).items()}
        wTb = torch.tensor([1.0, 2.0, 0.3], dtype=F64)
        r0 = ft.residual((wTb,), params)
        jr0 = j_extra_f.planar_projection_factor().residual(
            (jnp.asarray(wTb.numpy()),), {k: jnp.asarray(v.numpy()) for k, v in params.items()})
        np.testing.assert_allclose(r0.numpy(), np.asarray(jr0), rtol=0, atol=GEO_TOL)
        params["measured"] = params["measured"] + r0
        np.testing.assert_allclose(ft.residual((wTb,), params).numpy(), 0.0, atol=1e-10)


# --- LM on small graphs of phase 15's scene types, carried across ------------------------------


def _jax_graph(farrays):
    g = JGraph()
    for name, keys, params, info in farrays:
        jft = (FACTORS[name][0]() if name in FACTORS else
               getattr(j_factors, name[:5].lower() + "_factor")(name[5:])
               if name.startswith("Prior") else
               j_factors.between_factor(name[7:]) if name.startswith("Between") else
               j_sam.range_factor("Pose2", "Point2") if name == "RangePose2Point2" else None)
        if name.startswith(("Prior", "Between")):
            jp = _jlayout(name[5:] if name.startswith("Prior") else name[7:], params)
        elif name.startswith("OrientedPlane3"):
            jp = _jlayout("OrientedPlane3", params)
        else:
            jp = jax.tree_util.tree_map(jnp.asarray, params)
        g.add_batch(jft, keys, jp, info)
    return g


def _jax_values(varrays):
    v = JValues()
    for t, (keys, params) in varrays.items():
        v.insert_batch(keys, t, _jlayout(t, params))
    return v


@pytest.mark.parametrize("scene", ["sim3", "plane", "essential", "range_bearing"])
def test_scene_lm_matches_jax(scene):
    """LM on small graphs of phase 15's scenes, carried across by convert:
    Sim3 and range-bearing against the JAX package's LM; plane and essential
    (Unit3-based values, whose JAX Jacobians are NaN at the zero tangent, so
    the JAX LM cannot step) at a stationary point of the JAX package's cost:
    its error at the port's solution = the port's, its gradient there (the
    JAX Jacobians at JAX_EPS) <= 1e-6 of the start's."""
    if scene == "sim3":
        va, fa = synthetic.sim3_sphere(2, 3, seed=0)
    elif scene == "plane":
        va, fa, _ = synthetic.plane_slam(12, 6, seed=0)
    elif scene == "essential":
        va, fa, _ = synthetic.two_view_pairs(2, 8, seed=0)
    else:
        va, fa, _ = synthetic.planar_slam(12, 6, seed=0)
    tg = convert.graph_from_arrays(fa, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    jg, jv = _jax_graph(fa), _jax_values(va)
    np.testing.assert_allclose(float(tg.error(tv)), _jax_error(jg, jv), rtol=1e-12)
    if scene in ("sim3", "range_bearing"):
        _lm_both(jg, jv, tg, tv, jax_lm=True, max_iterations=8)
        return
    tr = _lm_both(jg, jv, tg, tv, max_iterations=20)
    jopt = _jax_values({t: (np.asarray(tv.type_keys(t)), _np(tr.values.params(t)))
                        for t in tv.types()})
    np.testing.assert_allclose(_jax_error(jg, jopt), tr.error, rtol=1e-12)

    def grad_norm(v):
        """|J^T b| at v (the port's Jacobians = the JAX package's at JAX_EPS,
        factor by factor: test_factor_residual_and_linearization_match_jax)."""
        return float(torch.linalg.norm(t_linsolve.assemble_dense(tg.linearize(v))[1]))

    assert grad_norm(tr.values) <= 1e-6 * grad_norm(tv)


def test_new_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    for make in (t_sim3.identity, t_ess.essential_identity, t_ess.plane_identity,
                 t_ess.line_identity, t_extra.sim2_identity, lambda: t_extra.sim2(0.1, [0, 0], 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
