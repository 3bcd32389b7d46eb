"""The port's unstable factors (rolling-shutter projection, BetweenFactorEM,
InvDepthFactor3) against the JAX package's.

Inputs come from np.random.default_rng(seed) (and the scenes of
utils/synthetic.py, made from one seed) and go through both packages; the
port runs on the CPU in float64. Tolerances: whitened residuals and
forward-mode Jacobians atol 1e-10 x max(1, the block's largest entry: an
inverse depth's column reaches ~1e5 pixels) on random batches of 64 (for
BetweenFactorEM this pins `.detach()` against JAX's stop_gradient), LM
(dense) histories over a small graph of each type rel 1e-9. The tests of
tests/test_slam_extra.py:242-319 are mirrored here on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import cameras as t_cams
from gtsam_petercdev_torch.geometry.pose3 import Pose3 as TPose3
from gtsam_petercdev_torch.nonlinear import factor_graph as t_fg
from gtsam_petercdev_torch.nonlinear.optimizers import LMParams as TLMParams
from gtsam_petercdev_torch.nonlinear.optimizers import levenberg_marquardt as t_lm
from gtsam_petercdev_torch.slam import unstable_factors as t_uf
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.nonlinear import factor_graph as j_fg
from gtsam_petercdev_tpu.nonlinear.optimizers import LMParams as JLMParams
from gtsam_petercdev_tpu.nonlinear.optimizers import levenberg_marquardt as j_lm
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors
from gtsam_petercdev_tpu.slam import unstable_factors as j_uf
from test_torch_navigation import rand_rot, to_t

F64 = torch.float64
K5 = [500.0, 500.0, 0.0, 320.0, 240.0]


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


# --- the JAX tests, on the port ---------------------------------------------------


def test_rolling_shutter_projection():
    K = t64(K5)
    pa = TPose3(torch.eye(3, dtype=F64), t64([0.0, 0.0, 0.0]))
    pb = TPose3(torch.eye(3, dtype=F64), t64([1.0, 0.0, 0.0]))
    pt = t64([0.3, -0.2, 4.0])
    ft = t_uf.projection_factor_rolling_shutter()
    # alpha endpoints reduce to plain projection at A and B
    for alpha, pose in [(0.0, pa), (1.0, pb), (0.5, None)]:
        r = ft.residual((pa, pb, pt), {"uv": torch.zeros(2, dtype=F64), "K": K,
                                       "alpha": t64(alpha)})
        if pose is not None:
            uv_ref, _ = t_cams.project_s2(pose, pt, K)
            np.testing.assert_allclose(r.numpy(), uv_ref.numpy(), atol=1e-9)
    # the interpolated pose lies between the endpoints
    mid = t_uf.interpolate_pose3(pa, pb, 0.5)
    np.testing.assert_allclose(mid.t.numpy(), [0.5, 0.0, 0.0], atol=1e-12)
    # forward-mode oracle: the residual is differentiable and moves with B
    J = torch.func.jacfwd(lambda p: ft.residual(
        (pa, TPose3(pb.R, p), pt), {"uv": torch.zeros(2, dtype=F64), "K": K,
                                    "alpha": t64(0.7)}))(pb.t)
    assert J.abs().max() > 1e-3


def test_between_factor_em_inlier_outlier():
    ft = t_uf.between_factor_em("Pose2")
    x1 = torch.zeros(3, dtype=F64)
    x2 = t64([1.0, 0.0, 0.0])
    params = {"measured": t64([1.0, 0.0, 0.0]), "R_in": torch.eye(3, dtype=F64) / 0.1,
              "R_out": torch.eye(3, dtype=F64) / 10.0, "prior_in": t64(0.5),
              "prior_out": t64(0.5)}
    # a consistent measurement: the inlier branch dominates
    r = ft.residual((x1, x2), params).numpy()
    assert np.linalg.norm(r[:3]) < 1e-6 and np.linalg.norm(r[3:]) < 1e-6
    # a wildly inconsistent one: the outlier responsibility ~1, the residual
    # dominated by the WIDE model (bounded influence)
    r2 = ft.residual((x1, x2), dict(params, measured=t64([30.0, 0.0, 0.0]))).numpy()
    assert np.linalg.norm(r2[:3]) < 1e-10
    assert np.linalg.norm(r2[3:]) < 5.0


def test_inv_depth_factor3_roundtrip():
    K = t64(K5)
    pose = TPose3(torch.eye(3, dtype=F64), t64([0.2, -0.1, 0.0]))
    uv = t64([350.0, 230.0])
    ray5, rho = t_uf.inv_depth_backproject(pose, K, uv, 5.0)
    pt = t_uf.inv_depth_to_point(ray5, rho)
    uv_back, _ = t_cams.project_s2(pose, pt, K)
    np.testing.assert_allclose(uv_back.numpy(), uv.numpy(), atol=1e-8)
    ft = t_uf.inv_depth_factor3()
    r = ft.residual((pose, ray5, rho[None]), {"uv": uv, "K": K})
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-8)
    # the inverse depth is unobservable from the anchor view (no parallax)...
    J0 = torch.func.jacfwd(lambda q: ft.residual((pose, ray5, q), {"uv": uv, "K": K}))(rho[None])
    np.testing.assert_allclose(J0.numpy(), 0.0, atol=1e-9)
    # ...and observable from a translated view
    pose2_ = TPose3(pose.R, pose.t + t64([0.5, 0.0, 0.0]))
    J = torch.func.jacfwd(lambda q: ft.residual((pose2_, ray5, q), {"uv": uv, "K": K}))(rho[None])
    assert J.abs().max() > 1e-3


# --- residuals and Jacobians against JAX, batches of 64 -----------------------------

N = 64


def _poses(rng, n, t_scale=1.0):
    return rand_rot(rng, n, 0.3), rng.normal(size=(n, 3)) * t_scale


def _rs_case(rng):
    Ra, ta = _poses(rng, N)
    Rb = Ra @ rand_rot(rng, N, 0.05)
    tb = ta + rng.normal(size=(N, 3)) * 0.2
    pts = ta + np.einsum("nij,nj->ni", Ra, np.stack(
        [rng.uniform(-2, 2, N), rng.uniform(-2, 2, N), rng.uniform(4, 8, N)], axis=1))
    pts[:3] = ta[:3] - 5.0 * Ra[:3, :, 2]  # behind the camera: masked to zero
    params = {"uv": rng.normal(size=(N, 2)) * 20 + [320, 240],
              "K": np.broadcast_to(K5, (N, 5)).copy(), "alpha": rng.uniform(0, 1, N)}
    return ("Pose3", "Pose3", "Point3"), ((Ra, ta), (Rb, tb), pts), params, 2


def _em_case(rng):
    R1, t1 = _poses(rng, N)
    R2 = R1 @ rand_rot(rng, N, 0.2)
    t2 = t1 + rng.normal(size=(N, 3))
    mR, mt = rand_rot(rng, N, 0.2), rng.normal(size=(N, 3))
    sig = np.array([0.05] * 3 + [0.2] * 3)
    R_in = np.broadcast_to(np.diag(1 / sig), (N, 6, 6)) * rng.uniform(0.5, 2.0, (N, 1, 1))
    params = {"measured": (mR, mt), "R_in": R_in, "R_out": R_in / 50.0,
              "prior_in": rng.uniform(0.5, 0.95, N), "prior_out": rng.uniform(0.05, 0.5, N)}
    return ("Pose3", "Pose3"), ((R1, t1), (R2, t2)), params, 12


def _inv_depth_case(rng):
    R, t = _poses(rng, N, 0.3)
    base = t + rng.normal(size=(N, 3)) * 0.3
    ray = R[:, :, 2] + rng.normal(size=(N, 3)) * 0.2  # roughly along the optical axis
    ray5 = np.concatenate([base, np.arctan2(ray[:, 1], ray[:, 0])[:, None],
                           np.arctan2(ray[:, 2], np.linalg.norm(ray[:, :2], axis=1))[:, None]],
                          axis=1)
    rho = rng.uniform(0.1, 0.4, (N, 1))
    params = {"uv": rng.normal(size=(N, 2)) * 20 + [320, 240],
              "K": np.broadcast_to(K5, (N, 5)).copy()}
    return ("Pose3", "InvDepthRay5", "Vector1"), ((R, t), ray5, rho), params, 2


CASES = {
    "ProjectionFactorRollingShutter": (_rs_case, j_uf.projection_factor_rolling_shutter,
                                       t_uf.projection_factor_rolling_shutter),
    "BetweenFactorEMPose3": (_em_case, lambda: j_uf.between_factor_em("Pose3"),
                             lambda: t_uf.between_factor_em("Pose3")),
    "InvDepthFactor3": (_inv_depth_case, j_uf.inv_depth_factor3, t_uf.inv_depth_factor3),
}


def _jlay(t, x):
    return j_pose3.Pose3(*map(jnp.asarray, x)) if t == "Pose3" else jnp.asarray(x)


def _tlay(t, x):
    return TPose3(*to_t(x)) if t == "Pose3" else t64(x)


@pytest.mark.parametrize("name", list(CASES))
def test_residual_and_jacobians_match_jax(name):
    make_case, jmake, tmake = CASES[name]
    types, xs, params, d = make_case(np.random.default_rng(3))
    jft, tft = jmake(), tmake()
    assert (tft.name, tft.var_types, tft.resid_dim) == (jft.name, jft.var_types, jft.resid_dim)
    info = np.broadcast_to(np.eye(d), (N, d, d)).copy()
    jp = dict(params)
    tp = {k: (TPose3(*to_t(v)) if k == "measured" else t64(v)) for k, v in params.items()}
    if "measured" in jp:
        jp["measured"] = j_pose3.Pose3(*map(jnp.asarray, jp["measured"]))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jr, jJ = jax.jit(lambda x, p, s: j_fg.residual_and_jac(jft, None, x, p, s))(
        tuple(_jlay(t, x) for t, x in zip(types, xs)), jp, jnp.asarray(info))
    tr, tJ = t_fg.residual_and_jac(tft, None, tuple(_tlay(t, x) for t, x in zip(types, xs)),
                                   tp, t64(info))
    assert len(tJ) == len(jJ)
    for a, b in [(tr, jr)] + list(zip(tJ, jJ)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10 * max(1.0, np.abs(b).max()), rtol=0)
    if name == "ProjectionFactorRollingShutter":
        assert (tr[:3] == 0).all() and all((J[:3] == 0).all() for J in tJ)
    elif name == "InvDepthFactor3":
        assert (tr != 0).any(dim=1).sum() >= N - 4  # nearly all in front of the camera


# --- LM (dense) over a small graph of each type against JAX --------------------------

_J_FT = {"ProjectionFactorRollingShutter": j_uf.projection_factor_rolling_shutter,
         "InvDepthFactor3": j_uf.inv_depth_factor3,
         "BetweenFactorEMPose3": lambda: j_uf.between_factor_em("Pose3")}


def _jax_graph(va, fa):
    values = JValues()
    for t, (keys, p) in va.items():
        values.insert_batch(np.asarray(keys), t, _jlay(t, p))
    graph = j_fg.NonlinearFactorGraph()
    for name, keys, p, info in fa:
        if name in _J_FT:
            ft = _J_FT[name]()
            p = dict(p)
            if "measured" in p:
                p["measured"] = _jlay("Pose3", p["measured"])
            p = jax.tree_util.tree_map(jnp.asarray, p)
        elif name.startswith("Prior"):
            ft = j_factors.prior_factor(name[5:])
            p = _jlay(ft.var_types[0], p)
        else:
            ft = j_factors.between_factor(name[7:])
            p = _jlay(ft.var_types[0], p)
        graph.add_batch(ft, np.asarray(keys), p, np.asarray(info))
    return graph, values


def _scene(kind):
    if kind == "rolling_shutter":
        va, fa, _ = synthetic.rolling_shutter_scene(6, 12, 4, seed=1)
    elif kind == "inv_depth":
        va, fa, _ = synthetic.inv_depth_scene(6, 10, 4, seed=1)
    else:
        va, _, fa, _, _ = synthetic.sphere_rings_outliers(3, 4, seed=1, share=0.5)
    return va, fa


@pytest.mark.parametrize("kind", ["rolling_shutter", "em", "inv_depth"])
def test_lm_dense_history_matches_jax(kind):
    va, fa = _scene(kind)
    jg, jv = _jax_graph(va, fa)
    jres = j_lm(jg, jv, JLMParams(solver="dense", max_iterations=6))
    tres = t_lm(convert.graph_from_arrays(fa, device="cpu"),
                convert.values_from_arrays(va, device="cpu"),
                TLMParams(solver="dense", max_iterations=6), device="cpu")
    assert len(tres.error_history) == len(jres.error_history)
    np.testing.assert_allclose(tres.error_history, jres.error_history, rtol=1e-9)
    assert tres.error < tres.error_history[0]
