"""The port's smart-factor bundle adjustment (geometry/triangulation.py,
slam/smart.py, sfm/tracks.py, utils/dsf.py) against the JAX package.

The same numpy inputs (made from a seed) feed both packages; the port runs
on the CPU in float64. Tolerances: triangulation atol 1e-9; the reduced
camera system (H, g), the implicit operator and the Q / SVD modes rel 1e-9
(the same sums in another order; the port's Jacobians are analytic where
JAX's are forward-mode); PCG and LM histories rel 1e-8 (iterations amplify
those roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import triangulation as t_tri
from gtsam_petercdev_torch.geometry.pose3 import Pose3 as TPose3
from gtsam_petercdev_torch.models import ba_synth
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.sfm import tracks as t_tracks
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.slam import smart as t_smart
from gtsam_petercdev_torch.utils import convert, dsf as t_dsf
from gtsam_petercdev_tpu.geometry import triangulation as j_tri
from gtsam_petercdev_tpu.geometry.pose3 import Pose3 as JPose3
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.sfm import tracks as j_tracks
from gtsam_petercdev_tpu.slam import factors as j_factors
from gtsam_petercdev_tpu.slam import smart as j_smart
from gtsam_petercdev_tpu.utils import dsf as j_dsf

CUBE_K = np.array([50.0, 50.0, 0.0, 50.0, 50.0])
CUBE_K2 = np.array([60.0, 60.0, 0.0, 48.0, 52.0])
STEREO_K = np.array([50.0, 50.0, 0.0, 50.0, 50.0, 0.5])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _cube_poses():
    """8 cameras on a circle of radius 30 looking at the origin (the JAX
    tests' cube scene, examples/SFMdata.h), and the 8 cube corners."""
    points = np.array([[10, 10, 10], [-10, 10, 10], [-10, -10, 10], [10, -10, 10],
                       [10, 10, -10], [-10, 10, -10], [-10, -10, -10], [10, -10, -10]], float)
    Rs, ts = [], []
    for i in range(8):
        ang = 2 * np.pi * i / 8
        c = np.array([30.0 * np.cos(ang), 0.0, 30.0 * np.sin(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=1))
        ts.append(c)
    return np.stack(Rs), np.stack(ts), points


def _cube_batch(kind, noise=0.5, seed=0):
    """(JAX batch, port batch, R0, t0): the cube scene's tracks in mono,
    rig (two calibrations) or stereo form, the cameras perturbed."""
    rng = np.random.default_rng(seed)
    R, t, points = _cube_poses()
    cal = {"mono": CUBE_K[None], "rig": np.stack([CUBE_K, CUBE_K2]), "stereo": STEREO_K[None]}[kind]
    tracks, cal_of_cam = [], ({i: i % 2 for i in range(8)} if kind == "rig" else None)
    for p in points:
        obs = []
        for i in range(8):
            q = R[i].T @ (p - t[i])
            if q[2] <= 0:
                continue
            K = cal[cal_of_cam[i]] if cal_of_cam else cal[0]
            u, v = K[0] * q[0] / q[2] + K[3], K[1] * q[1] / q[2] + K[4]
            z = [u, u - K[0] * K[5] / q[2], v] if kind == "stereo" else [u, v]
            obs.append((i, np.asarray(z) + rng.normal(size=len(z)) * noise))
        tracks.append(obs)
    jb = j_smart.from_tracks(tracks, jnp.asarray(cal), cal_of_cam=cal_of_cam,
                             stereo=kind == "stereo")
    tb = t_smart.from_tracks(tracks, cal, cal_of_cam=cal_of_cam, stereo=kind == "stereo",
                             device="cpu")
    xi = rng.normal(size=(8, 6)) * 0.02
    from gtsam_petercdev_torch.geometry import pose3 as t_pose3

    p0 = t_pose3.retract(TPose3(torch.tensor(R), torch.tensor(t)), torch.tensor(xi))
    return jb, tb, p0.R.numpy(), p0.t.numpy()


def _gathered(jb, tb, R, t):
    rows = np.asarray(jb.cam_rows)
    jp = JPose3(jnp.asarray(R[rows]), jnp.asarray(t[rows]))
    tp = t_smart.gather_poses(tb, TPose3(torch.tensor(R), torch.tensor(t)))
    return jp, tp


def _jx(fn, jb, jp, *args):
    """A JAX smart-factor function of (batch, gathered poses, *args), jitted
    over the poses (eager, its vmapped forward-mode Jacobians take seconds)."""
    return jax.jit(lambda p: fn(jb, p, *args))(jp)


def _rig_batches():
    s = ba_synth.smart_rig(20, 500, seed=0)
    cal = np.array([ba_synth.SMART_CAL])
    jb = j_smart.SmartProjectionFactorBatch(s["cam_rows"], s["mask"],
                                            jnp.asarray(s["measured"]), jnp.asarray(cal))
    tb = convert.smart_batch_from_arrays(np.array(jb.cam_rows), np.array(jb.mask),
                                         np.array(jb.measured), np.array(jb.cal),
                                         np.array(jb.cal_rows), device="cpu")
    return jb, tb, s


# --- triangulation -------------------------------------------------------------


def _tri_inputs(seed=3, T=12, M=5):
    """T tracks of M views of random cameras around random points: some
    views masked, track 0 a single view, track 1 behind its cameras,
    track 2 a gross outlier, track 3 far from its cameras."""
    rng = np.random.default_rng(seed)
    R, t, meas, mask = [], [], [], np.ones((T, M), bool)
    for j in range(T):
        p = rng.uniform(-3, 3, size=3) + (np.array([0, 0, 400.0]) if j == 3 else 0)
        Rj, tj, mj = [], [], []
        for m in range(M):
            c = rng.normal(size=3) * 2 + np.array([0, 0, -12.0])
            z = (p - c) / np.linalg.norm(p - c) * (-1 if j == 1 else 1)
            x = np.cross([0, 1.0, 0], z)
            x /= np.linalg.norm(x)
            Rm = np.stack([x, np.cross(z, x), z], axis=1)
            q = Rm.T @ (p - c)
            mj.append(q[:2] / q[2] + rng.normal(size=2) * 1e-3 + (0.05 if j == 2 and m == 0 else 0))
            Rj.append(Rm)
            tj.append(c)
        R.append(Rj), t.append(tj), meas.append(mj)
    mask[0, 1:] = False
    mask[5, 3:] = False
    return np.array(R), np.array(t), np.array(meas), mask


def test_triangulation_matches_jax():
    """DLT, LOST and the nonlinear refinement over a batch of tracks, and
    triangulate_safe's status codes with and without the distance and
    outlier thresholds, equal JAX's vmapped single-track functions (atol
    1e-9 on points of well-posed tracks)."""
    R, t, meas, mask = _tri_inputs()
    jp, tp = JPose3(jnp.asarray(R), jnp.asarray(t)), TPose3(torch.tensor(R), torch.tensor(t))
    jm, tm = jnp.asarray(meas), torch.tensor(meas)
    jk, tk = jnp.asarray(mask), torch.tensor(mask)
    ok = np.arange(len(R)) != 0  # the single view's DLT null space is not unique
    pj, svj = jax.jit(jax.vmap(j_tri.triangulate_dlt))(jp, jm, jk)
    pt, svt = t_tri.triangulate_dlt(tp, tm, tk)
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], atol=1e-9)
    np.testing.assert_allclose(svt.numpy(), np.asarray(svj), atol=1e-9)
    lj = jax.jit(jax.vmap(j_tri.triangulate_lost))(jp, jm, jk)
    np.testing.assert_allclose(t_tri.triangulate_lost(tp, tm, tk).numpy()[ok],
                               np.asarray(lj)[ok], atol=1e-9)
    nj = jax.jit(jax.vmap(j_tri.triangulate_nonlinear))(jp, jm, pj, jk)
    nt = t_tri.triangulate_nonlinear(tp, tm, torch.tensor(np.asarray(pj)), tk)
    np.testing.assert_allclose(nt.numpy()[ok], np.asarray(nj)[ok], atol=1e-9)
    for params in (j_tri.TriangulationParameters(),
                   j_tri.TriangulationParameters(landmark_distance_threshold=100.0,
                                                 dynamic_outlier_rejection_threshold=0.01)):
        rj = jax.jit(lambda *a: j_tri.triangulate_batch(*a, params))(jp, jm, jk)
        rt = t_tri.triangulate_batch(tp, tm, tk, t_tri.TriangulationParameters(*params))
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
        np.testing.assert_allclose(rt.point.numpy()[ok], np.asarray(rj.point)[ok], atol=1e-9)
    codes = rt.status.numpy()
    assert codes[0] == t_tri.DEGENERATE and codes[1] == t_tri.BEHIND_CAMERA
    assert codes[2] == t_tri.OUTLIER and codes[3] == t_tri.FAR_POINT
    assert (codes[4:] == t_tri.VALID).all()


# --- the reduced camera system -------------------------------------------------


@pytest.mark.parametrize("kind", ["mono", "rig", "stereo"])
def test_camera_system_matches_jax(kind):
    """HESSIAN mode: the dense reduced camera system (H, g) and the total
    error of the mono, rig and stereo cube scenes equal JAX's (rel 1e-9)."""
    jb, tb, R, t = _cube_batch(kind)
    jp, tp = _gathered(jb, tb, R, t)
    Hj, gj, ej = _jx(j_smart.assemble_camera_system, jb, jp, 8)
    Ht, gt, et = t_smart.assemble_camera_system(tb, tp, 8)
    assert _rel(Ht, Hj) < 1e-9 and _rel(gt, gj) < 1e-9
    assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej))
    assert abs(float(t_smart.total_error(tb, tp)) - float(ej)) <= 1e-9 * abs(float(ej))


def test_ragged_rig_terms_match_jax():
    """The ragged rig (2-6 views, a behind-camera and a single-view track):
    equal validity (498 of 500 + 2), F / E / b of the valid tracks and the
    camera system (rel 1e-9)."""
    jb, tb, s = _rig_batches()
    jp, tp = _gathered(jb, tb, s["R0"], s["t0"])
    Fj, Ej, bj, vj = _jx(j_smart._track_terms, jb, jp)
    Ft, Et, bt, vt = t_smart._track_terms(tb, tp)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.sum() == 500 and not vj[-2:].any()
    for a, b in ((Ft, Fj), (Et, Ej), (bt, bj)):
        assert _rel(a.numpy()[vj], np.asarray(b)[vj]) < 1e-9
    Hj, gj, _ = _jx(j_smart.assemble_camera_system, jb, jp, 20)
    Ht, gt, _ = t_smart.assemble_camera_system(tb, tp, 20)
    assert _rel(Ht, Hj) < 1e-9 and _rel(gt, gj) < 1e-9


def test_implicit_schur_matches_jax():
    """IMPLICIT_SCHUR: the matrix-free product, gradient and block diagonal
    equal JAX's (rel 1e-9) and the dense H's."""
    jb, tb, R, t = _cube_batch("mono")
    jp, tp = _gathered(jb, tb, R, t)
    H, g, _ = t_smart.assemble_camera_system(tb, tp, 8)
    jt, tt = _jx(j_smart.implicit_schur_terms, jb, jp), t_smart.implicit_schur_terms(tb, tp)
    v = np.random.default_rng(1).standard_normal((8, 6))
    yj = j_smart.implicit_schur_hvp(jt, jb.cam_rows, jnp.asarray(v), 8)
    yt = t_smart.implicit_schur_hvp(tt, tb.cam_rows, torch.tensor(v), 8)
    assert _rel(yt, yj) < 1e-9 and _rel(yt.reshape(-1), H @ torch.tensor(v).reshape(-1)) < 1e-9
    gj = j_smart.implicit_schur_gradient(jt, jb.cam_rows, 8)
    gt = t_smart.implicit_schur_gradient(tt, tb.cam_rows, 8)
    assert _rel(gt, gj) < 1e-9 and _rel(gt.reshape(-1), g) < 1e-9
    bj = j_smart.implicit_schur_block_diag(jt, jb.cam_rows, 8)
    bt = t_smart.implicit_schur_block_diag(tt, tb.cam_rows, 8)
    assert _rel(bt, bj) < 1e-9
    assert _rel(bt, torch.stack([H[6 * c : 6 * c + 6, 6 * c : 6 * c + 6] for c in range(8)])) < 1e-9


@pytest.mark.parametrize("mode", ["jacobian_q_factors", "jacobian_svd_factors"])
def test_jacobian_modes_reproduce_hessian(mode):
    """JACOBIAN_Q / JACOBIAN_SVD: per track A^T A and A^T b equal JAX's (rel
    1e-9; the SVD basis itself is not unique) and, added into the camera
    columns, the HESSIAN mode's H and g."""
    jb, tb, R, t = _cube_batch("mono")
    jp, tp = _gathered(jb, tb, R, t)
    Aj, bj = _jx(getattr(j_smart, mode), jb, jp)
    At, bt = getattr(t_smart, mode)(tb, tp)
    T, rows = At.shape[0], At.shape[1]
    Af, Ajf = At.reshape(T, rows, -1), np.asarray(Aj).reshape(T, rows, -1)
    AtA = torch.einsum("tri,trj->tij", Af, Af)
    Atb = torch.einsum("tri,tr->ti", Af, bt)
    assert _rel(AtA, np.einsum("tri,trj->tij", Ajf, Ajf)) < 1e-9
    assert _rel(Atb, np.einsum("tri,tr->ti", Ajf, np.asarray(bj))) < 1e-9
    H, g, _ = t_smart.assemble_camera_system(tb, tp, 8)
    Hq, gq = torch.zeros_like(H), torch.zeros_like(g)
    for k in range(T):
        cols = torch.cat([tb.rows_dev[k, m] * 6 + torch.arange(6) for m in range(tb.max_views)])
        Hq[cols[:, None], cols[None, :]] += AtA[k]
        gq[cols] += Atb[k]
    assert _rel(Hq, H) < 1e-9 and _rel(gq, g) < 1e-9


def test_smart_pcg_matches_jax():
    """smart_pcg (block-Jacobi PCG on the implicit system, damped) equals
    JAX's (rel 1e-8) and the dense damped solve."""
    jb, tb, R, t = _cube_batch("mono")
    jp, tp = _gathered(jb, tb, R, t)
    xj = _jx(j_smart.smart_pcg, jb, jp, 8, 1e-3)
    xt = t_smart.smart_pcg(tb, tp, 8, lam=1e-3)
    assert _rel(xt, xj) < 1e-8
    H, g, _ = t_smart.assemble_camera_system(tb, tp, 8)
    xd = torch.linalg.solve(H + 1e-3 * torch.eye(48, dtype=H.dtype), g)
    assert _rel(xt.reshape(-1), xd) < 1e-6


def test_cube_smart_lm_history_matches_jax():
    """smart_levenberg_marquardt on the cube scene (priors on cameras 0 and
    1, the others perturbed; half-pixel noise, so the optimum's error is
    well above rounding and a relative comparison means something): the
    error history equals JAX's (rel 1e-8), and so do the final poses."""
    jb, tb, R0, t0 = _cube_batch("mono", noise=0.5, seed=11)
    R, t, _ = _cube_poses()
    R0[:2], t0[:2] = R[:2], t[:2]
    jv, tv = JValues(), TValues(device="cpu")
    for i in range(8):
        jv.insert(i, "Pose3", JPose3(jnp.asarray(R0[i]), jnp.asarray(t0[i])))
        tv.insert(i, "Pose3", TPose3(torch.tensor(R0[i]), torch.tensor(t0[i])))
    jg, tg = JGraph(), TGraph(device="cpu")
    iso = np.asarray(j_noise.isotropic(6, 1e-4, jnp.float64))
    for i in (0, 1):
        jg.add(j_factors.prior_factor("Pose3"), [i], JPose3(jnp.asarray(R[i]), jnp.asarray(t[i])),
               jnp.asarray(iso))
        tg.add(t_factors.prior_factor("Pose3"), [i], TPose3(torch.tensor(R[i]), torch.tensor(t[i])),
               iso)
    rj = j_smart.smart_levenberg_marquardt(jg, jb, jv, j_opt.LMParams(max_iterations=30))
    rt = t_smart.smart_levenberg_marquardt(tg, tb, tv, t_opt.LMParams(max_iterations=30),
                                           device="cpu")
    assert len(rt.error_history) == len(rj.error_history) and rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.error_history, rj.error_history, rtol=1e-8)
    assert rt.converged and rt.error < 0.2 * rt.error_history[0]
    np.testing.assert_allclose(rt.values.params("Pose3").t.numpy(),
                               np.asarray(rj.values.params("Pose3").t), atol=1e-7)


# --- tracks and union-find ---------------------------------------------------------


def test_tracks_from_pairwise_matches_equal_jax():
    """Equal track sets from the same keypoints and matches, inconsistent
    components (two keypoints of one image) dropped by both."""
    rng = np.random.default_rng(4)
    kps = [rng.uniform(0, 640, size=(30, 2)) for _ in range(5)]
    matches = {}
    for i in range(5):
        for j in range(i + 1, 5):
            matches[(i, j)] = np.stack([rng.permutation(30)[:20], rng.permutation(30)[:20]], 1)
    canon = lambda trs: sorted(tuple((im, tuple(np.round(uv, 9))) for im, uv in
                                     sorted(tr.measurements, key=lambda x: x[0])) for tr in trs)
    jt = j_tracks.tracks_from_pairwise_matches(kps, matches)
    tt = t_tracks.tracks_from_pairwise_matches(kps, matches)
    assert len(tt) > 0 and canon(tt) == canon(jt)


def test_dsf_matches_jax():
    """DSFVector and DSFMap: equal sets after the same unions."""
    rng = np.random.default_rng(5)
    pairs = rng.integers(0, 200, size=(150, 2))
    jv, tv = j_dsf.DSFVector(200), t_dsf.DSFVector(200)
    jv.merge_pairs(pairs[:, 0], pairs[:, 1])
    tv.merge_pairs(pairs[:, 0], pairs[:, 1])
    canon = lambda sets: sorted(tuple(sorted(map(int, v))) for v in sets.values())
    assert canon(tv.sets()) == canon(jv.sets())
    jm, tm = j_dsf.DSFMap(), t_dsf.DSFMap()
    for a, b in pairs[:60]:
        jm.merge(("k", int(a)), ("k", int(b)))
        tm.merge(("k", int(a)), ("k", int(b)))
    assert sorted(map(sorted, tm.sets().values())) == sorted(map(sorted, jm.sets().values()))


def test_smart_entry_points_raise_without_cuda():
    """No CPU fallback: the batch builder and the LM default to the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_smart.from_tracks([[(0, np.zeros(2)), (1, np.zeros(2))]], CUBE_K)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.smart_batch_from_arrays(np.zeros((1, 2)), np.ones((1, 2)), np.zeros((1, 2, 2)),
                                        CUBE_K[None])
    _, tb, _, _ = _cube_batch("mono")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_smart.smart_levenberg_marquardt(TGraph(device="cpu"), tb, TValues(device="cpu"))
