"""The port's bundle-adjustment slice against the JAX package.

Keys, calibrations, cameras, the SfmCamera manifold, the projection factors,
the synthetic BA generator, the BAL reader, the Schur solver, the routed
multifrontal solver and LM on both. Inputs come from a numpy seed and go
through both packages; the port runs on the CPU in float64.

Tolerances: geometry and linearization atol 1e-10 (the same formulas in the
same precision); solves rel 1e-9 against the JAX Schur solve and the dense
oracles; LM error histories rel 1e-8 over 5 iterations (each iteration
re-linearizes at a point that differs by rounding).
"""

import ast
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.core import keys as t_keys
from gtsam_petercdev_torch.core import manifold as t_manifold
from gtsam_petercdev_torch.geometry import cal3 as t_cal3
from gtsam_petercdev_torch.geometry import cameras as t_cameras
from gtsam_petercdev_torch.geometry.pose3 import Pose3 as TPose3
from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.models import ba_synth as t_synth
from gtsam_petercdev_torch.models import bundle_adjustment as t_ba
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.sfm import bal as t_bal
from gtsam_petercdev_torch.sfm import schur as t_schur
from gtsam_petercdev_torch.slam import projection as t_proj
from gtsam_petercdev_torch.utils import convert
from gtsam_petercdev_tpu.core import keys as j_keys
from gtsam_petercdev_tpu.core import manifold as j_manifold
from gtsam_petercdev_tpu.geometry import cal3 as j_cal3
from gtsam_petercdev_tpu.geometry import cameras as j_cameras
from gtsam_petercdev_tpu.geometry.pose3 import Pose3 as JPose3
from gtsam_petercdev_tpu.linear import solve as j_solve
from gtsam_petercdev_tpu.models import ba_synth as j_synth
from gtsam_petercdev_tpu.models import bundle_adjustment as j_ba
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.sfm import bal as j_bal
from gtsam_petercdev_tpu.sfm import schur as j_schur
from gtsam_petercdev_tpu.slam import projection as j_proj
from test_torch_factor_graph import jax_linearize
from test_torch_multifrontal import _port_sources

ATOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG = dict(n_cams=8, n_points=60, obs_per_point=4, seed=1)  # the small BA rig


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rig_pair():
    """The small rig in both packages, float64, from the same generator call."""
    jdata = j_synth.make_synthetic_ba(dtype=jnp.float64, **RIG)
    jg, jv = j_ba.build_ba_graph(jdata, dtype=jnp.float64)
    tdata = t_synth.make_synthetic_ba(dtype=np.float64, **RIG)
    tg, tv = t_ba.build_ba_graph(tdata, device="cpu")
    return jg, jv, tg, tv


def _poses(rng, n):
    """Random camera poses looking roughly at the origin from radius ~10."""
    w = rng.normal(size=(n, 3)) * 0.3
    R = np.asarray(jax.vmap(lambda x: jax.scipy.linalg.expm(jnp.array(
        [[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0]])))(jnp.asarray(w)))
    t = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, -10.0])
    return R, t


# --- keys ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,j", [("x", 0), ("c", 999), ("p", 49_999), ("l", (1 << 56) - 1)])
def test_symbol_keys(c, j):
    k = t_keys.symbol(c, j)
    assert k == j_keys.symbol(c, j)
    assert (t_keys.symbol_chr(k), t_keys.symbol_index(k)) == (c, j)
    assert t_keys.key_to_str(k) == j_keys.key_to_str(k)
    assert int(t_keys.Symbol(c, j)) == k and t_keys.shorthand(c)(j) == k
    lk = t_keys.labeled_symbol(c, "A", j & ((1 << 48) - 1))
    assert lk == j_keys.labeled_symbol(c, "A", j & ((1 << 48) - 1))
    assert repr(t_keys.LabeledSymbol.from_key(lk)) == repr(j_keys.LabeledSymbol.from_key(lk))


# --- calibrations and cameras ---------------------------------------------------------

CAL_CASES = [
    ("cal3_s2_uncalibrate", [520.0, 510.0, 0.3, 320.0, 240.0], 2),
    ("cal3_s2_calibrate", [520.0, 510.0, 0.3, 320.0, 240.0], 2),
    ("cal3_bundler_uncalibrate", [500.0, -0.05, 0.01], 2),
    ("cal3_bundler_calibrate", [500.0, -0.05, 0.01], 2),
    ("cal3_ds2_uncalibrate", [520.0, 510.0, 0.3, 320.0, 240.0, -0.1, 0.02, 1e-3, -2e-3], 2),
    ("cal3_fisheye_uncalibrate", [520.0, 510.0, 0.3, 320.0, 240.0, -0.01, 0.002, 1e-4, -2e-5], 2),
    ("cal3_unified_uncalibrate",
     [520.0, 510.0, 0.3, 320.0, 240.0, -0.1, 0.02, 1e-3, -2e-3, 0.4], 2),
    ("cal3_unified_space_from_nplane",
     [520.0, 510.0, 0.3, 320.0, 240.0, -0.1, 0.02, 1e-3, -2e-3, 0.4], 2),
    ("stereo_uncalibrate", [520.0, 510.0, 0.3, 320.0, 240.0, 0.12], 3),
]


@pytest.mark.parametrize("name,k,width", CAL_CASES, ids=[c[0] for c in CAL_CASES])
def test_calibration_maps(name, k, width, rng):
    p = rng.normal(size=(16, width)) * 0.2
    p[0] = 0.0  # the fisheye model's r = 0 branch
    if name.endswith("_calibrate"):  # image coordinates, from the forward map
        fwd = name.replace("_calibrate", "_uncalibrate")
        p = np.asarray(getattr(j_cal3, fwd)(jnp.asarray(k), jnp.asarray(p)))
    k_batch = np.broadcast_to(np.asarray(k), (16, len(k))) * (1.0 + 0.01 * rng.normal(size=(16, 1)))
    for kk in (np.asarray(k), k_batch):
        _close(getattr(t_cal3, name)(_t(kk), _t(p)), getattr(j_cal3, name)(jnp.asarray(kk),
                                                                        jnp.asarray(p)))


@pytest.mark.parametrize("name", ["cal3_ds2_calibrate", "cal3_fisheye_calibrate",
                                  "cal3_unified_calibrate"])
def test_newton_calibrations(name, rng):
    """The iterative inverses, one point at a time as the JAX package runs them."""
    k = CAL_CASES[4][1] if name == "cal3_ds2_calibrate" else (
        CAL_CASES[5][1] if name == "cal3_fisheye_calibrate" else CAL_CASES[6][1])
    fwd = {"cal3_ds2_calibrate": "cal3_ds2_uncalibrate",
           "cal3_fisheye_calibrate": "cal3_fisheye_uncalibrate",
           "cal3_unified_calibrate": "cal3_ds2_uncalibrate"}[name]
    for p in rng.normal(size=(3, 2)) * 0.2:
        pi = np.asarray(getattr(j_cal3, fwd)(jnp.asarray(k[:9]), jnp.asarray(p)))
        _close(getattr(t_cal3, name)(_t(k), _t(pi)), getattr(j_cal3, name)(jnp.asarray(k),
                                                                        jnp.asarray(pi)))


def test_calibration_constructors():
    for name, args in (("cal3_s2", (1, 2, 3, 4, 5)), ("cal3_bundler", (500, 0.1, 0.2)),
                       ("cal3_fisheye", (1, 2, 3, 4, 5, 6)), ("cal3_unified", (1, 2, 3, 4, 5)),
                       ("cal3_s2_stereo", (1, 2, 3, 4, 5, 0.1))):
        got = getattr(t_cal3, name)(*args, device="cpu")
        _close(got, getattr(j_cal3, name)(*args, dtype=jnp.float64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cal3.cal3_bundler(500.0, 0.0, 0.0)


@pytest.mark.parametrize("name", ["project_to_normalized", "project_bundler", "project_s2",
                                  "stereo_project", "backproject_s2"])
def test_camera_projections(name, rng):
    """Points in front of, behind and (one) on the camera plane: image point
    and depth agree, so the cheirality masks agree."""
    n = 24
    R, t = _poses(rng, n)
    pts = rng.uniform(-3, 3, size=(n, 3))
    pts[0] = t[0] + R[0] @ np.array([0.3, -0.2, -4.0])  # behind the camera
    pts[1] = t[1] + R[1] @ np.array([0.3, -0.2, 0.0])  # on the camera plane
    cal = {"project_bundler": [500.0, -0.05, 0.01], "project_s2": CAL_CASES[0][1],
           "backproject_s2": CAL_CASES[0][1], "stereo_project": CAL_CASES[8][1]}.get(name)
    tp, jp = TPose3(_t(R), _t(t)), JPose3(jnp.asarray(R), jnp.asarray(t))
    if name == "backproject_s2":
        uv, depth = rng.normal(size=(n, 2)) * 100 + 300, rng.uniform(1, 9, size=n)
        _close(t_cameras.backproject_s2(tp, _t(cal), _t(uv), _t(depth)),
               j_cameras.backproject_s2(jp, jnp.asarray(cal), jnp.asarray(uv), jnp.asarray(depth)))
        return
    args_t = (tp, _t(pts)) + ((_t(cal),) if cal else ())
    args_j = (jp, jnp.asarray(pts)) + ((jnp.asarray(cal),) if cal else ())
    (uv_t, z_t), (uv_j, z_j) = getattr(t_cameras, name)(*args_t), getattr(j_cameras, name)(*args_j)
    _close(z_t, z_j)
    _close(uv_t, uv_j, atol=1e-10 * max(1.0, float(np.abs(np.asarray(uv_j)).max())))
    assert (np.asarray(z_j) <= 0).any() and (np.asarray(z_j) > 0).any()


# --- the SfmCamera manifold -------------------------------------------------------------


def test_sfm_camera_retract_local(rng):
    n = 12
    R, t = _poses(rng, n)
    cal = np.array([500.0, -0.05, 0.01]) + rng.normal(size=(n, 3)) * 0.01
    xi = rng.normal(size=(n, 9)) * 0.2
    tm, jm = t_manifold.get("SfmCamera"), j_manifold.get("SfmCamera")
    assert tm.dim == jm.dim == 9
    tc = t_bal.SfmCamera(_t(R), _t(t), _t(cal))
    jc = j_bal.SfmCamera(jnp.asarray(R), jnp.asarray(t), jnp.asarray(cal))
    tr, jr = tm.retract(tc, _t(xi)), jm.retract(jc, jnp.asarray(xi))
    for a, b in zip(tr, jr):
        _close(a, b)
    _close(tm.local(tc, tr), jm.local(jc, jr))
    _close(tm.local(tc, tr), xi, atol=1e-9)
    ident = tm.identity(device="cpu")
    for a, b in zip(ident, jm.identity(jnp.float64)):
        _close(a, b)


# --- projection factors ---------------------------------------------------------------------


def _check_linearize(jg, jv, tg, tv):
    np.testing.assert_allclose(float(tg.error(tv)), float(jax.jit(jg.error)(jv)), rtol=1e-12)
    jl, tl = jax_linearize(jg, jv), tg.linearize(tv)
    assert tl.type_counts == jl.type_counts
    for jb, tb in zip(jl.batches, tl.batches):
        assert tb.var_types == jb.var_types
        for jr, tr in zip(jb.rows, tb.rows):
            np.testing.assert_array_equal(tr, np.asarray(jr))
        scale = max(1.0, float(np.abs(np.asarray(jb.b)).max()))
        _close(tb.b, jb.b, atol=ATOL * scale)
        for jA, tA in zip(jb.A, tb.A):
            _close(tA, jA, atol=ATOL * max(1.0, float(np.abs(np.asarray(jA)).max())))


def test_general_sfm_factor_linearization():
    """The BA graph of the small rig: GeneralSFMFactor (forward-mode
    Jacobians w.r.t. the 9-dim camera and the point) and both priors."""
    jg, jv, tg, tv = _rig_pair()
    jg._materialize()
    assert [b.ftype.name for b in tg.batches] == [b.ftype.name for b in jg.batches]
    _check_linearize(jg, jv, tg, tv)


FIXED_CAL = {"ProjectionFactorCal3_S2": ("projection_factor_s2", CAL_CASES[0][1], 2),
             "ProjectionFactorCal3Bundler": ("projection_factor_bundler_fixed",
                                             [500.0, -0.05, 0.01], 2),
             "GenericStereoFactor": ("stereo_factor", CAL_CASES[8][1], 3)}


@pytest.mark.parametrize("name", sorted(FIXED_CAL))
def test_fixed_calibration_factor_linearization(name, rng):
    """(Pose3, Point3) factors with K as a per-factor parameter; one point is
    behind its camera, where residual and Jacobians are masked to zero."""
    make, K, rdim = FIXED_CAL[name]
    n_pose, n_pt = 4, 10
    R, t = _poses(rng, n_pose)
    pts = rng.uniform(-2, 2, size=(n_pt, 3))
    pts[0] = t[0] + R[0] @ np.array([0.1, 0.1, -5.0])
    keys = np.array([[i % n_pose, 100 + i] for i in range(n_pt)])
    params = {"uv": rng.normal(size=(n_pt, rdim)) * 50, "K": np.broadcast_to(K, (n_pt, len(K)))}
    info = np.broadcast_to(np.eye(rdim) / 1.5, (n_pt, rdim, rdim))
    jv = JValues()
    jv.insert_batch(np.arange(n_pose), "Pose3", JPose3(jnp.asarray(R), jnp.asarray(t)))
    jv.insert_batch(100 + np.arange(n_pt), "Point3", jnp.asarray(pts))
    jg = JGraph().add_batch(getattr(j_proj, make)(), keys,
                            {k: jnp.asarray(v) for k, v in params.items()}, info)
    tv = convert.values_from_arrays(
        {"Pose3": (np.arange(n_pose), (R, t)), "Point3": (100 + np.arange(n_pt), pts)},
        device="cpu")
    tg = convert.graph_from_arrays([(name, keys, params, info)], device="cpu")
    assert tg.batches[0].ftype is getattr(t_proj, make)()
    _check_linearize(jg, jv, tg, tv)
    assert float(tg.linearize(tv).batches[0].A[0][0].abs().max()) == 0.0  # the masked factor


def test_float32_linearization_stays_float32():
    """Forward-mode Jacobians of the 9-dim camera chart in float32 (the
    dtype the BA benchmark runs) come out in float32 and agree with float64."""
    data = t_synth.make_synthetic_ba(dtype=np.float32, **RIG)
    g32, v32 = t_ba.build_ba_graph(data, dtype=torch.float32, device="cpu")
    g64, v64 = t_ba.build_ba_graph(data, dtype=torch.float64, device="cpu")
    for b32, b64 in zip(g32.linearize(v32).batches, g64.linearize(v64).batches):
        assert b32.b.dtype == torch.float32 and all(a.dtype == torch.float32 for a in b32.A)
        for a32, a64 in zip(b32.A, b64.A):
            assert _rel(a32, a64) < 1e-4


# --- the synthetic generator and the BAL reader ------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_make_synthetic_ba_is_bit_identical(dtype):
    kw = dict(n_cams=12, n_points=150, obs_per_point=3, pixel_noise=0.7, seed=5)
    jd = j_synth.make_synthetic_ba(dtype=jnp.dtype(dtype), **kw)
    td = t_synth.make_synthetic_ba(dtype=dtype, **kw)
    assert (td.n_cameras, td.n_tracks) == (jd.n_cameras, jd.n_tracks) == (12, 150)
    for tc, jc in zip(td.cameras, jd.cameras):
        for a, b in zip(tc, jc):
            assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    for tt, jt in zip(td.tracks, jd.tracks):
        assert np.array_equal(tt.point, jt.point)
        assert np.array_equal(tt.cam_idx, jt.cam_idx) and tt.cam_idx.dtype == jt.cam_idx.dtype
        assert tt.uv.dtype == jt.uv.dtype and np.array_equal(tt.uv, jt.uv)


def test_build_ba_graph_matches_jax():
    jg, jv, tg, tv = _rig_pair()
    jg._materialize()
    assert tv.type_keys("SfmCamera") == jv.type_keys("SfmCamera")
    assert tv.type_keys("Point3") == jv.type_keys("Point3")
    for a, b in zip(tv.params("SfmCamera"), jv.params("SfmCamera")):
        _close(a, b, atol=0)
    _close(tv.params("Point3"), jv.params("Point3"), atol=0)
    for tb, jb in zip(tg.batches, jg.batches):
        np.testing.assert_array_equal(tb.keys, np.asarray(jb.keys))
        _close(tb.sqrt_info, jb.sqrt_info, atol=0)
    _close(tg.batches[0].params["uv"], jg.batches[0].params["uv"], atol=0)


def _write_bal(path, rng, n_cams=3, n_pts=7):
    obs = [(i, j, *rng.normal(size=2) * 100) for j in range(n_pts) for i in range(n_cams)
           if (i + j) % 3 != 0 or i == 0]
    cams = np.concatenate([rng.normal(size=(n_cams, 3)) * 0.3, rng.normal(size=(n_cams, 3)),
                           np.tile([450.0, -1e-2, 1e-4], (n_cams, 1))], axis=1)
    cams[0, :3] = 0.0  # the zero-rotation branch of the Rodrigues formula
    pts = rng.normal(size=(n_pts, 3))
    with open(path, "w") as f:
        f.write(f"{n_cams} {n_pts} {len(obs)}\n")
        for i, j, u, v in obs:
            f.write(f"{i} {j}     {u:.6e} {v:.6e}\n")
        for val in list(cams.reshape(-1)) + list(pts.reshape(-1)):
            f.write(f"{val:.16e}\n")
    return len(obs)


def test_read_bal(tmp_path, rng):
    path = str(tmp_path / "problem-3-7-pre.txt")
    n_obs = _write_bal(path, rng)
    td, jd = t_bal.read_bal(path), j_bal.read_bal(path)
    assert (td.n_cameras, td.n_tracks) == (jd.n_cameras, jd.n_tracks) == (3, 7)
    assert sum(len(tr.cam_idx) for tr in td.tracks) == n_obs
    for tc, jc in zip(td.cameras, jd.cameras):
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-15, rtol=0)
    for tt, jt in zip(td.tracks, jd.tracks):
        np.testing.assert_array_equal(tt.point, jt.point)
        np.testing.assert_array_equal(tt.cam_idx, jt.cam_idx)
        np.testing.assert_array_equal(tt.uv, np.asarray(jt.uv).reshape(-1, 2))
    # the file's graph builds and its error is the JAX package's
    tg, tv = t_ba.build_ba_graph(td, device="cpu")
    jg, jv = j_ba.build_ba_graph(jd, dtype=jnp.float64)
    np.testing.assert_allclose(float(tg.error(tv)), float(jg.error(jv)), rtol=1e-12)


# --- linear solves ----------------------------------------------------------------------------------

SOLVE_CASES = [(1e-4, False), (1e-2, True)]


@pytest.fixture(scope="module")
def rig_solves():
    """Per (lambda, damping): the JAX Schur step and the JAX dense-oracle
    step at the rig's initial point, keyed by type."""
    jg, jv, tg, tv = _rig_pair()
    jl = jax_linearize(jg, jv)
    plan = j_schur.build_schur_plan(jl)
    rows_static = tuple(tuple(np.asarray(r) for r in lb.rows) for lb in jl.batches)
    Ab = tuple((lb.A, lb.b) for lb in jl.batches)
    H, g = j_solve.assemble_dense(jl)
    ref = {}
    for lam, damping in SOLVE_CASES:
        x = j_solve.dense_solve(H, g, lam, diagonal_damping=damping)
        ref[lam, damping] = (
            j_schur.schur_solve(plan, rows_static, Ab, lam, diagonal_damping=damping),
            j_solve.unflatten_delta(jl, x))
    return tg, tv, ref


@pytest.mark.parametrize("lam,damping", SOLVE_CASES)
@pytest.mark.parametrize("solver", ["schur", "multifrontal"])
def test_ba_step_matches_jax_schur_and_dense(solver, lam, damping, rig_solves):
    """The port's Schur solve and its routed multifrontal solve (K4 leaf
    bucket feeding a K3 root through the block-layout extend-add) against
    the JAX Schur solve and both dense oracles, rel 1e-9."""
    tg, tv, ref = rig_solves
    lg = tg.linearize(tv)
    if solver == "schur":
        delta, lin_dec = t_schur.solve_linearized(tg, tv, lam, damping, cache={"schur_lg": lg})
    else:
        cache = {"mf_lg": lg}
        delta, lin_dec = t_elim.solve_linearized(tg, tv, lam, damping, cache=cache)
        assert int(cache["bad_pivots"]) == 0
        _, maps = t_elim._graph_plan(tg, lg)
        routes = [t_elim.bucket_route(bm, 9, 8) for bm in maps.buckets]
        assert routes[0] == "blocks" and "smem" in routes
    H, g = t_solve.assemble_dense(lg)
    x_dense = t_solve.unflatten_delta(lg, t_solve.dense_solve(H, g, lam, diagonal_damping=damping))
    j_schur_delta, j_dense = ref[lam, damping]
    for t in ("SfmCamera", "Point3"):
        assert _rel(delta[t], x_dense[t]) < 1e-9
        assert _rel(delta[t], j_dense[t]) < 1e-9
        assert _rel(delta[t], j_schur_delta[t]) < 1e-9
    assert float(lin_dec) > 0


def test_indefinite_camera_system_is_rejected_not_raised():
    """A reduced camera matrix that is not positive definite (a negative
    lambda here) is reported as bad pivots, as the multifrontal solver's
    clamped pivots are, so LM re-damps instead of failing."""
    _, _, tg, tv = _rig_pair()
    for solve in (t_schur.solve_linearized, t_elim.solve_linearized):
        cache = {}
        solve(tg, tv, -1e9, cache=cache)
        assert int(cache["bad_pivots"]) > 0
        solve(tg, tv, 1e-4, cache=cache)
        assert int(cache["bad_pivots"]) == 0


def test_schur_plan_matches_jax_and_lives_on_the_graph():
    jg, jv, tg, tv = _rig_pair()
    lg = tg.linearize(tv)
    tp, jp = t_schur.build_schur_plan(lg), j_schur.build_schur_plan(jax_linearize(jg, jv))
    assert (tp.cam_type, tp.dc, tp.n_cams, tp.n_pts) == (jp.cam_type, jp.dc, jp.n_cams, jp.n_pts)
    assert (tp.proj, tp.cam_only, tp.pt_only) == (jp.proj, jp.cam_only, jp.pt_only)
    for (ta, tb), (ja, jb) in zip(tp.pairs, jp.pairs):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    # the optimizer hook's plan is cached on the graph object, not in a
    # module table keyed by id(graph): it goes when the graph goes
    t_schur.solve_linearized(tg, tv, 1e-4)
    plan, _ = t_schur._graph_plan(tg, lg)
    assert t_schur._graph_plan(tg, lg)[0] is plan
    assert not hasattr(t_schur, "_SCHUR_CACHE")
    import weakref

    ref = weakref.ref(plan)
    del tg, plan
    gc.collect()
    assert ref() is None
    with pytest.raises(NotImplementedError, match="sign"):
        lg.batches[0].sign = -1.0
        t_schur.build_schur_plan(lg)


# --- LM end to end -----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lm_histories():
    """One JAX LM run per solver on the small rig (shared by the cases)."""
    jg, jv, _, _ = _rig_pair()
    return {solver: j_opt.levenberg_marquardt(
        jg, jv, j_opt.LMParams(max_iterations=5, solver=solver)) for solver in
        ("multifrontal", "schur")}


@pytest.mark.parametrize("solver", ["multifrontal", "schur"])
def test_lm_error_history_matches_jax(solver, jax_lm_histories):
    _, _, tg, tv = _rig_pair()
    jres = jax_lm_histories[solver]
    tres = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(max_iterations=5, solver=solver),
                                     device="cpu")
    assert tres.iterations == jres.iterations
    assert tres.error < 0.2 * tres.error_history[0]
    np.testing.assert_allclose(tres.error_history, jres.error_history, rtol=1e-8)
    for a, b in zip(tres.values.params("SfmCamera"), jres.values.params("SfmCamera")):
        _close(a, b, atol=1e-6)
    _close(tres.values.params("Point3"), jres.values.params("Point3"), atol=1e-6)


def test_optimize_ba_and_unknown_solver():
    data = t_synth.make_synthetic_ba(dtype=np.float64, **RIG)
    res = t_ba.optimize_ba(data, t_opt.LMParams(solver="schur", max_iterations=3), device="cpu")
    assert res.error < res.error_history[0]
    tg, tv = t_ba.build_ba_graph(data, device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver="pcg"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ba.build_ba_graph(data)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ba.optimize_ba(data)


# --- port rules -----------------------------------------------------------------------------------------

NEW_MODULES = ["core/keys.py", "geometry/cal3.py", "geometry/cameras.py", "sfm/bal.py",
               "sfm/schur.py", "slam/projection.py", "models/ba_synth.py",
               "models/bundle_adjustment.py", "ops/cholesky.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_no_jax_and_loads_no_foreign_library(module):
    """Each module of this slice is among the sources the import test walks,
    imports neither jax nor the JAX package, and names none of its native
    libraries."""
    path = os.path.join(REPO, "gtsam_petercdev_torch", module)
    assert path in set(_port_sources())
    with open(path) as f:
        src = f.read()
    for node in ast.walk(ast.parse(src, filename=path)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "gtsam_petercdev_tpu"), name
    assert "_native" not in src.replace("_read_bal_native", "") and "load_library" not in src
