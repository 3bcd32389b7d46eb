"""JAX parity for the port's public functions that no other test compares.

Each case builds its inputs from a seed with numpy, runs the JAX package's
function (float64 on the CPU) and the port's (device="cpu", float64), and
compares them: integers, strings, orderings and bytes for equality, and
every floating result at 1e-12 relative (`assert_rel`: the largest
absolute difference over the largest absolute entry of the JAX result).

The JAX side runs eagerly, except where one `jax.jit` of the call
compiles in a fraction of the time that eager mode spends compiling each
operation on its first use (`_jit` and the module fixtures): the
linearizations, the chart and Jacobian batches, triangulation, the smart
factors, discrete elimination, the filters and the constrained solve. A
jit that closes over Python numbers or lists reads them as eager mode
does (float64 constants under x64). The file takes about 22 s alone.

The last section feeds Python numbers and lists (a float t or dt, lists
for samples, biases, covariances and Kalman matrices) to every port entry
that takes them through `device.as_float`: each must come out as the JAX
package's, which reads them as float64 under x64. Before `as_float`,
`torch.as_tensor` rounded them to float32 first (differences ~1e-8).

Results that are not port faults: none found. The port refuses to load a
Values file that names a class of another package (a JAX Pose3, say): by
design its loader admits numpy arrays and builtins only, so the
cross-package byte cases use Pose2 and vector values, which both read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.core import keys as t_keys
from gtsam_petercdev_torch.discrete import discrete as t_disc
from gtsam_petercdev_torch.geometry import essential as t_ess
from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_torch.geometry import triangulation as t_tri
from gtsam_petercdev_torch.geometry.pose3 import Pose3 as TPose3
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.linear import kalman as t_kalman
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.linear import qr as t_qr
from gtsam_petercdev_torch.linear import sampler as t_sampler
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.navigation import ahrs as t_ahrs
from gtsam_petercdev_torch.navigation import extra_factors as t_extra
from gtsam_petercdev_torch.navigation import preintegration as t_pre
from gtsam_petercdev_torch.navigation import scenario as t_sc
from gtsam_petercdev_torch.navigation.navstate import NavState as TNavState
from gtsam_petercdev_torch.nonlinear import ekf as t_ekf
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.sfm import bal as t_bal
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.slam import projection as t_proj
from gtsam_petercdev_torch.slam import smart as t_smart
from gtsam_petercdev_torch.utils import dot as t_dot
from gtsam_petercdev_torch.utils import serialization as t_ser
from gtsam_petercdev_tpu.core import keys as j_keys
from gtsam_petercdev_tpu.discrete import discrete as j_disc
from gtsam_petercdev_tpu.geometry import essential as j_ess
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.geometry import so3 as j_so3
from gtsam_petercdev_tpu.geometry import triangulation as j_tri
from gtsam_petercdev_tpu.geometry.pose3 import Pose3 as JPose3
from gtsam_petercdev_tpu.inference import symbolic as j_sym
from gtsam_petercdev_tpu.linear import kalman as j_kalman
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.linear import qr as j_qr
from gtsam_petercdev_tpu.linear import sampler as j_sampler
from gtsam_petercdev_tpu.linear import solve as j_solve
from gtsam_petercdev_tpu.navigation import ahrs as j_ahrs
from gtsam_petercdev_tpu.navigation import extra_factors as j_extra
from gtsam_petercdev_tpu.navigation import preintegration as j_pre
from gtsam_petercdev_tpu.navigation import scenario as j_sc
from gtsam_petercdev_tpu.navigation.navstate import NavState as JNavState
from gtsam_petercdev_tpu.nonlinear import ekf as j_ekf
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.sfm import bal as j_bal
from gtsam_petercdev_tpu.slam import factors as j_factors
from gtsam_petercdev_tpu.slam import projection as j_proj
from gtsam_petercdev_tpu.slam import smart as j_smart
from gtsam_petercdev_tpu.utils import dot as j_dot
from gtsam_petercdev_tpu.utils import serialization as j_ser
from test_torch_linear_extras import _constrained_toy

REL = 1e-12
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


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_rel(port, ref, rel=REL):
    """Every leaf of `port` within rel x the largest entry of `ref`'s leaf."""
    pl, rl = jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        assert a.dtype == np.float64, a.dtype
        scale = max(float(np.abs(b).max()), 1e-300) if b.size else 1.0
        diff = float(np.abs(a - b).max()) if b.size else 0.0
        assert diff <= rel * scale, (diff, scale)


def _jit(fn, *args):
    """fn(*args) under one jax.jit (the arguments arrays or pytrees of them)."""
    return jax.jit(fn)(*args)


def _rot(rng, n, s=0.6):
    return t_so3.expmap(t64(rng.normal(size=(n, 3)) * s)).numpy()


# --- keys --------------------------------------------------------------------------------


def test_labeled_symbol_accessors_match_jax():
    """labeled_symbol_chr / _label / _index on labeled keys, plain symbols
    and raw integers: equal strings and integers."""
    keys = [j_keys.labeled_symbol(c, lab, j) for c, lab, j in
            [("x", "A", 0), ("l", "B", 7), ("p", "z", (1 << 48) - 1), ("X", "~", 12345)]]
    keys += [j_keys.symbol("x", 3), j_keys.symbol("c", (1 << 56) - 1), 0, 1, (1 << 63) + 5]
    for k in keys:
        assert t_keys.labeled_symbol_chr(k) == j_keys.labeled_symbol_chr(k)
        assert t_keys.labeled_symbol_label(k) == j_keys.labeled_symbol_label(k)
        assert t_keys.labeled_symbol_index(k) == j_keys.labeled_symbol_index(k)


# --- geometry ----------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["left_jacobian", "left_jacobian_inverse"])
def test_so3_left_jacobians_match_jax(fn):
    """A batch of tangents with an angle of exactly 0, 1e-9 and near pi."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(10, 3))
    w[0] = 0.0
    w[1] = [1e-9, 0.0, 0.0]
    w[2] = [3e-10, -6e-10, 2e-10]
    w[3] = [0.0, 0.0, 3.1]
    jfn = jax.jit(getattr(j_so3, fn))
    assert_rel(getattr(t_so3, fn)(t64(w)), jfn(w))
    for k in range(4):  # one tangent at a time, unbatched
        assert_rel(getattr(t_so3, fn)(t64(w[k])), jfn(w[k]))


def test_essential_and_plane_charts_match_jax():
    """essential_retract / essential_local and plane_retract / plane_local
    on a batch of 8."""
    rng = np.random.default_rng(1)
    n = 8
    R, t = _rot(rng, n), rng.normal(size=(n, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    xi = rng.normal(size=(n, 5)) * 0.3
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d, pxi = rng.normal(size=n) * 3, rng.normal(size=(n, 3)) * 0.3

    def jax_side(E, x, P, px):
        E2, P2 = j_ess.essential_retract(E, x), j_ess.plane_retract(P, px)
        return E2, j_ess.essential_local(E, E2), P2, j_ess.plane_local(P, P2)

    jE2, jEloc, jP2, jPloc = _jit(jax_side, j_ess.EssentialMatrix(jnp.asarray(R), jnp.asarray(t)),
                                  xi, j_ess.OrientedPlane3(jnp.asarray(nrm), jnp.asarray(d)), pxi)
    tE = t_ess.EssentialMatrix(t64(R), t64(t))
    tE2 = t_ess.essential_retract(tE, t64(xi))
    assert_rel(tuple(tE2), tuple(jE2))
    assert_rel(t_ess.essential_local(tE, tE2), jEloc)
    tP = t_ess.OrientedPlane3(t64(nrm), t64(d))
    tP2 = t_ess.plane_retract(tP, t64(pxi))
    assert_rel(tuple(tP2), tuple(jP2))
    assert_rel(t_ess.plane_local(tP, tP2), jPloc)


def _track(rng, M=4):
    """M cameras 12 m behind a point, looking at it, and its noisy
    normalized image coordinates."""
    p = rng.uniform(-2, 2, size=3)
    R, t, meas = [], [], []
    for _ in range(M):
        c = rng.normal(size=3) * 2 + np.array([0, 0, -12.0])
        z = (p - c) / np.linalg.norm(p - c)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        Rm = np.stack([x, np.cross(z, x), z], axis=1)
        q = Rm.T @ (p - c)
        meas.append(q[:2] / q[2] + rng.normal(size=2) * 1e-3)
        R.append(Rm)
        t.append(c)
    return np.array(R), np.array(t), np.array(meas)


TRI_MODES = [(False, False), (True, False), (False, True)]


@pytest.fixture(scope="module")
def tri_tracks():
    """Three tracks of four views (the last view masked out on track 2), and
    the JAX package's triangulate_point3 on each track in every mode of
    TRI_MODES, under one jit."""
    rng = np.random.default_rng(2)
    R, t, meas = (np.stack(x) for x in zip(*(_track(rng) for _ in range(3))))
    mask = np.ones(meas.shape[:2], bool)
    mask[2, -1] = False

    def jax_side(poses, meas, mask):
        return [jax.vmap(lambda p, m, k: j_tri.triangulate_point3(
            p, m, k, optimize=o, use_lost=u))(poses, meas, mask) for o, u in TRI_MODES]

    return R, t, meas, mask, _jit(jax_side, JPose3(jnp.asarray(R), jnp.asarray(t)), meas, mask)


@pytest.mark.parametrize("mode", range(len(TRI_MODES)), ids=["dlt", "optimize", "lost"])
def test_triangulate_point3_matches_jax(mode, tri_tracks):
    """The point and rank_ok of each track, the port's call on one track
    at a time against the JAX package's on that track."""
    R, t, meas, mask, jout = tri_tracks
    optimize, use_lost = TRI_MODES[mode]
    jp, jok = jout[mode]
    for k in range(len(R)):
        tp, tok = t_tri.triangulate_point3(TPose3(t64(R[k]), t64(t[k])), t64(meas[k]),
                                           torch.tensor(mask[k]), optimize=optimize,
                                           use_lost=use_lost)
        assert_rel(tp, jp[k])
        assert bool(tok) == bool(jok[k])


# --- inference ---------------------------------------------------------------------------


def _random_edges(rng, n=30, extra=25):
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    loops = rng.integers(0, n, size=(extra, 2))
    loops = loops[loops[:, 0] != loops[:, 1]]
    return np.concatenate([chain, loops]).astype(np.int64)


def test_constrained_colamd_ordering_matches_jax():
    """Equal permutations, with the constrained set held last."""
    rng = np.random.default_rng(3)
    for n, last in ((30, [4, 17, 29]), (30, []), (12, list(range(12)))):
        edges = _random_edges(rng, n)
        tp = t_sym.constrained_colamd_ordering(n, edges, np.asarray(last, dtype=np.int64))
        jp = j_sym.constrained_colamd_ordering(n, edges, np.asarray(last, dtype=np.int64))
        np.testing.assert_array_equal(tp, jp)
        if last:
            assert sorted(tp[-len(last):]) == sorted(last)


def test_clique_slot_matches_jax():
    """The slot of every variable of every clique of one plan."""
    rng = np.random.default_rng(4)
    n = 30
    edges = _random_edges(rng, n)
    perm = j_sym.colamd_ordering(n, edges)
    fv = [edges]
    jp = j_sym.symbolic_eliminate(n, fv, 3, ordering=perm)
    tp = t_sym.symbolic_eliminate(n, fv, 3, ordering=perm)
    assert len(tp.cliques) == len(jp.cliques)
    for tc, jc in zip(tp.cliques, jp.cliques):
        for v in list(jc.frontal) + list(jc.separator):
            assert t_sym.clique_slot(tp, tc, v) == j_sym.clique_slot(jp, jc, v)


# --- linear ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def constrained_toy():
    """The port's linearized toy, and the JAX solve of its own, jitted once
    with lam traced (damping static)."""
    tg, tv, _ = _constrained_toy("torch")
    jg, jv, _ = _constrained_toy("jax")
    solve = jax.jit(lambda v, lam, damping: j_qr.solve_constrained_dense(
        jg.linearize(v), lam, damping), static_argnums=2)
    return tg.linearize(tv), lambda lam, damping: solve(jv, lam, damping)


@pytest.mark.parametrize("lam,damping", [(0.0, False), (1e-2, False), (0.3, True)])
def test_solve_constrained_dense_matches_jax(lam, damping, constrained_toy):
    """The 3-pose chain with pose 0 pinned exactly (one sigma==0 prior):
    the step and its linearized decrease, undamped and damped."""
    tl, jsolve = constrained_toy
    jd, jdec = jsolve(lam, damping)
    td, tdec = t_qr.solve_constrained_dense(tl, lam, damping)
    assert sorted(td) == sorted(jd)
    assert_rel([td[k] for k in sorted(td)], [jd[k] for k in sorted(jd)])
    assert_rel(tdec, jdec)


def _pose2_pair(rng, n=10):
    """A Pose2 chain with two loop closures and a prior, in both packages."""
    x = np.cumsum(rng.normal(size=(n, 3)) * [1.0, 0.3, 0.2], axis=0)
    jg, jv, tg, tv = JGraph(), JValues(), TGraph(device="cpu"), TValues(device="cpu")
    sig = np.array([0.1, 0.1, 0.05])
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (2, n - 3)]
    meas = [t_pose2.between(t64(x[i]), t64(x[j])).numpy() + rng.normal(size=3) * 0.05
            for i, j in pairs]
    for g, f, noise, arr in ((jg, j_factors, j_noise, jnp.asarray), (tg, t_factors, t_noise, t64)):
        g.add(f.prior_factor("Pose2"), [0], arr(x[0]), noise.diagonal_sigmas(sig))
        for (i, j), m in zip(pairs, meas):
            g.add(f.between_factor("Pose2"), [i, j], arr(m), noise.diagonal_sigmas(sig))
    x0 = x + rng.normal(size=x.shape) * 0.1
    for k in range(n):
        jv.insert(k, "Pose2", jnp.asarray(x0[k]))
        tv.insert(k, "Pose2", t64(x0[k]))
    return jg, jv, tg, tv


def test_zero_delta_and_linearized_decrease_match_jax():
    """zero_delta: the same types, shapes, dtype and zeros.
    linearized_decrease against the JAX package's own formula for LM's rho
    denominator (g.d - 0.5 d^T H d from its gradient and hvp, as its
    optimizers and multifrontal solve write it) on a random step."""
    rng = np.random.default_rng(5)
    jg, jv, tg, tv = _pose2_pair(rng)
    tl = tg.linearize(tv)
    tz = t_solve.zero_delta(tl, F64, "cpu")
    step = {k: rng.normal(size=tuple(tz[k].shape)) * 0.1 for k in tz}

    def jax_side(v):
        lg, d = jg.linearize(v), {k: jnp.asarray(x) for k, x in step.items()}
        g, Hd = j_solve.gradient(lg), j_solve.hvp(lg, d)
        return j_solve.zero_delta(lg, jnp.float64), sum(
            jnp.vdot(g[k], d[k]) for k in d) - 0.5 * sum(jnp.vdot(d[k], Hd[k]) for k in d)

    jz, jdec = _jit(jax_side, jv)
    assert sorted(tz) == sorted(jz)
    for k in jz:
        assert tz[k].dtype == F64 and jz[k].dtype == jnp.float64
        assert tuple(tz[k].shape) == jz[k].shape
        assert not tz[k].any() and not jz[k].any()
    assert_rel(t_solve.linearized_decrease(tl, {k: t64(v) for k, v in step.items()}), jdec)


# --- nonlinear ---------------------------------------------------------------------------


def test_check_convergence_matches_jax():
    """Across the edges of the three tolerances (error_tol, the absolute
    and the relative decrease), an increase, and old = 0: equal verdicts."""
    cases = []
    for et, at, rt in ((0.0, 1e-5, 1e-5), (1e-3, 0.0, 0.0), (0.0, 0.0, 1e-2), (0.5, 1e-2, 1e-1)):
        for old in (0.0, 1e-3, 1.0, 100.0):
            for new in (0.0, 1e-3, 0.5, old - 1e-5, old - 1e-2, old - 0.5, old * 0.99,
                        old * 0.9, old + 1e-6, old + 1.0):
                cases.append((et, at, rt, old, new))
    verdicts = set()
    for et, at, rt, old, new in cases:
        kw = dict(error_tol=et, absolute_error_tol=at, relative_error_tol=rt)
        v = t_opt.check_convergence(t_opt.OptimizerParams(**kw), old, new)
        assert v == j_opt.check_convergence(j_opt.OptimizerParams(**kw), old, new), (kw, old, new)
        verdicts.add(v)
    assert verdicts == {True, False}


def test_dogleg_params_accept_verbose_dl():
    """The JAX package's DoglegParams field; read nowhere in either."""
    assert t_opt.DoglegParams(verbose_dl=True).verbose_dl is True
    assert t_opt.DoglegParams().verbose_dl == j_opt.DoglegParams().verbose_dl is False


# --- navigation --------------------------------------------------------------------------


def _nav_state(rng, n=None):
    lead = () if n is None else (n,)
    R = _rot(rng, 1 if n is None else n)
    R = R[0] if n is None else R
    t, v = rng.normal(size=lead + (3,)), rng.normal(size=lead + (3,))
    return JNavState(*map(jnp.asarray, (R, t, v))), TNavState(*map(t64, (R, t, v)))


@pytest.mark.parametrize("dt_kind", ["python", "array"])
def test_correct_pim_matches_jax(dt_kind):
    """NavState::correctPIM with dt a Python float (dt = 0.3) or an array
    of one dt an interval."""
    rng = np.random.default_rng(6)
    if dt_kind == "python":
        js, ts = _nav_state(rng)
        xi, dt = rng.normal(size=9), 0.3
        jdt, tdt = dt, dt
    else:
        js, ts = _nav_state(rng, 5)
        xi, dt = rng.normal(size=(5, 9)), rng.uniform(0.1, 2.0, size=5)
        jdt, tdt = jnp.asarray(dt), t64(dt)
    g = np.array([0.0, 0.0, -9.81])
    jfn = j_pre.correct_pim if dt_kind == "python" else jax.vmap(
        j_pre.correct_pim, in_axes=(0, 0, 0, None))  # the JAX function takes one interval
    assert_rel(t_pre.correct_pim(ts, t64(xi), tdt, t64(g)),
               jfn(js, jnp.asarray(xi), jdt, jnp.asarray(g)))


# --- slam --------------------------------------------------------------------------------


def test_general_sfm_factor_matches_jax():
    """GeneralSFMFactor on 4 SfmCameras and 10 Point3s through each graph's
    error and linearize: residuals and both Jacobians. Point 0 lies behind
    its camera, where both mask the residual and Jacobians to zero.
    """
    rng = np.random.default_rng(7)
    n_cam, n_pt = 4, 10
    R = _rot(rng, n_cam, 0.3)
    t = rng.normal(size=(n_cam, 3)) + [0.0, 0.0, -10.0]
    cal = np.array([500.0, -0.05, 0.01]) + rng.normal(size=(n_cam, 3)) * 0.01
    pts = rng.uniform(-2, 2, size=(n_pt, 3))
    pts[0] = t[0] + R[0] @ np.array([0.1, 0.1, -5.0])  # depth -5 in camera 0
    keys = np.array([[i % n_cam, 100 + i] for i in range(n_pt)])
    uv = rng.normal(size=(n_pt, 2)) * 50
    info = np.broadcast_to(np.eye(2) / 1.5, (n_pt, 2, 2))
    jv, tv = JValues(), TValues(device="cpu")
    jv.insert_batch(np.arange(n_cam), "SfmCamera", j_bal.SfmCamera(*map(jnp.asarray, (R, t, cal))))
    jv.insert_batch(100 + np.arange(n_pt), "Point3", jnp.asarray(pts))
    tv.insert_batch(np.arange(n_cam), "SfmCamera", t_bal.SfmCamera(*map(t64, (R, t, cal))))
    tv.insert_batch(100 + np.arange(n_pt), "Point3", t64(pts))
    jg = JGraph().add_batch(j_proj.general_sfm_factor(), keys, {"uv": jnp.asarray(uv)}, info)
    tg = TGraph(device="cpu").add_batch(t_proj.general_sfm_factor(), keys, {"uv": uv}, info)
    jerr, ((jA, jb),) = _jit(lambda v: (jg.error(v), [(lb.A, lb.b) for lb in
                                                     jg.linearize(v).batches]), jv)
    assert_rel(tg.error(tv), jerr)
    (tb,) = tg.linearize(tv).batches
    assert_rel([tb.b, *tb.A], [jb, *jA])
    masked = (tb.b == 0).all(dim=-1).numpy()
    assert masked[0] and not masked.all()


def _cube_tracks(rng, noise=0.5):
    """8 cameras on a circle of radius 30 looking at the 8 corners of a
    cube (the JAX tests' scene), mono Cal3_S2 tracks, cameras perturbed."""
    pts = np.array([[x, y, z] for x in (10, -10) for y in (10, -10) for z in (10, -10)], float)
    K = np.array([50.0, 50.0, 0.0, 50.0, 50.0])
    Rs, ts = [], []
    for i in range(8):
        a = 2 * np.pi * i / 8
        c = np.array([30.0 * np.cos(a), 0.0, 30.0 * np.sin(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=1))
        ts.append(c)
    R, t = np.stack(Rs), np.stack(ts)
    tracks = []
    for p in pts:
        obs = []
        for i in range(8):
            q = R[i].T @ (p - t[i])
            if q[2] > 0:
                uvi = K[[0, 1]] * q[:2] / q[2] + K[[3, 4]]
                obs.append((i, uvi + rng.normal(size=2) * noise))
        tracks.append(obs)
    xi = rng.normal(size=(8, 6)) * 0.02
    R0 = t_so3.retract(t64(R), t64(xi[:, :3])).numpy()
    return tracks, K[None], R0, t + xi[:, 3:]


@pytest.fixture(scope="module")
def cube_smart():
    """The cube scene's smart factors in both packages, the poses gathered,
    and the JAX schur_contributions jitted once with lam traced."""
    rng = np.random.default_rng(8)
    tracks, cal, R, t = _cube_tracks(rng)
    jb = j_smart.from_tracks(tracks, jnp.asarray(cal))
    tb = t_smart.from_tracks(tracks, cal, device="cpu")
    rows = np.asarray(jb.cam_rows)
    jp = JPose3(jnp.asarray(R[rows]), jnp.asarray(t[rows]))
    tp = t_smart.gather_poses(tb, TPose3(t64(R), t64(t)))
    jfn = jax.jit(lambda p, lam: j_smart.schur_contributions(jb, p, lam))
    return tb, tp, lambda lam: jfn(jp, lam)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_schur_contributions_matches_jax(lam, cube_smart):
    """The reduced camera system's per-track pieces (Hblocks, gblocks, the
    total error) of the cube scene's smart factors, undamped and damped."""
    tb, tp, jschur = cube_smart
    assert_rel(t_smart.schur_contributions(tb, tp, lam), jschur(lam))


# --- discrete ----------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "max"])
def test_eliminate_one_matches_jax(op):
    """Eliminate each variable of a small loopy graph from the full factor
    list: the conditional's table, parents and argmax, the separator factor
    and the remaining factors' scopes."""
    rng = np.random.default_rng(9)
    cards = {0: 2, 1: 3, 2: 2, 3: 4}
    scopes = [(0,), (1,), (0, 1), (1, 2), (2, 3), (0, 3), (3,)]
    tables = [rng.uniform(0.1, 1.0, size=tuple(cards[k] for k in s)) for s in scopes]
    tables[2][0, 1] = tables[2][1, 1]  # a tie for the max-product argmax
    meta = []  # the JAX results' scopes, recorded while the jit traces

    def jax_side(tabs):
        jf = [j_disc.DiscreteFactor(s, a) for s, a in zip(scopes, tabs)]
        out = []
        for var in cards:
            c, sep, rem = j_disc.eliminate_one(jf, var, cards, op)
            meta.append((c.frontal, c.parents, sep and sep.keys, [f.keys for f in rem]))
            out.append((c.table, c.argmax, sep and sep.table))
        return out

    jout = _jit(jax_side, tables)
    tf = [t_disc.DiscreteFactor(s, t64(a)) for s, a in zip(scopes, tables)]
    for var, (jtab, jarg, jsep), (jfr, jpar, jsk, jrem) in zip(cards, jout, meta):
        tc, ts, tr = t_disc.eliminate_one(tf, var, cards, op)
        assert (tc.frontal, tc.parents) == (jfr, jpar)
        assert_rel(tc.table, jtab)
        if op == "max":
            np.testing.assert_array_equal(tc.argmax.numpy(), np.asarray(jarg))
        else:
            assert tc.argmax is None and jarg is None
        assert (ts is None) == (jsk is None)
        if ts is not None:
            assert ts.keys == jsk
            assert_rel(ts.table, jsep)
        assert [f.keys for f in tr] == jrem


# --- utils -------------------------------------------------------------------------------


def _ser_pair():
    """A Pose2 graph with a Huber-robust batch, plus a Vector3 prior."""
    rng = np.random.default_rng(10)
    jg, jv, tg, tv = _pose2_pair(rng, 6)
    v3 = rng.normal(size=3)
    jv.insert(50, "Vector3", jnp.asarray(v3))
    tv.insert(50, "Vector3", t64(v3))
    info = np.eye(3) * 4.0
    jg.add(j_factors.prior_factor("Vector3"), [50], jnp.asarray(v3 + 0.1), info)
    tg.add(t_factors.prior_factor("Vector3"), [50], t64(v3 + 0.1), info)
    for g, noise, arr in ((jg, j_noise, jnp.asarray), (tg, t_noise, t64)):
        g.add(j_factors.between_factor("Pose2") if g is jg else t_factors.between_factor("Pose2"),
              [1, 4], arr([3.0, 0.5, 0.1]), noise.diagonal_sigmas(np.array([0.2, 0.2, 0.1])),
              robust=noise.RobustLoss("huber", 1.345))
    return jg, jv, tg, tv


def _values_equal(tv, jv):
    assert sorted(tv.types()) == sorted(jv.types())
    for ty in jv.types():
        assert list(tv.type_keys(ty)) == list(jv.type_keys(ty))
        np.testing.assert_array_equal(_np(tv.params(ty)), np.asarray(jv.params(ty)))


def test_values_and_graph_bytes_cross_read():
    """Bytes JAX writes, the port reads, and the reverse; each side's graph
    error on each side's values is then equal (1e-12 relative), and the
    values bit for bit. A JAX Pose3 Values file is refused by the port."""
    jg, jv, tg, tv = _ser_pair()
    ref = float(_jit(jg.error, jv))
    assert_rel(tg.error(tv), ref)
    tv2 = t_ser.values_from_bytes(j_ser.values_to_bytes(jv), device="cpu")
    tg2 = t_ser.graph_from_bytes(j_ser.graph_to_bytes(jg), device="cpu")
    _values_equal(tv2, jv)
    assert_rel(tg2.error(tv2), ref)
    jv2 = j_ser.values_from_bytes(t_ser.values_to_bytes(tv))
    jg2 = j_ser.graph_from_bytes(t_ser.graph_to_bytes(tg))
    _values_equal(tv, jv2)
    assert_rel(t64(float(_jit(jg2.error, jv2))), ref)
    p3 = JValues()
    p3.insert(0, "Pose3", JPose3(jnp.eye(3), jnp.zeros(3)))
    with pytest.raises(ValueError, match="only numpy arrays and builtins"):
        t_ser.values_from_bytes(j_ser.values_to_bytes(p3), device="cpu")


def test_graph_to_dot_and_write_dot_match_jax(tmp_path):
    """Equal dot text for the same graph, with and without a title, and
    equal files from write_dot."""
    jg, _, tg, _ = _ser_pair()
    assert t_dot.graph_to_dot(tg) == j_dot.graph_to_dot(jg)
    assert t_dot.graph_to_dot(tg, title="pose graph") == j_dot.graph_to_dot(jg, title="pose graph")
    t_dot.write_dot(tg, str(tmp_path / "t.dot"), title="g")
    j_dot.write_dot(jg, str(tmp_path / "j.dot"), title="g")
    assert (tmp_path / "t.dot").read_text() == (tmp_path / "j.dot").read_text()


# --- Python numbers enter as float64 -----------------------------------------------------


SCENARIO_METHODS = ("rotation", "position", "velocity_n", "omega_b", "acceleration_n", "nav_state")


@pytest.mark.parametrize("t", [0.3, 7.1])
@pytest.mark.parametrize("kind", ["constant_twist", "accelerating"])
def test_scenarios_take_python_times(kind, t):
    """Each scenario method at a Python float time, both scenarios built
    from Python lists."""
    w, v = [0.1, -0.05, 0.3], [10.0, 0.2, 0.0]
    if kind == "constant_twist":
        js, ts = j_sc.constant_twist(w, v), t_sc.constant_twist(w, v, device="cpu")
    else:
        args = (np.eye(3), [1.0, 2, 3], [1.0, 0, 0], [0.3, 0.1, 0], [0.1, -0.2, 0.3])
        js = j_sc.AcceleratingScenario(*(jnp.asarray(x, dtype=jnp.float64) for x in args))
        ts = t_sc.AcceleratingScenario(*(t64(x) for x in args))
    for m in SCENARIO_METHODS:
        assert_rel(tuple(np.atleast_1d(_np(x)) for x in jax.tree_util.tree_leaves(
            getattr(ts, m)(t))), tuple(np.atleast_1d(np.asarray(x)) for x in
                                       jax.tree_util.tree_leaves(getattr(js, m)(t))))


def _imu_lists(rng, S=20):
    acc = (rng.normal(size=(S, 3)) * 0.5 + [0.0, 0.0, 9.81]).tolist()
    omega = (rng.normal(size=(S, 3)) * 0.3).tolist()
    dts = (0.004 + 0.002 * rng.random(S)).tolist()
    return acc, omega, dts


def test_preintegrate_takes_python_lists():
    """preintegrate's samples, dts and bias_hat as Python lists, and
    pim_init's bias_hat as a list."""
    rng = np.random.default_rng(11)
    acc, omega, dts = _imu_lists(rng)
    bias = [0.05, -0.03, 0.04, 2e-3, -1e-3, 1.5e-3]
    jp, tp = j_pre.default_params(), t_pre.default_params(device="cpu")
    jpim, jinit = _jit(lambda: (tuple(j_pre.preintegrate(jp, acc, omega, dts, bias)),
                                tuple(j_pre.pim_init(bias))))
    assert_rel(tuple(t_pre.preintegrate(tp, acc, omega, dts, bias)), jpim)
    assert_rel(tuple(t_pre.pim_init(bias, device="cpu")), jinit)


def test_ahrs_takes_python_lists():
    """preintegrate_rotation's gyro_cov, samples, dts and bias_hat as Python
    lists, and rotation_init's bias_hat as a list."""
    rng = np.random.default_rng(12)
    _, omega, dts = _imu_lists(rng)
    bias = [2e-3, -1e-3, 1.5e-3]
    cov = (np.eye(3) * 1e-4).tolist()
    assert_rel(tuple(t_ahrs.preintegrate_rotation(cov, omega, dts, bias)),
               tuple(j_ahrs.preintegrate_rotation(jnp.asarray(cov), omega, dts, bias)))
    assert_rel(tuple(t_ahrs.rotation_init(bias, device="cpu")), tuple(j_ahrs.rotation_init(bias)))


KF_DT = 0.1
KF_F = [[1.0, KF_DT], [0.0, 1.0]]


def _kalman_run(kf, stack):
    """A 2-state constant-velocity track of 4 steps, every matrix a Python
    list: the filtered and predicted states and the RTS smoothing."""
    B, u = [[0.5 * KF_DT * KF_DT], [KF_DT]], [0.3]
    Q = [[1e-3, 0.0], [0.0, 2e-3]]
    H, R = [[1.0, 0.0]], [[0.05]]
    s = kf.init([0.0, 1.0], [[0.1, 0.0], [0.0, 0.1]])
    filt, pred = [], []
    for z in ([0.1], [0.23], [0.31], [0.47]):
        s = kf.predict(s, KF_F, B, u, Q)
        pred.append(s)
        s = kf.update(s, H, z, R)
        filt.append(s)
    fs = kf.GaussianState(stack([f.mean for f in filt]), stack([f.cov for f in filt]))
    ps = kf.GaussianState(stack([p.mean for p in pred]), stack([p.cov for p in pred]))
    return tuple(fs), tuple(kf.smooth_rts(fs, ps, [KF_F] * len(filt)))


def test_kalman_takes_python_lists():
    """init, predict (F, B, u, Q), update (H, z, R) and smooth_rts (F) on
    Python lists (the JAX run under one jit, its lists closed over)."""
    assert_rel(_kalman_run(t_kalman, torch.stack), _jit(lambda: _kalman_run(j_kalman, jnp.stack)))


def _ekf_run(ekf, pose2, arr, Q, zs, R):
    odo = arr([1.0, 0.0, 0.1])
    b = ekf.ManifoldBelief(arr([0.0, 0.0, 0.0]), arr(0.01 * np.eye(3)))
    for z in zs:
        b = ekf.predict(b, "Pose2", lambda p: pose2.compose(p, odo), Q)
        b = ekf.update(b, "Pose2", lambda p: p[:2], z, R)
    return tuple(b)


def test_ekf_takes_python_lists():
    """ekf.predict's Q and ekf.update's z and R as Python lists, on a Pose2
    belief over three steps (the JAX run under one jit; its predict adds Q
    as given, so Q is an array there)."""
    rng = np.random.default_rng(13)
    Q = (np.eye(3) * 1e-3).tolist()
    R = (np.eye(2) * 1e-2).tolist()
    zs = [(rng.normal(size=2) * 0.1 + [k + 1.0, 0.1 * k]).tolist() for k in range(3)]
    assert_rel(_ekf_run(t_ekf, t_pose2, t64, Q, zs, R),
               _jit(lambda: _ekf_run(j_ekf, j_pose2, jnp.asarray, jnp.asarray(Q), zs, R)))


def test_sampler_takes_python_lists():
    """The draws differ (a torch.Generator against a JAX key), so what is
    compared is what each applies to its own draws: sample_diagonal's
    sigmas (the sample over the generator's standard normal draws) and
    sample_sqrt_info's transform (the port's sqrt_info_transform of JAX's
    draws against JAX's sample_sqrt_info), each from Python lists."""
    sig = [0.5, 2.0, 1.3]
    R = [[2.0, 0.5, 0.1], [0.0, 1.0, -0.3], [0.0, 0.0, 4.0]]
    key = jax.random.PRNGKey(0)
    js, jz, jr = _jit(lambda: (j_sampler.sample_diagonal(key, jnp.asarray(sig), (5,)),
                               jax.random.normal(key, (5, 3), dtype=jnp.float64),
                               j_sampler.sample_sqrt_info(key, jnp.asarray(R), (5,))))
    ts = t_sampler.sample_diagonal(torch.Generator().manual_seed(0), sig, (5,))
    tz = torch.randn((5, 3), generator=torch.Generator().manual_seed(0), dtype=F64)
    assert_rel(ts / tz, js / jz)
    assert_rel(t_sampler.sqrt_info_transform(R, t64(jz)), jr)
    tr = t_sampler.sample_sqrt_info(torch.Generator().manual_seed(1), R, (5,))
    tz = torch.randn((5, 3), generator=torch.Generator().manual_seed(1), dtype=F64)
    assert_rel(tr, np.linalg.solve(np.asarray(R), tz.numpy().T).T)


def test_extra_factor_params_take_python_numbers():
    """The magnetometer factors' 'scale' and the constant-velocity factor's
    'dt' as Python floats, straight into each residual (the graph turns
    params into float64 tensors itself)."""
    rng = np.random.default_rng(14)
    Rm = _rot(rng, 1)[0]
    d = rng.normal(size=3)
    params = {"measured": rng.normal(size=3), "direction": d / np.linalg.norm(d),
              "bias": rng.normal(size=3) * 0.1}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: t64(v) for k, v in params.items()}
    jparams["scale"] = tparams["scale"] = 0.3
    j1, t1 = _nav_state(rng)
    j2, t2 = _nav_state(rng)
    jres = _jit(lambda: (
        j_extra.mag_factor().residual((jnp.asarray(Rm),), jparams),
        j_extra.mag_pose_factor().residual((JPose3(jnp.asarray(Rm), jnp.asarray(d)),), jparams),
        j_extra.constant_velocity_factor().residual((j1, j2), {"dt": 0.3})))
    assert_rel((t_extra.mag_factor().residual((t64(Rm),), tparams),
                t_extra.mag_pose_factor().residual((TPose3(t64(Rm), t64(d)),), tparams),
                t_extra.constant_velocity_factor().residual((t1, t2), {"dt": 0.3})), jres)
