"""The port's fixed-lag smoothing (nonlinear/fixed_lag.py) and NonlinearISAM
(nonlinear/nonlinear_isam.py) against the JAX package.

The streams are tests/test_fixed_lag.py's (a Pose2 chain with unary xy
measurements, made from a seed with numpy); the port runs on the CPU in
float64. The incremental smoother's marginalizations depend on the Bayes
tree, so both sides run on the COLAMD proxy there (the JAX side its "jax"
engine; as tests/test_torch_isam2.py); the batch smoother and
NonlinearISAM do not build one.

Tolerances: the marginal's information and gradient (sqrtH^T sqrtH,
sqrtH^T rhs: sqrtH itself is unique only up to an orthogonal factor)
atol 1e-9; a JAX-made marginal graph carried across, error rel 1e-12;
smoother estimates against JAX 1e-8 (tangent norm); against the full
batch the JAX tests' 1e-3 (batch smoother) and 2e-3 (incremental);
NonlinearISAM against JAX 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.inference import incremental as t_inc
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.nonlinear import fixed_lag as t_fl
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType as TFactorType
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.nonlinear_isam import NonlinearISAM as TNonlinearISAM
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert
from gtsam_petercdev_torch.utils.synthetic import pose2_compose_np as compose
from gtsam_petercdev_tpu.nonlinear import fixed_lag as j_fl
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from gtsam_petercdev_tpu.nonlinear.factor_graph import FactorType as JFactorType
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.nonlinear_isam import NonlinearISAM as JNonlinearISAM
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

ODO = np.array([1.0, 0.0, 0.05])
UN_INFO = np.eye(2) / 0.05
ODO_INFO = np.eye(3) / 0.02
PR_INFO = np.eye(3) / 0.01


def _unary_xy(FT):
    """tests/test_fixed_lag.py's unary xy factor, in either package."""
    return FT("UnaryXY", ("Pose2",), 2, lambda xs, params: xs[0][..., :2] - params)


J_UN, T_UN = _unary_xy(JFactorType), _unary_xy(TFactorType)


def _simulate(T, seed):
    rng = np.random.default_rng(seed)
    gt = [np.zeros(3)]
    for _ in range(T - 1):
        gt.append(compose(gt[-1], ODO))
    return gt, [p[:2] + rng.normal(size=2) * 0.05 for p in gt]


def _step_factors(t, gt, meas):
    """(factor, keys, params, sqrt_info) of time step t: a unary, and the
    prior (t = 0) or the odometry."""
    facs = [("un", [t], meas[t], UN_INFO)]
    facs.append(("Prior", [0], gt[0], PR_INFO) if t == 0 else ("Between", [t - 1, t], ODO, ODO_INFO))
    return facs


def _graph(facs, jax_side):
    g = JGraph() if jax_side else TGraph(device="cpu")
    for kind, keys, p, info in facs:
        if kind == "un":
            ft = J_UN if jax_side else T_UN
        else:
            ft = getattr(j_factors if jax_side else t_factors, kind.lower() + "_factor")("Pose2")
        g.add(ft, keys, jnp.asarray(p) if jax_side else p, info)
    return g


def _values(items, jax_side):
    v = JValues() if jax_side else TValues(device="cpu")
    for k, x in items:
        v.insert(k, "Pose2", jnp.asarray(x) if jax_side else x)
    return v


def _tangent_gap(a, b):
    """||local(a, b)|| for two Pose2 as numpy."""
    return float(np.linalg.norm(t_pose2.local(torch.as_tensor(a), torch.as_tensor(b)).numpy()))


def _hg(graph):
    """(keys, H = sqrtH^T sqrtH, g = sqrtH^T rhs) of a graph's one marginal
    factor."""
    graph._materialize()
    (b,) = [b for b in graph.batches if b.ftype.name.startswith("LinearContainer")]
    sqrtH, rhs = np.asarray(b.params[1])[0], np.asarray(b.params[2])[0]
    return [int(k) for k in b.keys[0]], sqrtH.T @ sqrtH, sqrtH.T @ rhs


def test_marginalize_keys_matches_jax():
    """tests/test_fixed_lag.py's 4-pose problem at perturbed values, key 0
    marginalized: the same boundary, H_marg and g_marg (atol 1e-9), the
    same kept factors; after LM from there, the remaining estimates match
    the full solution (the JAX test's 1e-6)."""
    gt, meas = _simulate(4, seed=0)
    rng = np.random.default_rng(0)
    init = [(i, compose(p, rng.normal(size=3) * 0.01)) for i, p in enumerate(gt)]
    facs = [f for t in range(4) for f in _step_factors(t, gt, meas)]
    gj, vj = j_fl.marginalize_keys(_graph(facs, True), _values(init, True), [0])
    gt_, vt = t_fl.marginalize_keys(_graph(facs, False), _values(init, False), [0], device="cpu")
    kj, Hj, g_j = _hg(gj)
    kt, Ht, g_t = _hg(gt_)
    assert kt == kj and 0 not in vt and sorted(vt.keys()) == [1, 2, 3]
    np.testing.assert_allclose(Ht, Hj, atol=1e-9)
    np.testing.assert_allclose(g_t, g_j, atol=1e-9)
    assert gt_.num_factors == gj.num_factors
    np.testing.assert_allclose(float(gt_.error(vt)), float(gj.error(vj)), rtol=1e-12)

    full = t_opt.levenberg_marquardt(_graph(facs, False), _values(init, False),
                                     t_opt.LMParams(max_iterations=20), device="cpu")
    g2, v2 = t_fl.marginalize_keys(_graph(facs, False), full.values, [0], device="cpu")
    res2 = t_opt.levenberg_marquardt(g2, v2, t_opt.LMParams(max_iterations=20), device="cpu")
    for k in (1, 2, 3):
        assert _tangent_gap(res2.values.at(k), full.values.at(k)) < 1e-6


def test_jax_container_graph_converts():
    """A marginal graph the JAX package made (a Pose2 chain with a loop,
    keys 0 and 1 marginalized) carried across as numpy by
    convert.graph_from_arrays computes the same error (rel 1e-12)."""
    rng = np.random.default_rng(4)
    gt, _ = _simulate(6, seed=4)
    facs = [("Prior", [0], gt[0], PR_INFO)] + [
        ("Between", [t - 1, t], ODO, ODO_INFO) for t in range(1, 6)] + [
        ("Between", [0, 4], compose(compose(compose(ODO, ODO), ODO), ODO), ODO_INFO)]
    vals = [(i, compose(p, rng.normal(size=3) * 0.05)) for i, p in enumerate(gt)]
    gj, vj = j_fl.marginalize_keys(_graph(facs, True), _values(vals, True), [0, 1])
    arrays = [(b.ftype.name, np.asarray(b.keys), jax.tree_util.tree_map(np.asarray, b.params),
               np.asarray(b.sqrt_info)) for b in gj.batches]
    assert any(name.startswith("LinearContainer[Pose2,Pose2") for name, *_ in arrays)
    gt_ = convert.graph_from_arrays(arrays, device="cpu")
    vt = _values([(k, np.asarray(vj.at(k))) for k in vj.keys()], False)
    np.testing.assert_allclose(float(gt_.error(vt)), float(gj.error(vj)), rtol=1e-12)


def _run_smoother(sm, T, gt, meas, jax_side, batch_kind):
    """Drive a fixed-lag smoother over T steps (each new pose from the last
    estimate composed with the odometry); returns (estimate, the full
    graph, its initial values, the marginalized key lists)."""
    facs_all, init_all, marg, est = [], [], [], None
    for t in range(T):
        prev = None if t == 0 else (sm.values if batch_kind else est).at(t - 1)
        init = gt[t] if t == 0 else compose(np.asarray(prev), ODO)
        facs = _step_factors(t, gt, meas)
        facs_all += facs
        init_all.append((t, init))
        r = sm.update(_graph(facs, jax_side), _values([(t, init)], jax_side), {t: float(t)})
        est = r.values
        marg.append(list(r.marginalized))
    return est, facs_all, init_all, marg


@pytest.mark.parametrize("kind", ["batch", "incremental"])
def test_fixed_lag_smoothers_match_jax_and_batch(kind, monkeypatch):
    """tests/test_fixed_lag.py's smoothers, lag 4: the batch one over the
    first 7 of its 12 steps (two marginalizations, the second after an LM
    over the first one's marginal factor; the JAX side's LM compiles anew
    for every window, ~4 s a step on the CPU), the incremental one over its
    40: the same keys marginalized at every update, in-window estimates =
    JAX's (1e-8) and = a batch LM of the whole history (the JAX tests' 1e-3
    / 2e-3); the window and, for the incremental smoother, the live cliques
    stay bounded."""
    lag = 4.0
    if kind == "batch":
        T, seed, bound = 7, 3, 1e-3
        sj = j_fl.BatchFixedLagSmoother(lag, j_opt.LMParams(max_iterations=15))
        st = t_fl.BatchFixedLagSmoother(lag, t_opt.LMParams(max_iterations=15), device="cpu")
    else:
        from gtsam_petercdev_tpu.native import build as j_native

        monkeypatch.setattr(j_native, "load_ccolamd", lambda *a, **k: None)
        monkeypatch.setattr(t_inc, "ccolamd_ordering", t_sym.colamd_ordering)
        monkeypatch.setattr(t_sym, "ccolamd_ordering", t_sym.colamd_ordering)
        T, seed, bound = 40, 7, 2e-3
        params = dict(relinearize_threshold=0.0, relinearize_skip=1, wildfire_threshold=0.0)
        sj = j_fl.IncrementalFixedLagSmoother(lag, j_isam2.ISAM2Params(engine_backend="jax", **params))
        st = t_fl.IncrementalFixedLagSmoother(lag, t_isam2.ISAM2Params(**params), device="cpu")
    gt, meas = _simulate(T, seed)
    ej, _, _, mj = _run_smoother(sj, T, gt, meas, True, kind == "batch")
    et, facs, init, mt = _run_smoother(st, T, gt, meas, False, kind == "batch")
    assert mt == mj and sum(map(len, mt)) == T - int(lag) - 1
    assert sorted(et.keys()) == sorted(int(k) for k in ej.keys())
    assert len(et) <= int(lag) + 2
    if kind == "incremental":
        assert st.isam.engine.n_live <= int(lag) + 3
    batch = t_opt.levenberg_marquardt(_graph(facs, False), _values(init, False),
                                      t_opt.LMParams(max_iterations=30), device="cpu")
    for k in et.keys():
        assert _tangent_gap(et.at(k), np.asarray(ej.at(k))) < 1e-8, k
        assert _tangent_gap(et.at(k), batch.values.at(k)) < bound, k


def test_nonlinear_isam_matches_jax():
    """NonlinearISAM with reorder interval 2 over 5 steps of the stream
    (three linear updates, two reorderings): the estimate after every step
    = JAX's (1e-9)."""
    gt, meas = _simulate(5, seed=5)
    rng = np.random.default_rng(5)
    nj, nt = JNonlinearISAM(reorder_interval=2), TNonlinearISAM(reorder_interval=2, device="cpu")
    for t in range(5):
        facs = _step_factors(t, gt, meas)
        x0 = compose(gt[t], rng.normal(size=3) * 0.05)
        nj.update(_graph(facs, True), _values([(t, x0)], True))
        nt.update(_graph(facs, False), _values([(t, x0)], False))
        ej, et = nj.estimate(), nt.estimate()
        for k in range(t + 1):
            assert _tangent_gap(et.at(k), np.asarray(ej.at(k))) < 1e-9, (t, k)


def test_isam2_takes_a_marginal_wider_than_its_block():
    """A marginal factor on two poses (6 whitened rows, the engine's block
    is 3) enters ISAM2 as two row blocks: the delta of an exact update =
    the dense solve of the same graph (atol 1e-9, the JAX ISAM2 contract's
    tolerance), the error = the graph's (rel 1e-12). The JAX engine has no
    such split (its factor rows are at most one block wide)."""
    from gtsam_petercdev_torch.linear import solve as t_solve

    rng = np.random.default_rng(11)
    gt, _ = _simulate(6, seed=11)
    facs = [("Prior", [0], gt[0], PR_INFO)] + [
        ("Between", [t - 1, t], ODO, ODO_INFO) for t in range(1, 6)] + [
        ("Between", [0, 4], compose(compose(compose(ODO, ODO), ODO), ODO), ODO_INFO)]
    vals = [(i, compose(p, rng.normal(size=3) * 0.05)) for i, p in enumerate(gt)]
    g, v = t_fl.marginalize_keys(_graph(facs, False), _values(vals, False), [0], device="cpu")
    assert any(b.ftype.resid_dim == 6 for b in g.batches)
    isam = t_isam2.ISAM2(t_isam2.ISAM2Params(enable_relinearization=False, wildfire_threshold=0.0,
                                             device="cpu"))
    res = isam.update(g, v)
    assert res.n_new_factors == g.num_factors and len(res.new_factor_units) == g.num_factors + 1
    H, gg = t_solve.assemble_dense(g.linearize(v))
    np.testing.assert_allclose(isam.delta()["Pose2"].numpy(),
                               t_solve.dense_solve(H, gg).reshape(-1, 3).numpy(), atol=1e-9)
    assert isam.error(v) == pytest.approx(float(g.error(v)), rel=1e-12)
