"""The port's marginals (inference/treemarg.py, nonlinear/marginals.py,
ISAM2.marginal_covariance / joint_marginal_covariance) and leaf
marginalization (IncrementalEngine / ISAM2.marginalize_leaves) against the
JAX package.

The same numpy graphs feed both packages; the port runs on the CPU in
float64. Covariances and exact estimates do not depend on the elimination
ordering, so they are held against the JAX package's default engine; what
depends on the Bayes tree (which cliques a marginalization deletes, the
messages it leaves, the fixed set, same-clique joints) is held against the
JAX engine's "jax" backend with its CCOLAMD ordering replaced by the
COLAMD proxy, and the port's AMD by the same proxy (as
tests/test_torch_isam2.py does).

Tolerances: covariances against JAX atol 1e-9, against the dense oracle
atol 1e-8 (tests/test_tree_marginals.py's); estimates after a
marginalization atol 1e-8 (the same solves in another order of summation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference.treemarg import TreeMarginals
from gtsam_petercdev_torch.inference import incremental as t_inc
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.marginals import Marginals as TMarginals
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils.synthetic import pose2_between_np as between
from gtsam_petercdev_torch.utils.synthetic import pose2_compose_np as compose
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.marginals import Marginals as JMarginals
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

PR_INFO = np.diag(1.0 / np.array([0.1, 0.1, 0.05]))
OD_INFO = np.diag(1.0 / np.array([0.2, 0.2, 0.1]))
EXACT = dict(enable_relinearization=False, wildfire_threshold=0.0)


def _loop_step(T=12, seed=1):
    """tests/test_tree_marginals.py's 12-pose loop graph as one update:
    ([(key, value)], [(kind, keys, measurement, sqrt_info)])."""
    rng = np.random.default_rng(seed)
    vals = [(t, rng.normal(size=3) * 0.3) for t in range(T)]
    facs = [("Prior", [0], np.zeros(3), PR_INFO)]
    facs += [("Between", [t - 1, t], np.array([1.0, 0.0, 0.1]), OD_INFO) for t in range(1, T)]
    facs += [("Between", [0, T - 1], np.array([0.0, 1.0, 0.0]), OD_INFO),
             ("Between", [3, 8], np.array([1.0, 1.0, 0.0]), OD_INFO)]
    return vals, facs


def _incremental_steps():
    """tests/test_tree_marginals.py's 10 updates with a loop closure at 7."""
    rng = np.random.default_rng(5)
    steps = []
    for t in range(10):
        facs = ([("Prior", [0], np.zeros(3), PR_INFO)] if t == 0 else
                [("Between", [t - 1, t], np.array([1.0, 0.0, 0.1]), OD_INFO)])
        if t == 7:
            facs.append(("Between", [2, 7], np.array([0.0, 1.0, 0.0]), OD_INFO))
        steps.append(([(t, rng.normal(size=3) * 0.3)], facs))
    return steps


def _stream(n, seed, loop_every, loop_back):
    """A Pose2 chain with loop closures i - loop_back -> i every loop_every
    poses, initial values the truth perturbed by N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    gt = [np.zeros(3)]
    for _ in range(1, n):
        gt.append(compose(gt[-1], np.array([1.0, 0.0, rng.normal() * 0.3])))
    steps = [([(0, gt[0])], [("Prior", [0], gt[0], PR_INFO)])]
    for i in range(1, n):
        facs = [("Between", [i - 1, i], between(gt[i - 1], gt[i]), OD_INFO)]
        if i >= loop_back and i % loop_every == 0:
            facs.append(("Between", [i - loop_back, i], between(gt[i - loop_back], gt[i]), OD_INFO))
        steps.append(([(i, compose(gt[i], rng.normal(size=3) * 0.1))], facs))
    return steps


def _jax_graph(steps):
    nv, nf = JValues(), JGraph()
    for vals, facs in steps:
        for key, v in vals:
            nv.insert(key, "Pose2", jnp.asarray(v))
        for kind, keys, meas, info in facs:
            nf.add(getattr(j_factors, kind.lower() + "_factor")("Pose2"), keys, jnp.asarray(meas),
                   info)
    return nf, nv


def _port_graph(steps):
    nv, nf = TValues(device="cpu"), TGraph(device="cpu")
    for vals, facs in steps:
        for key, v in vals:
            nv.insert(key, "Pose2", v)
        for kind, keys, meas, info in facs:
            nf.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, meas, info)
    return nf, nv


def _port_isam(**kw):
    return t_isam2.ISAM2(t_isam2.ISAM2Params(device="cpu", **kw))


def _proxy_jax_isam(monkeypatch, **kw):
    from gtsam_petercdev_tpu.native import build as j_native

    monkeypatch.setattr(j_native, "load_ccolamd", lambda *a, **k: None)
    monkeypatch.setattr(t_inc, "ccolamd_ordering", t_sym.colamd_ordering)
    monkeypatch.setattr(t_sym, "ccolamd_ordering", t_sym.colamd_ordering)
    return j_isam2.ISAM2(j_isam2.ISAM2Params(engine_backend="jax", **kw))


def _live_cliques(isam, key_of):
    """The live cliques as (frontal keys, separator keys) sets."""
    return {(frozenset(key_of[g] for g in c.frontal), frozenset(key_of[g] for g in c.separator))
            for c in isam.engine.cliques if c is not None and c.alive}


@pytest.mark.parametrize("case", ["loop_graph", "incremental"])
def test_tree_marginals_match_jax_and_dense(case):
    """Every pose's tree marginal: = JAX's (atol 1e-9) and = the port's
    dense Marginals of the same graph (atol 1e-8); TreeMarginals read
    directly gives the same blocks."""
    steps = [_loop_step()] if case == "loop_graph" else _incremental_steps()
    ji, ti = j_isam2.ISAM2(j_isam2.ISAM2Params(**EXACT)), _port_isam(**EXACT)
    for step in steps:
        ji.update(*_jax_graph([step]))
        ti.update(*_port_graph([step]))
    dense = TMarginals(*_port_graph(steps), device="cpu")
    tm = TreeMarginals(ti.engine)
    n = sum(len(v) for v, _ in steps)
    assert tm.n_steps > 1
    for k in range(n):
        cov = ti.marginal_covariance(k).numpy()
        np.testing.assert_allclose(cov, np.asarray(ji.marginal_covariance(k)), atol=1e-9)
        np.testing.assert_allclose(cov, dense.marginal_covariance(k).numpy(), atol=1e-8)
        np.testing.assert_array_equal(cov, tm.covariance_gid(ti._key_gid[k])[:3, :3].numpy())


def test_joint_same_clique_matches_jax_on_proxy(monkeypatch):
    """On the proxy the JAX engine builds the port's tree: the joint of the
    first two scope keys of every clique = JAX's (atol 1e-9) and = dense."""
    step = _loop_step()
    ji, ti = _proxy_jax_isam(monkeypatch, **EXACT), _port_isam(**EXACT)
    ji.update(*_jax_graph([step]))
    ti.update(*_port_graph([step]))
    assert _live_cliques(ti, ti._gid_key) == _live_cliques(ji, ji._gid_key)
    dense = TMarginals(*_port_graph([step]), device="cpu")
    found = 0
    for c in ti.engine.cliques:
        if c is None or len(c.frontal) + len(c.separator) < 2:
            continue
        keys = [ti._gid_key[g] for g in (c.frontal + c.separator)[:2]]
        J = ti.joint_marginal_covariance(keys).numpy()
        np.testing.assert_allclose(J, np.asarray(ji.joint_marginal_covariance(keys)), atol=1e-9)
        np.testing.assert_allclose(J, dense.joint_marginal_covariance(keys).numpy(), atol=1e-8)
        found += 1
    assert found >= 3
    with pytest.raises(ValueError, match="clique scope"):  # 0 and 6 share no clique
        ti.joint_marginal_covariance([0, 6])


def test_marginals_dense_and_tree_match_jax():
    """Marginals, dense and tree, with the batch and information forms,
    against the JAX package's (atol 1e-9; information rel 1e-9): every key
    through the batch form, four keys one by one (each JAX query compiles)."""
    step = _loop_step(seed=3)
    jd = JMarginals(*_jax_graph([step]))
    jt = JMarginals(*_jax_graph([step]), method="tree")
    td = TMarginals(*_port_graph([step]), device="cpu")
    tt = TMarginals(*_port_graph([step]), method="tree", device="cpu")
    keys = list(range(12))
    for a, b, c in zip(td.batch_marginal_covariances(keys), jd.batch_marginal_covariances(keys),
                       tt.batch_marginal_covariances(keys)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9)
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-8)
    for k in (0, 3, 8, 11):
        for t_m, j_m in ((td, jd), (tt, jt)):
            np.testing.assert_allclose(t_m.marginal_covariance(k).numpy(),
                                       np.asarray(j_m.marginal_covariance(k)), atol=1e-9)
        np.testing.assert_allclose(td.marginal_information(k).numpy(),
                                   np.asarray(jd.marginal_information(k)), rtol=1e-9, atol=1e-9)
    pair = [3, 8]
    np.testing.assert_allclose(td.joint_marginal_covariance(pair).numpy(),
                               np.asarray(jd.joint_marginal_covariance(pair)), atol=1e-9)
    np.testing.assert_allclose(td.joint_marginal_information(pair).numpy(),
                               np.asarray(jd.joint_marginal_information(pair)), rtol=1e-9, atol=1e-9)


def test_marginalize_leaves_matches_jax_on_proxy(monkeypatch):
    """engine.marginalize_leaves against the JAX engine on the proxy: the
    same live cliques afterwards (so the same dead ones), the same message
    scopes and fixed set, the same retired factors; estimates after three
    more updates atol 1e-8."""
    steps = _stream(20, seed=6, loop_every=5, loop_back=5)
    params = dict(relinearize_threshold=0.01, relinearize_skip=1, wildfire_threshold=0.0)
    ji, ti = _proxy_jax_isam(monkeypatch, **params), _port_isam(**params)
    for step in steps[:14]:
        ji.update(*_jax_graph([step]))
        ti.update(*_port_graph([step]))
    ji.marginalize_leaves([0, 1, 2, 3])
    ti.marginalize_leaves([0, 1, 2, 3])
    assert _live_cliques(ti, ti._gid_key) == _live_cliques(ji, ji._gid_key)
    scopes = lambda isam: sorted(tuple(sorted(isam._gid_key[g] for g in m.scope))
                                 for m in isam.engine.msgs if m.alive)
    assert scopes(ti) == scopes(ji) and scopes(ti)
    assert {ti._gid_key[g] for g in ti._fixed_gids} == {ji._gid_key[g] for g in ji._fixed_gids}
    retired = lambda isam: sorted(tuple(int(k) for k in grp.keys[r])
                                  for grp in isam._groups if grp is not None
                                  for r in np.nonzero(grp.retired[: grp.n])[0])
    assert retired(ti) == retired(ji)
    for step in steps[14:17]:
        ji.update(*_jax_graph([step]))
        ti.update(*_port_graph([step]))
    et, ej = ti.calculate_estimate(), ji.calculate_estimate()
    assert sorted(et.keys()) == sorted(ej.keys()) == list(range(4, 17))
    for k in range(4, 17):
        np.testing.assert_allclose(et.at(k).numpy(), np.asarray(ej.at(k)), atol=1e-8)
    assert ti.error() == pytest.approx(ji.error(), rel=1e-9)


def test_marginalized_key_is_refused_and_cache_dropped():
    """A factor on a marginalized key raises ValueError; the covariance
    cache is dropped by marginalize_leaves (same update count, new tree)."""
    steps = _stream(12, seed=7, loop_every=5, loop_back=5)
    ti = _port_isam(**EXACT)
    for step in steps:
        ti.update(*_port_graph([step]))
    before = ti._tree_marginals()
    assert ti._tree_marginals() is before  # cached within one update
    ti.marginalize_leaves([0, 1])
    assert ti._tm_cache is None and ti._tree_marginals() is not before
    assert ti.marginal_covariance(5).shape == (3, 3)
    nf = TGraph(device="cpu")
    nf.add(t_factors.between_factor("Pose2"), [1, 11], np.array([1.0, 0.0, 0.0]), OD_INFO)
    with pytest.raises(ValueError, match="marginalized key"):
        ti.update(nf, None)
    assert 0 not in ti.calculate_estimate() and 0 not in ti.theta


def test_cache_dropped_when_marginalize_leaves_raises(monkeypatch):
    """The engine re-eliminates before it refuses a mixed clique (the
    fixed-lag smoother's retry relies on the RuntimeError): the covariance
    cache is dropped all the same, and the next covariance is the new
    tree's."""
    steps = _stream(12, seed=7, loop_every=5, loop_back=5)
    ti = _port_isam(**EXACT)
    for step in steps:
        ti.update(*_port_graph([step]))
    ti.marginal_covariance(5)
    eng = ti.engine

    def reeliminate_then_refuse(gids, keep_messages=True):
        eng.update(marked=set(gids), relin=set(gids), first=list(gids))
        raise RuntimeError("marginalize_leaves: clique mixes live vars")

    monkeypatch.setattr(eng, "marginalize_leaves", reeliminate_then_refuse)
    with pytest.raises(RuntimeError):
        ti.marginalize_leaves([3])
    assert ti._tm_cache is None
    tm = TreeMarginals(eng)
    for k in (2, 5, 11):
        np.testing.assert_array_equal(ti.marginal_covariance(k).numpy(),
                                      tm.covariance_gid(ti._key_gid[k]).numpy())


def test_float32_isam2_matches_jax_float32():
    """ISAM2 in float32 (ISAM2Params(dtype=torch.float32)) over a 24-pose
    stream with loop closures, at City10000's parameters: estimates = the
    JAX package's float32 ISAM2 within 1e-4 (float32 rounding, summed in
    two orders), no clamped pivot."""
    steps = _stream(24, seed=9, loop_every=6, loop_back=6)
    params = dict(relinearize_threshold=0.01, relinearize_skip=1, wildfire_threshold=0.0)
    ji = j_isam2.ISAM2(j_isam2.ISAM2Params(**params))
    ti = _port_isam(dtype=torch.float32, **params)
    for vals, facs in steps:
        nv, nf = JValues(), JGraph()
        tv, tf = TValues(device="cpu", dtype=torch.float32), TGraph(device="cpu", dtype=torch.float32)
        for key, v in vals:
            nv.insert(key, "Pose2", jnp.asarray(v, dtype=jnp.float32))
            tv.insert(key, "Pose2", v)
        for kind, keys, meas, info in facs:
            nf.add(getattr(j_factors, kind.lower() + "_factor")("Pose2"), keys,
                   jnp.asarray(meas, dtype=jnp.float32), info.astype(np.float32))
            tf.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, meas, info)
        ji.update(nf, nv)
        assert int(ti.update(tf, tv).bad_pivots) == 0
    et, ej = ti.calculate_estimate(), ji.calculate_estimate()
    assert et.params("Pose2").dtype == torch.float32
    for k in range(24):
        np.testing.assert_allclose(et.at(k).numpy(), np.asarray(ej.at(k)), atol=1e-4)
