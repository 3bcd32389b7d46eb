"""The port's concurrent filtering and smoothing (nonlinear/concurrent.py)
against the JAX package, on tests/test_concurrent.py's 16-step stream (a
Pose2 chain with unary xy measurements, lag 4, a synchronization every 4
steps), made from a seed with numpy; the port runs on the CPU in float64.

Against the JAX package each pair runs as few steps as reach a
synchronize that moves keys (the JAX side's LM compiles anew for every
window, ~5 s a step on the CPU): the batch pair the first 4 steps at lag 2
(the synchronize at step 3 moves key 0), the incremental pair the first 8
at lag 4 (a synchronize with no key out of lag, then one that moves keys
0-2). The batch pair builds no Bayes tree; the incremental pair's iSAM2
halves back-substitute partially (wildfire 0.001) and marginalize, both of
which depend on the tree, so both sides run on the COLAMD proxy there
(the JAX side its "jax" engine; as tests/test_torch_isam2.py). The incremental
pair is held against the batch pair over all 16 steps at lag 4.

Tolerances: estimates against JAX 1e-8 (tangent norm); the incremental
pair against the batch pair 5e-3, as tests/test_concurrent.py:126.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.inference import incremental as t_inc
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.nonlinear import concurrent as t_cc
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType as TFactorType
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils.synthetic import pose2_compose_np as compose
from gtsam_petercdev_tpu.nonlinear import concurrent as j_cc
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2
from gtsam_petercdev_tpu.nonlinear.factor_graph import FactorType as JFactorType
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

T, LAG = 16, 4.0
ODO = np.array([1.0, 0.0, 0.05])
UN_INFO, ODO_INFO, PR_INFO = np.eye(2) / 0.05, np.eye(3) / 0.02, np.eye(3) / 0.01
J_UN = JFactorType("UnaryXY", ("Pose2",), 2, lambda xs, params: xs[0][:2] - params)
T_UN = TFactorType("UnaryXY", ("Pose2",), 2, lambda xs, params: xs[0][..., :2] - params)


def _stream():
    rng = np.random.default_rng(2)
    gt = [np.zeros(3)]
    for _ in range(T - 1):
        gt.append(compose(gt[-1], ODO))
    return gt, [p[:2] + rng.normal(size=2) * 0.05 for p in gt]


def _pair_xyt(xs, params):
    return torch.cat([xs[0] - params[..., :3], xs[1] - params[..., 3:]], -1)


# a weak factor on two poses with 6 whitened rows: wider than the engine's
# 3-row block, so ISAM2 takes it as two row blocks (the JAX engine refuses it)
T_WIDE = TFactorType("PairXYT", ("Pose2", "Pose2"), 6, _pair_xyt)
WIDE_INFO = np.eye(6) / 0.5


def _run_pair(jax_side: bool, incremental: bool, n_steps: int = T, lag: float = LAG,
              wide: bool = False, on_sync=None):
    """tests/test_concurrent.py's run_pair in either package, over the
    stream's first n_steps steps; `wide` (port only) adds a T_WIDE factor
    on (t - 1, t) ahead of each step's others, and on_sync(filter) runs
    after each synchronize."""
    cc, factors = (j_cc, j_factors) if jax_side else (t_cc, t_factors)
    dev = {} if jax_side else {"device": "cpu"}
    if incremental:
        ip = dict(relinearize_threshold=1e-4, relinearize_skip=1)
        P = (lambda: j_isam2.ISAM2Params(engine_backend="jax", **ip)) if jax_side else (
            lambda: t_isam2.ISAM2Params(**ip))
        filt = cc.ConcurrentIncrementalFilter(lag, P(), **dev)
        smoother = cc.ConcurrentIncrementalSmoother(P(), **dev)
        sync = cc.synchronize_incremental
    else:
        filt, smoother, sync = cc.ConcurrentBatchFilter(lag, **dev), cc.ConcurrentBatchSmoother(
            **dev), cc.synchronize
    gt, meas = _stream()
    conv = jnp.asarray if jax_side else np.asarray
    est = None
    for t in range(n_steps):
        nf = JGraph() if jax_side else TGraph(device="cpu")
        nv = JValues() if jax_side else TValues(device="cpu")
        init = gt[t] if t == 0 else compose(np.asarray(est.at(t - 1)), ODO)
        nv.insert(t, "Pose2", conv(init))
        if wide and t > 0:
            nf.add(T_WIDE, [t - 1, t], np.concatenate([gt[t - 1], gt[t]]), WIDE_INFO)
        nf.add(J_UN if jax_side else T_UN, [t], conv(meas[t]), UN_INFO)
        if t == 0:
            nf.add(factors.prior_factor("Pose2"), [0], conv(gt[0]), PR_INFO)
        else:
            nf.add(factors.between_factor("Pose2"), [t - 1, t], conv(ODO), ODO_INFO)
        filt.update(nf, nv, {t: float(t)})
        est = filt.values
        if t % 4 == 3:
            sync(filt, smoother)
            if on_sync is not None:
                on_sync(filt)
    return filt, smoother


def _gap(a, b):
    return float(torch.linalg.norm(t_pose2.local(torch.as_tensor(np.asarray(a)),
                                                 torch.as_tensor(np.asarray(b)))))


@pytest.fixture(scope="module")
def port_pairs():
    return {inc: _run_pair(False, inc) for inc in (False, True)}


@pytest.mark.parametrize("incremental", [False, True], ids=["batch", "incremental"])
def test_pair_matches_jax(incremental, monkeypatch):
    """The filter's window, the smoother's history and the separator: the
    same keys as the JAX package's pair, estimates within 1e-8."""
    if incremental:
        from gtsam_petercdev_tpu.native import build as j_native

        monkeypatch.setattr(j_native, "load_ccolamd", lambda *a, **k: None)
        monkeypatch.setattr(t_inc, "ccolamd_ordering", t_sym.colamd_ordering)
        monkeypatch.setattr(t_sym, "ccolamd_ordering", t_sym.colamd_ordering)
    steps, lag = (8, LAG) if incremental else (4, 2.0)
    fj, sj = _run_pair(True, incremental, steps, lag)
    ft, st = _run_pair(False, incremental, steps, lag)
    assert st.separator == [int(k) for k in sj.separator] and st.separator
    for (a, b) in ((ft.values, fj.values), (st.values, sj.values)):
        assert sorted(a.keys()) == sorted(int(k) for k in b.keys())
        for k in a.keys():
            assert _gap(a.at(k), b.at(k)) < 1e-8, k
    assert len(ft.values) <= int(lag) + 3


def test_incremental_pair_matches_batch_pair(port_pairs):
    """tests/test_concurrent.py:126 on the port: the incremental pair's
    filter window (separator aside), separator and history against the
    batch pair's, 5e-3; most of the history lives in the smoother."""
    fb, sb = port_pairs[False]
    fi, si = port_pairs[True]
    sep = set(si.separator)
    for k in fi.values.keys():
        if k in fb.values and k not in sep:
            assert _gap(fi.values.at(k), fb.values.at(k)) < 5e-3, ("filter", k)
    n_hist = 0
    for k in si.values.keys():
        if k in sb.values:
            assert _gap(si.values.at(k), sb.values.at(k)) < 5e-3, ("smoother", k)
            n_hist += k not in sep
    assert n_hist >= 8 and len(fi.values) <= int(LAG) + 3


def test_incremental_filter_takes_a_wide_factor():
    """A factor wider than the block dimension is two engine units. After
    every synchronize the filter's tree holds exactly the units of the
    factors it kept and of the smoother's prior, each row's every block;
    and the incremental pair, fed the wide factors ahead of each step's
    others for 8 steps, stays within 5e-3 of the batch pair fed the
    same."""
    def live_units_match(filt):
        live = {(g, r) for g, grp in enumerate(filt.isam._groups) if grp is not None
                for r in range(grp.n) if not grp.retired[r]}
        held = [u for rows in filt._batch_units for units in rows for u in units]
        held += filt._prior_units
        assert len(held) == len(set(held)) and set(held) == live
        assert [len(rows) for rows in filt._batch_units] == [b.size for b in filt.graph.batches]
        for b, rows in zip(filt.graph.batches, filt._batch_units):
            assert all(len(units) == filt.isam.row_blocks(b.ftype) for units in rows)

    n_syncs = []  # 8 steps: a synchronize that moves no key, then one that moves keys 0-2
    fb, sb = _run_pair(False, False, 8, wide=True)
    fi, si = _run_pair(False, True, 8, wide=True,
                       on_sync=lambda f: (live_units_match(f), n_syncs.append(1)))
    assert len(n_syncs) == 2 and 0 not in fi.values and 0 in si.values
    assert any(b.ftype is T_WIDE for b in fi.graph.batches)
    for (a, b) in ((fi.values, fb.values), (si.values, sb.values)):
        for k in a.keys():
            if k in b:
                assert _gap(a.at(k), b.at(k)) < 5e-3, k
