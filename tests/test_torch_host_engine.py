"""The port's host engine (IncrementalEngine(backend="numpy"),
inference/kernels_np.py, csrc/host/solve_native.cpp built by g++) against
the JAX package's "numpy" backend and against the port's own card engine.

Both packages' numpy backends run the same native sweeps (the port's is its
own build of the copied source), so with both sides on the COLAMD proxy
the trees, the re-elimination counts and the wildfire counts are equal
update by update, and the estimates agree to rel 1e-9 (the assembly order
of the factor sums is the same; the JAX side pads nothing either). The
port's host and card engines plan the same trees (one bucket a level,
exact counts), so their n_reeliminated agree on the port's own ordering;
their wildfire counters count different things (cliques solved by the
native sweep, rounds of the card's descent) and are not compared.
"""

import numpy as np
import pytest
import torch
from test_torch_ordering import jax_city_updates

from gtsam_petercdev_torch.inference import incremental as t_inc
from gtsam_petercdev_torch.inference import kernels_np as t_knp
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.models import city10000 as t_city
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.utils import synthetic
from gtsam_petercdev_tpu.inference import kernels_np as j_knp
from gtsam_petercdev_tpu.models import city10000 as j_city


def _bucket(B, nf, ns, d, seed, dtype, indefinite=False):
    rng = np.random.default_rng(seed)
    m = (nf + ns) * d
    A = rng.normal(size=(B, m + 3, m))
    F = np.einsum("bri,brj->bij", A, A) + 0.1 * np.eye(m)
    if indefinite:
        F[0, 1, 1] = -1.0
    return F.astype(dtype), rng.normal(size=(B, m)).astype(dtype)


@pytest.mark.parametrize("dtype,B,nf,ns,d", [
    (np.float64, 5, 2, 3, 3), (np.float64, 1, 4, 0, 3), (np.float64, 3, 3, 2, 6),
    (np.float32, 5, 2, 3, 3), (np.float32, 2, 1, 4, 3)])
def test_kernels_np_match_jax(dtype, B, nf, ns, d):
    """partial_cholesky and backsolve_bucket against the JAX twins: float64
    through both native cores (rel 1e-12), float32 through the port's plain
    PyTorch version and the JAX numpy loop (the same block steps, rounded
    apart: rel 1e-4 of each array's largest entry); back-substitution
    through the plain PyTorch version (rel 1e-12 in float64)."""
    tol = 1e-12 if dtype == np.float64 else 1e-4
    for indefinite in (False, True):
        F, g = _bucket(B, nf, ns, d, 7, dtype, indefinite)
        ot, oj = t_knp.partial_cholesky(F, g, nf, d), j_knp.partial_cholesky(F, g, nf, d)
        assert ot["bad"] == oj["bad"] and (ot["bad"] > 0) == indefinite
        for k in ("L", "Linv", "W", "y", "U", "ug"):
            assert ot[k].dtype == dtype, k
            np.testing.assert_allclose(ot[k], oj[k], rtol=tol,
                                       atol=tol * np.abs(np.nan_to_num(oj[k])).max(initial=1.0),
                                       err_msg=k)
    rhs = np.random.default_rng(1).normal(size=(B, nf * d)).astype(dtype)
    xj = j_knp.backsolve_bucket(ot["L"], ot["Linv"], rhs, nf, d)
    xt = t_knp.backsolve_bucket(ot["L"], ot["Linv"], rhs, nf, d)
    assert xt.dtype == dtype
    np.testing.assert_allclose(xt, xj, rtol=tol, atol=tol * np.abs(np.nan_to_num(xj)).max())


def _city_file(tmp_path, n_lines=150):
    lines, gt = synthetic.city_stream(200, seed=0)
    path = tmp_path / "city.txt"
    path.write_text("\n".join(lines[:n_lines]) + "\n")
    return str(path), gt


def _pin_port_to_proxy(monkeypatch):
    monkeypatch.setattr(t_inc, "ccolamd_ordering", t_sym.colamd_ordering)
    monkeypatch.setattr(t_sym, "ccolamd_ordering", t_sym.colamd_ordering)


@pytest.mark.parametrize("wildfire", [0.0, 1e-12])
def test_host_engine_matches_jax_numpy_backend(wildfire, tmp_path, monkeypatch):
    """150 City lines, both sides on the COLAMD proxy: the same trees
    (n_reeliminated, orphans, cliques) in every update, estimates rel 1e-9.
    The wildfire counts (cliques the native sweep solved) are equal in every
    update at threshold 1e-12; at 0.0 the two descents part in 25 of the 150
    updates, each where a clique's change is 0 on one side and a few ulps on
    the other (the factors' linearizations round differently), as the card
    and the CPU part (ROADMAP C1)."""
    from gtsam_petercdev_tpu.native import build as j_native

    monkeypatch.setattr(j_native, "load_ccolamd", lambda *a, **k: None)
    _pin_port_to_proxy(monkeypatch)
    path, _ = _city_file(tmp_path)
    uj = jax_city_updates(monkeypatch)
    # the JAX "auto" backend on a CPU host is its numpy backend
    rj = j_city.run_city10000(path, wildfire_threshold=wildfire)
    rt = t_city.run_city10000(path, device="cpu", engine_backend="numpy", wildfire_threshold=wildfire)
    assert rt.updates[0].n_reeliminated > 0
    for a, b in zip(rt.updates, uj[1:], strict=True):
        assert (a.n_reeliminated, a.n_orphans, a.n_cliques) == \
            (b.n_reeliminated, b.n_orphans, b.n_cliques)
        if wildfire > 0:
            assert a.wildfire_rounds == b.wildfire_rounds
        assert int(a.bad_pivots) == int(b.bad_pivots) == 0
    ej = np.asarray(rj.estimate)
    np.testing.assert_allclose(rt.estimate, ej, rtol=1e-9, atol=1e-9 * np.abs(ej).max())


def test_host_engine_matches_card_engine_on_amd(tmp_path):
    """The port's host and card engines (the card engine on the CPU) over
    150 City lines on the port's AMD: the same n_reeliminated in every
    update, estimates rel 1e-9."""
    path, gt = _city_file(tmp_path)
    rh = t_city.run_city10000(path, device="cpu", engine_backend="numpy")
    rc = t_city.run_city10000(path, device="cpu")
    assert [u.n_reeliminated for u in rh.updates] == [u.n_reeliminated for u in rc.updates]
    np.testing.assert_allclose(rh.estimate, rc.estimate, rtol=1e-9,
                               atol=1e-9 * np.abs(rc.estimate).max())
    assert abs(rh.ate_rmse(gt) - rc.ate_rmse(gt)) < 1e-9


def test_host_engine_runs_float64_only(tmp_path):
    """The host engine's native sweeps are float64 code: float32 raises
    ValueError at the engine, at ISAM2Params and at the harness, before any
    update; the float64 run on the same lines goes through."""
    path, _ = _city_file(tmp_path, 80)
    with pytest.raises(ValueError, match="float64"):
        t_inc.IncrementalEngine(3, dtype=torch.float32, device="cpu", backend="numpy")
    with pytest.raises(ValueError, match="float64"):
        t_isam2.ISAM2(t_isam2.ISAM2Params(device="cpu", dtype=torch.float32,
                                          engine_backend="numpy"))
    with pytest.raises(ValueError, match="float64"):
        t_city.run_city10000(path, device="cpu", engine_backend="numpy", dtype=torch.float32)
    r64 = t_city.run_city10000(path, device="cpu", engine_backend="numpy")
    assert all(int(u.bad_pivots) == 0 for u in r64.updates)


def test_fixed_lag_marginalize_leaves_on_the_host_engine(tmp_path):
    """run_city10000_fixed_lag (lag 50) on the host engine: the same keys
    marginalized at every update and the same live cliques as the card
    engine on the CPU, the window's estimates rel 1e-9."""
    path, _ = _city_file(tmp_path)
    fh = t_city.run_city10000_fixed_lag(path, lag=50, device="cpu", engine_backend="numpy")
    fc = t_city.run_city10000_fixed_lag(path, lag=50, device="cpu")
    assert sum(map(len, fh.marginalized)) > 0
    assert fh.marginalized == fc.marginalized and fh.keys == fc.keys
    assert fh.live_cliques == fc.live_cliques
    np.testing.assert_allclose(fh.estimate, fc.estimate, rtol=1e-9,
                               atol=1e-9 * np.abs(fc.estimate).max())


def test_host_engine_tree_marginals_match_card_engine(tmp_path):
    path, _ = _city_file(tmp_path, 60)
    held = {}
    for be, dev in (("numpy", "cpu"), ("torch", "cpu")):
        t_city.run_city10000(path, device=dev, engine_backend=be,
                             step_cb=lambda k, isam, be=be: held.__setitem__(be, isam))
    for key in (0, 10, 30):
        np.testing.assert_allclose(held["numpy"].marginal_covariance(key),
                                   held["torch"].marginal_covariance(key), rtol=1e-9, atol=1e-14)


def test_delta_handed_to_torch_does_not_alias_the_host_delta(tmp_path):
    """The native sweep writes the host delta through raw pointers; a tensor
    of torch.from_numpy(x) would change under its holder. x_snapshot and
    every delta read are copies: mutating the engine after the hand-off
    leaves them unchanged."""
    path, _ = _city_file(tmp_path, 40)
    held = {}
    t_city.run_city10000(path, device="cpu", engine_backend="numpy",
                         step_cb=lambda k, isam: held.__setitem__("isam", isam))
    isam = held["isam"]
    eng = isam.engine
    snap, rows = eng.x_snapshot(), isam.delta()["Pose2"]
    one = isam.calculate_estimate_key(5)
    alias = torch.from_numpy(eng.x)  # the hazard the copies close
    before = (snap.clone(), rows.clone(), one.clone())
    assert float(eng.x[: eng.n].__abs__().max()) > 0
    eng.zero_delta_rows(list(range(eng.n)))
    eng.x[eng.n - 1] = 7.0
    assert float(alias[: eng.n].abs().max()) == 7.0
    for a, b in zip((snap, rows, one), before):
        assert torch.equal(a, b)


def test_host_backend_needs_the_cpu(tmp_path):
    """backend="numpy" on a CUDA device raises ValueError (with or without a
    card): at the engine, at ISAM2Params (its default device is "cuda") and
    at both City harnesses; nothing moves a caller's run to the CPU. So
    does an unknown backend, "auto" among them. On device="cpu" the wrapper
    and the engine run on the CPU."""
    path, _ = _city_file(tmp_path, 20)
    with pytest.raises(ValueError, match="cpu"):
        t_inc.IncrementalEngine(3, device="cuda", backend="numpy")
    with pytest.raises(ValueError, match="backend"):
        t_inc.IncrementalEngine(3, device="cpu", backend="jax")
    for kw in (dict(device="cuda"), {}):
        with pytest.raises(ValueError, match="device='cpu'"):
            t_isam2.ISAM2(t_isam2.ISAM2Params(engine_backend="numpy", **kw))
    with pytest.raises(ValueError, match="device='cpu'"):
        t_city.run_city10000(path, device="cuda", engine_backend="numpy")
    with pytest.raises(ValueError, match="device='cpu'"):
        t_city.run_city10000_fixed_lag(path, lag=10, device="cuda", engine_backend="numpy")
    for be in ("jax", "auto"):
        with pytest.raises(ValueError, match="engine_backend"):
            t_isam2.ISAM2(t_isam2.ISAM2Params(device="cpu", engine_backend=be))
    isam = t_isam2.ISAM2(t_isam2.ISAM2Params(device="cpu", engine_backend="numpy"))
    assert isam.device.type == "cpu"
    eng = t_inc.IncrementalEngine(3, device="cpu", backend="numpy")
    assert isinstance(eng.x, np.ndarray) and eng._nat is not None
