"""The port's incremental smoother (inference/incremental.py, nonlinear/isam2.py,
models/city10000.py) against the JAX package.

The same numpy streams (made from a seed) feed both packages; the port runs
on the CPU in float64, where its bucket kernels take their plain versions.
The JAX side runs as tests/test_isam2.py runs it: its "numpy" engine by
default on the CPU, its "jax" engine where the Bayes trees are compared.

Tolerances: the delta of an exact (wildfire 0, no relinearization) update
atol 1e-9, as tests/test_isam2.py:102-146 holds it against a dense solve;
estimates under relinearization atol 1e-8 (the same solves in another
order of summation); the incremental-vs-batch check atol 1e-4, as
tests/test_isam2.py:27-73.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference import incremental as t_inc
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.models import city10000 as t_city
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.optimizers import OptimizerParams, gauss_newton
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.ops import cholesky as t_chol
from gtsam_petercdev_torch.ops import cholesky_v2 as t_chol_v2
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import synthetic
from gtsam_petercdev_torch.utils.synthetic import pose2_between_np as between
from gtsam_petercdev_torch.utils.synthetic import pose2_compose_np as compose
from gtsam_petercdev_tpu.models import city10000 as j_city
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors

PRIOR_INFO = np.eye(3) / 0.05
ODO_INFO = np.eye(3) / 0.1


def _stream(n, seed, loop_every, loop_back, first_loop):
    """Per update: ([(key, initial Pose2)], [(factor, keys, measurement,
    sqrt_info)]). A chain with steps (1, 0, N(0, 0.3^2)), exact odometry,
    loop closures i - loop_back -> i every loop_every poses from first_loop,
    initial values the truth perturbed by N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    gt = [np.zeros(3)]
    for _ in range(1, n):
        gt.append(compose(gt[-1], np.array([1.0, 0.0, rng.normal() * 0.3])))
    steps = [([(0, gt[0])], [("Prior", [0], gt[0], PRIOR_INFO)])]
    for i in range(1, n):
        facs = [("Between", [i - 1, i], between(gt[i - 1], gt[i]), ODO_INFO)]
        if i >= first_loop and i % loop_every == 0:
            back = i - loop_back
            facs.append(("Between", [back, i], between(gt[back], gt[i]), ODO_INFO))
        steps.append(([(i, compose(gt[i], rng.normal(size=3) * 0.1))], facs))
    return steps


def _feed_jax(isam, step):
    nv, nf = JValues(), JGraph()
    for key, v in step[0]:
        nv.insert(key, "Pose2", jnp.asarray(v))
    for kind, keys, meas, info in step[1]:
        nf.add(getattr(j_factors, kind.lower() + "_factor")("Pose2"), keys, jnp.asarray(meas), info)
    return isam.update(nf, nv)


def _feed_port(isam, step):
    nv, nf = TValues(device="cpu"), TGraph(device="cpu")
    for key, v in step[0]:
        nv.insert(key, "Pose2", v)
    for kind, keys, meas, info in step[1]:
        nf.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, meas, info)
    return isam.update(nf, nv)


def _port_isam(**kw):
    return t_isam2.ISAM2(t_isam2.ISAM2Params(device="cpu", **kw))


def _estimate(values, n):
    return np.stack([np.asarray(values.at(i)) for i in range(n)])


def _dense_delta(steps_so_far):
    """The port's dense oracle: the whole graph so far, linearized at the
    initial values, solved by dense Cholesky."""
    nv, nf = TValues(device="cpu"), TGraph(device="cpu")
    for vals, facs in steps_so_far:
        for key, v in vals:
            nv.insert(key, "Pose2", v)
        for kind, keys, meas, info in facs:
            nf.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, meas, info)
    H, g = t_solve.assemble_dense(nf.linearize(nv))
    return t_solve.dense_solve(H, g, 0.0).reshape(-1, 3).numpy()


def test_delta_exact_matches_jax_and_dense():
    """(1) Relinearization off, wildfire 0: after every 6th update the
    port's delta equals the JAX ISAM2's and a dense solve (atol 1e-9)."""
    steps = _stream(30, seed=1, loop_every=5, loop_back=10, first_loop=10)
    params = dict(enable_relinearization=False, wildfire_threshold=0.0)
    ji, ti = j_isam2.ISAM2(j_isam2.ISAM2Params(**params)), _port_isam(**params)
    for i, step in enumerate(steps):
        _feed_jax(ji, step)
        _feed_port(ti, step)
        if i % 6 == 0 or i == len(steps) - 1:
            xt = ti.delta()["Pose2"].numpy()
            np.testing.assert_allclose(xt, np.asarray(ji.delta()["Pose2"]), atol=1e-9)
            np.testing.assert_allclose(xt, _dense_delta(steps[: i + 1]), atol=1e-9)


def test_relinearized_estimates_match_jax():
    """(2) Relinearization on (threshold 0.01, skip 1), loop closures every
    7 poses: estimates agree after every 10th update and at the end. The
    JAX engine orders with real CCOLAMD, so its Bayes tree differs from the
    port's; wildfire 0 (the City10000 setting) makes both back-substitutions
    exact, where the default 0.001 would stop each at different cliques."""
    steps = _stream(40, seed=2, loop_every=7, loop_back=7, first_loop=7)
    params = dict(relinearize_threshold=0.01, relinearize_skip=1, wildfire_threshold=0.0)
    ji, ti = j_isam2.ISAM2(j_isam2.ISAM2Params(**params)), _port_isam(**params)
    n_relin = 0
    for i, step in enumerate(steps):
        rj, rt = _feed_jax(ji, step), _feed_port(ti, step)
        assert rt.n_relinearized == rj.n_relinearized
        n_relin += rt.n_relinearized
        if i % 10 == 0 or i == len(steps) - 1:
            np.testing.assert_allclose(_estimate(ti.calculate_estimate(), i + 1),
                                       _estimate(ji.calculate_estimate(), i + 1), atol=1e-8)
    assert n_relin > 0


def test_bayes_tree_counters_match_jax_engine(monkeypatch):
    """(3) The JAX engine's "jax" backend and the port, both on the COLAMD
    proxy (the JAX package's CCOLAMD and the port's AMD order differently),
    build the same Bayes tree, update by update."""
    from gtsam_petercdev_tpu.native import build as j_native

    monkeypatch.setattr(j_native, "load_ccolamd", lambda *a, **k: None)
    monkeypatch.setattr(t_inc, "ccolamd_ordering", t_sym.colamd_ordering)
    monkeypatch.setattr(t_sym, "ccolamd_ordering", t_sym.colamd_ordering)
    steps = _stream(24, seed=3, loop_every=7, loop_back=7, first_loop=7)
    params = dict(relinearize_threshold=0.01, relinearize_skip=1)
    ji = j_isam2.ISAM2(j_isam2.ISAM2Params(engine_backend="jax", **params))
    ti = _port_isam(**params)
    keys = ("n_affected_cliques", "n_orphans", "n_reeliminated", "n_cliques")
    for step in steps:
        rj, rt = _feed_jax(ji, step), _feed_port(ti, step)
        assert [getattr(rt, k) for k in keys] == [getattr(rj, k) for k in keys]
        assert int(rt.bad_pivots) == int(rj.bad_pivots) == 0
    np.testing.assert_allclose(_estimate(ti.calculate_estimate(), len(steps)),
                               _estimate(ji.calculate_estimate(), len(steps)), atol=1e-8)


def test_run_city10000_matches_jax(tmp_path):
    """(4) Both harnesses over the same 120-line city_stream file."""
    lines, gt = synthetic.city_stream(120, seed=0)
    path = tmp_path / "city_stream.txt"
    path.write_text("\n".join(lines[:120]) + "\n")
    rj = j_city.run_city10000(str(path))
    rt = t_city.run_city10000(str(path), device="cpu")
    assert (rt.n_poses, rt.n_loop_closures) == (rj.n_poses, rj.n_loop_closures)
    assert rt.n_loop_closures > 0 and len(rt.updates) == 120
    np.testing.assert_allclose(rt.estimate, np.asarray(rj.estimate), atol=1e-8)
    assert abs(rt.ate_rmse(gt) - rj.ate_rmse(gt)) < 1e-8


def test_remove_factors_matches_jax():
    """(5) Removing a loop closure, then an empty update."""
    steps = _stream(20, seed=4, loop_every=5, loop_back=5, first_loop=5)
    params = dict(enable_relinearization=False, wildfire_threshold=0.0)
    ji, ti = j_isam2.ISAM2(j_isam2.ISAM2Params(**params)), _port_isam(**params)
    units = {}
    for i, step in enumerate(steps):
        rj, rt = _feed_jax(ji, step), _feed_port(ti, step)
        units[i] = (rj.new_factor_units, rt.new_factor_units)
    uj, ut = units[10]
    assert ut == uj and len(ut) == 2  # odometry and the loop closure
    ji.remove_factors(uj[1:])
    ti.remove_factors(ut[1:])
    _feed_jax(ji, ([], []))
    _feed_port(ti, ([], []))
    xt = ti.delta()["Pose2"].numpy()
    np.testing.assert_allclose(xt, np.asarray(ji.delta()["Pose2"]), atol=1e-9)
    kept = [(v, [f for j, f in enumerate(facs) if not (i == 10 and j == 1)])
            for i, (v, facs) in enumerate(steps)]
    np.testing.assert_allclose(xt, _dense_delta(kept), atol=1e-9)
    assert ti.error() == pytest.approx(ji.error(), rel=1e-9)


def test_incremental_matches_batch():
    """(6) As tests/test_isam2.py:27-73 on the port alone: each new pose
    starts from the previous estimate composed with its noisy odometry;
    after 5 empty updates the estimate is the port's batch GN optimum of
    the same graph from the same initial values."""
    n = 25
    rng = np.random.default_rng(42)
    steps = _stream(n, seed=5, loop_every=7, loop_back=7, first_loop=7)
    ti = _port_isam(relinearize_threshold=0.01, relinearize_skip=1)
    nv, nf = TValues(device="cpu"), TGraph(device="cpu")
    for i, (vals, facs) in enumerate(steps):
        if i:
            prev = ti.calculate_estimate().at(i - 1).numpy()
            vals = [(i, compose(prev, compose(facs[0][2], rng.normal(size=3) * 0.05)))]
        _feed_port(ti, (vals, facs))
        for key, v in vals:
            nv.insert(key, "Pose2", v)
        for kind, keys, meas, info in facs:
            nf.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, meas, info)
    for _ in range(5):
        ti.update()
    batch = gauss_newton(nf, nv, OptimizerParams(max_iterations=50), device="cpu")
    a, b = _estimate(ti.calculate_estimate(), n), _estimate(batch.values, n)
    np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=0, atol=1e-4)
    dth = np.arctan2(np.sin(a[:, 2] - b[:, 2]), np.cos(a[:, 2] - b[:, 2]))
    assert np.abs(dth).max() < 1e-4


def test_entry_points_raise_without_cuda():
    """(7) device= defaults to "cuda": without a card ISAM2, the engine and
    the harness raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_isam2.ISAM2()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_isam2.ISAM2(t_isam2.ISAM2Params(relinearize_skip=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_inc.IncrementalEngine(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_city.run_city10000("unused.txt")
    assert t_inc.IncrementalEngine(3, device="cpu").x.device.type == "cpu"


@pytest.mark.parametrize("nf,ns,d,itemsize", [
    (1, 2, 3, 8), (32, 64, 3, 8), (32, 128, 3, 8), (64, 64, 3, 8),
    (32, 128, 3, 4), (32, 256, 3, 4), (4, 8, 6, 8), (16, 128, 6, 8)])
def test_level_router_picks_by_shared_memory(nf, ns, d, itemsize, monkeypatch):
    """(8) A level bucket goes to K4 when its clique fits shared memory,
    else to K1, on both sides of `fits_smem`; `_level` calls that kernel."""
    route = t_inc.level_route(nf, ns, d, itemsize)
    assert route == ("blocks" if t_chol.fits_smem(nf, ns, d, itemsize) else "global")
    calls = []
    for mod, name in ((t_chol, "partial_cholesky_blocks"), (t_chol_v2, "partial_cholesky")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    if itemsize == 8:  # run the level on a float64 pool of one clique
        B, mb = 1, nf + ns
        rng = np.random.default_rng(nf + ns)
        A = rng.normal(size=(mb * d, mb * d))
        F = torch.tensor(A @ A.T / (mb * d) + np.eye(mb * d))
        pool = torch.cat([t_chol.blocks_from_dense(F[None], mb, d).reshape(-1, d * d),
                          torch.zeros(1, d * d, dtype=torch.float64)])
        gp = torch.zeros(B * mb + 1, d, dtype=torch.float64)
        up = lambda a: torch.as_tensor(a, dtype=torch.int64)
        ext = t_inc._plan_rounds(np.full(ns * ns, mb * mb), mb * mb, up)  # root: all trash
        extg = t_inc._plan_rounds(np.full(ns, mb), mb, up)
        out = t_inc._level(pool, gp, 0, 0, B, nf, ns, d, ext, extg)
        want = "partial_cholesky_blocks" if route == "blocks" else "partial_cholesky"
        assert calls == [want]
        assert tuple(out["U"].shape) == (B, ns * ns, d, d) and int(out["bad"]) == 0


def test_pool_holds_every_block_k4_reads(monkeypatch):
    """(9) The incremental scatters (factor groups, orphan messages, the
    children's extend-add) fill every block of a level's frontal matrices
    that K4 reads, in both triangles: each level's pool slice, read as K4's
    plain version reads it (a dense relayout), is symmetric, and the root's
    equals the Schur complement of the whole graph's dense Hessian onto the
    root's variables."""
    steps = _stream(21, seed=6, loop_every=4, loop_back=6, first_loop=8)
    ti = _port_isam(enable_relinearization=False, wildfire_threshold=0.0)
    for step in steps[:-1]:
        _feed_port(ti, step)
    seen = []
    orig = t_inc._level

    def spy(pool, gp, boff, goff, B, nf, ns, d, ext, extg):
        mb = nf + ns
        Fb = pool[boff : boff + B * mb * mb].reshape(-1, d, d)
        seen.append((t_chol.dense_from_blocks(Fb, B, mb, d).clone(),
                     gp[goff : goff + B * mb].reshape(B, mb * d).clone(), nf, ns))
        return orig(pool, gp, boff, goff, B, nf, ns, d, ext, extg)

    monkeypatch.setattr(t_inc, "_level", spy)
    res = _feed_port(ti, steps[-1])
    assert res.n_reeliminated > 3 and len(seen) > 2
    for F, _, _, _ in seen:
        np.testing.assert_allclose(F.numpy(), F.transpose(1, 2).numpy(), atol=1e-12)
    eng = ti.engine
    root = next(c for c in eng.cliques if c is not None and c.parent < 0)
    F, g, nf, ns = seen[-1]
    assert ns == 0 and F.shape[0] == 1
    H, gg = t_solve.assemble_dense(ti._as_graph().linearize(ti.theta))
    H, gg = H.numpy(), gg.numpy()
    r = np.concatenate([np.arange(3 * v, 3 * v + 3) for v in root.frontal])
    o = np.setdiff1d(np.arange(H.shape[0]), r)
    S = H[np.ix_(r, r)] - H[np.ix_(r, o)] @ np.linalg.solve(H[np.ix_(o, o)], H[np.ix_(o, r)])
    gs = gg[r] - H[np.ix_(r, o)] @ np.linalg.solve(H[np.ix_(o, o)], gg[o])
    k = len(r)
    np.testing.assert_allclose(F[0, :k, :k].numpy(), S, rtol=1e-9, atol=1e-9 * np.abs(S).max())
    np.testing.assert_allclose(g[0, :k].numpy(), gs, atol=1e-9 * np.abs(gs).max())
    # padded frontal blocks hold the identity and nothing else
    np.testing.assert_array_equal(F[0, k:, k:].numpy(), np.eye(F.shape[1] - k))
    assert float(F[0, :k, k:].abs().max() if k < F.shape[1] else 0.0) == 0.0


def test_recorded_isam2_shapes_have_kernel_plans():
    """tests/data/isam2_bucket_shapes.json (tools/bench_bucket_shapes.py):
    each level shape carries the route `level_route` gives it in float64
    and float32, and every shape has a launch plan for the kernel it takes
    (K4's where it routes there; K2's for every wildfire shape)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "data", "isam2_bucket_shapes.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["d"] == 3 and rec["level"] and rec["wildfire"]
    for B, nf, ns, r64, r32, count in rec["level"]:
        assert (r64, r32) == (t_inc.level_route(nf, ns, 3, 8), t_inc.level_route(nf, ns, 3, 4))
        assert count > 0
        for route, itemsize in ((r64, 8), (r32, 4)):
            if route == "blocks":
                assert t_chol.k4_plan(B, nf, ns, 3, itemsize).grid > 0
            else:
                assert t_chol_v2.k1_plan(B, nf, ns, 3, itemsize).factor_grid == B
    for B, nf, ns, count in rec["wildfire"]:
        assert t_chol_v2.k2_plan(B, nf, ns, 3, 8).grid > 0 and count > 0


def test_add_rounds_match_sequential_index_add():
    """The planned rounds of a scatter-add with repeated destinations (and
    pads bound for the trash row) give, bit for bit, what one sequential
    CPU `index_add_` gives, with no duplicate index in any round."""
    rng = np.random.default_rng(3)
    n_dest, trash = 40, 40
    dest = rng.integers(0, n_dest + 1, size=500)  # trash = n_dest, about 1 in 41
    src = torch.tensor(rng.normal(size=(500, 9)) * 10.0 ** rng.integers(-8, 8, size=(500, 1)))
    plan = t_inc._plan_rounds(dest, trash, lambda a: torch.as_tensor(a, dtype=torch.int64))
    assert len(plan.rounds) == np.bincount(dest[dest != trash]).max()
    for _, d in plan.rounds:
        assert d.unique().numel() == d.numel() and int(d.max()) < trash
    got = torch.zeros(n_dest + 1, 9, dtype=torch.float64)
    t_inc._add_rounds(got, plan, src)
    want = torch.zeros(n_dest + 1, 9, dtype=torch.float64)
    keep = torch.as_tensor(dest != trash)
    want.index_add_(0, torch.as_tensor(dest)[keep], src[keep])
    assert torch.equal(got, want)


def test_city_stream_pool_sums_have_unique_destinations(tmp_path, monkeypatch):
    """Every pool sum of the engine (factor groups, orphan messages, the
    identity rows, each level's extend-add) is an `index_add_` with unique
    destination indices while the 150-line City stream is updated, so the
    card sums in a fixed order; `index_put_` is not used for sums at all."""
    lines, _ = synthetic.city_stream(3687, seed=0)
    path = tmp_path / "city_stream.txt"
    path.write_text("\n".join(lines[:150]) + "\n")
    calls = {"index_add_": 0}
    orig_add, orig_put = torch.Tensor.index_add_, torch.Tensor.index_put_

    def index_add_(self, dim, index, source, **kw):
        calls["index_add_"] += 1
        assert index.unique().numel() == index.numel(), "duplicate destination in index_add_"
        return orig_add(self, dim, index, source, **kw)

    def index_put_(self, indices, values, accumulate=False):
        assert not accumulate, "index_put_(accumulate=True) in the engine"
        return orig_put(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_add_", index_add_)
    monkeypatch.setattr(torch.Tensor, "index_put_", index_put_)
    r = t_city.run_city10000(str(path), device="cpu")
    assert len(r.updates) == 150 and calls["index_add_"] > 1000
    assert all(np.isfinite(r.estimate).ravel())
