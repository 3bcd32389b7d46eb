"""The port's planner, multifrontal solve and GN/LM against the JAX package.

Graphs: `_random_pose2_graph` of tests/test_multifrontal.py and a small Pose3
ring graph (4 rings x 5 poses, `utils/synthetic.sphere_rings`), carried
across as numpy arrays. The port runs on the CPU in float64, where its
bucket kernels take their plain versions.

Tolerances: solves atol 1e-8 (as tests/test_multifrontal.py); GN/LM final
error rel 1e-9 and poses atol 1e-6 (as test_gn_with_multifrontal_solver).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.utils import convert
from gtsam_petercdev_tpu.inference import elimination as j_elim
from gtsam_petercdev_tpu.inference import symbolic as j_sym
from gtsam_petercdev_tpu.linear import solve as j_solve
from gtsam_petercdev_tpu.nonlinear import optimizers as j_opt
from test_torch_factor_graph import both, jax_linearize, pose2_problem, pose3_rings

ATOL = 1e-8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(name, rng):
    if name == "pose3_rings":
        return pose3_rings()
    n_poses, n_loops = {"pose2_12_4": (12, 4), "pose2_30_10": (30, 10),
                        "pose2_60_25": (60, 25)}[name]
    return pose2_problem(rng, n_poses, n_loops)


def _factor_vars(factor_arrays):
    return [np.asarray(keys, dtype=np.int64) for _, keys, _, _ in factor_arrays]


# --- symbolic plan ------------------------------------------------------------


@pytest.mark.parametrize("problem", ["pose2_60_25", "pose3_rings"])
@pytest.mark.parametrize("ordering", ["nested_dissection", "colamd", "degree_ascending"])
def test_plan_equality_for_explicit_ordering(problem, ordering, rng):
    """Same ordering in, same plan out: perm, levels, buckets (nf, ns, B),
    cliques, and the numeric maps built on it."""
    va, fa = _problem(problem, rng)
    t = next(iter(va))
    n, d = len(va[t][0]), 3 if t == "Pose2" else 6
    fv = _factor_vars(fa)
    edges = np.concatenate([f[:, [0, 1]] for f in fv if f.shape[1] == 2])
    order_fn = f"{ordering}_ordering"
    perm = getattr(j_sym, order_fn)(n, edges)
    np.testing.assert_array_equal(getattr(t_sym, order_fn)(n, edges), perm)

    jp = j_sym.symbolic_eliminate(n, fv, d, ordering=perm, max_buckets_per_level=4)
    tp = t_sym.symbolic_eliminate(n, fv, d, ordering=perm, max_buckets_per_level=4)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(tp.iperm, jp.iperm)
    assert [[(b.nf, b.ns, b.cliques) for b in lv] for lv in tp.levels] == [
        [(b.nf, b.ns, b.cliques) for b in lv] for lv in jp.levels
    ]
    assert [(c.frontal, c.separator, c.parent) for c in tp.cliques] == [
        (c.frontal, c.separator, c.parent) for c in jp.cliques
    ]

    structure = [(tuple(f[:, k] for k in range(f.shape[1])), None) for f in fv]
    jm = j_elim.build_numeric_maps(jp, [((t,) * f.shape[1], r) for f, (r, _) in zip(fv, structure)])
    tm = t_elim.build_numeric_maps(tp, [((t,) * f.shape[1], r) for f, (r, _) in zip(fv, structure)])
    np.testing.assert_array_equal(tm.asm_plan.direct, jm.asm_plan.direct)
    np.testing.assert_array_equal(tm.asm_g_plan.direct, jm.asm_g_plan.direct)
    for tb, jb in zip(tm.buckets, jm.buckets):
        assert (tb.B, tb.nf, tb.ns, tb.blk_start, tb.g_start) == (
            jb.B, jb.nf, jb.ns, jb.blk_start, jb.g_start)
        np.testing.assert_array_equal(tb.sep_idx, jb.sep_idx)
        np.testing.assert_array_equal(tb.fro_idx, jb.fro_idx)
        for (tc, ts, tpp), (jc, js, jpp) in zip(tb.ext_mm or (), jb.ext_mm or ()):
            assert tc == jc
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(tpp, jpp)


# --- multifrontal solve ---------------------------------------------------------


def _port_solve(tg, tv, lam, damping):
    lg = tg.linearize(tv)
    _, maps = t_elim._graph_plan(tg, lg)
    x, stats = t_elim.multifrontal_solve(
        maps, tuple((lb.A, lb.b) for lb in lg.batches), lam,
        diagonal_damping=damping, return_stats=True)
    assert int(stats["bad_pivots"]) == 0
    H, g = t_solve.assemble_dense(lg)
    x_dense = t_solve.dense_solve(H, g, lam, diagonal_damping=damping)
    return lg, x, x_dense


CASES = [("pose2_12_4", 1e-3, False), ("pose2_60_25", 0.1, True),
         ("pose3_rings", 1e-3, False), ("pose3_rings", 0.1, True)]


@pytest.mark.parametrize("problem,lam,damping", CASES)
def test_multifrontal_matches_dense_oracles(problem, lam, damping, rng):
    jg, jv, tg, tv = both(*_problem(problem, rng))
    lg, x, x_dense = _port_solve(tg, tv, lam, damping)
    t = next(iter(lg.type_counts))
    np.testing.assert_allclose(x.numpy(), t_solve.unflatten_delta(lg, x_dense)[t].numpy(),
                               atol=ATOL)
    H, g = jax.jit(lambda v: j_solve.assemble_dense(jg.linearize(v)))(jv)
    x_j = jax.jit(j_solve.dense_solve, static_argnames="diagonal_damping")(
        H, g, lam, diagonal_damping=damping)
    j_dense = j_solve.unflatten_delta(jax_linearize(jg, jv), x_j)[t]
    np.testing.assert_allclose(x.numpy(), np.asarray(j_dense), atol=ATOL)


@pytest.mark.parametrize("problem,lam,damping", [CASES[0], CASES[3]])
def test_multifrontal_matches_jax(problem, lam, damping, rng):
    jg, jv, tg, tv = both(*_problem(problem, rng))
    _, x, _ = _port_solve(tg, tv, lam, damping)
    jl = jax_linearize(jg, jv)
    t = next(iter(jl.type_counts))
    plan = j_elim.build_plan_for_graph([(lb.rows, t) for lb in jl.batches], jl.type_counts[t],
                                       3 if t == "Pose2" else 6)
    maps = j_elim.build_numeric_maps(plan, jl)
    x_j = j_elim.multifrontal_solve(maps, tuple((lb.A, lb.b) for lb in jl.batches), lam,
                                    diagonal_damping=damping)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=ATOL)


# --- the slice end to end: GN and LM on the multifrontal solver -----------------


def _pose_arrays(values, t):
    p = values.params(t)
    return [np.asarray(a.numpy() if torch.is_tensor(a) else a)
            for a in (p if isinstance(p, tuple) else (p,))]


@pytest.mark.parametrize("problem", ["pose2_30_10", "pose3_rings"])
def test_gn_and_lm_multifrontal_match_jax(problem, rng):
    jg, jv, tg, tv = both(*_problem(problem, rng))
    t = next(iter(jv.types()))
    for method, params in (("gauss_newton", "OptimizerParams"), ("levenberg_marquardt", "LMParams")):
        jres = getattr(j_opt, method)(jg, jv, getattr(j_opt, params)(
            max_iterations=15, solver="multifrontal"))
        tres = getattr(t_opt, method)(tg, tv, getattr(t_opt, params)(
            max_iterations=15, solver="multifrontal"), device="cpu")
        assert tres.error < tres.error_history[0]
        np.testing.assert_allclose(tres.error, jres.error, rtol=1e-9, atol=1e-12)
        for a, b in zip(_pose_arrays(tres.values, t), _pose_arrays(jres.values, t)):
            np.testing.assert_allclose(a, b, atol=1e-6)


# --- port rules -------------------------------------------------------------------


def _port_sources():
    pkg = os.path.join(REPO, "gtsam_petercdev_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX package."""
    banned = ("jax", "jaxlib", "gtsam_petercdev_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


def test_entry_points_raise_without_cuda(rng):
    """device= defaults to "cuda": without a card an entry point raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    va, fa = _problem("pose2_12_4", rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        TValues()
    with pytest.raises(RuntimeError, match="CUDA"):
        TGraph()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.values_from_arrays(va)
    tg = convert.graph_from_arrays(fa, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_opt.gauss_newton(tg, tv, t_opt.OptimizerParams(solver="multifrontal"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_opt.levenberg_marquardt(tg, tv)
