"""The port's partitioned separator-Schur solver against the JAX package's.

Problems: the 12 x 12 Pose2 grid of tests/test_partition.py and its
16-camera / 200-point sub-block bundle adjustment, carried across as numpy
arrays. The port runs on the CPU in float64 with P parts folded onto the
one device (its bucket kernels take their plain versions there); the JAX
package runs one part per device of the virtual 8-device CPU mesh
(tests/conftest.py).

Tolerances: the plan is equal integer for integer (both packages order
each part through scipy's COLAMD); solves atol 1e-9 against the JAX
PartitionedSolver and atol 1e-8 against the port's multifrontal solve (as
tests/test_partition.py); the GN loop's final error within 1e-6 of dense GN
(as test_partitioned_gn_converges).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.models import ba_synth as t_synth
from gtsam_petercdev_torch.models import bundle_adjustment as t_ba
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.parallel import partition as t_part
from gtsam_petercdev_tpu.parallel import partition as j_part
from test_partition import _grid_problem
from test_torch_factor_graph import both, jax_to_arrays

BA_RIG = dict(n_cams=16, n_points=200, obs_per_point=3)


def _structure(lg, offs, dims):
    return [
        {"keys": np.stack([np.asarray(r, np.int64) + offs[t]
                           for r, t in zip(lb.rows, lb.var_types)], axis=1),
         "dims": tuple(dims[t] for t in lb.var_types)}
        for lb in lg.batches
    ]


@pytest.fixture(scope="module")
def grid():
    """The 12 x 12 grid on the port: (graph, values, lg, structure, n)."""
    jg, jv, n = _grid_problem(12, np.random.default_rng(42))
    _, _, tg, tv = both(*jax_to_arrays(jg, jv))
    tlg = tg.linearize(tv)
    return tg, tv, tlg, _structure(tlg, {"Pose2": 0}, {"Pose2": 3}), n


@pytest.fixture(scope="module")
def ba():
    """The sub-block BA rig on the port (the JAX package's make_synthetic_ba
    gives the same arrays: tests/test_torch_ba.py): (graph, values, lg,
    structure, var_dims, offs, dims, n)."""
    tg, tv = t_ba.build_ba_graph(t_synth.make_synthetic_ba(dtype=np.float64, **BA_RIG),
                                 device="cpu")
    tlg = tg.linearize(tv)
    dims = {"Point3": 3, "SfmCamera": 9}
    offs = t_elim.type_offsets(tlg.type_counts)
    n = sum(tlg.type_counts.values())
    var_dims = np.full(n, 9, np.int64)
    var_dims[offs["Point3"] : offs["Point3"] + tlg.type_counts["Point3"]] = 3
    return tg, tv, tlg, _structure(tlg, offs, dims), var_dims, offs, dims, n


def _assert_plans_equal(tp, jp):
    for f in dataclasses.fields(j_part.PartitionedPlan):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(b, list) and b and isinstance(b[0], dict):
            assert len(a) == len(b), f.name
            for da, db in zip(a, b):
                assert da.keys() == db.keys(), f.name
                for k in db:
                    np.testing.assert_array_equal(da[k], db[k], err_msg=f"{f.name}[{k}]")
        elif isinstance(b, list) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert t_part.plan_padded_flops(tp) == j_part.plan_padded_flops(jp)


@pytest.mark.parametrize("n_parts", [2, 8])
def test_plan_equals_jax_grid(grid, n_parts):
    """The grid's plan: every field of PartitionedPlan, integer for integer."""
    *_, structure, n = grid
    _assert_plans_equal(t_part.build_partitioned_plan(structure, n, 3, n_parts),
                        j_part.build_partitioned_plan(structure, n, 3, n_parts))


@pytest.mark.parametrize("n_parts", [2, 4])
def test_plan_equals_jax_subblock_ba(ba, n_parts):
    """The sub-block BA's plan and its split structure."""
    *_, structure, var_dims, _, _, _ = ba
    ts, tb, tn = t_part.split_structure_to_blocks(structure, var_dims, 3)
    js, jb, jn = j_part.split_structure_to_blocks(structure, var_dims, 3)
    assert tn == jn
    np.testing.assert_array_equal(tb, jb)
    for a, b in zip(ts, js):
        assert a["dims"] == b["dims"]
        np.testing.assert_array_equal(a["keys"], b["keys"])
    _assert_plans_equal(t_part.build_partitioned_plan(ts, tn, 3, n_parts),
                        j_part.build_partitioned_plan(js, jn, 3, n_parts))


def test_partition_vars_is_vertex_separator():
    """As tests/test_partition.py: every variable once, no edge between two
    interiors; and the JAX package's partition exactly."""
    W = 16
    n = W * W
    edges = np.asarray([(i, i + 1) for i in range(n) if i % W + 1 < W]
                       + [(i, i + W) for i in range(n) if i // W + 1 < W], dtype=np.int64)
    interiors, sep = t_part.partition_vars(n, edges, 8)
    part_of = np.full(n, -1)
    for p, ints in enumerate(interiors):
        part_of[ints] = p
    assert sum(len(i) for i in interiors) + len(sep) == n
    pa, pb = part_of[edges[:, 0]], part_of[edges[:, 1]]
    assert not ((pa >= 0) & (pb >= 0) & (pa != pb)).any()
    j_int, j_sep = j_part.partition_vars(n, edges, 8)
    np.testing.assert_array_equal(sep, j_sep)
    for a, b in zip(interiors, j_int):
        np.testing.assert_array_equal(a, b)


def _tAb(lg):
    return tuple((lb.A, lb.b) for lb in lg.batches)


@pytest.mark.parametrize("n_parts", [2, 8])
def test_solve_matches_jax(grid, n_parts):
    """The same damped system (the port's linearization, as numpy arrays)
    through the JAX PartitionedSolver (a part per device of the virtual
    mesh) and the port's (P parts folded), atol 1e-9."""
    _, _, tlg, structure, n = grid
    jp = j_part.build_partitioned_plan(structure, n, 3, n_parts)
    mesh = Mesh(np.array(jax.devices()[:n_parts]), ("parts",))
    jAb = tuple((tuple(jnp.asarray(a.numpy()) for a in lb.A), jnp.asarray(lb.b.numpy()))
                for lb in tlg.batches)
    x_jax = j_part.PartitionedSolver(jp, mesh).solve(jAb, 1e-3)
    tp = t_part.build_partitioned_plan(structure, n, 3, n_parts)
    x = t_part.PartitionedSolver(tp, device="cpu").solve(_tAb(tlg), 1e-3)
    assert x.shape == (n, 3) and x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), x_jax, atol=1e-9, rtol=0)


@pytest.fixture(scope="module")
def sphere():
    """A 10 x 12 Pose3 sphere (utils/synthetic.sphere_rings), linearized in
    float64 and in float32 at its initial values: (structure, n, Ab64, Ab32,
    the float64 multifrontal solve at lambda 1e-5)."""
    from gtsam_petercdev_torch.utils import convert, synthetic

    va, fa = synthetic.sphere_rings(10, 12, seed=0)
    lgs = []
    for dt in (torch.float64, torch.float32):
        g = convert.graph_from_arrays(fa, device="cpu", dtype=dt)
        lgs.append((g, g.linearize(convert.values_from_arrays(va, device="cpu", dtype=dt))))
    (g64, lg64), (_, lg32) = lgs
    _, maps = t_elim._graph_plan(g64, lg64)
    structure, _ = t_part.linearized_structure(lg64)
    n = sum(lg64.type_counts.values())
    return structure, n, _tAb(lg64), _tAb(lg32), t_elim.multifrontal_solve(maps, _tAb(lg64), 1e-5)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_float32_solve_matches_jax(sphere, n_parts):
    """The same float32 damped system through the JAX PartitionedSolver and
    the port's: each within 5e-5 x max|x| of the float64 solve and of each
    other (float32 readings here <= 1.2e-5), and the port no more than 3x
    further from float64 than the JAX package (readings 0.3-1.0x). The
    partitioned ordering rounds more than the multifrontal one in both
    packages (tools/partitioned_f32_reference.py on phase 11's sphere)."""
    structure, n, _, Ab32, x64 = sphere
    jp = j_part.build_partitioned_plan(structure, n, 6, n_parts)
    mesh = Mesh(np.array(jax.devices()[:n_parts]), ("parts",))
    jAb = tuple((tuple(jnp.asarray(a.numpy()) for a in A), jnp.asarray(b.numpy())) for A, b in Ab32)
    x_jax = torch.as_tensor(np.asarray(j_part.PartitionedSolver(jp, mesh).solve(jAb, 1e-5)))
    tp = t_part.build_partitioned_plan(structure, n, 6, n_parts)
    x = t_part.PartitionedSolver(tp, device="cpu").solve(Ab32, 1e-5)
    assert x.dtype == torch.float32
    scale = x64.abs().max()
    e_port = ((x.double() - x64).abs().max() / scale).item()
    e_jax = ((x_jax.double() - x64).abs().max() / scale).item()
    assert e_port <= 5e-5 and e_jax <= 5e-5, (e_port, e_jax)
    assert ((x.double() - x_jax.double()).abs().max() / scale).item() <= 5e-5
    assert e_port <= 3 * e_jax, (e_port, e_jax)


@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_solve_matches_multifrontal(grid, n_parts):
    """Folded parts against the port's own multifrontal solve, atol 1e-8;
    every level one bucket of P * B cliques; a second solve bitwise equal;
    the clamped-pivot count 0 on this SPD system."""
    tg, tv, tlg, structure, n = grid
    _, maps = t_elim._graph_plan(tg, tlg)
    x_ref = t_elim.multifrontal_solve(maps, _tAb(tlg), 1e-3)
    plan = t_part.build_partitioned_plan(structure, n, 3, n_parts)
    solver = t_part.PartitionedSolver(plan, device="cpu")
    assert [(lv.Bt, lv.nf, lv.ns) for lv in solver.folded.levels] == [
        (n_parts * B, nf, ns) for B, nf, ns in plan.levels]
    x, stats = solver.solve(_tAb(tlg), 1e-3, return_stats=True)
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), atol=1e-8, rtol=0)
    assert torch.equal(solver.solve(_tAb(tlg), 1e-3), x)
    assert int(stats["bad_pivots"]) == 0


@pytest.mark.parametrize("max_direct", [1, 2, 4])
def test_gather_sum_plan_matches_index_add(max_direct):
    """elimination.build_gather_sum_plan, the one planner of every pool sum
    (batch multifrontal and the partitioned levels): the planned sums are
    index_add_'s; rows with a negative destination take no part; at most
    max_direct gathers a destination after the pairwise rounds."""
    rng = np.random.default_rng(max_direct)
    dest = rng.integers(0, 40, 500)
    dest[rng.random(500) < 0.3] = -1
    plan = t_elim.build_gather_sum_plan(dest, 50, len(dest), max_direct=max_direct)
    assert plan.direct.shape == (50, max_direct) and len(plan.rounds) > 0
    src = torch.as_tensor(rng.normal(size=(500, 2)))
    got = t_elim.apply_gather_sum(t_elim.DeviceGatherSum.of(plan, "cpu"), src)
    want = torch.zeros(50, 2, dtype=torch.float64).index_add_(
        0, torch.as_tensor(dest[dest >= 0]), src[dest >= 0])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_sums_are_planned(grid):
    """Determinism on the card rests on this: every pool row a level pushes
    into appears once (no scatter-add with repeated destinations), and only
    later levels' rows are written."""
    *_, structure, n = grid
    solver = t_part.PartitionedSolver(t_part.build_partitioned_plan(structure, n, 3, 4),
                                      device="cpu")
    for lv in solver.folded.levels:
        for push, lo in ((lv.ext, lv.pool_lo), (lv.ext_g, lv.g_lo)):
            if push is not None:
                rows = push[0]
                assert len(np.unique(rows)) == len(rows) and rows.min() >= lo


def test_indefinite_separator_reports_bad_pivots(grid):
    """A separator system that is not positive definite: x is NaN (the JAX
    package's cho_factor) and the solve counts the failure for LM."""
    _, _, tlg, structure, n = grid
    solver = t_part.PartitionedSolver(t_part.build_partitioned_plan(structure, n, 3, 4),
                                      device="cpu")
    x, stats = solver.solve(_tAb(tlg), -1e6, return_stats=True)
    assert int(stats["bad_pivots"]) > 0 and torch.isnan(x).any()


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_subblock_ba_matches_multifrontal(ba, n_parts):
    """Mixed-dim BA through uniform d = 3 sub-blocks (cameras as three
    blocks) against the port's mixed 9/3 multifrontal solve, atol 1e-8."""
    tg, tv, tlg, structure, var_dims, offs, dims, n = ba
    lam = 1e-3
    delta, _ = t_elim.solve_linearized(tg, tv, lam, cache={"mf_lg": tlg})
    sub, base, n_sub = t_part.split_structure_to_blocks(structure, var_dims, 3)
    sub_Ab = t_part.split_Ab_to_blocks(_tAb(tlg), structure, 3)
    plan = t_part.build_partitioned_plan(sub, n_sub, 3, n_parts)
    x = t_part.merge_block_solution(t_part.PartitionedSolver(plan, device="cpu").solve(
        sub_Ab, lam), base, var_dims, 3)
    for t in sorted(dims):
        got = x[offs[t] : offs[t] + tlg.type_counts[t], : dims[t]]
        np.testing.assert_allclose(got.numpy(), delta[t].numpy(), atol=1e-8, rtol=0, err_msg=t)
    assert t_part.plan_padded_flops(plan)["interior_gflops_per_device"] > 0


def test_partitioned_gn_converges():
    """The GN loop on the port's solver (P = 4, folded) reaches the dense
    GN optimum (as tests/test_partition.py)."""
    jg, jv, n = _grid_problem(8, np.random.default_rng(42))
    _, _, tg, tv = both(*jax_to_arrays(jg, jv))
    ref = t_opt.gauss_newton(tg, tv, device="cpu")
    part = t_opt.gauss_newton(tg, tv, t_opt.OptimizerParams(
        solver="partitioned", partition_devices=4, max_iterations=5), device="cpu")
    assert abs(part.error - ref.error) < 1e-6
    loop = tv
    solver = None
    for _ in range(5):
        lg = tg.linearize(loop)
        if solver is None:
            plan = t_part.build_partitioned_plan(_structure(lg, {"Pose2": 0}, {"Pose2": 3}), n,
                                                 3, 4)
            solver = t_part.PartitionedSolver(plan, device="cpu")
        loop = loop.retract({"Pose2": solver.solve(_tAb(lg), 0.0)})
    assert abs(float(tg.error(loop)) - ref.error) < 1e-6


def test_entry_points_raise_without_cuda(grid):
    """device= defaults to "cuda": without a card the solver and the
    optimizer hook raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    *_, structure, n = grid
    plan = t_part.build_partitioned_plan(structure, n, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_part.PartitionedSolver(plan)
    tg, tv, *_ = grid
    with pytest.raises(RuntimeError, match="CUDA"):
        t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver="partitioned"))
    with pytest.raises(ValueError, match="diagonal_damping"):
        t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver="partitioned",
                                                         diagonal_damping=True), device="cpu")
