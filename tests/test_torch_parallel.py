"""The port's distributed paths (parallel/mesh.py, the partitioned solver
over ranks, solver="partitioned" in the optimizers) against the JAX package
and across ranks.

JAX parity: the factor-sharded normal equations on the toy Pose3 problem
of __graft_entry__ (the JAX side on the virtual 8-device CPU mesh), atol
1e-9. Multi-rank: two ranks on gloo (torch.multiprocessing spawn, a
FileStore under tmp_path, no network port; every join waits at most 60 s,
so a hung rank fails the test instead of stalling the suite) against one
rank, to 1e-12. The optimizer tests mirror tests/test_parallel.py.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import __graft_entry__ as ge
import _torch_dist_worker as worker
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.parallel import mesh as t_mesh
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.parallel import mesh as j_mesh
from gtsam_petercdev_tpu.slam.factors import between_factor, prior_factor
from test_torch_factor_graph import both, jax_to_arrays

JOIN_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def toy():
    """__graft_entry__._toy_pose3_problem(10) in both packages."""
    jg, jv = ge._toy_pose3_problem(n_poses=10, dtype=jnp.float64)
    return both(*jax_to_arrays(jg, jv))


def test_distributed_normal_equations_match_jax(toy):
    jg, jv, tg, tv = toy
    ne, counts = t_mesh.distributed_normal_equations(tg, tv, device="cpu")
    H, g = ne(tv)
    jne, jcounts = j_mesh.distributed_normal_equations(jg, jv, j_mesh.make_mesh(8))
    H_j, g_j = jax.jit(jne)(jv)  # eager shard_map dispatch is far slower on the CPU
    assert counts == jcounts
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), atol=1e-9, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-9, rtol=0)


def test_distributed_gn_step_is_the_dense_step(toy):
    """One step without a group: the dense damped solve, retracted; the
    error falls."""
    _, _, tg, tv = toy
    out = t_mesh.distributed_gn_step(tg, tv, device="cpu")(tv, 1e-6)
    lg = tg.linearize(tv)
    H, g = t_solve.assemble_dense(lg)
    ref = tv.retract(t_solve.unflatten_delta(lg, t_solve.dense_solve(H, g, 1e-6)))
    assert torch.equal(out.params("Pose3").t, ref.params("Pose3").t)
    assert float(tg.error(out)) < float(tg.error(tv))


def _pose2_chain():
    """tests/test_parallel.py's 20-pose chain with a loop closure."""
    rng = np.random.default_rng(5)
    n = 20
    g, v = JGraph(), JValues()
    sig = j_noise.isotropic(3, 0.05, jnp.float64)
    v.insert(0, "Pose2", jnp.zeros(3))
    g.add(prior_factor("Pose2"), [0], jnp.zeros(3), j_noise.isotropic(3, 0.01, jnp.float64))
    for i in range(n - 1):
        odo = jnp.asarray([1.0, 0.0, 0.3])
        v.insert(i + 1, "Pose2", j_pose2.compose(v.at(i), odo + rng.normal(size=3) * 0.05))
        g.add(between_factor("Pose2"), [i, i + 1], odo, sig)
    g.add(between_factor("Pose2"), [0, n - 1], j_pose2.between(v.at(0), v.at(n - 1)), sig)
    return both(*jax_to_arrays(g, v))[2:]


def test_partitioned_solver_in_lm_matches_dense():
    """solver="partitioned" as LM's linear solver (lambda retries included)
    reaches the dense LM optimum (as tests/test_parallel.py)."""
    tg, tv = _pose2_chain()
    dense = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(max_iterations=15), device="cpu")
    part = t_opt.levenberg_marquardt(
        tg, tv, t_opt.LMParams(max_iterations=15, solver="partitioned", partition_devices=4),
        device="cpu")
    assert abs(dense.error - part.error) < 1e-8
    # the plan is cached on the graph, one per part count
    assert len(tg.__dict__["_partitioned_solvers"]) == 1


def test_make_mesh_without_a_group():
    assert t_mesh.make_mesh() is None and t_mesh.make_mesh(1) is None
    with pytest.raises(ValueError, match="ranks"):
        t_mesh.make_mesh(2)


def test_entry_points_raise_without_cuda(toy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    _, _, tg, tv = toy
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mesh.distributed_normal_equations(tg, tv)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mesh.distributed_gn_step(tg, tv)
    from gtsam_petercdev_torch.parallel import scaling

    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.run(parts=(1,), ba_parts=())


# --- two gloo ranks against one rank ------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each rank's `worker.results`, two ranks on gloo; and one rank's."""
    d = tmp_path_factory.mktemp("gloo")
    ctx = tmp.start_processes(worker.rank_main, args=(2, str(d / "store"), str(d)), nprocs=2,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(5)
            pytest.fail(f"a rank did not finish within {JOIN_TIMEOUT_S} s")
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(2)]
    return ranks, worker.results(None)


@pytest.mark.parametrize("key", ["solve", "H", "g", "lm"])
def test_two_ranks_equal_one(two_ranks, key):
    """P = 4 over two ranks (two parts each) = P = 4 on one rank; the
    two-rank normal equations = one rank's; the LM histories agree. Both
    ranks hold the same result."""
    ranks, one = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r[key], one[key], atol=1e-12, rtol=1e-12)
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_scaling_rows_on_cpu():
    """The scaling harness at small shapes on the CPU: each row agrees with
    the multifrontal solve to 1e-8 x its largest entry, repeats bitwise,
    times both solves in alternation, and launches no kernel (the plain
    versions run on the CPU); the table has a line a row."""
    from gtsam_petercdev_torch.parallel import scaling

    rows = (scaling.sphere_rows("cpu", parts=(1, 4), shape=(6, 8), reps=1)
            + scaling.ba_rows("cpu", parts=(2,), shape=(8, 120, 3), reps=1))
    assert [(r["problem"], r["parts"]) for r in rows] == [("sphere", 1), ("sphere", 4), ("ba", 2)]
    for r in rows:
        assert r["max_abs_diff"] <= 1e-8 * r["max_abs_x"] and r["bitwise_repeat"]
        assert r["ms"] > 0 and r["multifrontal_ms"] > 0 and r["ratio"] > 0
        assert sum(r["launches"].values()) == 0
    assert rows[0]["S"] == 0 and rows[1]["S"] > 0
    assert len(scaling.table(rows)) == 2 + len(rows)
