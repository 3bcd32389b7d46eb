"""Rank bodies of the multi-rank CPU tests in tests/test_torch_parallel.py.

Each rank is a process started by torch.multiprocessing (spawn), joined to
the others by gloo over a FileStore (no network port); this module imports
no JAX, so a rank starts quickly. `results(group)` is what the tests
compare: the same function with group=None is the one-rank reference.
"""

import os

import numpy as np
import torch

from gtsam_petercdev_torch.inference import elimination
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.parallel import mesh, partition
from gtsam_petercdev_torch.utils import convert, synthetic

N_PARTS = 4
LAM = 1e-3


def problem():
    """A 6 x 8 Pose3 ring graph on the CPU."""
    va, fa = synthetic.sphere_rings(6, 8, seed=3)
    return convert.graph_from_arrays(fa, device="cpu"), convert.values_from_arrays(va, device="cpu")


def results(group):
    """{solve: x of the damped system at P = N_PARTS, H, g: the normal
    equations, lm: the partitioned LM's error history}."""
    graph, values = problem()
    lg = graph.linearize(values)
    structure = [{"keys": np.stack(s.gids, axis=1), "dims": s.dims}
                 for s in elimination.graph_structure(graph, values)]
    plan = partition.build_partitioned_plan(structure, len(values), 6, N_PARTS)
    solver = partition.PartitionedSolver(plan, group, device="cpu")
    x = solver.solve(tuple((lb.A, lb.b) for lb in lg.batches), LAM)
    H, g = mesh.distributed_normal_equations(graph, values, group, device="cpu")[0](values)
    # the optimizer's group is the default one (make_mesh): every rank in it
    lm = optimizers.levenberg_marquardt(
        graph, values, optimizers.LMParams(solver="partitioned", partition_devices=N_PARTS,
                                           max_iterations=4), device="cpu")
    return dict(solve=x.numpy(), H=H.numpy(), g=g.numpy(), lm=np.asarray(lm.error_history))


def rank_main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """torch.multiprocessing entry: join the gloo group, write results."""
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results(dist.group.WORLD))
    finally:
        dist.destroy_process_group()
