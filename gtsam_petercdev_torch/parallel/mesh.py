"""Process groups and the factor-sharded distributed solve steps.

Port of gtsam_petercdev_tpu/parallel/mesh.py. The JAX package shards factor
batches over a device mesh with shard_map and reduces with `psum`; here a
torch.distributed process group of R ranks (one device each) plays the
mesh:

  * Factor-parallel linearization: rank r linearizes its contiguous shard
    of every factor batch and builds the dense (H, g) of its shard
    (`linear/solve.assemble_dense`); one `all_reduce(SUM)` sums them. The
    device analog of the reference's tbb::parallel_for over factors
    (gtsam/nonlinear/NonlinearFactorGraph.cpp:246-262).
  * The reduced system is solved on every rank (`dense_solve`); the
    partitioned large-map path (separator Schur complement) is
    parallel/partition.py.

With no group (one rank) every function is the single-device computation.
`assemble_dense` accumulates with `index_put_`, atomics on the card: its
sums, and so these steps, may differ from run to run in the last bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_map
from gtsam_petercdev_torch.device import DeviceLike, check_graph_values
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


def make_mesh(n_ranks: Optional[int] = None):
    """The process group the distributed paths run over: the initialized
    default group when it has more than one rank, else None (one rank).
    n_ranks, where given, must be that group's size (1 without one)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"asked for {n_ranks} ranks, the default process group has {world}")
    return dist.group.WORLD if world > 1 else None


def _rank_world(group):
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _shard(graph: NonlinearFactorGraph, rank: int, world: int) -> NonlinearFactorGraph:
    """The graph of rows [N r / R, N (r + 1) / R) of every factor batch
    (batches left empty are dropped)."""
    graph._materialize()
    out = NonlinearFactorGraph(device=graph.device, dtype=graph.dtype)
    for b in graph.batches:
        lo, hi = b.size * rank // world, b.size * (rank + 1) // world
        if hi > lo:
            out.batches.append(dataclasses.replace(
                b, keys=b.keys[lo:hi], params=tree_map(lambda a: a[lo:hi], b.params),
                sqrt_info=b.sqrt_info[lo:hi],
                constrained_mask=None if b.constrained_mask is None else b.constrained_mask[lo:hi],
                _rows_cache=None))
    return out


def distributed_normal_equations(graph: NonlinearFactorGraph, values: Values, group=None, *,
                                 device: DeviceLike = "cuda"):
    """(step, type_counts): step(values) -> (H [D, D], g [D]), the dense
    normal equations of the whole graph, each rank linearizing its shard of
    every factor batch and one `all_reduce` summing the ranks' (H, g).
    group: a process group (None: one rank). type_counts: variables per
    type, in the sorted-type order of H's blocks."""
    check_graph_values(graph, values, device)
    rank, world = _rank_world(group)
    shard = _shard(graph, rank, world)
    type_counts = {t: values._count(t) for t in values.types()}
    D = sum(n * manifold.get(t).dim for t, n in type_counts.items())

    def step(values_in: Values):
        lg = shard.linearize(values_in)
        if lg.batches:
            H, g = linsolve.assemble_dense(lg)
        else:  # more ranks than factors: this rank adds nothing
            H = torch.zeros((D, D), dtype=graph.dtype, device=graph.device)
            g = torch.zeros((D,), dtype=graph.dtype, device=graph.device)
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(H, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return H, g

    return step, type_counts


def distributed_gn_step(graph: NonlinearFactorGraph, values: Values, group=None, *,
                        device: DeviceLike = "cuda"):
    """step(values, lam) -> values: one Gauss-Newton step, the normal
    equations summed over the ranks (`distributed_normal_equations`), the
    damped dense solve on every rank, the retract."""
    ne_step, type_counts = distributed_normal_equations(graph, values, group, device=device)

    def step(values_in: Values, lam) -> Values:
        H, g = ne_step(values_in)
        x = linsolve.dense_solve(H, g, lam)
        delta: Dict[str, torch.Tensor] = {}
        start = 0
        for t in sorted(type_counts):
            n, dim = type_counts[t], manifold.get(t).dim
            delta[t] = x[start : start + n * dim].reshape(n, dim)
            start += n * dim
        return values_in.retract(delta)

    return step
