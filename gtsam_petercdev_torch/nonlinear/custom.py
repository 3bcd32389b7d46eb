"""CustomFactor + LinearContainerFactor.

Port of gtsam_petercdev_tpu/nonlinear/custom.py. Reference:
gtsam/nonlinear/CustomFactor.{h,cpp} lets Python users supply an error
callback; here the callback is a pure PyTorch function of ONE factor and
Jacobians come from forward-mode autodiff, so `custom_factor` is a thin
FactorType constructor: the callback is wrapped in `torch.func.vmap`, so
the port's batched `residual` runs it over a whole factor batch at once
(and `residual_and_jac` differentiates that batch in one `jacfwd` call).

LinearContainerFactor (nonlinear/LinearContainerFactor.h) wraps an existing
*linear* factor (A, b at a linearization point x0) so it can ride in a
nonlinear graph: r(x) = sum_k A_k * local(x0_k, x_k) - b. This is the JAX
package's per-block form (params A tuple, b, x0 tuple; named
"LinearContainer<T1>_<T2>_<dim>"); the fixed-lag marginal's sqrtH form is
`nonlinear/fixed_lag.linear_container_factor` ("LinearContainer[T1,T2]<D>").
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_map
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


def custom_factor(
    name: str,
    var_types: Sequence[str],
    resid_dim: int,
    error_fn: Callable[[Tuple[Any, ...], Any], torch.Tensor],
) -> FactorType:
    """User-supplied residual; Jacobians via forward-mode autodiff
    (CustomFactor.h).

    error_fn(xs, params) -> [resid_dim]; xs are single-element manifold
    params in var_types order, params one factor's params. The factor
    evaluates it over a batch with `torch.func.vmap`."""
    batched = torch.func.vmap(error_fn)
    return FactorType(
        name=name,
        var_types=tuple(var_types),
        resid_dim=resid_dim,
        residual=lambda xs, params: batched(tuple(xs), params),
    )


def linear_container_factor(var_types: Sequence[str], resid_dim: int) -> FactorType:
    """params = {'A': tuple of [N, d, dim_k] blocks, 'b': [N, d], 'x0': tuple
    of linearization-point values (one layout [N, ...] per slot)}.
    r(x) = sum_k A_k local(x0_k, x_k) - b, batched over factors."""
    var_types = tuple(var_types)
    locals_ = [manifold.get(t).local for t in var_types]

    def residual(xs, params):
        r = -params["b"]
        for k, x in enumerate(xs):
            xi = locals_[k](params["x0"][k], x)
            r = r + (params["A"][k] @ xi[..., None])[..., 0]
        return r

    return FactorType(
        name=f"LinearContainer{'_'.join(var_types)}_{resid_dim}",
        var_types=var_types,
        resid_dim=resid_dim,
        residual=residual,
    )


def linear_container_graph(graph: NonlinearFactorGraph, values: Values) -> NonlinearFactorGraph:
    """Every factor batch of `graph` linearized at `values` and wrapped in
    `linear_container_factor` (LinearContainerFactor::ConvertLinearGraph):
    the whitened blocks A_k and b = -r(x0), unit sqrt_info, x0 the batch's
    variables at `values`. A new graph on `graph`'s device; linearized at
    `values` it gives back `graph`'s linearization."""
    lg = graph.linearize(values)
    out = NonlinearFactorGraph(device=graph.device, dtype=graph.dtype)
    for batch, lb in zip(graph.batches, lg.batches):
        x0 = tuple(tree_map(lambda a, r=r: a[r], values.params(t))
                   for t, r in zip(lb.var_types, lb.rows_dev))
        n, d = lb.b.shape
        out.add_batch(linear_container_factor(lb.var_types, d), batch.keys,
                      {"A": lb.A, "b": lb.b, "x0": x0},
                      torch.eye(d, dtype=graph.dtype, device=graph.device).expand(n, d, d))
    return out
