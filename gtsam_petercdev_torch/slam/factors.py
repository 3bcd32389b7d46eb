"""Core SLAM factor types: Prior and Between over any registered Lie group.

Port of gtsam_petercdev_tpu/slam/factors.py (the default build's chart
conventions):
  PriorFactor<T>:   error = -Local(x, prior), Jacobian = Identity
  BetweenFactor<T>: error = Local(measured, between(x1, x2)), Jacobians of
                    `between` alone (no Local chain-rule term)

Pose3 factors carry closed-form batched Jacobians (`analytic`); the other
types linearize through torch.func autodiff of `linearize_residual`.
`nonlinear_equality` pins a variable exactly, for the constrained dense
solve of linear/qr.py.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.geometry import pose3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


def nonlinear_equality(type_name: str):
    """NonlinearEquality<T> (gtsam/nonlinear/NonlinearEquality.h:44): pin a
    variable EXACTLY to a value. Returns (factor_type, sqrt_info, mask) —
    add with graph.add(ft, [key], value, sqrt_info, constrained_mask=mask)
    and solve with the exact constrained path (solver="dense")."""
    from gtsam_petercdev_torch.linear.noise import constrained_all

    sqrt_info, mask = constrained_all(manifold.get(type_name).dim)
    return prior_factor(type_name), sqrt_info, mask


def _eye_like(r0, dim):
    return torch.eye(dim, dtype=r0.dtype, device=r0.device).expand(
        *r0.shape[:-1], dim, dim
    )


def _pose3_prior_analytic(m):
    def analytic(xs, params):
        (x,) = xs
        r0 = -m.local(x, params)
        return r0, (_eye_like(r0, m.dim),)

    return analytic


def _pose3_between_analytic(m):
    def analytic(xs, params):
        x1, x2 = xs
        h0 = m.between(x1, x2)
        r0 = m.local(params, h0)
        # between(x1 Exp(d1), x2 Exp(d2)) = h0 Exp(-Ad(h0^-1) d1) Exp(d2)
        # => J1 = -Ad(h0^-1), J2 = I in h0's chart
        J1 = -pose3.adjoint_map(pose3.inverse(h0))
        return r0, (J1, _eye_like(r0, m.dim))

    return analytic


@lru_cache(maxsize=None)
def prior_factor(type_name: str, gtsam_compatible: bool = True) -> FactorType:
    """Unary prior; params = prior value."""
    m = manifold.get(type_name)

    def residual(xs, params):
        (x,) = xs
        return -m.local(x, params)

    def linearize_residual(xs_r, xs0, params):
        # value at delta=0: -Local(x0, prior); Jacobian: d/ddelta
        # Local(x0, x0 (+) delta) = Identity
        (x,) = xs_r
        (x0,) = xs0
        return -m.local(x0, params) + m.local(x0, x)

    return FactorType(
        name=f"Prior{type_name}",
        var_types=(type_name,),
        resid_dim=m.dim,
        residual=residual,
        linearize_residual=linearize_residual if gtsam_compatible else None,
        analytic=_pose3_prior_analytic(m)
        if (gtsam_compatible and type_name == "Pose3")
        else None,
    )


@lru_cache(maxsize=None)
def between_factor(type_name: str, gtsam_compatible: bool = True) -> FactorType:
    """Binary relative measurement; params = measured value."""
    m = manifold.get(type_name)

    def residual(xs, params):
        x1, x2 = xs
        return m.local(params, m.between(x1, x2))

    def linearize_residual(xs_r, xs0, params):
        # value at delta=0: Local(measured, h0); Jacobian: derivative of
        # between() in the chart at h0 — no Local chain term
        x1, x2 = xs_r
        h0 = m.between(xs0[0], xs0[1])
        return m.local(params, h0) + m.local(h0, m.between(x1, x2))

    return FactorType(
        name=f"Between{type_name}",
        var_types=(type_name, type_name),
        resid_dim=m.dim,
        residual=residual,
        linearize_residual=linearize_residual if gtsam_compatible else None,
        analytic=_pose3_between_analytic(m)
        if (gtsam_compatible and type_name == "Pose3")
        else None,
    )


def factor_type(name: str) -> FactorType:
    """FactorType from its name: "Prior<Type>" or "Between<Type>"."""
    for prefix, make in (("Prior", prior_factor), ("Between", between_factor)):
        if name.startswith(prefix):
            return make(name[len(prefix):])
    raise KeyError(f"unknown factor type {name!r}")
