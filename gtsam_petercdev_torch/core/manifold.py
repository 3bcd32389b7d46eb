"""Manifold traits registry — port of gtsam_petercdev_tpu/core/manifold.py.

A manifold type is a `ManifoldType` descriptor of pure batched functions
over its parameter layout (one tensor, or a NamedTuple of tensors).
`Values` stores one stacked parameter layout per registered type; the
optimizers only call `retract` / `local` through these descriptors.

Registered here: Pose2 (first-order chart, the default build's), Pose3,
Rot3, Rot2, Point2/3, Vector1/2/3/6 and the extended geometry: Sim3 (dim
7), Unit3 (2), EssentialMatrix (5), OrientedPlane3 (3) and Line3 (4),
imported lazily so that the core import graph stays acyclic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from gtsam_petercdev_torch.core.tree import tree_stack
from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import pose2, pose3, rot2, so3


@dataclass(frozen=True)
class ManifoldType:
    name: str
    dim: int
    retract: Callable[[Any, torch.Tensor], Any]
    local: Callable[[Any, Any], torch.Tensor]
    identity: Callable[..., Any]
    # group operations (None for plain manifolds)
    compose: Optional[Callable] = None
    inverse: Optional[Callable] = None
    between: Optional[Callable] = None
    expmap: Optional[Callable] = None
    logmap: Optional[Callable] = None
    extras: Dict[str, Callable] = field(default_factory=dict)

    def stack(self, elements):
        """Stack a python list of single-element params into a batch."""
        return tree_stack(elements, lambda xs: torch.stack(xs, dim=0))


_REGISTRY: Dict[str, ManifoldType] = {}


def register(mtype: ManifoldType) -> ManifoldType:
    _REGISTRY[mtype.name] = mtype
    return mtype


def get(name: str) -> ManifoldType:
    return _REGISTRY[name]


def registered() -> Dict[str, ManifoldType]:
    return dict(_REGISTRY)


def vector_space(name: str, dim: int) -> ManifoldType:
    """R^n as a trivial Lie group."""

    def identity(dtype=torch.float64, device="cuda"):
        return torch.zeros(dim, dtype=dtype, device=resolve_device(device))

    return ManifoldType(
        name=name,
        dim=dim,
        retract=lambda x, d: x + d,
        local=lambda a, b: b - a,
        identity=identity,
        compose=lambda a, b: a + b,
        inverse=lambda a: -a,
        between=lambda a, b: b - a,
        expmap=lambda d: d,
        logmap=lambda x: x,
    )


# --- built-in registrations -------------------------------------------------

# The canonical Pose2 chart is FIRST-ORDER (the default build's); the chart
# used by Values.retract and by factor linearization must agree. The full
# expmap chart stays available in extras.
POSE2 = register(
    ManifoldType(
        name="Pose2",
        dim=3,
        retract=pose2.retract_first_order,
        local=pose2.local_first_order,
        identity=pose2.identity,
        compose=pose2.compose,
        inverse=pose2.inverse,
        between=pose2.between,
        expmap=pose2.expmap,
        logmap=pose2.logmap,
        extras={
            "retract_expmap": pose2.retract,
            "local_expmap": pose2.local,
            "adjoint_map": pose2.adjoint_map,
        },
    )
)

POSE3 = register(
    ManifoldType(
        name="Pose3",
        dim=6,
        retract=pose3.retract,
        local=pose3.local,
        identity=pose3.identity,
        compose=pose3.compose,
        inverse=pose3.inverse,
        between=pose3.between,
        expmap=pose3.expmap,
        logmap=pose3.logmap,
        extras={"adjoint_map": pose3.adjoint_map},
    )
)

ROT3 = register(
    ManifoldType(
        name="Rot3",
        dim=3,
        retract=so3.retract,
        local=so3.local,
        identity=so3.identity,
        compose=so3.compose,
        inverse=so3.inverse,
        between=so3.between,
        expmap=so3.expmap,
        logmap=so3.logmap,
        extras={"expmap_derivative": so3.expmap_derivative},
    )
)

ROT2 = register(
    ManifoldType(
        name="Rot2",
        dim=1,
        retract=rot2.retract,
        local=rot2.local,
        identity=rot2.identity,
        compose=rot2.compose,
        inverse=rot2.inverse,
        between=rot2.between,
        expmap=rot2.expmap,
        logmap=rot2.logmap,
    )
)


def _register_extended_geometry():
    """Sim3 / Unit3 / EssentialMatrix / OrientedPlane3 / Line3 (imported
    lazily to keep the core import graph acyclic)."""
    from gtsam_petercdev_torch.geometry import essential, sim3, unit3

    register(
        ManifoldType(
            name="Sim3",
            dim=7,
            retract=sim3.retract,
            local=sim3.local,
            identity=sim3.identity,
            compose=sim3.compose,
            inverse=sim3.inverse,
            between=sim3.between,
            expmap=sim3.expmap,
            logmap=sim3.logmap,
        )
    )
    register(ManifoldType(name="Unit3", dim=2, retract=unit3.retract, local=unit3.local,
                          identity=unit3.identity))
    register(ManifoldType(name="EssentialMatrix", dim=5, retract=essential.essential_retract,
                          local=essential.essential_local,
                          identity=essential.essential_identity))
    register(ManifoldType(name="OrientedPlane3", dim=3, retract=essential.plane_retract,
                          local=essential.plane_local, identity=essential.plane_identity))
    register(ManifoldType(name="Line3", dim=4, retract=essential.line_retract,
                          local=essential.line_local, identity=essential.line_identity))


POINT2 = register(vector_space("Point2", 2))
POINT3 = register(vector_space("Point3", 3))
VECTOR1 = register(vector_space("Vector1", 1))
VECTOR2 = register(vector_space("Vector2", 2))
VECTOR3 = register(vector_space("Vector3", 3))
VECTOR6 = register(vector_space("Vector6", 6))

_register_extended_geometry()
