"""NavState: SO(3) x R^3 x R^3 (attitude, position, velocity).

Port of gtsam_petercdev_tpu/navigation/navstate.py. The chart is the
reference's (gtsam/navigation/NavState.cpp:286-330):
  retract:  R' = R Exp(dθ), t' = t + R dp, v' = v + R dv
  local:    dθ = Log(R^T R_g), dp = R^T (t_g - t), dv = R^T (v_g - v)
Tangent order (θ, p, v), dim 9; every function is batched over leading dims.
Importing this module registers NavState and ConstantBias (a 6-vector:
accelerometer, gyroscope) in the manifold registry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import so3


class NavState(NamedTuple):
    R: torch.Tensor  # [..., 3, 3] nRb
    t: torch.Tensor  # [..., 3] position in nav frame
    v: torch.Tensor  # [..., 3] velocity in nav frame


DIM = 9


def identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    return NavState(torch.eye(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev),
                    torch.zeros(3, dtype=dtype, device=dev))


def retract(s: NavState, xi) -> NavState:
    dth, dp, dv = xi[..., :3], xi[..., 3:6], xi[..., 6:9]
    return NavState(
        s.R @ so3.expmap(dth),
        s.t + so3.rotate(s.R, dp),
        s.v + so3.rotate(s.R, dv),
    )


def local(a: NavState, b: NavState):
    dth = so3.logmap(so3.between(a.R, b.R))
    dp = so3.unrotate(a.R, b.t - a.t)
    dv = so3.unrotate(a.R, b.v - a.v)
    return torch.cat([dth, dp, dv], dim=-1)


NAVSTATE = manifold.register(
    manifold.ManifoldType(
        name="NavState",
        dim=9,
        retract=retract,
        local=local,
        identity=identity,
    )
)

# bias: ConstantBias (accelerometer, gyroscope) as a flat 6-vector
CONSTANT_BIAS = manifold.register(manifold.vector_space("ConstantBias", 6))
