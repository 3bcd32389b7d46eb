"""SO(2): planar rotations, stored as the angle theta (tensor [...]).

Port of gtsam_petercdev_tpu/geometry/rot2.py; tangent dim 1.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import resolve_device

DIM = 1


def wrap(theta):
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def identity(dtype=torch.float64, device="cuda"):
    return torch.zeros((), dtype=dtype, device=resolve_device(device))


def compose(a, b):
    return wrap(a + b)


def inverse(a):
    return -a


def between(a, b):
    return wrap(b - a)


def expmap(w):
    return wrap(w[..., 0])


def logmap(a):
    return wrap(a)[..., None]


def retract(a, w):
    return wrap(a + w[..., 0])


def local(a, b):
    return wrap(b - a)[..., None]


def matrix(a):
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def rotate(a, p):
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack(
        [c * p[..., 0] - s * p[..., 1], s * p[..., 0] + c * p[..., 1]], dim=-1
    )


def unrotate(a, p):
    return rotate(-a, p)
