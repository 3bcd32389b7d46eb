"""Sim(3): similarity transforms (scale-drift-aware SLAM).

Port of gtsam_petercdev_tpu/geometry/sim3.py (reference: gtsam/geometry/
Similarity3.{h,cpp}): action p -> s R p + t, tangent ordering (omega, v,
lambda) (Similarity3::Logmap).

Representation: NamedTuple Sim3(R [..., 3, 3], t [..., 3], s [...]), batched
over leading dims. Exp / log use the JAX package's fixed 20-term series for
the Sim(3) "W" matrix (Sum A^n / (n+1)!, A = hat(omega) + lambda I), and
`logmap` inverts it with a batched 3 x 3 solve: no closed form, so the port
computes what the JAX package computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import so3


class Sim3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]


DIM = 7


def identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    return Sim3(torch.eye(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev),
                torch.ones((), dtype=dtype, device=dev))


def transform_from(g: Sim3, p):
    """p -> s R p + t (Similarity3::transformFrom)."""
    return g.s[..., None] * so3.rotate(g.R, p) + g.t


def compose(a: Sim3, b: Sim3) -> Sim3:
    return Sim3(a.R @ b.R, a.s[..., None] * so3.rotate(a.R, b.t) + a.t, a.s * b.s)


def inverse(g: Sim3) -> Sim3:
    Rinv = so3.inverse(g.R)
    sinv = 1.0 / g.s
    return Sim3(Rinv, -sinv[..., None] * so3.rotate(Rinv, g.t), sinv)


def between(a: Sim3, b: Sim3) -> Sim3:
    return compose(inverse(a), b)


def _W(w, lam, terms: int = 20):
    """W = Sum_{n>=0} A^n / (n+1)!, A = hat(w) + lam I (so t = W v): the JAX
    package's fixed series, term for term."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    A = so3.hat(w) + lam[..., None, None] * eye
    out = eye.expand(A.shape)
    term = out
    fact = 1.0
    for n in range(1, terms + 1):
        term = term @ A
        fact *= n + 1
        out = out + term / fact
    return out


def expmap(xi) -> Sim3:
    """xi [..., 7] = (omega, v, lambda) -> Sim3."""
    w, v, lam = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_W(w, lam) @ v[..., None])[..., 0]
    return Sim3(so3.expmap(w), t, torch.exp(lam))


def logmap(g: Sim3):
    w = so3.logmap(g.R)
    lam = torch.log(g.s)
    v = torch.linalg.solve(_W(w, lam), g.t[..., None])[..., 0]
    return torch.cat([w, v, lam[..., None]], dim=-1)


def retract(g: Sim3, xi) -> Sim3:
    return compose(g, expmap(xi))


def local(a: Sim3, b: Sim3):
    return logmap(between(a, b))


def matrix(g: Sim3):
    """[[s R, t], [0, 1]] homogeneous form."""
    top = torch.cat([g.s[..., None, None] * g.R, g.t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.t.dtype, device=g.t.device)
    return torch.cat([top, bottom.expand(*g.t.shape[:-1], 1, 4)], dim=-2)
