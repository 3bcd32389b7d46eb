"""Port geometry and manifold registry against the JAX package.

Inputs come from a numpy seed and go through both packages; the port runs
on the CPU in float64. Tolerance: atol 1e-12 (the same formulas in the same
precision; only the order of a few sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.core import manifold as t_manifold
from gtsam_petercdev_torch.geometry import pose2 as t_pose2
from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.geometry import so3 as t_so3
from gtsam_petercdev_tpu.core import manifold as j_manifold
from gtsam_petercdev_tpu.geometry import pose2 as j_pose2
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.geometry import so3 as j_so3

ATOL = 1e-12


def _close(port, ref, atol=ATOL):
    if isinstance(port, tuple):
        for p, r in zip(port, ref):
            _close(p, r, atol)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _t(*arrays):
    out = tuple(torch.tensor(np.asarray(a, dtype=np.float64)) for a in arrays)
    return out if len(out) > 1 else out[0]


def _omegas(rng, n=16):
    """Random axis-angles, plus the small-angle and near-pi regimes."""
    w = rng.normal(size=(n, 3))
    axes = w / np.linalg.norm(w, axis=1, keepdims=True)
    small = axes[:4] * np.array([0.0, 1e-9, 1e-6, 1e-4])[:, None]
    near_pi = axes[4:8] * (np.pi - np.array([0.0, 1e-8, 1e-5, 1e-3]))[:, None]
    return np.concatenate([w, small, near_pi], axis=0)


def test_so3_exp_log_compose_between(rng):
    w1, w2 = _omegas(rng), _omegas(rng)
    _close(t_so3.expmap(_t(w1)), j_so3.expmap(jnp.asarray(w1)))
    R1, R2 = j_so3.expmap(jnp.asarray(w1)), j_so3.expmap(jnp.asarray(w2))
    tR1, tR2 = _t(R1, R2)
    _close(t_so3.logmap(tR1), j_so3.logmap(R1))
    _close(t_so3.compose(tR1, tR2), j_so3.compose(R1, R2))
    _close(t_so3.between(tR1, tR2), j_so3.between(R1, R2))
    _close(t_so3.retract(tR1, _t(w2)), j_so3.retract(R1, jnp.asarray(w2)))
    _close(t_so3.local(tR1, tR2), j_so3.local(R1, R2))
    _close(t_so3.expmap_derivative(_t(w1)), j_so3.expmap_derivative(jnp.asarray(w1)))
    _close(t_so3.logmap_derivative(_t(w1)), j_so3.logmap_derivative(jnp.asarray(w1)))


@pytest.mark.parametrize("theta2", [0.0, 1e-12, 0.3])
def test_so3_trig_coeffs_jacfwd_nan_free(theta2):
    """The safe-denominator pattern keeps forward-mode derivatives finite
    at and near the small-angle branch, equal to JAX's."""
    w = np.array([np.sqrt(theta2), 0.0, 0.0])
    jt = torch.func.jacfwd(t_so3.expmap)(_t(w))
    jj = jax.jacfwd(j_so3.expmap)(jnp.asarray(w))
    assert torch.isfinite(jt).all()
    _close(jt, jj)


def _pose2s(rng, n=12):
    p = rng.normal(size=(n, 3))
    p[:2, 2] = [0.0, 1e-8]  # small-angle branch of the SE(2) exp
    return p


def test_pose2_group_and_charts(rng):
    a, b, xi = _pose2s(rng), _pose2s(rng), _pose2s(rng)
    ja, jb, jxi = jnp.asarray(a), jnp.asarray(b), jnp.asarray(xi)
    ta, tb, txi = _t(a, b, xi)
    _close(t_pose2.expmap(txi), j_pose2.expmap(jxi))
    _close(t_pose2.logmap(ta), j_pose2.logmap(ja))
    _close(t_pose2.compose(ta, tb), j_pose2.compose(ja, jb))
    _close(t_pose2.between(ta, tb), j_pose2.between(ja, jb))
    _close(t_pose2.inverse(ta), j_pose2.inverse(ja))
    _close(t_pose2.retract(ta, txi), j_pose2.retract(ja, jxi))
    _close(t_pose2.local(ta, tb), j_pose2.local(ja, jb))
    _close(t_pose2.retract_first_order(ta, txi), j_pose2.retract_first_order(ja, jxi))
    _close(t_pose2.local_first_order(ta, tb), j_pose2.local_first_order(ja, jb))
    _close(t_pose2.adjoint_map(ta), j_pose2.adjoint_map(ja))


def test_pose3_group_and_charts(rng):
    xi1 = np.concatenate([_omegas(rng), rng.normal(size=(24, 3))], axis=1)
    xi2 = np.concatenate([_omegas(rng), rng.normal(size=(24, 3))], axis=1)
    j1, j2 = j_pose3.expmap(jnp.asarray(xi1)), j_pose3.expmap(jnp.asarray(xi2))
    t1 = t_pose3.Pose3(*_t(j1.R, j1.t))
    t2 = t_pose3.Pose3(*_t(j2.R, j2.t))
    _close(tuple(t_pose3.expmap(_t(xi1))), tuple(j1))
    _close(t_pose3.logmap(t1), j_pose3.logmap(j1))
    _close(tuple(t_pose3.compose(t1, t2)), tuple(j_pose3.compose(j1, j2)))
    _close(tuple(t_pose3.between(t1, t2)), tuple(j_pose3.between(j1, j2)))
    _close(tuple(t_pose3.inverse(t1)), tuple(j_pose3.inverse(j1)))
    _close(tuple(t_pose3.retract(t1, _t(xi2))), tuple(j_pose3.retract(j1, jnp.asarray(xi2))))
    _close(t_pose3.local(t1, t2), j_pose3.local(j1, j2))
    _close(t_pose3.adjoint_map(t1), j_pose3.adjoint_map(j1))
    _close(t_pose3.matrix(t1), j_pose3.matrix(j1))


PORTED = ["Pose2", "Pose3", "Rot3", "Rot2", "Point2", "Point3",
          "Vector1", "Vector2", "Vector3", "Vector6"]


@pytest.mark.parametrize("name", PORTED)
def test_manifold_registry_matches(name, rng):
    tm, jm = t_manifold.get(name), j_manifold.get(name)
    assert tm.dim == jm.dim
    n = 5
    if name == "Pose3":
        j_x = j_pose3.expmap(jnp.asarray(rng.normal(size=(n, 6))))
        t_x = t_pose3.Pose3(*_t(j_x.R, j_x.t))
    elif name == "Rot3":
        j_x = j_so3.expmap(jnp.asarray(rng.normal(size=(n, 3))))
        t_x = _t(j_x)
    elif name == "Rot2":
        j_x = jnp.asarray(rng.uniform(-3, 3, size=n))
        t_x = _t(j_x)
    else:
        j_x = jnp.asarray(rng.normal(size=(n, tm.dim)))
        t_x = _t(j_x)
    delta = rng.normal(size=(n, tm.dim)) * 0.3
    j_y = jm.retract(j_x, jnp.asarray(delta))
    t_y = tm.retract(t_x, _t(delta))
    _close(tuple(t_y) if name == "Pose3" else t_y, tuple(j_y) if name == "Pose3" else j_y)
    _close(tm.local(t_x, t_y), jm.local(j_x, j_y))
    _close(tm.local(t_x, t_y), _t(delta))
    ident = tm.identity(dtype=torch.float64, device="cpu")
    j_ident = jm.identity(jnp.float64)
    _close(tuple(ident) if name == "Pose3" else ident,
           tuple(j_ident) if name == "Pose3" else j_ident)


def test_registry_covers_slice():
    assert set(PORTED) <= set(t_manifold.registered())
