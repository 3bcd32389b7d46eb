"""IMU trajectory scenarios + Monte-Carlo-capable runner.

Port of gtsam_petercdev_tpu/navigation/scenario.py (reference: navigation/
Scenario.h, closed-form ConstantTwistScenario / AcceleratingScenario
trajectories; navigation/ScenarioRunner.h, which generates IMU measurements
from a scenario, integrates them, and compares the preintegrated covariance
against sampling). A scenario's functions take a time or a tensor of times
[...] and return [..., 3] / [..., 3, 3]: the JAX package's `jax.vmap` over
times is one batched call here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import as_float, resolve_device
from gtsam_petercdev_torch.geometry import pose3, so3
from gtsam_petercdev_torch.navigation import preintegration as pre
from gtsam_petercdev_torch.navigation.navstate import NavState, local as ns_local


def _times(t, like):
    return as_float(t, like)[..., None]


def _as(x, like_or_dev, dtype=None):
    """x (numbers, numpy, a tensor) as a tensor on a device, in a dtype."""
    x = as_float(x)
    return x.to(like_or_dev) if dtype is None else x.to(like_or_dev, dtype)


class ConstantTwistScenario(NamedTuple):
    """Body twist (w, v) constant: pose(t) = Exp(t [w; v]) composed on start.

    omega_b is constant; velocity/acceleration follow the screw motion
    (Scenario.h ConstantTwistScenario).
    """

    w: torch.Tensor  # [3] body angular velocity
    v: torch.Tensor  # [3] body linear velocity
    R0: torch.Tensor  # [3,3] initial attitude
    t0: torch.Tensor  # [3] initial position

    def rotation(self, t):
        return self.R0 @ so3.expmap(self.w * _times(t, self.w))

    def position(self, t):
        # integrate v in the rotating frame: closed form via SE(3) expmap
        xi = torch.cat([self.w, self.v]) * _times(t, self.w)
        p = pose3.expmap(xi)
        return self.t0 + so3.rotate(self.R0, p.t)

    def velocity_n(self, t):
        return so3.rotate(self.rotation(t), self.v)

    def omega_b(self, t):
        return self.w.expand(_times(t, self.w).shape[:-1] + (3,))

    def acceleration_n(self, t):
        # d/dt (R(t) v) = R(t) (w x v)
        return so3.rotate(self.rotation(t), torch.linalg.cross(self.w, self.v, dim=-1))

    def nav_state(self, t) -> NavState:
        return NavState(self.rotation(t), self.position(t), self.velocity_n(t))


def constant_twist(w, v, R0=None, t0=None, dtype=torch.float64,
                   device="cuda") -> ConstantTwistScenario:
    dev = resolve_device(device)
    as_t = lambda x: _as(x, dev, dtype)
    return ConstantTwistScenario(
        w=as_t(w),
        v=as_t(v),
        R0=torch.eye(3, dtype=dtype, device=dev) if R0 is None else as_t(R0),
        t0=torch.zeros(3, dtype=dtype, device=dev) if t0 is None else as_t(t0),
    )


class AcceleratingScenario(NamedTuple):
    """Constant nav-frame acceleration + constant body rotation rate
    (Scenario.h AcceleratingScenario)."""

    R0: torch.Tensor
    t0: torch.Tensor
    v0: torch.Tensor  # [3] initial nav velocity
    a_n: torch.Tensor  # [3] constant nav acceleration
    w_b: torch.Tensor  # [3] constant body angular velocity

    def rotation(self, t):
        return self.R0 @ so3.expmap(self.w_b * _times(t, self.w_b))

    def position(self, t):
        tt = _times(t, self.v0)
        return self.t0 + self.v0 * tt + 0.5 * self.a_n * tt * tt

    def velocity_n(self, t):
        return self.v0 + self.a_n * _times(t, self.v0)

    def omega_b(self, t):
        return self.w_b.expand(_times(t, self.w_b).shape[:-1] + (3,))

    def acceleration_n(self, t):
        return self.a_n.expand(_times(t, self.a_n).shape[:-1] + (3,))

    def nav_state(self, t) -> NavState:
        return NavState(self.rotation(t), self.position(t), self.velocity_n(t))


class ScenarioRunner:
    """Generate IMU measurements from a scenario; integrate and validate.

    measured_omega = omega_b + gyro bias (+ noise)
    measured_acc   = R^T (a_n - g) + accel bias (+ noise)   [specific force]
    (ScenarioRunner.h:52-90). Tensors live on the device of params.n_gravity.
    """

    def __init__(self, scenario, params: pre.PreintegrationParams, dt: float,
                 bias=None):
        self.scenario = scenario
        self.params = params
        self.dt = float(dt)
        g = params.n_gravity
        self.bias = (
            torch.zeros(6, dtype=g.dtype, device=g.device) if bias is None
            else _as(bias, g)
        )

    def actual_specific_force(self, t):
        R = self.scenario.rotation(t)
        return so3.unrotate(R, self.scenario.acceleration_n(t) - self.params.n_gravity)

    def measured_series(self, T: float, rng: np.random.Generator | None = None):
        """Sample times + (acc, omega, dt) arrays over [0, T): [n, 3], [n, 3],
        [n]. With `rng`, the accelerometer's noise is drawn first, then the
        gyroscope's, as in the JAX package: one seed, the same samples."""
        g = self.params.n_gravity
        n = int(round(T / self.dt))
        ts = torch.as_tensor(np.arange(n) * self.dt).to(g)
        acc = self.actual_specific_force(ts) + self.bias[:3]
        omega = self.scenario.omega_b(ts) + self.bias[3:]
        if rng is not None:
            # discrete-time noise: sigma/sqrt(dt)
            sa = float(np.sqrt(float(self.params.accel_cov[0, 0]) / self.dt))
            sw = float(np.sqrt(float(self.params.gyro_cov[0, 0]) / self.dt))
            acc = acc + torch.as_tensor(rng.normal(size=(n, 3)) * sa).to(acc)
            omega = omega + torch.as_tensor(rng.normal(size=(n, 3)) * sw).to(omega)
        dts = torch.full((n,), self.dt, dtype=acc.dtype, device=acc.device)
        return acc, omega, dts

    def integrate(self, T: float, bias_hat=None, rng=None) -> pre.PIM:
        acc, omega, dts = self.measured_series(T, rng)
        return pre.preintegrate(self.params, acc, omega, dts, bias_hat)

    def predict(self, pim: pre.PIM, initial: NavState, bias_hat=None) -> NavState:
        b = torch.zeros_like(pim.bias_hat) if bias_hat is None else bias_hat
        return pre.predict(pim, self.params, initial, b)

    def estimate_covariance(self, T: float, runs: int, initial: NavState,
                            seed: int = 0):
        """Monte-Carlo covariance of the predicted nav state (the reference's
        ScenarioRunner::estimateCovariance oracle)."""
        rng = np.random.default_rng(seed)
        samples = []
        clean = self.predict(self.integrate(T), initial)
        for _ in range(runs):
            pim = self.integrate(T, rng=rng)
            s = self.predict(pim, initial)
            samples.append(ns_local(clean, s).cpu().numpy())
        X = np.stack(samples)
        X = X - X.mean(axis=0)
        return X.T @ X / (len(samples) - 1)
