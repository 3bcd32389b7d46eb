"""Bundle adjustment in BAL's camera model (PinholeCamera<Cal3Bundler>),
GTSAM's GeneralSFMFactor and PriorFactor semantics, solved by a plain point
Schur complement with a dense camera system.

Camera: camera-to-world R, centre t, (f, k1, k2); chart: the pose's
(R, t) Exp(omega, v) and the calibration added. Projection: q = R^T (p - t),
(x, y) = q_xy / q_z, uv = f (1 + k1 r + k2 r^2) (x, y) with r = x^2 + y^2;
residual uv - measured, zero (residual and Jacobian) where q_z <= 0.
Priors (on camera 0 and point `prior_point`): r = -Local(x, prior),
Jacobian I. Observations are listed point by point, every point seen at
least once (the generator's tracks are)."""

from __future__ import annotations

import numpy as np
import torch

from sam_bench.reference import lie


class Problem:
    def __init__(self, arrays: dict, device, dtype):
        T = lambda a: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)
        I = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(device)
        self.device, self.dtype = device, dtype
        self.start = (T(arrays["R"]), T(arrays["t"]), T(arrays["cal"]), T(arrays["points"]))
        self.cam, self.pt = I(arrays["obs_cam"]), I(arrays["obs_pt"])
        self.uv = T(arrays["uv"])
        self.w = 1.0 / float(arrays["pixel_sigma"])
        self.wp = 1.0 / float(arrays["prior_sigma"])
        self.prior_cam = tuple(a[:1].clone() for a in self.start[:3])
        self.pp = int(arrays["prior_point"])
        self.prior_pt = self.start[3][self.pp:self.pp + 1].clone()
        self.C, self.P = len(self.start[0]), len(self.start[3])
        counts = torch.bincount(self.pt, minlength=self.P)
        if bool((self.pt[1:] < self.pt[:-1]).any()) or bool((counts == 0).any()):
            raise ValueError("ba reference: observations must come point by point")
        # the observations of the points seen m times, as [points, m] rows
        first = torch.cumsum(counts, 0) - counts
        self.tracks = [first[counts == m][:, None] + torch.arange(m, device=device)
                       for m in sorted(set(counts.tolist()))]

    def _project(self, state):
        R, t, cal, p = state
        Rc = R[self.cam]
        q = (Rc.transpose(-1, -2) @ (p[self.pt] - t[self.cam])[..., None])[..., 0]
        z = q[:, 2]
        front = z > 0
        zs = torch.where(front, z, torch.ones_like(z))
        xy = q[:, :2] / zs[:, None]
        f, k1, k2 = cal[self.cam].unbind(-1)
        r = (xy * xy).sum(-1)
        g = 1.0 + (k1 + k2 * r) * r
        uv = (f * g)[:, None] * xy
        return Rc, q, zs, xy, f, k1, k2, r, g, uv, front

    def _prior_residuals(self, state):
        R, t, cal, p = state
        rc = -torch.cat([lie.se3_log(*lie.between(R[:1], t[:1], *self.prior_cam[:2])),
                         self.prior_cam[2] - cal[:1]], -1)
        return rc, p[self.pp:self.pp + 1] - self.prior_pt

    def error(self, state):
        *_, uv, front = self._project(state)
        r = torch.where(front[:, None], uv - self.uv, torch.zeros_like(uv)) * self.w
        rc, rp = self._prior_residuals(state)
        return 0.5 * (r * r).sum() + 0.5 * self.wp ** 2 * ((rc * rc).sum() + (rp * rp).sum())

    def linearize(self, state):
        Rc, q, zs, xy, f, k1, k2, r, g, uv, front = self._project(state)
        x, y = xy.unbind(-1)
        gp = k1 + 2.0 * k2 * r
        D = torch.stack([torch.stack([g + 2 * x * x * gp, 2 * x * y * gp], -1),
                         torch.stack([2 * x * y * gp, g + 2 * y * y * gp], -1)], -2) * f[:, None, None]
        z0 = torch.zeros_like(zs)
        Pn = torch.stack([torch.stack([1 / zs, z0, -x / zs], -1),
                          torch.stack([z0, 1 / zs, -y / zs], -1)], -2)
        DP = D @ Pn  # d uv / d q   [N, 2, 3]
        eye = torch.eye(3, dtype=self.dtype, device=self.device).expand_as(Rc)
        dcal = torch.stack([g[:, None] * xy, (f * r)[:, None] * xy,
                            (f * r * r)[:, None] * xy], -1)  # [N, 2, 3]
        F = torch.cat([DP @ lie.hat(q), -DP, dcal], -1)  # camera [N, 2, 9]
        E = DP @ Rc.transpose(-1, -2)  # point [N, 2, 3]
        m = (front[:, None, None] * self.w).to(self.dtype)
        F, E = F * m, E * m
        b = -torch.where(front[:, None], uv - self.uv, torch.zeros_like(uv)) * self.w
        rc, rp = self._prior_residuals(state)
        return dict(F=F, E=E, b=b, bc=-self.wp * rc[0], bp=-self.wp * rp[0])

    def solve(self, lin, lam):
        F, E, b = lin["F"], lin["E"], lin["b"]
        C, P, dt, dev = self.C, self.P, self.dtype, self.device
        eye3 = torch.eye(3, dtype=dt, device=dev)
        Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev)
        Hpp.index_add_(0, self.pt, E.transpose(-1, -2) @ E)
        Hpp[self.pp] += self.wp ** 2 * eye3
        Hpp = Hpp + lam * eye3
        gp = torch.zeros((P, 3), dtype=dt, device=dev)
        gp.index_add_(0, self.pt, (E.transpose(-1, -2) @ b[..., None])[..., 0])
        gp[self.pp] += self.wp * lin["bp"]
        gc = torch.zeros((C, 9), dtype=dt, device=dev)
        gc.index_add_(0, self.cam, (F.transpose(-1, -2) @ b[..., None])[..., 0])
        gc[0] += self.wp * lin["bc"]
        Hinv = torch.linalg.inv(Hpp)
        W = F.transpose(-1, -2) @ E  # [N, 9, 3]
        WH = W @ Hinv[self.pt]  # W Hpp^-1
        # reduced camera matrix: diagonal blocks F^T F, minus W Hpp^-1 W^T
        # over every ordered pair of observations of one point
        blocks = torch.zeros((C * C, 9, 9), dtype=dt, device=dev)
        blocks.index_add_(0, self.cam * C + self.cam, F.transpose(-1, -2) @ F)
        for rows in self.tracks:
            Wp, cp = W[rows], self.cam[rows]
            for k in range(rows.shape[1]):
                contrib = WH[rows[:, k], None] @ Wp.transpose(-1, -2)  # [points, m, 9, 9]
                blocks.index_add_(0, (cp[:, k, None] * C + cp).reshape(-1),
                                  -contrib.reshape(-1, 9, 9))
                del contrib
        S = blocks.view(C, C, 9, 9).permute(0, 2, 1, 3).reshape(9 * C, 9 * C)
        del blocks
        S.diagonal().add_(lam)
        S[:9, :9] += self.wp ** 2 * torch.eye(9, dtype=dt, device=dev)
        g_red = gc.clone()
        g_red.index_add_(0, self.cam, -(WH @ gp[self.pt][..., None])[..., 0])
        L, info = torch.linalg.cholesky_ex(S)
        del S
        xc = torch.cholesky_solve(g_red.reshape(-1, 1), L).reshape(C, 9)
        del L
        rhs = gp.clone()
        rhs.index_add_(0, self.pt, -(W.transpose(-1, -2) @ xc[self.cam][..., None])[..., 0])
        xp = (Hinv @ rhs[..., None])[..., 0]
        # cost decrease of the undamped linear model: b.(J x) - 0.5 |J x|^2
        Jx = (F @ xc[self.cam][..., None] + E @ xp[self.pt][..., None])[..., 0]
        Jc, Jp = self.wp * xc[0], self.wp * xp[self.pp]
        dec = (b * Jx).sum() - 0.5 * (Jx * Jx).sum() + (lin["bc"] * Jc).sum() \
            - 0.5 * (Jc * Jc).sum() + (lin["bp"] * Jp).sum() - 0.5 * (Jp * Jp).sum()
        return (xc, xp), dec, int(info) == 0

    def retract(self, state, delta):
        R, t, cal, p = state
        xc, xp = delta
        R2, t2 = lie.retract(R, t, xc[:, :6])
        return R2, t2, cal + xc[:, 6:], p + xp

    def leaves(self, state) -> dict:
        return dict(zip(("R", "t", "cal", "points"), state))
