"""Smart projection factors: structureless bundle adjustment.

Port of gtsam_petercdev_tpu/slam/smart.py. Reference:
gtsam/slam/SmartFactorBase.h:51-309 (stacked F, E, b per track),
SmartProjectionFactor.h:44-332 (on-demand triangulateSafe + linearize),
geometry/CameraSet.h:175-241 (SchurComplement building the m*6+1 reduced
camera Hessian per landmark).

All tracks share one fixed max-views M with a validity mask, so
triangulation, Jacobians and the per-track Schur complement are each one
batched call over [T, M]. Degenerate / behind-camera / outlier tracks are
zero-weighted (the analog of the reference's degeneracy modes,
SmartProjectionFactor.h:128-196) rather than raising. The per-view
Jacobians F (pose, 6 columns) and E (point, 3 columns) are analytic: at
xi = 0 the camera-frame point q = R^T (p - t) moves by [q]_x omega - v.

The linearized output is the reduced camera system contribution:
  H_cc[(a,b)] += delta_ab F_a^T F_a - W_a P W_b^T      (per track, per view pair)
  g_c[a]     += F_a^T b_a - W_a P (sum_m E_m^T b_m)
which `smart_levenberg_marquardt` adds into the dense camera Hessian
alongside any regular camera-only factors (priors, between factors). The
dense sums (`index_put_(accumulate=True)`, atomics on the card) have no
exact-zero branch downstream, so card and CPU agree within rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core.tree import tree_leaves, tree_map
from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.geometry import cal3, so3, triangulation
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass(frozen=True)
class SmartProjectionParams:
    """slam/SmartFactorParams.h (linearization mode HESSIAN — the
    Schur-complement mode; IMPLICIT_SCHUR is the matrix-free `smart_pcg`
    path)."""

    triangulation: triangulation.TriangulationParameters = (
        triangulation.TriangulationParameters()
    )
    retriangulate: bool = True
    sigma: float = 1.0  # isotropic pixel noise


@dataclass
class SmartProjectionFactorBatch:
    """T tracks, each observed by up to M cameras (masked).

    cam_rows: [T, M] int32 rows into the camera type batch (host)
    mask:     [T, M] bool — view validity (host)
    measured: [T, M, 2] pixel measurements (its device is the batch's)
    cal:      calibration bank [C, 5] (Cal3_S2 rows); C == 1 is the shared
              single-camera case, C > 1 the multi-camera RIG
              (slam/SmartProjectionRigFactor.h:49 — fixed per-camera K)
    cal_rows: [T, M] int32 row of `cal` used by each view (all-zero default)
    stereo:   measured [T, M, 3] = (uL, uR, v), cal rows [C, 6] =
              Cal3_S2Stereo (fx fy s u0 v0 baseline)
              (gtsam_unstable/slam/SmartStereoProjectionFactor.h:55)
    """

    cam_rows: np.ndarray
    mask: np.ndarray
    measured: torch.Tensor
    cal: torch.Tensor
    params: SmartProjectionParams = field(default_factory=SmartProjectionParams)
    cal_rows: Optional[np.ndarray] = None
    stereo: bool = False
    # the host index arrays on the batch's device, uploaded once
    rows_dev: torch.Tensor = field(init=False, repr=False)
    mask_dev: torch.Tensor = field(init=False, repr=False)
    cals_dev: torch.Tensor = field(init=False, repr=False)  # [T, M, 5|6] per-view K

    def __post_init__(self):
        if self.cal.ndim == 1:
            self.cal = self.cal[None, :]
        if self.cal_rows is None:
            self.cal_rows = np.zeros(self.cam_rows.shape, dtype=np.int32)
        dev = self.measured.device
        up = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)
        self.rows_dev = up(self.cam_rows)
        self.mask_dev = torch.as_tensor(np.asarray(self.mask, dtype=bool)).to(dev)
        self.cals_dev = self.cal[up(self.cal_rows)]

    @property
    def n_tracks(self) -> int:
        return self.cam_rows.shape[0]

    @property
    def max_views(self) -> int:
        return self.cam_rows.shape[1]


def from_tracks(
    tracks: List[List[Tuple[int, np.ndarray]]],
    cal,
    params: Optional[SmartProjectionParams] = None,
    dtype=None,
    cal_of_cam=None,
    stereo: bool = False,
    *,
    device: DeviceLike = "cuda",
) -> SmartProjectionFactorBatch:
    """Build a batch from per-track (camera_row, uv) observation lists.

    cal_of_cam: optional {camera_row: cal_row} for rig configurations.
    stereo=True: observations are (uL, uR, v) and cal rows are
    Cal3_S2Stereo [fx fy s u0 v0 b] (SmartStereoProjectionFactor)."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    T = len(tracks)
    M = max(len(t) for t in tracks)
    zdim = 3 if stereo else 2
    cam_rows = np.zeros((T, M), dtype=np.int32)
    mask = np.zeros((T, M), dtype=bool)
    measured = np.zeros((T, M, zdim))
    cal_rows = np.zeros((T, M), dtype=np.int32)
    for j, t in enumerate(tracks):
        for m, (ci, uv) in enumerate(t):
            cam_rows[j, m] = ci
            mask[j, m] = True
            measured[j, m] = np.asarray(uv)
            if cal_of_cam is not None:
                cal_rows[j, m] = cal_of_cam[ci]
    cal = cal if torch.is_tensor(cal) else torch.as_tensor(np.asarray(cal))
    return SmartProjectionFactorBatch(
        cam_rows, mask, torch.as_tensor(measured).to(dev, dt), cal.to(dev, dt),
        params or SmartProjectionParams(), cal_rows, stereo=stereo)


def gather_poses(batch: SmartProjectionFactorBatch, poses: Pose3) -> Pose3:
    """The camera batch's poses [n_cams, ...] at each view: leaves [T, M, ...]."""
    return tree_map(lambda a: a[batch.rows_dev], poses)


def _track_terms(batch: SmartProjectionFactorBatch, poses: Pose3):
    """Per-track triangulation + whitened F, E, b stacks.

    poses: gathered Pose3 leaves [T, M, ...].
    Returns (F [T,M,z,6], E [T,M,z,3], b [T,M,z], valid [T]), z = 2 (3 stereo)."""
    sigma = batch.params.sigma
    cals = batch.cals_dev
    uv = batch.measured
    m = batch.mask_dev
    dtype = uv.dtype
    # triangulate from the left-camera rays (stereo: uL, v)
    uv_mono = torch.stack([uv[..., 0], uv[..., -1]], dim=-1) if batch.stereo else uv
    pn_meas = cal3.cal3_s2_calibrate(cals[..., :5], uv_mono)
    res = triangulation.triangulate_safe(poses, pn_meas, m, batch.params.triangulation,
                                         optimize=True)
    p = res.point
    valid = res.status == triangulation.VALID

    Rt = poses.R.transpose(-1, -2)
    q = so3.unrotate(poses.R, p[..., None, :] - poses.t)  # [T, M, 3] camera frame
    z = q[..., 2]
    small = z.abs() < (1e-8 if batch.stereo else 1e-9)  # the clamped depth: no d/dz
    zs = torch.where(small, torch.full_like(z, 1e-8 if batch.stereo else 1e-9), z)
    dz = torch.where(small, torch.zeros_like(z), -1.0 / (zs * zs))
    zero = torch.zeros_like(z)
    # dq/dxi at xi = 0 (xi = (omega, v)): [[q]_x | -I]; dq/dp = R^T
    dq_dxi = torch.cat([so3.hat(q), -torch.eye(3, dtype=dtype, device=q.device).expand_as(Rt)],
                       dim=-1)
    if batch.stereo:
        fx, fy, u0, v0, bl = (cals[..., i] for i in (0, 1, 3, 4, 5))
        pn = torch.stack([u0 + fx * q[..., 0] / zs, u0 + fx * (q[..., 0] - bl) / zs,
                          v0 + fy * q[..., 1] / zs], dim=-1)
        Dq = torch.stack([
            torch.stack([fx / zs, zero, fx * q[..., 0] * dz], -1),
            torch.stack([fx / zs, zero, fx * (q[..., 0] - bl) * dz], -1),
            torch.stack([zero, fy / zs, fy * q[..., 1] * dz], -1)], -2)
        b = uv - pn  # pixel-space residual
        f_eff = torch.ones_like(z)
    else:
        pn = q[..., :2] / zs[..., None]
        Dq = torch.stack([torch.stack([1.0 / zs, zero, q[..., 0] * dz], -1),
                          torch.stack([zero, 1.0 / zs, q[..., 1] * dz], -1)], -2)
        b = pn_meas - pn
        # whiten per view: normalized-coord noise = sigma / focal
        f_eff = 0.5 * (cals[..., 0] + cals[..., 1])
    F = Dq @ dq_dxi
    E = Dq @ Rt
    w = (f_eff / sigma) * m.to(dtype)
    return F * w[..., None, None], E * w[..., None, None], b * w[..., None], valid


def _point_cov(E, lam=0.0):
    Hpp = torch.einsum("tmdi,tmdj->tij", E, E)
    eye3 = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.linalg.inv(Hpp + (1e-9 + lam) * eye3)  # [T, 3, 3]


def schur_contributions(batch: SmartProjectionFactorBatch, poses: Pose3, lam=0.0):
    """Reduced camera-system pieces per track (CameraSet::SchurComplement).

    Returns (Hblocks [T,M,M,6,6], gblocks [T,M,6], total_err scalar).
    Invalid tracks contribute zero."""
    F, E, b, valid = _track_terms(batch, poses)
    dtype = b.dtype
    vw = valid.to(dtype)[:, None, None]
    P = _point_cov(E, lam)
    W = torch.einsum("tmdi,tmdj->tmij", F, E)  # [T,M,6,3]
    gp = torch.einsum("tmdi,tmd->ti", E, b)  # [T,3]
    Fb = torch.einsum("tmdi,tmd->tmi", F, b)  # [T,M,6]
    WPgp = torch.einsum("tmij,tjk,tk->tmi", W, P, gp)
    gblocks = (Fb - WPgp) * vw
    FtF = torch.einsum("tmdi,tmdj->tmij", F, F)  # diag blocks [T,M,6,6]
    WPWt = torch.einsum("taij,tjk,tblk->tabil", W, P, W)  # [T,M,M,6,6]
    eyeM = torch.eye(batch.max_views, dtype=dtype, device=b.device)
    diag = torch.einsum("ab,taij->tabij", eyeM, FtF)
    Hblocks = (diag - WPWt) * vw[..., None, None]
    err = 0.5 * torch.sum((b * valid.to(dtype)[:, None, None]) ** 2)
    return Hblocks, gblocks, err


def total_error(batch: SmartProjectionFactorBatch, poses: Pose3) -> torch.Tensor:
    """Sum of whitened reprojection errors at the triangulated points
    (SmartProjectionFactor::totalReprojectionError)."""
    _, _, b, valid = _track_terms(batch, poses)
    return 0.5 * torch.sum((b * valid.to(b.dtype)[:, None, None]) ** 2)


def assemble_camera_system(batch: SmartProjectionFactorBatch, poses: Pose3, n_cams: int,
                           lam=0.0):
    """Add the track contributions into the dense camera (H, g)."""
    Hb, gb, err = schur_contributions(batch, poses, 0.0)
    D = n_cams * 6
    H = torch.zeros((D, D), dtype=gb.dtype, device=gb.device)
    g = torch.zeros((D,), dtype=gb.dtype, device=gb.device)
    gidx = batch.rows_dev[..., None] * 6 + torch.arange(6, device=gb.device)  # [T,M,6]
    g.index_put_((gidx,), gb, accumulate=True)
    ga = gidx[:, :, None, :, None].expand(Hb.shape)
    gb2 = gidx[:, None, :, None, :].expand(Hb.shape)
    H.index_put_((ga, gb2), Hb, accumulate=True)
    return H, g, err


# ---------------------------------------------------------------------------
# IMPLICIT_SCHUR: matrix-free reduced-camera operator
# ---------------------------------------------------------------------------


def implicit_schur_terms(batch: SmartProjectionFactorBatch, poses: Pose3, lam=0.0):
    """The per-track pieces the implicit operator needs
    (RegularImplicitSchurFactor.h:39): the reduced camera Hessian
    H = F^T F - W P W^T is never formed; products stream through the
    factored pieces (O(T M) memory instead of O(T M^2))."""
    F, E, b, valid = _track_terms(batch, poses)
    return dict(F=F, E=E, b=b, P=_point_cov(E, lam), vw=valid.to(b.dtype))


def _add_rows(cam_rows, blocks, n_cams: int) -> torch.Tensor:
    """Per-view blocks [T, M, ...] summed into their cameras: [n_cams, ...]."""
    out = blocks.new_zeros((n_cams,) + tuple(blocks.shape[2:]))
    return out.index_put_((torch.as_tensor(cam_rows).to(blocks.device),), blocks,
                          accumulate=True)


def implicit_schur_hvp(terms, cam_rows, v6, n_cams: int):
    """(F^T F - W P W^T) v, matrix-free (multiplyHessianAdd analog,
    RegularImplicitSchurFactor.h:231). v6: [n_cams, 6]."""
    F, E, P, vw = terms["F"], terms["E"], terms["P"], terms["vw"]
    vt = v6[torch.as_tensor(cam_rows).to(v6.device)]  # [T, M, 6]
    Fv = torch.einsum("tmdi,tmi->tmd", F, vt)
    # point back-substitution: e = P E^T (F v)
    e = torch.einsum("tij,tj->ti", P, torch.einsum("tmdi,tmd->ti", E, Fv))
    # y = F^T (F v - E e)
    r = Fv - torch.einsum("tmdi,ti->tmd", E, e)
    yt = torch.einsum("tmdi,tmd->tmi", F, r) * vw[:, None, None]
    return _add_rows(cam_rows, yt, n_cams)


def implicit_schur_gradient(terms, cam_rows, n_cams: int):
    """g = F^T b - W P E^T b (the reduced-system right-hand side)."""
    F, E, b, P, vw = terms["F"], terms["E"], terms["b"], terms["P"], terms["vw"]
    e = torch.einsum("tij,tj->ti", P, torch.einsum("tmdi,tmd->ti", E, b))
    r = b - torch.einsum("tmdi,ti->tmd", E, e)
    gt = torch.einsum("tmdi,tmd->tmi", F, r) * vw[:, None, None]
    return _add_rows(cam_rows, gt, n_cams)


def implicit_schur_block_diag(terms, cam_rows, n_cams: int):
    """Per-camera 6x6 diagonal blocks of the reduced Hessian (the
    block-Jacobi preconditioner; hessianDiagonal analog)."""
    F, E, P, vw = terms["F"], terms["E"], terms["P"], terms["vw"]
    FtF = torch.einsum("tmdi,tmdj->tmij", F, F)
    W = torch.einsum("tmdi,tmdj->tmij", F, E)  # [T, M, 6, 3]
    WPWt = torch.einsum("tmij,tjk,tmlk->tmil", W, P, W)
    return _add_rows(cam_rows, (FtF - WPWt) * vw[:, None, None, None], n_cams)


def smart_pcg(batch: SmartProjectionFactorBatch, poses: Pose3, n_cams: int, lam=0.0,
              tol: float = 1e-10, max_iters: int = 200):
    """Matrix-free PCG on the implicit Schur system (IMPLICIT_SCHUR mode with
    an iterative solve: RegularImplicitSchurFactor + PCGSolver), block-Jacobi
    preconditioned. JAX's `lax.while_loop` stopping rule, each test one
    device -> host read. Returns delta [n_cams, 6]."""
    terms = implicit_schur_terms(batch, poses, 0.0)
    rows = batch.rows_dev
    g = implicit_schur_gradient(terms, rows, n_cams)
    blocks = implicit_schur_block_diag(terms, rows, n_cams)
    eye6 = torch.eye(6, dtype=g.dtype, device=g.device)
    Minv = torch.linalg.inv(blocks + (lam + 1e-9) * eye6)

    def A(v):
        return {"c": implicit_schur_hvp(terms, rows, v["c"], n_cams) + lam * v["c"]}

    def apply_Minv(r):
        return {"c": torch.einsum("nij,nj->ni", Minv, r["c"])}

    return linsolve.pcg(A, {"c": g}, apply_Minv, tol=tol, max_iters=max_iters)["c"]


# ---------------------------------------------------------------------------
# JACOBIAN_Q / JACOBIAN_SVD linearization modes
# ---------------------------------------------------------------------------


def _projector(E, P):
    """Q = I - E P E^T over the flattened (view, coord) rows: [T, zM, zM]."""
    T, M, zd = E.shape[0], E.shape[1], E.shape[2]
    Ef = E.reshape(T, M * zd, 3)
    eye = torch.eye(M * zd, dtype=E.dtype, device=E.device)
    return eye[None] - torch.einsum("tri,tij,tsj->trs", Ef, P, Ef)


def _view_block_expand(F):
    """[T, M, z, 6] -> [T, M*z, M, 6] with view-block structure (row r of
    view m occupies block column m only)."""
    T, M, zd = F.shape[0], F.shape[1], F.shape[2]
    eye = torch.eye(M, dtype=F.dtype, device=F.device)
    return torch.einsum("tmdk,mn->tmdnk", F, eye).reshape(T, M * zd, M, 6)


def jacobian_q_factors(batch: SmartProjectionFactorBatch, poses: Pose3):
    """JACOBIAN_Q mode (SmartFactorBase.h createJacobianQFactor /
    JacobianFactorQ.h): the stacked view system projected through
    Q = I - E P E^T so the landmark drops out. Returns the whitened
    (A [T, M*2, M, 6], b [T, M*2]); Q is idempotent and symmetric, so
    A^T A reproduces the Schur-complement Hessian exactly."""
    F, E, b, valid = _track_terms(batch, poses)
    T, M = F.shape[0], F.shape[1]
    Q = _projector(E, _point_cov(E))
    vw = valid.to(b.dtype)
    A = torch.einsum("trs,tsmk->trmk", Q, _view_block_expand(F))
    bq = torch.einsum("trs,ts->tr", Q, b.reshape(T, -1))
    return A * vw[:, None, None, None], bq * vw[:, None]


def jacobian_svd_factors(batch: SmartProjectionFactorBatch, poses: Pose3):
    """JACOBIAN_SVD mode (JacobianFactorSVD.h): an explicit rank-(2M-3)
    basis of null(E^T) from the eigendecomposition of the projector Q (its
    eigenvalues are 0 or 1). Returns (A [T, 2M-3, M, 6], b [T, 2M-3]), the
    information of JACOBIAN_Q in the fewest rows. The basis of a repeated
    eigenvalue is not unique: A is, up to an orthogonal map; A^T A and
    A^T b are unique."""
    F, E, b, valid = _track_terms(batch, poses)
    T, M = F.shape[0], F.shape[1]
    Q = _projector(E, _point_cov(E))
    _, V = triangulation.eigh_batched(Q)  # ascending eigenvalues
    k = M * 2 - 3
    basis = V[:, :, -k:]  # [T, 2M, k]
    Ab = torch.einsum("trk,trs->tks", basis, _view_block_expand(F).reshape(T, M * 2, M * 6))
    bs = torch.einsum("trk,tr->tk", basis, b.reshape(T, M * 2))
    vw = valid.to(b.dtype)
    return Ab.reshape(T, k, M, 6) * vw[:, None, None, None], bs * vw[:, None]


def smart_levenberg_marquardt(
    graph: NonlinearFactorGraph,
    smart: SmartProjectionFactorBatch,
    values: Values,
    params: Optional[optimizers.LMParams] = None,
    cam_type: str = "Pose3",
    *,
    device: DeviceLike = "cuda",
) -> optimizers.OptimizerResult:
    """LM over camera poses only: regular factors + the smart factors'
    dense Schur system (the SFMExample_SmartFactor pipeline)."""
    dev = resolve_device(device)
    for what, d in (("graph", graph.device), ("values", values.device),
                    ("smart factors", smart.measured.device)):
        if d.type != dev.type:
            raise ValueError(f"{what} is on {d}, optimizer asked for {dev}")
    params = params or optimizers.LMParams()
    graph._materialize()
    n_cams = tree_leaves(values.params(cam_type))[0].shape[0]

    def err_fn(values_in: Values):
        return total_error(smart, gather_poses(smart, values_in.params(cam_type))) \
            + graph.error(values_in)

    def assemble_fn(values_in: Values):
        H, g, _ = assemble_camera_system(smart, gather_poses(smart, values_in.params(cam_type)),
                                         n_cams)
        if graph.batches:
            H2, g2 = linsolve.assemble_dense(graph.linearize(values_in))
            H, g = H + H2, g + g2
        return H, g

    def solve_fn(H, g, lam):
        x = linsolve.dense_solve(H, g, lam, diagonal_damping=params.diagonal_damping)
        return x, torch.dot(g, x) - 0.5 * torch.dot(x, H @ x)

    err = float(err_fn(values))
    history = [err]
    lam = params.lambda_initial
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        H, g = assemble_fn(values)
        accepted = False
        for _ in range(params.max_try_iterations):
            x, lin_dec = solve_fn(H, g, lam)
            lin_dec = float(lin_dec)
            new_values = values.retract({cam_type: x.reshape(n_cams, 6)})
            # a failed factorization leaves x (and lin_dec) NaN: the step's
            # error is NaN, as in the JAX package, and the trial is rejected
            new_err = float(err_fn(new_values)) if math.isfinite(lin_dec) else math.nan
            rho = (err - new_err) / max(lin_dec, 1e-30)
            if err - new_err > 0 and rho >= params.min_model_fidelity:
                values = new_values
                lam = max(lam / params.lambda_factor, params.lambda_lower_bound)
                accepted = True
                break
            lam *= params.lambda_factor
            if lam > params.lambda_upper_bound:
                break
        if not accepted:
            converged = True
            break
        history.append(new_err)
        if optimizers.check_convergence(params, err, new_err):
            err = new_err
            converged = True
            break
        err = new_err
    return optimizers.OptimizerResult(values, err, it, converged, history)
