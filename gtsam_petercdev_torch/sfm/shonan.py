"""Shonan rotation averaging: certifiably-optimal SO(3) synchronization.

Port of gtsam_petercdev_tpu/sfm/shonan.py. Reference:
gtsam/sfm/ShonanAveraging.{h,cpp}:123-438 — the Riemannian staircase: at
each rank p >= 3, optimize the lifted problem over SO(p) (ShonanFactor =
Frobenius norm between lifted rotations), then check global optimality
with the minimum eigenvalue of the dual certificate matrix S = L - Lambda
(PowerMethod.h); if certified, round the solution back to SO(3)
(roundSolutionS).

Each staircase level is a batched LM solve over a registered SO(p) manifold
(tangent p(p-1)/2, retract Q expm(hat(xi)) with a fixed scaling-and-
squaring series, the JAX package's, so the numbers follow it); the Shonan
factor has no analytic Jacobian and is linearized by forward mode over the
whole batch. The certificate's min-eigenvalue is a matrix-free shifted
power iteration over the edge list (two `index_add_` a matvec); on the
card its loop reads nothing back until it ends.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import so3
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


# --- SO(p) manifold (registered per staircase level) -------------------------


@lru_cache(maxsize=None)
def _son_generators(p: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[p(p-1)/2, p, p] skew generators E_rc - E_cr, (r<c) row-major, made
    once per (p, dtype, device)."""
    rows, cols = np.triu_indices(p, k=1)
    B = np.zeros((len(rows), p, p))
    k = np.arange(len(rows))
    B[k, rows, cols] = 1.0
    B[k, cols, rows] = -1.0
    return torch.as_tensor(B, dtype=dtype).to(device)


def _son_hat(xi: torch.Tensor, p: int) -> torch.Tensor:
    """[..., p(p-1)/2] -> skew [..., p, p]; basis ordered (i<j) row-major.
    A contraction with the generators (each entry one xi_k times +-1), which
    forward mode differentiates without in-place writes."""
    return torch.einsum("...k,kij->...ij", xi, _son_generators(p, xi.dtype, xi.device))


def _son_vee(S: torch.Tensor, p: int) -> torch.Tensor:
    rows, cols = np.triu_indices(p, k=1)
    return S[..., rows, cols]


def _expm_series(S: torch.Tensor, squarings: int = 8, terms: int = 7) -> torch.Tensor:
    """Batched, everywhere-differentiable matrix exponential by fixed
    scaling-and-squaring + Taylor (p is tiny: matmuls only). Error ~
    (||S||/2^s)^terms / terms! — negligible for ||S|| <~ 10."""
    T = S / (2.0**squarings)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device).expand(S.shape)
    out = eye
    term = eye
    for k in range(1, terms + 1):
        term = (term @ T) / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def register_son(p: int) -> str:
    """Register SO(p) as a manifold type 'SOn{p}' (params [p, p])."""
    name = f"SOn{p}"
    if name in manifold.registered():
        return name
    dim = p * (p - 1) // 2

    def retract(Q, xi):
        return Q @ _expm_series(_son_hat(xi, p))

    def local(Q1, Q2):
        # the first-order skew part of log(Q1^T Q2), as the JAX package
        # documents it (adequate for convergence checks; LM uses retract)
        M = Q1.transpose(-1, -2) @ Q2
        S = 0.5 * (M - M.transpose(-1, -2))
        return _son_vee(S, p)

    def identity(dtype=torch.float64, device="cuda"):
        return torch.eye(p, dtype=dtype, device=resolve_device(device))

    manifold.register(
        manifold.ManifoldType(name=name, dim=dim, retract=retract, local=local, identity=identity)
    )
    return name


# --- measurements ------------------------------------------------------------


@dataclass
class ShonanMeasurements:
    """Edge list (i, j, R_ij, kappa): R_j ~ R_i R_ij with concentration kappa
    (BinaryMeasurement<Rot3> with isotropic Langevin noise). i, j host-side;
    R and kappa on the device the staircase runs on."""

    i: np.ndarray  # [E]
    j: np.ndarray  # [E]
    R: torch.Tensor  # [E, 3, 3]
    kappa: torch.Tensor  # [E]

    @property
    def num_edges(self) -> int:
        return len(self.i)

    @property
    def num_nodes(self) -> int:
        return int(max(self.i.max(), self.j.max())) + 1


def measurements_from_between_graph(graph: NonlinearFactorGraph) -> ShonanMeasurements:
    """Rotation measurements from BetweenPose3 factors
    (ShonanAveraging::makeNoiseModelRobust / extractRotations), on the
    graph's device."""
    graph._materialize()
    iks, jks, Rs, ks = [], [], [], []
    for b in graph.batches:
        if b.ftype.name.startswith("BetweenPose3"):
            iks.append(b.keys[:, 0].astype(np.int64))
            jks.append(b.keys[:, 1].astype(np.int64))
            Rs.append(b.params.R)
            # kappa from the rotation block of sqrt_info (approximate:
            # mean squared row norm of the first 3 rows)
            si = b.sqrt_info[:, :3, :3]
            ks.append(torch.mean(torch.sum(si * si, dim=-1), dim=-1))
    return ShonanMeasurements(
        np.concatenate(iks), np.concatenate(jks), torch.cat(Rs, dim=0), torch.cat(ks, dim=0)
    )


# --- lifted optimization at level p ------------------------------------------


def _shonan_factor(p: int) -> FactorType:
    """vec(M_j - M_i R_ij), M = Q[:, :3] — FrobeniusShonanFactor
    (sfm/ShonanFactor.h). Residual dim 3p."""
    name = register_son(p)

    def residual(xs, params):
        Qi, Qj = xs
        return (Qj[..., :, :3] - Qi[..., :, :3] @ params).flatten(-2)

    return FactorType(
        name=f"Shonan{p}", var_types=(name, name), resid_dim=3 * p, residual=residual
    )


def _gauge_factor(p: int) -> FactorType:
    """Weak prior pinning node 0 to the identity lift (removes the global
    O(p) gauge like ShonanGaugeFactor)."""
    name = register_son(p)

    def residual(xs, params):
        (Q,) = xs
        return (Q[..., :, :3] - params).flatten(-2)

    return FactorType(
        name=f"ShonanGauge{p}", var_types=(name,), resid_dim=3 * p, residual=residual
    )


def lifted_graph(m: ShonanMeasurements, p: int, dtype) -> NonlinearFactorGraph:
    """The level-p graph: one Shonan factor an edge (sqrt_info sqrt(kappa)
    I), then the gauge prior on node 0 (sigma 10), on the measurements'
    device."""
    graph = NonlinearFactorGraph(device=m.R.device, dtype=dtype)
    sqrt_k = torch.sqrt(m.kappa).to(dtype)
    si = sqrt_k[:, None, None] * torch.eye(3 * p, dtype=dtype, device=m.R.device)[None]
    graph.add_batch(_shonan_factor(p), np.stack([m.i, m.j], axis=1), m.R, si)
    anchor = torch.eye(p, dtype=dtype, device=m.R.device)[:, :3]
    graph.add(_gauge_factor(p), [0], anchor, noise.isotropic(3 * p, 10.0, np.float64))
    return graph


def optimize_at_p(
    m: ShonanMeasurements,
    p: int,
    Q_init: torch.Tensor,  # [N, p, p]
    lm_params: Optional[optimizers.LMParams] = None,
) -> Tuple[Values, float]:
    """tryOptimizingAt(p) (ShonanAveraging.h:351): LM on the lifted graph,
    on the measurements' device."""
    name = register_son(p)
    dev = m.R.device
    values = Values(device=dev, dtype=Q_init.dtype)
    values.insert_batch(range(Q_init.shape[0]), name, Q_init)
    graph = lifted_graph(m, p, Q_init.dtype)
    params = lm_params or optimizers.LMParams(
        max_iterations=60, solver="pcg", pcg_max_iters=500, pcg_tol=1e-10
    )
    res = optimizers.levenberg_marquardt(graph, values, params, device=dev)
    return res.values, res.error


# --- certificate -------------------------------------------------------------


def _connection_laplacian_matvec(m: ShonanMeasurements, N: int):
    """Matrix-free v -> L v for the 3Nx3N connection Laplacian L
    (ShonanAveraging::buildQ): L[ii] += k I, L[jj] += k I,
    L[ij] -= k R_ij, L[ji] -= k R_ij^T."""
    dev = m.R.device
    i = torch.as_tensor(m.i, dtype=torch.int64).to(dev)
    j = torch.as_tensor(m.j, dtype=torch.int64).to(dev)
    R = m.R
    kc = m.kappa[:, None, None]

    def matvec(V):  # V: [N, 3, c]
        Vi = V[i]
        Vj = V[j]
        out = torch.zeros_like(V)
        out.index_add_(0, i, kc * Vi - kc * torch.einsum("eab,ebc->eac", R, Vj))
        out.index_add_(0, j, kc * Vj - kc * torch.einsum("eba,ebc->eac", R, Vi))
        return out

    return matvec


def certificate_min_eigenvalue(
    m: ShonanMeasurements,
    Y: torch.Tensor,  # [N, 3, p] solution blocks (M_i^T = Q[:, :3]^T rows)
    iters: int = 300,
    seed: int = 0,
) -> float:
    """lambda_min(S), S = L - blockdiag(Lambda), Lambda_i = sym((L Y)_i Y_i^T)
    (computeMinEigenValue, ShonanAveraging.h:253-260; SE-Sync certificate).

    Shifted power iteration: largest eigenvalue of (c I - S) gives
    c - lambda_min; c from a Gershgorin bound. Matrix-free throughout; one
    read of the bound before the loop and one of the result after it."""
    N = Y.shape[0]
    Lmv = _connection_laplacian_matvec(m, N)
    LY = Lmv(Y)  # [N, 3, p]
    Lam = torch.einsum("nap,nbp->nab", LY, Y)
    Lam = 0.5 * (Lam + Lam.transpose(-1, -2))  # [N, 3, 3]

    def Smv(V):  # [N, 3, c]
        return Lmv(V) - torch.einsum("nab,nbc->nac", Lam, V)

    # Gershgorin-style bound on ||S||: 2*max_i (sum of incident kappas) + ||Lam||
    deg = np.zeros(N)
    kk = m.kappa.cpu().numpy()
    np.add.at(deg, m.i, kk)
    np.add.at(deg, m.j, kk)
    c = 2.0 * float(deg.max()) + float(torch.max(torch.abs(Lam))) * 3.0 + 1.0

    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.normal(size=(N, 3, 1)), dtype=Y.dtype).to(Y.device)
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(iters):
        w = c * v - Smv(v)
        v = w / torch.sqrt(torch.sum(w * w) + 1e-300)
    w = c * v - Smv(v)
    lam_max_shifted = float(torch.sum(v * w))
    return c - lam_max_shifted  # = lambda_min(S)


# --- rounding ----------------------------------------------------------------


def round_solution(Q: torch.Tensor) -> torch.Tensor:
    """[N, p, p] lifted -> [N, 3, 3] SO(3) (roundSolutionS, .h:264,363):
    rank-3 SVD of the stacked Stiefel blocks, majority-det sign fix,
    per-block SO(3) projection, then the left gauge R_0 = I. The SVD's own
    choice of singular-vector signs (and of a basis where singular values
    are equal) is a left O(3) factor of every block, which the gauge
    removes."""
    N, p, _ = Q.shape
    M = Q[:, :, :3]  # [N, p, 3] Stiefel blocks
    Y = M.transpose(1, 2).reshape(3 * N, p)  # rows = M_i^T stacked
    U, s, _ = torch.linalg.svd(Y, full_matrices=False)
    Y3 = U[:, :3] * s[None, :3]  # [3N, 3]; block_i ~ M_i^T W, W in O(3)
    blocks = Y3.reshape(N, 3, 3)
    # majority det decides the global reflection of W (no host read)
    mean_det = torch.mean(torch.linalg.det(blocks))
    flip = torch.ones(3, dtype=Q.dtype, device=Q.device)
    flip[2] = -1.0
    blocks = torch.where(mean_det < 0, blocks * flip, blocks)
    # project each to SO(3) and undo the transposition (blocks are R_i^T W)
    Ub, _, Vbt = torch.linalg.svd(blocks)
    det = torch.linalg.det(Ub @ Vbt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (Ub * S[:, None, :]) @ Vbt
    R = R.transpose(-1, -2)
    # global left-gauge: R_i <- R_0^T R_i so that R_0 = I (measurements
    # R_j = R_i R_ij are invariant to left multiplication)
    return R[0].transpose(-1, -2)[None] @ R


@dataclass
class ShonanResult:
    rotations: torch.Tensor  # [N, 3, 3]
    p_final: int
    min_eigenvalue: float
    certified: bool
    cost: float


def lift(R: torch.Tensor, p: int) -> torch.Tensor:
    """Q = [[R, 0], [0, I]] of each rotation, [N, p, p]."""
    N = R.shape[0]
    Q0 = torch.zeros((N, p, p), dtype=R.dtype, device=R.device)
    Q0[:, :3, :3] = R
    for d in range(3, p):
        Q0[:, d, d] = 1.0
    return Q0


def shonan_averaging(
    m: ShonanMeasurements,
    p_min: int = 3,
    p_max: int = 6,
    optimality_threshold: float = -1e-4,
    R_init: Optional[torch.Tensor] = None,
    lm_params: Optional[optimizers.LMParams] = None,
    seed: int = 0,
    dtype=torch.float64,
) -> ShonanResult:
    """ShonanAveraging::run (ShonanAveraging.h:404): the Riemannian
    staircase, on the measurements' device."""
    N = m.num_nodes
    dev = m.R.device
    rng = np.random.default_rng(seed)
    if R_init is None:
        # random init (::initializeRandomly)
        R_init = so3.expmap(torch.as_tensor(rng.normal(size=(N, 3)) * 1.0, dtype=dtype).to(dev))

    lam_min = -np.inf
    Qsol = None
    p_used = p_min
    cost = np.nan
    for p in range(p_min, p_max + 1):
        # lift (+ random perturbation in the new rows)
        Q0 = lift(torch.as_tensor(R_init, dtype=dtype).to(dev), p)
        if p > p_min:
            # perturb along the new dimension to escape the saddle
            name = register_son(p)
            xi = torch.as_tensor(rng.normal(size=(N, p * (p - 1) // 2)) * 0.01, dtype=dtype)
            Q0 = manifold.get(name).retract(Q0, xi.to(dev))

        vals, cost = optimize_at_p(m, p, Q0, lm_params)
        Qsol = vals.params(f"SOn{p}")  # [N, p, p]
        Y = Qsol[:, :, :3].transpose(1, 2)  # [N, 3, p] = M_i^T
        lam_min = certificate_min_eigenvalue(m, Y, seed=seed)
        R_round = round_solution(Qsol)
        if lam_min >= optimality_threshold:
            return ShonanResult(R_round, p, lam_min, True, cost)
        R_init = R_round  # initialize next level from the rounded solution
        p_used = p
    return ShonanResult(round_solution(Qsol), p_used, lam_min, False, cost)
