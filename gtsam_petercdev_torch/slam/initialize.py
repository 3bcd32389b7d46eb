"""Pose-graph initialization: chordal relaxation (3D) and LAGO (2D).

Port of gtsam_petercdev_tpu/slam/initialize.py. Reference:
  InitializePose3 (gtsam/slam/InitializePose3.{h,cpp}:45-91) — solve the
  chordal relaxation of rotation synchronization as a LINEAR least-squares
  problem over the 9 entries of each rotation matrix, project back onto
  SO(3) by SVD, then recover translations from a second linear solve.
  lago (gtsam/slam/lago.{h,cpp}:42-92) — 2D orientation-first init: correct
  relative-angle measurements for 2*pi winding along a spanning tree, solve
  the linear orientation system, then the linear position system.

Chordal: both stages are factor batches solved matrix-free by the block-
Jacobi PCG (`linear/solve.pcg_solve`); the SO(3) projection is one batched
SVD. LAGO: the BFS tree stays on the host; both normal-equation systems are
assembled by scatter-adds over all edges at once and solved by
`torch.linalg.solve` on the graph's device. The position system is
kron(H, I2) for the orientation system's H (anchor included), so it is
solved as H with the x and y right-hand sides: the same solution as the
reference's 2n x 2n system, at a quarter of its size.

Both follow the graph's device and return Values there.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import resolve_dtype
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values

# flat vector manifold of the rotation relaxation
if "Vector9" not in manifold.registered():
    manifold.register(manifold.vector_space("Vector9", 9))


def _edges(graph: NonlinearFactorGraph, prefix: str):
    """(i keys, j keys, measured params per batch) of the batches whose
    factor type's name starts with `prefix`."""
    graph._materialize()
    sel = [b for b in graph.batches if b.ftype.name.startswith(prefix)]
    if not sel:
        raise ValueError(f"no {prefix} factors in graph")
    ik = np.concatenate([b.keys[:, 0] for b in sel])
    jk = np.concatenate([b.keys[:, 1] for b in sel])
    return ik, jk, [b.params for b in sel]


def _extract_pose3_edges(graph: NonlinearFactorGraph):
    """(i_keys, j_keys, measured R [E, 3, 3], measured t [E, 3]) from the
    BetweenPose3 batches."""
    ik, jk, ps = _edges(graph, "BetweenPose3")
    return ik, jk, torch.cat([p.R for p in ps]), torch.cat([p.t for p in ps])


def _chordal_residual(xs, params):
    """Rows of R_j must equal rows of R_i rotated by the measured R_ij
    (InitializePose3::buildLinearOrientationGraph)."""
    xi, xj = xs  # [..., 9]: rows of R stacked
    Ri = xi.reshape(*xi.shape[:-1], 3, 3)
    Rj = xj.reshape(*xj.shape[:-1], 3, 3)
    return (Rj - Ri @ params).reshape(*xi.shape[:-1], 9)


def _anchor_residual(xs, params):
    (x,) = xs
    return x - params


def _t_residual(xs, params):
    """t_j - t_i = R_i t_ij (InitializePose3::computePoses on translations)."""
    ti, tj = xs
    Ri, tij = params
    return tj - ti - (Ri @ tij[..., None])[..., 0]


_CHORDAL9 = FactorType("Chordal9", ("Vector9", "Vector9"), 9, _chordal_residual)
_ANCHOR9 = FactorType("Anchor9", ("Vector9",), 9, _anchor_residual)
_CHORDAL_T = FactorType("ChordalT", ("Point3", "Point3"), 3, _t_residual)
_ANCHOR_T = FactorType("AnchorT", ("Point3",), 3, _anchor_residual)


def initialize_pose3_chordal(
    graph: NonlinearFactorGraph,
    anchor_key: Optional[int] = None,
    pcg_tol: float = 1e-8,
    pcg_max_iters: int = 2000,
    dtype=None,
) -> Values:
    """Chordal initialization of a Pose3 pose graph (InitializePose3.h:45-91).

    Returns a Values on the graph's device with Pose3 estimates for every
    key touched by a BetweenPose3 factor (dtype default float64)."""
    dev, dt = graph.device, resolve_dtype(dtype)
    ik, jk, Rm, tm = _extract_pose3_edges(graph)
    keys = np.unique(np.concatenate([ik, jk]))
    if anchor_key is None:
        anchor_key = int(keys[0])
    n = len(keys)
    edge_keys = np.stack([ik, jk], axis=1)

    # --- stage 1: rotations (linear 9D relaxation) -----------------------
    eye9 = torch.eye(3, dtype=dt, device=dev).reshape(9)
    rot_vals = Values(device=dev, dtype=dt)
    rot_vals.insert_batch(keys, "Vector9", eye9.expand(n, 9))
    rot_graph = NonlinearFactorGraph(device=dev, dtype=dt)
    rot_graph.add_batch(_CHORDAL9, edge_keys, Rm, np.eye(9))
    rot_graph.add_batch(_ANCHOR9, [[anchor_key]], eye9[None], noise.isotropic(9, 1e-3, np.float64))
    delta = linsolve.pcg_solve(rot_graph.linearize(rot_vals), tol=pcg_tol, max_iters=pcg_max_iters)
    x9 = rot_vals.params("Vector9") + delta["Vector9"]  # [N, 9]

    # project to SO(3): R = U diag(1, 1, det(U V^T)) V^T (Frobenius-closest)
    U, _, Vh = torch.linalg.svd(x9.reshape(-1, 3, 3))
    det = torch.linalg.det(U @ Vh)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * S[:, None, :]) @ Vh

    # --- stage 2: translations (linear, rotations fixed) ------------------
    z3 = torch.zeros(3, dtype=dt, device=dev)
    t_vals = Values(device=dev, dtype=dt)
    t_vals.insert_batch(keys, "Point3", z3.expand(n, 3))
    t_graph = NonlinearFactorGraph(device=dev, dtype=dt)
    ri = torch.as_tensor(np.searchsorted(keys, ik), device=dev)
    t_graph.add_batch(_CHORDAL_T, edge_keys, (R[ri], tm), np.eye(3))
    t_graph.add_batch(_ANCHOR_T, [[anchor_key]], z3[None], noise.isotropic(3, 1e-3, np.float64))
    dt_ = linsolve.pcg_solve(t_graph.linearize(t_vals), tol=pcg_tol, max_iters=pcg_max_iters)
    t = t_vals.params("Point3") + dt_["Point3"]

    out = Values(device=dev, dtype=dt)
    out.insert_batch(keys, "Pose3", Pose3(R, t))
    return out


# --- LAGO (2D) ---------------------------------------------------------------


def _extract_pose2_edges(graph: NonlinearFactorGraph):
    """(i_keys, j_keys, measured [E, 3] on the graph's device) from the
    BetweenPose2 batches."""
    ik, jk, ps = _edges(graph, "BetweenPose2")
    return ik, jk, torch.cat(ps)


def _bfs_thetas(n, ri, rj, dth, anchor_row):
    """Orientation of each of the n poses accumulated along a BFS spanning
    tree from the anchor (lago::computeThetasToRoot)."""
    adj = [[] for _ in range(n)]
    for i, j, d in zip(ri.tolist(), rj.tolist(), dth.tolist()):
        adj[i].append((j, d, 1.0))
        adj[j].append((i, d, -1.0))
    theta = np.full(n, np.nan)
    theta[anchor_row] = 0.0
    q = deque([anchor_row])
    while q:
        u = q.popleft()
        for v, d, sgn in adj[u]:
            if np.isnan(theta[v]):
                theta[v] = theta[u] + sgn * d
                q.append(v)
    return theta


def initialize_pose2_lago(
    graph: NonlinearFactorGraph, anchor_key: Optional[int] = None, dtype=None
) -> Values:
    """LAGO 2D initialization (gtsam/slam/lago.h:42-92), on the graph's
    device.

    1. a spanning tree (BFS on the host) gives winding-consistent
       orientation guesses; each loop-closure angle is regularized to the
       nearest 2*pi-compatible value (lago::computeThetasToRoot);
    2. linear least squares over all orientation constraints;
    3. linear least squares for the positions with the orientations fixed.
    """
    dev, dt = graph.device, resolve_dtype(dtype)
    ik, jk, m = _extract_pose2_edges(graph)
    m_np = m.double().cpu().numpy()
    keys = np.unique(np.concatenate([ik, jk]))
    n = len(keys)
    if anchor_key is None:
        anchor_key = int(keys[0])
    ri, rj = np.searchsorted(keys, ik), np.searchsorted(keys, jk)
    a = int(np.searchsorted(keys, anchor_key))

    theta_tree = _bfs_thetas(n, ri, rj, m_np[:, 2], a)
    pred = theta_tree[rj] - theta_tree[ri]
    dth = m_np[:, 2] + 2 * np.pi * np.round((pred - m_np[:, 2]) / (2 * np.pi))

    # orientation normal equations: one +1 / -1 pattern per edge, summed
    # over all edges by scatter-adds, plus the anchor
    ri_d = torch.as_tensor(ri, device=dev)
    rj_d = torch.as_tensor(rj, device=dev)
    E = len(ri)
    H = torch.zeros((n, n), dtype=dt, device=dev)
    ones = torch.ones(E, dtype=dt, device=dev)
    H.index_put_((torch.cat([ri_d, rj_d, ri_d, rj_d]), torch.cat([ri_d, rj_d, rj_d, ri_d])),
                  torch.cat([ones, ones, -ones, -ones]), accumulate=True)
    H[a, a] += 1e6
    dth_d = torch.as_tensor(dth, dtype=dt, device=dev)
    g = torch.zeros(n, dtype=dt, device=dev)
    g.index_add_(0, ri_d, -dth_d)
    g.index_add_(0, rj_d, dth_d)
    theta = torch.linalg.solve(H, g)

    # positions: t_j - t_i = R(theta_i) dt_ij; the system is kron(H, I2)
    md = m.to(dt)
    c, s = torch.cos(theta[ri_d]), torch.sin(theta[ri_d])
    rhs = torch.stack([c * md[:, 0] - s * md[:, 1], s * md[:, 0] + c * md[:, 1]], dim=1)
    g2 = torch.zeros((n, 2), dtype=dt, device=dev)
    g2.index_add_(0, ri_d, -rhs)
    g2.index_add_(0, rj_d, rhs)
    t = torch.linalg.solve(H, g2)

    out = Values(device=dev, dtype=dt)
    wrapped = torch.atan2(torch.sin(theta), torch.cos(theta))
    out.insert_batch(keys, "Pose2", torch.cat([t, wrapped[:, None]], dim=1))
    return out
