"""Schur-complement bundle-adjustment solver: batched landmark elimination.

Port of gtsam_petercdev_tpu/sfm/schur.py. The reference eliminates
landmarks per smart factor via CameraSet::SchurComplement
(gtsam/geometry/CameraSet.h:175-241) building the m*dc+1 reduced camera
Hessian per track. Here ALL tracks are eliminated in one batched pass:

  H_pp[j]  = sum_obs E^T E   (+ point priors, + damping)   [T, 3, 3]
  g_p[j]   = sum_obs E^T b
  W[o]     = F^T E                                         [O, dc, 3]
  S        = H_cc - sum_{(a,b) in same track} W[a] Hpp[j]^-1 W[b]^T
  g_c      = g_cc - sum_obs W Hpp^-1 g_p
  solve S dx_c = g_c (dense Cholesky; cameras are few), then back-substitute
  dx_p[j] = Hpp[j]^-1 (g_p[j] - sum_obs E^T F dx_c).

Obs-pair index arrays are precomputed on the host (plan) and uploaded once
per device; everything else is `index_add_` / `index_put_(accumulate=True)`,
gathers, batched 3x3 inverses and one dense Cholesky (`torch.linalg`: the
JAX package computes these outside any kernel too). Accumulation by
`index_put_` uses atomics on the card, so sums differ from run to run in
the last bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.nonlinear.factor_graph import LinearizedGraph

POINT_TYPE = "Point3"


@dataclass
class SchurPlan:
    cam_type: str
    dc: int
    n_cams: int
    n_pts: int
    # projection batches: (batch_idx, cam_slot, pt_slot)
    proj: List[Tuple[int, int, int]]
    # camera-only batches: (batch_idx, [slots])
    cam_only: List[Tuple[int, List[int]]]
    # point-only (unary) batches: (batch_idx, slot)
    pt_only: List[Tuple[int, int]]
    # obs-pair arrays per projection batch: (pair_a, pair_b) local obs indices
    pairs: List[Tuple[np.ndarray, np.ndarray]]
    # device -> (rows_static it was built from, uploaded index tensors)
    _device_cache: Dict[str, tuple] = field(default_factory=dict, repr=False)


def build_schur_plan(lg: LinearizedGraph) -> SchurPlan:
    types = set(lg.type_counts.keys())
    assert POINT_TYPE in types and len(types) == 2, types
    if any(lb.sign != 1.0 for lb in lg.batches):
        raise NotImplementedError(
            "schur solver does not support sign=-1 (AntiFactor) batches; "
            "use the dense or multifrontal solver"
        )
    cam_type = next(t for t in types if t != POINT_TYPE)
    dc = manifold.get(cam_type).dim
    proj, cam_only, pt_only, pairs = [], [], [], []
    for bi, lb in enumerate(lg.batches):
        vt = lb.var_types
        if POINT_TYPE in vt and cam_type in vt:
            assert len(vt) == 2
            cs = vt.index(cam_type)
            ps = vt.index(POINT_TYPE)
            proj.append((bi, cs, ps))
            # group obs by point row -> all ordered pairs within the track
            rows = np.asarray(lb.rows[ps])
            order = np.argsort(rows, kind="stable")
            bounds = np.flatnonzero(np.diff(rows[order])) + 1
            pa, pb = [], []
            for idx in np.split(order, bounds) if len(order) else ():
                A, B = np.meshgrid(idx, idx, indexing="ij")
                pa.append(A.reshape(-1))
                pb.append(B.reshape(-1))
            pairs.append(
                (
                    np.concatenate(pa) if pa else np.zeros(0, np.int64),
                    np.concatenate(pb) if pb else np.zeros(0, np.int64),
                )
            )
        elif POINT_TYPE in vt:
            assert len(vt) == 1, "point-point factors unsupported in Schur path"
            pt_only.append((bi, 0))
        else:
            cam_only.append((bi, list(range(len(vt)))))
    return SchurPlan(
        cam_type=cam_type,
        dc=dc,
        n_cams=lg.type_counts[cam_type],
        n_pts=lg.type_counts[POINT_TYPE],
        proj=proj,
        cam_only=cam_only,
        pt_only=pt_only,
        pairs=pairs,
    )


def _indices_on(plan: SchurPlan, rows_static, device):
    """The plan's index tensors on `device`, uploaded once: per batch the
    row tensors, per projection batch the pair tensors."""
    ent = plan._device_cache.get(str(device))
    if ent is None or ent[0] is not rows_static:
        up = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(device)
        rows = tuple(tuple(up(r) for r in rs) for rs in rows_static)
        pairs = tuple((up(pa), up(pb)) for pa, pb in plan.pairs)
        ent = (rows_static, rows, pairs)
        plan._device_cache[str(device)] = ent
    return ent[1], ent[2]


def _outer(A, B):
    return torch.einsum("ndi,ndj->nij", A, B)


def schur_solve(
    plan: SchurPlan,
    rows_static,
    Ab,
    lam=0.0,
    diagonal_damping: bool = False,
    return_stats: bool = False,
):
    """Returns delta {cam_type: [C, dc], 'Point3': [T, 3]}.

    rows_static: per batch, tuple of np row arrays (plan-time constants).
    Ab: per batch, (A_blocks tuple, b) tensors; the solve runs on their device.
    With return_stats=True returns (delta, stats): stats['bad_pivots'] (an
    int32 device scalar) is nonzero when the reduced camera matrix was not
    positive definite at this lambda — the delta is then garbage, and LM
    rejects the trial as it does for the multifrontal solver's clamped pivots.
    """
    dc = plan.dc
    C_, T_ = plan.n_cams, plan.n_pts
    b0 = Ab[0][1]
    dtype, dev = b0.dtype, b0.device
    Dc = C_ * dc
    rows, pairs = _indices_on(plan, rows_static, dev)

    H_pp = torch.zeros((T_, 3, 3), dtype=dtype, device=dev)
    g_p = torch.zeros((T_, 3), dtype=dtype, device=dev)
    Hcc = torch.zeros((Dc, Dc), dtype=dtype, device=dev)
    g_c = torch.zeros((C_, dc), dtype=dtype, device=dev)
    ar = torch.arange(dc, device=dev)

    def cam_gidx(r):
        return (r * dc)[:, None] + ar[None, :]

    def add_cc(ga, gb, blk):
        Hcc.index_put_((ga[:, :, None], gb[:, None, :]), blk, accumulate=True)

    # point-only priors
    for bi, slot in plan.pt_only:
        A_, b_ = Ab[bi]
        E = A_[slot]
        H_pp.index_add_(0, rows[bi][slot], _outer(E, E))
        g_p.index_add_(0, rows[bi][slot], torch.einsum("ndi,nd->ni", E, b_))

    # camera-only factors -> dense camera system
    for bi, slots in plan.cam_only:
        A_, b_ = Ab[bi]
        gidx = [cam_gidx(rows[bi][k]) for k in slots]
        for a, k in enumerate(slots):
            g_c.index_add_(0, rows[bi][k], torch.einsum("ndi,nd->ni", A_[k], b_))
            for b2, l in enumerate(slots):
                add_cc(gidx[a], gidx[b2], _outer(A_[k], A_[l]))

    # projection factors
    Ws, obs = [], []
    for bi, cs, ps in plan.proj:
        A_, b = Ab[bi]
        F, E = A_[cs], A_[ps]  # [N, d, dc], [N, d, 3]
        crow, prow = rows[bi][cs], rows[bi][ps]
        H_pp.index_add_(0, prow, _outer(E, E))
        g_p.index_add_(0, prow, torch.einsum("ndi,nd->ni", E, b))
        g_c.index_add_(0, crow, torch.einsum("ndi,nd->ni", F, b))
        gidx = cam_gidx(crow)
        add_cc(gidx, gidx, _outer(F, F))
        Ws.append(_outer(F, E))  # [N, dc, 3]
        obs.append((crow, prow, E, F))

    # damping
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if diagonal_damping:
        H_pp = H_pp + lam * torch.diag_embed(torch.diagonal(H_pp, dim1=1, dim2=2))
        Hcc = Hcc + lam * torch.diag(torch.diagonal(Hcc))
    else:
        H_pp = H_pp + lam * eye3
        Hcc.diagonal().add_(lam)

    Hpp_inv = torch.linalg.inv(H_pp + 1e-12 * eye3)  # [T, 3, 3]

    # Schur: subtract W_a Hpp^-1 W_b^T over same-track obs pairs
    for W, (crow, prow, _, _), (pa, pb) in zip(Ws, obs, pairs):
        contrib = torch.einsum("pij,pjk,plk->pil", W[pa], Hpp_inv[prow[pa]], W[pb])
        add_cc(cam_gidx(crow[pa]), cam_gidx(crow[pb]), -contrib)
        # rhs: g_c -= W Hpp^-1 g_p (once per obs)
        gc_contrib = torch.einsum("nij,njk,nk->ni", W, Hpp_inv[prow], g_p[prow])
        g_c.index_add_(0, crow, -gc_contrib)

    # reduced camera solve
    L, info = torch.linalg.cholesky_ex(Hcc)
    xc = torch.cholesky_solve(g_c.reshape(Dc, 1), L).reshape(C_, dc)

    # back-substitute points: dx_p = Hpp^-1 (g_p - sum E^T F dx_c)
    rhs_p = g_p.clone()
    for crow, prow, E, F in obs:
        Fx = torch.einsum("ndj,nj->nd", F, xc[crow])
        rhs_p.index_add_(0, prow, -torch.einsum("ndi,nd->ni", E, Fx))
    xp = torch.einsum("tij,tj->ti", Hpp_inv, rhs_p)

    delta = {plan.cam_type: xc, POINT_TYPE: xp}
    if return_stats:
        return delta, {"bad_pivots": (info != 0).to(torch.int32)}
    return delta


# --- optimizer integration ---------------------------------------------------


def _graph_plan(graph, lg):
    """(plan, rows_static) for this graph's structure, cached ON the graph
    object (as the multifrontal plan is), so a plan lives and dies with its
    graph. The JAX package keys a module-level cache by id(graph), which can
    hand a collected graph's plan to a new graph at the same address."""
    key = (
        tuple((lb.var_types, len(lb.b)) for lb in lg.batches),
        tuple(sorted(lg.type_counts.items())),
    )
    cache = graph.__dict__.setdefault("_schur_plans", {})
    ent = cache.get(key)
    if ent is None:
        rows_static = tuple(tuple(np.asarray(r) for r in lb.rows) for lb in lg.batches)
        ent = cache[key] = (build_schur_plan(lg), rows_static)
    return ent


def solve_linearized(graph, values, lam, diagonal_damping=False, cache=None):
    """Optimizer hook (solver='schur')."""
    from gtsam_petercdev_torch.linear import solve as linsolve

    cache = cache if cache is not None else {}
    if cache.get("schur_lg") is None:
        cache["schur_lg"] = graph.linearize(values)
    lg = cache["schur_lg"]
    plan, rows_static = _graph_plan(graph, lg)

    Ab = tuple((lb.A, lb.b) for lb in lg.batches)
    delta, stats = schur_solve(
        plan, rows_static, Ab, lam, diagonal_damping=diagonal_damping, return_stats=True
    )
    # surface an indefinite camera system so LM rejects the trial and re-damps
    cache["bad_pivots"] = stats["bad_pivots"]
    return delta, linsolve.linearized_decrease(lg, delta)
