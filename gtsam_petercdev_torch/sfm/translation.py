"""Translation averaging: MFAS outlier ordering + TranslationRecovery.

Port of gtsam_petercdev_tpu/sfm/translation.py. Reference:
gtsam/sfm/MFAS.{h,cpp}:51 (minimum-feedback-arc-set greedy ordering of
translation-direction measurements projected on an axis;
computeOutlierWeights flags edges inconsistent with the order) and
gtsam/sfm/TranslationRecovery.{h,cpp}:51 (solve global translations from
unit direction measurements with TranslationFactor
residual = t_j - t_i - ||t_j - t_i|| * w_ij).

MFAS is host graph work. Its greedy pick scans the remaining nodes in the
iteration order of a Python set, as the JAX package's loop does: that order
is fixed when the set is made (removing a member moves none of the others),
so the scan runs over numpy arrays in that order, with the same rule (the
first source node, else the first maximum of wout - win) and the same
float updates in the same order: the orders and weights equal the JAX
package's. The recovery solve is a batched LM on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values


def mfas_ordering(
    edges: Sequence[Tuple[int, int]], weights: Sequence[float]
) -> List[int]:
    """Greedy minimum-feedback-arc-set ordering (MFAS.cpp).

    Edge (i, j) with weight w > 0 votes for i before j; w < 0 is treated as
    (j, i) with |w| (the reference pre-flips by projection sign). Returns a
    node order minimizing (heuristically) the total backward weight."""
    win: Dict[int, float] = {}
    wout: Dict[int, float] = {}
    out_adj: Dict[int, List[Tuple[int, float]]] = {}
    in_adj: Dict[int, List[Tuple[int, float]]] = {}
    nodes = set()
    for (i, j), w in zip(edges, weights):
        if w < 0:
            i, j, w = j, i, -w
        nodes.update((i, j))
        wout[i] = wout.get(i, 0.0) + w
        win[j] = win.get(j, 0.0) + w
        out_adj.setdefault(i, []).append((j, w))
        in_adj.setdefault(j, []).append((i, w))

    # the scan order: the iteration order of the JAX package's `remaining`
    seq = list(set(nodes))
    slot = {n: k for k, n in enumerate(seq)}
    w_in = np.array([win.get(n, 0.0) for n in seq], dtype=np.float64)
    w_out = np.array([wout.get(n, 0.0) for n in seq], dtype=np.float64)
    alive = np.ones(len(seq), dtype=bool)
    order: List[int] = []
    for _ in range(len(seq)):
        # source nodes first; else max (wout - win) (MFAS.cpp choice)
        src = np.flatnonzero(alive & (w_in < 1e-12))
        if len(src):
            k = int(src[0])
        else:
            k = int(np.argmax(np.where(alive, w_out - w_in, -np.inf)))
        best = seq[k]
        order.append(best)
        alive[k] = False
        for (j, w) in out_adj.get(best, ()):
            if alive[slot[j]]:
                w_in[slot[j]] -= w
        for (i, w) in in_adj.get(best, ()):
            if alive[slot[i]]:
                w_out[slot[i]] -= w
    return order


def mfas_outlier_weights(
    edges: Sequence[Tuple[int, int]],
    directions: np.ndarray,  # [E, 3] unit translation directions i->j
    projection_axes: Optional[np.ndarray] = None,  # [A, 3]
) -> np.ndarray:
    """computeOutlierWeights: project directions on several axes, order each
    1D problem with MFAS, and accumulate the backward (inconsistent) weight
    per edge. High weight => likely outlier direction. Host numpy."""
    if projection_axes is None:
        rng = np.random.default_rng(42)
        projection_axes = rng.normal(size=(8, 3))
        projection_axes /= np.linalg.norm(projection_axes, axis=1, keepdims=True)
    directions = np.asarray(directions)
    E = len(edges)
    ij = np.asarray(edges, dtype=np.int64).reshape(E, 2)
    out = np.zeros(E)
    for ax in projection_axes:
        w = directions @ ax  # signed 1D weights
        order = mfas_ordering(edges, w)
        pos = {n: k for k, n in enumerate(order)}
        pi = np.array([pos[n] for n in ij[:, 0]])
        pj = np.array([pos[n] for n in ij[:, 1]])
        back = np.where(w >= 0, pi > pj, pj > pi)
        out += np.where(back, np.abs(w), 0.0)
    return out / len(projection_axes)


# --- translation recovery ----------------------------------------------------


def _translation_factor() -> FactorType:
    """residual = t_j - t_i - ||t_j - t_i|| * w_ij (TranslationFactor.h)."""

    def residual(xs, params):
        ti, tj = xs
        d = tj - ti
        n = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-18)
        return d - n * params

    return FactorType(
        name="TranslationDirection",
        var_types=("Point3", "Point3"),
        resid_dim=3,
        residual=residual,
    )


def _translation_prior() -> FactorType:
    """residual = t - params: the gauge priors of `recover_translations`."""

    def residual(xs, params):
        (x,) = xs
        return x - params

    return FactorType("TranslationPrior", ("Point3",), 3, residual)


def recover_translations(
    edges: Sequence[Tuple[int, int]],
    directions,  # [E, 3] unit vectors (t_j - t_i direction), world frame
    scale_anchor: float = 1.0,
    sigma: float = 0.01,
    init: Optional[Dict[int, np.ndarray]] = None,
    params: Optional[optimizers.LMParams] = None,
    dtype=None,
    *,
    device: DeviceLike = "cuda",
) -> Values:
    """TranslationRecovery::run — gauge fixed by anchoring the first edge's
    first node at the origin and its second at `scale_anchor` times its
    direction (the reference adds equivalent priors). The graph: one
    TranslationDirection factor an edge (sigma), then the two priors (sigma
    1e-6); LM (default: `LMParams(max_iterations=60)`, the dense solver)
    on `device` in `dtype` (default float64)."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    directions = np.asarray(directions, dtype=np.float64)
    nodes = sorted({n for e in edges for n in e})
    rng = np.random.default_rng(7)
    start = np.empty((len(nodes), 3))
    for k, n in enumerate(nodes):
        if init is not None and n in init:
            start[k] = np.asarray(init[n], dtype=np.float64)
        else:
            start[k] = rng.normal(size=3)
    values = Values(device=dev, dtype=dt)
    values.insert_batch(nodes, "Point3", start)

    ij = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    E = len(ij)
    graph = NonlinearFactorGraph(device=dev, dtype=dt)
    graph.add_batch(_translation_factor(), ij, directions,
                    np.broadcast_to(noise.isotropic(3, sigma, np.float64), (E, 3, 3)))
    # gauge: t_{i0} = 0; t_{j0} = anchor * w_0 (fixes global scale)
    i0, j0 = ij[0]
    graph.add_batch(_translation_prior(), [[i0], [j0]],
                    np.stack([np.zeros(3), scale_anchor * directions[0]]),
                    np.broadcast_to(noise.isotropic(3, 1e-6, np.float64), (2, 3, 3)))
    res = optimizers.levenberg_marquardt(
        graph, values, params or optimizers.LMParams(max_iterations=60), device=dev
    )
    return res.values
