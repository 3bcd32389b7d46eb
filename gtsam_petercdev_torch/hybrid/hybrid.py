"""Hybrid (conditional linear-Gaussian) factor graphs.

Port of gtsam_petercdev_tpu/hybrid/hybrid.py. Reference: gtsam/hybrid/ —
HybridGaussianFactor (a discrete-indexed collection of Gaussian factors),
HybridGaussianFactorGraph with EliminateHybrid
(HybridGaussianFactorGraph.cpp:291-618 dispatching discrete-only /
continuous-only / mixture elimination), HybridBayesNet with
prune(maxNrLeaves) (HybridBayesNet.h:229).

The discrete ASSIGNMENT GRID is a batch axis. The discrete posterior comes
from the conditional-linear-Gaussian evidence
  P(m) ∝ phi_disc(m) * exp(-E(m)) / sqrt(det H(m)),
E(m) = min_x 0.5||A(m) x - b(m)||^2 — the model-selection constant the
reference tracks via the conditionals' normalization terms. Pruning keeps
the top-K assignments (HybridBayesNet::prune analog).

Two solves, as in the JAX package:
* `HybridGaussianFactorGraph.eliminate` (dense): H [M, D, D], g [M, D] and
  c [M] for all M assignments at once, one `index_add_` per term with the
  assignment axis leading, then one batched `torch.linalg.cholesky` of
  H + 1e-10 I (a library call: the JAX package's dense Cholesky is outside
  any Pallas kernel too).
* `eliminate_sparse`: every hypothesis through the multifrontal engine on
  one plan, the M hypotheses folded into each bucket so that each bucket is
  one kernel launch for all of them (`elimination.multifrontal_solve` with
  `hypotheses=M`).

Tables and systems live on the graph's device (default "cuda"); the
assignments are host numpy (they index the terms' components).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype


@dataclass
class _GaussianTerm:
    """sum_k A_k x_{c_k} - b, rows whitened. cont_keys: which continuous
    vars; A: [d, dim_k] per key; hybrid terms additionally carry leading
    assignment axes over their disc_keys."""

    cont_keys: Tuple[int, ...]
    A: Tuple[torch.Tensor, ...]
    b: torch.Tensor
    disc_keys: Tuple[int, ...] = ()
    # log of the noise-model normalizer log det(R) (per assignment for
    # hybrid terms) — the scalar the reference pairs with each component
    # (HybridGaussianFactor) so mixtures with different noise models
    # compare correctly in the discrete posterior.
    log_norm: torch.Tensor = None


class HybridGaussianFactorGraph:
    """Mixed graph: continuous Gaussian terms, discrete potentials, and
    discrete-indexed Gaussian mixtures, on `device` (default "cuda"; raises
    without a card unless the caller passes "cpu") in `dtype` (default
    float64)."""

    def __init__(self, *, device: DeviceLike = "cuda", dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.cont_dims: Dict[int, int] = {}
        self.disc_cards: Dict[int, int] = {}
        self.gaussians: List[_GaussianTerm] = []
        self.discrete: List[Tuple[Tuple[int, ...], torch.Tensor]] = []

    def _t(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a, dtype=np.float64))
        return a.to(device=self.device, dtype=self.dtype)

    # --- construction ----------------------------------------------------

    def add_continuous(self, keys_dims: Sequence[Tuple[int, int]], A_blocks, b, log_norm=0.0):
        """Whitened Gaussian factor sum_k A_k x_k = b."""
        keys = tuple(k for k, _ in keys_dims)
        for k, d in keys_dims:
            if self.cont_dims.setdefault(k, d) != d:
                raise ValueError(f"dim mismatch for continuous var {k}")
        self.gaussians.append(_GaussianTerm(keys, tuple(self._t(a) for a in A_blocks), self._t(b),
                                            (), self._t(log_norm)))
        return self

    def add_discrete(self, keys_cards: Sequence[Tuple[int, int]], table):
        keys = tuple(k for k, _ in keys_cards)
        cards = tuple(c for _, c in keys_cards)
        for k, c in keys_cards:
            if self.disc_cards.setdefault(k, c) != c:
                raise ValueError(f"cardinality mismatch for discrete var {k}")
        self.discrete.append((keys, self._t(table).reshape(cards)))
        return self

    def add_hybrid(
        self,
        cont_keys_dims: Sequence[Tuple[int, int]],
        disc_keys_cards: Sequence[Tuple[int, int]],
        A_blocks,  # per cont key: [*cards, d, dim_k]
        b,  # [*cards, d]
        log_norm=None,  # [*cards] log det(R) per assignment (default 0)
    ):
        """HybridGaussianFactor: one Gaussian per discrete assignment."""
        for k, d in cont_keys_dims:
            if self.cont_dims.setdefault(k, d) != d:
                raise ValueError(f"dim mismatch for continuous var {k}")
        for k, c in disc_keys_cards:
            if self.disc_cards.setdefault(k, c) != c:
                raise ValueError(f"cardinality mismatch for discrete var {k}")
        cards = tuple(c for _, c in disc_keys_cards)
        ln = (torch.zeros(cards, dtype=self.dtype, device=self.device) if log_norm is None
              else self._t(log_norm).reshape(cards))
        self.gaussians.append(_GaussianTerm(
            tuple(k for k, _ in cont_keys_dims), tuple(self._t(a) for a in A_blocks), self._t(b),
            tuple(k for k, _ in disc_keys_cards), ln))
        return self

    # --- elimination ------------------------------------------------------

    def _cont_offsets(self):
        off, D = {}, 0
        for k in sorted(self.cont_dims.keys()):
            off[k] = D
            D += self.cont_dims[k]
        return off, D

    def _assignments(self):
        dkeys = sorted(self.disc_cards.keys())
        grids = [range(self.disc_cards[k]) for k in dkeys]
        return dkeys, list(itertools.product(*grids))

    def _asg_array(self, assignments) -> Tuple[List[int], np.ndarray]:
        """(sorted discrete keys, [M, n_disc] int64): the full grid for None,
        else the given restricted hypothesis set."""
        if assignments is None:
            dkeys, grid = self._assignments()
            return dkeys, np.asarray(grid, dtype=np.int64).reshape(len(grid), len(dkeys))
        return sorted(self.disc_cards.keys()), np.asarray(assignments, dtype=np.int64)

    def _log_phi(self, asg_arr: np.ndarray, dkeys) -> torch.Tensor:
        """Discrete potentials + noise-model normalizers per assignment."""
        asg = torch.as_tensor(asg_arr).to(self.device)
        log_phi = torch.zeros(asg.shape[0], dtype=self.dtype, device=self.device)
        idx_of = {k: i for i, k in enumerate(dkeys)}
        for keys, table in self.discrete:
            vals = table[tuple(asg[:, idx_of[k]] for k in keys)]
            log_phi = log_phi + torch.log(torch.clamp(vals, min=1e-300))
        for t in self.gaussians:
            if t.disc_keys:
                log_phi = log_phi + t.log_norm[tuple(asg[:, idx_of[k]] for k in t.disc_keys)]
            else:
                log_phi = log_phi + t.log_norm
        return log_phi

    def _selected(self, t: _GaussianTerm, asg: torch.Tensor, idx_of):
        """The term's (A blocks, b) per assignment: [M, r, dim_k] / [M, r]
        for a hybrid term (its component of each assignment), else as
        stored."""
        if not t.disc_keys:
            return t.A, t.b
        sel = tuple(asg[:, idx_of[k]] for k in t.disc_keys)
        return tuple(a[sel] for a in t.A), t.b[sel]

    def eliminate(self, assignments=None) -> "HybridBayesNet":
        """Hybrid elimination: a batched dense Gaussian solve per assignment
        + discrete posterior from the CLG evidence.

        assignments: optional [M, n_disc] RESTRICTED hypothesis set over the
        sorted discrete keys (the pruned-hypothesis incremental path,
        hybrid/incremental.py); None = the full grid."""
        off, D = self._cont_offsets()
        dkeys, asg_arr = self._asg_array(assignments)
        M = asg_arr.shape[0]
        dev, dt = self.device, self.dtype
        if D > 0:
            asg = torch.as_tensor(asg_arr).to(dev)
            idx_of = {k: i for i, k in enumerate(dkeys)}
            H = torch.zeros((M, D * D), dtype=dt, device=dev)
            g = torch.zeros((M, D), dtype=dt, device=dev)
            c = torch.zeros(M, dtype=dt, device=dev)
            for t in self.gaussians:
                A, b = self._selected(t, asg, idx_of)
                J = torch.cat(A, dim=-1).expand(M, -1, -1)  # [M, r, Dt]
                b = b.expand(M, -1)
                span = torch.as_tensor(np.concatenate(
                    [np.arange(off[k], off[k] + self.cont_dims[k]) for k in t.cont_keys])).to(dev)
                g.index_add_(1, span, torch.einsum("mri,mr->mi", J, b))
                H.index_add_(1, (span[:, None] * D + span[None, :]).reshape(-1),
                             (J.transpose(1, 2) @ J).reshape(M, -1))
                c = c + 0.5 * torch.sum(b * b, dim=-1)
            Hr = H.reshape(M, D, D) + 1e-10 * torch.eye(D, dtype=dt, device=dev)
            L = torch.linalg.cholesky(Hr)
            xs = torch.cholesky_solve(g[:, :, None], L)[:, :, 0]
            Es = c - 0.5 * torch.sum(g * xs, dim=-1)  # min_x 0.5||Ax-b||^2
            logdets = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=-1)
        else:
            xs = torch.zeros((M, 0), dtype=dt, device=dev)
            Es = logdets = torch.zeros(M, dtype=dt, device=dev)
        return self._bayes_net(dkeys, asg_arr, Es, logdets, xs)

    def _bayes_net(self, dkeys, asg_arr, Es, logdets, xs) -> "HybridBayesNet":
        """CLG evidence: log P(m) = log phi - E(m) - 0.5 log det H(m) + const,
        normalized."""
        logp = self._log_phi(asg_arr, dkeys) - Es - 0.5 * logdets
        off, _ = self._cont_offsets()
        return HybridBayesNet(disc_keys=tuple(dkeys), assignments=asg_arr,
                              log_probs=logp - torch.logsumexp(logp, dim=0), cont_offsets=off,
                              cont_dims=dict(self.cont_dims), solutions=xs)


@dataclass
class HybridBayesNet:
    """Posterior: discrete distribution over assignments + the optimal
    continuous solution per assignment (HybridBayesNet semantics). The
    assignments are host numpy; log_probs and solutions are tensors on the
    graph's device."""

    disc_keys: Tuple[int, ...]
    assignments: np.ndarray  # [M, n_disc]
    log_probs: torch.Tensor  # [M] normalized
    cont_offsets: Dict[int, int]
    cont_dims: Dict[int, int]
    solutions: torch.Tensor  # [M, D]

    def optimize(self) -> Tuple[Dict[int, int], Dict[int, torch.Tensor]]:
        """MPE discrete assignment + its continuous solution
        (HybridBayesNet::optimize)."""
        best = int(torch.argmax(self.log_probs))
        asg = {k: int(self.assignments[best, i]) for i, k in enumerate(self.disc_keys)}
        x = self.solutions[best]
        return asg, {k: x[o : o + self.cont_dims[k]] for k, o in self.cont_offsets.items()}

    def discrete_marginal(self, key: int) -> torch.Tensor:
        col = self.assignments[:, self.disc_keys.index(key)]
        p = torch.exp(self.log_probs)
        return p.new_zeros(int(col.max()) + 1).index_add_(0, torch.as_tensor(col).to(p.device), p)

    def prune(self, max_leaves: int) -> "HybridBayesNet":
        """Keep the top-K assignments (HybridBayesNet::prune, .h:229) by the
        JAX package's rule, a host argsort of the log probabilities (one
        read); between exactly tied hypotheses rounding decides."""
        order = np.argsort(-self.log_probs.cpu().numpy())[:max_leaves]
        idx = torch.as_tensor(order).to(self.log_probs.device)
        lp = self.log_probs[idx]
        lp = lp - (torch.log(torch.sum(torch.exp(lp - lp.max()))) + lp.max())  # renormalize
        return HybridBayesNet(self.disc_keys, self.assignments[order], lp, self.cont_offsets,
                              self.cont_dims, self.solutions[idx])


# ---------------------------------------------------------------------------
# sparse per-hypothesis elimination (Hybrid_City10000 scale)
# ---------------------------------------------------------------------------


class SparseHypotheses:
    """The continuous systems of M hypotheses of one graph on one multifrontal
    plan. Terms group into factor batches by (cont dims, residual dim, disc
    cards), as in the JAX package (hybrid.py:310-342); a hybrid batch takes
    each hypothesis's component by the strides of its cards. `Ab` holds, per
    batch, (A blocks, b) with a leading hypothesis axis for hybrid batches
    and without one for shared batches; `maps` is the plan of one
    hypothesis."""

    def __init__(self, graph: HybridGaussianFactorGraph, asg_arr: np.ndarray):
        from gtsam_petercdev_torch.inference import elimination

        self.M = asg_arr.shape[0]
        dev = self.device = graph.device
        self.dtype = graph.dtype
        idx_of = {k: i for i, k in enumerate(sorted(graph.disc_cards.keys()))}
        ckeys = sorted(graph.cont_dims.keys())
        gid_of = {k: i for i, k in enumerate(ckeys)}
        d = max(graph.cont_dims.values())

        groups: Dict[Tuple, Dict] = {}
        for t in graph.gaussians:
            dims = tuple(graph.cont_dims[k] for k in t.cont_keys)
            cards = tuple(graph.disc_cards[k] for k in t.disc_keys)
            g = groups.setdefault((dims, int(t.b.shape[-1]), cards),
                                  {"A": [], "b": [], "gids": [], "dcols": []})
            cflat = int(np.prod(cards)) if cards else None
            g["A"].append(tuple(a.reshape((cflat,) + a.shape[-2:]) if cards else a for a in t.A))
            g["b"].append(t.b.reshape(cflat, -1) if cards else t.b)
            g["gids"].append([gid_of[k] for k in t.cont_keys])
            g["dcols"].append([idx_of[k] for k in t.disc_keys])

        structure, self.Ab, self.gids, self.dims = [], [], [], []
        for (dims, _, cards), g in groups.items():
            gids = np.asarray(g["gids"], dtype=np.int64)  # [N, K]
            N = gids.shape[0]
            structure.append(elimination.BatchStructure(
                dims, tuple(gids[:, k] for k in range(len(dims)))))
            A = tuple(torch.stack([a[k] for a in g["A"]]) for k in range(len(dims)))
            b = torch.stack(g["b"])
            if cards:  # each hypothesis's component of each term: [M, N]
                strides = np.cumprod((cards + (1,))[::-1])[::-1][1:]
                sel = (asg_arr[:, np.asarray(g["dcols"], dtype=np.int64)] * strides).sum(-1)
                sel = torch.as_tensor(sel).to(dev)
                rows = torch.arange(N, device=dev)
                A = tuple(a[rows, sel] for a in A)
                b = b[rows, sel]
            self.Ab.append((A, b))
            self.gids.append([torch.as_tensor(gids[:, k]).to(dev) for k in range(len(dims))])
            self.dims.append(dims)
        self.Ab = tuple(self.Ab)
        self.plan = elimination.build_plan_for_graph(structure, len(ckeys), d)
        self.maps = elimination.build_numeric_maps(
            self.plan, structure,
            var_dims=np.asarray([graph.cont_dims[k] for k in ckeys], dtype=np.int64))
        # x [.., n, d] -> the dense offsets layout [.., D]
        self.flat = torch.as_tensor(np.concatenate(
            [gid_of[k] * d + np.arange(graph.cont_dims[k]) for k in ckeys])).to(dev)

    def hypothesis(self, h: int):
        """Hypothesis h's (A blocks, b) per batch, without the hypothesis
        axis: the input of one `elimination.multifrontal_solve`."""
        return tuple((tuple(a[h] if a.dim() == 4 else a for a in A), b[h] if b.dim() == 3 else b)
                     for A, b in self.Ab)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """E = 1/2 ||A x - b||^2 per hypothesis for x [M, n, d], summed over
        the batches in their order (hybrid.py:370-376)."""
        E = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for (A, b), gids, dims in zip(self.Ab, self.gids, self.dims):
            r = b
            for k in range(len(dims)):
                eq = "mnrk,mnk->mnr" if A[k].dim() == 4 else "nrk,mnk->mnr"
                r = r - torch.einsum(eq, A[k], x[:, gids[k], : dims[k]])
            E = E + 0.5 * torch.sum(r * r, dim=(1, 2))
        return E

    def solve(self):
        """(x [M, D] in the dense offsets layout, E [M], logdet [M]) of every
        hypothesis, the hypotheses folded into each bucket."""
        from gtsam_petercdev_torch.inference import elimination

        x, stats = elimination.multifrontal_solve(self.maps, self.Ab, 1e-10, return_logdet=True,
                                                  hypotheses=self.M)
        return x.reshape(self.M, -1)[:, self.flat], self.energy(x), stats["logdet"]


def eliminate_sparse(graph: HybridGaussianFactorGraph, assignments=None) -> HybridBayesNet:
    """Same posterior as graph.eliminate(), with each hypothesis's continuous
    solve routed through the SPARSE multifrontal engine: all hypotheses share
    one symbolic plan (identical structure, different components) and are
    folded into each bucket, one launch a bucket for all of them
    (HybridGaussianFactorGraph.cpp:536-618's per-leaf elimination, batched
    instead of walked; `SparseHypotheses`). Use when the continuous
    dimension outgrows the dense path (Hybrid_City10000-style problems)."""
    dkeys, asg_arr = graph._asg_array(assignments)
    xs, Es, logdets = SparseHypotheses(graph, asg_arr).solve()
    return graph._bayes_net(dkeys, asg_arr, Es, logdets, xs)
