"""Discrete factor graphs: dense-tensor potentials, elimination by reduction.

Port of gtsam_petercdev_tpu/discrete/discrete.py. Reference: gtsam/discrete/
— DecisionTreeFactor (DecisionTree.h:62 ADD with leaf merging),
DiscreteFactorGraph.h:53-99 (EliminateDiscrete sum-product /
EliminateForMPE max-product), DiscreteConditional, DiscreteBayesNet,
DiscreteMarginals.

A factor over variables (v1..vk) with cardinalities (c1..ck) is ONE dense
tensor of shape (c1,...,ck) on the graph's device: a product is a broadcast
multiply, an elimination a sum or max over one axis. Cardinalities in
robotics use-cases are small (2-10), so density costs little. The order of
every product and reduction is the JAX package's, so `optimize` breaks ties
as it does (torch.argmax, like jnp.argmax, takes the first maximum).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype


@dataclass(frozen=True)
class DiscreteFactor:
    """Potential phi(v1..vk) as a dense tensor.

    keys: variable ids, in tensor-axis order. table.shape[i] = card(keys[i]).
    """

    keys: Tuple[int, ...]
    table: torch.Tensor

    @property
    def cards(self) -> Tuple[int, ...]:
        return tuple(self.table.shape)

    def value(self, assignment: Dict[int, int]) -> float:
        idx = tuple(assignment[k] for k in self.keys)
        return float(self.table[idx])

    def normalized(self) -> "DiscreteFactor":
        s = torch.sum(self.table)
        return DiscreteFactor(self.keys, self.table / torch.where(s == 0, 1.0, s))


@dataclass(frozen=True)
class DiscreteConditional:
    """P(frontal | parents) — frontal is axis 0, parents follow.

    For max-product elimination, `argmax` holds argmax_frontal over the
    parents' assignment grid (shape = parent cards) enabling MPE backtrack.
    """

    frontal: int
    parents: Tuple[int, ...]
    table: torch.Tensor  # [card_frontal, *parent_cards]
    argmax: Optional[torch.Tensor] = None  # [*parent_cards] int32

    def choose(self, assignment: Dict[int, int]) -> torch.Tensor:
        idx = tuple(assignment[p] for p in self.parents)
        return self.table[(slice(None),) + idx]


def _align(f: DiscreteFactor, all_keys: Tuple[int, ...], cards: Dict[int, int]):
    """Broadcast f.table to the axis order of all_keys."""
    perm_src = [all_keys.index(k) for k in f.keys]
    out_shape = [1] * len(all_keys)
    for ax_src, ax_dst in enumerate(perm_src):
        out_shape[ax_dst] = f.table.shape[ax_src]
    order = np.argsort(perm_src, kind="stable")
    return f.table.permute(tuple(int(o) for o in order)).reshape(tuple(out_shape))


def product(factors: Sequence[DiscreteFactor], cards: Dict[int, int]) -> DiscreteFactor:
    """Pointwise product over the union scope (DecisionTreeFactor::operator*)."""
    all_keys = tuple(sorted({k for f in factors for k in f.keys}))
    t0 = factors[0].table
    out = torch.ones(tuple(cards[k] for k in all_keys), dtype=t0.dtype, device=t0.device)
    for f in factors:
        out = out * _align(f, all_keys, cards)
    return DiscreteFactor(all_keys, out)


def eliminate_one(
    factors: List[DiscreteFactor],
    var: int,
    cards: Dict[int, int],
    op: str = "sum",
) -> Tuple[DiscreteConditional, Optional[DiscreteFactor], List[DiscreteFactor]]:
    """Eliminate `var`: multiply its factors, reduce over its axis.

    Returns (conditional, separator_factor_or_None, remaining_factors).
    op='sum' -> EliminateDiscrete (DiscreteFactorGraph.h:53);
    op='max' -> EliminateForMPE (:66).
    """
    involved = [f for f in factors if var in f.keys]
    remaining = [f for f in factors if var not in f.keys]
    if not involved:
        raise KeyError(f"variable {var} not in graph")
    joint = product(involved, cards)
    t = torch.movedim(joint.table, joint.keys.index(var), 0)
    parents = tuple(k for k in joint.keys if k != var)
    if op == "sum":
        marg = torch.sum(t, dim=0)
        argm = None
    else:
        marg = torch.amax(t, dim=0)
        argm = torch.argmax(t, dim=0).to(torch.int32)
    cond = DiscreteConditional(var, parents, t / torch.where(marg == 0, 1.0, marg), argm)
    sep = DiscreteFactor(parents, marg) if parents else None
    return cond, sep, remaining


@dataclass
class DiscreteBayesNet:
    conditionals: List[DiscreteConditional]  # elimination order

    def optimize(self) -> Dict[int, int]:
        """MPE assignment by reverse traversal. Valid when produced by
        max-product elimination (DiscreteLookupDAG::argmax); with
        sum-product conditionals this is the sequential argmax heuristic
        (DiscreteBayesNet::optimize semantics). One read a variable."""
        assignment: Dict[int, int] = {}
        for cond in reversed(self.conditionals):
            if cond.argmax is not None:
                idx = tuple(assignment[p] for p in cond.parents)
                assignment[cond.frontal] = int(cond.argmax[idx])
            else:
                assignment[cond.frontal] = int(torch.argmax(cond.choose(assignment)))
        return assignment

    def sample(self, generator: torch.Generator) -> Dict[int, int]:
        """One ancestral sample. generator: a torch.Generator on the tables'
        device (the JAX package takes an np.random.Generator, so the two draw
        different streams from one seed)."""
        assignment: Dict[int, int] = {}
        for cond in reversed(self.conditionals):
            probs = cond.choose(assignment)
            probs = probs / probs.sum()
            assignment[cond.frontal] = int(torch.multinomial(probs, 1, generator=generator))
        return assignment

    def evaluate(self, assignment: Dict[int, int]) -> float:
        p = 1.0
        for cond in self.conditionals:
            idx = (assignment[cond.frontal],) + tuple(assignment[pk] for pk in cond.parents)
            p *= float(cond.table[idx])
        return p


class DiscreteFactorGraph:
    """Factor container + elimination front-door (DiscreteFactorGraph.h:99).
    Its tables live on `device` (default "cuda"; raises without a card
    unless the caller passes "cpu") in `dtype` (default float64)."""

    def __init__(self, *, device: DeviceLike = "cuda", dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.factors: List[DiscreteFactor] = []
        self.cards: Dict[int, int] = {}

    def add(self, keys_cards: Sequence[Tuple[int, int]], table) -> "DiscreteFactorGraph":
        """keys_cards: [(key, cardinality), ...]; table: array or flat list
        in row-major order over those cardinalities (DecisionTreeFactor ctor)."""
        keys = tuple(k for k, _ in keys_cards)
        cards = tuple(c for _, c in keys_cards)
        for k, c in keys_cards:
            if self.cards.setdefault(k, c) != c:
                raise ValueError(f"cardinality mismatch for {k}")
        if not isinstance(table, torch.Tensor):
            table = torch.tensor(np.asarray(table, dtype=np.float64))
        t = table.to(device=self.device, dtype=self.dtype).reshape(cards)
        self.factors.append(DiscreteFactor(keys, t))
        return self

    def all_keys(self) -> List[int]:
        return sorted({k for f in self.factors for k in f.keys})

    def eliminate_sequential(
        self, ordering: Optional[Sequence[int]] = None, op: str = "sum"
    ) -> DiscreteBayesNet:
        ordering = list(ordering) if ordering is not None else self.all_keys()
        factors = list(self.factors)
        conds = []
        for var in ordering:
            cond, sep, factors = eliminate_one(factors, var, self.cards, op)
            conds.append(cond)
            if sep is not None:
                factors.append(sep)
        return DiscreteBayesNet(conds)

    def optimize(self, ordering: Optional[Sequence[int]] = None) -> Dict[int, int]:
        """MPE via max-product elimination + backtrack
        (DiscreteFactorGraph::optimize)."""
        return self.eliminate_sequential(ordering, op="max").optimize()

    def joint(self) -> DiscreteFactor:
        return product(self.factors, self.cards)

    def marginal(self, key: int) -> torch.Tensor:
        """P(key) by sum-product elimination of all other variables
        (DiscreteMarginals semantics)."""
        factors = list(self.factors)
        for var in (k for k in self.all_keys() if k != key):
            _, sep, factors = eliminate_one(factors, var, self.cards, "sum")
            if sep is not None:
                factors.append(sep)
        if factors:
            t = torch.squeeze(product(factors, self.cards).table)
        else:
            t = torch.ones((self.cards[key],), dtype=self.dtype, device=self.device)
        t = t.reshape(self.cards[key])
        return t / torch.sum(t)

    def evaluate(self, assignment: Dict[int, int]) -> float:
        p = 1.0
        for f in self.factors:
            p *= f.value(assignment)
        return p


def signature_table(spec: str, card_frontal: int, parent_cards: Sequence[int]):
    """Parse a reference-style Signature spec: rows of frontal ratios per
    parent assignment, e.g. "4/1 1/4" for one binary parent
    (discrete/Signature.h). Rows are row-major over parents. Host numpy, as
    in the JAX package: the result feeds `DiscreteFactorGraph.add`."""
    tables = []
    for row in spec.strip().split():
        vals = np.asarray([float(x) for x in row.split("/")])
        if len(vals) != card_frontal:
            raise ValueError(f"row {row} has {len(vals)} entries, expected {card_frontal}")
        tables.append(vals / vals.sum())
    arr = np.stack(tables, axis=0).reshape(tuple(parent_cards) + (card_frontal,))
    return np.moveaxis(arr, -1, 0)  # (frontal, *parents)
