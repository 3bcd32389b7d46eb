"""NonlinearFactorGraph as typed struct-of-arrays factor batches.

Port of gtsam_petercdev_tpu/nonlinear/factor_graph.py. Factors are grouped
by FactorType into batches {params: [N, ...], keys: [N, K]}; residuals and
manifold Jacobians come either from a closed-form batched `analytic`
function (the Pose3 fast path) or from `torch.func.jacfwd` of
(residual o retract) over the whole batch at once.

Linearization output is a `LinearizedGraph`: per batch, whitened Jacobian
blocks A_k [N, d, dim_k] per key slot plus rhs b = -whitened_error [N, d].

Factor data (params, sqrt_info) lives on the graph's device in its dtype;
keys stay host-side numpy, and each batch caches its key -> row lookup (and
the rows' device copy) per Values index, so an optimizer loop uploads no
index per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_leaves, tree_map, tree_stack
from gtsam_petercdev_torch.device import (
    DeviceLike,
    check_on,
    resolve_device,
    resolve_dtype,
)
from gtsam_petercdev_torch.linear.noise import RobustLoss
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass(frozen=True)
class FactorType:
    """Descriptor of one factor family.

    residual(xs, params) -> [..., resid_dim]: xs is a tuple of variable
    params (one per key slot, manifold types per var_types); written over
    leading batch dims: `error` and `linearize` call it on a whole batch.
    """

    name: str
    var_types: Tuple[str, ...]
    resid_dim: int
    residual: Callable[[Tuple[Any, ...], Any], torch.Tensor]
    # Optional linearization residual (xs_retracted, xs_lin_point, params):
    # Jacobians come from THIS function with xs_lin_point held constant,
    # while `residual` still defines the cost (the default build's
    # BetweenFactor / PriorFactor chart conventions).
    linearize_residual: Optional[Callable[[Tuple, Tuple, Any], torch.Tensor]] = None
    # Optional closed-form batched linearization (xs, params) ->
    # (r0 [N, d], Js tuple of [N, d, dim_k]); replaces jacfwd when set.
    analytic: Optional[Callable[[Tuple, Any], Tuple]] = None

    def retract_fn(self, slot: int):
        return manifold.get(self.var_types[slot]).retract


@dataclass
class FactorBatch:
    ftype: FactorType
    keys: np.ndarray  # [N, K] host-side keys (uint64)
    params: Any  # tensor layout, leaves [N, ...] on the graph's device
    sqrt_info: torch.Tensor  # [N, d, d]
    robust: Optional[RobustLoss] = None
    # +1.0 normal factor; -1.0 subtracts information (AntiFactor)
    sign: float = 1.0
    # [N, d] bool host-side: rows that are EXACT equality constraints
    constrained_mask: Optional[np.ndarray] = None
    # (values index, its length, host rows, device rows) of the last lookup
    _rows_cache: Optional[tuple] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return self.keys.shape[0]


@dataclass
class LinearBatch:
    """Whitened linear factor batch: sum_k A_k delta_k ~= b."""

    var_types: Tuple[str, ...]
    rows: Tuple[np.ndarray, ...]  # per slot, [N] int32 rows into type batch
    A: Tuple[torch.Tensor, ...]  # per slot, [N, d, dim_k]
    b: torch.Tensor  # [N, d]
    sign: float = 1.0  # -1.0: information is SUBTRACTED (AntiFactor)
    constrained_mask: Optional[np.ndarray] = None  # [N, d] bool host-side
    rows_dev: Tuple[torch.Tensor, ...] = ()  # `rows` on the device (int64)


@dataclass
class LinearizedGraph:
    batches: List[LinearBatch]
    type_counts: Dict[str, int]  # variables per type (delta shapes)


def _whiten(sqrt_info, r):
    return (sqrt_info @ r[..., None])[..., 0]


def residual_and_jac(ftype: FactorType, robust, xs, params, sqrt_info):
    """Whitened residual + manifold Jacobians at delta=0, batched over the
    leading axis. Returns (r_w [N, d], Js tuple of [N, d, dim_k])."""
    dims = [manifold.get(t).dim for t in ftype.var_types]
    retracts = [ftype.retract_fn(k) for k in range(len(dims))]

    if ftype.analytic is not None:
        r0, Js0 = ftype.analytic(xs, params)
        r_w = _whiten(sqrt_info, r0)
        Js = [sqrt_info @ Jk for Jk in Js0]
    else:
        total = int(sum(dims))
        n = sqrt_info.shape[0]

        # One forward-mode pass over the WHOLE batch: factor i's residual
        # depends on its own delta alone, so pushing the basis vector e_k
        # through every factor at once gives column k of every Jacobian.
        # (Keeping the batch axis inside the differentiated function also
        # keeps every intermediate at >= 1 dim: forward-mode tangents of
        # 0-dim float32 tensors combined with Python scalars come out in
        # float64 on some PyTorch versions.)
        def batch_fn(delta_flat):
            deltas = torch.split(delta_flat.expand(n, total), dims, dim=-1)
            xs_r = tuple(retracts[k](x, dl) for k, (x, dl) in enumerate(zip(xs, deltas)))
            if ftype.linearize_residual is not None:
                r = ftype.linearize_residual(xs_r, xs, params)
            else:
                r = ftype.residual(xs_r, params)
            rw = _whiten(sqrt_info, r)
            return rw, rw

        z = torch.zeros(total, dtype=sqrt_info.dtype, device=sqrt_info.device)
        J, r_w = torch.func.jacfwd(batch_fn, has_aux=True)(z)  # [N, d, total]
        Js = list(torch.split(J, dims, dim=-1))

    if robust is not None:
        e = torch.linalg.norm(r_w, dim=-1)
        sw = torch.sqrt(robust.weight(e))[:, None]
        r_w = r_w * sw
        Js = [Jk * sw[..., None] for Jk in Js]
    return r_w, tuple(Js)


class NonlinearFactorGraph:
    """Host-side graph builder; factor data lives on `device` in `dtype`."""

    def __init__(self, *, device: DeviceLike = "cuda", dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)  # default float64
        self.batches: List[FactorBatch] = []
        # staging: tag -> (ftype, [keys], [params], [sqrt_info], robust, sign, [mask])
        self._pending: Dict[tuple, tuple] = {}

    def _to_device(self, tree):
        def conv(a):
            a = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
            return a.to(device=self.device, dtype=self.dtype)

        return tree_map(conv, tree)

    # -- construction -----------------------------------------------------

    def add_batch(
        self,
        ftype: FactorType,
        keys,
        params,
        sqrt_info,
        robust: Optional[RobustLoss] = None,
        sign: float = 1.0,
        constrained_mask=None,
    ) -> "NonlinearFactorGraph":
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1, len(ftype.var_types))
        n = keys.shape[0]
        params = self._to_device(params)
        sqrt_info = self._to_device(sqrt_info)
        if sqrt_info.ndim == 2:
            sqrt_info = sqrt_info.expand(n, ftype.resid_dim, ftype.resid_dim)
        if constrained_mask is not None:
            constrained_mask = np.broadcast_to(
                np.asarray(constrained_mask, dtype=bool), (n, ftype.resid_dim)
            )
        self.batches.append(
            FactorBatch(ftype, keys, params, sqrt_info, robust, sign, constrained_mask)
        )
        return self

    def add(
        self,
        ftype,
        keys,
        params,
        sqrt_info,
        robust=None,
        sign: float = 1.0,
        constrained_mask=None,
    ):
        """Add a single factor (staged; batched together per type+robust+sign)."""
        tag = (ftype.name, repr(robust), sign, constrained_mask is not None)
        entry = self._pending.setdefault(tag, (ftype, [], [], [], robust, sign, []))
        entry[1].append(np.asarray(keys, dtype=np.uint64))
        entry[2].append(self._to_device(params))
        entry[3].append(self._to_device(sqrt_info))
        if constrained_mask is not None:
            entry[6].append(np.asarray(constrained_mask, dtype=bool))
        return self

    def _materialize(self):
        for (ftype, keys, params, infos, robust, sign, masks) in self._pending.values():
            self.add_batch(
                ftype,
                np.stack(keys, axis=0),
                tree_stack(params, lambda xs: torch.stack(xs, dim=0)),
                torch.stack(infos, dim=0),
                robust,
                sign,
                np.stack(masks, axis=0) if masks else None,
            )
        self._pending = {}

    @property
    def num_factors(self) -> int:
        self._materialize()
        return sum(b.size for b in self.batches)

    def all_keys(self):
        self._materialize()
        out = []
        seen = set()
        for b in self.batches:
            for k in b.keys.reshape(-1):
                if k not in seen:
                    seen.add(k)
                    out.append(int(k))
        return out

    # -- numeric closures ---------------------------------------------------

    def _batch_rows(self, batch: FactorBatch, values: Values):
        """Host rows and their device copy for one batch (cached per index)."""
        c = batch._rows_cache
        if c is not None and c[0] is values._index and c[1] == len(values._index):
            return c[2], c[3]
        rows = tuple(
            values.rows(batch.keys[:, k], t) for k, t in enumerate(batch.ftype.var_types)
        )
        rows_dev = tuple(
            torch.as_tensor(r, dtype=torch.int64).to(self.device) for r in rows
        )
        batch._rows_cache = (values._index, len(values._index), rows, rows_dev)
        return rows, rows_dev

    def _gather(self, values: Values, batch: FactorBatch, rows_dev):
        return tuple(
            tree_map(lambda a: a[rows_dev[k]], values.params(t))
            for k, t in enumerate(batch.ftype.var_types)
        )

    def _check_values(self, values: Values):
        for t in values.types():
            check_on(tree_leaves(values.params(t))[0], self.device, f"Values[{t}]")

    def error(self, values: Values) -> torch.Tensor:
        """Total graph error = sum 0.5||whitened||^2 (robust: rho(||.||))."""
        self._materialize()
        self._check_values(values)
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for batch in self.batches:
            _, rows_dev = self._batch_rows(batch, values)
            xs = self._gather(values, batch, rows_dev)
            r_w = _whiten(batch.sqrt_info, batch.ftype.residual(xs, batch.params))
            if batch.robust is not None:
                e = torch.linalg.norm(r_w, dim=-1)
                total = total + batch.sign * torch.sum(batch.robust.loss(e))
            else:
                total = total + batch.sign * 0.5 * torch.sum(r_w * r_w)
        return total

    def linearize(self, values: Values) -> LinearizedGraph:
        """Linearize at `values` -> whitened LinearizedGraph, b = -whitened error
        (min ||A delta - b||^2, the JacobianFactor convention)."""
        self._materialize()
        self._check_values(values)
        out = []
        for batch in self.batches:
            rows, rows_dev = self._batch_rows(batch, values)
            xs = self._gather(values, batch, rows_dev)
            r_w, Js = residual_and_jac(
                batch.ftype, batch.robust, xs, batch.params, batch.sqrt_info
            )
            out.append(
                LinearBatch(
                    var_types=batch.ftype.var_types,
                    rows=rows,
                    A=Js,
                    b=-r_w,
                    sign=batch.sign,
                    constrained_mask=batch.constrained_mask,
                    rows_dev=rows_dev,
                )
            )
        counts = {t: values._count(t) for t in values.types()}
        return LinearizedGraph(out, counts)
