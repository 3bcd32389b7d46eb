"""Values — key -> manifold value container, one stacked layout per type.

Port of gtsam_petercdev_tpu/nonlinear/values.py. Each manifold type keeps
ONE stacked parameter layout (leading axis = variables of that type) on the
Values' device; the key -> (type, row) index stays host-side Python, so all
device work is batched per type and `retract` is one chart update per type.

A VectorValues (tangent / delta vector) is {type_name: [N_t, dim_t] tensor}.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_leaves, tree_map, tree_stack
from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype

VectorValues = Dict[str, torch.Tensor]


class Values:
    def __init__(
        self,
        params=None,
        index=None,
        type_keys=None,
        *,
        device: DeviceLike = "cuda",
        dtype=None,
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)  # default float64
        # type -> stacked params layout ([N_t, ...] leaves)
        self._params: Dict[str, Any] = {
            t: self._to_device(p) for t, p in (params or {}).items()
        }
        # key -> (type_name, row); shared (never mutated in place) between a
        # Values and the ones `retract` derives from it
        self._index: Dict[int, Tuple[str, int]] = dict(index) if index else {}
        # type -> ordered list of keys (row order)
        self._type_keys: Dict[str, List[int]] = (
            {t: list(ks) for t, ks in type_keys.items()} if type_keys else {}
        )
        # True while the index is shared with a derived / parent Values
        self._shared_index = False
        # staging area for single-value host-side insertion
        self._pending: Dict[str, List[Any]] = {}

    def _to_device(self, tree):
        def conv(a):
            a = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
            return a.to(device=self.device, dtype=self.dtype)

        return tree_map(conv, tree)

    def _with_params(self, params: Dict[str, Any]) -> "Values":
        """A Values over new params sharing this one's key index."""
        obj = Values.__new__(Values)
        obj.device, obj.dtype = self.device, self.dtype
        obj._params = params
        obj._index = self._index
        obj._type_keys = self._type_keys
        obj._shared_index = self._shared_index = True
        obj._pending = {}
        return obj

    # -- host-side construction ------------------------------------------

    def _own_index(self):
        """Copy the key index before mutating it, if it is shared."""
        if self._shared_index:
            self._index = dict(self._index)
            self._type_keys = {t: list(ks) for t, ks in self._type_keys.items()}
            self._shared_index = False

    def insert(self, key: int, type_name: str, value) -> "Values":
        """Insert a single value (host-side staging; cheap append)."""
        key = int(key)
        if key in self._index:
            raise KeyError(f"key {key} already in Values")
        self._own_index()
        row = self._count(type_name)
        self._index[key] = (type_name, row)
        self._type_keys.setdefault(type_name, []).append(key)
        self._pending.setdefault(type_name, []).append(self._to_device(value))
        return self

    def insert_batch(self, keys, type_name: str, stacked_params) -> "Values":
        """Insert many values of one type from a stacked layout (leaves [N, ...])."""
        keys = [int(k) for k in keys]
        self._own_index()
        # flush pending singles of this type first to keep row order
        if self._pending.get(type_name):
            self._materialize()
        base = self._count(type_name)
        for off, key in enumerate(keys):
            if key in self._index:
                raise KeyError(f"key {key} already in Values")
            self._index[key] = (type_name, base + off)
            self._type_keys.setdefault(type_name, []).append(key)
        new = self._to_device(stacked_params)
        if type_name in self._params:
            self._params[type_name] = tree_map(
                lambda a, b: torch.cat([a, b], dim=0), self._params[type_name], new
            )
        else:
            self._params[type_name] = new
        return self

    def update(self, key: int, value) -> "Values":
        """Replace the value at an existing key (in place on the stack)."""
        t, row = self._index[int(key)]
        self._materialize()
        new = self._to_device(value)

        def put(a, v):
            a = a.clone()
            a[row] = v
            return a

        self._params[t] = tree_map(put, self._params[t], new)
        return self

    def _count(self, t: str) -> int:
        n = len(self._pending.get(t, ()))
        if t in self._params:
            n += tree_leaves(self._params[t])[0].shape[0]
        return n

    def _materialize(self):
        if not self._pending:
            return
        for t, vals in self._pending.items():
            stacked = tree_stack(vals, lambda xs: torch.stack(xs, dim=0))
            if t in self._params:
                self._params[t] = tree_map(
                    lambda a, b: torch.cat([a, b], dim=0), self._params[t], stacked
                )
            else:
                self._params[t] = stacked
        self._pending = {}

    # -- queries ----------------------------------------------------------

    def __contains__(self, key: int) -> bool:
        return int(key) in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def type_of(self, key: int) -> str:
        return self._index[int(key)][0]

    def row_of(self, key: int) -> int:
        return self._index[int(key)][1]

    def type_keys(self, t: str) -> List[int]:
        return list(self._type_keys.get(t, ()))

    def types(self) -> List[str]:
        self._materialize()
        return list(self._params.keys())

    def params(self, t: str):
        self._materialize()
        return self._params[t]

    def at(self, key: int):
        """Single element params."""
        t, row = self._index[int(key)]
        self._materialize()
        return tree_map(lambda a: a[row], self._params[t])

    def rows(self, keys, t: str) -> np.ndarray:
        """Host: rows of `keys` (all of type t) as an int32 array."""
        out = np.empty(len(keys), dtype=np.int32)
        for i, k in enumerate(keys):
            tt, row = self._index[int(k)]
            if tt != t:
                raise TypeError(f"key {k} has type {tt}, expected {t}")
            out[i] = row
        return out

    # -- tangent-space ops --------------------------------------------------

    def retract(self, delta: VectorValues) -> "Values":
        """x (+) delta per type (Values::retract)."""
        self._materialize()
        new_params = {}
        for t, p in self._params.items():
            if t in delta:
                new_params[t] = manifold.get(t).retract(p, delta[t])
            else:
                new_params[t] = p
        return self._with_params(new_params)

    def local(self, other: "Values") -> VectorValues:
        """Tangent of `other` in the chart at self, per type."""
        self._materialize()
        other._materialize()
        return {
            t: manifold.get(t).local(p, other._params[t])
            for t, p in self._params.items()
        }

    def zero_delta(self, dtype=None) -> VectorValues:
        self._materialize()
        out = {}
        for t, p in self._params.items():
            leaf = tree_leaves(p)[0]
            out[t] = torch.zeros(
                (leaf.shape[0], manifold.get(t).dim),
                dtype=dtype or leaf.dtype,
                device=leaf.device,
            )
        return out

    def total_dim(self) -> int:
        self._materialize()
        return sum(
            tree_leaves(p)[0].shape[0] * manifold.get(t).dim
            for t, p in self._params.items()
        )

    def __repr__(self):
        self._materialize()
        counts = {t: self._count(t) for t in self._params}
        return f"Values({counts}, device={self.device})"
