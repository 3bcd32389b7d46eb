"""ISAM2 — incremental smoothing and mapping on the Bayes-tree engine.

Port of gtsam_petercdev_tpu/nonlinear/isam2.py. Reference:
gtsam/nonlinear/ISAM2.{h,cpp} (update ISAM2.cpp:419-484, relinearization
marking :454-468, recalculate :117-363, wildfire back-substitution
ISAM2Clique.cpp:237).

The heavy lifting lives in inference/incremental.py (pool-backed Bayes
tree, removeTop / orphan surgery, the bucket kernels, wildfire). This
wrapper owns the NONLINEAR side as the reference's ISAM2 does:

  1. addVariables: new theta entries get global ids (gids) and engine rows.
  2. pushBackFactors: new factors are linearized once and cached in the
     engine's factor stores (cacheLinearizedFactors semantics).
  3. gatherRelinearizeKeys: every `relinearize_skip` updates, variables
     with |delta| > relinearize_threshold are marked.
  4. retractMasked (Values.h:229): ONLY marked variables move their
     linearization point; their delta zeroes; every cached factor row
     touching them is re-linearized in place.
  5. engine.update re-eliminates the affected top and wildfire-solves delta.

Everything numeric stays on `ISAM2Params.device` (default "cuda"; without a
card it raises unless "cpu" is asked for): the linearization point in
per-type stores, the factors' parameters and noise, the engine's pools and
delta. The host keeps keys and the tree. The only device -> host reads of
an update are the engine's (the relinearization scan and one per wildfire
round); `ISAM2Result.bad_pivots` stays a device tensor until it is read.

`ISAM2Params.engine_backend` picks the engine: "torch" (the default: the
pools and the bucket kernels on `device`) or "numpy" (the host engine of
inference/incremental.py: exact per-clique payloads and the native sweeps,
float64 on device "cpu" only; any other device raises ValueError). The JAX
package's "auto" sniffs the host (numpy on a CPU host); the port's caller
names the device and the engine, and nothing is moved behind their back.

Incremental-vs-batch contract (tests/testGaussianISAM2.cpp): with
wildfire_threshold = 0 the delta equals a from-scratch batch solve of the
same linearized system to solver precision.

`marginalize_leaves` (ISAM2.cpp:487-724) eliminates variables out of the
tree for good: their factors become Gaussian marginal messages on the live
separator, whose variables are never relinearized again (the reference's
fixedVariables_), and a new factor on a marginalized key is refused.
`marginal_covariance` / `joint_marginal_covariance` read the Bayes tree's
top-down covariance sweep (inference/treemarg.py), cached per update.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_leaves, tree_map
from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.inference.incremental import IncrementalEngine
from gtsam_petercdev_torch.inference.treemarg import TreeMarginals
from gtsam_petercdev_torch.nonlinear.factor_graph import (
    FactorBatch,
    NonlinearFactorGraph,
    residual_and_jac,
    row_block,
)
from gtsam_petercdev_torch.nonlinear.values import Values


@dataclass
class ISAM2Params:
    relinearize_threshold: float = 0.1
    relinearize_skip: int = 10
    enable_relinearization: bool = True
    # 0.0 = exact full back-substitution; reference default 0.001
    # (ISAM2Params.h optimizationParams wildfireThreshold)
    wildfire_threshold: float = 0.001
    evaluate_error: bool = False  # fill ISAM2Result.error_* (costs O(graph))
    block_dim: Optional[int] = None  # pad dim; default max dim of first types
    device: DeviceLike = "cuda"
    dtype: Any = None  # default float64
    # "torch" | "numpy" (the host engine: device "cpu", float64); module docstring
    engine_backend: str = "torch"


def check_engine_backend(engine_backend: str, device: DeviceLike, dtype=None) -> None:
    """Raise ValueError unless `engine_backend` is "torch" or "numpy", and
    for "numpy" (the host engine) unless `device` is the CPU and `dtype`
    float64 (None: the default, float64)."""
    if engine_backend not in ("torch", "numpy"):
        raise ValueError(f"engine_backend must be 'torch' or 'numpy', not {engine_backend!r}")
    if engine_backend == "numpy" and torch.device(device).type != "cpu":
        raise ValueError(f"engine_backend='numpy' is the host engine: it runs on device='cpu', "
                         f"not {device!r}")
    if engine_backend == "numpy" and resolve_dtype(dtype) != torch.float64:
        raise ValueError(f"engine_backend='numpy' is the host engine: it runs in float64, "
                         f"not {dtype!r}")


@dataclass
class ISAM2Result:
    error_before: Optional[float] = None
    error_after: Optional[float] = None
    n_relinearized: int = 0
    n_new_factors: int = 0
    n_affected_cliques: int = 0
    n_orphans: int = 0
    n_reeliminated: int = 0
    wildfire_rounds: int = 0
    bad_pivots: Any = 0  # int32 device tensor (0 when nothing was eliminated)
    n_cliques: int = 0
    # engine units of the factors added THIS update (pass to remove_factors);
    # a factor wider than the block dimension has row_blocks() of them,
    # block-major within its batch
    new_factor_units: List[Tuple[int, int]] = field(default_factory=list)


def _grow_rows(t: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """t's first n rows in a zero tensor of cap rows."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[:n] = t[:n]
    return out


class _TypeStore:
    """Device store of one manifold type's linearization points, a row per
    variable, grown by doubling."""

    __slots__ = ("t", "mt", "n", "cap", "params", "gids")

    def __init__(self, t: str):
        self.t = t
        self.mt = manifold.get(t)
        self.n = 0
        self.cap = 0
        self.params = None  # layout of the type, leaves [cap, ...]
        self.gids = np.zeros(0, dtype=np.int64)  # [cap] gid per row

    def append(self, params) -> List[int]:
        """Store k new rows (leaves [k, ...] on the store's device)."""
        k = tree_leaves(params)[0].shape[0]
        if self.n + k > self.cap:
            cap = max(64, self.cap)
            while cap < self.n + k:
                cap *= 2
            if self.params is None:
                self.params = tree_map(lambda a: _grow_rows(a, 0, cap), params)
            else:
                self.params = tree_map(lambda a: _grow_rows(a, self.n, cap), self.params)
            g = np.zeros(cap, dtype=np.int64)
            g[: self.n] = self.gids[: self.n]
            self.gids, self.cap = g, cap
        tree_map(lambda dst, src: dst[self.n : self.n + k].copy_(src), self.params, params)
        rows = list(range(self.n, self.n + k))
        self.n += k
        return rows


class _Group:
    """One engine factor group's nonlinear factors: parameters and noise on
    the device (relinearization reads them there), keys and retired flags
    on the host."""

    __slots__ = ("ftype", "robust", "sign", "n", "cap", "params", "sqrt_info", "keys", "retired")

    def __init__(self, ftype, robust, sign):
        self.ftype = ftype
        self.robust = robust
        self.sign = sign
        self.n = 0
        self.cap = 0
        self.params = None  # leaves [cap, ...] on the device
        self.sqrt_info = None  # [cap, rd, rd] on the device
        self.keys = None  # numpy [cap, K]
        self.retired = None  # numpy bool [cap]

    def append(self, params, sqrt_info, keys_np) -> List[int]:
        k = keys_np.shape[0]
        if self.n + k > self.cap:
            cap = max(16, self.cap)
            while cap < self.n + k:
                cap *= 2
            src = (params, sqrt_info) if self.params is None else (self.params, self.sqrt_info)
            n_old = 0 if self.params is None else self.n
            self.params = tree_map(lambda a: _grow_rows(a, n_old, cap), src[0])
            self.sqrt_info = _grow_rows(src[1], n_old, cap)
            keys = np.zeros((cap,) + keys_np.shape[1:], dtype=keys_np.dtype)
            retired = np.zeros(cap, dtype=bool)
            if n_old:
                keys[:n_old], retired[:n_old] = self.keys[:n_old], self.retired[:n_old]
            self.keys, self.retired, self.cap = keys, retired, cap
        sl = slice(self.n, self.n + k)
        tree_map(lambda dst, s: dst[sl].copy_(s), self.params, params)
        self.sqrt_info[sl] = sqrt_info
        self.keys[sl] = keys_np
        rows = list(range(self.n, self.n + k))
        self.n += k
        return rows


class ISAM2:
    def __init__(self, params: Optional[ISAM2Params] = None):
        self.params = params or ISAM2Params()
        check_engine_backend(self.params.engine_backend, self.params.device, self.params.dtype)
        self.device = resolve_device(self.params.device)
        self.dtype = resolve_dtype(self.params.dtype)
        self._engine: Optional[IncrementalEngine] = None
        self._key_gid: Dict[int, int] = {}
        self._gid_key: List[int] = []
        self._gid_type: List[str] = []
        self._gid_row: List[int] = []  # row in the type store
        self._stores: Dict[str, _TypeStore] = {}
        self._groups: List[Optional[_Group]] = []
        self._marginalized: Set[int] = set()  # keys eliminated out of the tree
        # gids in the scope of persistent marginal factors: never relinearized
        # (the reference's fixedVariables_, ISAM2.cpp:693)
        self._fixed_gids: Set[int] = set()
        self._update_count = 0
        self._tm_cache: Optional[Tuple[int, TreeMarginals]] = None

    # -- public API -----------------------------------------------------------

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_theta: Optional[Values] = None,
        force_relinearize: bool = False,
    ) -> ISAM2Result:
        res = ISAM2Result()
        self._update_count += 1
        eng = self._ensure_engine(new_theta)

        if self.params.evaluate_error and self._gid_key:
            # errorBefore at the pre-update estimate (theta + delta)
            res.error_before = self.error(self.calculate_estimate())

        # 1. add variables
        new_gids = self._add_variables(new_theta)

        # 2. add factors (linearize once, cache in the engine)
        marked: Set[int] = set()
        new_units: List[Tuple[int, int]] = []
        if new_factors is not None:
            new_factors._materialize()
            for batch in new_factors.batches:
                bad = [int(k) for k in batch.keys.reshape(-1) if int(k) in self._marginalized]
                if bad:
                    raise ValueError(f"factor references marginalized key(s) {bad[:4]}")
                gids = np.asarray([[self._key_gid[int(k)] for k in row] for row in batch.keys],
                                  dtype=np.int64)
                for b in self._engine_batches(batch):
                    g = self._group_for(b)
                    rows = self._groups[g].append(
                        self._to_device(b.params), self._to_device(b.sqrt_info),
                        np.asarray(b.keys, dtype=np.int64))
                    A, bb = self._linearize_rows(g, rows)
                    new_units.extend((g, r) for r in eng.add_factors(g, gids, A, bb))
                res.n_new_factors += batch.size
                marked.update(int(v) for v in gids.reshape(-1))
        marked -= set(new_gids)  # new keys go through new_keys (ordered last)

        # 3. relinearization marking (gatherRelinearizeKeys, ISAM2.cpp:454)
        relin: Set[int] = set()
        if self.params.enable_relinearization and (
            force_relinearize or self._update_count % self.params.relinearize_skip == 0
        ):
            md = eng.var_max_delta()
            for gid in np.where(md > self.params.relinearize_threshold)[0]:
                gid = int(gid)
                if gid in eng.var_clique and gid not in self._fixed_gids:
                    relin.add(gid)
        res.n_relinearized = len(relin)

        # 4. retractMasked + row-granular relinearization
        if relin:
            self._retract_masked(relin)
            eng.zero_delta_rows(sorted(relin))
            touched: Dict[int, Set[int]] = {}
            for gid in relin:
                for (g, r) in eng.var_factors.get(gid, ()):
                    touched.setdefault(g, set()).add(r)
            for g, rows in touched.items():
                rows = sorted(rows)
                A, bb = self._linearize_rows(g, rows)
                eng.set_factor_rows(g, rows, A, bb)

        # 5. re-eliminate the affected top + wildfire
        stats = eng.update(new_keys=new_gids, new_fac_units=new_units, marked=marked,
                           relin=relin, wildfire_threshold=self.params.wildfire_threshold)
        res.n_affected_cliques = stats.get("n_affected_cliques", 0)
        res.n_orphans = stats.get("n_orphans", 0)
        res.n_reeliminated = stats.get("n_reeliminated", 0)
        res.wildfire_rounds = stats.get("wildfire_rounds", 0)
        res.bad_pivots = stats.get("bad_pivots", 0)
        res.n_cliques = eng.n_live
        res.new_factor_units = list(new_units)
        if self.params.evaluate_error:
            res.error_after = self.error(self.calculate_estimate())
        return res

    def remove_factors(self, units: Sequence[Tuple[int, int]]) -> None:
        """Remove previously added factors by their engine units (returned
        in ISAM2Result.new_factor_units) — the ISAM2UpdateParams
        removeFactorIndices analog. The affected part of the tree is
        re-eliminated without the removed information."""
        if not units:
            return
        eng = self._engine
        for (g, r) in units:
            grp = self._groups[g]
            if grp is not None and grp.retired is not None and r < grp.n:
                grp.retired[r] = True
        marked = {g for g in eng.remove_factor_units(units) if g in eng.var_clique}
        if marked:
            eng.update(marked=marked, wildfire_threshold=self.params.wildfire_threshold)
        self._update_count += 1
        self._tm_cache = None

    @property
    def theta(self) -> Values:
        """The linearization point as a Values (materialized on demand)."""
        return self._theta_values()

    def calculate_estimate(self) -> Values:
        """theta (+) delta (ISAM2.cpp:786-818); marginalized variables are
        gone from it (ISAM2.cpp:717)."""
        eng = self._engine
        v = Values(device=self.device, dtype=self.dtype)
        for t, st in self._stores.items():
            live = self._live_params(st)
            if live is not None:
                gids, p = live
                v.insert_batch([self._gid_key[g] for g in gids], t,
                               st.mt.retract(p, eng.delta_rows(gids, st.mt.dim)))
        return v

    def calculate_estimate_key(self, key: int):
        """Single-variable estimate theta[key] (+) delta[key] on the device
        (ISAM2::calculateEstimate(Key); no full retract, no host read)."""
        gid = self._key_gid[int(key)]
        st = self._stores[self._gid_type[gid]]
        p = tree_map(lambda a: a[self._gid_row[gid]], st.params)
        return st.mt.retract(p, self._engine.delta_at(gid, st.mt.dim))

    def delta(self) -> Dict[str, torch.Tensor]:
        eng = self._engine
        return {t: eng.delta_rows(st.gids[: st.n], st.mt.dim)
                for t, st in self._stores.items() if st.n}

    def error(self, values: Optional[Values] = None) -> float:
        """Total nonlinear error over all live (non-removed) factors."""
        values = values if values is not None else self.calculate_estimate()
        return float(self._as_graph().error(values))

    def marginal_covariance(self, key: int) -> torch.Tensor:
        """Tangent-space marginal covariance at the linearization point:
        ISAM2::marginalCovariance through the Bayes tree's top-down sweep
        (inference/treemarg.py; BayesTreeCliqueBase.h:172-203 semantics)."""
        gid = self._key_gid[int(key)]
        d = manifold.get(self._gid_type[gid]).dim
        return self._tree_marginals().covariance_gid(gid)[:d, :d]

    def joint_marginal_covariance(self, keys: Sequence[int]) -> torch.Tensor:
        """Joint covariance over keys that share one clique scope (adjacent
        states, commonly). Raises ValueError where they span cliques: use
        nonlinear.marginals.Marginals for arbitrary joints."""
        gids = [self._key_gid[int(k)] for k in keys]
        J = self._tree_marginals().joint_gids(gids)
        if J is None:
            raise ValueError("keys do not share a clique scope; use nonlinear.Marginals")
        d = self._engine.d
        dims = [manifold.get(self._gid_type[g]).dim for g in gids]
        sel = self._engine._upload(np.concatenate([i * d + np.arange(dd) for i, dd in enumerate(dims)]))
        return J[sel][:, sel]

    def _tree_marginals(self) -> TreeMarginals:
        if self._tm_cache is None or self._tm_cache[0] != self._update_count:
            self._tm_cache = (self._update_count, TreeMarginals(self._engine))
        return self._tm_cache[1]

    def marginalize_leaves(self, keys: Sequence[int], keep_messages: bool = True) -> None:
        """ISAM2::marginalizeLeaves (ISAM2.cpp:487-724): eliminate the given
        variables out of the tree for good, their factors replaced by
        Gaussian marginals on the live separator variables, which become
        FIXED (never relinearized). Raises RuntimeError where a key is not
        in a clique of marginalized variables only after the re-elimination
        (the fixed-lag smoother retries key by key)."""
        eng = self._engine
        gids = [self._key_gid[int(k)] for k in keys if int(k) in self._key_gid]
        n_msgs_before = len(eng.msgs)
        # the tree is re-eliminated even where the engine then raises: cached
        # marginals index the old cliques (the cache key _update_count does
        # not change here)
        self._tm_cache = None
        for (g, r) in eng.marginalize_leaves(gids, keep_messages=keep_messages):
            grp = self._groups[g]
            if grp is not None and r < grp.n:
                grp.retired[r] = True
        for mr in eng.msgs[n_msgs_before:]:
            self._fixed_gids.update(int(v) for v in mr.scope)
        self._marginalized.update(int(k) for k in keys)

    # -- internals --------------------------------------------------------------

    def _to_device(self, tree):
        return tree_map(lambda a: a.to(device=self.device, dtype=self.dtype), tree)

    def _ensure_engine(self, new_theta: Optional[Values]) -> IncrementalEngine:
        if self._engine is not None:
            return self._engine
        types = new_theta.types() if new_theta is not None else []
        if not types:
            raise ValueError("first ISAM2.update must introduce variables")
        d = self.params.block_dim or max(manifold.get(t).dim for t in types)
        self._engine = IncrementalEngine(d, dtype=self.dtype, device=self.device,
                                         backend=self.params.engine_backend)
        return self._engine

    def _add_variables(self, new_theta: Optional[Values]) -> List[int]:
        if new_theta is None:
            return []
        new_gids: List[int] = []
        dims: List[int] = []
        for t in new_theta.types():
            st = self._stores.get(t)
            if st is None:
                st = self._stores[t] = _TypeStore(t)
            keys_t = new_theta.type_keys(t)
            for key in keys_t:
                if int(key) in self._key_gid:
                    raise KeyError(f"key {key} already in ISAM2")
            rows = st.append(self._to_device(new_theta.params(t)))
            for key, row in zip(keys_t, rows):
                gid = len(self._gid_key)
                self._key_gid[int(key)] = gid
                self._gid_key.append(int(key))
                self._gid_type.append(t)
                self._gid_row.append(row)
                st.gids[row] = gid
                dims.append(st.mt.dim)
                new_gids.append(gid)
        self._engine.add_variables(dims)
        return new_gids

    def row_blocks(self, ftype) -> int:
        """Engine units a factor of ftype takes: 1, or where its whitened
        residual is wider than the block dimension, its row blocks
        (_engine_batches; ISAM2Result.new_factor_units holds a batch's
        units block-major)."""
        return -(-ftype.resid_dim // self._engine.d)

    def _engine_batches(self, b: FactorBatch):
        """b, or where its whitened residual is wider than the engine's
        block dimension d, its row blocks of d rows (factor_graph.row_block:
        together the same Hessian and error), each an engine factor row."""
        d, rd = self._engine.d, b.ftype.resid_dim
        if rd <= d:
            yield b
            return
        if b.robust is not None:
            raise ValueError(f"a robust factor wider than the block dimension ({rd} > {d} rows) "
                             "cannot be split into row blocks; set ISAM2Params.block_dim")
        for a in range(0, rd, d):
            z = min(a + d, rd)
            yield FactorBatch(row_block(b.ftype, a, z), b.keys, b.params, b.sqrt_info[:, a:z],
                              None, b.sign)

    def _group_for(self, b: FactorBatch) -> int:
        eng = self._engine
        dims = tuple(manifold.get(t).dim for t in b.ftype.var_types)
        if max(dims) > eng.d:
            raise ValueError(f"factor dims {dims} exceed engine block dim {eng.d}; "
                             "set ISAM2Params.block_dim")
        # key on the objects themselves (FactorType is a frozen dataclass):
        # two distinct factor families never share a group
        key = (b.ftype, repr(b.robust), float(b.sign))
        g = eng.group_for(key, len(dims), dims, b.sign)
        while len(self._groups) <= g:
            self._groups.append(None)
        if self._groups[g] is None:
            self._groups[g] = _Group(b.ftype, b.robust, float(b.sign))
        return g

    def _linearize_rows(self, g: int, rows: List[int]):
        """(Re-)linearize some of one group's factors at the current theta:
        (A per slot [N, d, dim_k], b [N, d]), residual rows padded to d."""
        grp = self._groups[g]
        ftype = grp.ftype
        d = self._engine.d
        keys_sel = grp.keys[rows]  # [N, K]
        # one upload: the factor rows, then each slot's rows in its type store
        idx = self._engine._upload(np.stack(
            [np.asarray(rows)] + [[self._gid_row[self._key_gid[int(k)]] for k in keys_sel[:, kk]]
                                  for kk in range(keys_sel.shape[1])]))
        params = tree_map(lambda a: a[idx[0]], grp.params)
        xs = tuple(tree_map(lambda a, i=kk: a[idx[1 + i]], self._stores[t].params)
                   for kk, t in enumerate(ftype.var_types))
        r_w, Js = residual_and_jac(ftype, grp.robust, xs, params, grp.sqrt_info[idx[0]])
        rd = ftype.resid_dim
        b = -r_w
        if rd < d:
            Js = tuple(torch.nn.functional.pad(Jk, (0, 0, 0, d - rd)) for Jk in Js)
            b = torch.nn.functional.pad(b, (0, d - rd))
        return Js, b

    def _retract_masked(self, relin_gids: Set[int]):
        """Values::retractMasked (Values.h:229): move the linearization point
        of ONLY the marked variables by their current delta."""
        eng = self._engine
        by_type: Dict[str, List[int]] = {}
        for gid in sorted(relin_gids):
            by_type.setdefault(self._gid_type[gid], []).append(gid)
        for t, gids in by_type.items():
            st = self._stores[t]
            idx = eng._upload(np.stack([gids, [self._gid_row[g] for g in gids]]))
            p = tree_map(lambda a: a[idx[1]], st.params)
            newp = st.mt.retract(p, eng.delta_at(idx[0], st.mt.dim))
            tree_map(lambda a, v: a.index_copy_(0, idx[1], v), st.params, newp)

    def _live_params(self, st: _TypeStore):
        """(gids, params) of the store's variables still in the tree, or None
        where there is none."""
        if st.n == 0:
            return None
        if self._marginalized:
            live = np.asarray([self._gid_key[g] not in self._marginalized
                               for g in st.gids[: st.n]])
            if not live.any():
                return None
            if not live.all():
                rows = np.nonzero(live)[0]
                idx = self._engine._upload(rows)
                return st.gids[rows], tree_map(lambda a: a[idx], st.params)
        return st.gids[: st.n], tree_map(lambda a: a[: st.n], st.params)

    def _theta_values(self) -> Values:
        v = Values(device=self.device, dtype=self.dtype)
        for t, st in self._stores.items():
            live = self._live_params(st)
            if live is not None:
                v.insert_batch([self._gid_key[g] for g in live[0]], t, live[1])
        return v

    def _as_graph(self) -> NonlinearFactorGraph:
        g = NonlinearFactorGraph(device=self.device, dtype=self.dtype)
        for grp in self._groups:
            if grp is None or grp.n == 0:
                continue
            live = ~grp.retired[: grp.n]
            if not live.any():
                continue
            rows = self._engine._upload(np.nonzero(live)[0])
            g.add_batch(grp.ftype, grp.keys[: grp.n][live].astype(np.uint64),
                        tree_map(lambda a: a[rows], grp.params), grp.sqrt_info[rows],
                        grp.robust, grp.sign)
        return g

    # exposed for tests and harnesses
    @property
    def engine(self) -> IncrementalEngine:
        return self._engine
