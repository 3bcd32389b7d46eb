"""Checkpoints: save and load Values, factor graphs, solver state and whole
ISAM2 instances.

Port of gtsam_petercdev_tpu/utils/serialization.py. Reference:
gtsam/base/serialization.h:97-270 (boost::serialization of every factor and
value type); examples/SolverComparer.cpp:19-30 round-trips whole solver
states between runs.

State is host numpy plus a small index, pickled. Factor types are stored BY
NAME and resolved through a registry on load (the callable residuals are
never serialized), the analog of boost's polymorphic type registration
(gtsam_unstable/slam/serialization.cpp). Manifold layouts that are
NamedTuples (Pose3, SfmCamera) are stored as {"__layout__": name,
"fields": [...]}, so a file holds numpy arrays and builtins only.

Loading unpickles through `_HostUnpickler`, which admits numpy arrays and
builtins and nothing else: a file that names any other class (a JAX
package's Pose3, say) is refused with a ValueError, never imported. The
Pose2 / vector Values and graph files of the JAX package's
`values_to_bytes` / `graph_to_bytes` load as they are.

Every loader takes `device=` (default "cuda"; it raises without a card
unless "cpu" is asked for) and puts what it loads there.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from gtsam_petercdev_torch.core.tree import tree_map
from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.inference.incremental import (
    CliqueRec, FactorGroup, HostPayload, IncrementalEngine, MsgRec, PoolArrays, PoolClass,
    _make_pool)
from gtsam_petercdev_torch.linear.noise import RobustLoss
from gtsam_petercdev_torch.navigation.ahrs import PreintegratedRotation
from gtsam_petercdev_torch.navigation.preintegration import PIM
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params, _Group, _TypeStore
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.utils import convert

# --- factor-type registry ----------------------------------------------------

_TYPE_REGISTRY: Dict[str, Callable[[], FactorType]] = {}


def register_factor_type(name: str, builder: Callable[[], FactorType]) -> None:
    _TYPE_REGISTRY[name] = builder


def resolve_factor_type(name: str) -> FactorType:
    """FactorType by name: the registry, then the built-in families of
    utils/convert.factor_type (Prior*, Between*, projection factors,
    "LinearContainer[T1,...]<dim>")."""
    if name in _TYPE_REGISTRY:
        return _TYPE_REGISTRY[name]()
    try:
        return convert.factor_type(name)
    except KeyError:
        raise KeyError(f"unknown factor type {name!r}; register it with "
                       "serialization.register_factor_type") from None


# --- host trees and the restricted unpickler ---------------------------------

# NamedTuple layouts by name: the values' and the navigation factors' params
_LAYOUTS = dict(convert._LAYOUTS, PIM=PIM, PreintegratedRotation=PreintegratedRotation)

_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
    ("builtins", "set"), ("builtins", "frozenset"), ("builtins", "complex"),
    ("builtins", "slice"), ("builtins", "range"), ("builtins", "bytearray"),
}


class _HostUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and builtins only."""

    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise ValueError(f"checkpoint names {module}.{name}: only numpy arrays and builtins "
                             "load here (a file that holds another package's classes is refused)")
        return super().find_class(module, name)


def _loads(data: bytes):
    return _HostUnpickler(io.BytesIO(data)).load()


def _to_host(tree):
    """Tensors -> numpy, NamedTuple layouts -> {"__layout__", "fields"}."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple):
        parts = [_to_host(x) for x in tree]
        if hasattr(tree, "_fields"):
            return {"__layout__": type(tree).__name__, "fields": parts}
        return tuple(parts)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _from_host(tree, leaf: Callable[[np.ndarray], torch.Tensor]):
    """Inverse of _to_host: numpy arrays -> leaf(array), layouts rebuilt."""
    if isinstance(tree, np.ndarray):
        return leaf(tree)
    if isinstance(tree, dict):
        if "__layout__" in tree:
            return _LAYOUTS[tree["__layout__"]](*(_from_host(x, leaf) for x in tree["fields"]))
        return {k: _from_host(v, leaf) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_from_host(x, leaf) for x in tree)
    return tree


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A copy of a on device, floating arrays in `dtype` where given."""
    t = torch.tensor(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _rows_into(saved: np.ndarray, cap: int, device, dtype=None) -> torch.Tensor:
    """A zero tensor of cap rows on device whose first rows are `saved`."""
    src = _tensor(saved, device, dtype)
    out = torch.zeros((cap,) + tuple(src.shape[1:]), dtype=src.dtype, device=device)
    out[: src.shape[0]] = src
    return out


def _to_device(tree, device: torch.device, dtype: Optional[torch.dtype] = None):
    return _from_host(tree, lambda a: _tensor(a, device, dtype))


def _host_dtype(tree) -> Optional[torch.dtype]:
    """torch dtype of the first floating numpy array in a host tree."""
    if isinstance(tree, np.ndarray):
        return resolve_dtype(tree.dtype) if tree.dtype.kind == "f" else None
    parts = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, tuple) else ()
    for x in parts:
        dt = _host_dtype(x)
        if dt is not None:
            return dt
    return None


def _robust_spec(r: Optional[RobustLoss]):
    return (r.name, r.k) if r is not None else None


def _robust(spec) -> Optional[RobustLoss]:
    return RobustLoss(*spec) if spec else None


# --- Values ------------------------------------------------------------------


def values_to_bytes(values: Values) -> bytes:
    values._materialize()
    return pickle.dumps({"params": {t: _to_host(values.params(t)) for t in values.types()},
                         "index": dict(values._index),
                         "type_keys": {t: list(ks) for t, ks in values._type_keys.items()}},
                        protocol=4)


def values_from_bytes(data: bytes, *, device: DeviceLike = "cuda", dtype=None) -> Values:
    """Values on `device`, in `dtype` (default: the file's)."""
    state = _loads(data)
    dev = resolve_device(device)
    dt = resolve_dtype(dtype) if dtype is not None else _host_dtype(state["params"])
    return Values({t: _to_device(p, dev, dt) for t, p in state["params"].items()},
                  state["index"], state["type_keys"], device=dev, dtype=dt)


def save_values(path: str, values: Values) -> None:
    with open(path, "wb") as f:
        f.write(values_to_bytes(values))


def load_values(path: str, *, device: DeviceLike = "cuda", dtype=None) -> Values:
    with open(path, "rb") as f:
        return values_from_bytes(f.read(), device=device, dtype=dtype)


# --- NonlinearFactorGraph ----------------------------------------------------


def graph_to_bytes(graph: NonlinearFactorGraph) -> bytes:
    graph._materialize()
    return pickle.dumps({"batches": [
        {"ftype": b.ftype.name, "keys": np.asarray(b.keys), "params": _to_host(b.params),
         "sqrt_info": _to_host(b.sqrt_info), "robust": _robust_spec(b.robust), "sign": b.sign,
         "constrained_mask": b.constrained_mask}
        for b in graph.batches]}, protocol=4)


def graph_from_bytes(data: bytes, *, device: DeviceLike = "cuda", dtype=None) -> NonlinearFactorGraph:
    """The graph on `device`, in `dtype` (default: the file's)."""
    state = _loads(data)
    dev = resolve_device(device)
    batches = state["batches"]
    dt = (resolve_dtype(dtype) if dtype is not None
          else _host_dtype(tuple(bs["sqrt_info"] for bs in batches)))
    graph = NonlinearFactorGraph(device=dev, dtype=dt)
    for bs in batches:
        graph.add_batch(resolve_factor_type(bs["ftype"]), bs["keys"],
                        _to_device(bs["params"], dev, dt), _to_device(bs["sqrt_info"], dev, dt),
                        _robust(bs["robust"]), bs.get("sign", 1.0),
                        constrained_mask=bs.get("constrained_mask"))
    return graph


def save_graph(path: str, graph: NonlinearFactorGraph) -> None:
    with open(path, "wb") as f:
        f.write(graph_to_bytes(graph))


def load_graph(path: str, *, device: DeviceLike = "cuda", dtype=None) -> NonlinearFactorGraph:
    with open(path, "rb") as f:
        return graph_from_bytes(f.read(), device=device, dtype=dtype)


# --- combined solver checkpoint ----------------------------------------------


def save_checkpoint(path: str, graph: Optional[NonlinearFactorGraph] = None,
                    values: Optional[Values] = None, extra: Optional[Dict[str, Any]] = None) -> None:
    """One file of (graph, values, extra arrays): the analog of
    SolverComparer's binary solver-state archives."""
    state = {"graph": graph_to_bytes(graph) if graph is not None else None,
             "values": values_to_bytes(values) if values is not None else None,
             "extra": _to_host(extra) if extra is not None else None}
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)


def load_checkpoint(path: str, *, device: DeviceLike = "cuda"):
    """(graph, values, extra) on `device`."""
    with open(path, "rb") as f:
        state = _loads(f.read())
    dev = resolve_device(device)
    graph = graph_from_bytes(state["graph"], device=dev) if state["graph"] else None
    values = values_from_bytes(state["values"], device=dev) if state["values"] else None
    extra = _to_device(state["extra"], dev) if state["extra"] is not None else None
    return graph, values, extra


# --- whole ISAM2 checkpoint ------------------------------------------------------
#
# The reference serializes whole ISAM2 instances (SolverComparer.cpp:19-30)
# so long incremental runs survive restarts. The engine's state is its host
# records plus its device pools, factor stores and delta; all of it goes to
# host numpy, so that a resumed run repeats the uninterrupted one bit for
# bit: the pools with their capacity, live rows and free lists (row
# allocation order), the message pools, the factor groups, the wrapper's
# stores and groups. The host engine (backend "numpy") has no pools: its
# per-clique payloads and message payloads are saved whole, and the native
# sweep's tables (`_NativeTree`) are rebuilt from the records on load. The
# structural plan cache is not saved: a plan is a function of structure
# alone and is rebuilt on its first miss. A card engine's checkpoint loads
# onto any device; a host engine's loads onto the host engine.

_ISAM2_FORMAT = "gtsam_petercdev_torch.ISAM2/1"
_PARAM_FIELDS = ("relinearize_threshold", "relinearize_skip", "enable_relinearization",
                 "wildfire_threshold", "evaluate_error", "block_dim", "engine_backend")


def _pool_state(p, live_rows) -> tuple:
    """A pool's class, capacity, allocation state and its LIVE rows only:
    a freed row is rewritten whole before it is read again, so it is
    restored as zeros (the dead rows of wide-separator classes are most of
    a long run's pool bytes)."""
    rows = np.asarray(sorted(live_rows), dtype=np.int64)
    idx = torch.as_tensor(rows, device=p.arrays.L.device)
    return (p.nf, p.ns, p.cap, p.top, list(p.free), rows,
            tuple(a.index_select(0, idx).cpu().numpy() for a in p.arrays))


def isam2_to_bytes(isam) -> bytes:
    eng = isam.engine
    if eng is None:
        raise ValueError("empty ISAM2 (no update yet)")
    engine = {
        "d": eng.d, "n": eng.n, "var_dims": eng.var_dims, "xcap": eng.xcap,
        "backend": eng.backend, "x": _to_host(eng.x),
        "payloads": {cid: tuple(p) for cid, p in eng.payloads.items()},
        "msg_payloads": dict(eng.msg_payloads),
        "pools": [_pool_state(p, [c.row for c in eng.cliques if c is not None and c.cls == k])
                  for k, p in eng.pools.items()],
        "msg_pools": [_pool_state(p, [m.row for m in eng.msgs if m.alive and m.ns == k])
                      for k, p in eng.msg_pools.items()],
        "cliques": [None if c is None else
                    (c.cid, c.cls, c.row, c.frontal, c.separator, c.parent, list(c.children),
                     c.owned_fac, c.owned_msg, c.alive) for c in eng.cliques],
        "var_clique": dict(eng.var_clique),
        "groups": [(fg.K, fg.dims, fg.sign, fg.cap, tuple(_to_host(a[: fg.n]) for a in fg.A),
                    _to_host(fg.b[: fg.n]), fg.keys[: fg.n], fg.n) for fg in eng.groups],
        "var_factors": {k: list(v) for k, v in eng.var_factors.items()},
        "msgs": [(m.mid, m.ns, m.row, m.scope, m.alive) for m in eng.msgs],
        "removed_units": sorted(eng.removed_units),
        "n_live": eng.n_live,
    }
    wrapper = {
        "params": {k: getattr(isam.params, k) for k in _PARAM_FIELDS},
        "dtype": str(isam.dtype).split(".")[1],
        "gid_key": list(isam._gid_key), "gid_type": list(isam._gid_type),
        "gid_row": list(isam._gid_row),
        "stores": {t: (st.n, st.cap, st.gids[: st.n], _to_host(_first_rows(st.params, st.n)))
                   for t, st in isam._stores.items()},
        "groups": [None if g is None else {
            "ftype": g.ftype.name, "robust": _robust_spec(g.robust), "sign": g.sign, "n": g.n,
            "cap": g.cap, "params": _to_host(_first_rows(g.params, g.n)),
            "sqrt_info": g.sqrt_info[: g.n].cpu().numpy(), "keys": g.keys[: g.n],
            "retired": g.retired[: g.n]} for g in isam._groups],
        "families": {g: (ft.name, fam) for g, (ft, fam) in isam._families.items()},
        "marginalized": sorted(isam._marginalized),
        "fixed_gids": sorted(isam._fixed_gids),
        "update_count": isam._update_count,
    }
    return pickle.dumps({"format": _ISAM2_FORMAT, "engine": engine, "wrapper": wrapper},
                        protocol=4)


def _np_rows_into(saved: np.ndarray, cap: int, dtype) -> np.ndarray:
    """A zero host array of cap rows whose first rows are `saved`."""
    out = np.zeros((cap,) + saved.shape[1:], dtype=dtype)
    out[: saved.shape[0]] = saved
    return out


def _first_rows(tree, n: int):
    return tree_map(lambda a: a[:n], tree)


def isam2_from_bytes(data: bytes, *, device: DeviceLike = "cuda"):
    """An ISAM2 restored onto `device` from isam2_to_bytes' output. A host
    engine's checkpoint resumes on the host engine and needs device="cpu"
    (any other raises ValueError, as ISAM2Params does)."""
    state = _loads(data)
    if not isinstance(state, dict) or state.get("format") != _ISAM2_FORMAT:
        raise ValueError("not an ISAM2 checkpoint of gtsam_petercdev_torch "
                         f"(format {state.get('format') if isinstance(state, dict) else None!r})")
    es, ws = state["engine"], state["wrapper"]
    dtype = resolve_dtype(ws["dtype"])
    isam = ISAM2(ISAM2Params(**ws["params"], device=device, dtype=dtype))
    dev = isam.device
    backend = es.get("backend", "torch")
    eng = isam._engine = IncrementalEngine(es["d"], dtype=dtype, device=dev, backend=backend)
    eng.n, eng.var_dims, eng.xcap = es["n"], np.asarray(es["var_dims"]), es["xcap"]
    if eng._np:
        rows_into = lambda a, cap: _np_rows_into(a, cap, eng._npdtype)
        eng.x = rows_into(es["x"], es["xcap"] + 1)
        eng.payloads = {cid: HostPayload(*(np.array(a) for a in p))
                        for cid, p in es["payloads"].items()}
        eng.msg_payloads = {mid: (np.array(u), np.array(g))
                            for mid, (u, g) in es["msg_payloads"].items()}
    else:
        rows_into = lambda a, cap: _rows_into(a, cap, dev, dtype)
        eng.x = rows_into(es["x"], es["xcap"] + 1)

    def pool(ps):
        nf, ns, cap, top, free, rows, arrays = ps
        pa = _make_pool(nf, ns, es["d"], cap, dtype, dev)
        idx = torch.as_tensor(rows, device=dev)
        for dst, src in zip(pa, arrays):
            dst.index_copy_(0, idx, _tensor(src, dev))
        return PoolClass(nf, ns, cap, PoolArrays(*pa), list(free), top)

    for ps in es["pools"]:
        p = pool(ps)
        eng.pools[(p.nf, p.ns)] = p
    for ps in es["msg_pools"]:
        p = pool(ps)
        eng.msg_pools[p.ns] = p
    for cs in es["cliques"]:
        eng.cliques.append(None if cs is None else CliqueRec(
            cid=cs[0], cls=tuple(cs[1]), row=cs[2], frontal=list(cs[3]), separator=list(cs[4]),
            parent=cs[5], children=set(cs[6]), owned_fac=[tuple(u) for u in cs[7]],
            owned_msg=list(cs[8]), alive=cs[9]))
    if eng._nat is not None:  # the native sweep's tables, from the records
        for rec in eng.cliques:
            if rec is not None and rec.alive:
                eng._nat.alloc(rec, eng.payloads[rec.cid])
        for rec in eng.cliques:
            if rec is not None and rec.alive and rec.parent >= 0:
                eng._nat.set_parent(rec, eng.cliques[rec.parent])
    eng.var_clique = dict(es["var_clique"])
    for gid, (K, dims, sign, cap, A, b, keys, n) in enumerate(es["groups"]):
        k_all = np.zeros((cap, K), dtype=np.int64)
        k_all[:n] = keys
        eng.groups.append(FactorGroup(
            gid=gid, K=K, dims=tuple(dims), sign=sign, cap=cap,
            A=tuple(rows_into(a, cap) for a in A), b=rows_into(b, cap),
            keys=k_all, n=n))
    eng.var_factors = {k: [tuple(u) for u in v] for k, v in es["var_factors"].items()}
    eng.msgs = [MsgRec(mid=m[0], ns=m[1], row=m[2], scope=list(m[3]), alive=m[4])
                for m in es["msgs"]]
    eng.removed_units = set(map(tuple, es["removed_units"]))
    eng.n_live = es["n_live"]

    isam._gid_key, isam._gid_type = list(ws["gid_key"]), list(ws["gid_type"])
    isam._gid_row = list(ws["gid_row"])
    isam._key_gid = {int(k): g for g, k in enumerate(isam._gid_key)}
    for t, (n, cap, gids, params) in ws["stores"].items():
        st = _TypeStore(t)
        st.n, st.cap = n, cap
        st.gids = np.zeros(cap, dtype=np.int64)
        st.gids[:n] = gids
        st.params = _from_host(params, lambda a: _rows_into(a, cap, dev, dtype))
        isam._stores[t] = st
    for g, gs in enumerate(ws["groups"]):
        if gs is None:
            isam._groups.append(None)
            continue
        ftype, robust = resolve_factor_type(gs["ftype"]), _robust(gs["robust"])
        grp = _Group(ftype, robust, gs["sign"])
        grp.n, grp.cap = gs["n"], gs["cap"]
        grp.params = _from_host(gs["params"], lambda a: _rows_into(a, grp.cap, dev, dtype))
        grp.sqrt_info = _rows_into(gs["sqrt_info"], grp.cap, dev, dtype)
        grp.keys = np.zeros((grp.cap,) + gs["keys"].shape[1:], dtype=gs["keys"].dtype)
        grp.keys[: grp.n] = gs["keys"]
        grp.retired = np.zeros(grp.cap, dtype=bool)
        grp.retired[: grp.n] = gs["retired"]
        isam._groups.append(grp)
        # the engine's group key, as ISAM2._group_for builds it for new factors
        eng._group_key[(ftype, repr(robust), float(gs["sign"]))] = g
    # a checkpoint without them re-linearizes each row block on its own
    isam._families = {g: (resolve_factor_type(name), tuple(fam))
                      for g, (name, fam) in ws.get("families", {}).items()}
    isam._marginalized = set(ws["marginalized"])
    isam._fixed_gids = set(ws["fixed_gids"])
    isam._update_count = ws["update_count"]
    return isam


def save_isam2(path: str, isam) -> None:
    """Checkpoint a whole ISAM2 (Bayes tree, cached factors, delta,
    linearization points) so an incremental run can resume mid-stream."""
    with open(path, "wb") as f:
        f.write(isam2_to_bytes(isam))


def load_isam2(path: str, *, device: DeviceLike = "cuda"):
    with open(path, "rb") as f:
        return isam2_from_bytes(f.read(), device=device)
