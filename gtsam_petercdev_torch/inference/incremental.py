"""Incremental supernodal elimination — the Bayes tree, its payloads on the card.

Port of gtsam_petercdev_tpu/inference/incremental.py, the design of its
"jax" backend (host Bayes tree, shape-class pools on the device, index maps
passed at run time). Reference: gtsam/nonlinear/ISAM2.cpp:117-363
(recalculate), inference/BayesTree-inst.h:464-501 (removeTop / orphans),
ISAM2Clique.{h,cpp} (cached separator factors, wildfire back-substitution).

* The Bayes tree lives as HOST records (CliqueRec: frontal / separator
  gids, parent / children, owned factor rows) plus DEVICE pools: for each
  clique shape class (nf, ns) one set of tensors L / Linv / W / y / U / ug
  with a free list. A clique's numeric payload is one row of its class
  pool; U / ug is its cached separator factor (ISAM2Clique::cachedFactor_),
  kept in the d x d block layout the parent's block pool adds it in.

* update(...) does the reference's removeTop: affected cliques = ancestor
  closure of the cliques holding marked keys (frontal occurrence for
  new-factor keys, the containment subtree for relinearized keys).
  Children of affected cliques that are not affected themselves become
  ORPHANS; their cached (U, ug) re-enter the local elimination as dense
  message factors (ISAM2.cpp:286-300).

* The local problem (owned factors of the affected cliques, orphan
  messages, new factors) is assembled into one block pool [n_blocks + 1,
  d*d] and eliminated level by level, one bucket a level
  (`level_route`): K4 (`ops.cholesky.partial_cholesky_blocks`) factors the
  pool slice in place when a clique fits shared memory, else K1
  (`ops.cholesky_v2.partial_cholesky`) factors its dense relayout; U / ug
  are extend-added into the parents' blocks of the same pool. Every pool
  sum is split on the host into rounds of unique destinations
  (`AddRounds`), so the card adds the same operands in the same order as
  the CPU's sequential `index_add_`: no atomics race, and a run repeats
  bit for bit. Every
  level's frontal blocks are complete before the level runs (the children
  are in earlier levels), so K4 takes any bucket that fits, not only
  leaves. The index maps of a local problem depend on its structure alone
  and are cached on the device (`_LocalPlan`): the steady odometry update
  uploads no map.

* Back-substitution is "wildfire" (ISAM2Clique.cpp:237): a host-driven
  frontier descent from the re-eliminated cliques, one K2 launch
  (`ops.cholesky_v2.backsolve_bucket`, fused y - W xs) per round and shape
  class, that stops descending into subtrees whose separator delta changed
  by no more than the threshold. threshold = 0 descends fully (exact).

* Variables never move: gid = insertion order; the delta is one device
  tensor x [xcap + 1, d] (row xcap is a zero trash row) that grows by
  doubling.

The bucket kernels take their plain PyTorch versions on CPU tensors and
their CUDA kernels on CUDA tensors (no fallback): the engine is one code
path on either device. That is the "torch" backend, the counterpart of the
JAX engine's "jax" backend.

`backend="numpy"` is the host engine, the counterpart of the JAX engine's
"numpy" backend (its production path on a CPU host): no pools, but exact
per-clique numpy payloads (`HostPayload`, U dense [sd, sd]) keyed by clique
id and freed with the clique; exact shapes (no power-of-two classes); the
block pool assembled by native row scatters (`_NpAccum`); and the whole
level sweep and the whole wildfire descent each one call of the native
sweeps (`csrc/host/solve_native.cpp`: `eliminate_sweep` over the plan,
`wildfire_sweep` over the flat per-slot tables of `_NativeTree`). The
sweeps are float64 code, so the host engine runs in float64 on device
"cpu" only (anything else raises). Its delta x is a numpy
array that the native sweep writes through raw pointers, so it reaches
torch only as a copy (`x_snapshot`): a tensor made by `torch.from_numpy`
would alias it and change under the caller. Buckets keep their exact clique counts (the JAX
engine pads them to classes that bound its jit signatures; eager PyTorch
has no signatures to bound), while clique shapes keep the power-of-two
classes that make cliques share pools. Device -> host reads (the
relinearization scan, one per wildfire round) are counted in `n_reads`.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.inference.kernels_np import _ptr
from gtsam_petercdev_torch.inference.symbolic import ccolamd_ordering, symbolic_eliminate
from gtsam_petercdev_torch.ops import build_host, cholesky, cholesky_v2


def _pad(x: int) -> int:
    """The next power of two (at least 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def _pad_class(x: int) -> int:
    """Clique shape classes (nf / ns blocks), powers of two: cliques of
    nearby shapes share one pool."""
    return _pad(x)


# ---------------------------------------------------------------------------
# device pools
# ---------------------------------------------------------------------------


class PoolArrays(NamedTuple):
    """One shape class's clique payloads, a row per clique."""

    L: torch.Tensor  # [cap, fd, fd]
    Linv: torch.Tensor  # [cap, nf, d, d]
    W: torch.Tensor  # [cap, fd, sd]
    y: torch.Tensor  # [cap, fd]
    U: torch.Tensor  # [cap, ns*ns, d, d] row-major d x d blocks of F22 - W^T W
    ug: torch.Tensor  # [cap, ns, d]


@dataclass
class PoolClass:
    nf: int
    ns: int
    cap: int
    arrays: PoolArrays
    free: List[int] = field(default_factory=list)
    top: int = 0

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        if self.top >= self.cap:
            return -1  # caller grows
        r = self.top
        self.top += 1
        return r


def _make_pool(nf, ns, d, cap, dtype, device) -> PoolArrays:
    fd, sd = nf * d, ns * d
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return PoolArrays(L=z(cap, fd, fd), Linv=z(cap, nf, d, d), W=z(cap, fd, sd), y=z(cap, fd),
                      U=z(cap, ns * ns, d, d), ug=z(cap, ns, d))


def _grow_pool(p: PoolClass, d) -> PoolClass:
    """The class with twice the rows (at least 16), old rows copied."""
    new_cap = max(16, 2 * p.cap)
    old = p.arrays
    na = _make_pool(p.nf, p.ns, d, new_cap, old.L.dtype, old.L.device)
    for dst, src in zip(na, old):
        dst[: p.cap] = src
    return PoolClass(p.nf, p.ns, new_cap, na, p.free, p.top)


# ---------------------------------------------------------------------------
# host records
# ---------------------------------------------------------------------------


@dataclass
class CliqueRec:
    cid: int
    cls: Tuple[int, int]  # (nf, ns) pool class
    row: int  # pool row
    frontal: List[int]  # gids, elimination order
    separator: List[int]  # gids, local-plan position order
    parent: int = -1  # cid
    children: Set[int] = field(default_factory=set)
    owned_fac: List[Tuple[int, int]] = field(default_factory=list)  # (group, row)
    owned_msg: List[int] = field(default_factory=list)  # persistent msg ids
    alive: bool = True
    nslot: int = -1  # native-tree slot (host engine, float64)


# ---------------------------------------------------------------------------
# host engine (backend="numpy")
# ---------------------------------------------------------------------------


class HostPayload(NamedTuple):
    """One clique's payload on the host engine, at its exact class shape."""

    L: np.ndarray  # [fd, fd]
    Linv: np.ndarray  # [nf, d, d]
    W: np.ndarray  # [fd, sd]
    y: np.ndarray  # [fd]
    U: np.ndarray  # [sd, sd] dense F22 - W^T W
    ug: np.ndarray  # [sd]


def _np_pad_last(x, target):
    pad = target - x.shape[-1]
    if pad <= 0:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


class _NpAccum:
    """Scatter-add of rows into dst [R, W] (float64) through the native
    scatter_add_rows: one C call a contribution, in order."""

    def __init__(self, dst: np.ndarray):
        self.dst = dst
        self.W = dst.shape[1]
        self.lib = build_host.load("solve_native")

    def add(self, rows, vals):
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64).ravel())
        vals = np.ascontiguousarray(vals, dtype=np.float64)
        self.lib.scatter_add_rows(_ptr(self.dst), _ptr(rows), _ptr(vals), rows.size, self.W, -1)


class _NativeTree:
    """Flat per-slot topology / payload tables for the native wildfire sweep
    (`csrc/host/solve_native.cpp` wildfire_sweep). Slots are recycled through
    a free list, so the tables track the peak of live cliques, not the
    append-only clique ids. The payload addresses stay valid because the
    engine's `payloads` own the arrays until the clique dies."""

    def __init__(self, lib, d: int):
        self.lib = lib
        self.d = d
        cap = 1024
        self.cap = cap
        self.parent = np.full(cap, -1, dtype=np.int32)
        self.alive = np.zeros(cap, dtype=np.uint8)
        self.nf = np.zeros(cap, dtype=np.int32)
        self.ns = np.zeros(cap, dtype=np.int32)
        self.nfr = np.zeros(cap, dtype=np.int32)  # real counts (<= class)
        self.nsr = np.zeros(cap, dtype=np.int32)
        self.pL = np.zeros(cap, dtype=np.uint64)
        self.pLinv = np.zeros(cap, dtype=np.uint64)
        self.pW = np.zeros(cap, dtype=np.uint64)
        self.pY = np.zeros(cap, dtype=np.uint64)
        self.fro_off = np.zeros(cap, dtype=np.int64)
        self.sep_off = np.zeros(cap, dtype=np.int64)
        self.free: List[int] = []
        self.top = 0
        self.buf_cap = 65536
        self.fro_buf = np.zeros(self.buf_cap, dtype=np.int32)
        self.sep_buf = np.zeros(self.buf_cap, dtype=np.int32)
        self.cursor = 0  # shared cursor of both gid buffers
        self.live_ints = 0  # gid entries owned by live slots
        self.max_fd = d
        self.seed_mask = np.zeros(cap, dtype=np.uint8)
        self.scratch = np.zeros(4 * self.max_fd, dtype=np.float64)

    def _grow_slots(self):
        new = self.cap * 2
        for name in ("parent", "alive", "nf", "ns", "nfr", "nsr", "pL", "pLinv", "pW", "pY",
                     "fro_off", "sep_off", "seed_mask"):
            old = getattr(self, name)
            arr = np.zeros(new, dtype=old.dtype)
            if name == "parent":
                arr[:] = -1
            arr[: self.cap] = old
            setattr(self, name, arr)
        self.cap = new

    def _buf_reserve(self, n: int):
        need = self.cursor + n
        if need <= self.buf_cap:
            return
        while self.buf_cap < need:
            self.buf_cap *= 2
        for name in ("fro_buf", "sep_buf"):
            old = getattr(self, name)
            arr = np.zeros(self.buf_cap, dtype=np.int32)
            arr[: self.cursor] = old[: self.cursor]
            setattr(self, name, arr)

    def alloc(self, rec: CliqueRec, pay: HostPayload) -> int:
        nf, ns = rec.cls
        nfr, nsr = len(rec.frontal), len(rec.separator)
        if self.free:
            s = self.free.pop()
        else:
            if self.top >= self.cap:
                self._grow_slots()
            s = self.top
            self.top += 1
        width = max(nfr, nsr)
        self._buf_reserve(width)
        off = self.cursor
        self.fro_buf[off : off + nfr] = rec.frontal
        self.sep_buf[off : off + nsr] = rec.separator
        self.cursor += width
        self.live_ints += width
        self.parent[s] = -1
        self.alive[s] = 1
        self.nf[s], self.ns[s], self.nfr[s], self.nsr[s] = nf, ns, nfr, nsr
        self.pL[s] = pay.L.ctypes.data
        self.pLinv[s] = pay.Linv.ctypes.data
        self.pW[s] = pay.W.ctypes.data
        self.pY[s] = pay.y.ctypes.data
        self.fro_off[s] = off
        self.sep_off[s] = off
        fd = nf * self.d
        if fd > self.max_fd:
            self.max_fd = fd
            self.scratch = np.zeros(4 * fd, dtype=np.float64)
        rec.nslot = s
        return s

    def set_parent(self, rec: CliqueRec, parent_rec: Optional[CliqueRec]):
        self.parent[rec.nslot] = -1 if parent_rec is None else parent_rec.nslot

    def on_free(self, rec: CliqueRec):
        s = rec.nslot
        if s < 0:
            return
        self.alive[s] = 0
        self.pL[s] = self.pLinv[s] = self.pW[s] = self.pY[s] = 0
        self.live_ints -= max(int(self.nfr[s]), int(self.nsr[s]))
        self.free.append(s)
        rec.nslot = -1

    def maybe_compact(self, cliques):
        """Rebuild the gid buffers when dead entries dominate."""
        if self.cursor < (1 << 20) or self.cursor < 8 * max(1, self.live_ints):
            return
        new_f = np.zeros(self.buf_cap, dtype=np.int32)
        new_s = np.zeros(self.buf_cap, dtype=np.int32)
        cur = 0
        for rec in cliques:
            if rec is None or not rec.alive or rec.nslot < 0:
                continue
            s = rec.nslot
            nfr, nsr = int(self.nfr[s]), int(self.nsr[s])
            new_f[cur : cur + nfr] = self.fro_buf[self.fro_off[s] : self.fro_off[s] + nfr]
            new_s[cur : cur + nsr] = self.sep_buf[self.sep_off[s] : self.sep_off[s] + nsr]
            self.fro_off[s] = cur
            self.sep_off[s] = cur
            cur += max(nfr, nsr)
        self.fro_buf, self.sep_buf, self.cursor = new_f, new_s, cur

    def sweep(self, x: np.ndarray, xcap: int, seeds: List[int], threshold: float) -> int:
        """The wildfire descent over the whole tree from the seed slots,
        writing x in place; returns the number of cliques solved."""
        dirty = np.zeros(xcap + 1, dtype=np.uint8)
        self.seed_mask[: self.top] = 0
        seeds_np = np.asarray(seeds, dtype=np.int32)
        return int(self.lib.wildfire_sweep(
            self.top, _ptr(self.parent), _ptr(self.alive), _ptr(self.nf), _ptr(self.ns),
            _ptr(self.nfr), _ptr(self.nsr), _ptr(self.pL), _ptr(self.pLinv), _ptr(self.pW),
            _ptr(self.pY), _ptr(self.fro_off), _ptr(self.sep_off), _ptr(self.fro_buf),
            _ptr(self.sep_buf), _ptr(x), self.d, xcap, _ptr(seeds_np), len(seeds_np),
            float(threshold), _ptr(dirty), _ptr(self.seed_mask), _ptr(self.scratch)))


@dataclass
class FactorGroup:
    """Device store of one linear-factor family's cached linearization."""

    gid: int
    K: int
    dims: Tuple[int, ...]
    sign: float
    cap: int
    A: Tuple[torch.Tensor, ...]  # per slot [cap, d, dim_k] (numpy on the host engine)
    b: torch.Tensor  # [cap, d]
    keys: np.ndarray  # [cap, K] gids (host)
    n: int = 0


@dataclass
class MsgRec:
    """Persistent marginal factor (what marginalize_leaves leaves behind)."""

    mid: int
    ns: int  # pool class
    row: int  # row in the engine's msg pool for class ns
    scope: List[int]  # gids
    alive: bool = True


@dataclass
class _LocalPlan:
    """Cached structural plan of one local re-elimination: every index map
    is a function of the local problem's STRUCTURE only, uploaded once and
    reused on every cache hit (the odometry steady state)."""

    # per factor-gather entry (sorted group order): (g, N, blk rounds over
    # the N*K*K Hessian blocks, gix rounds over the N*K gradient rows,
    # own_lcid [N] local clique owning each row)
    fac: List[Tuple]
    # per message class: (src, pkey, nsc, blk rounds over M*nsc*nsc blocks,
    # gix rounds over M*nsc rows, entry_order [M] indices into the update's
    # msg entries, own_lcid [M])
    msg: List[Tuple]
    # The host engine's plans hold the destinations themselves (numpy
    # arrays, padded slots at the trash rows) where these hold AddRounds.
    eye: "AddRounds"  # identity on padded frontal blocks and fake dims
    eye_vals: torch.Tensor  # [P, d*d]
    ext: List[Tuple["AddRounds", "AddRounds"]]  # per level: U blocks, ug rows
    # per level: (nf, ns, B, cliques: [(local cid, frontal_lv, separator_lv,
    # parent local cid)]) where *_lv index local_vars
    levels_meta: List[Tuple]
    n_cliques: int
    n_blocks: int
    n_grows: int
    lvl_offsets: Tuple  # per level (block offset, gradient-row offset)

    @property
    def nbytes(self) -> int:
        maps = [self.eye, self.eye_vals] + [r for e in self.fac for r in e[2:4]]
        maps += [r for e in self.msg for r in e[3:5]] + [r for e in self.ext for r in e]
        return sum(_nbytes(m) for m in maps)


def _nbytes(m) -> int:
    """Bytes of one plan map: a host array (host engine), a tensor or the
    upload behind an AddRounds."""
    if isinstance(m, np.ndarray):
        return m.nbytes
    t = m.flat if isinstance(m, AddRounds) else m
    return t.numel() * t.element_size()


class AddRounds(NamedTuple):
    """A host-planned sum dst[dest[s]] += src[s] split into rounds with
    unique destinations. Round k adds the k-th contribution (in source
    order) of every destination that has one: each round's `index_add_`
    has no duplicate index, so the card adds without racing atomics, in
    the order of the CPU's sequential `index_add_`. Sources bound for the
    trash row (map padding) are dropped."""

    rounds: Tuple[Tuple[Optional[torch.Tensor], torch.Tensor], ...]  # (src rows or None = all, dest)
    flat: torch.Tensor  # the one upload the rounds are views of


def _plan_rounds(dest: np.ndarray, trash: int, up) -> AddRounds:
    """Split the scatter-add of source rows into `dest` (host array) into
    rounds of unique destinations; `up` uploads one int64 array."""
    dest = np.asarray(dest, dtype=np.int64).reshape(-1)
    keep = np.flatnonzero(dest != trash)
    n = len(keep)
    by_dest = np.argsort(dest[keep], kind="stable")
    ds = dest[keep][by_dest]
    first = np.r_[True, ds[1:] != ds[:-1]] if n else np.zeros(0, dtype=bool)
    if first.all():
        if n == len(dest):  # one round over every source row
            flat = up(dest)
            return AddRounds(((None, flat),), flat)
        pos, sizes = keep, np.array([n] if n else [], dtype=np.int64)
    else:
        # rank of each source among those of its destination, in source order
        idx = np.arange(n)
        rank = np.empty(n, dtype=np.int64)
        rank[by_dest] = idx - np.maximum.accumulate(np.where(first, idx, 0))
        pos = keep[np.argsort(rank, kind="stable")]
        sizes = np.bincount(rank)
    flat = up(np.concatenate([pos, dest[pos]]))
    n, rounds, a = len(pos), [], 0
    for k in sizes.tolist():
        rounds.append((flat[a : a + k], flat[n + a : n + a + k]))
        a += k
    return AddRounds(tuple(rounds), flat)


def _add_rounds(dst: torch.Tensor, plan: AddRounds, src: torch.Tensor) -> None:
    """dst[dest[s]] += src[s] for every planned source row, round by round."""
    for pos, dest in plan.rounds:
        dst.index_add_(0, dest, src if pos is None else src.index_select(0, pos))


# ---------------------------------------------------------------------------
# device pool operations (plain functions on tensors, in place)
# ---------------------------------------------------------------------------


def _scatter_pool(pool: PoolArrays, rows: torch.Tensor, out: Dict) -> None:
    """Write one level's clique payloads into their class pool rows."""
    for name, dst in zip(PoolArrays._fields, pool):
        dst.index_copy_(0, rows, out[name])


def _gather_msgs(U: torch.Tensor, ug: torch.Tensor, rows: torch.Tensor):
    return U.index_select(0, rows), ug.index_select(0, rows)


def _gather_fac(A, b, rows: torch.Tensor):
    return tuple(Ak.index_select(0, rows) for Ak in A), b.index_select(0, rows)


def _set_rows(A, b, rows: torch.Tensor, Anew, bnew) -> None:
    """Overwrite a factor group's cached linearization rows."""
    for Ak, An in zip(A, Anew):
        Ak.index_copy_(0, rows, An.to(Ak.dtype))
    b.index_copy_(0, rows, bnew.to(b.dtype))


def _copy_msg(dstU, dstug, drows, srcU, srcug, srows) -> None:
    """Copy cached separator messages between pools (clique -> marginal)."""
    dstU.index_copy_(0, drows, srcU.index_select(0, srows))
    dstug.index_copy_(0, drows, srcug.index_select(0, srows))


def _new_pool(n_blocks: int, n_grows: int, d: int, dtype, device):
    """A zero block pool [n_blocks + 1, d*d] and gradient rows [n_grows + 1,
    d]; the last row of each is the trash row padded maps point at."""
    return (torch.zeros((n_blocks + 1, d * d), dtype=dtype, device=device),
            torch.zeros((n_grows + 1, d), dtype=dtype, device=device))


def _scatter_group(pool, gp, A, b, blk: AddRounds, gix: AddRounds, sign: float, d: int) -> None:
    """Add one factor group's Hessian blocks A_k^T A_l (every (k, l) pair,
    both triangles) and gradients A_k^T b into the pool."""
    Ap = torch.stack([tnf.pad(Ak, (0, d - Ak.shape[2])) for Ak in A], dim=1)  # [N, K, d, d]
    H = torch.einsum("nkri,nlrj->nklij", Ap, Ap)
    g = torch.einsum("nkri,nr->nki", Ap, b)
    if sign != 1.0:
        H, g = H * sign, g * sign
    _add_rounds(pool, blk, H.reshape(-1, d * d))
    _add_rounds(gp, gix, g.reshape(-1, d))


def _scatter_msg_class(pool, gp, U, ug, blk: AddRounds, gix: AddRounds) -> None:
    """Add one class of cached messages (U in block layout) into the pool."""
    d = ug.shape[-1]
    _add_rounds(pool, blk, U.reshape(-1, d * d))
    _add_rounds(gp, gix, ug.reshape(-1, d))


def _scatter_eye(pool, rows: AddRounds, vals) -> None:
    _add_rounds(pool, rows, vals)


def _max_abs(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax(dim=1)


def _zero_rows(x: torch.Tensor, idx: torch.Tensor) -> None:
    x.index_fill_(0, idx, 0.0)


# ---------------------------------------------------------------------------
# the level step and the wildfire round
# ---------------------------------------------------------------------------


def level_route(nf: int, ns: int, d: int, itemsize: int) -> str:
    """Which kernel factors a level bucket of the incremental engine:
    "blocks" (K4, on the pool slice in place) when a clique of the shape
    fits shared memory, else "global" (K1, on the dense relayout). Unlike
    the batch solver's `elimination.bucket_route`, any level may take K4:
    children have extend-added into the pool before a level runs."""
    return "blocks" if cholesky.fits_smem(nf, ns, d, itemsize) else "global"


def _level(pool, gp, boff: int, goff: int, B: int, nf: int, ns: int, d: int,
           ext: AddRounds, extg: AddRounds) -> Dict:
    """Eliminate one level bucket of B cliques whose frontal blocks are
    pool[boff : boff + B*mb*mb], then extend-add each clique's U / ug into
    its parent's blocks (ext / extg, planned over the B*ns*ns blocks and
    B*ns rows; pads are dropped).
    Returns L, Linv, W, y, U [B, ns*ns, d, d], ug [B, ns, d], bad."""
    mb = nf + ns
    blocks = pool[boff : boff + B * mb * mb]
    gblocks = gp[goff : goff + B * mb]
    if level_route(nf, ns, d, pool.element_size()) == "blocks":
        out = cholesky.partial_cholesky_blocks(blocks.view(-1, d, d), gblocks.view(B, mb, d),
                                               nf, ns, d)
        out["U"], out["ug"] = out.pop("U_blocks"), out.pop("ug_blocks")
    else:
        out = cholesky_v2.partial_cholesky(cholesky.dense_from_blocks(blocks, B, mb, d),
                                           gblocks.reshape(B, mb * d), nf, d)
        out["U"] = cholesky.blocks_from_dense(out["U"], ns, d)
        out["ug"] = out["ug"].reshape(B, ns, d)
    if ns > 0:
        _add_rounds(pool, ext, out["U"].reshape(-1, d * d))
        _add_rounds(gp, extg, out["ug"].reshape(-1, d))
    return out


def _np_scatter_group(acc_pool: _NpAccum, acc_gp: _NpAccum, A, b, blk, gix, sign: float,
                      d: int) -> None:
    """Host engine: add one factor group's Hessian blocks A_k^T A_l and
    gradients A_k^T b (blk [N, K, K], gix [N, K] destinations)."""
    K, N = len(A), b.shape[0]
    for k in range(K):
        gk = np.matmul(A[k].transpose(0, 2, 1), b[:, :, None])[:, :, 0]
        if sign != 1.0:
            gk = gk * sign
        acc_gp.add(gix[:, k], _np_pad_last(gk, d))
        for l in range(K):
            v = np.matmul(A[k].transpose(0, 2, 1), A[l])
            if sign != 1.0:
                v = v * sign
            v = np.pad(v, ((0, 0), (0, d - v.shape[1]), (0, d - v.shape[2])))
            acc_pool.add(blk[:, k, l], v.reshape(N, d * d))


def _wild(pc: PoolClass, rows, sep_idx, fro_idx, x, nf: int, ns: int, d: int) -> torch.Tensor:
    """One wildfire round for one shape class: K2 solves the cliques at pool
    `rows` given their separators' x (L^T x_f = y - W x_s), writes their
    frontal rows of x, and returns each clique's largest change [B]."""
    a = pc.arrays
    B = rows.shape[0]
    xs = x.index_select(0, sep_idx.reshape(-1)).reshape(B, ns * d)
    xf = cholesky_v2.backsolve_bucket(a.L.index_select(0, rows), a.Linv.index_select(0, rows),
                                      a.W.index_select(0, rows), a.y.index_select(0, rows),
                                      xs, nf, d)
    fro = fro_idx.reshape(-1)
    change = (xf - x.index_select(0, fro).reshape(B, nf * d)).abs().amax(dim=1)
    # padded frontal slots all point at the trash row and solve to exact zeros
    x.index_copy_(0, fro, xf.reshape(B * nf, d))
    return change


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class IncrementalEngine:
    """Linear-level incremental multifrontal solver (GaussianISAM analog).

    The nonlinear wrapper (nonlinear/isam2.py) owns linearization points
    and the relinearization policy; this engine owns the Bayes tree, the
    cached linear factors, and the delta x [n, d] (gid order, padded to d),
    all on `device` (default "cuda"; raises without a card unless "cpu").

    backend: "torch" (the pools and the bucket kernels on `device`) or
    "numpy" (the host engine: exact per-clique numpy payloads and the native
    sweeps; `device` must be "cpu", else ValueError)."""

    def __init__(self, d: int, dtype=torch.float64, device: DeviceLike = "cuda",
                 backend: str = "torch"):
        if backend not in ("torch", "numpy"):
            raise ValueError(f"backend must be 'torch' or 'numpy', not {backend!r}")
        if backend == "numpy" and torch.device(device).type != "cpu":
            raise ValueError(f"backend='numpy' is the host engine: it runs on device='cpu', "
                             f"not {device!r}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        if backend == "numpy" and self.dtype != torch.float64:
            raise ValueError(f"backend='numpy' is the host engine: its native sweeps run in "
                             f"float64, not {self.dtype}")
        self.backend = backend
        self._np = backend == "numpy"
        self._npdtype = torch.empty((), dtype=self.dtype).numpy().dtype
        self.d = d
        self.n = 0  # variables (gids 0..n-1)
        self.var_dims = np.zeros(0, dtype=np.int64)
        self.xcap = 1024
        self.x = self._zeros(self.xcap + 1, d)
        self.pools: Dict[Tuple[int, int], PoolClass] = {}
        self.msg_pools: Dict[int, PoolClass] = {}  # persistent marginals
        # host engine: per-clique payloads by cid and marginal messages by
        # mid, each freed with its owner; the native sweep's tables
        self.payloads: Dict[int, HostPayload] = {}
        self.msg_payloads: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._nat = _NativeTree(build_host.load("solve_native"), d) if self._np else None
        self.cliques: List = []  # CliqueRec or None (retired)
        self.var_clique: Dict[int, int] = {}  # gid -> cid (frontal owner)
        self.groups: List[FactorGroup] = []
        self._group_key: Dict[Tuple, int] = {}
        self.var_factors: Dict[int, List[Tuple[int, int]]] = {}  # gid -> [(g, row)]
        self.msgs: List = []  # MsgRec
        self.n_live = 0  # live clique count
        # factor units excised via remove_factor_units: filtered out of
        # owned_fac collection at the next re-elimination touching them
        self.removed_units: Set[Tuple[int, int]] = set()
        # structural local-plan cache, LRU by count and by index-map bytes
        self._plan_cache: "OrderedDict[Tuple, _LocalPlan]" = OrderedDict()
        self._plan_cache_cap = 128
        self._plan_cache_bytes = 0
        self._plan_cache_byte_cap = 64 * 2**20
        self.n_reads = 0  # device -> host reads

    def _upload(self, a, dtype=torch.int64) -> torch.Tensor:
        """A host array as a NEW tensor on the engine's device. Host records
        (factor keys, plan maps) are edited in place, so an upload never
        aliases them; the copy also makes the transfer safe to issue
        without waiting for the device."""
        t = torch.tensor(np.asarray(a), dtype=dtype)
        return t.to(self.device, non_blocking=True)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host (counted: each read waits for the card)."""
        self.n_reads += 1
        return t.cpu().numpy()

    def _zeros(self, *shape):
        """A zero store of the engine: numpy on the host engine, else a tensor."""
        if self._np:
            return np.zeros(shape, dtype=self._npdtype)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- variables / factors ------------------------------------------------

    def add_variables(self, dims: Sequence[int]) -> List[int]:
        gids = list(range(self.n, self.n + len(dims)))
        self.n += len(dims)
        self.var_dims = np.concatenate([self.var_dims, np.asarray(dims, dtype=np.int64)])
        if self.n > self.xcap:
            old = self.xcap
            while self.n > self.xcap:
                self.xcap *= 2
            nx = self._zeros(self.xcap + 1, self.d)
            nx[:old] = self.x[:old]
            self.x = nx
        return gids

    def group_for(self, key: Tuple, K: int, dims: Tuple[int, ...], sign: float) -> int:
        g = self._group_key.get(key)
        if g is not None:
            return g
        g = len(self.groups)
        cap = 64
        z = self._zeros
        self.groups.append(FactorGroup(
            gid=g, K=K, dims=tuple(dims), sign=float(sign), cap=cap,
            A=tuple(z(cap, self.d, dk) for dk in dims), b=z(cap, self.d),
            keys=np.zeros((cap, K), dtype=np.int64)))
        self._group_key[key] = g
        return g

    def _grow_group(self, fg: FactorGroup, need: int):
        cap = fg.cap
        while cap < need:
            cap *= 2
        z = self._zeros
        A = tuple(z(cap, self.d, dk) for dk in fg.dims)
        for An, Ak in zip(A, fg.A):
            An[: fg.cap] = Ak
        b = z(cap, self.d)
        b[: fg.cap] = fg.b
        keys = np.zeros((cap, fg.K), dtype=np.int64)
        keys[: fg.n] = fg.keys[: fg.n]
        fg.A, fg.b, fg.keys, fg.cap = A, b, keys, cap

    def add_factors(self, g: int, gids: np.ndarray, A, b) -> List[int]:
        """Append factor rows with their (already whitened) linearization."""
        fg = self.groups[g]
        nnew = gids.shape[0]
        if fg.n + nnew > fg.cap:
            self._grow_group(fg, fg.n + nnew)
        rows = list(range(fg.n, fg.n + nnew))
        fg.keys[fg.n : fg.n + nnew] = gids
        self.set_factor_rows(g, rows, A, b)
        fg.n += nnew
        for i, r in enumerate(rows):
            for k in range(fg.K):
                self.var_factors.setdefault(int(gids[i, k]), []).append((g, r))
        return rows

    def set_factor_rows(self, g: int, rows, A, b):
        """Overwrite the cached linearization of existing rows (relinearize)."""
        fg = self.groups[g]
        if self._np:
            idx = np.asarray(rows, dtype=np.int64)
            for Ak, An in zip(fg.A, A):
                Ak[idx] = An.detach().cpu().numpy()
            fg.b[idx] = b.detach().cpu().numpy()
            return
        _set_rows(fg.A, fg.b, self._upload(rows), A, b)

    def remove_factor_units(self, units) -> Set[int]:
        """Excise cached factor units from the tree's bookkeeping; returns
        the set of gids the caller must re-eliminate (update(marked=...))
        for the information to actually leave the tree."""
        marked: Set[int] = set()
        for (g, r) in units:
            u = (g, r)
            self.removed_units.add(u)
            fg = self.groups[g]
            for k in range(fg.K):
                gid = int(fg.keys[r, k])
                marked.add(gid)
                lst = self.var_factors.get(gid)
                if lst:
                    self.var_factors[gid] = [x for x in lst if x != u]
        return marked

    # -- affected-set computation (removeTop) --------------------------------

    def _cliques_containing(self, gid: int) -> List[int]:
        """All live cliques whose scope contains gid: the containment subtree
        rooted at gid's frontal clique (BayesTree subtree property)."""
        c0 = self.var_clique.get(gid)
        if c0 is None:
            return []
        out, stack = [], [c0]
        while stack:
            cid = stack.pop()
            out.append(cid)
            for ch in self.cliques[cid].children:
                if gid in self.cliques[ch].separator:
                    stack.append(ch)
        return out

    def _affected_set(self, marked: Set[int], relin: Set[int]) -> Set[int]:
        aff: Set[int] = set()
        seeds: Set[int] = set()
        for gid in marked:
            c = self.var_clique.get(gid)
            if c is not None:
                seeds.add(c)
        for gid in relin:
            seeds.update(self._cliques_containing(gid))
        for cid in seeds:
            while cid >= 0 and cid not in aff:
                aff.add(cid)
                cid = self.cliques[cid].parent
        return aff

    # -- the update -----------------------------------------------------------

    def update(
        self,
        new_keys: Sequence[int] = (),
        new_fac_units: Sequence[Tuple[int, int]] = (),
        marked: Set[int] = frozenset(),
        relin: Set[int] = frozenset(),
        first: Sequence[int] = (),
        wildfire_threshold: float = 0.0,
    ) -> Dict:
        """Re-eliminate the affected top of the tree (ISAM2::recalculate).

        new_keys: gids entering the tree this update (ordered LAST —
        ColamdConstrainedLast, inference/Ordering.cpp:128).
        new_fac_units: (group, row) factor rows added this update.
        marked: existing gids touched by new factors (removeTop marking).
        relin: gids whose linearization changed (fluid containment marking).
        first: gids to order FIRST (marginalization staging).
        """
        new_keys = [g for g in new_keys if g not in self.var_clique]
        aff = self._affected_set(set(marked) | set(relin), set(relin))

        orphan_cids: List[int] = []
        fac_units: Set[Tuple[int, int]] = set(new_fac_units)
        msg_ids: List[int] = []
        local_vars: List[int] = list(new_keys)
        for cid in aff:
            c = self.cliques[cid]
            local_vars.extend(c.frontal)
            fac_units.update(u for u in c.owned_fac if u not in self.removed_units)
            msg_ids.extend(mid for mid in c.owned_msg if self.msgs[mid].alive)
            for ch in c.children:
                if ch not in aff:
                    orphan_cids.append(ch)
        stats = self._reeliminate(
            sorted(set(local_vars)), sorted(fac_units), sorted(set(msg_ids)),
            sorted(orphan_cids), aff, new_last=list(new_keys), first=list(first),
            wildfire_threshold=wildfire_threshold)
        stats["n_affected_cliques"] = len(aff)
        stats["n_orphans"] = len(orphan_cids)
        return stats

    # -- local elimination ------------------------------------------------------

    def _reeliminate(
        self,
        local_vars: List[int],
        fac_units: List[Tuple[int, int]],
        msg_ids: List[int],
        orphan_cids: List[int],
        dead: Set[int],
        new_last: List[int],
        first: List[int],
        wildfire_threshold: float = 0.0,
    ) -> Dict:
        d = self.d
        m = len(local_vars)
        if m == 0:
            return {"n_reeliminated": 0, "bad_pivots": 0}
        lva = np.asarray(local_vars, dtype=np.int64)
        lid_arr = np.full(self.n, -1, dtype=np.int64)
        lid_arr[lva] = np.arange(m)

        # ---- symbolic structure + plan-cache signature ----
        per_group: Dict[int, List[int]] = {}
        for (g, r) in fac_units:
            per_group.setdefault(g, []).append(r)
        fac_entries = []  # (g, rows [N], lids [N, K])
        sig_parts: List = [m, self.var_dims[lva].tobytes()]
        for g in sorted(per_group):
            fg = self.groups[g]
            rows = np.asarray(sorted(set(per_group[g])), dtype=np.int64)
            lids = lid_arr[fg.keys[rows]]
            fac_entries.append((g, rows, lids))
            sig_parts.append((g, lids.shape[0], lids.tobytes()))
        # (src, pool key, ref, scope lids); ref is the pool row, on the host
        # engine the cid / mid that keys the payload
        msg_entries = []
        for cid in orphan_cids:
            c = self.cliques[cid]
            sc = lid_arr[np.asarray(c.separator, dtype=np.int64)]
            msg_entries.append(("clq", c.cls, cid if self._np else c.row, sc))
            sig_parts.append(("clq", c.cls, sc.tobytes()))
        for mid in msg_ids:
            mr = self.msgs[mid]
            sc = lid_arr[np.asarray(mr.scope, dtype=np.int64)]
            msg_entries.append(("msg", mr.ns, mid if self._np else mr.row, sc))
            sig_parts.append(("msg", mr.ns, sc.tobytes()))
        first_l = frozenset(int(lid_arr[g]) for g in first if lid_arr[g] >= 0)
        last_l = frozenset(int(lid_arr[g]) for g in new_last if lid_arr[g] >= 0) - first_l
        sig_parts.append((tuple(sorted(first_l)), tuple(sorted(last_l))))
        sig = tuple(sig_parts)

        plan = self._plan_cache.get(sig)
        if plan is None:
            plan = self._build_plan(lva, fac_entries, msg_entries, first_l, last_l)
            if m <= 512:  # closure cascades do not repeat structurally
                self._plan_cache[sig] = plan
                self._plan_cache_bytes += plan.nbytes
                while self._plan_cache and (
                    len(self._plan_cache) > self._plan_cache_cap
                    or self._plan_cache_bytes > self._plan_cache_byte_cap
                ):
                    _, old = self._plan_cache.popitem(last=False)
                    self._plan_cache_bytes -= old.nbytes
        else:
            self._plan_cache.move_to_end(sig)

        # ---- assemble the block pool ----
        own_fac: Dict[int, List[Tuple[int, int]]] = {}
        own_msg: Dict[int, List[int]] = {}
        orphan_owner: Dict[int, int] = {}  # orphan entry idx -> owner lcid
        if self._np:
            pool = np.zeros((plan.n_blocks + 1, d * d), dtype=self._npdtype)
            gp = np.zeros((plan.n_grows + 1, d), dtype=self._npdtype)
            acc_pool, acc_gp = _NpAccum(pool), _NpAccum(gp)
        else:
            pool, gp = _new_pool(plan.n_blocks, plan.n_grows, d, self.dtype, self.device)
        for (g, rows, _), (_, N, blk, gix, own_lcid) in zip(fac_entries, plan.fac):
            fg = self.groups[g]
            if self._np:
                _np_scatter_group(acc_pool, acc_gp, tuple(Ak[rows] for Ak in fg.A), fg.b[rows],
                                  blk, gix, fg.sign, d)
            else:
                A, b = _gather_fac(fg.A, fg.b, self._upload(rows))
                _scatter_group(pool, gp, A, b, blk, gix, fg.sign, d)
            for i in range(N):
                own_fac.setdefault(int(own_lcid[i]), []).append((g, int(rows[i])))
        for (src, pkey, nsc, blk, gix, order, own_lcid) in plan.msg:
            prow = np.empty(len(order), dtype=np.int64)
            for mi, ei in enumerate(order):
                prow[mi] = msg_entries[ei][2]
                if src == "msg":
                    own_msg.setdefault(int(own_lcid[mi]), []).append(
                        msg_ids[ei - len(orphan_cids)])
                else:
                    orphan_owner[ei] = int(own_lcid[mi])
            if self._np:
                msgs = ([self.payloads[r][4:] for r in prow.tolist()] if src == "clq"
                        else [self.msg_payloads[r] for r in prow.tolist()])  # (U, ug)
                M = len(msgs)
                U = np.stack([u for u, _ in msgs])
                Ub = U.reshape(M, nsc, d, nsc, d).transpose(0, 1, 3, 2, 4).reshape(-1, d * d)
                acc_pool.add(blk.reshape(-1), Ub)
                acc_gp.add(gix.reshape(-1), np.stack([ug for _, ug in msgs]).reshape(-1, d))
            else:
                pc = self.pools[pkey] if src == "clq" else self.msg_pools[pkey]
                U, ug = _gather_msgs(pc.arrays.U, pc.arrays.ug, self._upload(prow))
                _scatter_msg_class(pool, gp, U, ug, blk, gix)
        if self._np:
            acc_pool.add(plan.eye, plan.eye_vals)
        else:
            _scatter_eye(pool, plan.eye, plan.eye_vals)

        # ---- bottom-up level sweep ----
        outs = []
        if self._np:  # one native call for the whole sweep
            nat_pay, bad = self._native_eliminate(plan, pool, gp)
        else:
            bad = torch.zeros((), dtype=torch.int32, device=self.device)
            for li, (nf, ns, B, _) in enumerate(plan.levels_meta):
                boff, goff = plan.lvl_offsets[li]
                ext, extg = plan.ext[li]
                out = _level(pool, gp, boff, goff, B, nf, ns, d, ext, extg)
                bad = bad + out["bad"]
                outs.append(out)

        # ---- retire dead cliques, free pool rows / payloads ----
        for cid in dead:
            c = self.cliques[cid]
            c.alive = False
            if self._np:
                self._nat.on_free(c)
                self.payloads.pop(cid, None)
            else:
                self.pools[c.cls].free.append(c.row)
            self.cliques[cid] = None
        self.n_live -= len(dead)

        # ---- create new clique records + their payloads ----
        new_by_level: List[List[int]] = []
        local2global: Dict[int, int] = {}
        for li, (nf, ns, B, clqs) in enumerate(plan.levels_meta):
            cls = (nf, ns)
            pc = None if self._np else self.pools.get(cls)
            if pc is None and not self._np:
                pc = self.pools[cls] = PoolClass(
                    nf, ns, 0, _make_pool(nf, ns, d, 0, self.dtype, self.device))
            rows_np = np.empty(B, dtype=np.int64)
            lv_cids = []
            for i, (pcid, fro_lv, sep_lv, _) in enumerate(clqs):
                r = -1
                if not self._np:
                    r = pc.alloc()
                    while r < 0:
                        self.pools[cls] = pc = _grow_pool(pc, d)
                        r = pc.alloc()
                rows_np[i] = r
                gcid = len(self.cliques)
                rec = CliqueRec(
                    cid=gcid, cls=cls, row=r,
                    frontal=[local_vars[v] for v in fro_lv],
                    separator=[local_vars[v] for v in sep_lv],
                    owned_fac=own_fac.get(pcid, []), owned_msg=own_msg.get(pcid, []))
                self.cliques.append(rec)
                local2global[pcid] = gcid
                lv_cids.append(gcid)
                for gid in rec.frontal:
                    self.var_clique[gid] = gcid
                if self._np:  # the native sweep wrote the payload in place
                    pay = self.payloads[gcid] = nat_pay[li][i]
                    self._nat.alloc(rec, pay)
            if not self._np:
                _scatter_pool(pc.arrays, self._upload(rows_np), outs[li])
            new_by_level.append(lv_cids)
        self.n_live += plan.n_cliques

        # ---- wire the tree: parents/children of new cliques + orphans ----
        for (_, _, _, clqs) in plan.levels_meta:
            for (pcid, _, _, par) in clqs:
                if par >= 0:
                    gcid, pg = local2global[pcid], local2global[par]
                    self.cliques[gcid].parent = pg
                    self.cliques[pg].children.add(gcid)
                    if self._np:
                        self._nat.set_parent(self.cliques[gcid], self.cliques[pg])
        for ei, cid in enumerate(orphan_cids):
            pg = local2global[orphan_owner[ei]]
            self.cliques[cid].parent = pg
            self.cliques[pg].children.add(cid)
            if self._np:
                self._nat.set_parent(self.cliques[cid], self.cliques[pg])
        if self._np:
            self._nat.maybe_compact(self.cliques)

        # ---- wildfire back-substitution from the new cliques ----
        n_rounds = self._wildfire(new_by_level, wildfire_threshold)
        return {"n_reeliminated": plan.n_cliques, "bad_pivots": bad,
                "wildfire_rounds": n_rounds}

    def _native_eliminate(self, plan: _LocalPlan, pool: np.ndarray, gp: np.ndarray):
        """The whole bottom-up level sweep in ONE native call (eliminate_sweep:
        each clique's front gathered from the block pool, factored straight
        into its payload arrays, its Schur complement extend-added into the
        parent's blocks), the per-clique payloads allocated first. Returns
        the level-major payloads and the bad-pivot count."""
        d = self.d
        nl = len(plan.levels_meta)
        meta = np.zeros((5, nl), dtype=np.int64)  # nf, ns, B, block offset, row offset
        extp = np.empty(nl, np.uint64)
        extgp = np.empty(nl, np.uint64)
        total = sum(lv[2] for lv in plan.levels_meta)
        pp = np.empty((6, total), np.uint64)
        nat_pay: List[List[HostPayload]] = []
        ci, max_m = 0, 1
        for li, (nf, ns, B, _) in enumerate(plan.levels_meta):
            fd, sd = nf * d, ns * d
            max_m = max(max_m, fd + sd)
            meta[:, li] = (nf, ns, B) + tuple(plan.lvl_offsets[li])
            ext, extg = plan.ext[li]  # int32, contiguous, kept alive by the plan
            extp[li], extgp[li] = ext.ctypes.data, extg.ctypes.data
            # one allocation a clique, not a level arena: a view of an arena
            # would pin the whole level while one of its cliques lives
            lv_pays = []
            for _ in range(B):
                pay = HostPayload(L=np.empty((fd, fd)), Linv=np.empty((nf, d, d)),
                                  W=np.empty((fd, sd)), y=np.empty(fd), U=np.empty((sd, sd)),
                                  ug=np.empty(sd))
                lv_pays.append(pay)
                pp[:, ci] = [a.ctypes.data for a in pay]
                ci += 1
            nat_pay.append(lv_pays)
        work = np.empty(max_m * (max_m + 1))
        bad = self._nat.lib.eliminate_sweep(
            _ptr(pool), _ptr(gp), d, nl, *(_ptr(meta[k]) for k in range(5)), _ptr(extp),
            _ptr(extgp), *(_ptr(pp[k]) for k in range(6)), 1e-10, _ptr(work))
        return nat_pay, int(bad)

    def _build_plan(self, lva: np.ndarray, fac_entries, msg_entries, first_l: frozenset,
                    last_l: frozenset) -> _LocalPlan:
        """Host symbolic planning for one local-problem STRUCTURE (cache
        miss only): ordering, supernodes, level layout, all index maps,
        uploaded here once. The host engine keeps exact clique shapes and the
        maps' destinations as host arrays."""
        d = self.d
        m = len(lva)
        up = self._upload
        if self._np:
            rounds = lambda dest, trash: np.asarray(dest, dtype=np.int64)
        else:
            rounds = lambda dest, trash: _plan_rounds(dest, trash, up)
        factor_vars = [lids for (_, _, lids) in fac_entries] + [
            sc[None, :] for (_, _, _, sc) in msg_entries]

        # ---- ordering: [first | colamd middle | new_last] ----
        edge_list = []
        for fv in factor_vars:
            K = fv.shape[1]
            for a in range(K):
                for b_ in range(a + 1, K):
                    edge_list.append(np.stack([fv[:, a], fv[:, b_]], axis=1))
        edges = np.concatenate(edge_list, axis=0) if edge_list else np.zeros((0, 2), np.int64)
        base = ccolamd_ordering(m, edges)
        order = np.asarray(
            [v for v in base if v in first_l]
            + [v for v in base if v not in first_l and v not in last_l]
            + [v for v in base if v in last_l], dtype=np.int64)
        plan = symbolic_eliminate(
            m, factor_vars, d, ordering=order, max_buckets_per_level=1,
            no_merge_across=first_l if first_l else None,
            pad_fn=(lambda x: max(1, x)) if self._np else _pad_class)

        # ---- layout: one bucket per level, cliques contiguous ----
        iperm = plan.iperm
        cliques = plan.cliques
        for c in cliques:
            c._fpos = {v: i for i, v in enumerate(c.frontal)}
            c._spos = {v: i for i, v in enumerate(c.separator)}

        def cpos(c, pv):
            p = c._fpos.get(pv)
            return p if p is not None else c.bucket[0] + c._spos[pv]

        buckets = [lv[0] for lv in plan.levels]
        blk_base = np.zeros(len(cliques), dtype=np.int64)
        g_base = np.zeros(len(cliques), dtype=np.int64)
        mb_of = np.zeros(len(cliques), dtype=np.int64)
        boff = goff = 0
        lvl_offsets = []
        for bk in buckets:
            lvl_offsets.append((boff, goff))
            mb = bk.nf + bk.ns
            for i, cid in enumerate(bk.cliques):
                blk_base[cid] = boff + i * mb * mb
                g_base[cid] = goff + i * mb
                mb_of[cid] = mb
            boff += len(bk.cliques) * mb * mb
            goff += len(bk.cliques) * mb
        n_blocks, n_grows = boff, goff
        trash_blk, trash_g = n_blocks, n_grows

        # ---- factor scatter maps + ownership ----
        plan_fac = []
        for (g, rows, lids) in fac_entries:
            N, K = lids.shape
            pvs = iperm[lids]
            own = plan.var_clique[pvs.min(axis=1)]
            pos = np.empty((N, K), dtype=np.int64)
            for i in range(N):
                c = cliques[own[i]]
                for k in range(K):
                    pos[i, k] = cpos(c, pvs[i, k])
            blk = (blk_base[own][:, None, None] + pos[:, :, None] * mb_of[own][:, None, None]
                   + pos[:, None, :])
            gix = g_base[own][:, None] + pos
            plan_fac.append((g, N, rounds(blk, trash_blk), rounds(gix, trash_g), own.copy()))

        # ---- message scatter maps, one entry per (source, class) ----
        by_class: Dict[Tuple, List[int]] = {}
        for i, (src, pkey, _, _) in enumerate(msg_entries):
            nsc = pkey[1] if src == "clq" else pkey
            by_class.setdefault((src, pkey, nsc), []).append(i)
        plan_msg = []
        for (src, pkey, nsc), idxs in sorted(by_class.items(),
                                             key=lambda kv: (kv[0][0], str(kv[0][1]))):
            M = len(idxs)
            blk = np.full((M, nsc, nsc), trash_blk, dtype=np.int64)
            gix = np.full((M, nsc), trash_g, dtype=np.int64)
            own_lcid = np.zeros(M, dtype=np.int64)
            for mi, ei in enumerate(idxs):
                pv = iperm[msg_entries[ei][3]]
                ownc = cliques[plan.var_clique[pv.min()]]
                own_lcid[mi] = ownc.cid
                ps = np.asarray([cpos(ownc, p) for p in pv], dtype=np.int64)
                nr = len(pv)
                blk[mi, :nr, :nr] = blk_base[ownc.cid] + ps[:, None] * mb_of[ownc.cid] + ps[None, :]
                gix[mi, :nr] = g_base[ownc.cid] + ps
            plan_msg.append((src, pkey, nsc, rounds(blk, trash_blk), rounds(gix, trash_g),
                             list(idxs), own_lcid))

        # ---- identity on padded frontal blocks and on fake dims ----
        eye_rows, eye_vals = [], []
        eye_flat = np.eye(d).reshape(-1)
        for c in cliques:
            mb = mb_of[c.cid]
            for i in range(len(c.frontal), c.bucket[0]):
                eye_rows.append(blk_base[c.cid] + i * mb + i)
                eye_vals.append(eye_flat)
            for i, pv in enumerate(c.frontal):
                dv = int(self.var_dims[lva[plan.perm[pv]]])
                if dv < d:
                    v = np.zeros((d, d))
                    v[np.arange(dv, d), np.arange(dv, d)] = 1.0
                    eye_rows.append(blk_base[c.cid] + i * mb + i)
                    eye_vals.append(v.reshape(-1))
        eye_vals_np = np.stack(eye_vals) if eye_vals else np.zeros((0, d * d))

        # ---- extend-add maps: each clique's U / ug into its parent ----
        ext_maps = []
        for bk in buckets:
            ns = bk.ns
            ext = np.full((len(bk.cliques), ns, ns), trash_blk, dtype=np.int64)
            extg = np.full((len(bk.cliques), ns), trash_g, dtype=np.int64)
            for i, cid in enumerate(bk.cliques):
                c = cliques[cid]
                if c.parent >= 0 and c.separator:
                    p = cliques[c.parent]
                    ppos = np.asarray([cpos(p, v) for v in c.separator], dtype=np.int64)
                    nr = len(c.separator)
                    ext[i, :nr, :nr] = (blk_base[p.cid] + ppos[:, None] * mb_of[p.cid]
                                        + ppos[None, :])
                    extg[i, :nr] = g_base[p.cid] + ppos
            if self._np:  # the native sweep reads them as int32
                ext_maps.append((np.ascontiguousarray(ext, dtype=np.int32),
                                 np.ascontiguousarray(extg, dtype=np.int32)))
            else:
                ext_maps.append((rounds(ext, trash_blk), rounds(extg, trash_g)))

        # ---- per-level clique metadata (for CliqueRec construction) ----
        levels_meta = []
        for bk in buckets:
            clqs = [(c.cid, tuple(int(plan.perm[v]) for v in c.frontal),
                     tuple(int(plan.perm[v]) for v in c.separator), c.parent)
                    for c in (cliques[cid] for cid in bk.cliques)]
            levels_meta.append((bk.nf, bk.ns, len(bk.cliques), clqs))

        return _LocalPlan(
            fac=plan_fac, msg=plan_msg, eye=rounds(eye_rows, trash_blk),
            eye_vals=(eye_vals_np.astype(self._npdtype) if self._np
                      else up(eye_vals_np, dtype=self.dtype)),
            ext=ext_maps, levels_meta=levels_meta,
            n_cliques=len(cliques), n_blocks=n_blocks, n_grows=n_grows,
            lvl_offsets=tuple(lvl_offsets))

    # -- wildfire ---------------------------------------------------------------

    def _wild_round(self, cids: List[int]) -> Dict[int, float]:
        """Back-substitute one frontier of cliques (parents all solved): one
        K2 launch per shape class, one device -> host read of the changes
        (the card engine's; the host engine descends in _NativeTree.sweep)."""
        by_cls: Dict[Tuple[int, int], List[int]] = {}
        for cid in cids:
            by_cls.setdefault(self.cliques[cid].cls, []).append(cid)
        order, changes = [], []
        for (nf, ns), group in sorted(by_cls.items()):
            B = len(group)
            # one upload: pool rows [B], separator gids [B, ns], frontal gids
            # [B, nf]; padded slots point at x's zero trash row
            idx = np.full(B * (1 + ns + nf), self.xcap, dtype=np.int64)
            sep = idx[B : B + B * ns].reshape(B, ns)
            fro = idx[B + B * ns :].reshape(B, nf)
            for i, cid in enumerate(group):
                c = self.cliques[cid]
                idx[i] = c.row
                sep[i, : len(c.separator)] = c.separator
                fro[i, : len(c.frontal)] = c.frontal
            dev = self._upload(idx)
            changes.append(_wild(self.pools[(nf, ns)], dev[:B], dev[B : B + B * ns].view(B, ns),
                                 dev[B + B * ns :].view(B, nf), self.x, nf, ns, self.d))
            order.extend(group)
        return dict(zip(order, self._read(torch.cat(changes)).tolist()))

    def _wildfire(self, new_by_level: List[List[int]], threshold: float) -> int:
        """Frontier descent: new cliques top-down (forced), then into old
        subtrees while the separator delta keeps changing by > threshold
        (ISAM2Clique::optimizeWildfireNode semantics). The host engine runs
        the whole descent in one native call and returns the number of
        cliques it solved; the card engine returns the number of rounds."""
        if self._np:
            seeds = [self.cliques[cid].nslot for lv in new_by_level for cid in lv]
            return self._nat.sweep(self.x, self.xcap, seeds, threshold)
        dirty: Set[int] = set()
        new_set = {cid for lv in new_by_level for cid in lv}
        n_rounds = 0
        candidates: List[int] = []
        for lv_cids in reversed(new_by_level):  # top level last in plan order
            if not lv_cids:
                continue
            changes = self._wild_round(lv_cids)
            n_rounds += 1
            for cid, chg in changes.items():
                if chg > threshold:
                    dirty.update(self.cliques[cid].frontal)
                for ch in self.cliques[cid].children:
                    if ch not in new_set:
                        candidates.append(ch)
        frontier = [ch for ch in dict.fromkeys(candidates)
                    if any(v in dirty for v in self.cliques[ch].separator)]
        while frontier:
            changes = self._wild_round(frontier)
            n_rounds += 1
            for cid, chg in changes.items():
                if chg > threshold:
                    dirty.update(self.cliques[cid].frontal)
            nxt: List[int] = []
            for cid in frontier:
                for ch in self.cliques[cid].children:
                    if any(v in dirty for v in self.cliques[ch].separator):
                        nxt.append(ch)
            frontier = nxt
        return n_rounds

    # -- delta access -------------------------------------------------------------

    def x_snapshot(self) -> torch.Tensor:
        """The delta [xcap + 1, d] as a tensor that shares no memory with the
        engine. The host engine's x is a numpy array written in place (the
        native sweep through raw pointers, zero_delta_rows), so a tensor of
        `torch.from_numpy(x)` would change under its holder: every hand-off
        of the host delta to torch goes through this copy."""
        return torch.from_numpy(self.x.copy()) if self._np else self.x.clone()

    def delta_at(self, idx, dim: int) -> torch.Tensor:
        """Delta rows x[idx, :dim] (idx an int or an index tensor on the
        engine's device)."""
        x = self.x_snapshot() if self._np else self.x
        return x[idx, :dim]

    def delta_rows(self, gids, dim: int) -> torch.Tensor:
        """Delta rows [len(gids), dim] of a set of variables."""
        return self.delta_at(self._upload(gids), dim)

    def zero_delta_rows(self, gids) -> None:
        if self._np:
            self.x[np.asarray(gids, dtype=np.int64)] = 0.0
            return
        _zero_rows(self.x, self._upload(gids))

    def var_max_delta(self) -> np.ndarray:
        """max |delta| per gid (relinearization marking; one host read)."""
        if self._np:
            return np.max(np.abs(self.x[: self.n]), axis=1)
        return self._read(_max_abs(self.x[: self.n]))

    def clique_factors(self, cls: Tuple[int, int], cliques: List[CliqueRec], rows: torch.Tensor):
        """(L, Linv, W) [B, ...] of cliques of one shape class as tensors on
        the engine's device; `rows` are their pool rows, uploaded (unused by
        the host engine, which stacks copies of the payloads)."""
        if self._np:
            return tuple(torch.from_numpy(np.stack([getattr(self.payloads[c.cid], k)
                                                    for c in cliques]))
                         for k in ("L", "Linv", "W"))
        a = self.pools[cls].arrays
        return a.L.index_select(0, rows), a.Linv.index_select(0, rows), a.W.index_select(0, rows)

    # -- marginalization ------------------------------------------------------------

    def marginalize_leaves(self, gids: Sequence[int],
                           keep_messages: bool = True) -> List[Tuple[int, int]]:
        """Marginalize variables out of the tree (ISAM2::marginalizeLeaves,
        gtsam/nonlinear/ISAM2.cpp:487-724). Returns the retired (group, row)
        factor units whose information went into marginal factors.

        Two phases: (1) an update with the marginalized variables ordered
        FIRST and no supernode merged across the marginal / live boundary,
        so every one of them ends frontal in a leaf-most clique of marginal
        variables only; (2) those cliques are deleted, and the cached
        separator message (U, ug) of each top-most one becomes a persistent
        marginal factor on its live separator (the LinearContainerFactor
        analog), copied into the message pool of its class."""
        gids = [g for g in gids if self.var_clique.get(g) is not None]
        if not gids:
            return []
        gset = set(gids)
        self.update(marked=gset, relin=gset, first=gids)

        dead: List[CliqueRec] = []
        for g in gids:
            cid = self.var_clique.get(g)
            if cid is None:
                continue
            c = self.cliques[cid]
            if not all(v in gset for v in c.frontal):
                raise RuntimeError(f"marginalize_leaves: clique {cid} mixes live vars "
                                   f"{[v for v in c.frontal if v not in gset]}")
            if c not in dead:
                dead.append(c)
        dead_cids = {c.cid for c in dead}
        for c in dead:
            if any(ch not in dead_cids and self.cliques[ch] is not None and self.cliques[ch].alive
                   for ch in c.children):
                raise RuntimeError("marginalize_leaves: clique has live children")

        all_retired: List[Tuple[int, int]] = []
        for c in dead:
            live_scope = list(c.separator)
            nsc = c.cls[1]
            # only the top-most marginal cliques (all-live separator) leave a
            # message: lower ones flowed into their dead parents in phase 1
            if keep_messages and live_scope and not any(v in gset for v in live_scope):
                mid = len(self.msgs)
                if self._np:
                    r = -1
                    pay = self.payloads[c.cid]
                    self.msg_payloads[mid] = (pay.U.copy(), pay.ug.copy())
                else:
                    mp = self.msg_pools.get(nsc)
                    if mp is None:
                        mp = self.msg_pools[nsc] = PoolClass(
                            0, nsc, 0, _make_pool(0, nsc, self.d, 0, self.dtype, self.device))
                    r = mp.alloc()
                    while r < 0:
                        self.msg_pools[nsc] = mp = _grow_pool(mp, self.d)
                        r = mp.alloc()
                    src = self.pools[c.cls].arrays
                    _copy_msg(mp.arrays.U, mp.arrays.ug, self._upload([r]), src.U, src.ug,
                              self._upload([c.row]))
                self.msgs.append(MsgRec(mid=mid, ns=nsc, row=r, scope=live_scope))
                # owner: the live clique where the first separator var is frontal
                self.cliques[self.var_clique[live_scope[0]]].owned_msg.append(mid)
            # unlink and free; the factors and messages this clique owned are
            # retired: their information now lives in the marginal factor
            if c.parent >= 0 and self.cliques[c.parent] is not None:
                self.cliques[c.parent].children.discard(c.cid)
            if self._np:
                self._nat.on_free(c)
                self.payloads.pop(c.cid, None)
            else:
                self.pools[c.cls].free.append(c.row)
            for gid in c.frontal:
                self.var_clique.pop(gid, None)
            retired = set(c.owned_fac)
            all_retired.extend(c.owned_fac)
            for (g, r) in c.owned_fac:
                for k in range(self.groups[g].K):
                    gid = int(self.groups[g].keys[r, k])
                    lst = self.var_factors.get(gid)
                    if lst:
                        self.var_factors[gid] = [u for u in lst if u not in retired]
            for mid in c.owned_msg:
                mr = self.msgs[mid]
                if mr.alive:  # its information flowed into this clique: row reusable
                    mr.alive = False
                    if self._np:
                        self.msg_payloads.pop(mid, None)
                    else:
                        self.msg_pools[mr.ns].free.append(mr.row)
            self.cliques[c.cid] = None
            self.n_live -= 1
        # tombstone the variables (their x rows stay zero)
        self.zero_delta_rows(sorted(gset))
        return all_retired
