"""Batched supernodal multifrontal Cholesky — eager execution of an
EliminationPlan (block-pool design).

Port of gtsam_petercdev_tpu/inference/elimination.py. Every clique's
(padded) frontal matrix is a row-major grid of mb x mb blocks of d x d; all
cliques' blocks live in ONE flat pool [n_blocks, d*d] ordered
level/bucket/clique-contiguously, so each bucket's frontal matrices are a
slice of the pool. Factor Hessian blocks and child->parent Schur
contributions reach their slots through host-planned gather-sums
(`GatherSumPlan`): deterministic, scatter-free sums.

Per bucket, one of three partial-Cholesky kernels factors all its cliques,
chosen by the bucket's shape alone (`bucket_route`): a leaf bucket whose
clique fits shared memory goes to `ops.cholesky.partial_cholesky_blocks`
(K4), which reads the pool slice as it is and leaves U / ug in block layout
for the parent's extend-add; another bucket that fits goes to
`ops.cholesky.partial_cholesky` (K3); the rest go to
`ops.cholesky_v2.partial_cholesky` (K1). Each is a CUDA kernel on the card
and its plain version on the CPU. The top-down back-substitution runs
`ops.cholesky_v2.backsolve_bucket` (K2) per bucket.

Eager execution: the JAX package traces the index maps into one jitted
program; here every plan index tensor is uploaded ONCE per (NumericMaps,
device) — `NumericMaps.on_device` — so a solve copies no index from the
host.

Mixed-dimension variables (tangent dim < d) are padded to d with identity
rows on the fake dims.

`multifrontal_factor` / `multifrontal_apply` split the solve into
factor-once / apply-many (the subgraph preconditioner's use): the factor
runs the same bucket routing (K4 / K3 / K1) and keeps each bucket's L,
Linv and W; an apply runs the forward solve (plain PyTorch, as in the JAX
package) and K2 for the back-substitution.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.inference.symbolic import (
    Clique,
    EliminationPlan,
    symbolic_eliminate,
)
from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.ops import cholesky, cholesky_v2


@dataclass
class BatchStructure:
    """Host structure of one factor batch: per-slot global var ids."""

    dims: Tuple[int, ...]  # true tangent dim per slot (<= plan.d)
    gids: Tuple[np.ndarray, ...]  # per slot [N] global variable ids
    sign: float = 1.0


@dataclass
class GatherSumPlan:
    """Host-planned scatter-free segment sum: pool[t] = sum of the source
    rows whose destination is t, computed as (optional log-depth pairwise
    pre-reduce rounds) + <= C direct gathers. Deterministic: the order of
    every sum is fixed on the host."""

    rounds: List[Tuple[np.ndarray, np.ndarray]]  # (ia, ib) over current src
    direct: np.ndarray  # [n_dest, C] rows into final src (last row = zero)
    n_src: int  # rows of the original source array


def build_gather_sum_plan(
    dest: np.ndarray, n_dest: int, n_src: int, max_direct: int = 4
) -> GatherSumPlan:
    """Plan pool[t] = sum_{s: dest[s]==t} src[s] as gathers.

    dest: [S] destination ids (< n_dest) in source-row order; rows with
    dest[s] < 0 go nowhere (padding, or rows another sum takes). Rows with
    the same destination are pairwise-combined (log2 rounds) until every
    destination has <= max_direct contributing rows, then gathered
    directly. Destinations are taken in order of first appearance and each
    one's rows in source order, so the order of every sum is fixed. Vectorized
    (a partitioned level's pushes can have millions of rows).
    """
    dest = np.asarray(dest, dtype=np.int64)
    src = np.flatnonzero(dest >= 0)
    t = dest[src]
    uniq, first, inv = np.unique(t, return_index=True, return_inverse=True)
    rank_of = np.empty(len(uniq), dtype=np.int64)
    rank_of[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    grp = rank_of[inv]
    order = np.argsort(grp, kind="stable")
    grp, rows = grp[order], src[order]
    group_dest = uniq[np.argsort(rank_of)]
    counts = np.bincount(grp, minlength=len(uniq))
    rounds: List[Tuple[np.ndarray, np.ndarray]] = []
    cur_len = len(dest)  # the zero row past the current source
    while len(counts) and counts.max() > max_direct:
        starts = np.cumsum(counts) - counts
        pos = np.flatnonzero((np.arange(len(grp)) - starts[grp]) % 2 == 0)
        nxt = pos + 1
        has_b = nxt < len(grp)
        has_b[has_b] = grp[nxt[has_b]] == grp[pos[has_b]]
        ib = np.full(len(pos), cur_len, dtype=np.int64)
        ib[has_b] = rows[nxt[has_b]]
        rounds.append((rows[pos].astype(np.int32), ib.astype(np.int32)))
        grp = grp[pos]
        rows = np.arange(len(pos), dtype=np.int64)
        cur_len = len(pos)
        counts = (counts + 1) // 2
    C = max(1, int(counts.max()) if len(counts) else 1)
    direct = np.full((n_dest, C), cur_len, dtype=np.int32)  # trash = zero row
    starts = np.cumsum(counts) - counts
    direct[group_dest[grp], np.arange(len(grp)) - starts[grp]] = rows
    return GatherSumPlan(rounds=rounds, direct=direct, n_src=n_src)


@dataclass
class DeviceGatherSum:
    """A GatherSumPlan's index arrays on one device."""

    rounds: List[Tuple[torch.Tensor, torch.Tensor]]
    direct: List[torch.Tensor]  # one [n_dest] column per direct gather

    @classmethod
    def of(cls, plan: GatherSumPlan, device) -> "DeviceGatherSum":
        up = lambda a: torch.as_tensor(a, dtype=torch.int64).to(device)
        return cls(
            rounds=[(up(ia), up(ib)) for ia, ib in plan.rounds],
            direct=[up(np.ascontiguousarray(plan.direct[:, c])) for c in range(plan.direct.shape[1])],
        )


def apply_gather_sum(plan: DeviceGatherSum, src: torch.Tensor) -> torch.Tensor:
    """Execute a gather-sum plan. src [n_src, w] -> [n_dest, w]."""
    z = src.new_zeros((1, src.shape[1]))
    for ia, ib in plan.rounds:
        s = torch.cat([src, z], dim=0)
        src = s[ia] + s[ib]
    s = torch.cat([src, z], dim=0)
    out = s[plan.direct[0]]
    for col in plan.direct[1:]:
        out = out + s[col]
    return out


@dataclass
class BucketMaps:
    level: int
    B: int
    nf: int  # padded frontal blocks
    ns: int  # padded separator blocks
    blk_start: int  # first pool row of this bucket's blocks
    g_start: int  # first g-pool row
    sep_idx: np.ndarray  # [B, ns] x-pool rows of separator vars (trash pads)
    fro_idx: np.ndarray  # [B, nf] x-pool rows of frontal vars (trash pads)
    # extend-add groups, one per child bucket in ascending order:
    # (child_bucket_flat_idx, sel [n_sel] child rows, ppos [n_sel, ns_child]
    # parent block slot of each child separator block, -1 = padding)
    ext_mm: Optional[List[Tuple[int, np.ndarray, np.ndarray]]] = None
    ext_seg: Optional[GatherSumPlan] = None  # parent segment sum over n_all

    @property
    def mb(self):
        return self.nf + self.ns


@dataclass
class DeviceBucket:
    """One bucket's index tensors on a device (see NumericMaps.on_device)."""

    # per extend-add group: (child bucket, sel, scalar map [n_sel, m] from a
    # parent row to the child's padded U row (sd_child = the zero pad row),
    # arange(n_sel) [n_sel, 1, 1] for the batched gather, and — for a child
    # bucket without children of its own, whose U may be in block layout —
    # the same map split into (block index, index in the block), else None)
    ext: List[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, Optional[tuple]]]
    ext_seg: Optional[DeviceGatherSum]
    sep_idx: torch.Tensor  # [B * ns]
    fro_idx: torch.Tensor  # [B * nf]


@dataclass
class DeviceMaps:
    asm_plan: DeviceGatherSum
    asm_g_plan: DeviceGatherSum
    hdiag_plan: DeviceGatherSum
    eye_vals: torch.Tensor  # float64, cast per solve dtype
    iperm: torch.Tensor
    var_g_rows: torch.Tensor  # [n] g-pool row of each variable's frontal slot, gid order
    buckets: List[DeviceBucket]


_MAPS_UID = [0]


@dataclass
class NumericMaps:
    plan: EliminationPlan
    n_blocks: int
    n_grows: int
    batch_signs: List[float]
    asm_plan: GatherSumPlan  # factor blocks + eye + damp -> block pool
    asm_g_plan: GatherSumPlan  # factor g rows -> g pool
    hdiag_plan: GatherSumPlan  # per-slot |col|^2 rows -> [n] Hessian diag
    eye_vals: np.ndarray  # [P, d*d] identity padding contribution values
    buckets: List[BucketMaps]  # flattened level-major, bottom-up
    uid: int = -1
    _device_cache: Dict[str, DeviceMaps] = field(default_factory=dict, repr=False)

    def on_device(self, device: torch.device) -> DeviceMaps:
        """This plan's index tensors on `device`, uploaded once and cached."""
        key = str(device)
        dm = self._device_cache.get(key)
        if dm is None:
            dm = _upload(self, device)
            self._device_cache[key] = dm
        return dm


def _upload(maps: NumericMaps, device) -> DeviceMaps:
    d = maps.plan.d
    up = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(device)
    buckets = []
    for bm in maps.buckets:
        m = bm.mb * d
        ext = []
        for ch_bf, sel, pp in bm.ext_mm or ():
            nsel, ns_c = pp.shape
            sd_c = ns_c * d
            # scalar row map: parent row blk*d+e <- child row a*d+e where
            # pp[c, a] == blk, else the zero pad row sd_c (the one-hot
            # selector S6 of the JAX package, as an index)
            rowmap = np.full((nsel, m), sd_c, dtype=np.int64)
            for a in range(ns_c):
                for c in np.nonzero(pp[:, a] >= 0)[0]:
                    p0 = int(pp[c, a]) * d
                    rowmap[c, p0 : p0 + d] = np.arange(a * d, a * d + d)
            # a leaf child may hand over U as [ns_c, ns_c, d, d] blocks: row
            # a*d+e is block a, in-block e; the pad row is the zero block ns_c
            blocked = None if maps.buckets[ch_bf].ext_mm else (up(rowmap // d), up(rowmap % d))
            ext.append((ch_bf, up(sel), up(rowmap), up(np.arange(nsel)[:, None, None]), blocked))
        buckets.append(
            DeviceBucket(
                ext=ext,
                ext_seg=DeviceGatherSum.of(bm.ext_seg, device) if bm.ext_seg else None,
                sep_idx=up(bm.sep_idx.reshape(-1)),
                fro_idx=up(bm.fro_idx.reshape(-1)),
            )
        )
    var_g_rows = np.zeros(maps.plan.n, dtype=np.int64)
    for bm in maps.buckets:
        rows = bm.g_start + np.arange(bm.B)[:, None] * bm.mb + np.arange(bm.nf)[None, :]
        real = bm.fro_idx < maps.plan.n
        var_g_rows[maps.plan.perm[bm.fro_idx[real]]] = rows[real]
    return DeviceMaps(
        asm_plan=DeviceGatherSum.of(maps.asm_plan, device),
        asm_g_plan=DeviceGatherSum.of(maps.asm_g_plan, device),
        hdiag_plan=DeviceGatherSum.of(maps.hdiag_plan, device),
        eye_vals=torch.as_tensor(maps.eye_vals, dtype=torch.float64).to(device),
        iperm=up(maps.plan.iperm),
        var_g_rows=up(var_g_rows),
        buckets=buckets,
    )


def build_plan_for_graph(
    lg_rows,
    n_vars: int,
    d: int,
    ordering: Optional[np.ndarray] = None,
    **kwargs,
) -> EliminationPlan:
    """lg_rows: list of (rows_tuple, _ignored) or BatchStructure entries."""
    factor_vars = []
    for ent in lg_rows:
        rows = ent.gids if isinstance(ent, BatchStructure) else ent[0]
        factor_vars.append(np.stack(rows, axis=1).astype(np.int64))
    return symbolic_eliminate(n_vars, factor_vars, d, ordering=ordering, **kwargs)


def type_offsets(type_counts: Dict[str, int]) -> Dict[str, int]:
    """Global variable enumeration: types in sorted-name order."""
    off, out = 0, {}
    for t in sorted(type_counts):
        out[t] = off
        off += type_counts[t]
    return out


def graph_structure(graph, values) -> List[BatchStructure]:
    """Host-only structure extraction (no device work)."""
    graph._materialize()
    counts = {t: values._count(t) for t in values.types()}
    offs = type_offsets(counts)
    out = []
    for batch in graph.batches:
        gids, dims = [], []
        for k, t in enumerate(batch.ftype.var_types):
            rows = values.rows(batch.keys[:, k], t)
            gids.append(np.asarray(rows, dtype=np.int64) + offs[t])
            dims.append(manifold.get(t).dim)
        out.append(BatchStructure(tuple(dims), tuple(gids), batch.sign))
    return out


def _as_structures(structure) -> List[BatchStructure]:
    if hasattr(structure, "batches"):  # LinearizedGraph
        offs = type_offsets(structure.type_counts)
        ents = []
        for lb in structure.batches:
            dims = tuple(manifold.get(t).dim for t in lb.var_types)
            gids = tuple(
                np.asarray(r, dtype=np.int64) + offs[t]
                for r, t in zip(lb.rows, lb.var_types)
            )
            ents.append(BatchStructure(dims, gids, getattr(lb, "sign", 1.0)))
        return ents
    out = []
    for ent in structure:
        if isinstance(ent, BatchStructure):
            out.append(ent)
        else:  # (var_types, rows[, sign]) tuple, single type space
            var_types, rows = ent[0], ent[1]
            sign = ent[2] if len(ent) > 2 else 1.0
            dims = tuple(manifold.get(t).dim for t in var_types)
            gids = tuple(np.asarray(r, dtype=np.int64) for r in rows)
            out.append(BatchStructure(dims, gids, sign))
    return out


def build_numeric_maps(
    plan: EliminationPlan, structure, var_dims: Optional[np.ndarray] = None
) -> NumericMaps:
    """Build block-granular index maps binding factor structure to the plan.

    var_dims: [n] true tangent dim per global var (defaults to plan.d —
    uniform). Vars with dim < d get identity rows on their fake dims.
    """
    structure = _as_structures(structure)
    d = plan.d
    iperm = plan.iperm
    cliques = plan.cliques

    # clique block-pool bases (level/bucket/clique-contiguous)
    blk_base = np.zeros(len(cliques), dtype=np.int64)
    g_base = np.zeros(len(cliques), dtype=np.int64)
    mb_of = np.zeros(len(cliques), dtype=np.int64)
    boff, goff = 0, 0
    bucket_meta = []
    for lv_i, lv in enumerate(plan.levels):
        for bk in lv:
            mb = bk.nf + bk.ns
            bucket_meta.append((lv_i, bk, boff, goff))
            for cid in bk.cliques:
                blk_base[cid] = boff
                g_base[cid] = goff
                mb_of[cid] = mb
                boff += mb * mb
                goff += mb
    n_blocks, n_grows = boff, goff

    fpos = [{v: i for i, v in enumerate(c.frontal)} for c in cliques]
    spos = [{v: i for i, v in enumerate(c.separator)} for c in cliques]

    def cpos(c: Clique, pv: int) -> int:
        p = fpos[c.cid].get(pv)
        if p is not None:
            return p
        return c.bucket[0] + spos[c.cid][pv]

    # --- factor contribution destinations (block pool / g pool slots) ---
    # enumeration order MUST match assemble(): per batch, k-major then l for
    # blocks; per batch then k for g rows; then eye rows; then damp rows.
    blk_dest_parts: List[np.ndarray] = []
    g_dest_parts: List[np.ndarray] = []
    hdiag_dest_parts: List[np.ndarray] = []
    signs = []
    for ent in structure:
        K = len(ent.gids)
        gids = [np.asarray(g, dtype=np.int64) for g in ent.gids]
        N = gids[0].shape[0]
        pvs = [iperm[g] for g in gids]
        minpv = pvs[0]
        for k in range(1, K):
            minpv = np.minimum(minpv, pvs[k])
        own = plan.var_clique[minpv]  # [N]
        base = blk_base[own]
        gb = g_base[own]
        mb = mb_of[own]
        pos = np.empty((N, K), dtype=np.int64)
        for k in range(K):
            pos[:, k] = np.array(
                [cpos(cliques[own[i]], pvs[k][i]) for i in range(N)], dtype=np.int64
            )
        for k in range(K):
            g_dest_parts.append(gb + pos[:, k])
            hdiag_dest_parts.append(gids[k])
            for l in range(K):
                blk_dest_parts.append(base + pos[:, k] * mb + pos[:, l])
        signs.append(float(ent.sign))

    # --- identity padding: padded frontal slots + fake dims of small vars ---
    dd = d * d
    eye_rows, eye_vals = [], []
    eye_flat = np.eye(d).reshape(-1)
    if var_dims is None:
        var_dims = np.full(plan.n, d, dtype=np.int64)
    for c in cliques:
        nf_pad, _ = c.bucket
        mb = mb_of[c.cid]
        for i in range(len(c.frontal), nf_pad):
            eye_rows.append(blk_base[c.cid] + i * mb + i)
            eye_vals.append(eye_flat)
        for i, pv in enumerate(c.frontal):
            dv = int(var_dims[plan.perm[pv]])
            if dv < d:
                v = np.zeros((d, d))
                v[np.arange(dv, d), np.arange(dv, d)] = 1.0
                eye_rows.append(blk_base[c.cid] + i * mb + i)
                eye_vals.append(v.reshape(-1))
    eye_rows = np.asarray(eye_rows, dtype=np.int64)
    eye_vals = np.stack(eye_vals).astype(np.float64) if eye_vals else np.zeros((0, dd))

    # --- per-var diag block rows (gid order, for damping) ---
    var_diag = np.zeros(plan.n, dtype=np.int64)
    for c in cliques:
        mb = mb_of[c.cid]
        for i, pv in enumerate(c.frontal):
            var_diag[plan.perm[pv]] = blk_base[c.cid] + i * mb + i

    # --- assembly gather plans (block pool, g pool, Hessian diagonal) ---
    n_fac_blk = sum(p.shape[0] for p in blk_dest_parts)
    n_fac_g = sum(p.shape[0] for p in g_dest_parts)
    blk_dest = np.concatenate(blk_dest_parts + [eye_rows, var_diag])
    asm_plan = build_gather_sum_plan(
        blk_dest, n_blocks + 1, n_fac_blk + len(eye_rows) + plan.n
    )
    g_dest = np.concatenate(g_dest_parts) if g_dest_parts else np.zeros(0, np.int64)
    asm_g_plan = build_gather_sum_plan(g_dest, n_grows + 1, n_fac_g)
    hdiag_dest = (
        np.concatenate(hdiag_dest_parts) if hdiag_dest_parts else np.zeros(0, np.int64)
    )
    hdiag_plan = build_gather_sum_plan(hdiag_dest, plan.n, n_fac_g)

    # --- bucket maps: child -> (flat bucket, local row) for extend-add ---
    child_loc: Dict[int, Tuple[int, int]] = {}
    for bf_i, (_, bk, _, _) in enumerate(bucket_meta):
        for i, cid in enumerate(bk.cliques):
            child_loc[cid] = (bf_i, i)

    # children lists (only cliques that push a real separator contribution)
    kids: List[List[int]] = [[] for _ in cliques]
    for c in cliques:
        if c.parent >= 0 and c.separator:
            kids[c.parent].append(c.cid)

    buckets = []
    x_trash = plan.n
    for (lv_i, bk, boff_b, goff_b) in bucket_meta:
        B = len(bk.cliques)
        nf, ns = bk.nf, bk.ns
        sep = np.full((B, ns), x_trash, dtype=np.int64)
        fro = np.full((B, nf), x_trash, dtype=np.int64)
        mm_groups: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        for i, cid in enumerate(bk.cliques):
            c = cliques[cid]
            for si, v in enumerate(c.separator):
                sep[i, si] = v
            for fi, v in enumerate(c.frontal):
                fro[i, fi] = v
            for ch_cid in kids[cid]:
                ch = cliques[ch_cid]
                ch_bf, ch_loc = child_loc[ch_cid]
                ch_ns = cliques[ch_cid].bucket[1]
                pp = np.full(ch_ns, -1, dtype=np.int32)
                pp[: len(ch.separator)] = [cpos(c, v) for v in ch.separator]
                mm_groups.setdefault(ch_bf, []).append((i, ch_loc, pp))
        # extend-add groups (parent-segment order = concat of groups in
        # ascending child-bucket order)
        ext_mm, parent_ids = [], []
        for ch_bf in sorted(mm_groups):
            ents = mm_groups[ch_bf]
            sel = np.asarray([e[1] for e in ents], dtype=np.int32)
            pp = np.stack([e[2] for e in ents], axis=0)
            ext_mm.append((ch_bf, sel, pp))
            parent_ids.extend(e[0] for e in ents)
        ext_seg = (
            build_gather_sum_plan(
                np.asarray(parent_ids, dtype=np.int64), B, len(parent_ids), max_direct=2
            )
            if parent_ids
            else None
        )
        buckets.append(
            BucketMaps(
                level=lv_i,
                B=B,
                nf=nf,
                ns=ns,
                blk_start=boff_b,
                g_start=goff_b,
                sep_idx=sep,
                fro_idx=fro,
                ext_mm=ext_mm or None,
                ext_seg=ext_seg,
            )
        )

    _MAPS_UID[0] += 1
    return NumericMaps(
        plan=plan,
        n_blocks=n_blocks,
        n_grows=n_grows,
        batch_signs=signs,
        asm_plan=asm_plan,
        asm_g_plan=asm_g_plan,
        hdiag_plan=hdiag_plan,
        eye_vals=eye_vals,
        buckets=buckets,
        uid=_MAPS_UID[0],
    )


def _pad_last(x, target):
    pad = target - x.shape[-1]
    return x if pad <= 0 else tnf.pad(x, (0, pad))


def assemble(maps: NumericMaps, dm: DeviceMaps, Ab, lam, diagonal_damping: bool):
    """Gather factor Hessian blocks + identity padding + damping into the
    block pool, scatter-free (see GatherSumPlan).

    Returns (pool [n_blocks+1, d*d], gp [n_grows+1, d])."""
    d = maps.plan.d
    dd = d * d
    b0 = Ab[0][1]
    dtype, dev = b0.dtype, b0.device
    n = maps.plan.n
    eye = torch.eye(d, dtype=dtype, device=dev)

    # contribution rows in the exact order the host plans enumerate
    blk_rows, g_rows, hdiag_rows = [], [], []
    for bi, (A, b) in enumerate(Ab):
        sign = maps.batch_signs[bi]
        N = b.shape[0]
        for k in range(len(A)):
            gk = torch.einsum("nri,nr->ni", A[k], b)
            hk = torch.einsum("nri,nri->ni", A[k], A[k])
            if sign != 1.0:
                gk = gk * sign
                hk = hk * sign
            g_rows.append(_pad_last(gk, d))
            hdiag_rows.append(_pad_last(hk, d))
            for l in range(len(A)):
                blk = A[k].transpose(1, 2) @ A[l]
                if sign != 1.0:
                    blk = blk * sign
                blk = tnf.pad(blk, (0, d - blk.shape[2], 0, d - blk.shape[1]))
                blk_rows.append(blk.reshape(N, dd))

    # damping contribution per variable (targets its diag slot)
    if diagonal_damping:
        hdiag = apply_gather_sum(dm.hdiag_plan, torch.cat(hdiag_rows, dim=0))
        damp = (lam * hdiag[:, :, None] * eye[None]).reshape(n, dd)
    else:
        damp = (lam * eye).reshape(1, dd).expand(n, dd)

    contrib = torch.cat(blk_rows + [dm.eye_vals.to(dtype), damp], dim=0)
    pool = apply_gather_sum(dm.asm_plan, contrib)
    gp = apply_gather_sum(dm.asm_g_plan, torch.cat(g_rows, dim=0))
    return pool, gp


def bucket_route(bm: BucketMaps, d: int, itemsize: int) -> str:
    """Which partial-Cholesky kernel factors a bucket, by its shape alone:
    "blocks" (K4: a leaf bucket — no extend-add, its frontal matrices are the
    pool slice as assembled — whose clique fits shared memory), "smem" (K3:
    another bucket whose clique fits) or "global" (K1: the rest)."""
    if not cholesky.fits_smem(bm.nf, bm.ns, d, itemsize):
        return "global"
    return "smem" if bm.ext_mm else "blocks"


def _extend_add(db: DeviceBucket, outs, m: int, d: int):
    """Children's Schur contributions in the parent's frame: (dF [B, m*m],
    dg [B, m]). A child's dense U is gathered by the scalar row map; block-
    layout U (from K4) by its block and in-block indices, without ever
    becoming [B, sd, sd]."""
    incs = []
    for ch_bf, sel, rowmap, c, blocked in db.ext:
        out = outs[ch_bf]
        if "U_blocks" in out:
            bi, ii = blocked
            ns_c = out["ug_blocks"].shape[1]
            Ub = out["U_blocks"][sel].reshape(-1, ns_c, ns_c, d, d)
            Ub = tnf.pad(Ub, (0, 0, 0, 0, 0, 1, 0, 1))  # one zero block per block axis
            inc = Ub[c, bi[:, :, None], bi[:, None, :], ii[:, :, None], ii[:, None, :]]
        else:
            Us = tnf.pad(out["U"][sel], (0, 1, 0, 1))
            inc = Us[c, rowmap[:, :, None], rowmap[:, None, :]]
        incs.append(inc.reshape(-1, m * m))
    ugs = {ch_bf: outs[ch_bf]["ug_blocks"].flatten(1) if "ug_blocks" in outs[ch_bf]
           else outs[ch_bf]["ug"] for ch_bf, *_ in db.ext}
    return apply_gather_sum(db.ext_seg, torch.cat(incs, dim=0)), _extend_add_g(db, ugs)


def _extend_add_g(db: DeviceBucket, ugs) -> torch.Tensor:
    """Children's ug [B_c, sd_c] (by child bucket) in the parent's frame,
    summed per parent: [B, m]."""
    incgs = [torch.gather(tnf.pad(ugs[ch_bf][sel], (0, 1)), 1, rowmap)
             for ch_bf, sel, rowmap, _, _ in db.ext]
    return apply_gather_sum(db.ext_seg, torch.cat(incgs, dim=0))


def _eliminate(maps: NumericMaps, dm: DeviceMaps, pool, gp):
    """Bottom-up: per bucket one batched partial Cholesky on the kernel
    `bucket_route` picks; each bucket pulls its children's Schur
    contributions (U, ug) into its frame by index and segment-sums them per
    parent (the extend-add). Returns (the per-bucket outputs, the bad-pivot
    count as an int32 device scalar)."""
    d = maps.plan.d
    outs = []
    bad_total = torch.zeros((), dtype=torch.int32, device=pool.device)
    itemsize = pool.element_size()
    for bm, db in zip(maps.buckets, dm.buckets):
        B, nf, mb = bm.B, bm.nf, bm.mb
        m = mb * d
        blocks = pool[bm.blk_start : bm.blk_start + B * mb * mb]
        gblocks = gp[bm.g_start : bm.g_start + B * mb]
        route = bucket_route(bm, d, itemsize)
        if route == "blocks":
            out = cholesky.partial_cholesky_blocks(
                blocks.view(-1, d, d), gblocks.view(B, mb, d), nf, bm.ns, d)
        else:
            Fm = cholesky.dense_from_blocks(blocks, B, mb, d)
            gm = gblocks.reshape(B, m)
            if db.ext:
                dF, dg = _extend_add(db, outs, m, d)
                Fm = Fm + dF.reshape(B, m, m)
                gm = gm + dg
            chol = cholesky.partial_cholesky if route == "smem" else cholesky_v2.partial_cholesky
            out = chol(Fm, gm, nf, d)
        bad_total = bad_total + out["bad"]
        outs.append(out)
    return outs, bad_total


def _back_substitute(maps: NumericMaps, dm: DeviceMaps, factors, ys) -> torch.Tensor:
    """Top-down: K2 solves L^T x_f = y - W x_s per bucket; factors is
    (L, Linv, W) per bucket. Returns x [n, d] in global variable-id order."""
    d = maps.plan.d
    y0 = ys[0]
    x = torch.zeros((maps.plan.n + 1, d), dtype=y0.dtype, device=y0.device)
    for bm, db, (L, Linv, W), y in zip(reversed(maps.buckets), reversed(dm.buckets),
                                       reversed(factors), reversed(ys)):
        B, nf, ns = bm.B, bm.nf, bm.ns
        if ns > 0:
            xs = x[db.sep_idx].reshape(B, ns * d)
        else:
            xs = torch.zeros((B, 0), dtype=y.dtype, device=y.device)
        xf = cholesky_v2.backsolve_bucket(L, Linv, W, y, xs, nf, d)
        x[db.fro_idx] = xf.reshape(B * nf, d)
    # permuted rows -> global variable id order
    return x[:-1][dm.iperm]


def multifrontal_solve(
    maps: NumericMaps,
    Ab,
    lam=0.0,
    diagonal_damping: bool = False,
    return_stats: bool = False,
    return_logdet: bool = False,
):
    """Solve (J^T J + lam D) x = J^T b via the planned supernodal Cholesky.

    Ab: tuple over factor batches of (A_blocks tuple, b); the solve runs on
    their device. Returns x [n, d] in GLOBAL variable-id order; with
    return_stats=True returns (x, stats) where stats['bad_pivots'] (an int32
    device scalar) counts clamped pivots. return_logdet=True returns the
    stats too, with stats['logdet'] = log det(J^T J + lam D) (padded slots
    carry identity pivots and add log 1 = 0)."""
    dm = maps.on_device(Ab[0][1].device)
    pool, gp = assemble(maps, dm, Ab, lam, diagonal_damping)
    outs, bad_total = _eliminate(maps, dm, pool, gp)
    xg = _back_substitute(maps, dm, [(o["L"], o["Linv"], o["W"]) for o in outs],
                          [o["y"] for o in outs])
    if return_stats or return_logdet:
        stats = {"bad_pivots": bad_total}
        if return_logdet:
            stats["logdet"] = sum(
                2.0 * torch.sum(torch.log(torch.clamp(
                    torch.diagonal(o["L"], dim1=1, dim2=2), min=1e-300))) for o in outs)
        return xg, stats
    return xg


def multifrontal_factor(maps: NumericMaps, Ab, lam=0.0):
    """Assemble (J^T J + lam I) and eliminate it, keeping each bucket's
    factor (L, Linv, W) for repeated `multifrontal_apply` calls. The buckets
    take the kernels `multifrontal_solve` takes."""
    dm = maps.on_device(Ab[0][1].device)
    pool, gp = assemble(maps, dm, Ab, lam, False)
    outs, _ = _eliminate(maps, dm, pool, gp)
    return [(o["L"], o["Linv"], o["W"]) for o in outs]


def multifrontal_apply(maps: NumericMaps, chol, r: torch.Tensor) -> torch.Tensor:
    """x = H^-1 r for the factor `chol` of `multifrontal_factor`; r [n, <= d]
    in global variable-id order. Bottom-up forward solve L y = r with the
    children's g-downdates extend-added, then K2's back-substitution."""
    d = maps.plan.d
    dm = maps.on_device(r.device)
    gp = torch.zeros((maps.n_grows + 1, d), dtype=r.dtype, device=r.device)
    gp[dm.var_g_rows] = _pad_last(r, d)
    ys, ugs = [], {}
    for bf, (bm, db, (L, Linv, W)) in enumerate(zip(maps.buckets, dm.buckets, chol)):
        B, nf, ns, fd = bm.B, bm.nf, bm.ns, bm.nf * d
        gm = gp[bm.g_start : bm.g_start + B * bm.mb].reshape(B, bm.mb * d)
        if db.ext:
            gm = gm + _extend_add_g(db, ugs)
        y = kernels.forward_solve_bucket(L, Linv, gm[:, :fd], nf, d)
        if ns > 0:
            ugs[bf] = gm[:, fd:] - torch.einsum("bkf,bk->bf", W, y)
        ys.append(y)
    return _back_substitute(maps, dm, chol, ys)


# ---------------------------------------------------------------------------
# optimizer integration
# ---------------------------------------------------------------------------


def _plan_key(lg):
    return (
        tuple((lb.var_types, len(lb.b)) for lb in lg.batches),
        tuple(sorted(lg.type_counts.items())),
    )


def set_graph_plan(graph, lg, plan: EliminationPlan, maps: NumericMaps) -> None:
    """Make `solve_linearized` use a prebuilt (plan, maps) for this graph's
    structure: a plan depends on the structure alone, so a caller that
    solves one structure in two dtypes, or with an ordering of its own,
    plans once."""
    _PLANNED.add(graph)
    graph.__dict__.setdefault("_mf_plans", {})[_plan_key(lg)] = (plan, maps)


_PLANNED = weakref.WeakSet()  # graphs holding cached plans


def clear_plan_cache() -> None:
    """Forget every cached (plan, maps), so each graph plans anew."""
    for graph in list(_PLANNED):
        graph.__dict__.pop("_mf_plans", None)
    _PLANNED.clear()


def _graph_plan(graph, lg):
    """(plan, maps) for this graph's structure, cached on the graph."""
    key = _plan_key(lg)
    _PLANNED.add(graph)
    cache = graph.__dict__.setdefault("_mf_plans", {})
    ent = cache.get(key)
    if ent is None:
        types = sorted(lg.type_counts)
        dims = {t: manifold.get(t).dim for t in types}
        d = max(dims.values())
        offs = type_offsets(lg.type_counts)
        n = sum(lg.type_counts.values())
        structure = [
            BatchStructure(
                tuple(dims[t] for t in lb.var_types),
                tuple(
                    np.asarray(r, dtype=np.int64) + offs[t]
                    for r, t in zip(lb.rows, lb.var_types)
                ),
                lb.sign,
            )
            for lb in lg.batches
        ]
        plan = build_plan_for_graph(structure, n, d)
        var_dims = np.full(n, d, dtype=np.int64)
        for t in types:
            var_dims[offs[t] : offs[t] + lg.type_counts[t]] = dims[t]
        ent = (plan, build_numeric_maps(plan, structure, var_dims=var_dims))
        cache[key] = ent
    return ent


def solve_linearized(graph, values, lam, diagonal_damping=False, cache=None):
    """Optimizer hook (solver="multifrontal"): linearize once per outer
    iteration (cached), then damped supernodal solves per lambda try.

    Mixed variable types/dims: every variable gets a d_max-padded tangent
    block (fake dims pinned by identity); the delta is sliced back per type.
    """
    from gtsam_petercdev_torch.linear import solve as linsolve

    cache = cache if cache is not None else {}
    if cache.get("mf_lg") is None:
        cache["mf_lg"] = graph.linearize(values)
    lg = cache["mf_lg"]
    _, maps = _graph_plan(graph, lg)

    types = sorted(lg.type_counts)
    offs = type_offsets(lg.type_counts)
    Ab = tuple((lb.A, lb.b) for lb in lg.batches)
    x, stats = multifrontal_solve(
        maps, Ab, lam, diagonal_damping=diagonal_damping, return_stats=True
    )
    # surface the clamped-pivot count so LM can reject indefinite trials
    cache["bad_pivots"] = stats["bad_pivots"]
    delta = {
        t: x[offs[t] : offs[t] + lg.type_counts[t], : manifold.get(t).dim]
        for t in types
    }

    return delta, linsolve.linearized_decrease(lg, delta)


def plan_flop_stats(plan, var_dims=None):
    """Padded vs native factorization FLOPs of one multifrontal sweep.

    Padded: every clique runs at its bucket's (nf_pad, ns_pad) * d shape
    (what the device runs). Native: the clique's true frontal/separator dims
    under var_dims. The ratio is the shape-class + dim-padding waste."""
    d = plan.d
    if var_dims is None:
        var_dims = np.full(plan.n, d, dtype=np.int64)

    def _flops(f, s):
        return f**3 / 3.0 + f * f * s + f * s * s

    padded = native = 0.0
    for lv in plan.levels:
        for bk in lv:
            fpad, spad = bk.nf * d, bk.ns * d
            padded += len(bk.cliques) * _flops(fpad, spad)
            for cid in bk.cliques:
                c = plan.cliques[cid]
                ft = float(sum(var_dims[plan.perm[pv]] for pv in c.frontal))
                st = float(sum(var_dims[plan.perm[pv]] for pv in c.separator))
                native += _flops(ft, st)
    return {
        "padded_gflops": padded / 1e9,
        "native_gflops": native / 1e9,
        "padding_waste_pct": round(100.0 * (1.0 - native / padded), 1) if padded else 0.0,
    }
