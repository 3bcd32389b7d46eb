"""Partitioned separator-Schur solve: parts folded onto a device, ranks
joined by torch.distributed.

Port of gtsam_petercdev_tpu/parallel/partition.py. The map is split into P
interior regions separated by a global vertex separator S
(`partition_vars`, the analog of gtsam_unstable/partition/FindSeparator.h:41);
each part's interior is eliminated with the batched partial-Cholesky
kernels of the single-device multifrontal solver; the Schur complements
onto S are summed; the dense separator system is solved on every rank;
back-substitution runs per part.

Host planning (`build_partitioned_plan`, numpy/scipy) is a copy of the JAX
package's, COLAMD per part included, and gives the same plan integer for
integer: every part is padded to one level signature (level count, per
level a clique count B and shape nf, ns), and every index map is per-part
data with a leading [P] axis.

Execution (`PartitionedSolver`). The JAX package runs one part per mesh
device under shard_map. Here parts are data: a rank holds P/R contiguous
parts on its device (R = the process group's size, 1 without a group), and
because all parts share the padded signature, each level of a rank's parts
is ONE bucket of (P/R * B, nf, ns) cliques: one launch of the kernel
`elimination.bucket_route` picks (K4 / K3 / K1) and one K2 launch in the
back-substitution. Every sum is host-planned (`GatherSumPlan`: gathers in a
fixed order, no scatter-add), so two runs on the card are bitwise equal:
the factor assembly, each level's extend-add into the pool, and the
separator sums over the rank's parts; across ranks one
`torch.distributed.all_reduce(SUM)` (the JAX package's `psum`). The
separator system is a dense Cholesky (`torch.linalg.cholesky_ex`), as
`jax.scipy.linalg.cho_factor` is in the JAX package: where it fails the
separator solution is NaN, as there, and the failure is reported to LM
with the kernels' clamped pivots (`solve(..., return_stats=True)`).

Math per part p (uniform padded block dim d):
  H = [H_II  H_IS; H_SI  H_SS_p]  (interior I_p, separator scope S_p ⊆ S)
  interior multifrontal elimination ⇒ Schur U_p = H_SS_p − H_SI H_II⁻¹ H_IS
  Σ_p U_p ⇒ dense S system ⇒ x_S (on every rank)
  back-substitution with x_S seeded ⇒ x_I_p
Factors whose variables all lie in S are summed straight into the
separator system (by the rank that holds part 0).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from gtsam_petercdev_torch.device import DeviceLike, check_on, resolve_device
from gtsam_petercdev_torch.inference.elimination import (
    GatherSumPlan,
    DeviceGatherSum,
    apply_gather_sum,
    bucket_route,
    build_gather_sum_plan,
)
from gtsam_petercdev_torch.inference.symbolic import (
    colamd_ordering,
    symbolic_eliminate,
)
from gtsam_petercdev_torch.ops import cholesky, cholesky_v2


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# graph partitioning (host)
# ---------------------------------------------------------------------------


def partition_vars(
    n: int, edges: np.ndarray, n_parts: int
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Recursive BFS-bisection vertex partitioning.

    Returns (interiors, separator): `interiors` is a list of n_parts arrays
    of variable ids with NO edge between two different interiors; every
    crossing path goes through `separator`. The analog of the reference's
    METIS FindSeparator (gtsam_unstable/partition/FindSeparator.h:41).
    """
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    if n_parts <= 1 or n <= n_parts:
        return [np.arange(n, dtype=np.int64)], np.zeros(0, dtype=np.int64)
    i = np.concatenate([edges[:, 0], edges[:, 1]])
    j = np.concatenate([edges[:, 1], edges[:, 0]])
    A = sp.csr_matrix((np.ones(len(i)), (i, j)), shape=(n, n))
    A.sum_duplicates()

    sep_all: List[np.ndarray] = []

    def bisect(nodes: np.ndarray):
        """-> (half_a, half_b, sep) with sep ⊂ half_a's side."""
        sub = A[nodes][:, nodes]
        nsub = len(nodes)
        ncomp, labels = csgraph.connected_components(sub, directed=False)
        if ncomp > 1:
            # split by components (balanced-ish)
            ca = labels == labels[0]
            return nodes[ca], nodes[~ca], np.zeros(0, dtype=np.int64)
        d0 = csgraph.breadth_first_order(
            sub, 0, directed=False, return_predecessors=False
        )
        far = d0[-1]
        dist = csgraph.dijkstra(sub, directed=False, unweighted=True, indices=far)
        med = np.median(dist)
        maskA = dist <= med
        if maskA.all() or not maskA.any():
            half = nsub // 2
            sortd = np.argsort(dist, kind="stable")
            maskA = np.zeros(nsub, dtype=bool)
            maskA[sortd[:half]] = True
        B_ind = np.where(~maskA)[0]
        nbrs_of_B = np.unique(sub[B_ind].indices)
        sep_mask = np.zeros(nsub, dtype=bool)
        sep_mask[nbrs_of_B] = True
        sep_mask &= maskA
        a_mask = maskA & ~sep_mask
        return nodes[a_mask], nodes[~maskA], nodes[sep_mask]

    parts: List[np.ndarray] = [np.arange(n, dtype=np.int64)]
    while len(parts) < n_parts:
        # split the largest part
        parts.sort(key=len, reverse=True)
        nodes = parts.pop(0)
        a, b, s = bisect(nodes)
        if len(s):
            sep_all.append(s)
        if len(a) == 0 or len(b) == 0:
            # could not split further: re-insert and stop
            parts.insert(0, np.concatenate([a, b]))
            break
        parts.append(a)
        parts.append(b)
    while len(parts) < n_parts:
        parts.append(np.zeros(0, dtype=np.int64))
    sep = (
        np.unique(np.concatenate(sep_all))
        if sep_all
        else np.zeros(0, dtype=np.int64)
    )
    return parts[:n_parts], sep


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------


@dataclass
class PartitionedPlan:
    n: int
    d: int
    S: int  # separator var count
    n_parts: int
    sep_gids: np.ndarray  # [S] global var id per separator slot
    int_gids: List[np.ndarray]  # per part, interior gids in local-var order
    levels: List[Tuple[int, int, int]]  # unified (B, nf, ns) per level
    pool_size: int
    g_size: int
    m_max: int  # padded local-var count (x_perm length)
    # stacked per-part device maps (leading axis P)
    batch_maps: List[Dict[str, np.ndarray]]
    eye_rows: np.ndarray  # [P, E] pool rows
    eye_vals: np.ndarray  # [P, E, d*d]
    damp_rows: np.ndarray  # [P, V] pool rows of interior var diag blocks
    lvl_ext: List[Dict[str, np.ndarray]]  # per level stacked ext/sep/back maps
    sep_seed_pos: np.ndarray  # [P, Sp] x_perm positions of local sep vars
    sep_seed_sid: np.ndarray  # [P, Sp] global separator slot (trash S)
    int_out_pos: List[np.ndarray]  # per part [n_int_p] x_perm position of gid
    sep_fake_diag: np.ndarray  # [S*d] 1.0 where dim padding needs pinning
    sep_real_diag: np.ndarray  # [S*d] 1.0 on real dims (damping)


def _graph_edges(structure) -> np.ndarray:
    edge_list = []
    for ent in structure:
        keys = ent["keys"]
        K = keys.shape[1]
        for a in range(K):
            for b in range(a + 1, K):
                edge_list.append(np.stack([keys[:, a], keys[:, b]], axis=1))
    if not edge_list:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(edge_list, axis=0)


def build_partitioned_plan(
    structure: Sequence[Dict],
    n: int,
    d: int,
    n_parts: int,
    var_dims: Optional[np.ndarray] = None,
) -> PartitionedPlan:
    """structure: per factor batch {'keys': [N, K] int64 gids, 'dims': tuple}.

    Builds the partition, the per-part interior elimination plans, unifies
    their padded signatures, and stacks every index map with a leading
    [n_parts] axis (`PartitionedSolver` folds a rank's parts from it).
    """
    if var_dims is None:
        var_dims = np.full(n, d, dtype=np.int64)
    edges = _graph_edges(structure)
    interiors, sep = partition_vars(n, edges, n_parts)
    while len(interiors) < n_parts:  # tiny graphs: some parts stay empty
        interiors.append(np.zeros(0, dtype=np.int64))
    S = len(sep)
    sid = np.full(n, -1, dtype=np.int64)
    sid[sep] = np.arange(S)
    part_of = np.full(n, -1, dtype=np.int64)
    for p, ints in enumerate(interiors):
        part_of[ints] = p

    # --- assign factors: any interior var fixes the part; all-sep -> owner 0
    fac_part: List[np.ndarray] = []
    for ent in structure:
        keys = ent["keys"]
        pk = part_of[keys]  # [N, K], -1 for sep vars
        fp = pk.max(axis=1)  # interior part (or -1 if pure-sep)
        # separator property: all interior vars of one factor share a part
        assert np.all((pk < 0) | (pk == fp[:, None])), (
            "factor spans two interiors — not a vertex separator"
        )
        fac_part.append(fp)

    # --- per-part local problems -----------------------------------------
    per_part = []
    for p in range(n_parts):
        ints = interiors[p]
        # local sep scope: sep vars appearing in this part's factors
        scope = set()
        for ent, fp in zip(structure, fac_part):
            rows = np.where(fp == p)[0]
            if len(rows):
                ks = ent["keys"][rows]
                scope.update(int(v) for v in ks.reshape(-1) if part_of[v] < 0)
        sep_local = np.asarray(sorted(scope), dtype=np.int64)
        local = np.concatenate([ints, sep_local])
        lid = np.full(n, -1, dtype=np.int64)
        lid[local] = np.arange(len(local))
        n_int = len(ints)
        fvars = []
        rowsets = []
        for ent, fp in zip(structure, fac_part):
            rows = np.where(fp == p)[0]
            rowsets.append(rows)
            if len(rows):
                fvars.append(lid[ent["keys"][rows]])
        m_local = len(local)
        if n_int == 0:
            per_part.append(
                dict(local=local, lid=lid, n_int=0, plan=None,
                     rowsets=rowsets, sep_local=sep_local)
            )
            continue
        base = colamd_ordering(m_local, _local_edges(fvars, m_local))
        sep_set = set(range(n_int, m_local))
        order = np.asarray(
            [v for v in base if v not in sep_set]
            + list(range(n_int, m_local)),
            dtype=np.int64,
        )
        plan = symbolic_eliminate(
            m_local, fvars if fvars else [np.zeros((0, 1), np.int64)], d,
            ordering=order, max_buckets_per_level=1,
            no_merge_across=sep_set, pad_fn=_pow2,
        )
        per_part.append(
            dict(local=local, lid=lid, n_int=n_int, plan=plan,
                 rowsets=rowsets, sep_local=sep_local)
        )

    # --- unify level signatures across parts ------------------------------
    # keep only interior cliques (frontal positions < n_int); their levels
    part_levels: List[List] = []  # per part: list of lists of cliques
    for pp in per_part:
        plan = pp["plan"]
        if plan is None:
            part_levels.append([])
            continue
        n_int = pp["n_int"]
        lvls: Dict[int, List] = {}
        for c in plan.cliques:
            if c.frontal[0] < n_int:  # pure by the merge barrier
                assert all(v < n_int for v in c.frontal)
                lvls.setdefault(c.level, []).append(c)
        # compress level ids preserving order
        part_levels.append([lvls[k] for k in sorted(lvls)])
    L = max((len(pl) for pl in part_levels), default=1)
    L = max(L, 1)
    levels: List[Tuple[int, int, int]] = []
    for li in range(L):
        B = nf = 1
        ns = 0
        for pl in part_levels:
            if li < len(pl):
                cl = pl[li]
                B = max(B, _pow2(len(cl)))
                nf = max(nf, max(c.bucket[0] for c in cl))
                ns = max(ns, max(c.bucket[1] for c in cl))
        levels.append((B, nf, ns))

    # pool layout (shared across parts)
    pool_off, g_off = [], []
    boff = goff = 0
    for (B, nf, ns) in levels:
        mb = nf + ns
        pool_off.append(boff)
        g_off.append(goff)
        boff += B * mb * mb
        goff += B * mb
    pool_size, g_size = boff, goff
    trash_blk, trash_g = pool_size, g_size
    m_max = _pow2(max(max(len(pp["local"]) for pp in per_part), 1))
    x_trash = m_max
    sep_trash_blk = S * S  # flat sep pool trash row
    sep_trash_g = S

    dd = d * d
    eye_flat = np.eye(d).reshape(-1)

    # --- per-part layout: assign cliques to level slots, positions --------
    part_meta = []
    for p, pp in enumerate(per_part):
        plan = pp["plan"]
        meta = dict(
            blk_base={}, g_base={}, mb_of={}, cpos={}, lvl_cl=[],
        )
        if plan is not None:
            for c in plan.cliques:
                c._fpos = {v: i for i, v in enumerate(c.frontal)}
                c._spos = {v: i for i, v in enumerate(c.separator)}
        for li, cl in enumerate(part_levels[p]):
            B, nf, ns = levels[li]
            mb = nf + ns
            for i, c in enumerate(cl):
                meta["blk_base"][c.cid] = pool_off[li] + i * mb * mb
                meta["g_base"][c.cid] = g_off[li] + i * mb
                meta["mb_of"][c.cid] = mb
                meta["nf_of"] = meta.get("nf_of", {})
                meta["nf_of"][c.cid] = nf
            meta["lvl_cl"].append(cl)
        part_meta.append(meta)

    def cpos(meta, c, pv):
        fp = c._fpos.get(pv)
        if fp is not None:
            return fp
        return meta["nf_of"][c.cid] + c._spos[pv]

    # --- factor scatter maps (pool + sep), stacked -------------------------
    batch_maps = []
    for bi, ent in enumerate(structure):
        keys = ent["keys"]
        K = keys.shape[1]
        n_sep_rows = int(np.sum(fac_part[bi] < 0))
        Nb = max(
            max((len(pp["rowsets"][bi]) for pp in per_part), default=0),
            # part 0 carries its own rows PLUS the pure-separator factors
            len(per_part[0]["rowsets"][bi]) + n_sep_rows,
        )
        Nb = _pow2(max(1, Nb))
        rows_m = np.zeros((n_parts, Nb), dtype=np.int32)
        mask_m = np.zeros((n_parts, Nb), dtype=np.float64)
        blkp = np.full((n_parts, Nb, K, K), trash_blk, dtype=np.int32)
        gixp = np.full((n_parts, Nb, K), trash_g, dtype=np.int32)
        blks = np.full((n_parts, Nb, K, K), sep_trash_blk, dtype=np.int32)
        gixs = np.full((n_parts, Nb, K), sep_trash_g, dtype=np.int32)
        for p, pp in enumerate(per_part):
            rows = pp["rowsets"][bi]
            plan = pp["plan"]
            lid = pp["lid"]
            take = list(rows)
            # pure-sep factors ride on part 0
            if p == 0:
                sep_rows = np.where(fac_part[bi] < 0)[0]
            else:
                sep_rows = np.zeros(0, dtype=np.int64)
            nr = len(take)
            nsr = len(sep_rows)
            rows_m[p, :nr] = take
            rows_m[p, nr : nr + nsr] = sep_rows
            mask_m[p, : nr + nsr] = 1.0
            if nr and plan is not None:
                meta = part_meta[p]
                lids = lid[keys[rows]]
                pvs = plan.iperm[lids]
                own = plan.var_clique[pvs.min(axis=1)]
                for i in range(nr):
                    c = plan.cliques[own[i]]
                    bb = meta["blk_base"][c.cid]
                    gb = meta["g_base"][c.cid]
                    mb = meta["mb_of"][c.cid]
                    pos = [cpos(meta, c, pvs[i, k]) for k in range(K)]
                    for k in range(K):
                        gixp[p, i, k] = gb + pos[k]
                        for l in range(K):
                            blkp[p, i, k, l] = bb + pos[k] * mb + pos[l]
            for i, r in enumerate(sep_rows):
                ss = sid[keys[r]]
                for k in range(K):
                    gixs[p, nr + i, k] = ss[k]
                    for l in range(K):
                        blks[p, nr + i, k, l] = ss[k] * S + ss[l]
        batch_maps.append(
            dict(rows=rows_m, mask=mask_m, blk_pool=blkp, gix_pool=gixp,
                 blk_sep=blks, gix_sep=gixs, K=K, Nb=Nb)
        )

    # --- eye padding + damping rows ---------------------------------------
    eye_rows_l, eye_vals_l, damp_rows_l = [], [], []
    for p, pp in enumerate(per_part):
        plan, meta = pp["plan"], part_meta[p]
        er, ev, dr = [], [], []
        used = np.zeros(len(levels), dtype=np.int64)
        for li, cl in enumerate(part_levels[p]):
            used[li] = len(cl)
        for li, (B, nf, ns) in enumerate(levels):
            mb = nf + ns
            for i in range(int(used[li]), B):
                for j in range(nf):
                    er.append(pool_off[li] + i * mb * mb + j * mb + j)
                    ev.append(eye_flat)
        if plan is not None:
            local = pp["local"]
            for li, cl in enumerate(part_levels[p]):
                B, nf, ns = levels[li]
                mb = nf + ns
                for i, c in enumerate(cl):
                    bb = meta["blk_base"][c.cid]
                    for fi in range(len(c.frontal), nf):
                        er.append(bb + fi * mb + fi)
                        ev.append(eye_flat)
                    for fi, pv in enumerate(c.frontal):
                        dr.append(bb + fi * mb + fi)
                        dv = int(var_dims[local[plan.perm[pv]]])
                        if dv < d:
                            v = np.zeros((d, d))
                            v[np.arange(dv, d), np.arange(dv, d)] = 1.0
                            er.append(bb + fi * mb + fi)
                            ev.append(v.reshape(-1))
        eye_rows_l.append(er)
        eye_vals_l.append(ev)
        damp_rows_l.append(dr)
    E = _pow2(max(max(len(e) for e in eye_rows_l), 1))
    V = _pow2(max(max(len(r) for r in damp_rows_l), 1))
    eye_rows = np.full((n_parts, E), trash_blk, dtype=np.int32)
    eye_vals = np.zeros((n_parts, E, dd))
    damp_rows = np.full((n_parts, V), trash_blk, dtype=np.int32)
    for p in range(n_parts):
        er, ev, dr = eye_rows_l[p], eye_vals_l[p], damp_rows_l[p]
        if er:
            eye_rows[p, : len(er)] = er
            eye_vals[p, : len(er)] = np.stack(ev)
        if dr:
            damp_rows[p, : len(dr)] = dr

    # --- per-level extend-add / sep-redirect / back-substitution maps -----
    lvl_ext = []
    for li, (B, nf, ns) in enumerate(levels):
        ext = np.full((n_parts, B, ns, ns), trash_blk, dtype=np.int32)
        extg = np.full((n_parts, B, ns), trash_g, dtype=np.int32)
        sext = np.full((n_parts, B, ns, ns), sep_trash_blk, dtype=np.int32)
        sextg = np.full((n_parts, B, ns), sep_trash_g, dtype=np.int32)
        sidx = np.full((n_parts, B, ns), x_trash, dtype=np.int32)
        fidx = np.full((n_parts, B, nf), x_trash, dtype=np.int32)
        for p, pp in enumerate(per_part):
            plan, meta = pp["plan"], part_meta[p]
            if plan is None or li >= len(part_levels[p]):
                continue
            n_int = pp["n_int"]
            local = pp["local"]
            for i, c in enumerate(part_levels[p][li]):
                for fi, pv in enumerate(c.frontal):
                    fidx[p, i, fi] = pv
                for si, pv in enumerate(c.separator):
                    sidx[p, i, si] = pv
                if not c.separator:
                    continue
                # parent = clique owning min separator position
                ppv = min(c.separator)
                if ppv < n_int:
                    pc = plan.cliques[plan.var_clique[ppv]]
                    bb = meta["blk_base"][pc.cid]
                    gb = meta["g_base"][pc.cid]
                    mb = meta["mb_of"][pc.cid]
                    # (the JAX package's element loops, as one numpy
                    # assignment: the same integers)
                    ppos = np.asarray([cpos(meta, pc, v) for v in c.separator])
                    k = len(ppos)
                    extg[p, i, :k] = gb + ppos
                    ext[p, i, :k, :k] = bb + ppos[:, None] * mb + ppos[None, :]
                else:
                    # parent dropped (separator clique): redirect to the
                    # global separator system
                    ssl = sid[local[plan.perm[np.asarray(c.separator)]]]
                    k = len(ssl)
                    sextg[p, i, :k] = ssl
                    sext[p, i, :k, :k] = ssl[:, None] * S + ssl[None, :]
        lvl_ext.append(
            dict(ext=ext, extg=extg, sext=sext, sextg=sextg,
                 sep=sidx, fro=fidx)
        )

    # --- separator seeding + interior output maps -------------------------
    Sp = _pow2(max(max(len(pp["sep_local"]) for pp in per_part), 1))
    sep_seed_pos = np.full((n_parts, Sp), x_trash, dtype=np.int32)
    sep_seed_sid = np.full((n_parts, Sp), S, dtype=np.int32)
    int_out_pos = []
    int_gids = []
    for p, pp in enumerate(per_part):
        plan = pp["plan"]
        n_int = pp["n_int"]
        local = pp["local"]
        if plan is not None:
            for i, sv in enumerate(pp["sep_local"]):
                sep_seed_pos[p, i] = plan.iperm[pp["lid"][sv]]
                sep_seed_sid[p, i] = sid[sv]
            int_out_pos.append(plan.iperm[np.arange(n_int)].astype(np.int64))
        else:
            int_out_pos.append(np.zeros(0, dtype=np.int64))
        int_gids.append(local[:n_int])

    sep_fake = np.zeros(S * d)
    sep_real = np.zeros(S * d)
    for s, gv in enumerate(sep):
        dv = int(var_dims[gv])
        sep_real[s * d : s * d + dv] = 1.0
        if dv < d:
            sep_fake[s * d + dv : (s + 1) * d] = 1.0

    return PartitionedPlan(
        n=n, d=d, S=S, n_parts=n_parts,
        sep_gids=sep, int_gids=int_gids,
        levels=levels, pool_size=pool_size, g_size=g_size, m_max=m_max,
        batch_maps=batch_maps,
        eye_rows=eye_rows, eye_vals=eye_vals, damp_rows=damp_rows,
        lvl_ext=lvl_ext,
        sep_seed_pos=sep_seed_pos, sep_seed_sid=sep_seed_sid,
        int_out_pos=int_out_pos,
        sep_fake_diag=sep_fake, sep_real_diag=sep_real,
    )


def _local_edges(fvars: List[np.ndarray], m: int) -> np.ndarray:
    edge_list = []
    for fv in fvars:
        K = fv.shape[1]
        for a in range(K):
            for b in range(a + 1, K):
                edge_list.append(np.stack([fv[:, a], fv[:, b]], axis=1))
    if not edge_list:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(edge_list, axis=0)


# ---------------------------------------------------------------------------
# the solver: a rank's parts folded into one bucket a level
# ---------------------------------------------------------------------------


def _pushed(dest: np.ndarray):
    """A push of source rows into existing rows of a pool: (the distinct
    destination rows, sorted; the gather-sum plan onto them), or None when
    no row has a destination."""
    dest = np.asarray(dest, dtype=np.int64)
    sel = np.flatnonzero(dest >= 0)
    if not len(sel):
        return None
    rows, inv = np.unique(dest[sel], return_inverse=True)
    compact = np.full(len(dest), -1, dtype=np.int64)
    compact[sel] = inv
    return rows, build_gather_sum_plan(compact, len(rows), len(compact))


def _push(pool: torch.Tensor, push, src: torch.Tensor) -> torch.Tensor:
    """pool[rows] += the planned sums of src's rows, for push = (rows,
    DeviceGatherSum) of `_pushed` (None: nothing). The rows are distinct,
    so the write is an index_put_ without accumulation: deterministic."""
    if push is not None:
        rows, plan = push
        pool[rows] += apply_gather_sum(plan, src)
    return pool


@dataclass
class _Level:
    """One level of a rank's folded parts: Bt = parts * B cliques."""

    Bt: int
    nf: int
    ns: int
    pool_lo: int  # first pool row of the level
    g_lo: int  # first g-pool row
    # truthy when lower levels push Schur complements into this one;
    # `elimination.bucket_route` reads it (a leaf level takes K4)
    ext_mm: bool
    ext: Optional[tuple]  # (pool rows, plan over the level's U block rows)
    ext_g: Optional[tuple]  # (g-pool rows, plan over its ug rows)
    sep_sel: np.ndarray  # U block rows bound for the separator system
    sep_g_sel: np.ndarray  # ug rows bound for it
    sidx: np.ndarray  # [Bt * ns] x rows of the separator slots (trash pads)
    fidx: np.ndarray  # [Bt * nf] x rows of the frontal slots (trash pads)


@dataclass
class _Folded:
    """Host maps of one rank's parts over one pool (see `_fold`)."""

    take: List[np.ndarray]  # per batch, the global factor rows the rank assembles
    n_pool: int  # rows of the block pool (d*d each)
    n_g: int  # rows of the g pool (d each)
    # factor blocks + identity padding + damping -> (pool rows, plan); the
    # rows no factor reaches (most of a padded level) stay 0
    asm: Optional[tuple]
    asm_g: Optional[tuple]  # factor g rows -> (g-pool rows, plan)
    eye_vals: np.ndarray  # [E, d*d] identity padding values
    n_damp: int  # damped diagonal blocks (lam * I each)
    sep: Optional[GatherSumPlan]  # factor blocks + levels' sep U rows -> [S*S]
    sep_g: Optional[GatherSumPlan]  # factor g rows + levels' sep ug rows -> [S]
    levels: List[_Level]
    seed_pos: np.ndarray  # x rows of the parts' separator slots (trash pads)
    seed_sid: np.ndarray  # their separator slots (S pads)
    out_idx: np.ndarray  # [n] row of [x interiors | x_S | 0] per global var


def _fold(plan: PartitionedPlan, parts: range, owns_sep: bool) -> _Folded:
    """Fold the plan's per-part maps for `parts` (contiguous) into one pool:
    level li holds, part after part, each part's B cliques, so a level is
    one bucket of len(parts) * B cliques. Pool row r of part q (the JAX
    package's per-part numbering) becomes Q * off_li + q * size_li +
    (r - off_li); x position v of part q becomes q * m_max + v; each map's
    trash slot is dropped (-1) or, for x, the one row past the parts'."""
    S, Q = plan.S, len(parts)
    pool_off, g_off, blk_sz, g_sz = [], [], [], []
    boff = goff = 0
    for (B, nf, ns) in plan.levels:
        mb = nf + ns
        pool_off.append(boff)
        g_off.append(goff)
        blk_sz.append(B * mb * mb)
        g_sz.append(B * mb)
        boff += B * mb * mb
        goff += B * mb
    pool_off, g_off = np.asarray(pool_off), np.asarray(g_off)
    blk_sz, g_sz = np.asarray(blk_sz), np.asarray(g_sz)

    def fold(r, q, off, sz, trash):
        r = np.asarray(r, dtype=np.int64)
        out = np.full(r.shape, -1, dtype=np.int64)
        real = r != trash
        rr = r[real]
        li = np.searchsorted(off, rr, side="right") - 1
        out[real] = Q * off[li] + q * sz[li] + (rr - off[li])
        return out

    fold_blk = lambda r, q: fold(r, q, pool_off, blk_sz, plan.pool_size)
    fold_g = lambda r, q: fold(r, q, g_off, g_sz, plan.g_size)
    x_trash = Q * plan.m_max
    fold_x = lambda v, q: np.where(v == plan.m_max, x_trash, q * plan.m_max + v)
    sep_blk = lambda s: np.where(s == S * S, -1, s)
    sep_g = lambda s: np.where(s == S, -1, s)

    # factor contributions, in the order `PartitionedSolver.solve` computes
    # them: per batch, the rank's rows part after part; blocks k-major then
    # l, then g rows per k
    take, blk_dest, blk_sep, g_dest, g_sep = [], [], [], [], []
    for bm in plan.batch_maps:
        K = bm["K"]
        cnt = [int(bm["mask"][p].sum()) for p in parts]
        take.append(np.concatenate(
            [bm["rows"][p, :c] for p, c in zip(parts, cnt)]).astype(np.int64))
        for k in range(K):
            for l in range(K):
                blk_dest.append(np.concatenate([fold_blk(bm["blk_pool"][p, :c, k, l], q)
                                                for q, (p, c) in enumerate(zip(parts, cnt))]))
                blk_sep.append(np.concatenate([sep_blk(bm["blk_sep"][p, :c, k, l])
                                               for p, c in zip(parts, cnt)]))
        for k in range(K):
            g_dest.append(np.concatenate([fold_g(bm["gix_pool"][p, :c, k], q)
                                          for q, (p, c) in enumerate(zip(parts, cnt))]))
            g_sep.append(np.concatenate([sep_g(bm["gix_sep"][p, :c, k])
                                         for p, c in zip(parts, cnt)]))
    eye_dest = np.concatenate([fold_blk(plan.eye_rows[p], q) for q, p in enumerate(parts)])
    eye_vals = np.concatenate([plan.eye_vals[p] for p in parts])[eye_dest >= 0]
    eye_dest = eye_dest[eye_dest >= 0]
    damp_dest = np.concatenate([fold_blk(plan.damp_rows[p], q) for q, p in enumerate(parts)])
    damp_dest = damp_dest[damp_dest >= 0]
    n_pool, n_g = Q * plan.pool_size, Q * plan.g_size
    n_fac_blk = sum(len(x) for x in blk_dest)
    n_fac_g = sum(len(x) for x in g_dest)
    asm = _pushed(np.concatenate(blk_dest + [eye_dest, damp_dest]))
    asm_g = _pushed(np.concatenate(g_dest))

    # levels: folded buckets, the extend-add pushes, the separator rows
    levels = []
    got_ext = np.zeros(len(plan.levels), dtype=bool)  # over ALL parts: one routing
    for le in plan.lvl_ext:
        r = le["ext"][le["ext"] < plan.pool_size]
        if len(r):
            got_ext[np.searchsorted(pool_off, r, side="right") - 1] = True
    sep_src, sep_g_src = [], []
    for li, ((B, nf, ns), le) in enumerate(zip(plan.levels, plan.lvl_ext)):
        ext = np.concatenate([fold_blk(le["ext"][p].reshape(-1), q) for q, p in enumerate(parts)])
        extg = np.concatenate([fold_g(le["extg"][p].reshape(-1), q) for q, p in enumerate(parts)])
        sext = np.concatenate([sep_blk(le["sext"][p].reshape(-1)) for p in parts])
        sextg = np.concatenate([sep_g(le["sextg"][p].reshape(-1)) for p in parts])
        sep_sel, sep_g_sel = np.flatnonzero(sext >= 0), np.flatnonzero(sextg >= 0)
        sep_src.append(sext[sep_sel])
        sep_g_src.append(sextg[sep_g_sel])
        levels.append(_Level(
            Bt=Q * B, nf=nf, ns=ns, pool_lo=Q * pool_off[li], g_lo=Q * g_off[li],
            ext_mm=bool(got_ext[li]), ext=_pushed(ext), ext_g=_pushed(extg),
            sep_sel=sep_sel, sep_g_sel=sep_g_sel,
            sidx=np.concatenate([fold_x(le["sep"][p].reshape(-1), q) for q, p in enumerate(parts)]),
            fidx=np.concatenate([fold_x(le["fro"][p].reshape(-1), q) for q, p in enumerate(parts)]),
        ))
    sep = sep_gp = None
    if S:
        sep_dest = np.concatenate(blk_sep + [np.full(len(eye_dest) + len(damp_dest), -1)] + sep_src)
        sep = build_gather_sum_plan(sep_dest, S * S, len(sep_dest))
        sep_g_dest = np.concatenate(g_sep + sep_g_src)
        sep_gp = build_gather_sum_plan(sep_g_dest, S, len(sep_g_dest))

    # the separator seed and the output gather
    seed_pos = np.concatenate([fold_x(plan.sep_seed_pos[p], q) for q, p in enumerate(parts)])
    seed_sid = np.concatenate([plan.sep_seed_sid[p] for p in parts])
    zero = x_trash + S  # the zero row after [x interiors | x_S]
    out_idx = np.full(plan.n, zero, dtype=np.int64)
    for q, p in enumerate(parts):
        out_idx[plan.int_gids[p]] = q * plan.m_max + plan.int_out_pos[p]
    if owns_sep and S:
        out_idx[plan.sep_gids] = x_trash + np.arange(S)
    return _Folded(take=take, n_pool=n_pool, n_g=n_g, asm=asm, asm_g=asm_g, eye_vals=eye_vals, n_damp=len(damp_dest),
                   sep=sep, sep_g=sep_gp, levels=levels, seed_pos=seed_pos, seed_sid=seed_sid,
                   out_idx=out_idx)


class PartitionedSolver:
    """The partitioned solve of one problem structure on one rank.

    plan: a `PartitionedPlan` of P = plan.n_parts parts. group: a
    torch.distributed process group of R ranks, R dividing P, or None (R =
    1: this device holds every part). Rank r holds parts [r P/R, (r+1) P/R)
    on `device`; every rank calls `solve` with the same inputs.

    solve(Ab, lam) -> x [n, d] on `device`, in global variable order: Ab is
    the per-batch (A_blocks tuple, b) tuple the multifrontal solver takes,
    in GLOBAL factor order, on `device`; each rank gathers its parts'
    factor rows. With return_stats=True -> (x, stats): stats['bad_pivots']
    (an int32 device scalar, summed over ranks) counts the kernels' clamped
    pivots plus 1 where the separator Cholesky failed (x is then NaN)."""

    def __init__(self, plan: PartitionedPlan, group=None, *, device: DeviceLike = "cuda"):
        self.plan = plan
        self.group = group
        self.device = resolve_device(device)
        if group is None:
            rank, world = 0, 1
        else:
            import torch.distributed as dist

            rank, world = dist.get_rank(group), dist.get_world_size(group)
        if plan.n_parts % world:
            raise ValueError(f"{plan.n_parts} parts do not divide over {world} ranks")
        q = plan.n_parts // world
        self.parts = range(rank * q, (rank + 1) * q)
        self.folded = _fold(plan, self.parts, owns_sep=rank == 0)
        self._dev = self._upload(self.folded)

    def _upload(self, f: _Folded):
        dev = self.device
        up = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64).to(dev)
        gs = lambda p: None if p is None else DeviceGatherSum.of(p, dev)
        push = lambda e: None if e is None else (up(e[0]), DeviceGatherSum.of(e[1], dev))
        return dict(
            take=[up(t) for t in f.take], asm=push(f.asm), asm_g=push(f.asm_g),
            eye_vals=torch.as_tensor(f.eye_vals, dtype=torch.float64).to(dev),
            sep=gs(f.sep), sep_g=gs(f.sep_g),
            levels=[dict(ext=push(lv.ext), ext_g=push(lv.ext_g), sep_sel=up(lv.sep_sel),
                         sep_g_sel=up(lv.sep_g_sel), sidx=up(lv.sidx), fidx=up(lv.fidx))
                    for lv in f.levels],
            seed_pos=up(f.seed_pos), seed_sid=up(f.seed_sid), out_idx=up(f.out_idx),
            sep_fake=torch.as_tensor(self.plan.sep_fake_diag).to(dev),
            sep_real=torch.as_tensor(self.plan.sep_real_diag).to(dev))

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def solve(self, Ab, lam=0.0, return_stats: bool = False):
        plan, f, dm = self.plan, self.folded, self._dev
        d, S = plan.d, plan.S
        dd = d * d
        b0 = Ab[0][1]
        check_on(b0, self.device, "Ab")
        dtype, dev = b0.dtype, b0.device
        eye = torch.eye(d, dtype=dtype, device=dev)

        # factor Hessian blocks and g rows of the rank's factors, in the
        # order `_fold` planned
        blk_rows, g_rows = [], []
        for (A, b), take in zip(Ab, dm["take"]):
            Ag = [Ak[take] for Ak in A]
            bg = b[take]
            for k in range(len(Ag)):
                for l in range(len(Ag)):
                    blk = Ag[k].transpose(1, 2) @ Ag[l]
                    blk = tnf.pad(blk, (0, d - blk.shape[2], 0, d - blk.shape[1]))
                    blk_rows.append(blk.reshape(-1, dd))
            for k in range(len(Ag)):
                g_rows.append(tnf.pad(torch.einsum("nri,nr->ni", Ag[k], bg),
                                      (0, d - Ag[k].shape[2])))
        damp = (lam * eye).reshape(1, dd).expand(f.n_damp, dd)
        contrib = torch.cat(blk_rows + [dm["eye_vals"].to(dtype), damp])
        pool = _push(contrib.new_zeros((f.n_pool, dd)), dm["asm"], contrib)
        gp = _push(contrib.new_zeros((f.n_g, d)), dm["asm_g"], torch.cat(g_rows))

        # bottom-up: one bucket of the rank's parts a level; each level
        # pushes its Schur complements into later levels' pool rows (every
        # destination once, summed in the planned order) and hands its
        # separator rows to the separator sum
        itemsize = pool.element_size()
        bad = torch.zeros((), dtype=torch.int32, device=dev)
        factors, sep_src, sep_g_src = [], [], []
        for lv, dl in zip(f.levels, dm["levels"]):
            Bt, nf, ns = lv.Bt, lv.nf, lv.ns
            mb = nf + ns
            blocks = pool[lv.pool_lo : lv.pool_lo + Bt * mb * mb]
            gblocks = gp[lv.g_lo : lv.g_lo + Bt * mb]
            route = bucket_route(lv, d, itemsize)
            if route == "blocks":
                out = cholesky.partial_cholesky_blocks(
                    blocks.view(-1, d, d), gblocks.view(Bt, mb, d), nf, ns, d)
                U, ug = out["U_blocks"].reshape(-1, dd), out["ug_blocks"].reshape(-1, d)
            else:
                chol = cholesky.partial_cholesky if route == "smem" else cholesky_v2.partial_cholesky
                out = chol(cholesky.dense_from_blocks(blocks, Bt, mb, d),
                           gblocks.reshape(Bt, mb * d), nf, d)
                U = cholesky.blocks_from_dense(out["U"], ns, d).reshape(-1, dd)
                ug = out["ug"].reshape(-1, d)
            bad = bad + out["bad"]
            _push(pool, dl["ext"], U)
            _push(gp, dl["ext_g"], ug)
            sep_src.append(U[dl["sep_sel"]])
            sep_g_src.append(ug[dl["sep_g_sel"]])
            factors.append((out["L"], out["Linv"], out["W"], out["y"]))

        # the separator system: this rank's sum, then the sum over ranks
        if S:
            sep_pool = self._all_reduce(apply_gather_sum(dm["sep"], torch.cat([contrib] + sep_src)))
            sep_g = self._all_reduce(apply_gather_sum(dm["sep_g"], torch.cat(g_rows + sep_g_src)))
            Smat = sep_pool.reshape(S, S, d, d).permute(0, 2, 1, 3).reshape(S * d, S * d)
            Smat = Smat + torch.diag(dm["sep_fake"].to(dtype) + lam * dm["sep_real"].to(dtype))
            Lc, info = torch.linalg.cholesky_ex(Smat)
            xS = torch.cholesky_solve(sep_g.reshape(S * d, 1), Lc).reshape(S, d)
            xS = torch.where(info == 0, xS, torch.full_like(xS, float("nan")))
            bad = bad + (info != 0).to(torch.int32)
        else:
            xS = torch.zeros((0, d), dtype=dtype, device=dev)
        bad = self._all_reduce(bad)

        # top-down: the separator seeded, then one K2 launch a level
        Q = len(self.parts)
        x = torch.zeros((Q * plan.m_max + 1, d), dtype=dtype, device=dev)
        x[dm["seed_pos"]] = torch.cat([xS, xS.new_zeros((1, d))])[dm["seed_sid"]]
        for lv, dl, (L, Linv, W, y) in zip(reversed(f.levels), reversed(dm["levels"]),
                                           reversed(factors)):
            if lv.ns:
                xs = x[dl["sidx"]].reshape(lv.Bt, lv.ns * d)
            else:
                xs = y.new_zeros((lv.Bt, 0))
            xf = cholesky_v2.backsolve_bucket(L, Linv, W, y, xs, lv.nf, d)
            x[dl["fidx"]] = xf.reshape(lv.Bt * lv.nf, d)
        xg = torch.cat([x[:-1], xS, x.new_zeros((1, d))])[dm["out_idx"]]
        xg = self._all_reduce(xg)  # each entry is one rank's, the others add 0
        if return_stats:
            return xg, {"bad_pivots": bad}
        return xg


# ---------------------------------------------------------------------------
# optimizer integration (solver="partitioned")
# ---------------------------------------------------------------------------

def linearized_structure(lg):
    """(structure, var_dims) of a LinearizedGraph: per factor batch
    {'keys': [N, K] global variable ids, 'dims': tangent dims}, the
    variables numbered as the multifrontal solve numbers them (types in
    sorted-name order); var_dims [n] each variable's tangent dim."""
    from gtsam_petercdev_torch.core import manifold
    from gtsam_petercdev_torch.inference.elimination import type_offsets

    offs = type_offsets(lg.type_counts)
    dims = {t: manifold.get(t).dim for t in lg.type_counts}
    structure = [
        {"keys": np.stack([np.asarray(r, np.int64) + offs[t]
                           for r, t in zip(lb.rows, lb.var_types)], axis=1),
         "dims": tuple(dims[t] for t in lb.var_types)}
        for lb in lg.batches
    ]
    var_dims = np.zeros(sum(lg.type_counts.values()), dtype=np.int64)
    for t, c in lg.type_counts.items():
        var_dims[offs[t] : offs[t] + c] = dims[t]
    return structure, var_dims


_SOLVED = weakref.WeakSet()  # graphs holding cached partitioned solvers


def clear_solver_cache() -> None:
    """Drop every cached partitioned solver (plan, folded maps, device
    indices), so each graph plans anew on its next solve (the JAX package's
    clears its module-level cache)."""
    for graph in list(_SOLVED):
        graph.__dict__.pop("_partitioned_solvers", None)
    _SOLVED.clear()


def _graph_solver(graph, lg, n_parts, group) -> PartitionedSolver:
    """The partitioned solver of this graph's structure, cached ON the graph
    object as the multifrontal and Schur plans are (the JAX package keys a
    module-level cache by id(graph)); `clear_solver_cache` drops them."""
    from gtsam_petercdev_torch.inference.elimination import _plan_key

    key = (_plan_key(lg), n_parts)
    _SOLVED.add(graph)
    cache = graph.__dict__.setdefault("_partitioned_solvers", {})
    ent = cache.get(key)
    if ent is None or ent.group is not group:
        structure, var_dims = linearized_structure(lg)
        plan = build_partitioned_plan(structure, len(var_dims), int(var_dims.max()), n_parts,
                                      var_dims=var_dims)
        ent = cache[key] = PartitionedSolver(plan, group, device=graph.device)
    return ent


def solve_linearized(graph, values, lam, cache=None, n_parts=None, group=None):
    """GN/LM linear-solve hook over the partitioned solver (solver=
    "partitioned"). Linearizes once per outer iteration (cached in `cache`),
    plans once per graph structure and part count (cached on the graph),
    and solves the damped system (lam * I) for each lambda trial. n_parts:
    P, by default the ranks of `group`. group: a process group; by default
    the initialized default group when it has more than one rank
    (`mesh.make_mesh`), else none. Returns (delta dict, linearized cost
    decrease) like the other solvers; cache['bad_pivots'] takes the
    solve's count, so LM rejects an indefinite trial."""
    from gtsam_petercdev_torch.core import manifold
    from gtsam_petercdev_torch.inference.elimination import type_offsets
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.parallel.mesh import make_mesh

    cache = cache if cache is not None else {}
    if cache.get("mf_lg") is None:
        cache["mf_lg"] = graph.linearize(values)
    lg = cache["mf_lg"]
    if any(lb.sign != 1.0 for lb in lg.batches):
        raise NotImplementedError("the partitioned solver takes no subtracted information "
                                  "(a factor batch of sign -1)")
    if group is None:
        group = make_mesh()
    if n_parts is None:
        n_parts = 1 if group is None else torch.distributed.get_world_size(group)
    solver = _graph_solver(graph, lg, n_parts, group)
    x, stats = solver.solve(tuple((lb.A, lb.b) for lb in lg.batches), lam, return_stats=True)
    cache["bad_pivots"] = stats["bad_pivots"]
    offs = type_offsets(lg.type_counts)
    delta = {
        t: x[offs[t] : offs[t] + lg.type_counts[t], : manifold.get(t).dim]
        for t in sorted(lg.type_counts)
    }
    return delta, linsolve.linearized_decrease(lg, delta)


# ---------------------------------------------------------------------------
# mixed-dim support: uniform sub-block splitting + FLOP accounting
# ---------------------------------------------------------------------------


def split_structure_to_blocks(
    structure: Sequence[Dict], var_dims: np.ndarray, d_sub: int
):
    """Re-express a mixed-dim problem on uniform d_sub blocks.

    The partitioned plan pads every variable block to one uniform d, so a
    Point3 inside a d=9 camera problem pays (9/3)^3 = 27x its native
    factorization FLOPs. Splitting each variable of dim dv into dv/d_sub
    consecutive sub-variables (a camera -> three d=3 blocks) removes that
    padding entirely while keeping the planner uniform — the analog of
    the reference's variable-size Scatter blocks (gtsam/linear/Scatter.h:49).

    structure: per factor batch {'keys': [N, K] int64 gids, 'dims': tuple}.
    Returns (sub_structure, sub_base[n] int64, n_sub) where global sub-var
    id of (v, j) is sub_base[v] + j.
    """
    var_dims = np.asarray(var_dims, dtype=np.int64)
    assert np.all(var_dims % d_sub == 0), (var_dims.max(), d_sub)
    nb = var_dims // d_sub
    sub_base = np.concatenate([[0], np.cumsum(nb)[:-1]])
    n_sub = int(nb.sum())
    sub_structure = []
    for ent in structure:
        keys = ent["keys"]
        dims = ent["dims"]
        cols = []
        sdims = []
        for k, dv in enumerate(dims):
            for j in range(dv // d_sub):
                cols.append(sub_base[keys[:, k]] + j)
                sdims.append(d_sub)
        sub_structure.append(
            {"keys": np.stack(cols, axis=1), "dims": tuple(sdims)}
        )
    return sub_structure, sub_base, n_sub


def split_Ab_to_blocks(Ab, structure, d_sub: int):
    """Slice each factor batch's A blocks into d_sub-wide column blocks
    (same enumeration order as split_structure_to_blocks)."""
    out = []
    for (A, b), ent in zip(Ab, structure):
        blocks = []
        for k, dv in enumerate(ent["dims"]):
            for j in range(dv // d_sub):
                blocks.append(A[k][:, :, j * d_sub : (j + 1) * d_sub])
        out.append((tuple(blocks), b))
    return tuple(out)


def merge_block_solution(
    x_sub: torch.Tensor, sub_base: np.ndarray, var_dims: np.ndarray, d_sub: int
) -> torch.Tensor:
    """[n_sub, d_sub] sub-block solution -> [n, max_d] per-var layout, on
    x_sub's device (the slots past a variable's dim stay 0)."""
    var_dims = np.asarray(var_dims, dtype=np.int64)
    n, kmax, nb = len(var_dims), int(var_dims.max()) // d_sub, var_dims // d_sub
    v = np.repeat(np.arange(n), nb)  # one entry per sub-block: its variable
    j = np.arange(len(v)) - np.repeat(np.cumsum(nb) - nb, nb)  # and its index in it
    x = x_sub.new_zeros((n, kmax, d_sub))
    x[torch.as_tensor(v), torch.as_tensor(j)] = x_sub[torch.as_tensor(sub_base[v] + j)]
    return x.reshape(n, kmax * d_sub)


def plan_padded_flops(plan: PartitionedPlan) -> Dict[str, float]:
    """Padded factorization FLOPs PER PART of one partitioned solve (the
    JAX package's key names: a part was a device there), computed from the
    unified level signatures (every part runs the same padded levels): per
    clique chol((nf*d)^3/3) + trsm + syrk, plus the separator Cholesky that
    every rank runs."""
    d = plan.d
    interior = 0.0
    for (B, nf, ns) in plan.levels:
        f = nf * d
        s = ns * d
        interior += B * (f**3 / 3.0 + f * f * s + f * s * s)
    sep = (plan.S * d) ** 3 / 3.0
    return {
        "interior_gflops_per_device": interior / 1e9,
        "separator_gflops_replicated": sep / 1e9,
    }
