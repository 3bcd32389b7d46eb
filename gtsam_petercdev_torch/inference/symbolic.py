"""Symbolic elimination planning (host-side, numpy).

Copied from gtsam_petercdev_tpu/inference/symbolic.py (numpy/scipy only),
but for the fill-reducing ordering: the JAX package binds a prebuilt
CCOLAMD whose source is not in the repository, and the port's
`ccolamd_ordering` is its own approximate minimum-degree ordering
(`csrc/host/ordering.cpp`, built by g++ through `ops/build_host.py`).

The reference's inference layer builds, per solve: VariableIndex ->
fill-reducing Ordering (COLAMD, inference/Ordering.cpp:42) ->
EliminationTree (EliminationTree-inst.h:78) -> JunctionTree supernode merge
(JunctionTree-inst.h:102-120) -> parallel post-order clique elimination
(ClusterTree-inst.h:286).

The TPU-native inversion: ALL of that irregular work happens here on host,
ONCE per graph structure, producing a static `EliminationPlan` of padded,
shape-bucketed clique batches plus flat scatter/gather index maps. The device
then executes the plan as a fixed sequence of batched dense kernels
(inference/elimination.py) with no host round-trips.

v1 scope: one uniform variable type (block dim d). Mixed-dim problems (BA)
reduce to this via Schur complement pre-elimination of landmarks (sfm/).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


def colamd_ordering(n: int, edges: np.ndarray) -> np.ndarray:
    """Fill-reducing ordering via SuperLU's COLAMD on the H pattern.

    Returns perm: position -> original var id (like the reference's
    Ordering, inference/Ordering.cpp:42 — COLAMD on the variable index).
    Falls back to natural order for tiny problems.
    """
    if n <= 2 or len(edges) == 0:
        return np.arange(n, dtype=np.int64)
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    i = np.concatenate([edges[:, 0], edges[:, 1], np.arange(n)])
    j = np.concatenate([edges[:, 1], edges[:, 0], np.arange(n)])
    data = np.ones(len(i))
    H = sp.csc_matrix((data, (i, j)), shape=(n, n))
    # Diagonal-dominant values so SuperLU does no numerical row pivoting and
    # the column ordering reflects pure structure.
    H = H + sp.eye(n) * (H.sum(axis=0).max() + n)
    try:
        lu = spla.splu(
            H.tocsc(),
            permc_spec="COLAMD",
            options=dict(SymmetricMode=True),
            diag_pivot_thresh=0.0,
        )
        return np.asarray(lu.perm_c, dtype=np.int64)
    except Exception:
        return np.arange(n, dtype=np.int64)


def nested_dissection_ordering(
    n: int, edges: np.ndarray, leaf_size: int = 16
) -> np.ndarray:
    """Recursive BFS-bisection nested dissection.

    The analog of the reference's METIS ordering (inference/Ordering.cpp:211,
    gtsam_unstable/partition/NestedDissection.h) without METIS: split each
    subgraph by BFS distance from a pseudo-peripheral seed, order both halves
    recursively, then the separator LAST. Produces balanced elimination trees
    (log depth) — exactly what the level-batched supernodal kernels want —
    with small separators on SLAM-style graphs.
    """
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    if n == 0:
        return np.zeros(0, dtype=np.int64)
    i = np.concatenate([edges[:, 0], edges[:, 1]])
    j = np.concatenate([edges[:, 1], edges[:, 0]])
    A = sp.csr_matrix((np.ones(len(i)), (i, j)), shape=(n, n))
    A.sum_duplicates()

    order: List[int] = []

    def recurse(nodes: np.ndarray):
        if len(nodes) <= leaf_size:
            order.extend(nodes.tolist())
            return
        sub = A[nodes][:, nodes]
        nsub = len(nodes)
        # connected components first — recurse each separately
        ncomp, labels = csgraph.connected_components(sub, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                recurse(nodes[labels == c])
            return
        # pseudo-peripheral pair via double BFS
        d0 = csgraph.breadth_first_order(sub, 0, directed=False, return_predecessors=False)
        far = d0[-1]
        dist = sp.csgraph.dijkstra(sub, directed=False, unweighted=True, indices=far)
        med = np.median(dist)
        maskA = dist <= med
        if maskA.all() or not maskA.any():
            half = nsub // 2
            sortd = np.argsort(dist, kind="stable")
            maskA = np.zeros(nsub, dtype=bool)
            maskA[sortd[:half]] = True
        # separator: nodes of A adjacent to B
        B_ind = np.where(~maskA)[0]
        nbrs_of_B = np.unique(sub[B_ind].indices)
        sep_mask = np.zeros(nsub, dtype=bool)
        sep_mask[nbrs_of_B] = True
        sep_mask &= maskA
        A_mask = maskA & ~sep_mask
        recurse(nodes[A_mask])
        recurse(nodes[~maskA])
        order.extend(nodes[sep_mask].tolist())

    recurse(np.arange(n, dtype=np.int64))
    perm = np.asarray(order, dtype=np.int64)
    assert len(perm) == n
    return perm


def degree_ascending_ordering(n: int, edges: np.ndarray) -> np.ndarray:
    """Eliminate low-degree variables first (stable). On bipartite SfM-style
    graphs this is the landmarks-first ordering (each point's separator is
    just its few cameras) — COLAMD via SuperLU degenerates badly there
    (measured 1.7 TB symbolic fill on a 200-camera/10k-point problem vs
    0.08 GB for degree-ascending)."""
    deg = np.zeros(n, dtype=np.int64)
    if len(edges):
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
    return np.argsort(deg, kind="stable").astype(np.int64)


def amd_ordering(n: int, edges: np.ndarray, cmember: "np.ndarray | None" = None) -> np.ndarray:
    """Approximate minimum-degree ordering of the variable graph (the port's
    `csrc/host/ordering.cpp`): quotient graph, approximate external degrees,
    element absorption, supervariables with mass elimination; dense rows get
    no special treatment. `cmember` [n] puts every variable of group k before
    any of group k + 1; ties go to the lowest variable id. Returns perm:
    position -> variable id."""
    import ctypes

    from gtsam_petercdev_torch.ops import build_host

    perm = np.zeros(n, dtype=np.int64)
    if n == 0:
        return perm
    e = np.ascontiguousarray(np.asarray(edges, dtype=np.int64).reshape(-1, 2))
    cm = None if cmember is None else np.ascontiguousarray(cmember, dtype=np.int64)
    if cm is not None and cm.shape != (n,):
        raise ValueError(f"cmember has shape {cm.shape}, expected ({n},)")
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
    rc = build_host.load("ordering").gtsam_amd_order(
        n, e.shape[0], ptr(e), None if cm is None else ptr(cm), ptr(perm))
    if rc != 0:
        raise ValueError(f"edges name a variable outside [0, {n})")
    return perm


def ccolamd_ordering(
    n: int, edges: np.ndarray, cmember: "np.ndarray | None" = None
) -> np.ndarray:
    """The port's stand-in for the reference's constrained COLAMD
    (inference/Ordering.cpp:55-126), which the JAX package binds from a
    prebuilt library whose source is not in the repository: the port's own
    approximate minimum-degree ordering (`amd_ordering`), with CCOLAMD's
    `cmember` constraint groups. Its fill comes within a few percent of
    CCOLAMD's, but its trees are its own. For n <= 2 or no edges it returns
    the COLAMD proxy's answer, as the JAX function does."""
    if n <= 2 or len(edges) == 0:
        return colamd_ordering(n, edges)
    return amd_ordering(n, edges, cmember)


def ordering_candidates(n: int, edges: np.ndarray) -> List[Tuple[str, np.ndarray, int]]:
    """best_ordering's candidates, the JAX package's four in its order: ND,
    `ccolamd_ordering` (the port's AMD), the COLAMD proxy, degree-ascending;
    each as (name, perm, F_size of its plan at d = 1). F_size at block
    dimension d is d^2 (F_size - 1) + 1."""
    out = []
    for name, fn in (("nested_dissection", nested_dissection_ordering),
                     ("amd", ccolamd_ordering), ("colamd_proxy", colamd_ordering),
                     ("degree_ascending", degree_ascending_ordering)):
        perm = fn(n, edges)
        out.append((name, perm, symbolic_eliminate(n, [edges], 1, ordering=perm).F_size))
    return out


def best_ordering(n: int, edges: np.ndarray) -> np.ndarray:
    """Pick the ordering with the least (padded) symbolic fill — the planner
    is cheap relative to the numeric solve, so try the four
    `ordering_candidates` and keep the first of least F_size."""
    return min(ordering_candidates(n, edges), key=lambda c: c[2])[1]


def constrained_colamd_ordering(
    n: int, edges: np.ndarray, last: np.ndarray
) -> np.ndarray:
    """ColamdConstrainedLast (Ordering.cpp:128): force `last` vars to the end
    of the ordering (iSAM2's mechanism for keeping new vars near the root)."""
    perm = colamd_ordering(n, edges)
    last_set = set(int(v) for v in last)
    head = [v for v in perm if v not in last_set]
    tail = [v for v in perm if v in last_set]
    return np.asarray(head + tail, dtype=np.int64)


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------


@dataclass
class Bucket:
    """One shape class of cliques within a level."""

    nf: int  # padded frontal var count (blocks)
    ns: int  # padded separator var count (blocks)
    cliques: List[int]  # clique ids
    # flat offsets of each clique's frontal matrix in F_flat
    base: np.ndarray = None  # [B] int64
    vec_base: np.ndarray = None  # [B] offsets in g_flat

    @property
    def m(self):
        return self.nf + self.ns


@dataclass
class Clique:
    cid: int
    frontal: List[int]  # ordered var ids (permuted space), real only
    separator: List[int]  # sorted var ids (permuted space), real only
    parent: int = -1
    level: int = 0
    bucket: Tuple[int, int] = None  # (nf_pad, ns_pad)


@dataclass
class EliminationPlan:
    n: int  # number of variables
    d: int  # block dim
    perm: np.ndarray  # position -> var id (original row space)
    iperm: np.ndarray  # var id -> position
    cliques: List[Clique] = field(default_factory=list)
    levels: List[List[Bucket]] = field(default_factory=list)  # ascending
    F_size: int = 0  # total flat frontal entries (+1 trash)
    g_size: int = 0  # total flat rhs entries (+1 trash)
    var_clique: np.ndarray = None  # var (permuted) -> clique id
    var_pos: np.ndarray = None  # var (permuted) -> position in owning frontal
    # extend-add maps computed lazily by the numeric layer
    clique_of: Dict[int, Clique] = field(default_factory=dict)

    def frontal_base(self, cid: int) -> int:
        return self._base[cid]

    def stats(self) -> Dict:
        nf = [len(c.frontal) for c in self.cliques]
        ns = [len(c.separator) for c in self.cliques]
        return dict(
            n_cliques=len(self.cliques),
            n_levels=len(self.levels),
            max_front=max(nf) if nf else 0,
            max_sep=max(ns) if ns else 0,
            F_entries=self.F_size,
        )


_PAD_SIZES = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]


def _pad_to_class(x: int) -> int:
    for p in _PAD_SIZES:
        if x <= p:
            return p
    return ((x + 127) // 128) * 128


# ---------------------------------------------------------------------------
# symbolic elimination
# ---------------------------------------------------------------------------


def symbolic_eliminate(
    n: int,
    factor_vars: List[np.ndarray],
    d: int,
    ordering: Optional[np.ndarray] = None,
    merge_threshold: float = 0.25,
    max_supernode: int = 32,
    max_buckets_per_level: int = 2,
    no_merge_across: Optional[set] = None,
    pad_fn=None,
) -> EliminationPlan:
    """Build the elimination plan.

    factor_vars: list of [N, K] int arrays of variable ids per factor batch.
    no_merge_across: optional set of variable ids (original space) forming a
    group boundary — supernode merging never joins a var inside the set with
    one outside (used to keep marginalization candidates in pure cliques).
    pad_fn: clique shape-class padding (defaults to the fine-grained batch
    classes; the incremental engine passes power-of-two padding to bound
    the number of distinct jit signatures).
    """
    if pad_fn is None:
        pad_fn = _pad_to_class
    # --- edges & ordering ---
    edge_list = []
    for fv in factor_vars:
        K = fv.shape[1]
        for a in range(K):
            for b in range(a + 1, K):
                edge_list.append(np.stack([fv[:, a], fv[:, b]], axis=1))
    edges = (
        np.concatenate(edge_list, axis=0) if edge_list else np.zeros((0, 2), np.int64)
    )
    if ordering is None:
        ordering = best_ordering(n, edges)
    perm = np.asarray(ordering, dtype=np.int64)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)

    # --- adjacency in permuted space (higher neighbors only) ---
    adj_high: List[set] = [set() for _ in range(n)]
    for (a, b) in edges:
        pa, pb = int(iperm[a]), int(iperm[b])
        if pa == pb:
            continue
        lo, hi = (pa, pb) if pa < pb else (pb, pa)
        adj_high[lo].add(hi)

    # --- exact symbolic elimination via etree child-structure union
    #     (EliminationTree-inst.h:78 equivalent) ---
    struct: List[List[int]] = [None] * n
    parent = np.full(n, -1, dtype=np.int64)
    pending_children: List[List[int]] = [[] for _ in range(n)]
    for v in range(n):
        s = set(adj_high[v])
        for c in pending_children[v]:
            s.update(struct[c])
        s.discard(v)
        s = {u for u in s if u > v}
        struct[v] = sorted(s)
        if s:
            p = min(s)
            parent[v] = p
            pending_children[p].append(v)

    # --- supernode amalgamation (JunctionTree-inst.h:102-120 analog) ---
    # fundamental: v merges into the supernode of parent(v) when struct(v) =
    # {next} + struct(next); relaxed: allow padding waste below threshold.
    cliques: List[Clique] = []
    var_clique = np.full(n, -1, dtype=np.int64)
    barrier = (
        {int(iperm[v]) for v in no_merge_across} if no_merge_across else None
    )
    cur: Optional[Clique] = None
    for v in range(n):
        merge = False
        if (
            cur is not None
            and parent[v - 1] == v
            and len(cur.frontal) < max_supernode
            and (barrier is None or ((v in barrier) == (v - 1 in barrier)))
        ):
            s_prev = struct[v - 1]
            s_v = struct[v]
            # fundamental supernode test
            if len(s_prev) == len(s_v) + 1 and s_prev[0] == v and s_prev[1:] == s_v:
                merge = True
            else:
                # relaxed: extra fill introduced by merging, as a fraction
                prev_sep = set(s_prev) - {v}
                union = prev_sep | set(s_v)
                extra = (len(union) - len(s_v)) + (len(union) - len(prev_sep))
                denom = max(1, len(union))
                if extra / denom <= merge_threshold:
                    merge = True
        if merge:
            cur.frontal.append(v)
        else:
            cur = Clique(cid=len(cliques), frontal=[v], separator=[])
            cliques.append(cur)
        var_clique[v] = cur.cid

    for c in cliques:
        fset = set(c.frontal)
        sep = set()
        for v in c.frontal:
            sep.update(struct[v])
        c.separator = sorted(sep - fset)

    # --- clique tree: parent = clique owning min(separator) ---
    for c in cliques:
        c.parent = int(var_clique[c.separator[0]]) if c.separator else -1

    # --- levels (height from leaves) ---
    children: List[List[int]] = [[] for _ in cliques]
    for c in cliques:
        if c.parent >= 0:
            children[c.parent].append(c.cid)
    # process in cid order: children always have smaller min-var? Not
    # guaranteed for level calc; do a proper pass.
    level = np.zeros(len(cliques), dtype=np.int64)
    # topological: a clique's children have smaller cid (their min frontal var
    # is eliminated earlier, and parent owns a later var), so ascending cid
    # order is a valid bottom-up traversal.
    for c in cliques:
        for ch in children[c.cid]:
            assert ch < c.cid
    for cid in range(len(cliques)):
        if children[cid]:
            level[cid] = 1 + max(level[ch] for ch in children[cid])
    for c in cliques:
        c.level = int(level[c.cid])

    # --- buckets per level ---
    # Each bucket is one batched device kernel; with fine shape classes a
    # level can explode into 10-20 buckets -> ~1000 tiny sequential kernels
    # per solve (launch-bound on TPU, huge XLA graphs). Merge shape classes
    # within a level down to `max_buckets_per_level`, choosing merges that
    # minimize the extra padded volume (flops are nearly free at these sizes;
    # kernel count is the cost that matters).
    n_levels = int(level.max()) + 1 if len(cliques) else 0
    levels: List[List[Bucket]] = []
    for lv in range(n_levels):
        groups: Dict[Tuple[int, int], List[int]] = {}
        for c in cliques:
            if c.level != lv:
                continue
            key = (pad_fn(len(c.frontal)), pad_fn(len(c.separator)) if c.separator else 0)
            groups.setdefault(key, []).append(c.cid)
        items = sorted(groups.items(), key=lambda kv: kv[0][0] + kv[0][1])
        while len(items) > max_buckets_per_level:
            best_i, best_extra = 0, None
            for i in range(len(items) - 1):
                (nf1, ns1), c1 = items[i]
                (nf2, ns2), c2 = items[i + 1]
                m = max(nf1, nf2) + max(ns1, ns2)
                extra = (len(c1) + len(c2)) * m * m - (
                    len(c1) * (nf1 + ns1) ** 2 + len(c2) * (nf2 + ns2) ** 2
                )
                if best_extra is None or extra < best_extra:
                    best_extra, best_i = extra, i
            (nf1, ns1), c1 = items[best_i]
            (nf2, ns2), c2 = items[best_i + 1]
            items[best_i] = ((max(nf1, nf2), max(ns1, ns2)), c1 + c2)
            del items[best_i + 1]
        for key, cids in items:
            for cid in cids:
                cliques[cid].bucket = key
            # descending child count: the numeric layer's pull-model
            # extend-add gathers then cover only a PREFIX of the bucket's
            # slab per multiplicity layer (a slot's contribution count is
            # bounded by its clique's child count), cutting gather rows
            # ~2x on sphere2500 (see elimination.BucketMaps.ext_pull)
            cids.sort(key=lambda c: -len(children[c]))
        levels.append([Bucket(nf=k[0], ns=k[1], cliques=v) for k, v in items])

    # --- flat offsets ---
    F_off = 0
    g_off = 0
    base = np.zeros(len(cliques), dtype=np.int64)
    vec_base = np.zeros(len(cliques), dtype=np.int64)
    for lv in levels:
        for bk in lv:
            m = bk.m * d
            bk.base = np.zeros(len(bk.cliques), dtype=np.int64)
            bk.vec_base = np.zeros(len(bk.cliques), dtype=np.int64)
            for i, cid in enumerate(bk.cliques):
                bk.base[i] = F_off
                bk.vec_base[i] = g_off
                base[cid] = F_off
                vec_base[cid] = g_off
                F_off += m * m
                g_off += m

    # --- var -> (clique, position) ---
    var_pos = np.full(n, -1, dtype=np.int64)
    for c in cliques:
        for i, v in enumerate(c.frontal):
            var_pos[v] = i

    plan = EliminationPlan(
        n=n,
        d=d,
        perm=perm,
        iperm=iperm,
        cliques=cliques,
        levels=levels,
        F_size=F_off + 1,  # +1 trash entry
        g_size=g_off + 1,
        var_clique=var_clique,
        var_pos=var_pos,
    )
    plan._base = base
    plan._vec_base = vec_base
    plan._children = children
    return plan


def clique_slot(plan: EliminationPlan, c: Clique, v: int) -> int:
    """Position (block index) of permuted var v inside clique c's frontal."""
    try:
        return c.frontal.index(v)
    except ValueError:
        return len(c.frontal) + c.separator.index(v)
