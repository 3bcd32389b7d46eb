"""Disjoint-set forest (union-find).

Host-side bookkeeping structure used for feature-track formation and
spanning-tree construction — the analog of the reference's `DSFMap`
(gtsam/base/DSFMap.h:34) and `DSFVector` (gtsam/base/DSFVector.h). Pure
NumPy with path halving + union by rank; vectorized `find_all` for bulk
queries (the hot use in track generation merges millions of matches).

A copy of gtsam_petercdev_tpu/utils/dsf.py (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Set

import numpy as np


class DSFVector:
    """Union-find over dense integer ids [0, n)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        # path compression
        while p[i] != root:
            p[i], i = root, p[i]
        return int(root)

    def union(self, i: int, j: int) -> bool:
        """Merge the sets of i and j; returns False if already joined."""
        ri, rj = self.find(i), self.find(j)
        if ri == rj:
            return False
        if self.rank[ri] < self.rank[rj]:
            ri, rj = rj, ri
        self.parent[rj] = ri
        if self.rank[ri] == self.rank[rj]:
            self.rank[ri] += 1
        return True

    def merge_pairs(self, ii: np.ndarray, jj: np.ndarray) -> None:
        for i, j in zip(np.asarray(ii).ravel(), np.asarray(jj).ravel()):
            self.union(int(i), int(j))

    def find_all(self) -> np.ndarray:
        """Root of every element, fully path-compressed ([n] int64)."""
        p = self.parent
        while True:
            gp = p[p]
            if np.array_equal(gp, p):
                break
            p = gp
        self.parent = p.copy()
        return p

    def sets(self) -> Dict[int, np.ndarray]:
        """root -> member ids (analog of DSFVector::arrays)."""
        roots = self.find_all()
        order = np.argsort(roots, kind="stable")
        sorted_roots = roots[order]
        bounds = np.flatnonzero(np.diff(sorted_roots)) + 1
        groups = np.split(order, bounds)
        return {int(sorted_roots[g[0]]): g for g in groups}


class DSFMap:
    """Union-find over arbitrary hashable keys (gtsam/base/DSFMap.h:34)."""

    def __init__(self):
        self._id: Dict[Hashable, int] = {}
        self._keys: List[Hashable] = []
        self._dsf = DSFVector(0)
        self._parent: List[int] = []
        self._rank: List[int] = []

    def _intern(self, k: Hashable) -> int:
        i = self._id.get(k)
        if i is None:
            i = len(self._keys)
            self._id[k] = i
            self._keys.append(k)
            self._parent.append(i)
            self._rank.append(0)
        return i

    def _find(self, i: int) -> int:
        p = self._parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def find(self, k: Hashable) -> Hashable:
        return self._keys[self._find(self._intern(k))]

    def merge(self, a: Hashable, b: Hashable) -> None:
        ra, rb = self._find(self._intern(a)), self._find(self._intern(b))
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1

    def sets(self) -> Dict[Hashable, Set[Hashable]]:
        out: Dict[Hashable, Set[Hashable]] = {}
        for i, k in enumerate(self._keys):
            out.setdefault(self._keys[self._find(i)], set()).add(k)
        return out
