"""The launch plans of the bucket kernels at every bucket shape of the
recorded plans: the multi-CTA K1 and K3 (the partial Cholesky kernels for
dense fronts), K2 (the fused backsolve: a warp per clique, or a cluster of
CTAs per clique) and K4 (the block-pool partial Cholesky, several leaf
cliques a CTA).

K1 (`ops/cholesky_v2.partial_cholesky`) is three CUDA launches a bucket:
the factor of F11 (packed in shared memory where it fits, else in a global
scratch copy), the triangular solve over column slabs of [F12 | g1] (staged
in shared memory where it fits, else in place in W and y), and
the Schur-complement stage over 64 x 64 tiles of U (`ops/schur_update`).
K3 (`ops/cholesky.partial_cholesky`) is its shared-memory factor, then the
same Schur stage. The kernels run only on a card; here the host side is
checked: the slabs and tiles cover every W / y column and every U element
exactly once, K2's warps and cluster ranks every row of r and every clique
once, K4's groups every clique once, the shared memory of each launch fits the card, the factor
and solve branches are chosen by shape and take a front of any size, and the wrappers call the entry points in order
with the plan's grids, counting one wrapper call and its CUDA launches (a
meta tensor stands in for a device tensor, a recorder for the library).

The bucket shapes come from tests/data/bench_bucket_shapes.json, written by
tools/bench_bucket_shapes.py from the sphere and bundle-adjustment bench
plans and from the plans of the same graphs on the runner-up ordering
(nested dissection, degree-ascending), which the planner picks on other
graphs of these kinds; a test re-plans the sphere on both and compares.
"""

import contextlib
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.ops import build, schur_update
from gtsam_petercdev_torch.ops import cholesky as t_ops
from gtsam_petercdev_torch.ops import cholesky_v2 as t_ops_v2
from gtsam_petercdev_torch.utils import convert, synthetic

with open(os.path.join(os.path.dirname(__file__), "data", "bench_bucket_shapes.json")) as _f:
    PLANS = json.load(_f)
ITEMSIZE = {"f64": 8, "f32": 4}
PLAN_NAMES = ("sphere", "ba", "sphere_nd", "ba_degree")


def _shapes(route):
    """Distinct (B, nf, ns, d, dtype) of the buckets routed to `route`."""
    out = []
    for plan in PLAN_NAMES:
        d = PLANS[plan]["d"]
        for B, nf, ns, r64, r32 in PLANS[plan]["buckets"]:
            for r, sfx in ((r64, "f64"), (r32, "f32")):
                if r == route:
                    out.append((B, nf, ns, d, sfx))
    return sorted(set(out))


# K1: the bench plans' buckets, a front whose packed F11 exceeds shared
# memory in float64, and the largest front the planner forms (nf = 32, its
# max_supernode, at d = 16), whose solve stage exceeds it too in float64
K1_SHAPES = _shapes("global") + [(1, 30, 8, 9, "f64"), (1, 30, 8, 9, "f32"),
                                 (1, 32, 8, 16, "f64"), (1, 32, 8, 16, "f32")]
K3_SHAPES = _shapes("smem")


def _u_coverage(sd):
    """How often the Schur stage's tiles write each element of U."""
    count = np.zeros((sd, sd), dtype=np.int64)
    T = schur_update.TILE
    for ti, tj in schur_update.tiles(sd):
        assert ti >= tj
        for a in range(ti * T, min(sd, ti * T + T)):
            for c in range(tj * T, min(sd, tj * T + T)):
                if ti == tj and c > a:
                    continue  # the diagonal tile writes its lower half and the mirror
                count[a, c] += 1
                if a != c:
                    count[c, a] += 1
    return count


def test_bench_shapes_file_matches_the_sphere_plan():
    va, fa = synthetic.sphere_rings(50, 50, seed=0)
    g = convert.graph_from_arrays(fa, device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    structure = t_elim.graph_structure(g, v)
    plan = t_elim.build_plan_for_graph(structure, len(v), 6, max_buckets_per_level=4)
    maps = t_elim.build_numeric_maps(plan, structure)
    got = [[bm.B, bm.nf, bm.ns, t_elim.bucket_route(bm, 6, 8), t_elim.bucket_route(bm, 6, 4)]
           for bm in maps.buckets]
    assert got == PLANS["sphere"]["buckets"]
    edges = np.concatenate([np.stack(s.gids, axis=1) for s in structure if len(s.gids) == 2])
    nd = t_elim.build_plan_for_graph(structure, len(v), 6, max_buckets_per_level=4,
                                     ordering=t_sym.nested_dissection_ordering(len(v), edges))
    assert [[bm.B, bm.nf, bm.ns, t_elim.bucket_route(bm, 6, 8), t_elim.bucket_route(bm, 6, 4)]
            for bm in t_elim.build_numeric_maps(nd, structure).buckets] == \
        PLANS["sphere_nd"]["buckets"]
    # the plans on the port's AMD ordering: 10 sphere K1 buckets (12 cliques)
    # in float64, 6 in float32; the BA plan is its 50,000-point leaf (K4),
    # 31 chained 32-camera fronts (K1) and the 8-camera root (K3)
    k1 = [b for b in got if b[3] == "global"]
    assert len(k1) == 10 and sum(b[0] for b in k1) == 12
    assert sum(b[4] == "global" for b in got) == 6
    ba = PLANS["ba"]["buckets"]
    assert [b[:3] for b in ba if b[3] == "global"] == [[1, 32, 6]] * 31
    assert [b[:3] for b in ba if b[3] != "global"] == [[50000, 1, 4], [1, 8, 0]]


@pytest.mark.parametrize("B,nf,ns,d,sfx", K1_SHAPES)
def test_k1_plan_covers_every_output_once(B, nf, ns, d, sfx):
    fd, sd = nf * d, ns * d
    plan = t_ops_v2.k1_plan(B, nf, ns, d, ITEMSIZE[sfx])
    # stage (b): column slabs of [F12 | g1], each column in exactly one slab
    assert plan.solve_grid == (B, -(-(sd + 1) // t_ops_v2.SLAB))
    cols = np.zeros(sd + 1, dtype=np.int64)
    for s in range(plan.solve_grid[1]):
        lanes = np.arange(s * t_ops_v2.SLAB, (s + 1) * t_ops_v2.SLAB)
        cols[lanes[lanes <= sd]] += 1
    assert (cols == 1).all()
    # stage (c): the lower-triangle tiles, mirrored, write every U element once
    assert plan.schur_grid == (B, schur_update.n_tiles(sd)) == (B, len(schur_update.tiles(sd)))
    if sd:
        assert (_u_coverage(sd) == 1).all()
    assert plan.cuda_launches == (3 if sd else 2)
    # shared memory of stages (a) and (b) fits the card
    assert plan.factor_grid == B and plan.factor_threads % 32 == 0
    assert plan.factor_smem <= t_ops_v2.SMEM_LIMIT and plan.solve_smem <= t_ops_v2.SMEM_LIMIT
    staged = ((fd + d) * t_ops_v2.SLAB + 2 * fd * d + 2 * d * d) * ITEMSIZE[sfx]
    assert plan.solve_staged == (staged <= t_ops_v2.SMEM_LIMIT)
    assert plan.solve_smem == (staged if plan.solve_staged else d * t_ops_v2.SLAB * ITEMSIZE[sfx])


@pytest.mark.parametrize("nf,d,itemsize,packed,staged", [
    (32, 6, 8, True, True),     # the sphere root
    (24, 9, 8, True, True),     # the BA root
    (32, 14, 8, False, True),   # fd = 448: the slab still fits
    (32, 15, 8, False, False),  # fd = 480: 245,520 bytes would not
    (32, 16, 8, False, False),  # the largest front the planner forms
    (32, 16, 4, False, True),
    (63, 9, 8, False, True),    # fd = 567 fits, 576 does not
    (64, 9, 8, False, False),
    (70, 9, 8, False, False),
    (400, 16, 4, False, False),  # fd = 6400
])
def test_k1_plan_takes_any_front(nf, d, itemsize, packed, staged):
    """Every front has a plan: past shared memory, stage (a) works on a
    global scratch copy and stage (b) in place in W and y, and no launch asks
    for more shared memory than a CTA has."""
    fd = nf * d
    plan = t_ops_v2.k1_plan(1, nf, 8, d, itemsize)
    assert (plan.packed, plan.solve_staged) == (packed, staged)
    assert max(plan.factor_smem, plan.solve_smem) <= t_ops_v2.SMEM_LIMIT
    assert plan.solve_staged == (t_ops_v2.solve_smem_bytes(fd, d, itemsize) <= t_ops_v2.SMEM_LIMIT)


@pytest.mark.parametrize("nf,ns,d,itemsize,packed,smem", [
    (32, 96, 6, 8, True, 148_816),   # the sphere root: 149 KB of packed F11
    (24, 0, 9, 8, True, 188_800),    # the BA root: 189 KB
    (12, 24, 9, 8, True, 48_400),
    (30, 8, 9, 8, False, 2 * 8 * 81 + 16),  # 293 KB would not fit: global scratch
    (30, 8, 9, 4, True, 147_004),
    (40, 0, 6, 8, True, 231_952),  # fd = 240 fits, 246 does not
    (41, 0, 6, 8, False, 2 * 8 * 36 + 16),
    (41, 0, 6, 4, True, 121_828),
])
def test_k1_factor_branch_by_shape(nf, ns, d, itemsize, packed, smem):
    plan = t_ops_v2.k1_plan(1, nf, ns, d, itemsize)
    assert plan.packed == packed and plan.factor_smem == smem
    fd = nf * d
    assert t_ops_v2.packed_smem_bytes(fd, d, itemsize) == (fd * (fd + 1) // 2 + 2 * d * d) * itemsize + 16
    assert (t_ops_v2.packed_smem_bytes(fd, d, itemsize) <= t_ops_v2.SMEM_LIMIT) == packed


def test_k1_packed_branch_holds_every_bench_front():
    """Every K1 front of the recorded plans keeps F11 in shared memory but
    the BA bench plan's 32-camera fronts in float64 (fd = 288: a packed F11 of
    333 KB), which take the global branch."""
    unpacked = [s for s in _shapes("global")
                if not t_ops_v2.k1_plan(*s[:4], ITEMSIZE[s[4]]).packed]
    assert unpacked == [(1, 32, 6, 9, "f64")]


@pytest.mark.parametrize("B,nf,ns,d,sfx", K3_SHAPES)
def test_k3_plan_covers_every_output_once(B, nf, ns, d, sfx):
    """K3's buckets fit its one-CTA factor (the routing is unchanged) and the
    Schur stage's tiles write every U element once."""
    assert t_ops.fits_smem(nf, ns, d, ITEMSIZE[sfx])
    assert t_ops.smem_bytes(nf, ns, d, ITEMSIZE[sfx]) <= t_ops.SMEM_LIMIT
    sd = ns * d
    nt = -(-sd // schur_update.TILE)
    assert len(schur_update.tiles(sd)) == schur_update.n_tiles(sd) == nt * (nt + 1) // 2
    if sd:
        assert (_u_coverage(sd) == 1).all()


# --- the wrappers' contract, with a recorder in place of the library -----------


class _Recorder:
    """Stands in for a kernel library: every entry point returns 0 and
    records its name and arguments."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "load", lambda name: _Recorder(calls))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    accept = lambda name, *ts: {torch.float64: "f64", torch.float32: "f32"}[ts[0].dtype]
    monkeypatch.setattr(t_ops_v2, "_check_cuda", accept)
    monkeypatch.setattr(t_ops, "_check_cuda", accept)
    t_ops.reset_launch_counts()
    yield calls
    t_ops.reset_launch_counts()


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B,nf,ns,d,sfx", [(1, 32, 96, 6, "f64"), (2, 12, 96, 6, "f64"),
                                           (1, 24, 0, 9, "f64"), (1, 30, 8, 9, "f64"),
                                           (1, 32, 8, 16, "f64"), (1, 32, 24, 6, "f32")])
def test_k1_wrapper_launches_the_three_stages(recorded, B, nf, ns, d, sfx):
    dtype = torch.float64 if sfx == "f64" else torch.float32
    m = (nf + ns) * d
    out = t_ops_v2.partial_cholesky(_meta(B, m, m, dtype=dtype), _meta(B, m, dtype=dtype), nf, d)
    plan = t_ops_v2.k1_plan(B, nf, ns, d, ITEMSIZE[sfx])
    names = [c[0] for c in recorded]
    assert names == [f"gtsam_k1_factor_{sfx}", f"gtsam_k1_solve_{sfx}"] + (
        [f"gtsam_schur_update_{sfx}"] if ns else [])
    factor, solve = recorded[0][1], recorded[1][1]
    assert factor[5:9] == (B, nf, m, d)
    assert factor[10:13] == (int(plan.packed), plan.factor_threads, plan.factor_smem)
    assert solve[6:13] == (B, nf, m, d, plan.solve_grid[1], int(plan.solve_staged),
                           plan.solve_smem)
    if ns:
        assert recorded[2][1][6:10] == (B, nf * d, ns * d, plan.schur_grid[1])
    assert t_ops.launch_counts()["partial_cholesky"] == 1
    assert t_ops.cuda_launch_counts()["partial_cholesky"] == plan.cuda_launches
    assert out["U"].shape == (B, ns * d, ns * d) and out["W"].shape == (B, nf * d, ns * d)


@pytest.mark.parametrize("B,nf,ns,d", [(105, 1, 6, 9), (1, 2, 24, 9), (1, 24, 0, 6)])
def test_k3_wrapper_launches_factor_then_schur(recorded, B, nf, ns, d):
    m = (nf + ns) * d
    t_ops.partial_cholesky(_meta(B, m, m), _meta(B, m), nf, d)
    t_ops.partial_cholesky(_meta(B, m, m), _meta(B, m), nf, d)
    names = [c[0] for c in recorded]
    one = ["gtsam_partial_cholesky_smem_f64"] + (["gtsam_schur_update_f64"] if ns else [])
    assert names == one * 2
    if ns:
        assert recorded[1][1][6:10] == (B, nf * d, ns * d, schur_update.n_tiles(ns * d))
    assert t_ops.launch_counts()["partial_cholesky_smem"] == 2
    assert t_ops.cuda_launch_counts()["partial_cholesky_smem"] == 2 * len(one)


def test_k4_wrapper_keeps_one_launch(recorded):
    B, nf, ns, d = 4, 1, 4, 9
    mb = nf + ns
    out = t_ops.partial_cholesky_blocks(_meta(B * mb * mb, d, d), _meta(B, mb, d), nf, ns, d)
    assert [c[0] for c in recorded] == ["gtsam_partial_cholesky_blocks_f64"]
    assert t_ops.launch_counts()["partial_cholesky_blocks"] == 1
    assert t_ops.cuda_launch_counts()["partial_cholesky_blocks"] == 1
    assert out["U_blocks"].shape == (B, ns * ns, d, d)


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_meta_tensor_raises_without_launching(which):
    """Without the stand-ins, a tensor that is not on the CPU goes to the
    kernel path, which raises for a meta tensor: no fallback, no launch."""
    t_ops.reset_launch_counts()
    B, nf, ns, d = 1, 2, 24, 9
    m = (nf + ns) * d
    fn = t_ops_v2.partial_cholesky if which == "K1" else t_ops.partial_cholesky
    with pytest.raises(ValueError, match="CUDA"):
        fn(_meta(B, m, m), _meta(B, m), nf, d)
    assert set(t_ops.launch_counts().values()) == {0}
    assert set(t_ops.cuda_launch_counts().values()) == {0}


def test_schur_stage_is_registered():
    """The Schur stage is its own library, built like the others, and the
    tile constants match its source."""
    assert build.SOURCES["schur_update"] == "schur_update.cu"
    assert "factor_common.cuh" in build.HEADERS
    with open(os.path.join(build.CSRC, "schur_update.cu")) as f:
        src = f.read()
    assert f"constexpr int kTile = {schur_update.TILE};" in src
    assert f"constexpr int kThreads = {schur_update.THREADS};" in src
    assert "mma.sync.aligned.m8n8k4.row.col.f64" in open(
        os.path.join(build.CSRC, "factor_common.cuh")).read()
    with open(os.path.join(build.CSRC, "partial_cholesky.cu")) as f:
        src = f.read()
    assert f"constexpr int kSlab = {t_ops_v2.SLAB};" in src
    assert f"constexpr int kSolveThreads = {t_ops_v2.SOLVE_THREADS};" in src
    for name in ("partial_cholesky.cu", "partial_cholesky_smem.cu", "schur_update.cu",
                 "backsolve.cu"):
        with open(os.path.join(build.CSRC, name)) as f:
            assert not re.search(r"atomic\w*\(|\batom\.|\bred\.", f.read()), name


# --- K2: the fused backsolve, warp mode and cluster mode -------------------------


def _all_shapes():
    """Distinct (B, nf, ns, d) of every bucket of the recorded plans."""
    return sorted({(B, nf, ns, PLANS[p]["d"]) for p in PLAN_NAMES
                   for B, nf, ns, _, _ in PLANS[p]["buckets"]})


K2_SHAPES = [s + (sfx,) for s in _all_shapes() + [(1, 32, 8, 16)] for sfx in ("f64", "f32")]


def test_k2_mode_threshold_pins_the_bench_buckets():
    """Warp mode takes the fronts of fd <= 32 (1 of the 33 BA buckets, 19 of
    the 48 sphere buckets) except buckets of fewer than 32 cliques whose
    separator is wider than 6 fd: 1 BA bucket (the 50,000-clique leaf) and
    13 sphere buckets."""
    assert t_ops_v2.K2_WARP_MAX_FD == 32
    assert (t_ops_v2.K2_WARP_MIN_B, t_ops_v2.K2_WARP_SD_PER_FD) == (32, 6)
    for plan, n_small, n_warp in (("sphere", 19, 13), ("ba", 1, 1)):
        d = PLANS[plan]["d"]
        buckets = PLANS[plan]["buckets"]
        assert sum(nf * d <= 32 for _, nf, _, _, _ in buckets) == n_small
        modes = [t_ops_v2.k2_plan(B, nf, ns, d, 8).warp for B, nf, ns, _, _ in buckets]
        assert sum(modes) == n_warp
    leaf = t_ops_v2.k2_plan(50_000, 1, 4, 9, 8)
    assert leaf.warp and leaf.cliques_per_cta == t_ops_v2.K2_WARPS
    assert t_ops_v2.k2_plan(71, 1, 6, 6, 8).cliques_per_cta == 1  # spread over 71 SMs
    assert not t_ops_v2.k2_plan(1, 1, 24, 9, 8).warp  # fd = 9, sd = 216: cluster mode
    root = t_ops_v2.k2_plan(1, 32, 96, 6, 8)
    assert not root.warp and root.cluster == t_ops_v2.K2_CLUSTER_MAX


@pytest.mark.parametrize("B,nf,ns,d,sfx", K2_SHAPES)
def test_k2_plan_covers_every_row_and_clique_once(B, nf, ns, d, sfx):
    fd, sd = nf * d, ns * d
    plan = t_ops_v2.k2_plan(B, nf, ns, d, ITEMSIZE[sfx])
    assert plan.smem <= t_ops_v2.SMEM_LIMIT and plan.threads % 32 == 0
    assert 1 <= plan.cluster <= 8 and plan.grid % plan.cluster == 0
    seen = np.zeros((B, fd), dtype=np.int64)  # (clique, row of r) -> times summed
    if plan.warp:
        assert fd <= t_ops_v2.K2_WARP_MAX_FD and plan.cluster == 1 and plan.threads <= 256
        assert B >= t_ops_v2.K2_WARP_MIN_B or sd <= t_ops_v2.K2_WARP_SD_PER_FD * fd
        w = plan.threads // 32
        assert w == plan.cliques_per_cta
        stage = (fd * (t_ops_v2.K2_CHUNK + 1) + t_ops_v2.K2_CHUNK) * ITEMSIZE[sfx]
        assert 2 <= plan.stages <= 8 and plan.smem == w * plan.stages * stage
        assert plan.stages == 2 or plan.stages <= -(-sd // t_ops_v2.K2_CHUNK)
        for blk in range(plan.grid):
            for warp in range(w):
                b = blk * w + warp
                if b < B:
                    seen[b, :] += 1  # lane f < fd owns row f
    else:
        assert plan.grid == B * plan.cluster
        assert fd > t_ops_v2.K2_WARP_MAX_FD or (B < t_ops_v2.K2_WARP_MIN_B
                                                 and sd > t_ops_v2.K2_WARP_SD_PER_FD * fd)
        assert fd <= plan.threads <= 512 and plan.stages == 0  # rank 0: a thread a row
        assert plan.smem == (plan.rows + 2 * fd) * ITEMSIZE[sfx]
        if plan.cluster > 1:
            assert B <= t_ops_v2.K2_CLUSTER_B
        for blk in range(plan.grid):
            b, rank = divmod(blk, plan.cluster)
            seen[b, rank * plan.rows : min(fd, (rank + 1) * plan.rows)] += 1
    assert (seen == 1).all()


def test_k2_plan_refuses_fronts_past_the_chain():
    with pytest.raises(ValueError, match="fd <= 512"):
        t_ops_v2.k2_plan(1, 33, 0, 16, 8)


@pytest.mark.parametrize("B,nf,ns,d,sfx", [(50_000, 1, 4, 9, "f64"), (1, 32, 96, 6, "f64"),
                                           (3, 16, 24, 6, "f32"), (1, 24, 0, 9, "f64"),
                                           (2, 3, 12, 9, "f32")])
def test_k2_wrapper_launches_once_with_the_plan(recorded, B, nf, ns, d, sfx):
    dtype = torch.float64 if sfx == "f64" else torch.float32
    fd, sd = nf * d, ns * d
    x = t_ops_v2.backsolve_bucket(_meta(B, fd, fd, dtype=dtype), _meta(B, nf, d, d, dtype=dtype),
                                  _meta(B, fd, sd, dtype=dtype), _meta(B, fd, dtype=dtype),
                                  _meta(B, sd, dtype=dtype), nf, d)
    plan = t_ops_v2.k2_plan(B, nf, ns, d, ITEMSIZE[sfx])
    assert [c[0] for c in recorded] == [f"gtsam_backsolve_{sfx}"]
    assert recorded[0][1][6:17] == (B, nf, ns, d, int(plan.warp), plan.grid, plan.threads,
                                    plan.cluster, plan.rows, plan.stages, plan.smem)
    assert t_ops.launch_counts()["backsolve_bucket"] == 1
    assert t_ops.cuda_launch_counts()["backsolve_bucket"] == 1
    assert x.shape == (B, fd)


# --- K4: several leaf cliques a CTA ------------------------------------------------


K4_SHAPES = sorted({(B, nf, ns, d) for B, nf, ns, d, _ in _shapes("blocks")}
                   | {(b, 1, 4, 9) for b in (50_000, 1, 17)}
                   | {(9, 1, 4, 6), (5, 6, 6, 9), (3, 2, 3, 9)})


@pytest.mark.parametrize("sfx", ["f64", "f32"])
@pytest.mark.parametrize("B,nf,ns,d", K4_SHAPES)
def test_k4_plan_covers_every_clique_once(B, nf, ns, d, sfx):
    isz = ITEMSIZE[sfx]
    plan = t_ops.k4_plan(B, nf, ns, d, isz)
    G = plan.cliques_per_cta
    assert t_ops.fits_smem(nf, ns, d, isz) and plan.smem <= t_ops.SMEM_LIMIT
    per = t_ops.smem_bytes(nf, ns, d, isz) - 16
    assert plan.smem == G * per + 16 * -(-G // 4)
    if G > 1:  # a warp a clique, four such CTAs fit an SM
        assert nf * d <= t_ops.K4_WARP_MAX_FD and plan.threads == 32 * G and 4 * plan.smem <= t_ops.SMEM_LIMIT + 64
    else:
        assert plan.threads in (64, 256, 1024)
    seen = np.zeros(B, dtype=np.int64)
    for blk in range(plan.grid):
        b0 = blk * G
        seen[b0 : b0 + min(G, B - b0)] += 1
    assert (seen == 1).all()
    assert plan.grid == -(-B // G)


def test_k4_plan_groups_the_leaves():
    """The BA leaf and the sphere's large leaf take eight cliques a CTA; a
    leaf clique too large to share a CTA takes one."""
    for isz in (8, 4):
        assert t_ops.k4_plan(50_000, 1, 4, 9, isz).cliques_per_cta == 8
        assert t_ops.k4_plan(395, 1, 4, 6, isz).cliques_per_cta == 8
        assert t_ops.k4_plan(17, 1, 4, 9, isz).grid == 3  # a ragged last group of one
        assert t_ops.k4_plan(5, 6, 6, 9, isz).cliques_per_cta == 1


@pytest.mark.parametrize("B,nf,ns,d", [(50_000, 1, 4, 9), (17, 1, 3, 6), (2, 6, 6, 9)])
def test_k4_wrapper_launches_once_with_the_plan(recorded, B, nf, ns, d):
    mb = nf + ns
    out = t_ops.partial_cholesky_blocks(_meta(B * mb * mb, d, d), _meta(B, mb, d), nf, ns, d)
    plan = t_ops.k4_plan(B, nf, ns, d, 8)
    assert [c[0] for c in recorded] == ["gtsam_partial_cholesky_blocks_f64"]
    assert recorded[0][1][9:13] == (B, nf, ns, d)
    assert recorded[0][1][14:17] == (plan.cliques_per_cta, plan.threads, plan.smem)
    assert t_ops.launch_counts()["partial_cholesky_blocks"] == 1
    assert t_ops.cuda_launch_counts()["partial_cholesky_blocks"] == 1
    assert out["U_blocks"].shape == (B, ns * ns, d, d) and out["ug_blocks"].shape == (B, ns, d)
