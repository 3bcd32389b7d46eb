"""Bucket partial Cholesky (K1) and fused backsolve (K2): CUDA wrappers.

Port of gtsam_petercdev_tpu/ops/cholesky_v2.py (`partial_cholesky`,
`backsolve_bucket`). The kernels are hand-written CUDA C++ for sm_90a in
`csrc/partial_cholesky.cu` with `csrc/schur_update.cu`, and
`csrc/backsolve.cu` (the source notes say what bounds them).

K2 is one launch per bucket in the mode `k2_plan` gives its shape: a warp
per clique, several cliques a CTA, for fronts of fd <= 32 (unless a bucket
of few cliques has a wide separator); else a thread-block cluster of c
CTAs per clique (c = 1 a plain CTA) whose ranks split W's rows, rank 0
running the right-looking block chain.

K1 is three launches per bucket (`k1_plan` gives their grids): (a) the
factor of F11, one CTA per clique, F11's lower triangle packed in shared
memory where it fits 227 KB, else in a global scratch copy; (b) the
triangular solve for W and y over column slabs of [F12 | g1], staged in
shared memory where it fits, else in place in W and y; (c) U and ug over
64 x 64 tiles (`ops/schur_update.py`). The branches are chosen by shape.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`inference/kernels.py`), a CUDA tensor launches the kernel
or raises. There is no fallback and no switch; on the card every bucket,
the largest front included, goes through the kernel.

Each wrapper counts its calls that launch in `<wrapper>.launches` and the
CUDA launches they make in `<wrapper>.cuda_launches`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.ops import build, schur_update

MAX_D = 16  # block size the kernels' shared-memory tiles hold
# dynamic shared memory a CTA can use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
SLAB = 32  # columns of [F12 | g1] per stage-(b) CTA (partial_cholesky.cu kSlab)
SOLVE_THREADS = 512  # partial_cholesky.cu kSolveThreads
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA tensors")
    dtype = tensors[0].dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return _SUFFIX[dtype]


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def packed_smem_bytes(fd: int, d: int, itemsize: int) -> int:
    """Stage (a)'s dynamic shared memory with F11 packed: the lower
    triangle, two diagonal blocks' inverses, 16 bytes for the pivot count."""
    return (fd * (fd + 1) // 2 + 2 * d * d) * itemsize + 16


def solve_smem_bytes(fd: int, d: int, itemsize: int) -> int:
    """Stage (b)'s dynamic shared memory with the slab staged: y_j [d, SLAB],
    the slab [fd, SLAB], and two buffers of L's block column [fd, d] and its
    block's inverse."""
    return (d * SLAB + fd * SLAB + 2 * fd * d + 2 * d * d) * itemsize


class K1Plan(NamedTuple):
    """The three launches of K1 for one bucket."""
    packed: bool  # stage (a) holds F11 packed in shared memory (else global scratch)
    factor_grid: int  # B
    factor_threads: int
    factor_smem: int
    solve_staged: bool  # stage (b) stages the slab and L in shared memory (else in place)
    solve_grid: tuple  # (B, slabs)
    solve_smem: int
    schur_grid: tuple  # (B, tiles); tiles == 0 when sd == 0 (no launch)

    @property
    def cuda_launches(self) -> int:
        return 2 + (self.schur_grid[1] > 0)


@functools.lru_cache(maxsize=None)
def k1_plan(B: int, nf: int, ns: int, d: int, itemsize: int) -> K1Plan:
    """Grids and shared memory of K1's launches, by shape alone; any front
    size has a plan (the branches that do not fit shared memory work in
    global memory)."""
    fd, sd = nf * d, ns * d
    packed = packed_smem_bytes(fd, d, itemsize) <= SMEM_LIMIT
    staged = solve_smem_bytes(fd, d, itemsize) <= SMEM_LIMIT
    return K1Plan(
        packed=packed, factor_grid=B, factor_threads=512 if fd >= 96 else 256,
        factor_smem=packed_smem_bytes(fd, d, itemsize) if packed else 2 * d * d * itemsize + 16,
        solve_staged=staged, solve_grid=(B, -(-(sd + 1) // SLAB)),
        solve_smem=solve_smem_bytes(fd, d, itemsize) if staged else d * SLAB * itemsize,
        schur_grid=(B, schur_update.n_tiles(sd)))


def partial_cholesky(Fm: torch.Tensor, gm: torch.Tensor, nf: int, d: int, eps=1e-10):
    """Whole-bucket partial Cholesky; same contract as
    kernels.partial_cholesky (dict of L, Linv, W, y, U, ug, bad)."""
    if Fm.device.type == "cpu":
        return kernels.partial_cholesky(Fm, gm, nf, d, eps)
    B, m, _ = Fm.shape
    fd = nf * d
    sd = m - fd
    if not (0 < d <= MAX_D) or nf <= 0 or sd < 0 or sd % d or gm.shape != (B, m):
        raise ValueError(f"partial_cholesky: bad shapes Fm {tuple(Fm.shape)} gm "
                         f"{tuple(gm.shape)} nf={nf} d={d}")
    Fm, gm = Fm.contiguous(), gm.contiguous()
    sfx = _check_cuda("partial_cholesky", Fm, gm)
    plan = k1_plan(B, nf, sd // d, d, Fm.element_size())
    new = lambda *shape: torch.empty(shape, dtype=Fm.dtype, device=Fm.device)
    L, Linv, W, y = new(B, fd, fd), new(B, nf, d, d), new(B, fd, sd), new(B, fd)
    U, ug = new(B, sd, sd), new(B, sd)
    bad = torch.empty((B,), dtype=torch.int32, device=Fm.device)
    if B:
        lib = build.load("partial_cholesky")
        # F11's working copy: in shared memory, else this global scratch
        scratch = None if plan.packed else new(B, fd, fd)
        with torch.cuda.device(Fm.device):
            stream = torch.cuda.current_stream().cuda_stream
            _raise_on(getattr(lib, f"gtsam_k1_factor_{sfx}")(
                _ptr(Fm), None if scratch is None else _ptr(scratch), _ptr(L), _ptr(Linv),
                _ptr(bad), B, nf, m, d, float(eps), int(plan.packed), plan.factor_threads,
                plan.factor_smem, stream), "partial_cholesky (factor)")
            _raise_on(getattr(lib, f"gtsam_k1_solve_{sfx}")(
                _ptr(Fm), _ptr(gm), _ptr(L), _ptr(Linv), _ptr(W), _ptr(y), B, nf, m, d,
                plan.solve_grid[1], int(plan.solve_staged), plan.solve_smem, stream),
                "partial_cholesky (solve)")
            n = 2 + schur_update.launch(Fm, gm, W, y, U, ug, sfx)
        partial_cholesky.launches += 1
        partial_cholesky.cuda_launches += n
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug,
                bad=torch.sum(bad).to(torch.int32))


partial_cholesky.launches = 0
partial_cholesky.cuda_launches = 0


def backsolve_plain(L, Linv, W, y, xs, nf: int, d: int):
    """Plain version of the fused backsolve: L^T x = y - W xs."""
    rhs = y - torch.einsum("bfs,bs->bf", W, xs) if W.shape[2] else y
    return kernels.backsolve_bucket(L, Linv, rhs, nf, d)


K2_CHUNK = 32  # backsolve.cu kChunk: W columns per ring stage (warp mode)
K2_WARP_MAX_FD = 32  # backsolve.cu kWarpMaxFd: warp mode holds a clique's rows in one warp
K2_MAX_FD = 512  # backsolve.cu kMaxFd: cluster mode's rank 0 has a thread per row
K2_WARPS = 8  # at most this many cliques a CTA in warp mode
K2_WARP_SD_PER_FD = 6  # warp mode unless sd > 6 fd in a bucket of < K2_WARP_MIN_B cliques
K2_WARP_MIN_B = 32
K2_SMS = 132  # the H100's SMs: warp mode spreads up to this many CTAs before packing warps
K2_CLUSTER_MAX = 8  # the portable cluster size
K2_CLUSTER_B = 16  # buckets of at most this many cliques may take clusters
K2_CLUSTER_W = 8192  # W elements per CTA that ask for one more CTA in the cluster


class K2Plan(NamedTuple):
    """The one launch of K2 for one bucket."""
    warp: bool  # warp mode (a warp per clique), else cluster mode
    grid: int
    threads: int
    cluster: int  # CTAs per clique in cluster mode (1 in warp mode)
    rows: int  # rows of r each cluster rank sums (fd in warp mode)
    stages: int  # ring depth in W chunks (warp mode; 0 in cluster mode)
    cliques_per_cta: int
    smem: int


@functools.lru_cache(maxsize=None)
def k2_plan(B: int, nf: int, ns: int, d: int, itemsize: int) -> K2Plan:
    """Mode, grid and shared memory of K2 for a bucket, by shape alone.
    Fronts of fd <= 32 take warp mode, unless the bucket has fewer than
    K2_WARP_MIN_B cliques whose separator is wider than K2_WARP_SD_PER_FD x
    fd (one warp would sum the long rows of W alone: cluster mode's warps
    share them). Warp mode puts ceil(B / K2_SMS) cliques in a CTA, at most
    K2_WARPS, each warp a ring of [fd, K2_CHUNK + 1] W and K2_CHUNK xs
    stages: as many as the chunks of W, at most 8, within half the card's
    shared memory a CTA, at least 2. The rest take cluster mode: c CTAs per
    clique, c > 1 only where the bucket has at most K2_CLUSTER_B cliques,
    one per K2_CLUSTER_W elements of W, at most K2_CLUSTER_MAX; each rank
    sums ceil(fd / c) rows of r."""
    fd, sd = nf * d, ns * d
    if not (0 < d <= MAX_D) or nf <= 0 or ns < 0 or fd > K2_MAX_FD:
        raise ValueError(f"k2_plan: no plan for nf={nf} ns={ns} d={d} (fd <= {K2_MAX_FD})")
    if fd <= K2_WARP_MAX_FD and (B >= K2_WARP_MIN_B or sd <= K2_WARP_SD_PER_FD * fd):
        return k2_warp_plan(B, nf, ns, d, itemsize)
    c = 1
    if B <= K2_CLUSTER_B:
        c = max(1, min(K2_CLUSTER_MAX, -(-fd * sd // K2_CLUSTER_W)))
    return k2_cluster_plan(B, nf, ns, d, itemsize, c)


def k2_warp_plan(B: int, nf: int, ns: int, d: int, itemsize: int) -> K2Plan:
    """K2 in warp mode (fd <= K2_WARP_MAX_FD), as `k2_plan` sizes it."""
    fd, sd = nf * d, ns * d
    w = max(1, min(K2_WARPS, -(-B // K2_SMS)))
    stage = (fd * (K2_CHUNK + 1) + K2_CHUNK) * itemsize
    stages = max(2, min(8, -(-sd // K2_CHUNK), SMEM_LIMIT // 2 // (w * stage)))
    return K2Plan(warp=True, grid=-(-B // w), threads=32 * w, cluster=1, rows=fd,
                  stages=stages, cliques_per_cta=w, smem=w * stages * stage)


def k2_cluster_plan(B: int, nf: int, ns: int, d: int, itemsize: int, c: int) -> K2Plan:
    """K2 in cluster mode with c CTAs a clique, as `k2_plan` sizes it."""
    fd = nf * d
    rows = -(-fd // c)
    return K2Plan(warp=False, grid=B * c, threads=512 if fd > 256 else 256, cluster=c,
                  rows=rows, stages=0, cliques_per_cta=1, smem=(rows + 2 * fd) * itemsize)


def backsolve_bucket(L, Linv, W, y, xs, nf: int, d: int):
    """Fused top-down back-substitution for one bucket: solves
    L^T x = y - W @ xs. W / xs may be zero-width (root buckets). One CUDA
    launch, in the mode `k2_plan` gives the shape."""
    if L.device.type == "cpu":
        return backsolve_plain(L, Linv, W, y, xs, nf, d)
    B, fd, _ = L.shape
    sd = W.shape[2]
    if not (0 < d <= MAX_D) or fd != nf * d or sd % d or xs.shape != (B, sd) \
            or y.shape != (B, fd) or Linv.shape != (B, nf, d, d):
        raise ValueError("backsolve_bucket: bad shapes")
    L, Linv, W, y, xs = (t.contiguous() for t in (L, Linv, W, y, xs))
    sfx = _check_cuda("backsolve_bucket", L, Linv, W, y, xs)
    plan = k2_plan(B, nf, sd // d, d, L.element_size())
    x = torch.empty((B, fd), dtype=L.dtype, device=L.device)
    if B:
        fn = getattr(build.load("backsolve"), f"gtsam_backsolve_{sfx}")
        with torch.cuda.device(L.device):
            err = fn(
                _ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(xs), _ptr(x),
                B, nf, sd // d, d, int(plan.warp), plan.grid, plan.threads, plan.cluster,
                plan.rows, plan.stages, plan.smem, torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(err, "backsolve_bucket")
        backsolve_bucket.launches += 1
        backsolve_bucket.cuda_launches += 1
    return x


backsolve_bucket.launches = 0
backsolve_bucket.cuda_launches = 0


def reset_launch_counts() -> None:
    """Set the launch counts (wrapper calls and CUDA launches) of all four
    bucket kernels to 0 (K1 and K2 here, K3 and K4 in ops/cholesky.py)."""
    from gtsam_petercdev_torch.ops import cholesky

    for fn in (partial_cholesky, backsolve_bucket, cholesky.partial_cholesky,
               cholesky.partial_cholesky_blocks):
        fn.launches = fn.cuda_launches = 0
