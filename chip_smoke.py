#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_petercdev_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 everything below
    python3 chip_smoke.py --kernels-only  phases 1-3 at a few shapes, no result
                                          line (a quick check after a kernel edit)

Phases, in order; any failure raises and the script exits non-zero without
a result line:
  1. card    name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build   nvcc builds every kernel of the paths from gtsam_petercdev_torch/csrc
  3. kernels each of the four CUDA kernels against its plain PyTorch version
             on the card, in float64 and float32: K1 (bucket partial Cholesky,
             working copy in global memory) and K2 (fused backsolve) at every
             bucket shape of the sphere and bundle-adjustment plans, K3
             (per-clique partial Cholesky in shared memory) and K4 (its
             block-pool variant) at every such shape that fits shared memory,
             plus an indefinite case (equal bad-pivot counts); kernel and
             plain times per sweep of the buckets the routing gives each kernel
  4. sphere  the synthetic 2,500-pose / 4,949-factor Pose3 sphere through the
             port's entry points: gauss_newton (f64, solver="multifrontal")
             and levenberg_marquardt, launch counters reset just before and
             read just after; the first GN step against the dense Cholesky
             oracle; a small graph against the CPU path; ms per chained GN
             iteration in float32 and float64
  5. BA      synthetic bundle adjustment, 1000 cameras / 50,000 points / 4
             observations each, through levenberg_marquardt with
             solver="multifrontal" and solver="schur", float32 and float64,
             counters reset just before and read just after; the first damped
             multifrontal step against the Schur solver's; a small rig against
             the CPU path; LM iterations per second by bench.py's protocol
  6. result  a `kernels` JSON line, the card line, then the last line
             {"ok": true, "device": {...}}

Needs one CUDA device and the CUDA toolkit (nvcc); it fails without either,
and in a directory that holds no gtsam_petercdev_torch package.
"""

import json
import os
import subprocess
import sys
import time

SEED = 0
N_RINGS = N_PER_RING = 50  # 2,500 poses, 4,949 between factors
GN_ITERS = 3
LM_ITERS = 3
BA_SHAPE = (1000, 50_000, 4)  # cameras, points, observations per point
BA_LM_ITERS = {"float32": 3, "float64": 2}
# kernel vs plain version on random SPD buckets (entries O(1), well
# conditioned): float64 agrees to rounding; float32 sums over up to
# fd = 216 terms per entry
TOL = {"float64": 1e-9, "float32": 2e-3}
# least-time bounds: H100 SXM, 3.35 TB/s HBM3; 67 TFLOP/s float32 (vector)
# and 67 TFLOP/s float64 (tensor core), NVIDIA's data sheet
MEM_BPS = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
# shapes of the JAX package's Pallas kernel tests, (B, nf, ns, d)
PALLAS_TEST_SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3)]
FACTOR_KEYS = ("L", "Linv", "W", "y", "U", "ug")

KERNELS = {
    # name: (source, TPU kernel it replaces, CUDA kernel name in the profile)
    "partial_cholesky": ("gtsam_petercdev_torch/csrc/partial_cholesky.cu",
                         "gtsam_petercdev_tpu/ops/cholesky_v2.py:256", "partial_cholesky_kernel"),
    "backsolve_bucket": ("gtsam_petercdev_torch/csrc/backsolve.cu",
                         "gtsam_petercdev_tpu/ops/cholesky_v2.py:347", "backsolve_kernel"),
    "partial_cholesky_smem": ("gtsam_petercdev_torch/csrc/partial_cholesky_smem.cu",
                              "gtsam_petercdev_tpu/ops/cholesky.py:197",
                              "partial_cholesky_smem_kernel"),
    "partial_cholesky_blocks": ("gtsam_petercdev_torch/csrc/partial_cholesky_smem.cu",
                                "gtsam_petercdev_tpu/ops/cholesky.py:369",
                                "partial_cholesky_smem_kernel"),
}
ROUTE_KERNEL = {"global": "partial_cholesky", "smem": "partial_cholesky_smem",
                "blocks": "partial_cholesky_blocks"}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --- phase 3: kernels against their plain versions -----------------------------


def spd_bucket(torch, gen, B, m, dtype):
    A = torch.randn(B, m, m, generator=gen, dtype=torch.float64, device="cuda")
    F = A @ A.transpose(1, 2) / m + torch.eye(m, dtype=torch.float64, device="cuda")
    g = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    return F.to(dtype).contiguous(), g.to(dtype).contiguous()


def factor_cost(B, nf, ns, d, itemsize):
    """Bytes and flops of one partial Cholesky of a bucket (K1, K3 and K4
    alike: K4 reads the pool slice, which is F's m * m elements per clique,
    and writes U / ug in block layout, the same number of elements)."""
    fd, sd = nf * d, ns * d
    m = fd + sd
    nbytes = itemsize * B * (m * m + m + fd * fd + nf * d * d + fd * sd + fd + sd * sd + sd) + 4 * B
    flops = B * (fd**3 / 3.0 + fd * fd * sd + fd * sd * sd)  # plan_flop_stats' count
    return nbytes, flops


def backsolve_cost(B, nf, ns, d, itemsize):
    fd, sd = nf * d, ns * d
    lower = fd * (fd - d) // 2  # the part of L below the diagonal blocks
    nbytes = itemsize * B * (lower + nf * d * d + fd * sd + fd + sd + fd)
    flops = B * (2.0 * fd * sd + 2.0 * lower + 2.0 * fd * d)
    return nbytes, flops


def bound(costs, dtype_name):
    """Sum over launches of max(bytes / rate, flops / peak), in ms, and
    which of the two dominates the sum."""
    t_b = sum(b / MEM_BPS for b, _ in costs)
    t_f = sum(f / PEAK_FLOPS[dtype_name] for _, f in costs)
    total = sum(max(b / MEM_BPS, f / PEAK_FLOPS[dtype_name]) for b, f in costs)
    return total * 1e3, "bytes" if t_b >= t_f else "operations"


def event_ms(torch, sweep, reps):
    sweep()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        sweep()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_kernel_ms(torch, sweep, kernel_name):
    """Device time of the named kernel in one sweep from torch.profiler,
    None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
    return total / 1e3 if total > 0 else None


def max_err(got, ref, keys, tol, what):
    """Largest abs difference over `keys`; raises beyond tol * max(1, |ref|)."""
    worst = 0.0
    for k in keys:
        if ref[k].numel():
            e = (got[k] - ref[k]).abs().max().item()
            if not e <= tol * max(1.0, ref[k].abs().max().item()):
                raise AssertionError(f"{what} {k}: err {e:.3e}")
            worst = max(worst, e)
    if int(got["bad"]) != int(ref["bad"]):
        raise AssertionError(f"{what}: bad pivots {int(got['bad'])} != {int(ref['bad'])}")
    return worst


def check_kernels(torch, mods, cases, timed):
    """Hold the four kernels against their plain versions at every case
    (B, nf, ns, d) and time them. timed: dtype name -> kernel name -> the
    cases of one sweep (the buckets the routing gives that kernel in the two
    bench plans, each once, in plan order)."""
    v2, v1, kernels = mods
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {k: {} for k in KERNELS}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        itemsize = torch.finfo(dtype).bits // 8
        errs = dict.fromkeys(KERNELS, 0.0)
        n_smem = 0
        for B, nf, ns, d in cases:
            what = f"{name} B={B} nf={nf} ns={ns} d={d}"
            mb = nf + ns
            F, g = spd_bucket(torch, gen, B, mb * d, dtype)
            ref = kernels.partial_cholesky(F, g, nf, d)
            errs["partial_cholesky"] = max(errs["partial_cholesky"], max_err(
                v2.partial_cholesky(F, g, nf, d), ref, FACTOR_KEYS, TOL[name], "K1 " + what))
            xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            args2 = (ref["L"], ref["Linv"], ref["W"].contiguous(), ref["y"].contiguous(), xs, nf, d)
            x_k, x_p = v2.backsolve_bucket(*args2), v2.backsolve_plain(*args2)
            e = (x_k - x_p).abs().max().item()
            if not e <= TOL[name] * max(1.0, x_p.abs().max().item()):
                raise AssertionError(f"K2 {what}: err {e:.3e}")
            errs["backsolve_bucket"] = max(errs["backsolve_bucket"], e)
            if not v1.fits_smem(nf, ns, d, itemsize):
                continue
            n_smem += 1
            errs["partial_cholesky_smem"] = max(errs["partial_cholesky_smem"], max_err(
                v1.partial_cholesky(F, g, nf, d), ref, FACTOR_KEYS, TOL[name], "K3 " + what))
            Fb = v1.blocks_from_dense(F, mb, d).contiguous().view(-1, d, d)
            gb = g.view(B, mb, d)
            errs["partial_cholesky_blocks"] = max(errs["partial_cholesky_blocks"], max_err(
                v1.partial_cholesky_blocks(Fb, gb, nf, ns, d),
                v1.partial_cholesky_blocks_plain(Fb, gb, nf, ns, d),
                ("L", "Linv", "W", "y", "U_blocks", "ug_blocks"), TOL[name], "K4 " + what))
        torch.cuda.synchronize()

        # indefinite bucket: clamped pivots counted identically by all three
        B, nf, ns, d = cases[0]
        F, g = spd_bucket(torch, gen, B, (nf + ns) * d, dtype)
        F[0, 0, 0] = -5.0
        Fb = v1.blocks_from_dense(F, nf + ns, d).contiguous().view(-1, d, d)
        bad = [int(kernels.partial_cholesky(F, g, nf, d)["bad"]),
               int(v2.partial_cholesky(F, g, nf, d)["bad"]),
               int(v1.partial_cholesky(F, g, nf, d)["bad"]),
               int(v1.partial_cholesky_blocks(Fb, g.view(B, nf + ns, d), nf, ns, d)["bad"])]
        if not (bad[0] >= 1 and len(set(bad)) == 1):
            raise AssertionError(f"indefinite case: bad (plain, K1, K3, K4) = {bad}")

        # times: plain, kernel, kernel, plain within this one call
        for kname in KERNELS:
            sweep_cases = timed[name][kname]
            inputs = []
            for B, nf, ns, d in sweep_cases:
                mb = nf + ns
                F, g = spd_bucket(torch, gen, B, mb * d, dtype)
                if kname == "backsolve_bucket":
                    ref = kernels.partial_cholesky(F, g, nf, d)
                    xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64,
                                     device="cuda").to(dtype)
                    inputs.append((ref["L"], ref["Linv"], ref["W"].contiguous(),
                                   ref["y"].contiguous(), xs, nf, d))
                elif kname == "partial_cholesky_blocks":
                    inputs.append((v1.blocks_from_dense(F, mb, d).contiguous().view(-1, d, d),
                                   g.view(B, mb, d), nf, ns, d))
                else:
                    inputs.append((F, g, nf, d))
            fn, plain, cost = {
                "partial_cholesky": (v2.partial_cholesky, kernels.partial_cholesky, factor_cost),
                "backsolve_bucket": (v2.backsolve_bucket, v2.backsolve_plain, backsolve_cost),
                "partial_cholesky_smem": (v1.partial_cholesky, v1.partial_cholesky_plain,
                                          factor_cost),
                "partial_cholesky_blocks": (v1.partial_cholesky_blocks,
                                            v1.partial_cholesky_blocks_plain, factor_cost),
            }[kname]
            sweep_k = lambda: [fn(*a) for a in inputs]
            sweep_p = lambda: [plain(*a) for a in inputs]
            p1 = event_ms(torch, sweep_p, 2)
            k_1 = event_ms(torch, sweep_k, 10)
            k_2 = event_ms(torch, sweep_k, 10)
            p2 = event_ms(torch, sweep_p, 2)
            b_ms, b_by = bound([cost(B, nf, ns, d, itemsize) for B, nf, ns, d in sweep_cases], name)
            r = dict(max_abs_err=errs[kname], ms=min(k_1, k_2), plain_ms=min(p1, p2),
                     device_ms=profiled_kernel_ms(torch, sweep_k, KERNELS[kname][2]),
                     bound_ms=b_ms, bound_by=b_by, buckets_timed=len(sweep_cases))
            if kname in ("partial_cholesky_smem", "partial_cholesky_blocks"):
                # the same buckets through K1 (for K4: the relayout to
                # [B, m, m] that K4 saves, then K1), as the path ran them before
                if kname == "partial_cholesky_blocks":
                    k1_in = [(a[0], a[1], a[2], a[2] + a[3], a[4]) for a in inputs]
                    sweep_1 = lambda: [v2.partial_cholesky(
                        v1.dense_from_blocks(Fb, gb.shape[0], mb, d), gb.reshape(gb.shape[0], -1),
                        nf, d) for Fb, gb, nf, mb, d in k1_in]
                else:
                    sweep_1 = lambda: [v2.partial_cholesky(*a) for a in inputs]
                r["k1_same_buckets_ms"] = event_ms(torch, sweep_1, 10)
            res[kname][name] = r
            del inputs
        log(f"kernels {name} ({len(cases)} shapes, {n_smem} fit shared memory): " + "; ".join(
            f"{k} err {v[name]['max_abs_err']:.2e} ms {v[name]['ms']:.3f} "
            f"(device {v[name]['device_ms']}) plain {v[name]['plain_ms']:.3f} "
            f"bound {v[name]['bound_ms']:.4f} ({v[name]['bound_by']}) over "
            f"{v[name]['buckets_timed']} buckets"
            + (f" K1 on the same buckets {v[name]['k1_same_buckets_ms']:.3f}"
               if "k1_same_buckets_ms" in v[name] else "")
            for k, v in res.items()))
    return res


# --- phases 4 and 5: the paths ----------------------------------------------------


def chained_ms(torch, step, values, n_chain):
    """bench.py's protocol: n_chain chained steps, one synchronize, median of 3."""
    cur = step(step(values))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        cur = values
        t0 = time.perf_counter()
        for _ in range(n_chain):
            cur = step(cur)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_chain)
    return sorted(times)[1], cur


def profile_step(torch, step, values, top=12):
    """One step under torch.profiler: (device busy ms, kernel launches,
    [(kernel, ms, calls)], [(host op, self ms, calls)]), or None when the
    profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(values)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(values)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kern),
                  key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top], host[:top]


def time_step(torch, v1, label, unit, step, graph, values, n_chain):
    """Chained time of `step`, its launches per step, and its profile."""
    v1.reset_launch_counts()
    step(values)
    per_step = v1.launch_counts()
    ms, out = chained_ms(torch, step, values, n_chain)
    err = float(graph.error(out))
    log(f"{label}: {ms:.3f} ms/{unit} (chained x{n_chain}, median of 3); launches per "
        f"{unit} {per_step}; error after {n_chain} steps {err:.6e}")
    if not err == err:
        raise AssertionError(f"{label}: steps gave a non-finite error")
    prof = profile_step(torch, step, values)
    if prof is None:
        log(f"{label} device time: not measured (no device events)")
        return ms, per_step
    busy, n_launch, rows, host = prof
    log(f"{label} device busy {busy:.3f} ms of {ms:.3f} ms ({100.0 * busy / ms:.1f}%); "
        f"top kernels by device time:")
    for key, kms, calls in rows:
        log(f"  {kms:9.3f} ms  {calls:5d}x  {key[:100]}")
    log(f"{label} host ops by self CPU time (profiled step, {n_launch} kernel launches):")
    for key, hms, calls in host:
        log(f"  {hms:9.3f} ms  {calls:5d}x  {key[:100]}")
    return ms, per_step


def check_result(res, what):
    hist = res.error_history
    if not (res.error < hist[0] and all(e == e and abs(e) != float("inf") for e in hist)):
        raise AssertionError(f"{what}: error did not fall or is not finite: {hist}")


def routing(elimination, maps, itemsize):
    d = maps.plan.d
    return [(bm.B, bm.nf, bm.ns, elimination.bucket_route(bm, d, itemsize)) for bm in maps.buckets]


def log_routing(elimination, label, maps):
    r64, r32 = routing(elimination, maps, 8), routing(elimination, maps, 4)
    log(f"{label}: {len(r64)} buckets (B, nf, ns) -> kernel in float64 [float32 where it differs]:")
    log("  " + " ".join(
        f"({B},{nf},{ns})->{ROUTE_KERNEL[a]}" + ("" if a == b else f"[{ROUTE_KERNEL[b]}]")
        for (B, nf, ns, a), (_, _, _, b) in zip(r64, r32)))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gtsam_petercdev_torch")):
        print("chip_smoke: gtsam_petercdev_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    kernels_only = "--kernels-only" in sys.argv[1:]
    t_start = time.perf_counter()

    import numpy as np

    from gtsam_petercdev_torch.inference import elimination, kernels, symbolic
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
    from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        LMParams, OptimizerParams, gauss_newton, levenberg_marquardt)
    from gtsam_petercdev_torch.ops import build, cholesky as v1, cholesky_v2 as v2
    from gtsam_petercdev_torch.sfm import schur
    from gtsam_petercdev_torch.utils import convert, synthetic

    # 1. card
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    for line in build.build_all(verbose=True):
        log(line)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    if kernels_only:
        cases = PALLAS_TEST_SHAPES + [(395, 1, 4, 6), (2, 12, 16, 6), (1, 32, 96, 6),
                                      (5000, 1, 4, 9), (3, 1, 0, 9), (2, 3, 24, 9), (1, 12, 24, 9)]
        timed = {n: {k: [(5000, 1, 4, 9), (2, 3, 8, 9)] for k in KERNELS}
                 for n in ("float64", "float32")}
        check_kernels(torch, (v2, v1, kernels), cases, timed)
        log(f"kernels-only check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # the sphere problem and its plans (host planning)
    va, fa = synthetic.sphere_rings(N_RINGS, N_PER_RING, seed=SEED)
    g64 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float64)
    v64 = convert.values_from_arrays(va, device="cuda", dtype=torch.float64)
    g32 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float32)
    v32 = convert.values_from_arrays(va, device="cuda", dtype=torch.float32)
    n_fac = sum(len(k) for name, k, _, _ in fa if name.startswith("Between"))
    log(f"sphere problem: {len(va['Pose3'][0])} poses, {n_fac} between factors + 1 prior")
    t0 = time.perf_counter()
    structure = elimination.graph_structure(g64, v64)
    bench_plan = elimination.build_plan_for_graph(structure, len(v64), 6, max_buckets_per_level=4)
    bench_maps = elimination.build_numeric_maps(bench_plan, structure)
    lg0 = g64.linearize(v64)
    opt_plan, opt_maps = elimination._graph_plan(g64, lg0)
    log(f"sphere plans: {time.perf_counter() - t0:.1f} s; bench plan {bench_plan.stats()} "
        f"{len(bench_maps.buckets)} buckets, {elimination.plan_flop_stats(bench_plan)}; "
        f"optimizer plan {len(opt_maps.buckets)} buckets")
    log_routing(elimination, "sphere bench plan", bench_maps)
    log_routing(elimination, "sphere optimizer plan", opt_maps)

    # the bundle-adjustment problem and its plans: one ordering, two
    # bucketings (bench.py's 4 per level, the optimizers' default 2), shared
    # by the float32 and float64 graphs (a plan depends on structure alone)
    n_cams, n_pts, n_obs = BA_SHAPE
    t0 = time.perf_counter()
    ba = {}
    for name, dtype, np_dtype in (("float32", torch.float32, np.float32),
                                  ("float64", torch.float64, np.float64)):
        data = make_synthetic_ba(n_cams, n_pts, n_obs, seed=SEED, dtype=np_dtype)
        ba[name] = build_ba_graph(data, dtype=dtype, device="cuda")
    del data
    log(f"BA problem: {n_cams} cameras, {n_pts} points, {n_pts * n_obs} observations "
        f"+ 2 priors; generated and uploaded (float32 and float64) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bg64, bv64 = ba["float64"]
    ba_struct = elimination.graph_structure(bg64, bv64)
    ba_lg0 = bg64.linearize(bv64)
    types = sorted(ba_lg0.type_counts)
    offs = elimination.type_offsets(ba_lg0.type_counts)
    n_vars = sum(ba_lg0.type_counts.values())
    var_dims = np.full(n_vars, 9, dtype=np.int64)
    var_dims[offs["Point3"] : offs["Point3"] + n_pts] = 3
    edges = np.stack(ba_struct[0].gids, axis=1)
    perm = symbolic.best_ordering(n_vars, edges)
    t_order = time.perf_counter() - t0
    ba_maps = {}
    for per_level in (4, 2):
        plan = elimination.build_plan_for_graph(ba_struct, n_vars, 9, ordering=perm,
                                                max_buckets_per_level=per_level)
        ba_maps[per_level] = elimination.build_numeric_maps(plan, ba_struct, var_dims=var_dims)
    ba_bench_maps = ba_maps[4]
    for graph, values in ba.values():
        elimination.set_graph_plan(graph, graph.linearize(values), ba_maps[2].plan, ba_maps[2])
    flop = elimination.plan_flop_stats(ba_bench_maps.plan, var_dims)
    log(f"BA plans: host planning {time.perf_counter() - t0:.1f} s (ordering {t_order:.1f} s); "
        f"bench plan {ba_bench_maps.plan.stats()} {len(ba_bench_maps.buckets)} buckets, {flop}; "
        f"optimizer plan {len(ba_maps[2].buckets)} buckets; largest front m = "
        f"{max(bm.mb for bm in ba_bench_maps.buckets) * 9}")
    log_routing(elimination, "BA bench plan", ba_bench_maps)
    log_routing(elimination, "BA optimizer plan", ba_maps[2])

    # 3. kernels against their plain versions
    all_maps = ((bench_maps, 6), (opt_maps, 6), (ba_bench_maps, 9), (ba_maps[2], 9))
    cases = list(dict.fromkeys(
        [(bm.B, bm.nf, bm.ns, d) for maps, d in all_maps for bm in maps.buckets]
        + PALLAS_TEST_SHAPES))
    timed = {}
    for name, itemsize in (("float64", 8), ("float32", 4)):
        timed[name] = {k: [] for k in KERNELS}
        for maps, d in ((bench_maps, 6), (ba_bench_maps, 9)):
            for B, nf, ns, route in routing(elimination, maps, itemsize):
                timed[name][ROUTE_KERNEL[route]].append((B, nf, ns, d))
                timed[name]["backsolve_bucket"].append((B, nf, ns, d))
    t0 = time.perf_counter()
    kres = check_kernels(torch, (v2, v1, kernels), cases, timed)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # 4. the sphere path, through the entry points
    v1.reset_launch_counts()
    gn = gauss_newton(g64, v64, OptimizerParams(solver="multifrontal", max_iterations=GN_ITERS),
                      device="cuda")
    lm = levenberg_marquardt(g64, v64, LMParams(solver="multifrontal", max_iterations=LM_ITERS),
                             device="cuda")
    torch.cuda.synchronize()
    sphere_launches = v1.launch_counts()
    log(f"GN: error {gn.error_history[0]:.6e} -> {gn.error:.6e} in {gn.iterations} iterations")
    log(f"LM: error {lm.error_history[0]:.6e} -> {lm.error:.6e} in {lm.iterations} iterations")
    log(f"launches on the sphere path: {sphere_launches}")
    check_result(gn, "sphere GN")
    check_result(lm, "sphere LM")
    p = gn.values.params("Pose3")
    n_poses = N_RINGS * N_PER_RING
    if not (p.R.shape == (n_poses, 3, 3) and torch.isfinite(p.R).all() and torch.isfinite(p.t).all()):
        raise AssertionError(f"GN result is not {n_poses} finite poses")

    # first GN step against the dense Cholesky oracle (float64)
    delta, _ = elimination.solve_linearized(g64, v64, 0.0, cache={"mf_lg": lg0})
    H, g = linsolve.assemble_dense(lg0)
    x_dense = linsolve.dense_solve(H, g, 0.0).reshape(-1, 6)
    rel = ((delta["Pose3"] - x_dense).norm() / x_dense.norm()).item()
    log(f"first GN step vs dense oracle: rel {rel:.3e}")
    if not rel <= 1e-8:
        raise AssertionError(f"GN step differs from the dense oracle: rel {rel:.3e}")
    del H, g, x_dense

    # a small graph: the card's path against the CPU path (plain kernels)
    sva, sfa = synthetic.sphere_rings(4, 5, seed=SEED + 1)
    small = []
    for dev in ("cuda", "cpu"):
        r = gauss_newton(convert.graph_from_arrays(sfa, device=dev),
                         convert.values_from_arrays(sva, device=dev),
                         OptimizerParams(solver="multifrontal", max_iterations=10), device=dev)
        small.append(r.error)
    log(f"small ring graph GN: cuda {small[0]:.12e} cpu {small[1]:.12e}")
    if not abs(small[0] - small[1]) <= 1e-9 * abs(small[1]):
        raise AssertionError("card and CPU paths disagree on the small graph")

    # ms per chained GN iteration (bench.py's protocol), float32 and float64
    def gn_step_fn(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(
                bench_maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-5)
            return values.retract({"Pose3": x})

        return step

    step_ms = {}
    for name, graph, values in (("float32", g32, v32), ("float64", g64, v64)):
        step_ms[name], _ = time_step(torch, v1, f"GN iteration {name}", "iter",
                                     gn_step_fn(graph), graph, values, 10)
    del g32, v32, g64, v64, lg0
    log(f"sphere phases done at {time.perf_counter() - t_start:.1f} s")

    # 5. the bundle-adjustment path, through the entry points
    torch.cuda.reset_peak_memory_stats()
    v1.reset_launch_counts()
    ba_res = {}
    for name in ("float32", "float64"):
        graph, values = ba[name]
        for solver in ("multifrontal", "schur"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = levenberg_marquardt(
                graph, values, LMParams(solver=solver, max_iterations=BA_LM_ITERS[name]),
                device="cuda")
            torch.cuda.synchronize()
            ba_res[name, solver] = res
            log(f"BA LM {name} {solver}: error {res.error_history[0]:.6e} -> {res.error:.6e} in "
                f"{res.iterations} iterations, {time.perf_counter() - t0:.2f} s, history "
                f"{['%.6e' % e for e in res.error_history]}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check_result(res, f"BA LM {name} {solver}")
            cam = res.values.params("SfmCamera")
            pts = res.values.params("Point3")
            if not (cam.R.shape == (n_cams, 3, 3) and pts.shape == (n_pts, 3)
                    and all(torch.isfinite(a).all() for a in (cam.R, cam.t, cam.cal, pts))):
                raise AssertionError(f"BA LM {name} {solver}: result is not finite")
    ba_launches = v1.launch_counts()
    log(f"launches on the BA path: {ba_launches}")
    launches = {k: sphere_launches[k] + ba_launches[k] for k in KERNELS}
    log(f"launches on the main paths: {launches}")
    # each path runs all four kernels (its plan has a leaf bucket, buckets
    # that fit shared memory and, in float64, fronts that do not)
    for path, counts in (("sphere", sphere_launches), ("BA", ba_launches)):
        if not all(n > 0 for n in counts.values()):
            raise AssertionError(f"a kernel was never launched on the {path} path: {counts}")
    for name in ("float32", "float64"):
        a, b = ba_res[name, "multifrontal"].error, ba_res[name, "schur"].error
        log(f"BA LM {name}: final error multifrontal {a:.9e} schur {b:.9e}")

    # first damped step (lambda = 1e-4): two independent eliminations of the
    # same float64 system, the multifrontal sweep and the landmark Schur solve
    cache = {"mf_lg": ba_lg0, "schur_lg": ba_lg0}
    d_mf, _ = elimination.solve_linearized(bg64, bv64, 1e-4, cache=cache)
    if int(cache["bad_pivots"]) != 0:
        raise AssertionError("BA first step: the multifrontal factorization clamped pivots")
    d_sc, _ = schur.solve_linearized(bg64, bv64, 1e-4, cache=cache)
    num = sum((d_mf[t] - d_sc[t]).pow(2).sum() for t in types).sqrt().item()
    den = sum(d_sc[t].pow(2).sum() for t in types).sqrt().item()
    log(f"BA first damped step, multifrontal vs schur (float64): rel {num / den:.3e}")
    if not num / den <= 1e-8:
        raise AssertionError(f"BA multifrontal and schur steps differ: rel {num / den:.3e}")
    del d_mf, d_sc, cache

    # a small rig: the card's path against the CPU path, both solvers
    sdata = make_synthetic_ba(8, 60, 4, seed=SEED + 1, dtype=np.float64)
    for solver in ("multifrontal", "schur"):
        small = [levenberg_marquardt(*build_ba_graph(sdata, device=dev),
                                     LMParams(solver=solver, max_iterations=5), device=dev).error
                 for dev in ("cuda", "cpu")]
        log(f"small BA rig LM {solver}: cuda {small[0]:.12e} cpu {small[1]:.12e}")
        if not abs(small[0] - small[1]) <= 1e-9 * abs(small[1]):
            raise AssertionError(f"card and CPU paths disagree on the small BA rig ({solver})")

    # LM iterations per second, bench.py's protocol: linearize, damped
    # multifrontal solve (lambda 1e-4) on the 4-per-level plan, retract
    def ba_step_fn(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(
                ba_bench_maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-4)
            return values.retract({t: x[offs[t] : offs[t] + ba_lg0.type_counts[t],
                                        : (3 if t == "Point3" else 9)] for t in types})

        return step

    ba_iters_per_s = {}
    for name in ("float32", "float64"):
        graph, values = ba[name]
        torch.cuda.reset_peak_memory_stats()
        ms, _ = time_step(torch, v1, f"BA LM step {name}", "step", ba_step_fn(graph), graph,
                          values, 4)
        ba_iters_per_s[name] = 1e3 / ms
        log(f"BA LM step {name}: {1e3 / ms:.3f} LM iterations/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # the step's first layer alone: linearize (forward-mode Jacobians of
        # the projection factors), so the profile above splits into it and the solve
        prof = profile_step(torch, lambda v, graph=graph: graph.linearize(v), values, top=4)
        if prof is not None:
            log(f"BA linearize {name} alone: device busy {prof[0]:.3f} ms, {prof[1]} kernel "
                f"launches; top kernels: "
                + "; ".join(f"{kms:.3f} ms {calls}x {key[:60]}" for key, kms, calls in prof[2]))
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # 6. result lines
    out = []
    for kname, (source, replaces, _) in KERNELS.items():
        f64, f32 = kres[kname]["float64"], kres[kname]["float32"]
        out.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=f64["max_abs_err"], ms=f64["ms"],
            plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"], bound_by=f64["bound_by"],
            library_ms=None, dtype="float64", device_ms=f64["device_ms"], float32=f32,
            launches_sphere_path=sphere_launches[kname], launches_ba_path=ba_launches[kname],
            k1_same_buckets_ms=f64.get("k1_same_buckets_ms"),
            timed=f"one sweep of the {f64['buckets_timed']} buckets the routing gives this "
                  f"kernel in the sphere and BA bench plans",
        ))
    print(json.dumps({"kernels": out, "gn_ms_per_iter": step_ms,
                      "ba_lm_iters_per_s": ba_iters_per_s}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
