#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_petercdev_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
a result line:
  1. card    name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build   nvcc builds every kernel of the path from gtsam_petercdev_torch/csrc
  3. kernels each CUDA kernel against its plain PyTorch version on the card,
             at every bucket shape of the 2,500-pose sphere plan, in float64
             and float32, plus an indefinite case (equal bad-pivot counts);
             kernel and plain times per sweep of the plan
  4. path    the synthetic 2,500-pose / 4,949-factor Pose3 sphere through the
             port's entry points: gauss_newton (f64, solver="multifrontal")
             and levenberg_marquardt, with the kernels' launch counters reset
             just before and read just after; the first GN step against the
             dense Cholesky oracle; a small graph against the CPU path;
             ms per chained GN iteration in float32 and float64
  5. result  a `kernels` JSON line, the card line, then the last line
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
GN_ITERS = 5
LM_ITERS = 5
# kernel vs plain version on random SPD buckets (entries O(1), well
# conditioned): float64 agrees to rounding; float32 sums over up to
# fd = 192 terms per entry
TOL = {"float64": 1e-9, "float32": 2e-3}
# least-time bounds: H100 SXM, 3.35 TB/s HBM3; 67 TFLOP/s float32 (vector)
# and 67 TFLOP/s float64 (tensor core), NVIDIA's data sheet
MEM_BPS = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --- phase 3: kernels against their plain versions -----------------------------


def bucket_shapes(maps):
    return [(bm.B, bm.nf, bm.ns) for bm in maps.buckets]


def spd_bucket(torch, gen, B, m, dtype):
    A = torch.randn(B, m, m, generator=gen, dtype=torch.float64, device="cuda")
    F = A @ A.transpose(1, 2) / m + torch.eye(m, dtype=torch.float64, device="cuda")
    g = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    return F.to(dtype).contiguous(), g.to(dtype).contiguous()


def k1_cost(B, nf, ns, d, itemsize):
    fd, sd = nf * d, ns * d
    m = fd + sd
    nbytes = itemsize * B * (m * m + m + fd * fd + nf * d * d + fd * sd + fd + sd * sd + sd) + 4 * B
    flops = B * (fd**3 / 3.0 + fd * fd * sd + fd * sd * sd)  # plan_flop_stats' count
    return nbytes, flops


def k2_cost(B, nf, ns, d, itemsize):
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


def check_kernels(torch, ops, kernels, shapes, n_timed, d):
    """Hold K1 and K2 against their plain versions at every shape; time one
    sweep of the first n_timed shapes (the bench plan's buckets, each once,
    in plan order) per dtype."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {"partial_cholesky": {}, "backsolve_bucket": {}}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        k1_args, k2_args, err1, err2 = [], [], 0.0, 0.0
        for B, nf, ns in shapes:
            m = (nf + ns) * d
            F, g = spd_bucket(torch, gen, B, m, dtype)
            got = ops.partial_cholesky(F, g, nf, d)
            ref = kernels.partial_cholesky(F, g, nf, d)
            torch.cuda.synchronize()
            for k in ("L", "Linv", "W", "y", "U", "ug"):
                if ref[k].numel():
                    e = (got[k] - ref[k]).abs().max().item()
                    scale = max(1.0, ref[k].abs().max().item())
                    if not e <= TOL[name] * scale:
                        raise AssertionError(f"K1 {name} B={B} nf={nf} ns={ns} {k}: err {e:.3e}")
                    err1 = max(err1, e)
            if int(got["bad"]) != int(ref["bad"]):
                raise AssertionError(f"K1 bad pivots {int(got['bad'])} != {int(ref['bad'])}")
            xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            args2 = (ref["L"], ref["Linv"], ref["W"].contiguous(), ref["y"].contiguous(), xs, nf, d)
            x_k = ops.backsolve_bucket(*args2)
            x_p = ops.backsolve_plain(*args2)
            e = (x_k - x_p).abs().max().item()
            if not e <= TOL[name] * max(1.0, x_p.abs().max().item()):
                raise AssertionError(f"K2 {name} B={B} nf={nf} ns={ns}: err {e:.3e}")
            err2 = max(err2, e)
            if len(k1_args) < n_timed:
                k1_args.append((F, g, nf, d))
                k2_args.append(args2)

        # indefinite bucket: clamped pivots counted identically
        B, nf, ns = shapes[0]
        m = (nf + ns) * d
        F, g = spd_bucket(torch, gen, B, m, dtype)
        F[0, 0, 0] = -5.0
        nb_k = int(ops.partial_cholesky(F, g, nf, d)["bad"])
        nb_p = int(kernels.partial_cholesky(F, g, nf, d)["bad"])
        if not nb_k == nb_p >= 1:
            raise AssertionError(f"indefinite case: bad {nb_k} (kernel) vs {nb_p} (plain)")

        itemsize = torch.finfo(dtype).bits // 8
        for kname, err, args, fn, plain, cost, cu in (
            ("partial_cholesky", err1, k1_args, ops.partial_cholesky, kernels.partial_cholesky,
             k1_cost, "partial_cholesky_kernel"),
            ("backsolve_bucket", err2, k2_args, ops.backsolve_bucket, ops.backsolve_plain,
             k2_cost, "backsolve_kernel"),
        ):
            sweep_k = lambda: [fn(*a) for a in args]
            sweep_p = lambda: [plain(*a) for a in args]
            # plain, kernel, kernel, plain: compare within one call
            p1 = event_ms(torch, sweep_p, 3)
            k_1 = event_ms(torch, sweep_k, 10)
            k_2 = event_ms(torch, sweep_k, 10)
            p2 = event_ms(torch, sweep_p, 3)
            b_ms, b_by = bound([cost(B, nf, ns, d, itemsize) for B, nf, ns in shapes[:n_timed]],
                               name)
            res[kname][name] = dict(
                max_abs_err=err, ms=min(k_1, k_2), plain_ms=min(p1, p2),
                device_ms=profiled_kernel_ms(torch, sweep_k, cu), bound_ms=b_ms, bound_by=b_by,
            )
        log(f"kernels {name}: " + ", ".join(
            f"{k} err {v[name]['max_abs_err']:.2e} ms {v[name]['ms']:.3f} "
            f"(device {v[name]['device_ms']}) plain {v[name]['plain_ms']:.3f} "
            f"bound {v[name]['bound_ms']:.4f} ({v[name]['bound_by']})"
            for k, v in res.items()))
    return res


# --- phase 4: the main path ------------------------------------------------------


def gn_step_fn(torch, elimination, graph, maps):
    def step(values):
        lg = graph.linearize(values)
        x = elimination.multifrontal_solve(maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-5)
        return values.retract({"Pose3": x})

    return step


def chained_ms(torch, step, values):
    """bench.py's protocol: 10 chained steps, one synchronize, median of 3."""
    cur = step(step(values))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        cur = values
        t0 = time.perf_counter()
        for _ in range(10):
            cur = step(cur)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / 10)
    return sorted(times)[1], cur


def profile_step(torch, step, values, top=12):
    """One GN step under torch.profiler: (device busy ms, kernel launches,
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
    t_start = time.perf_counter()

    from gtsam_petercdev_torch.inference import elimination, kernels
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        LMParams, OptimizerParams, gauss_newton, levenberg_marquardt)
    from gtsam_petercdev_torch.ops import build, cholesky_v2 as ops
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

    # the sphere problem and its plans (host planning)
    va, fa = synthetic.sphere_rings(N_RINGS, N_PER_RING, seed=SEED)
    g64 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float64)
    v64 = convert.values_from_arrays(va, device="cuda", dtype=torch.float64)
    g32 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float32)
    v32 = convert.values_from_arrays(va, device="cuda", dtype=torch.float32)
    n_fac = sum(len(k) for name, k, _, _ in fa if name.startswith("Between"))
    log(f"problem: {len(va['Pose3'][0])} poses, {n_fac} between factors + 1 prior")
    t0 = time.perf_counter()
    structure = elimination.graph_structure(g64, v64)
    bench_plan = elimination.build_plan_for_graph(structure, len(v64), 6, max_buckets_per_level=4)
    bench_maps = elimination.build_numeric_maps(bench_plan, structure)
    lg0 = g64.linearize(v64)
    opt_plan, opt_maps = elimination._graph_plan(g64, lg0)
    log(f"plans: {time.perf_counter() - t0:.1f} s; bench plan {bench_plan.stats()} "
        f"{len(bench_maps.buckets)} buckets, {elimination.plan_flop_stats(bench_plan)}; "
        f"optimizer plan {len(opt_maps.buckets)} buckets")
    shapes = bucket_shapes(bench_maps)
    extra = [s for s in dict.fromkeys(bucket_shapes(opt_maps)) if s not in shapes]
    log(f"bucket shapes (B, nf, ns): {shapes}; optimizer-only shapes: {extra}")

    # 3. kernels against their plain versions
    kres = check_kernels(torch, ops, kernels, shapes + extra, len(shapes), 6)

    # 4. the main path, through the entry points
    ops.reset_launch_counts()
    gn = gauss_newton(g64, v64, OptimizerParams(solver="multifrontal", max_iterations=GN_ITERS),
                      device="cuda")
    lm = levenberg_marquardt(g64, v64, LMParams(solver="multifrontal", max_iterations=LM_ITERS),
                             device="cuda")
    torch.cuda.synchronize()
    launches = {"partial_cholesky": ops.partial_cholesky.launches,
                "backsolve_bucket": ops.backsolve_bucket.launches}
    log(f"GN: error {gn.error_history[0]:.6e} -> {gn.error:.6e} in {gn.iterations} iterations")
    log(f"LM: error {lm.error_history[0]:.6e} -> {lm.error:.6e} in {lm.iterations} iterations")
    log(f"launches on the main path: {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    for res in (gn, lm):
        if not (res.error < res.error_history[0] and all(map(lambda e: e == e, res.error_history))):
            raise AssertionError(f"error did not fall: {res.error_history}")
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
    step_ms = {}
    for name, graph, values in (("float32", g32, v32), ("float64", g64, v64)):
        step = gn_step_fn(torch, elimination, graph, bench_maps)
        ops.reset_launch_counts()
        step(values)
        per_iter = {"partial_cholesky": ops.partial_cholesky.launches,
                    "backsolve_bucket": ops.backsolve_bucket.launches}
        ms, out = chained_ms(torch, step, values)
        err = float(graph.error(out))
        step_ms[name] = ms
        log(f"GN iteration {name}: {ms:.3f} ms/iter (chained x10, median of 3); "
            f"launches per iteration {per_iter}; error after 10 steps {err:.6e}")
        if not err == err:
            raise AssertionError(f"{name} GN steps gave a non-finite error")
        prof = profile_step(torch, step, values)
        if prof is None:
            log(f"GN iteration {name} device time: not measured (no device events)")
            continue
        busy, n_launch, rows, host = prof
        log(f"GN iteration {name} device busy {busy:.3f} ms of {ms:.3f} ms "
            f"({100.0 * busy / ms:.1f}%); top kernels by device time:")
        for key, kms, calls in rows:
            log(f"  {kms:9.3f} ms  {calls:5d}x  {key[:100]}")
        log(f"GN iteration {name} host ops by self CPU time (profiled step, "
            f"{n_launch} kernel launches):")
        for key, hms, calls in host:
            log(f"  {hms:9.3f} ms  {calls:5d}x  {key[:100]}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory {peak_gb:.2f} GiB; total {time.perf_counter() - t_start:.1f} s")

    # 5. result lines
    src = {"partial_cholesky": ("gtsam_petercdev_torch/csrc/partial_cholesky.cu",
                                "gtsam_petercdev_tpu/ops/cholesky_v2.py:256"),
           "backsolve_bucket": ("gtsam_petercdev_torch/csrc/backsolve.cu",
                                "gtsam_petercdev_tpu/ops/cholesky_v2.py:347")}
    out = []
    for kname, per in kres.items():
        f64, f32 = per["float64"], per["float32"]
        out.append(dict(
            name=kname, route="cuda", source=src[kname][0], replaces=src[kname][1],
            launches=launches[kname], max_abs_err=f64["max_abs_err"], ms=f64["ms"],
            plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"], bound_by=f64["bound_by"],
            library_ms=None, dtype="float64", device_ms=f64["device_ms"],
            float32=f32, timed=f"one sweep of the {len(shapes)}-bucket sphere plan",
        ))
    print(json.dumps({"kernels": out, "gn_ms_per_iter": step_ms}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
