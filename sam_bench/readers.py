"""The per-layer readers. Each metric's file under metrics/ names one of
these as its `read`.

A reader returns None when its cell gives it nothing to read."""

from __future__ import annotations

import os
import statistics
import time

from sam_bench import roofline
from sam_bench.reference.lm import LM_SETTINGS

REPS_LINEARIZE = 7
REPS_SOLVE = 5


def device_idle_pct(ctx):
    """The share of a profiled whole solve in which no operation ran on the
    device: 1 - the union of device intervals / the traced window."""
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_iter(ctx):
    """CUDA kernel launches of a profiled whole solve (copies and fills left
    out) over its LM iterations."""
    tr = ctx.trace
    if tr is None or tr.kernels == 0 or tr.iterations == 0:
        return None
    return tr.kernels / tr.iterations


def _median_ms(ctx, fn, reps):
    fn()
    ctx.sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ctx.sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def linearize_ms(ctx):
    """graph.linearize(start values), synchronised, the median of 7 calls
    after a warm one."""
    if ctx.graph is None or not ctx.on_cuda:
        return None
    return _median_ms(ctx, lambda: ctx.graph.linearize(ctx.start), REPS_LINEARIZE)


def _solve_ms(ctx, solver: str, solve_linearized):
    """One damped solve of the start's linearization at lambda_initial, the
    linearization cached by the warm call as LM's trials reuse it; median
    of 5."""
    if ctx.graph is None or not ctx.on_cuda or ctx.cell.traffic.get("solver") != solver:
        return None
    cache = {}
    lam = LM_SETTINGS["lambda_initial"]
    return _median_ms(ctx, lambda: solve_linearized(ctx.graph, ctx.start, lam, cache=cache),
                      REPS_SOLVE)


def solve_ms_multifrontal(ctx):
    """One damped multifrontal solve: assembly, K1-K4, the extend-adds and
    gathers, the back-substitution."""
    from gtsam_petercdev_torch.inference import elimination

    return _solve_ms(ctx, "multifrontal", elimination.solve_linearized)


def solve_ms_schur(ctx):
    """One damped landmark-Schur solve: the point elimination, the reduced
    camera system's assembly and Cholesky, the back-substitution."""
    from gtsam_petercdev_torch.sfm import schur

    return _solve_ms(ctx, "schur", schur.solve_linearized)


def bucket_kernels_roofline(ctx):
    """K1-K4's least time over their device time in the profiled solve: the
    plan's sweep bound at native clique sizes (roofline.py) times the sweeps
    the solve ran (the port's factor-route launch counts over the plan's
    buckets)."""
    tr = ctx.trace
    plans = ctx.graph.__dict__.get("_mf_plans") if ctx.graph is not None else None
    if tr is None or not plans:
        return None
    device_s = tr.kernel_seconds(roofline.is_bucket_kernel)
    launches = sum(tr.bucket_launches.get(k, 0) for k in roofline.FACTOR_ROUTES)
    if device_s <= 0 or launches == 0:
        return None
    (plan, _maps), = plans.values()
    counts = {t: len(ks) for t, ks in ctx.type_keys.items()}
    dims = roofline.var_dims(counts, ctx.cell.config["type_dims"])
    sweeps = launches / roofline.n_buckets(plan)
    bound_s = sweeps * roofline.sweep_bound_s(plan, dims, ctx.cell.config["dtype"])
    return 100.0 * bound_s / device_s


_SYMBOLIC = os.path.join("gtsam_petercdev_torch", "inference", "symbolic.py")


def plan_s(ctx):
    """Host planning in the traced run's set-up: cProfile's cumulative time
    of the calls into the port's inference/symbolic.py (the orderings, the
    symbolic elimination) from outside that module."""
    if ctx.setup_stats is None:
        return None
    inside = lambda key: key[0].endswith(_SYMBOLIC)
    total = 0.0
    for key, (_cc, _nc, _tt, _ct, callers) in ctx.setup_stats.stats.items():
        if inside(key):
            total += sum(c[3] for caller, c in callers.items() if not inside(caller))
    return total if total > 0 else None
