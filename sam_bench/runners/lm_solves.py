"""Back-to-back Levenberg-Marquardt solves of one problem: a closed loop of
batch solves, as a user re-solving a map or a reconstruction runs them.

Each solve is `levenberg_marquardt(graph, copy of the start, LMParams(
solver, max_iterations, the reference's LM_SETTINGS))` on the same graph
object, so the plan the port caches on the graph is reused. The copy of the
start values is inside the window. The window ends at the end of the first
solve that ends after `seconds`; iter_ms is the window over the LM
iterations of its solves (each result's `iterations`: linearizations, each
with its damped trials and retract).

Correctness: the plain reference runs the same LM from the same inputs, in
float64 on the same device, once the window has closed and the port's state
is freed. Every solve's error history is compared with the reference's,
entry by entry, and the final values of a sample of the solves (a reservoir
of STATES drawn with the seed) leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import numpy as np

from sam_bench import trace as tracing
from sam_bench.reference.lm import LM_SETTINGS, levenberg_marquardt as reference_lm

STATES = 3  # final states kept for the comparison (a reservoir sample)


def _copy(ctx):
    """A fresh Values with the start's parameters copied on the device."""
    from gtsam_petercdev_torch.nonlinear.values import Values

    s = ctx.start
    params = {}
    for t in s.types():
        p = s.params(t)
        params[t] = p.clone() if ctx.torch.is_tensor(p) else type(p)(*(a.clone() for a in p))
    return Values(params, ctx.index, ctx.type_keys, device=s.device, dtype=s.dtype)


def _solve(ctx, params=None):
    from gtsam_petercdev_torch.nonlinear.optimizers import levenberg_marquardt

    res = levenberg_marquardt(ctx.graph, _copy(ctx), params or ctx.params, device=ctx.device)
    ctx.sync()
    return res


def setup(ctx):
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams
    from gtsam_petercdev_torch.utils import convert

    torch, cfg, tr = ctx.torch, ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    ctx.graph = convert.graph_from_arrays(ctx.problem.factors, device=ctx.device, dtype=dtype)
    ctx.start = convert.values_from_arrays(ctx.problem.values, device=ctx.device, dtype=dtype)
    ctx.type_keys = {t: ctx.start.type_keys(t) for t in ctx.start.types()}
    for t, (keys, _) in ctx.problem.values.items():
        if ctx.type_keys[t] != [int(k) for k in keys]:
            raise RuntimeError(f"the port's Values hold {t} in another order")
    ctx.index = {k: (t, row) for t, ks in ctx.type_keys.items() for row, k in enumerate(ks)}
    ctx.params = LMParams(solver=tr["solver"], max_iterations=int(tr["max_iterations"]),
                          **LM_SETTINGS)
    # the warm solve, one LM iteration: plans, and runs every shape the
    # window runs (one linearization, its damped trials, the retract)
    _solve(ctx, dataclasses.replace(ctx.params, max_iterations=1))


def _record(ctx, res, rng, n_seen):
    ctx.histories.append([float(e) for e in res.error_history])
    if rng is None or len(ctx.states) < STATES:
        ctx.states.append(res.values)
    else:
        j = rng.randrange(n_seen)
        if j < STATES:
            ctx.states[j] = res.values


def window(ctx, seconds: float) -> dict:
    rng = random.Random(ctx.seed)
    ctx.histories, ctx.states = [], []
    iters, ends = 0, []
    ctx.sync()
    ctx.reset_peak()
    t0 = time.perf_counter()
    while True:
        res = _solve(ctx)
        iters += res.iterations
        _record(ctx, res, rng, len(ctx.histories) + 1)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    del res
    each = [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]
    print(f"sam_bench: window {elapsed:.4f} s, {iters} LM iterations, solves (s) {each}",
          file=sys.stderr)
    return {"iter_ms": elapsed * 1e3 / max(iters, 1),
            "peak_mem_gib": ctx.peak_bytes() / 2**30,
            "_solves": len(ctx.histories)}


def traced(ctx):
    """Two whole solves, each under the profiler; the fuller trace is kept."""
    rng = random.Random(ctx.seed)
    ctx.histories, ctx.states = [], []
    outs, (tr, res) = tracing.profiled(lambda: _solve(ctx), ctx)
    tr.iterations = res.iterations
    for k, r in enumerate(outs):
        _record(ctx, r, rng, k + 1)
    ctx.trace = tr
    return len(outs)


def release(ctx):
    """Free the port's state, keeping the sampled final states on the host."""
    leaves = ctx.cell.config["value_leaves"]
    kept = []
    for v in ctx.states:
        out = {}
        for t, names in leaves.items():
            p = v.params(t)
            parts = (p,) if ctx.torch.is_tensor(p) else tuple(p)
            out.update({n: a.detach().to("cpu", ctx.torch.float64) for n, a in zip(names, parts)})
        kept.append(out)
    ctx.states = kept
    ctx.graph = ctx.start = ctx.params = None
    ctx.empty_cache()


def gaps(histories, states, ref_history, ref_state) -> dict:
    """The compared numbers: iters_diff (largest difference in history
    length), hist_gap (largest relative gap of an error-history entry over
    the common length), state_gap (largest gap of a final-value leaf over
    that leaf's largest magnitude in the reference)."""
    iters_diff = max(abs(len(h) - len(ref_history)) for h in histories)
    hist_gap = max(abs(a - b) / abs(b) for h in histories for a, b in zip(h, ref_history))
    state_gap = 0.0
    for s in states:
        for name, ref in ref_state.items():
            scale = float(ref.abs().max())
            state_gap = max(state_gap, float((s[name] - ref).abs().max()) / scale)
    return {"iters_diff": float(iters_diff), "hist_gap": hist_gap, "state_gap": state_gap}


def reference(ctx):
    """(history, final leaves on the host) of the reference LM, float64."""
    torch = ctx.torch
    prob = ctx.reference.Problem(ctx.problem.arrays, ctx.device, torch.float64)
    res = reference_lm(prob, prob.start, int(ctx.cell.traffic["max_iterations"]))
    print(f"sam_bench: reference LM (float64): {res.iterations} iterations, "
          f"{res.trials} trials", file=sys.stderr)
    leaves = {k: v.detach().to("cpu", torch.float64) for k, v in prob.leaves(res.state).items()}
    return res.history, leaves


def check(ctx) -> dict:
    ref_history, ref_state = reference(ctx)
    out = gaps(ctx.histories, ctx.states, ref_history, ref_state)
    # a solve fails when its own history parts from the reference's
    lim = ctx.cell.limits
    ctx.failed = sum(
        1 for h in ctx.histories
        if abs(len(h) - len(ref_history)) > lim["iters_diff"]
        or max(abs(a - b) / abs(b) for a, b in zip(h, ref_history)) > lim["hist_gap"]
        or not np.isfinite(h).all())
    return out
