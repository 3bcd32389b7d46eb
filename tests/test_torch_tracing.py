"""The port's tracing (`gtsam_petercdev_torch/utils/timing.py`): `span` off
by default and free of clocks and syncs, spans nested at LM's layer
boundaries, LM's counters against the plain reference LM of the benchmark
(`sam_bench/reference`), and the spans' clock against torch.profiler's."""

import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, levenberg_marquardt
from gtsam_petercdev_torch.utils import convert, timing
from sam_bench.generators import ba_ring
from sam_bench.reference import ba as ref_ba
from sam_bench.reference import lm as ref_lm

SOLVERS = ["multifrontal", "schur"]
# 8 cameras, 100 points of 4 views, 10 px noise: the reference LM takes 10
# trials in 6 iterations, so trials are rejected
RIG = dict(n_cameras=8, n_points=100, n_observations=400, pixel_noise=10.0, pixel_sigma=1.0,
           prior_sigma=0.1, data_seed=2)


@pytest.fixture(autouse=True)
def _clean():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.disable()
    timing.tictoc_reset()
    timing.reset_counters()
    yield
    timing.disable()
    timing.tictoc_reset()
    timing.reset_counters()
    torch.set_num_threads(torch_threads)


def _problem():
    prob = ba_ring.make(RIG, 5)
    graph = convert.graph_from_arrays(prob.factors, device="cpu")
    return prob, graph, convert.values_from_arrays(prob.values, device="cpu")


def _solve(graph, values, solver, iters=10):
    return levenberg_marquardt(graph, values, LMParams(solver=solver, max_iterations=iters,
                                                       **ref_lm.LM_SETTINGS), device="cpu")


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read")


def _no_sync(*a, **kw):
    raise AssertionError("torch.cuda.synchronize called")


def test_span_off_records_nothing_reads_no_clock_and_never_syncs(monkeypatch):
    monkeypatch.setattr(timing, "time", _NoClock())
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    assert not timing.enabled()
    a, b = timing.span("outer"), timing.span("inner")
    assert a is b  # one shared null context
    with a:
        with b:
            pass
    assert timing.spans() == [] and timing.tictoc_get("outer") is None
    _, graph, values = _problem()
    _solve(graph, values, "multifrontal", iters=2)
    assert timing.spans() == [] and timing.tictoc_get("lm.iteration") is None
    assert timing.counters()["lm.iterations"] == 2  # counters stay on


@pytest.mark.parametrize("solver", SOLVERS)
def test_tracing_on_and_off_give_identical_solves(solver, monkeypatch):
    _, graph, values = _problem()
    off = _solve(graph, values, solver)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    timing.enable()
    on = _solve(graph, values, solver)
    timing.disable()
    assert on.error_history == off.error_history and on.iterations == off.iterations
    for t in off.values.types():
        p, q = on.values.params(t), off.values.params(t)
        for x, y in zip((p,) if torch.is_tensor(p) else p, (q,) if torch.is_tensor(q) else q):
            assert torch.equal(x, y)
    assert len(timing.spans()) > 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_spans_nest_at_the_layer_boundaries(solver):
    _, graph, values = _problem()
    timing.enable()
    res = _solve(graph, values, solver)
    timing.disable()
    spans = timing.spans()
    labels = [s[0] for s in spans]
    parent = {i: (spans[s[1]][0] if s[1] >= 0 else None) for i, s in enumerate(spans)}
    assert labels.count("lm.iteration") == res.iterations
    assert labels.count("linearize") == res.iterations
    assert labels.count(solver) == labels.count("lm.trial") == timing.counters()["lm.trials"]
    assert labels.count("plan") == 1  # the graph's first solve plans
    want = {"lm.iteration": None, "lm.trial": "lm.iteration", "linearize": "lm.trial",
            solver: "lm.trial", "plan": "lm.trial"}
    for i, lb in enumerate(labels):
        assert parent[i] == want[lb], (lb, parent[i])
    for lb, p, t0, t1 in spans:
        assert 0 < t0 <= t1
        if p >= 0:
            assert spans[p][2] <= t0 and t1 <= spans[p][3]
    # the TimingOutline tree tic writes to holds them too
    assert timing.tictoc_get(f"lm.iteration/lm.trial/{solver}").n == labels.count(solver)
    assert timing.tictoc_get("lm.iteration").n == res.iterations
    # a second solve of the same graph reuses the plan
    timing.tictoc_reset()
    timing.enable()
    _solve(graph, values, solver, iters=1)
    assert "plan" not in [s[0] for s in timing.spans()]


@pytest.mark.parametrize("solver", SOLVERS)
def test_counters_match_the_reference_lm(solver):
    prob, graph, values = _problem()
    ref = ref_ba.Problem(prob.arrays, "cpu", torch.float64)
    want = ref_lm.levenberg_marquardt(ref, ref.start, 10)
    assert want.trials > want.iterations  # rejected trials are counted too
    res = _solve(graph, values, solver)
    c = timing.counters()
    assert res.iterations == c["lm.iterations"] == want.iterations
    assert c["lm.trials"] == want.trials
    assert c.get("lm.bad_pivot_trials", 0) == 0
    assert c["host_reads"] == 1 + 3 * c["lm.trials"]


@pytest.mark.parametrize("solver", SOLVERS)
def test_bad_pivot_trial_is_counted(solver, monkeypatch):
    """The solver hook reports clamped pivots once: LM rejects that trial
    (one read: the pivot count) and re-damps."""
    if solver == "multifrontal":
        from gtsam_petercdev_torch.inference import elimination as mod
    else:
        from gtsam_petercdev_torch.sfm import schur as mod
    real = mod.solve_linearized
    calls = []

    def once_bad(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) == 2:
            kw["cache"]["bad_pivots"] = torch.tensor(3, dtype=torch.int32)
        return out

    monkeypatch.setattr(mod, "solve_linearized", once_bad)
    _, graph, values = _problem()
    res = _solve(graph, values, solver)
    c = timing.counters()
    assert c["lm.bad_pivot_trials"] == 1
    assert c["lm.trials"] == len(calls) and res.iterations == c["lm.iterations"]
    assert c["host_reads"] == 1 + 3 * c["lm.trials"] - 2 * c["lm.bad_pivot_trials"]


def test_host_read_and_counters():
    assert timing.host_read(torch.tensor(2.5, dtype=torch.float64)) == 2.5
    assert timing.host_read(7) == 7
    timing.count("x")
    timing.count("x", 4)
    assert timing.counters() == {"host_reads": 2, "x": 5}
    timing.reset_counters()
    assert timing.counters() == {}


def test_tictoc_reset_clears_spans_not_counters():
    timing.enable()
    with timing.span("a"):
        timing.count("n")
    assert [s[0] for s in timing.spans()] == ["a"]
    timing.tictoc_reset()
    assert timing.spans() == [] and timing.counters() == {"n": 1}


def test_span_clock_contains_the_profilers_mm():
    """Spans are stamped on the clock torch.profiler stamps host events on:
    a span around torch.mm contains the profile's aten::mm interval."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64, dtype=torch.float64)
    timing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with timing.span("mm"):
                torch.mm(a, a)
    timing.disable()
    mms = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm")
    spans = [(t0, t1) for lb, _, t0, t1 in timing.spans()]
    assert len(mms) == len(spans) == 20
    for (s0, s1), (m0, m1) in zip(spans, mms):
        assert s0 <= m0 <= m1 <= s1
    assert np.all(np.diff([s[0] for s in spans]) > 0)
