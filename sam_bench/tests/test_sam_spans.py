"""The readers of the port's spans and counters (`sam_bench/spans.py`): their
files and cells, the counters against the plain reference LM on the CPU,
no span reading without device events, and the join on a synthetic trace."""

from types import SimpleNamespace

import pytest
import torch

from sam_bench import harness, spans, spec
from sam_bench.reference.lm import levenberg_marquardt as reference_lm
from sam_bench.runners import lm_solves
from sam_bench.tests.small import small_cell

M, S = "ladybug-1723-cut750.lm_multifrontal", "ladybug-1723.lm_schur"
NEW = {  # metric -> (source, its cells)
    "lm_trials_per_iter": ("program_counter", {M, S}),
    "bad_pivot_trials_per_iter": ("program_counter", {M, S}),
    "host_reads_per_iter": ("program_counter", {M, S}),
    "device_ms.linearize": ("program_span", {M, S}),
    "idle_ms.linearize": ("program_span", {M, S}),
    "idle_ms.lm": ("program_span", {M, S}),
    "device_ms.multifrontal_glue": ("program_span", {M}),
    "idle_ms.multifrontal": ("program_span", {M}),
    "device_ms.schur": ("program_span", {S}),
    "idle_ms.schur": ("program_span", {S}),
}
COUNTERS = ["lm_trials_per_iter", "bad_pivot_trials_per_iter", "host_reads_per_iter"]
# a rig on which LM rejects trials: 10 trials in 6 iterations
REJECTING = dict(n_cameras=8, n_points=100, n_observations=400, pixel_noise=10.0, data_seed=2)


@pytest.mark.parametrize("name", sorted(NEW))
def test_metric_file_loads_and_names_its_cells(name):
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[name]
    source, cells = NEW[name]
    assert entry["source"] == source and entry["moves"] == "iter_ms"
    assert set(entry["workloads"]) == cells
    assert callable(spec.metric_reader(name).read)
    names = [m["name"] for m in spec.benchmark()["per_layer"]]
    assert names.index(name) > names.index("plan_s")  # after the existing readers


def _ctx(cell_name, **over):
    cell = small_cell(cell_name, **over)
    ctx = harness.Context(torch, torch.device("cpu"), cell, 2**31 + 77)
    ctx.problem = spec.module("generators", cell.config["generator"]).make(cell.config, ctx.seed)
    ctx.reference = spec.module("reference", cell.config["reference"])
    lm_solves.setup(ctx)
    return ctx


@pytest.mark.parametrize("cell", [M, S])
def test_counter_readers_give_the_reference_lms_ratios(cell):
    ctx = _ctx(cell, **REJECTING)
    prob = ctx.reference.Problem(ctx.problem.arrays, "cpu", torch.float64)
    want = reference_lm(prob, prob.start, int(ctx.cell.traffic["max_iterations"]))
    assert want.trials > want.iterations
    got = {n: spec.metric_reader(n).read(ctx) for n in COUNTERS}
    assert got["lm_trials_per_iter"] == want.trials / want.iterations
    assert got["bad_pivot_trials_per_iter"] == 0.0
    assert got["host_reads_per_iter"] == (1 + 3 * want.trials) / want.iterations
    # no device events on the CPU: the span readers read nothing
    for n in NEW:
        if n not in COUNTERS and cell in NEW[n][1]:
            assert spec.metric_reader(n).read(ctx) is None
    rec = spans.record(ctx)
    assert rec is spans.record(ctx)  # one solve, memoised
    assert rec.busy_s == 0 and rec.labels >= {"lm.iteration", "lm.trial", "linearize"}


def test_readers_return_none_without_the_ports_tracing(monkeypatch):
    """A port without timing.enable (the parent of the tracing) reads None."""
    from gtsam_petercdev_torch.utils import timing

    monkeypatch.delattr(timing, "enable")
    ctx = _ctx(S)
    assert all(spec.metric_reader(n).read(ctx) is None for n in NEW if S in NEW[n][1])


# spans: (label, parent, start, end); launches: (name, host start, correlation id);
# device operations: (name, start, end, correlation id)
SPANS = [("lm.iteration", -1, 100, 1000), ("lm.trial", 0, 110, 990), ("linearize", 1, 120, 300),
         ("multifrontal", 1, 400, 800)]
HOST = [("cudaLaunchKernel", 130, 11), ("cudaLaunchKernel", 410, 12),
        ("cudaLaunchKernel", 430, 15), ("cudaMemsetAsync", 850, 13),
        ("cudaLaunchKernel", 1100, 14)]
DEV = [("k_lin", 200, 350, 11), ("void factor_kernel<double, false, 9>", 420, 600, 12),
       ("index_kernel", 600, 640, 15), ("Memset (Device)", 860, 900, 13),
       ("k_out", 1150, 1200, 14), ("k_lost", 1210, 1220, 99)]


def test_join_of_a_synthetic_trace():
    j = spans.join(SPANS, HOST, DEV, 50, 1300, {"lm.iterations": 2, "lm.trials": 3})
    ns = lambda d: {k: round(v * 1e9) for k, v in d.items()}
    assert ns(j.device_s["linearize"]) == {"k_lin": 150}
    assert ns(j.device_s["multifrontal"]) == {"void factor_kernel<double, false, 9>": 180,
                                             "index_kernel": 40}
    assert ns(j.device_s["lm.trial"]) == {"Memset (Device)": 40}
    assert ns(j.device_s[spans.OUTSIDE]) == {"k_out": 50}
    assert ns(j.device_s[spans.NOT_JOINED]) == {"k_lost": 10}
    # a gap goes to the span open when the device ran dry: 350 (lm.trial, linearize
    # closed), 640 (multifrontal), 900 (lm.trial); the rest outside every span
    assert ns(j.idle_s) == {spans.OUTSIDE: 150 + 10 + 80, "lm.trial": 70 + 250,
                            "multifrontal": 220}
    assert round(j.busy_s * 1e9) == 470 and round(j.window_s * 1e9) == 1250
    assert [round(x * 1e9) for x in j.edge_idle_s] == [150, 80]
    assert round(j.under_lm_s * 1e9) == 150 + 180 + 40 + 40
    assert round((j.device_total_s() + sum(j.idle_s.values())) * 1e9) == 1250

    ctx = SimpleNamespace(_port_spans=j)
    per_iter = lambda name: spec.metric_reader(name).read(ctx)
    assert per_iter("device_ms.linearize") == pytest.approx(150e-6 / 2, rel=1e-12)
    assert per_iter("idle_ms.linearize") == 0.0
    assert per_iter("device_ms.multifrontal_glue") == pytest.approx(40e-6 / 2, rel=1e-12)
    assert per_iter("idle_ms.multifrontal") == pytest.approx(220e-6 / 2, rel=1e-12)
    assert per_iter("idle_ms.lm") == pytest.approx(320e-6 / 2, rel=1e-12)
    assert per_iter("device_ms.schur") is None and per_iter("idle_ms.schur") is None
    assert per_iter("lm_trials_per_iter") == 1.5
    assert per_iter("bad_pivot_trials_per_iter") == 0.0


def test_innermost_span_with_equal_starts():
    """Spans opened in the same nanosecond: the later one is the inner."""
    idx = spans.SpanIndex([("a", -1, 10, 100), ("b", 0, 10, 50), ("c", 1, 10, 20),
                           ("d", 0, 60, 70)])
    assert [idx.label(idx.at(t)) for t in (5, 10, 19, 20, 49, 55, 60, 70, 99, 100)] == \
        [spans.OUTSIDE, "c", "c", "b", "b", "a", "d", "a", "a", spans.OUTSIDE]
    assert idx.under_lm == [False] * 4
