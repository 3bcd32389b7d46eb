"""A run with its timed path broken underneath comes out not correct: the
harness without its look for a chip, on the CPU at small sizes, once for
each fault these cells can have (one chip: no exchange between chips)."""

import pytest
import torch

from sam_bench import harness
from sam_bench.tests.small import small_cell

CELLS = ["ladybug-1723-cut750.lm_multifrontal", "ladybug-1723.lm_schur"]


def _run(cell):
    return harness.run(small_cell(cell), 7, 0.2, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged(cell, monkeypatch):
    from gtsam_petercdev_torch.nonlinear.values import Values

    monkeypatch.setattr(Values, "retract", lambda self, delta: self)
    out = _run(cell)
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_factors_left_out(cell, monkeypatch):
    """Every linearized batch keeps its first half of rows, scaled by sqrt 2
    (the mean taken over the rest)."""
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph

    real = NonlinearFactorGraph.linearize

    def halved(self, values):
        lg = real(self, values)
        for lb in lg.batches:
            n = len(lb.b)
            if n > 1:
                keep = torch.zeros(n, dtype=lb.b.dtype)
                keep[: n // 2] = 2.0 ** 0.5
                lb.b.mul_(keep[:, None])
                for A in lb.A:
                    A.mul_(keep[:, None, None])
        return lg

    monkeypatch.setattr(NonlinearFactorGraph, "linearize", halved)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("what", ["values", "history"])
def test_answer_altered_where_produced(cell, what, monkeypatch):
    """Each solve's answer altered as LM returns it: one coordinate of the
    final values moved by 1e-3 of its scale, or the last error by 1e-2."""
    from gtsam_petercdev_torch.nonlinear import optimizers

    real = optimizers.levenberg_marquardt

    def altered(*args, **kw):
        res = real(*args, **kw)
        if what == "history":
            res.error_history[-1] *= 1.0 + 1e-2
        else:
            t = sorted(res.values.types())[-1]
            p = res.values.params(t)
            leaf = p if torch.is_tensor(p) else p[1]
            leaf.view(-1)[0] += 1e-3 * float(leaf.abs().max())
        return res

    monkeypatch.setattr(optimizers, "levenberg_marquardt", altered)
    assert not _run(cell)["correct"]
