"""The control: the port's own float32 path comes out not correct by the
cell's own numbers and limits. Small sizes on the CPU; on the card at the
cells' sizes it is `python3 -m sam_bench.control`."""

import pytest
import torch

from sam_bench import control
from sam_bench.tests.small import small_cell

# sizes at which float32 parts from float64 as at the cells' own; the
# multifrontal case with 4 views a point, as its plan for a 4 / 5 mix at this
# size takes the port ~50 s a solve on the CPU
CONTROL_SIZES = {
    "ladybug-1723-cut750.lm_multifrontal": dict(n_cameras=20, n_points=20000, n_observations=80000),
    "ladybug-1723.lm_schur": dict(n_cameras=20, n_points=20000, n_observations=86740),
}


@pytest.mark.parametrize("cell", sorted(CONTROL_SIZES))
@pytest.mark.parametrize("seed", [11, 2**32 + 5])
def test_float32_control_is_not_correct(cell, seed):
    c = small_cell(cell, **CONTROL_SIZES[cell])
    out = control.readings(c, seed, "cpu")
    assert not out["control_correct"], out["control"]


@pytest.mark.chip
def test_control_on_the_card(cuda):
    """One seed at the Schur cell's own size on the card."""
    from sam_bench import spec

    c = spec.cell(spec.benchmark(), "ladybug-1723.lm_schur")
    out = control.readings(c, 3, "cuda", program=True)
    assert not out["control_correct"]
    assert all(out["program"][k] <= c.limits[k] for k in c.limits)
