"""The plain reference agrees with the port on the CPU at small sizes: the
error, and Levenberg-Marquardt's whole history and result, in both solvers,
with tracks of 4 and 5 views."""

import pytest
import torch

from sam_bench.generators import ba_ring
from sam_bench.reference import ba, lm

BA = dict(n_cameras=20, n_points=500, pixel_noise=1.0, pixel_sigma=1.0, prior_sigma=0.1,
          data_seed=1)
# (views: n_observations, solver, LM iterations)
CASES = [(2000, "multifrontal", 10), (2168, "multifrontal", 10), (2000, "schur", 10),
         (2168, "schur", 10)]


def _problem(n_obs):
    return (ba_ring.make(dict(BA, n_observations=n_obs), 3), ba,
            {"SfmCamera": ("R", "t", "cal"), "Point3": ("points",)})


@pytest.mark.parametrize("n_obs,solver,iters", CASES)
def test_reference_lm_follows_the_port(n_obs, solver, iters):
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, levenberg_marquardt
    from gtsam_petercdev_torch.utils import convert

    prob, mod, leaves = _problem(n_obs)
    graph = convert.graph_from_arrays(prob.factors, device="cpu")
    values = convert.values_from_arrays(prob.values, device="cpu")
    ref = mod.Problem(prob.arrays, "cpu", torch.float64)
    assert float(ref.error(ref.start)) == pytest.approx(float(graph.error(values)), rel=1e-14)
    want = lm.levenberg_marquardt(ref, ref.start, iters)
    got = levenberg_marquardt(graph, values, LMParams(solver=solver, max_iterations=iters,
                                                      **lm.LM_SETTINGS), device="cpu")
    assert len(got.error_history) == len(want.history) >= 3
    for a, b in zip(got.error_history, want.history):
        assert a == pytest.approx(b, rel=1e-11)
    ref_leaves = mod.Problem.leaves(ref, want.state)
    for t, names in leaves.items():
        p = got.values.params(t)
        parts = (p,) if torch.is_tensor(p) else tuple(p)
        for name, a in zip(names, parts):
            r = ref_leaves[name]
            assert float((a - r).abs().max()) <= 1e-9 * float(r.abs().max())


@pytest.mark.parametrize("n_obs", [2000, 2168])
def test_reference_linearization_matches_the_port(n_obs):
    """The damped step of the first iteration equals the port's dense solve's."""
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.utils import convert

    prob, mod, _ = _problem(n_obs)
    graph = convert.graph_from_arrays(prob.factors, device="cpu")
    values = convert.values_from_arrays(prob.values, device="cpu")
    lg = graph.linearize(values)
    H, g = linsolve.assemble_dense(lg)
    x = linsolve.unflatten_delta(lg, linsolve.dense_solve(H, g, 1e-3))
    ref = mod.Problem(prob.arrays, "cpu", torch.float64)
    dx, _, ok = ref.solve(ref.linearize(ref.start), 1e-3)
    assert ok
    for a, b in [(x["SfmCamera"], dx[0]), (x["Point3"], dx[1])]:
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


def test_lie_round_trip():
    from sam_bench.reference import lie

    g = torch.Generator().manual_seed(0)
    xi = 0.5 * torch.randn(200, 6, generator=g, dtype=torch.float64)
    xi[:3] *= 1e-9  # the Taylor branches
    R, t = lie.se3_exp(xi)
    assert float((lie.se3_log(R, t) - xi).abs().max()) < 1e-12
    assert float((R @ R.transpose(-1, -2) - torch.eye(3, dtype=torch.float64)).abs().max()) < 1e-14
