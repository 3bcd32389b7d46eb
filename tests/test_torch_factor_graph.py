"""Port noise models, Values and factor-graph linearization against JAX.

The same numpy arrays (made from a seed) feed the JAX package and the port;
the port runs on the CPU in float64. Tolerance: atol 1e-10 (the same
formulas in the same precision; Jacobians through autodiff or the closed
form agree to rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.linear import noise as j_noise
from gtsam_petercdev_tpu.nonlinear.factor_graph import LinearBatch as JLinearBatch
from gtsam_petercdev_tpu.nonlinear.factor_graph import LinearizedGraph as JLinearizedGraph
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors
from test_multifrontal import _random_pose2_graph

ATOL = 1e-10


# --- carrying a problem across (numpy arrays in both directions) -------------


def _np_layout(p):
    return tuple(np.asarray(a) for a in p) if isinstance(p, tuple) else np.asarray(p)


def jax_to_arrays(jgraph, jvalues):
    """A JAX (graph, values) as the port's numpy carry-across format."""
    jgraph._materialize()
    values = {
        t: (np.asarray(jvalues.type_keys(t)), _np_layout(jvalues.params(t)))
        for t in jvalues.types()
    }
    factors = [
        (b.ftype.name, np.asarray(b.keys), _np_layout(b.params), np.asarray(b.sqrt_info))
        for b in jgraph.batches
    ]
    return values, factors


def _j_factor_type(name):
    if name.startswith("Prior"):
        return j_factors.prior_factor(name[5:])
    return j_factors.between_factor(name[7:])


def jax_from_arrays(values_arrays, factor_arrays):
    """The JAX package's (graph, values) from the carry-across format."""
    lay = lambda t, p: j_pose3.Pose3(*map(jnp.asarray, p)) if t == "Pose3" else jnp.asarray(p)
    values = JValues()
    for t, (keys, p) in values_arrays.items():
        values.insert_batch(keys, t, lay(t, p))
    graph = JGraph()
    for name, keys, p, info in factor_arrays:
        ft = _j_factor_type(name)
        graph.add_batch(ft, keys, lay(ft.var_types[0], p), info)
    return graph, values


def both(values_arrays, factor_arrays):
    jg, jv = jax_from_arrays(values_arrays, factor_arrays)
    tg = convert.graph_from_arrays(factor_arrays, device="cpu")
    tv = convert.values_from_arrays(values_arrays, device="cpu")
    return jg, jv, tg, tv


def pose2_problem(rng, n_poses=12, n_loops=4):
    return jax_to_arrays(*_random_pose2_graph(n_poses, n_loops, rng))


def pose3_rings(n_rings=4, n_per_ring=5, seed=0):
    return synthetic.sphere_rings(n_rings, n_per_ring, seed=seed)


def jax_linearize(jg, jv):
    """JAX's linearize under jit (op-by-op eager dispatch is ~10x slower on
    the CPU); rows come from the host lookup as in linearize itself."""
    jg._materialize()
    out = jax.jit(lambda v: [(lb.b, lb.A) for lb in jg.linearize(v).batches])(jv)
    return JLinearizedGraph(
        [
            JLinearBatch(b.ftype.var_types, jg._batch_terms(b, jv), A, rhs, b.sign)
            for b, (rhs, A) in zip(jg.batches, out)
        ],
        {t: jv._count(t) for t in jv.types()},
    )


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


# --- noise models -------------------------------------------------------------


NOISE_CASES = [
    ("isotropic", (6, 0.05, np.float64)),
    ("unit", (3, np.float64)),
    ("diagonal_sigmas", (np.array([0.1, 0.0, 2.0]),)),
    ("constrained_sigmas", (np.array([0.1, 0.0, 2.0]),)),
    ("constrained_all", (4,)),
    ("diagonal_precisions", (np.array([1e6, 1e4, 3.0]),)),
    ("gaussian_information", (np.array([[4.0, 1.0], [1.0, 3.0]]),)),
    ("gaussian_covariance", (np.array([[0.5, 0.1], [0.1, 0.2]]),)),
]


@pytest.mark.parametrize("name,args", NOISE_CASES, ids=[c[0] for c in NOISE_CASES])
def test_noise_constructors(name, args):
    got, ref = getattr(t_noise, name)(*args), getattr(j_noise, name)(*args)
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=ATOL, rtol=0)


LOSSES = ["huber", "cauchy", "tukey", "geman_mcclure", "welsch", "fair", "dcs"]


@pytest.mark.parametrize("name", LOSSES + ["l2"])
def test_robust_weight_and_loss(name):
    e = np.linspace(-6.0, 6.0, 49)
    t_loss = getattr(t_noise, name)() if name != "l2" else t_noise.RobustLoss("l2")
    j_loss = getattr(j_noise, name)() if name != "l2" else j_noise.RobustLoss("l2")
    _close(t_loss.weight(torch.tensor(e)), j_loss.weight(jnp.asarray(e)))
    _close(t_loss.loss(torch.tensor(e)), j_loss.loss(jnp.asarray(e)))


# --- Values -------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["pose2", "pose3"])
def test_values_retract(problem, rng):
    va, fa = pose2_problem(rng) if problem == "pose2" else pose3_rings()
    jg, jv, tg, tv = both(va, fa)
    t = "Pose2" if problem == "pose2" else "Pose3"
    n, dim = len(va[t][0]), 3 if t == "Pose2" else 6
    delta = rng.normal(size=(n, dim)) * 0.2
    jr = jv.retract({t: jnp.asarray(delta)}).params(t)
    tr = tv.retract({t: torch.tensor(delta)}).params(t)
    for a, b in zip(tr if t == "Pose3" else (tr,), jr if t == "Pose3" else (jr,)):
        _close(a, b)
    assert tv.retract({t: torch.tensor(delta)}).type_keys(t) == jv.type_keys(t)


# --- error and linearize ------------------------------------------------------


def _check_linearize(jg, jv, tg, tv):
    np.testing.assert_allclose(float(tg.error(tv)), float(jax.jit(jg.error)(jv)), rtol=1e-12)
    jl, tl = jax_linearize(jg, jv), tg.linearize(tv)
    assert tl.type_counts == jl.type_counts
    for jb, tb in zip(jl.batches, tl.batches):
        assert tb.var_types == jb.var_types
        for jr, tr in zip(jb.rows, tb.rows):
            np.testing.assert_array_equal(tr, np.asarray(jr))
        _close(tb.b, jb.b)
        for jA, tA in zip(jb.A, tb.A):
            _close(tA, jA)


def test_linearize_pose2_autodiff(rng):
    """Pose2 factors linearize through torch.func.vmap(jacfwd)."""
    _check_linearize(*both(*pose2_problem(rng, 20, 8)))


def test_linearize_pose3_analytic():
    """Pose3 factors take the closed-form Jacobians."""
    assert t_factors.between_factor("Pose3").analytic is not None
    _check_linearize(*both(*pose3_rings()))


def test_linearize_pose3_autodiff_path():
    """gtsam_compatible=False: Pose3 through vmap(jacfwd) of the full chart
    (so3.logmap under forward-mode autodiff)."""
    va, fa = pose3_rings(3, 4, seed=2)
    _, jv, _, tv = both(va, fa)
    name, keys, p, info = fa[1]
    jg = JGraph().add_batch(
        j_factors.between_factor("Pose3", False), keys,
        j_pose3.Pose3(*map(jnp.asarray, p)), info)
    tg = TGraph(device="cpu").add_batch(
        t_factors.between_factor("Pose3", False), keys, convert._layout("Pose3", p), info)
    assert t_factors.between_factor("Pose3", False).analytic is None
    _check_linearize(jg, jv, tg, tv)


@pytest.mark.parametrize("loss", ["huber", "cauchy"])
def test_linearize_robust(loss, rng):
    va, fa = pose2_problem(rng, 10, 3)
    _, jv, _, tv = both(va, fa)
    jg, tg = JGraph(), TGraph(device="cpu")
    for name, keys, p, info in fa:
        jg.add_batch(_j_factor_type(name), keys, jnp.asarray(p), info,
                     robust=getattr(j_noise, loss)(0.5))
        tg.add_batch(t_factors.factor_type(name), keys, p, info,
                     robust=getattr(t_noise, loss)(0.5))
    _check_linearize(jg, jv, tg, tv)
