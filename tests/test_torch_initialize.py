"""The port's chordal (3D) and LAGO (2D) initialization against the JAX
package's.

Inputs come from one numpy seed (or the repository's noisyToyGraph edges)
and go through both packages; the port runs on the CPU in float64.
Tolerances: chordal rotations and translations atol 1e-6 (both PCGs at tol
1e-8), LAGO atol 1e-12 on noisyToyGraph's edges and rel 1e-9 on a 200-pose
City stream. The claims of tests/test_initialize.py that read the missing
reference data are held here on the repository's noisyToyGraph edges.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.slam import initialize as t_init
from gtsam_petercdev_torch.slam.factors import between_factor as t_between
from gtsam_petercdev_torch.slam.factors import prior_factor as t_prior
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.slam import initialize as j_init
from gtsam_petercdev_tpu.slam.factors import between_factor as j_between
from test_torch_factor_graph import jax_from_arrays, jax_to_arrays

G2O = os.path.join(os.path.dirname(__file__), "data", "ref_noisyToyGraph_optimized.g2o")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_chordal(jg):
    out = j_init.initialize_pose3_chordal(jg)
    p = out.params("Pose3")
    return np.asarray(out.type_keys("Pose3")), np.asarray(p.R), np.asarray(p.t)


def _toy_arrays():
    return jax_to_arrays(*ge._toy_pose3_problem(n_poses=12, dtype=jnp.float64))


@pytest.mark.parametrize("problem", ["toy12", "sphere6x6"])
def test_chordal_matches_jax(problem):
    va, fa = _toy_arrays() if problem == "toy12" else synthetic.sphere_rings(6, 6, seed=0)
    jg, _ = jax_from_arrays(va, fa)
    keys, R_ref, t_ref = _jax_chordal(jg)
    tv = t_init.initialize_pose3_chordal(convert.graph_from_arrays(fa, device="cpu"))
    assert tv.type_keys("Pose3") == keys.tolist()
    p = tv.params("Pose3")
    np.testing.assert_allclose(p.R.numpy(), R_ref, atol=1e-6)
    np.testing.assert_allclose(p.t.numpy(), t_ref, atol=1e-6)
    # the result is a rotation: the SVD projection's det fix
    np.testing.assert_allclose(torch.linalg.det(p.R).numpy(), 1.0, atol=1e-12)


def test_chordal_improves_on_the_start_and_keeps_the_graph_device():
    """On the sphere without its prior (chordal fixes the gauge at the
    anchor), the chordal estimate's error is below the perturbed start's."""
    va, fa = synthetic.sphere_rings(6, 6, seed=0)
    g = convert.graph_from_arrays(fa[1:], device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    est = t_init.initialize_pose3_chordal(g)
    assert est.device == g.device
    assert float(g.error(est)) < float(g.error(v))


def _noisy_toy_edges():
    """The five EDGE_SE2 lines of the repository's noisyToyGraph, with their
    (unit) information."""
    rows = [ln.split() for ln in open(G2O) if ln.startswith("EDGE_SE2")]
    ij = np.array([[int(r[1]), int(r[2])] for r in rows])
    meas = np.array([[float(x) for x in r[3:6]] for r in rows])
    info = np.array([[float(x) for x in r[6:12]] for r in rows])
    sq = []
    for i11, i12, i13, i22, i23, i33 in info:
        I = np.array([[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]])
        sq.append(np.linalg.cholesky(I).T)
    return ij, meas, np.stack(sq)


def _pose2_graphs(ij, meas, sq):
    jg, tg = JGraph(), TGraph(device="cpu")
    jg.add_batch(j_between("Pose2"), ij, jnp.asarray(meas), jnp.asarray(sq))
    tg.add_batch(t_between("Pose2"), ij, meas, sq)
    return jg, tg


def _pose2_array(values):
    keys = values.type_keys("Pose2")
    return keys, np.asarray(values.params("Pose2"))


def test_lago_noisy_toy_matches_jax_and_reaches_the_reference_claims():
    """LAGO on noisyToyGraph's edges = the JAX LAGO (1e-12); the claims of
    tests/test_initialize.py::test_lago_init_noisy_toy: error below 0.5 at
    the LAGO estimate (the JAX package reads 0.080526 here), LM from it
    with the JAX test's prior ending below 0.07 (0.068377)."""
    jg, tg = _pose2_graphs(*_noisy_toy_edges())
    jv = j_init.initialize_pose2_lago(jg)
    tv = t_init.initialize_pose2_lago(tg)
    jk, jp = _pose2_array(jv)
    tk, tp = _pose2_array(tv)
    assert tk == list(jk)
    np.testing.assert_allclose(tp, jp, atol=1e-12)

    e = float(tg.error(tv))
    assert e < 0.5, e
    np.testing.assert_allclose(e, float(jg.error(jv)), rtol=1e-12)
    np.testing.assert_allclose(e, 0.080526, atol=1e-6)
    tg.add(t_prior("Pose2"), [0], tv.at(0), t_noise.diagonal_precisions(np.array([1e6, 1e6, 1e8])))
    res = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(max_iterations=30), device="cpu")
    assert res.error < 0.07, res.error
    np.testing.assert_allclose(res.error, 0.068377, atol=1e-6)


def test_lago_handles_orientation_wrap():
    """A loop whose accumulated orientation winds past pi (the JAX test's
    case, on the port)."""
    from gtsam_petercdev_torch.geometry import pose2

    n = 8
    gt = [torch.zeros(3, dtype=torch.float64)]
    step = torch.tensor([1.0, 0.0, 2 * np.pi / n], dtype=torch.float64)
    for _ in range(n - 1):
        gt.append(pose2.compose(gt[-1], step))
    graph = TGraph(device="cpu")
    model = t_noise.isotropic(3, 0.05, np.float64)
    for i in range(n):
        j = (i + 1) % n
        graph.add(t_between("Pose2"), [i, j], pose2.between(gt[i], gt[j]), model)
    est = t_init.initialize_pose2_lago(graph)
    for i in range(n):
        d = pose2.local(est.at(i), gt[i]).numpy()
        assert np.linalg.norm(d) < 1e-6, (i, d)


def _city_edges(n_poses):
    lines, gt = synthetic.city_stream(n_poses, seed=0)
    rows = [ln.split() for ln in lines]
    ij = np.array([[int(r[1]), int(r[3])] for r in rows])
    meas = np.array([[float(x) for x in r[6:9]] for r in rows])
    sig = np.where((ij[:, 1] == ij[:, 0] + 1)[:, None], np.array(synthetic.CITY_SIGMAS), 10.0)
    sq = np.stack([np.diag(1.0 / s) for s in sig])
    return ij, meas, sq, gt


def test_lago_city_cut_matches_jax():
    ij, meas, sq, gt = _city_edges(200)
    jg, tg = _pose2_graphs(ij, meas, sq)
    jk, jp = _pose2_array(j_init.initialize_pose2_lago(jg))
    tk, tp = _pose2_array(t_init.initialize_pose2_lago(tg))
    assert tk == list(jk)
    scale = np.abs(jp).max()
    np.testing.assert_allclose(tp, jp, atol=1e-9 * scale)
    # LAGO lands near the truth on this walk (orientations wrapped alike)
    assert np.sqrt(np.mean(np.sum((tp[:, :2] - gt[:, :2]) ** 2, axis=1))) < 2.0


def test_initializers_default_to_the_graph_device_and_cuda_raises_without_a_card():
    """The initializers follow the graph's device; a graph asked for on
    "cuda" (the default) raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        TGraph()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.graph_from_arrays(synthetic.sphere_rings(2, 3)[1])
