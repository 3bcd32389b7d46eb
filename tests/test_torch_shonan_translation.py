"""The port's Shonan averaging, MFAS and translation recovery against the
JAX package's (sfm/shonan.py, sfm/translation.py).

Inputs come from np.random.default_rng(seed) (the JAX tests' ring scenes:
`utils/synthetic.ring_rotations`) and go through both packages; the port
runs on the CPU in float64. Tolerances: the SO(p) operations atol 1e-13;
the Shonan factor's residual and Jacobian atol 1e-12; the certificate's
lambda_min within 1e-9 of the shift c (the same 300 power steps); rounded,
gauged rotations atol 1e-10 (the SVD's sign and basis choices are a left
O(3) factor that the gauge removes); the staircase's rotations atol 1e-8
with equal p_final and certificate; MFAS orders and outlier weights equal;
recovered translations atol 1e-8 (JAX) and 1e-4 (truth). The JAX tests
mirrored: tests/test_sfm_shonan_translation.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.core import manifold as t_manifold
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.sfm import shonan as t_shonan
from gtsam_petercdev_torch.sfm import translation as t_translation
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.core import manifold as j_manifold
from gtsam_petercdev_tpu.geometry import so3 as j_so3
from gtsam_petercdev_tpu.sfm import shonan as j_shonan
from gtsam_petercdev_tpu.sfm import translation as j_translation

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_measurements(n=10, noise_sigma=0.0, seed=0):
    i, j, R, k, R_gt = synthetic.ring_rotations(n, noise_sigma, seed)
    jm = j_shonan.ShonanMeasurements(i, j, jnp.asarray(R), jnp.asarray(k))
    tm = convert.shonan_measurements(i, j, R, k, device="cpu")
    return jm, tm, R_gt


def _random_son(rng, n, p):
    """n random SO(p) matrices (QR of Gaussians, det fixed), numpy."""
    Q, Rr = np.linalg.qr(rng.normal(size=(n, p, p)))
    Q = Q * np.sign(np.diagonal(Rr, axis1=1, axis2=2))[:, None, :]
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return Q


# --- SO(p) ------------------------------------------------------------------------


@pytest.mark.parametrize("p", [3, 4, 5, 6])
def test_son_operations(p):
    rng = np.random.default_rng(p)
    dim = p * (p - 1) // 2
    xi = rng.normal(size=(7, dim)) * 0.7
    S_j = j_shonan._son_hat(jnp.asarray(xi), p)
    S_t = t_shonan._son_hat(torch.tensor(xi), p)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=0, atol=0)
    np.testing.assert_allclose(t_shonan._son_vee(S_t, p).numpy(), xi, rtol=0, atol=0)
    np.testing.assert_allclose(t_shonan._expm_series(S_t).numpy(),
                               np.asarray(j_shonan._expm_series(S_j)), rtol=0, atol=1e-13)
    name_j, name_t = j_shonan.register_son(p), t_shonan.register_son(p)
    assert name_t == name_j == f"SOn{p}"
    mj, mt = j_manifold.get(name_j), t_manifold.get(name_t)
    assert mt.dim == mj.dim == dim
    Q = _random_son(rng, 7, p)
    Qr_j = mj.retract(jnp.asarray(Q), jnp.asarray(xi))
    Qr_t = mt.retract(torch.tensor(Q), torch.tensor(xi))
    np.testing.assert_allclose(Qr_t.numpy(), np.asarray(Qr_j), rtol=0, atol=1e-13)
    np.testing.assert_allclose(mt.local(torch.tensor(Q), Qr_t).numpy(),
                               np.asarray(mj.local(jnp.asarray(Q), Qr_j)), rtol=0, atol=1e-13)
    eye = mt.identity(dtype=torch.float32, device="cpu")
    assert eye.dtype == torch.float32 and torch.equal(eye, torch.eye(p))


def test_shonan_factor_residual_and_jacobian():
    """The level-5 Shonan factors at a perturbed lift: whitened residuals
    and forward-mode Jacobians (d r / d xi of each slot's retract), port
    against jax.jacfwd of the JAX package's factor."""
    p = 5
    jm, tm, _ = _both_measurements(6, 0.05, 1)
    Q = _random_son(np.random.default_rng(9), 6, p)
    tg = t_shonan.lifted_graph(tm, p, F64)
    tv = convert.values_from_arrays({f"SOn{p}": (np.arange(6), Q)}, device="cpu")
    lb = tg.linearize(tv).batches[0]
    ft, retract = j_shonan._shonan_factor(p), j_manifold.get(f"SOn{p}").retract
    w = np.sqrt(np.asarray(jm.kappa))[:, None]

    def one(Qi, Qj, Rij):
        f = lambda d: ft.residual((retract(Qi, d[:10]), retract(Qj, d[10:])), Rij)
        return f(jnp.zeros(20)), jax.jacfwd(f)(jnp.zeros(20))

    r, J = jax.jit(jax.vmap(one))(jnp.asarray(Q[jm.i]), jnp.asarray(Q[jm.j]), jm.R)
    np.testing.assert_allclose(lb.b.numpy(), -w * np.asarray(r), rtol=0, atol=1e-12)
    J = w[:, :, None] * np.asarray(J)
    np.testing.assert_allclose(lb.A[0].numpy(), J[:, :, :10], rtol=0, atol=1e-12)
    np.testing.assert_allclose(lb.A[1].numpy(), J[:, :, 10:], rtol=0, atol=1e-12)
    # the gauge prior's batch follows, named as the JAX package names it
    assert [b.ftype.name for b in tg.batches] == ["Shonan5", "ShonanGauge5"]


def test_certificate_min_eigenvalue():
    jm, tm, _ = _both_measurements(10, 0.05, 3)
    Q = _random_son(np.random.default_rng(2), 10, 4)
    Y = np.transpose(Q[:, :, :3], (0, 2, 1))
    for seed in (0, 5):
        lj = j_shonan.certificate_min_eigenvalue(jm, jnp.asarray(Y), seed=seed)
        lt = t_shonan.certificate_min_eigenvalue(tm, torch.tensor(Y), seed=seed)
        # the shift c: 2 x the largest incident kappa sum + 3 max|Lambda| + 1
        assert abs(lt - lj) <= 1e-9 * 50.0, (lt, lj)


def test_round_solution_gauged():
    """A lifted solution (each rotation lifted, then a common random SO(p)
    on the left): the rounded, gauged rotations are the truth's gauged ones,
    and the port's equal the JAX package's."""
    rng = np.random.default_rng(6)
    _, _, _, _, R_gt = synthetic.ring_rotations(10, 0.0, 0)
    for p in (3, 5):
        G = _random_son(rng, 1, p)[0]
        Q = np.einsum("ij,njk->nik", G, t_shonan.lift(torch.tensor(R_gt), p).numpy())
        Rt = t_shonan.round_solution(torch.tensor(Q)).numpy()
        Rj = np.asarray(j_shonan.round_solution(jnp.asarray(Q)))
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-10)
        gauged = np.einsum("ij,njk->nik", R_gt[0].T, R_gt)
        np.testing.assert_allclose(Rt, gauged, rtol=0, atol=1e-10)


@pytest.mark.parametrize("scene", ["exact", "noisy"])
def test_shonan_averaging(scene):
    """tests/test_sfm_shonan_translation.py's staircase runs: the exact ring
    at p 3-5 (seed 1), the noisy ring at p 4-6 (seed 2)."""
    sigma, seed, p_min, p_max, run_seed = {"exact": (0.0, 0, 3, 5, 1),
                                            "noisy": (0.05, 3, 4, 6, 2)}[scene]
    jm, tm, R_gt = _both_measurements(10, sigma, seed)
    jr = j_shonan.shonan_averaging(jm, p_min=p_min, p_max=p_max, seed=run_seed)
    tr = t_shonan.shonan_averaging(tm, p_min=p_min, p_max=p_max, seed=run_seed)
    assert tr.certified == jr.certified and tr.certified
    assert tr.p_final == jr.p_final
    assert abs(tr.min_eigenvalue - jr.min_eigenvalue) <= 1e-9
    np.testing.assert_allclose(tr.rotations.numpy(), np.asarray(jr.rotations), rtol=0, atol=1e-8)
    assert tr.cost == pytest.approx(jr.cost, rel=1e-8, abs=1e-12)
    gauged = np.einsum("ij,njk->nik", R_gt[0].T, R_gt)
    err = max(np.linalg.norm(j_so3.logmap(jnp.asarray(g.T @ r)))
              for g, r in zip(gauged, tr.rotations.numpy()))
    assert err < (1e-5 if scene == "exact" else 0.2), err


def test_measurements_from_between_graph():
    va, fa = synthetic.sphere_rings(3, 4, seed=0)
    from test_torch_factor_graph import jax_from_arrays

    jg, _ = jax_from_arrays(va, fa)
    jm = j_shonan.measurements_from_between_graph(jg)
    tm = t_shonan.measurements_from_between_graph(convert.graph_from_arrays(fa, device="cpu"))
    np.testing.assert_array_equal(tm.i, jm.i)
    np.testing.assert_array_equal(tm.j, jm.j)
    np.testing.assert_allclose(tm.R.numpy(), np.asarray(jm.R), rtol=0, atol=0)
    np.testing.assert_allclose(tm.kappa.numpy(), np.asarray(jm.kappa), rtol=1e-15)
    assert tm.num_nodes == jm.num_nodes == 12 and tm.num_edges == jm.num_edges


def test_lifted_multifrontal_route_p5():
    """Level 5 on a small ring by the multifrontal route (the bucket
    kernels' plain versions here) against the dense route, from the same
    lift: each node's SO(2) block is invisible to the cost, so LM's trials
    at small lambda clamp those pivots and are rejected; both routes reach
    the same cost and the same rounded rotations (port only; rel 1e-6,
    atol 1e-6)."""
    _, tm, _ = _both_measurements(8, 0.05, 4)
    rng = np.random.default_rng(3)
    R0 = torch.tensor(_random_son(rng, 8, 3))
    Q0 = t_manifold.get(t_shonan.register_son(5)).retract(
        t_shonan.lift(R0, 5), torch.tensor(rng.normal(size=(8, 10)) * 0.01))
    out = {}
    for solver in ("dense", "multifrontal"):
        vals, cost = t_shonan.optimize_at_p(
            tm, 5, Q0, t_opt.LMParams(solver=solver, max_iterations=60))
        out[solver] = (cost, t_shonan.round_solution(vals.params("SOn5")))
    assert out["multifrontal"][0] == pytest.approx(out["dense"][0], rel=1e-6, abs=1e-10)
    np.testing.assert_allclose(out["multifrontal"][1].numpy(), out["dense"][1].numpy(),
                               rtol=0, atol=1e-6)


# --- MFAS and translation recovery -----------------------------------------------


def _four_node_scene():
    """tests/test_sfm_shonan_translation.py's scene: 4 nodes, every pair,
    edge 1 reversed."""
    t_gt = np.array([[0, 0, 0], [1, 0, 0], [2, 0.5, 0], [3, 0, 1]], float)
    edges, dirs = [], []
    for i in range(4):
        for j in range(i + 1, 4):
            d = t_gt[j] - t_gt[i]
            edges.append((i, j))
            dirs.append(d / np.linalg.norm(d))
    dirs[1] = -dirs[1]
    return edges, np.asarray(dirs)


def _random_direction_graph(n=30, seed=0):
    """A random 30-node graph: a spanning chain plus random pairs, the true
    directions with noise, 10% reversed, node ids shuffled and sparse."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 5
    ids = rng.permutation(n) * 7 + 3
    pairs = {(k, k + 1) for k in range(n - 1)}
    while len(pairs) < 4 * n:
        a, b = rng.choice(n, size=2, replace=False)
        pairs.add((int(a), int(b)))
    pairs = sorted(pairs)
    dirs = np.array([pos[b] - pos[a] for a, b in pairs]) + rng.normal(size=(len(pairs), 3)) * 0.1
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    flip = rng.random(len(pairs)) < 0.1
    dirs[flip] *= -1
    return [(int(ids[a]), int(ids[b])) for a, b in pairs], dirs


@pytest.mark.parametrize("scene", ["chain", "four_nodes", "random30"])
def test_mfas(scene):
    if scene == "chain":
        edges, ws = [(0, 1), (1, 2), (2, 3), (0, 2)], [[1.0, 1.0, 1.0, 1.0]]
        dirs = None
    else:
        edges, dirs = _four_node_scene() if scene == "four_nodes" else _random_direction_graph()
        axes = np.random.default_rng(1).normal(size=(5, 3))
        ws = [dirs @ a for a in axes]
    for w in ws:
        order = t_translation.mfas_ordering(edges, w)
        assert order == j_translation.mfas_ordering(edges, w)
    if scene == "chain":
        pos = {n: i for i, n in enumerate(order)}
        assert pos[0] < pos[1] < pos[2] < pos[3]
        return
    wt = t_translation.mfas_outlier_weights(edges, dirs)
    np.testing.assert_array_equal(wt, j_translation.mfas_outlier_weights(edges, dirs))
    if scene == "four_nodes":
        assert np.argmax(wt) == 1, wt


def test_recover_translations():
    """tests/test_sfm_shonan_translation.py's five nodes, every pair: the
    gauge (node 0 at the origin, the first edge at length 2) gives the
    truth; port against the JAX package."""
    t_gt = np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 1], [1, 1, 2]], float)
    edges, dirs = [], []
    for i in range(5):
        for j in range(i + 1, 5):
            d = t_gt[j] - t_gt[i]
            edges.append((i, j))
            dirs.append(d / np.linalg.norm(d))
    jv = j_translation.recover_translations(edges, np.asarray(dirs), scale_anchor=2.0)
    tv = t_translation.recover_translations(edges, np.asarray(dirs), scale_anchor=2.0,
                                            device="cpu")
    est = tv.params("Point3").numpy()
    np.testing.assert_allclose(est, t_gt, atol=1e-4)
    np.testing.assert_allclose(est, np.stack([np.asarray(jv.at(n)) for n in range(5)]),
                               rtol=0, atol=1e-8)
    # the multifrontal route (d = 3) reaches the same translations
    mv = t_translation.recover_translations(edges, np.asarray(dirs), scale_anchor=2.0,
                                            params=t_opt.LMParams(solver="multifrontal",
                                                                  max_iterations=60),
                                            device="cpu")
    np.testing.assert_allclose(mv.params("Point3").numpy(), est, rtol=0, atol=1e-8)


def test_entry_points_raise_without_cuda():
    """device= defaults to "cuda": without a card the new entry points
    raise; those that follow their data's device run where it lives."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    i, j, R, k, _ = synthetic.ring_rotations(6)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.shonan_measurements(i, j, R, k)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_translation.recover_translations([(0, 1)], np.array([[1.0, 0.0, 0.0]]))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.values_from_arrays({"SOn4": (np.arange(2), np.eye(4)[None].repeat(2, 0))})
    with pytest.raises(RuntimeError, match="CUDA"):
        t_manifold.get(t_shonan.register_son(4)).identity()
    tm = convert.shonan_measurements(i, j, R, k, device="cpu")
    res = t_shonan.shonan_averaging(tm, p_min=3, p_max=3)
    assert res.rotations.device.type == "cpu"
