"""The port's discrete and hybrid inference against the JAX package's
(discrete/discrete.py, discrete/search.py, hybrid/hybrid.py,
hybrid/incremental.py, models/hybrid_city.py) and the Hybrid City stream.

Inputs come from np.random.default_rng(seed) or are the JAX tests' own
problems; the port runs on the CPU in float64. The discrete tests and the
small dense hybrid graphs run both packages here. The JAX package's sparse
elimination, its HybridSmoother on the switching chain and its Hybrid City
harness spend most of their time compiling (~15 s, ~9 s, ~22 s), so their
results on the same inputs come from tests/data/hybrid_reference.json,
written by tools/hybrid_reference.py. Tolerances: discrete tables, MPE
values, marginals and k-best values 1e-12; hybrid log-probabilities and
solutions 1e-9 (dense and sparse, the full grid and a restricted set);
Hybrid City posterior and trajectory 1e-8. The tests of tests/test_discrete.py,
tests/test_hybrid.py and test_utils_extra.py's k_best cases are mirrored.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.discrete import discrete as t_disc
from gtsam_petercdev_torch.discrete import search as t_search
from gtsam_petercdev_torch.hybrid import hybrid as t_hyb
from gtsam_petercdev_torch.hybrid import incremental as t_inc
from gtsam_petercdev_torch.inference import elimination
from gtsam_petercdev_torch.models import hybrid_city as t_city
from gtsam_petercdev_torch.ops import cholesky, cholesky_v2
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.discrete import discrete as j_disc
from gtsam_petercdev_tpu.discrete import search as j_search
from gtsam_petercdev_tpu.hybrid import hybrid as j_hyb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "tests", "data", "hybrid_reference.json")
TAB_TOL = 1e-12
HYB_TOL = 1e-9
CITY_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One intra-op thread while this module runs (small batched products
    cost more across threads); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


def t_discrete(jg):
    """A JAX DiscreteFactorGraph carried across as numpy arrays."""
    return convert.discrete_graph_from_arrays(
        [([(k, jg.cards[k]) for k in f.keys], np.asarray(f.table)) for f in jg.factors],
        device="cpu")


def t_hybrid(jg):
    """A JAX HybridGaussianFactorGraph carried across as numpy arrays."""
    terms = [(t.cont_keys, [np.asarray(a) for a in t.A], np.asarray(t.b), t.disc_keys,
              np.asarray(t.log_norm)) for t in jg.gaussians]
    return convert.hybrid_graph_from_arrays(dict(jg.cont_dims), dict(jg.disc_cards), terms,
                                            [(k, np.asarray(t)) for k, t in jg.discrete],
                                            device="cpu")


def spec_graph(spec):
    """The port's graph from the reference file's lists."""
    dims = {int(k): v for k, v in spec["cont_dims"].items()}
    cards = {int(k): v for k, v in spec["disc_cards"].items()}
    terms = [(ck, [np.asarray(a) for a in A], np.asarray(b), dk, np.asarray(ln))
             for ck, A, b, dk, ln in spec["terms"]]
    return convert.hybrid_graph_from_arrays(dims, cards, terms,
                                            [(k, np.asarray(t)) for k, t in spec["discrete"]],
                                            device="cpu")


def assert_bn(tb, jb, tol=HYB_TOL):
    """Port HybridBayesNet == a JAX one (or its reference-file dict)."""
    get = (lambda k: np.asarray(jb[k])) if isinstance(jb, dict) else (
        lambda k: np.asarray(getattr(jb, k)))
    np.testing.assert_array_equal(tb.assignments, get("assignments"))
    np.testing.assert_allclose(tb.log_probs.numpy(), get("log_probs"), atol=tol, rtol=0)
    np.testing.assert_allclose(tb.solutions.numpy(), get("solutions"), atol=tol, rtol=0)


# --- discrete ------------------------------------------------------------------------------


def _random_discrete(seed, cards, pairs):
    rng = np.random.default_rng(seed)
    jg = j_disc.DiscreteFactorGraph()
    for i, c in enumerate(cards):
        jg.add([(i, c)], rng.uniform(0.1, 1.0, c))
    for a, b in pairs:
        jg.add([(a, cards[a]), (b, cards[b])], rng.uniform(0.1, 1.0, (cards[a], cards[b])))
    return jg


CHAIN = ([2, 3, 2, 3, 2, 2], [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 5)])
LOOPY = ([2, 3, 2, 2], [(0, 1), (1, 2), (2, 3), (0, 3)])


@pytest.mark.parametrize("seed,shape", [(0, CHAIN), (1, LOOPY), (2, ([4, 2, 3], [(0, 1), (1, 2)]))])
def test_discrete_mpe_marginals_joint_match_jax(seed, shape):
    """MPE (max-product, same tie-breaking), every marginal, the joint and
    evaluate equal the JAX package's; the MPE value equals the brute-force
    maximum."""
    cards, pairs = shape
    jg = _random_discrete(seed, cards, pairs)
    tg = t_discrete(jg)
    assert tg.optimize() == jg.optimize()
    for k in range(len(cards)):
        np.testing.assert_allclose(tg.marginal(k).numpy(), np.asarray(jg.marginal(k)),
                                   atol=TAB_TOL)
    np.testing.assert_allclose(tg.joint().normalized().table.numpy(),
                               np.asarray(jg.joint().normalized().table), atol=TAB_TOL)
    best = max(tg.evaluate(dict(enumerate(a))) for a in itertools.product(*map(range, cards)))
    assert abs(tg.evaluate(tg.optimize()) - best) <= TAB_TOL
    asg = {k: c - 1 for k, c in enumerate(cards)}
    assert abs(tg.evaluate(asg) - jg.evaluate(asg)) <= TAB_TOL


@pytest.mark.parametrize("op", ["sum", "max"])
def test_discrete_bayes_net_matches_jax(op):
    """eliminate_sequential's conditionals (tables, parents, argmax) and the
    Bayes net's optimize / evaluate equal the JAX package's."""
    jg = _random_discrete(3, *LOOPY)
    order = [2, 0, 3, 1]
    jb = jg.eliminate_sequential(order, op=op)
    tb = t_discrete(jg).eliminate_sequential(order, op=op)
    for tc, jc in zip(tb.conditionals, jb.conditionals):
        assert (tc.frontal, tc.parents) == (jc.frontal, jc.parents)
        np.testing.assert_allclose(tc.table.numpy(), np.asarray(jc.table), atol=TAB_TOL)
        if op == "max":
            np.testing.assert_array_equal(tc.argmax.numpy(), np.asarray(jc.argmax))
    assert tb.optimize() == jb.optimize()
    asg = tb.optimize()
    assert abs(tb.evaluate(asg) - jb.evaluate(asg)) <= TAB_TOL


def test_discrete_ties_break_like_jax():
    """Equal table entries: the first maximum wins in both packages."""
    jg = j_disc.DiscreteFactorGraph()
    jg.add([(0, 3)], [0.5, 0.5, 0.5])
    jg.add([(0, 3), (1, 2)], [0.2, 0.2, 0.7, 0.7, 0.2, 0.2])
    assert t_discrete(jg).optimize() == jg.optimize() == {0: 1, 1: 0}


def test_bayes_net_sampling_frequency():
    """Ancestral sampling: the port's torch.Generator draws and the JAX
    package's numpy draws give the same frequencies (both within 0.03 of
    P(A) = (0.25, 0.75)); the streams differ, so they are compared by
    frequency, not draw for draw."""
    jg = j_disc.DiscreteFactorGraph()
    jg.add([(0, 2)], [0.25, 0.75])
    jg.add([(0, 2), (1, 2)], [0.9, 0.1, 0.3, 0.7])
    n = 4000
    jb = jg.eliminate_sequential([1, 0])
    rng = np.random.default_rng(2)
    jf = np.bincount([jb.sample(rng)[0] for _ in range(n)], minlength=2) / n
    tb = t_discrete(jg).eliminate_sequential([1, 0])
    gen = torch.Generator().manual_seed(2)
    tf = np.bincount([tb.sample(gen)[0] for _ in range(n)], minlength=2) / n
    np.testing.assert_allclose(tf, [0.25, 0.75], atol=0.03)
    np.testing.assert_allclose(tf, jf, atol=0.04)


def test_signature_table_matches_jax():
    for spec, card, parents in (("4/1 1/4", 2, [2]), ("1/2/3 3/2/1 1/1/1 2/1/1", 3, [2, 2])):
        np.testing.assert_array_equal(t_disc.signature_table(spec, card, parents),
                                      j_disc.signature_table(spec, card, parents))


@pytest.mark.parametrize("K", [1, 4, 10])
def test_k_best_matches_jax_and_brute_force(K):
    """DiscreteSearch is exact: the port's K best equal the JAX package's
    and the brute-force enumeration, in order."""
    jg = _random_discrete(0, *CHAIN)
    tg = t_discrete(jg)
    ts, js = t_search.k_best(tg, K), j_search.k_best(jg, K)
    cards = CHAIN[0]
    brute = sorted(((tg.evaluate(dict(enumerate(a))), dict(enumerate(a)))
                    for a in itertools.product(*map(range, cards))), key=lambda x: -x[0])
    assert [s.assignment for s in ts] == [s.assignment for s in js] == [b[1] for b in brute[:K]]
    np.testing.assert_allclose([s.value for s in ts], [s.value for s in js], atol=TAB_TOL)


def test_k_best_max_expansions_raises():
    tg = t_discrete(_random_discrete(0, *CHAIN))
    with pytest.raises(RuntimeError, match="expansions"):
        t_search.k_best(tg, 50, max_expansions=3)


# --- hybrid: the dense path ----------------------------------------------------------------


def _normal_pdf(x, mu, var):
    return np.exp(-0.5 * (x - mu) ** 2 / var) / np.sqrt(2 * np.pi * var)


def _mode_graph(s0, s1, A_sign, z, prior_mean):
    g = j_hyb.HybridGaussianFactorGraph()
    g.add_continuous([(0, 1)], [jnp.asarray([[1.0]])], jnp.asarray([prior_mean]))
    A = jnp.asarray([[[1.0 / s0]], [[A_sign / s1]]])
    b = jnp.asarray([[z / s0], [z / s1]])
    g.add_hybrid([(0, 1)], [(10, 2)], [A], b, log_norm=jnp.log(jnp.asarray([1 / s0, 1 / s1])))
    g.add_discrete([(10, 2)], [0.5, 0.5])
    return g


@pytest.mark.parametrize("case", ["mode_selection", "noise_scales"])
def test_dense_posterior_matches_jax_and_closed_form(case):
    """The JAX tests' two CLG cases: x ~ N(1, 1), z = 2 under z = x / z = -x;
    x ~ N(0, 1), z = 2 under sigma 1 / 10. The port's posterior and solution
    equal the JAX package's and the closed-form evidence."""
    if case == "mode_selection":
        jg = _mode_graph(1.0, 1.0, -1.0, 2.0, 1.0)
        expected = np.array([_normal_pdf(2, 1, 2), _normal_pdf(2, -1, 2)])
    else:
        jg = _mode_graph(1.0, 10.0, 1.0, 2.0, 0.0)
        expected = np.array([_normal_pdf(2, 0, 2), _normal_pdf(2, 0, 101)])
    jb, tb = jg.eliminate(), t_hybrid(jg).eliminate()
    assert_bn(tb, jb)
    np.testing.assert_allclose(tb.discrete_marginal(10).numpy(), expected / expected.sum(),
                               rtol=1e-9)
    asg, cont = tb.optimize()
    assert asg == jb.optimize()[0] == {10: 0}
    if case == "mode_selection":
        np.testing.assert_allclose(cont[0].numpy(), [1.5], atol=1e-9)


def _switching_chain(HG, device=None):
    """The JAX test's 3-step switching system x_{t+1} = x_t + u(m_t)."""
    u = {0: 1.0, 1: -1.0}
    x_true = [0.0, 1.0, 0.0]
    g = HG() if device is None else HG(device=device)
    g.add_continuous([(0, 1)], [np.asarray([[100.0]])], np.asarray([0.0]))
    for t, xt in enumerate(x_true):
        g.add_continuous([(t, 1)], [np.asarray([[10.0]])], np.asarray([10.0 * xt]))
    for t in range(2):
        A = np.asarray([[[-10.0]], [[-10.0]]])
        A2 = np.asarray([[[10.0]], [[10.0]]])
        b = np.asarray([[10.0 * u[0]], [10.0 * u[1]]])
        g.add_hybrid([(t, 1), (t + 1, 1)], [(100 + t, 2)], [A, A2], b)
        g.add_discrete([(100 + t, 2)], [0.5, 0.5])
    return g, x_true


def test_switching_chain_map_and_prune():
    """MPE of the switching chain (true modes 0, 1), its solution, and prune
    to 2: the port against its own closed-form truth and against the sparse
    route on the same graph."""
    g, x_true = _switching_chain(t_hyb.HybridGaussianFactorGraph, "cpu")
    bn = g.eliminate()
    asg, cont = bn.optimize()
    assert [asg[100], asg[101]] == [0, 1]
    for t, xt in enumerate(x_true):
        assert abs(float(cont[t][0]) - xt) < 0.05
    pruned = bn.prune(2)
    assert pruned.optimize()[0] == asg
    np.testing.assert_allclose(float(torch.exp(pruned.log_probs).sum()), 1.0, atol=1e-9)
    sp = t_hyb.eliminate_sparse(g)
    np.testing.assert_allclose(sp.log_probs.numpy(), bn.log_probs.numpy(), atol=1e-8)
    np.testing.assert_allclose(sp.solutions.numpy(), bn.solutions.numpy(), atol=1e-8)


# --- hybrid: the sparse path (the hypotheses folded into the buckets) ---------------------


@pytest.mark.parametrize("restricted", [False, True])
def test_eliminate_matches_jax_reference(ref, restricted):
    """A 12-variable chain (dims 3 and 2) with three hybrid terms (M = 12,
    or a restricted set of 5): the port's dense and sparse posteriors and
    solutions equal the JAX package's dense and sparse ones."""
    r = ref["sparse"]
    g = spec_graph(r["spec"])
    asg = r["restricted"] if restricted else None
    sfx = "_restricted" if restricted else ""
    assert_bn(g.eliminate(asg), r["dense" + sfx])
    assert_bn(t_hyb.eliminate_sparse(g, asg), r["sparse" + sfx])
    tb = t_hyb.eliminate_sparse(g, asg)
    jm = r["sparse" + sfx]["mpe"]
    assert tb.optimize()[0] == {int(k): v for k, v in jm.items()}


def test_eliminate_sparse_one_kernel_call_per_bucket(ref, monkeypatch):
    """The M = 12 hypotheses go through each bucket together: one partial
    Cholesky call and one backsolve call a bucket, each over M * B cliques,
    and no Python loop over hypotheses."""
    calls = []

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, a[0].shape[0]))
            return fn(*a, **kw)
        return wrapped

    for mod, name in ((cholesky, "partial_cholesky"), (cholesky, "partial_cholesky_blocks"),
                      (cholesky_v2, "partial_cholesky"), (cholesky_v2, "backsolve_bucket")):
        monkeypatch.setattr(mod, name, counting(f"{mod.__name__}.{name}", getattr(mod, name)))
    planned = []
    build = elimination.build_numeric_maps
    monkeypatch.setattr(elimination, "build_numeric_maps",
                        lambda *a, **kw: planned.append(build(*a, **kw)) or planned[-1])
    g = spec_graph(ref["sparse"]["spec"])
    t_hyb.eliminate_sparse(g)
    (maps,) = planned
    M = 12
    factor = [c for c in calls if not c[0].endswith("backsolve_bucket")]
    back = [c for c in calls if c[0].endswith("backsolve_bucket")]
    assert len(factor) == len(back) == len(maps.buckets)
    assert sorted(n for _, n in back) == sorted(M * bm.B for bm in maps.buckets)


def test_hybrid_smoother_matches_jax_reference(ref):
    """HybridSmoother on the switching chain at max_leaves 8 (the full
    grid), 2 (aggressive pruning) and with every update through the sparse
    route (dense_dim_limit 2) against the JAX package's."""
    r = ref["smoother"]
    for name, run in r["runs"].items():
        sm = t_inc.HybridSmoother(**run["kwargs"], device="cpu")
        for t, xt in enumerate(r["xs"]):
            sm.update(_smoother_slice(t, xt))
        assert_bn(sm.bayes_net, run)
        asg, cont = sm.optimize()
        assert asg == {int(k): v for k, v in run["mpe"].items()}, name
        for k, v in run["cont"].items():
            np.testing.assert_allclose(cont[int(k)].numpy(), v, atol=HYB_TOL)
        assert sm._hyp.shape[0] <= run["kwargs"]["max_leaves"]


def _smoother_slice(t, xt):
    g = t_hyb.HybridGaussianFactorGraph(device="cpu")
    if t == 0:
        g.add_continuous([(0, 1)], [np.asarray([[100.0]])], np.asarray([0.0]))
    g.add_continuous([(t, 1)], [np.asarray([[10.0]])], np.asarray([10.0 * xt]))
    if t > 0:
        g.add_hybrid([(t - 1, 1), (t, 1)], [(100 + t, 2)],
                     [np.asarray([[[-1.0]], [[-1.0]]]), np.asarray([[[1.0]], [[1.0]]])],
                     np.asarray([[1.0], [-1.0]]))
        g.add_discrete([(100 + t, 2)], [0.5, 0.5])
    return g


def test_hybrid_gaussian_isam_alias():
    isam = t_inc.HybridGaussianISAM(max_leaves=4, device="cpu")
    g = t_hyb.HybridGaussianFactorGraph(device="cpu")
    g.add_continuous([(0, 1)], [np.asarray([[1.0]])], np.asarray([1.0]))
    _, cont = isam.update(g).optimize()
    np.testing.assert_allclose(cont[0].numpy(), [1.0], atol=1e-12)


# --- Hybrid City ---------------------------------------------------------------------------


def test_hybrid_city_stream_truth(tmp_path):
    """The stream is city_stream's with ambiguity added: every line parses
    (models/city10000.parse_city10000), the true candidate of an ambiguous
    odometry line is city_stream's measurement, and a false loop closure
    points at another earlier pose than the true one."""
    from gtsam_petercdev_torch.models.city10000 import parse_city10000

    base, gt0 = synthetic.city_stream(300, seed=3)
    lines, gt, truth = synthetic.hybrid_city_stream(300, seed=3, p_ambiguous=0.3,
                                                    p_false_loop=0.5)
    np.testing.assert_array_equal(gt, gt0)
    assert len(lines) == len(base)
    path = tmp_path / "stream.txt"
    path.write_text("\n".join(lines) + "\n")
    parsed = parse_city10000(str(path))
    n_amb = n_false = 0
    for (a, b, meas), ln, cand, ok in zip(parsed, base, truth["candidate"], truth["loop_true"]):
        pa = ln.split()
        true_meas = tuple(float(x) for x in pa[6:9])
        np.testing.assert_allclose(meas[cand], true_meas, atol=1e-12)
        n_amb += len(meas) > 1
        if not ok:
            n_false += 1
            assert a != int(pa[1]) and b == int(pa[3]) and a < b - 1
    assert n_amb > 10 and n_false > 5


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_hybrid_city_matches_jax_reference(ref, backend, tmp_path):
    """run_hybrid_city on 40 lines (five binary loop modes, one loop false;
    max_hypotheses 4) on the card engine's CPU path and on the host engine:
    the same choices as the JAX harness, the posterior and the best
    hypothesis's trajectory within 1e-8."""
    r = ref["city"]
    cfg = r["config"]
    lines, _, _ = synthetic.hybrid_city_stream(cfg["n_poses"], cfg["seed"], cfg["p_ambiguous"],
                                               cfg["p_false_loop"])
    assert lines[: cfg["lines"]] == r["lines"]
    path = tmp_path / "city.txt"
    path.write_text("\n".join(r["lines"]) + "\n")
    out = t_city.run_hybrid_city(str(path), cfg["lines"], max_hypotheses=cfg["max_hypotheses"],
                                 progress=0, device="cpu", engine_backend=backend)
    assert (out["poses"], out["modes"], out["live_hypotheses"]) == (
        r["poses"], r["modes"], r["live_hypotheses"])
    assert out["best_loop_accept_frac"] == r["best_loop_accept_frac"]
    np.testing.assert_allclose(out["posterior"], r["posterior"], atol=CITY_TOL, rtol=0)
    np.testing.assert_allclose(out["traj"], np.asarray(r["traj"]), atol=CITY_TOL, rtol=0)


def test_hybrid_city_forks_match_jax_reference(ref, tmp_path):
    """Two ambiguous odometry lines fork four hypotheses through the
    serializer; none is pruned, and with no loop to tell them apart they
    tie: the posterior is the JAX harness's (four times 0.25) within 1e-8."""
    r = ref["city_forks"]
    path = tmp_path / "forks.txt"
    path.write_text("\n".join(r["lines"]) + "\n")
    out = t_city.run_hybrid_city(str(path), r["config"]["lines"],
                                 max_hypotheses=r["config"]["max_hypotheses"], progress=0,
                                 device="cpu")
    assert (out["modes"], out["live_hypotheses"], out["forks"]) == (r["modes"], 4, 3)
    np.testing.assert_allclose(out["posterior"], r["posterior"], atol=CITY_TOL, rtol=0)


def test_engine_logdet_matches_dense(tmp_path):
    """_engine_logdet of both engines equals log det of the ISAM2's dense
    Hessian at its linearization point."""
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models.city10000 import run_city10000

    lines, _ = synthetic.city_stream(40, seed=0)
    path = tmp_path / "stream.txt"
    path.write_text("\n".join(lines) + "\n")
    got = {}
    for backend in ("torch", "numpy"):
        isam = {}
        run_city10000(str(path), device="cpu", engine_backend=backend,
                      step_cb=lambda k, i: isam.setdefault("isam", i))
        got[backend] = t_city._engine_logdet(isam["isam"])
    isam = isam["isam"]
    H, _ = linsolve.assemble_dense(isam._as_graph().linearize(isam.theta))
    ref_ld = float(torch.linalg.slogdet(H)[1])
    np.testing.assert_allclose([got["torch"], got["numpy"]], [ref_ld, ref_ld], rtol=1e-10)


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    path = tmp_path / "one.txt"
    path.write_text("EDGE2 0 1 1 1 1 1.0 0.0 0.0\n")
    for make in (t_disc.DiscreteFactorGraph, t_hyb.HybridGaussianFactorGraph,
                 t_inc.HybridSmoother, lambda: t_city.run_hybrid_city(str(path), progress=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
