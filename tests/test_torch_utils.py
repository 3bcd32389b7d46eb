"""The port's utilities against the JAX package's: g2o / TORO I/O
(utils/dataset.py), the timers, debug flags and DOT writer, the solver
comparer, and parallel/partition.clear_solver_cache.

Files are the repository's own (tests/data/ref_noisyToyGraph_optimized.g2o)
or written here from np.random.default_rng(seed) graphs; the port runs on
the CPU in float64. Tolerances: parsed values, measurements and square-root
informations equal the JAX package's to 1e-12 (both parse the same text
with float()); a graph's error at read values 1e-9 relative; the DOT text,
write_g2o's text and the comparer's compare / perturb output are equal.
"""

import os

import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.parallel import partition as t_part
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_torch.utils import dataset as t_ds
from gtsam_petercdev_torch.utils import debug as t_debug
from gtsam_petercdev_torch.utils import dot as t_dot
from gtsam_petercdev_torch.utils import solver_comparer as t_cmp
from gtsam_petercdev_torch.utils import timing as t_timing
from gtsam_petercdev_tpu.utils import dataset as j_ds
from gtsam_petercdev_tpu.utils import dot as j_dot
from gtsam_petercdev_tpu.utils import solver_comparer as j_cmp
from test_torch_factor_graph import jax_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, "tests", "data", "ref_noisyToyGraph_optimized.g2o")
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(p):
    """A value's or measurement's arrays (Pose3: R, t)."""
    return [np.asarray(p)] if not isinstance(p, tuple) else [np.asarray(a) for a in p]


def _tensors(p):
    return [p.cpu().numpy()] if torch.is_tensor(p) else [a.cpu().numpy() for a in p]


def assert_read_equal(path, is3D=False):
    """read_g2o of both packages: the same values, factor keys,
    measurements and square-root informations."""
    tg, tv = t_ds.read_g2o(path, is3D=is3D, device="cpu")
    jg, jv = j_ds.read_g2o(path, is3D=is3D)
    jg._materialize()
    tg._materialize()
    assert tv.types() == jv.types()
    for t in tv.types():
        assert tv.type_keys(t) == [int(k) for k in jv.type_keys(t)]
        for a, b in zip(_tensors(tv.params(t)), _leaves(jv.params(t))):
            np.testing.assert_allclose(a, b, atol=TOL)
    assert len(tg.batches) == len(jg.batches)
    for tb, jb in zip(tg.batches, jg.batches):
        assert tb.ftype.name == jb.ftype.name
        np.testing.assert_array_equal(tb.keys, np.asarray(jb.keys))
        for a, b in zip(_tensors(tb.params), _leaves(jb.params)):
            np.testing.assert_allclose(a, b, atol=TOL)
        np.testing.assert_allclose(tb.sqrt_info.numpy(), np.asarray(jb.sqrt_info), atol=TOL)
    return tg, tv


def test_read_g2o_toy_graph_matches_jax():
    """The repository's noisyToyGraph golden (VERTEX_SE2 / EDGE_SE2) reads
    the same in both packages, and LM from it stays at its optimum."""
    tg, tv = assert_read_equal(TOY)
    assert len(tv) == 4
    r = t_opt.levenberg_marquardt(tg, tv, t_opt.LMParams(solver="multifrontal"), device="cpu")
    assert r.error <= r.error_history[0] + 1e-12


TORO_2D = """VERTEX2 0 0.0 0.0 0.0
VERTEX2 1 1.0 0.1 0.2
VERTEX2 2 2.1 0.0 0.4
EDGE2 0 1 1.0 0.1 0.2 50 1 40 30 2 3
EDGE2 1 2 1.1 -0.2 0.2 50 0 50 100 0 0
EDGE2 0 2 2.0 0.3 0.4 10 0.5 12 8 0.1 0.2
"""

TORO_3D = """VERTEX3 0 0 0 0 0 0 0
VERTEX3 1 1.0 0.2 -0.1 0.05 -0.02 0.3
EDGE3 0 1 1.0 0.2 -0.1 0.05 -0.02 0.3 100 0 0 0 0 0 100 0 0 0 0 100 0 0 0 400 0 0 400 0 400
"""

TORO_3D_NO_VERTICES = """EDGE3 0 1 1.0 0.0 0.0 0.0 0.0 0.3 1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 1 0 0 1 0 1
EDGE3 1 2 1.0 0.0 0.0 0.1 0.0 0.3 1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 1 0 0 1 0 1
"""


@pytest.mark.parametrize("text,is3D", [(TORO_2D, False), (TORO_3D, True),
                                       (TORO_3D_NO_VERTICES, True)])
def test_read_toro_matches_jax(tmp_path, text, is3D):
    """TORO EDGE2 (its info order), VERTEX3 / EDGE3 (yaw-pitch-roll, info
    unreordered) and a vertex-less file (initialize_from_odometry)."""
    path = tmp_path / "toro.graph"
    path.write_text(text)
    assert_read_equal(str(path), is3D)


@pytest.mark.parametrize("kind", ["Pose2", "Pose3"])
def test_write_g2o_matches_jax_and_reads_back(tmp_path, kind):
    """write_g2o writes the same text as the JAX package's; read back, the
    values are the written ones to the file's 6 decimals, and the original
    graph's error at them is within 1e-4 relative of its error at the
    originals."""
    if kind == "Pose2":
        lines, _ = synthetic.city_stream(30, seed=1)
        va = {"Pose2": (np.arange(30), np.cumsum(np.random.default_rng(0).normal(
            size=(30, 3)) * 0.1, axis=0))}
        fa = []
    else:
        va, fa = synthetic.sphere_rings(3, 4, seed=2)
    tv = convert.values_from_arrays(va, device="cpu")
    _, jv = jax_from_arrays(va, [])
    tp, jp = tmp_path / "port.g2o", tmp_path / "jax.g2o"
    t_ds.write_g2o(None, tv, str(tp))
    j_ds.write_g2o(None, jv, str(jp))
    assert tp.read_text() == jp.read_text()
    _, rv = assert_read_equal(str(tp), is3D=kind == "Pose3")
    for a, b in zip(_tensors(rv.params(kind)), _tensors(tv.params(kind))):
        np.testing.assert_allclose(a, b, atol=2e-6)
    if fa:
        tg = convert.graph_from_arrays(fa, device="cpu")
        e0, e1 = float(tg.error(tv)), float(tg.error(rv))
        assert abs(e1 - e0) <= 1e-4 * max(e0, 1.0)


def test_find_example_data_raises_for_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_ds.find_example_data("no_such_dataset_here.g2o", data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        t_ds.find_example_data("no_such_dataset_here.g2o")


def test_find_example_data_searches_the_given_dir_then_tests_data(tmp_path):
    """A name is found in the caller's directory, else in the checkout's
    tests/data, and nowhere outside the checkout."""
    (tmp_path / "mine.g2o").write_text("")
    assert t_ds.find_example_data("mine.g2o", data_dir=str(tmp_path)) == str(tmp_path / "mine.g2o")
    found = t_ds.find_example_data(os.path.basename(TOY))
    assert os.path.samefile(found, TOY)


def test_timing_debug_dot():
    """Nested tic spans count and nest as the JAX package's; debug flags;
    graph_to_dot writes the same text as the JAX package's."""
    t_timing.tictoc_reset()
    with t_timing.tic("outer"):
        for _ in range(2):
            with t_timing.tic("inner"):
                pass
    assert t_timing.tictoc_get("outer").n == 1
    assert t_timing.tictoc_get("outer/inner").n == 2
    assert t_timing.tictoc_get("outer/missing") is None
    t_timing.tictoc_reset()
    assert t_timing.tictoc_get("outer") is None

    t_debug.clear_debug_flags()
    assert not t_debug.is_debug("x")
    t_debug.set_debug_flag("x")
    assert t_debug.is_debug("x")
    t_debug.clear_debug_flags()
    assert not t_debug.is_debug("x")

    va, fa = synthetic.sphere_rings(2, 3, seed=0)
    jg, _ = jax_from_arrays(va, fa)
    tg = convert.graph_from_arrays(fa, device="cpu")
    assert t_dot.graph_to_dot(tg, title="toy") == j_dot.graph_to_dot(jg, title="toy")


def _city_g2o(path, n_lines):
    """A City g2o: dead-reckoning VERTEX_SE2 lines (write_g2o) and
    EDGE_SE2 lines of city_stream's measurements under the harness's
    sigmas."""
    lines, _ = synthetic.city_stream(200, seed=0)
    lines = lines[:n_lines]
    n = 1 + sum(int(ln.split()[3]) == int(ln.split()[1]) + 1 for ln in lines)
    x = np.zeros((n, 3))
    edges = []
    for ln in lines:
        p = ln.split()
        a, b, m = int(p[1]), int(p[3]), np.array([float(v) for v in p[6:9]])
        if b == a + 1:
            x[b] = synthetic.pose2_compose_np(x[a], m)
        s = synthetic.CITY_SIGMAS if b == a + 1 else (10.0, 10.0, 10.0)
        info = 1.0 / np.square(s)
        edges.append(f"EDGE_SE2 {a} {b} {m[0]:.9f} {m[1]:.9f} {m[2]:.9f} "
                     f"{info[0]} 0 0 {info[1]} 0 {info[2]}")
    t_ds.write_g2o(None, convert.values_from_arrays({"Pose2": (np.arange(n), x)}, device="cpu"),
                   str(path))
    with open(path, "a") as f:
        f.write("\n".join(edges) + "\n")


def test_solver_comparer_batch_incremental_compare_perturb(tmp_path, capsys):
    """The comparer on a 60-line City file: batch LM and incremental ISAM2
    reach the same poses (translation diff < 1e-3 m), and compare / perturb
    print and write what the JAX package's do on the same solutions."""
    g2o = tmp_path / "city.g2o"
    _city_g2o(g2o, 60)
    a, b = str(tmp_path / "batch.npz"), str(tmp_path / "incr.npz")
    t_cmp.main(["--batch", "-d", str(g2o), "-o", a, "--device", "cpu", "--iterations", "30"])
    t_cmp.main(["--incremental", "-d", str(g2o), "-o", b, "--device", "cpu",
                "--relinearize-skip", "1"])
    capsys.readouterr()
    d = t_cmp.main(["--compare", a, b, "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert d.max() < 1e-3
    j_cmp.main(["--compare", a, b])
    assert port_out == capsys.readouterr().out
    pa, pj = str(tmp_path / "pert_port.npz"), str(tmp_path / "pert_jax.npz")
    t_cmp.main(["--perturb", a, "-o", pa, "--device", "cpu"])
    j_cmp.main(["--perturb", a, "-o", pj])
    np.testing.assert_array_equal(np.load(pa)["sol"], np.load(pj)["sol"])


def test_clear_solver_cache_replans(monkeypatch):
    """A partitioned solve caches its solver on the graph; after
    clear_solver_cache the next solve builds its plan again."""
    va, fa = synthetic.sphere_rings(3, 4, seed=0)
    g = convert.graph_from_arrays(fa, device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    plans = []
    build = t_part.build_partitioned_plan
    monkeypatch.setattr(t_part, "build_partitioned_plan",
                        lambda *a, **kw: plans.append(1) or build(*a, **kw))
    x0, _ = t_part.solve_linearized(g, v, 1e-3, n_parts=2)
    t_part.solve_linearized(g, v, 1e-3, n_parts=2)
    assert len(plans) == 1 and "_partitioned_solvers" in g.__dict__
    t_part.clear_solver_cache()
    assert "_partitioned_solvers" not in g.__dict__
    x1, _ = t_part.solve_linearized(g, v, 1e-3, n_parts=2)
    assert len(plans) == 2
    for t in x0:
        np.testing.assert_allclose(x1[t].numpy(), x0[t].numpy(), atol=1e-12)


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ds.read_g2o(TOY)
    g2o = tmp_path / "city.g2o"
    _city_g2o(g2o, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cmp.main(["--batch", "-d", str(g2o)])
