"""The port's checkpoints (utils/serialization.py, run_city10000's
checkpoint_path / resume_from) against the JAX package's files and runs.

Round trips of Values, graphs and solver checkpoints; the JAX package's
Pose2 Values and graph files load in the port; a file that names a class
of another package is refused, never imported; a whole ISAM2 saved and
resumed repeats the uninterrupted run bit for bit (pools, free lists,
message pools and all), on the CPU in float64. No test reads data from
outside the repository: the streams are synthetic (utils/synthetic).

Tolerances: errors rel 1e-12 (the same sums); the resumed City run against
the JAX package's uninterrupted run atol 1e-8, as tests/test_torch_isam2.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.geometry import pose3 as t_pose3
from gtsam_petercdev_torch.linear import noise as t_noise
from gtsam_petercdev_torch.models import city10000 as t_city
from gtsam_petercdev_torch.nonlinear import isam2 as t_isam2
from gtsam_petercdev_torch.nonlinear import optimizers as t_opt
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph as TGraph
from gtsam_petercdev_torch.nonlinear.values import Values as TValues
from gtsam_petercdev_torch.slam import factors as t_factors
from gtsam_petercdev_torch.utils import serialization as t_ser
from gtsam_petercdev_torch.utils import synthetic
from gtsam_petercdev_torch.utils.synthetic import pose2_between_np as between
from gtsam_petercdev_torch.utils.synthetic import pose2_compose_np as compose
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3
from gtsam_petercdev_tpu.models import city10000 as j_city
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph as JGraph
from gtsam_petercdev_tpu.nonlinear.values import Values as JValues
from gtsam_petercdev_tpu.slam import factors as j_factors
from gtsam_petercdev_tpu.utils import serialization as j_ser

PR_INFO = np.eye(3) / 0.01
OD_INFO = np.eye(3) / 0.1


def _problem():
    """tests/test_serialization.py's 4-pose problem as numpy: (values
    [(key, Pose2)], factors [(kind, keys, measurement, sqrt_info, robust)])."""
    rng = np.random.default_rng(2)
    gt = [np.array([float(i), 0.0, 0.1 * i]) for i in range(4)]
    vals = [(i, compose(p, rng.normal(size=3) * 0.1)) for i, p in enumerate(gt)]
    facs = [("Prior", [0], gt[0], PR_INFO, None)] + [
        ("Between", [i, i + 1], between(gt[i], gt[i + 1]), OD_INFO, "huber" if i == 1 else None)
        for i in range(3)]
    return vals, facs


def _port(vals, facs):
    g, v = TGraph(device="cpu"), TValues(device="cpu")
    for k, x in vals:
        v.insert(k, "Pose2", x)
    for kind, keys, m, info, rob in facs:
        g.add(getattr(t_factors, kind.lower() + "_factor")("Pose2"), keys, m, info,
              robust=t_noise.huber(1.345) if rob else None)
    return g, v


def _jax(vals, facs):
    from gtsam_petercdev_tpu.linear import noise as j_noise

    g, v = JGraph(), JValues()
    for k, x in vals:
        v.insert(k, "Pose2", jnp.asarray(x))
    for kind, keys, m, info, rob in facs:
        g.add(getattr(j_factors, kind.lower() + "_factor")("Pose2"), keys, jnp.asarray(m), info,
              robust=j_noise.huber(1.345) if rob else None)
    return g, v


def test_values_graph_checkpoint_roundtrip(tmp_path):
    """Pose2 and Pose3 Values, a graph with a robust loss, and a solver
    checkpoint resumed: the same values, errors rel 1e-12, the same GN."""
    g, v = _port(*_problem())
    rng = np.random.default_rng(3)
    R = t_pose3.expmap(torch.as_tensor(rng.normal(size=(2, 6)) * 0.3)).R
    v6 = _port(*_problem())[1]
    v6.insert_batch([10, 11], "Pose3", t_pose3.Pose3(R, torch.as_tensor(rng.normal(size=(2, 3)))))
    p = str(tmp_path / "values.bin")
    t_ser.save_values(p, v6)
    v2 = t_ser.load_values(p, device="cpu")
    assert sorted(v2.keys()) == sorted(v6.keys())
    assert torch.equal(v2.params("Pose2"), v6.params("Pose2"))
    assert isinstance(v2.params("Pose3"), t_pose3.Pose3)
    assert all(torch.equal(a, b) for a, b in zip(v2.params("Pose3"), v6.params("Pose3")))

    p = str(tmp_path / "graph.bin")
    t_ser.save_graph(p, g)
    g2 = t_ser.load_graph(p, device="cpu")
    assert float(g2.error(v)) == pytest.approx(float(g.error(v)), rel=1e-12)
    assert [b.robust.name for b in g2.batches if b.robust is not None] == ["huber"]

    half = t_opt.gauss_newton(g, v, t_opt.OptimizerParams(max_iterations=1), device="cpu")
    p = str(tmp_path / "ckpt.bin")
    t_ser.save_checkpoint(p, g, half.values, {"iter": torch.tensor(1)})
    g3, v3, extra = t_ser.load_checkpoint(p, device="cpu")
    assert int(extra["iter"]) == 1
    full = t_opt.gauss_newton(g, v, device="cpu")
    resumed = t_opt.gauss_newton(g3, v3, device="cpu")
    assert resumed.error == pytest.approx(full.error, rel=1e-8, abs=1e-10)


def test_jax_files_load_and_jax_classes_are_refused(tmp_path):
    """The JAX package's Pose2 Values and graph files load in the port with
    the same error (rel 1e-12); a JAX Values file of Pose3 names a JAX
    class and a JAX engine checkpoint is not the port's: both refused."""
    jg, jv = _jax(*_problem())
    pv, pg = str(tmp_path / "jv.bin"), str(tmp_path / "jg.bin")
    j_ser.save_values(pv, jv)
    j_ser.save_graph(pg, jg)
    tv, tg = t_ser.load_values(pv, device="cpu"), t_ser.load_graph(pg, device="cpu")
    assert float(tg.error(tv)) == pytest.approx(float(jg.error(jv)), rel=1e-12)

    j3 = JValues()
    j3.insert(0, "Pose3", j_pose3.identity())
    j_ser.save_values(pv, j3)
    with pytest.raises(ValueError, match="only numpy arrays and builtins"):
        t_ser.load_values(pv, device="cpu")

    ji = j_isam2.ISAM2(j_isam2.ISAM2Params())
    ji.update(jg, jv)
    j_ser.save_isam2(pv, ji)
    with pytest.raises(ValueError, match="not an ISAM2 checkpoint"):
        t_ser.load_isam2(pv, device="cpu")


def test_isam2_checkpoint_with_marginals_resumes_bitwise(tmp_path):
    """An ISAM2 that has marginalized keys (message pools, a fixed set,
    retired factors), saved after update 15 and resumed for 5 more: its
    estimate and delta are bitwise those of the uninterrupted run."""
    _checkpoint_with_marginals_resumes_bitwise(tmp_path, "torch")


def test_host_engine_checkpoint_resumes_bitwise(tmp_path):
    """As above on the host engine (engine_backend="numpy"): the checkpoint
    holds its per-clique payloads and marginal message payloads, the load
    rebuilds the native sweep's tables, and the resumed run is bitwise the
    uninterrupted one."""
    _checkpoint_with_marginals_resumes_bitwise(tmp_path, "numpy")


def _checkpoint_with_marginals_resumes_bitwise(tmp_path, backend):
    rng = np.random.default_rng(8)
    gt = [np.zeros(3)]
    for _ in range(19):
        gt.append(compose(gt[-1], np.array([1.0, 0.0, rng.normal() * 0.3])))

    def feed(isam, i):
        g, v = TGraph(device="cpu"), TValues(device="cpu")
        v.insert(i, "Pose2", compose(gt[i], rng.normal(size=3) * 0.1))
        if i == 0:
            g.add(t_factors.prior_factor("Pose2"), [0], gt[0], PR_INFO)
        else:
            g.add(t_factors.between_factor("Pose2"), [i - 1, i], between(gt[i - 1], gt[i]), OD_INFO)
        if i >= 5 and i % 5 == 0:
            g.add(t_factors.between_factor("Pose2"), [i - 5, i], between(gt[i - 5], gt[i]), OD_INFO)
        isam.update(g, v)

    params = t_isam2.ISAM2Params(relinearize_threshold=0.01, relinearize_skip=1,
                                 wildfire_threshold=0.0, device="cpu", engine_backend=backend)
    runs = []
    for resume in (False, True):
        rng = np.random.default_rng(8)
        rng.normal(size=19)
        isam = t_isam2.ISAM2(params)
        for i in range(20):
            feed(isam, i)
            if i == 12:
                isam.marginalize_leaves([0, 1, 2, 3])
            if resume and i == 15:
                path = str(tmp_path / "isam2.ckpt")
                t_ser.save_isam2(path, isam)
                isam = t_ser.load_isam2(path, device="cpu")
                assert isam.engine.msgs and isam._fixed_gids
                assert isam.engine.backend == backend
        runs.append(isam)
    a, b = runs
    assert a.engine.n_live == b.engine.n_live
    assert torch.equal(a.delta()["Pose2"], b.delta()["Pose2"])
    ea, eb = a.calculate_estimate(), b.calculate_estimate()
    assert sorted(ea.keys()) == sorted(eb.keys()) == list(range(4, 20))
    assert torch.equal(ea.params("Pose2"), eb.params("Pose2"))
    g = TGraph(device="cpu")
    g.add(t_factors.between_factor("Pose2"), [1, 19], between(gt[1], gt[19]), OD_INFO)
    with pytest.raises(ValueError, match="marginalized key"):
        b.update(g, None)


def test_run_city10000_checkpoint_resumes(tmp_path, capsys):
    """run_city10000(checkpoint_path=...) over a 120-line city_stream
    writes the ISAM2 at its progress ticks (50, 100); resume_from finishes
    the last 20 lines bitwise equal to the uninterrupted run, within 1e-8
    of the JAX package's uninterrupted run."""
    lines, _ = synthetic.city_stream(120, seed=0)
    path = tmp_path / "city_stream.txt"
    path.write_text("\n".join(lines[:120]) + "\n")
    ckpt = str(tmp_path / "city.ckpt")
    full = t_city.run_city10000(str(path), device="cpu", progress_every=50, checkpoint_path=ckpt)
    resumed = t_city.run_city10000(str(path), device="cpu", resume_from=ckpt)
    assert len(resumed.updates) == 20 and "step 100:" in capsys.readouterr().out
    assert (resumed.n_poses, resumed.n_loop_closures) == (full.n_poses, full.n_loop_closures)
    np.testing.assert_array_equal(resumed.estimate, full.estimate)
    rj = j_city.run_city10000(str(path))
    np.testing.assert_allclose(resumed.estimate, np.asarray(rj.estimate), atol=1e-8)
    # the host engine's run resumes bitwise too, on the CPU; onto "cuda" its
    # checkpoint raises ValueError (with or without a card) and is not moved
    host = t_city.run_city10000(str(path), device="cpu", engine_backend="numpy",
                                progress_every=50, checkpoint_path=ckpt)
    rest = t_city.run_city10000(str(path), device="cpu", resume_from=ckpt,
                                engine_backend="numpy")
    np.testing.assert_array_equal(rest.estimate, host.estimate)
    with pytest.raises(ValueError, match="device='cpu'"):
        t_ser.load_isam2(ckpt, device="cuda")


def _entry_points(tmp_path):
    """The slice's new entry points, each called with its default device."""
    from gtsam_petercdev_torch.nonlinear import concurrent as t_cc
    from gtsam_petercdev_torch.nonlinear import fixed_lag as t_fl
    from gtsam_petercdev_torch.nonlinear.marginals import Marginals
    from gtsam_petercdev_torch.nonlinear.nonlinear_isam import NonlinearISAM

    g, v = _port(*_problem())
    path = tmp_path / "v.bin"
    t_ser.save_values(str(path), v)
    return {
        "Marginals": lambda: Marginals(g, v),
        "marginalize_keys": lambda: t_fl.marginalize_keys(g, v, [0]),
        "BatchFixedLagSmoother": lambda: t_fl.BatchFixedLagSmoother(4.0),
        "IncrementalFixedLagSmoother": lambda: t_fl.IncrementalFixedLagSmoother(4.0),
        "NonlinearISAM": lambda: NonlinearISAM(),
        "ConcurrentBatchFilter": lambda: t_cc.ConcurrentBatchFilter(4.0),
        "ConcurrentBatchSmoother": lambda: t_cc.ConcurrentBatchSmoother(),
        "ConcurrentIncrementalFilter": lambda: t_cc.ConcurrentIncrementalFilter(4.0),
        "ConcurrentIncrementalSmoother": lambda: t_cc.ConcurrentIncrementalSmoother(),
        "load_values": lambda: t_ser.load_values(str(path)),
        "run_city10000_fixed_lag": lambda: t_city.run_city10000_fixed_lag(str(path), 4.0),
    }


ENTRY_POINTS = ["Marginals", "marginalize_keys", "BatchFixedLagSmoother",
                "IncrementalFixedLagSmoother", "NonlinearISAM", "ConcurrentBatchFilter",
                "ConcurrentBatchSmoother", "ConcurrentIncrementalFilter",
                "ConcurrentIncrementalSmoother", "load_values", "run_city10000_fixed_lag"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_cuda(name, tmp_path):
    """device= defaults to "cuda": without a card each new entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points(tmp_path)[name]()
