"""The port's fill-reducing ordering (csrc/host/ordering.cpp through
inference/symbolic.py) against the JAX package's CCOLAMD.

The JAX package orders through a prebuilt CCOLAMD (its source is not in the
repository); the port runs its own approximate minimum-degree ordering,
built here by g++. The trees differ, so the gates are on fill: the port's
`F_size` (the planner's padded frontal entries, symbolic_eliminate of the
JAX package on both orderings) is at most 1.20x CCOLAMD's on every graph.
The iSAM2 gate holds estimates, not trees: at wildfire 0.0 both engines
back-substitute exactly, so the estimates agree to rel 1e-9 whatever the
ordering.
"""

import numpy as np
import pytest
from test_multifrontal import _random_pose2_graph

from gtsam_petercdev_torch.inference import symbolic as t_sym
from gtsam_petercdev_torch.models import city10000 as t_city
from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
from gtsam_petercdev_torch.utils import synthetic
from gtsam_petercdev_tpu.inference import symbolic as j_sym
from gtsam_petercdev_tpu.models import city10000 as j_city
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2

FILL_GATE = 1.20


def _city_edges(n_lines):
    lines, _ = synthetic.city_stream(400, seed=0)
    e = np.array([[int(ln.split()[1]), int(ln.split()[3])] for ln in lines[:n_lines]])
    return int(e.max()) + 1, e, 3


def _sphere_edges(rings, per_ring):
    _, factors = synthetic.sphere_rings(rings, per_ring, seed=0)
    return rings * per_ring, factors[1][1], 6


def _ba_edges(n_cams, n_pts, obs):
    data = make_synthetic_ba(n_cams, n_pts, obs, seed=0, dtype=np.float64)
    cams = np.stack([t.cam_idx for t in data.tracks])
    e = np.stack([cams.reshape(-1), n_cams + np.repeat(np.arange(n_pts), obs)], axis=1)
    return n_cams + n_pts, e, 9


def _pose2_edges(n_poses, n_loops, seed):
    graph, _ = _random_pose2_graph(n_poses, n_loops, np.random.default_rng(seed))
    e = np.concatenate([np.asarray(b.keys) for b in graph.batches if np.asarray(b.keys).shape[1] == 2])
    return n_poses, e.astype(np.int64), 3


GRAPHS = {
    "city_stream_300": lambda: _city_edges(300),
    "sphere_10x10": lambda: _sphere_edges(10, 10),
    "ba_50x2000x4": lambda: _ba_edges(50, 2000, 4),
    "pose2_60_25": lambda: _pose2_edges(60, 25, 1),
    "pose2_150_60": lambda: _pose2_edges(150, 60, 2),
}


def _fill(n, edges, perm, d):
    return j_sym.symbolic_eliminate(n, [edges], d, ordering=perm).F_size


def _is_perm(p, n):
    return p.dtype == np.int64 and sorted(p.tolist()) == list(range(n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fill_within_gate_of_ccolamd(name):
    """F_size of the port's ccolamd_ordering <= 1.20x the JAX CCOLAMD's."""
    n, e, d = GRAPHS[name]()
    perm = t_sym.ccolamd_ordering(n, e)
    assert _is_perm(perm, n)
    ratio = _fill(n, e, perm, d) / _fill(n, e, j_sym.ccolamd_ordering(n, e), d)
    assert ratio <= FILL_GATE, ratio


def test_amd_is_deterministic_and_ignores_edge_order():
    n, e, _ = _pose2_edges(150, 60, 3)
    p = t_sym.amd_ordering(n, e)
    rng = np.random.default_rng(0)
    shuffled = e[rng.permutation(len(e))][:, ::-1]  # edges reordered and flipped
    assert np.array_equal(p, t_sym.amd_ordering(n, e))
    assert np.array_equal(p, t_sym.amd_ordering(n, np.ascontiguousarray(shuffled)))


def test_amd_respects_constraint_groups():
    """Every variable of group k is ordered before any of group k + 1."""
    n, e, _ = _city_edges(300)
    rng = np.random.default_rng(1)
    cm = rng.integers(0, 3, size=n)
    p = t_sym.amd_ordering(n, e, cm)
    assert _is_perm(p, n)
    assert np.all(np.diff(cm[p]) >= 0)
    # ColamdConstrainedLast: the newest poses last, as iSAM2 asks
    last = np.zeros(n, dtype=np.int64)
    last[-5:] = 1
    p = t_sym.ccolamd_ordering(n, e, last)
    assert sorted(p[-5:].tolist()) == list(range(n - 5, n))


@pytest.mark.parametrize("n,edges", [
    (0, []), (1, []), (1, [[0, 0]]), (2, [[0, 1]]), (2, [[0, 1], [1, 0], [1, 1]]),
    (5, [[0, 1], [0, 1], [3, 3]]),  # duplicates, a self-edge, isolated 2 and 4
    (6, [[0, 1], [2, 3], [4, 5], [1, 2]])])
def test_amd_small_and_degenerate_graphs(n, edges):
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    assert _is_perm(t_sym.amd_ordering(n, e), n)
    assert _is_perm(t_sym.ccolamd_ordering(n, e), n)


def test_amd_rejects_an_edge_outside_the_graph():
    with pytest.raises(ValueError, match="outside"):
        t_sym.amd_ordering(3, np.array([[0, 3]]))


def test_small_problems_take_the_proxy_as_jax_does():
    e = np.array([[0, 1]])
    for n in (1, 2):
        assert np.array_equal(t_sym.ccolamd_ordering(n, e[: n - 1]), j_sym.colamd_ordering(n, e[: n - 1]))
    assert np.array_equal(t_sym.ccolamd_ordering(4, e[:0]), np.arange(4))


@pytest.mark.parametrize("name", ["pose2_150_60", "sphere_10x10", "city_stream_300"])
def test_best_ordering_keeps_the_least_fill_of_the_four_candidates(name):
    """best_ordering tries ND, ccolamd_ordering, the proxy and
    degree-ascending, in the JAX order, and keeps the least F_size; three of
    the candidates are the JAX package's own."""
    n, e, _ = GRAPHS[name]()
    cands = [t_sym.nested_dissection_ordering(n, e), t_sym.ccolamd_ordering(n, e),
             t_sym.colamd_ordering(n, e), t_sym.degree_ascending_ordering(n, e)]
    for ours, theirs in ((cands[0], j_sym.nested_dissection_ordering(n, e)),
                         (cands[2], j_sym.colamd_ordering(n, e)),
                         (cands[3], j_sym.degree_ascending_ordering(n, e))):
        assert np.array_equal(ours, theirs)
    fills = [_fill(n, e, p, 1) for p in cands]
    best = t_sym.best_ordering(n, e)
    assert np.array_equal(best, cands[int(np.argmin(fills))])
    assert _fill(n, e, best, 1) <= _fill(n, e, j_sym.best_ordering(n, e), 1) * FILL_GATE


def jax_city_updates(monkeypatch):
    """Record every JAX ISAM2.update result of a run (its harness keeps none)."""
    out, update = [], j_isam2.ISAM2.update

    def recorded(self, *a, **k):
        out.append(update(self, *a, **k))
        return out[-1]

    monkeypatch.setattr(j_isam2.ISAM2, "update", recorded)
    return out


def test_isam2_on_amd_matches_jax_on_ccolamd(tmp_path, monkeypatch):
    """The port's ISAM2 on its AMD and the JAX ISAM2 on real CCOLAMD over
    the first 150 City lines at wildfire 0.0: estimates to rel 1e-9. The
    trees differ; over these lines the port re-eliminates 0.913 times the
    cliques the JAX engine does (held within [0.5, 2])."""
    lines, _ = synthetic.city_stream(200, seed=0)
    path = tmp_path / "city.txt"
    path.write_text("\n".join(lines[:150]) + "\n")
    uj = jax_city_updates(monkeypatch)
    rj = j_city.run_city10000(str(path))
    rt = t_city.run_city10000(str(path), device="cpu")
    ej, et = np.asarray(rj.estimate), rt.estimate
    np.testing.assert_allclose(et, ej, rtol=1e-9, atol=1e-9 * np.abs(ej).max())
    ratio = (sum(u.n_reeliminated for u in rt.updates)
             / sum(u.n_reeliminated for u in uj[1:]))  # uj[0]: the prior's update
    assert 0.5 <= ratio <= 2.0, ratio


def test_ordering_and_sweeps_are_the_ports_own_builds():
    """The AMD and the host sweeps load from the port's own g++ builds of
    csrc/host/, never from the JAX package's prebuilt libraries."""
    import os

    from gtsam_petercdev_torch.ops import build_host

    t_sym.amd_ordering(4, np.array([[0, 1], [1, 2], [2, 3]]))
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(build_host.__file__)))
    for name in ("ordering", "solve_native"):
        lib = build_host.load(name)
        assert os.path.dirname(lib._name) == os.path.join(pkg, "_build")
        assert os.path.basename(lib._name).startswith(f"lib{name}-")
        assert os.path.isfile(os.path.join(pkg, "csrc", "host", build_host.SOURCES[name]))
