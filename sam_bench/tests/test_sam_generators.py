"""The frozen generators equal the port's own at seeds 0-2."""

import numpy as np
import pytest

from sam_bench.generators import ba_ring


def _leaves(p):
    if isinstance(p, dict):
        return [p[k] for k in sorted(p)]
    return list(p) if isinstance(p, tuple) else [p]


def _assert_same(port_values, port_factors, prob, tol):
    assert sorted(port_values) == sorted(prob.values)
    for t, (keys, params) in port_values.items():
        assert (np.asarray(keys, dtype=np.uint64) == prob.values[t][0]).all()
        for a, b in zip(_leaves(params), _leaves(prob.values[t][1])):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    assert [f[0] for f in port_factors] == [f[0] for f in prob.factors]
    for (_, k1, p1, s1), (_, k2, p2, s2) in zip(port_factors, prob.factors):
        assert (np.asarray(k1, dtype=np.uint64) == k2).all()
        for a, b in zip(_leaves(p1), _leaves(p2)):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)
        np.testing.assert_allclose(s2, s1, rtol=0, atol=0)


BA = dict(n_cameras=20, n_points=500, n_observations=2000, pixel_noise=1.0, pixel_sigma=1.0,
          prior_sigma=0.1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ba_ring_equals_make_synthetic_ba(seed):
    """Under the identity relabelling (n_points = 1: one permutation) the
    problem is the port's ba_arrays(make_synthetic_ba(...)) exactly; the rig
    itself at 500 points too."""
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
    from gtsam_petercdev_torch.models.bundle_adjustment import ba_arrays

    va, fa = ba_arrays(make_synthetic_ba(20, 1, 4, seed=seed, dtype=np.float64))
    prob = ba_ring.make(dict(BA, n_points=1, n_observations=4, data_seed=seed), 12345)
    _assert_same(va, fa, prob, 0.0)
    data = make_synthetic_ba(20, 500, 4, seed=seed, dtype=np.float64)
    R, t, cal, points, cam_idx, uv = ba_ring.rig(20, 500, 4, 1.0, seed)
    np.testing.assert_array_equal(R, np.stack([c.R for c in data.cameras]))
    np.testing.assert_array_equal(t, np.stack([c.t for c in data.cameras]))
    np.testing.assert_array_equal(cal, np.stack([c.cal for c in data.cameras]))
    np.testing.assert_array_equal(points, np.stack([tr.point for tr in data.tracks]))
    np.testing.assert_array_equal(cam_idx, np.stack([tr.cam_idx for tr in data.tracks]))
    np.testing.assert_array_equal(uv, np.stack([tr.uv for tr in data.tracks]))


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_ba_ring_seed_relabels_one_rig(seed):
    prob = ba_ring.make(dict(BA, data_seed=0), seed)
    R, t, cal, points, cam_idx, uv = ba_ring.rig(20, 500, 4, 1.0, 0)
    perm = np.random.default_rng(seed).permutation(500)
    a = prob.arrays
    np.testing.assert_array_equal(a["points"], points[perm])
    np.testing.assert_array_equal(a["obs_cam"], cam_idx[perm].reshape(-1))
    np.testing.assert_array_equal(a["uv"], uv[perm].reshape(-1, 2))
    np.testing.assert_array_equal(a["obs_pt"], np.repeat(np.arange(500), 4))
    pp = int(a["prior_point"])
    assert perm[pp] == 0
    name, keys, value, _ = prob.factors[2]
    assert name == "PriorPoint3" and keys[0, 0] == ba_ring.symbol("p", pp)
    np.testing.assert_array_equal(value[0], points[0])
    other = ba_ring.make(dict(BA, data_seed=0), seed + 1)
    assert not np.array_equal(other.arrays["points"], a["points"])


@pytest.mark.parametrize("seed", [0, 5])
def test_ba_ring_fifth_views(seed):
    """n_observations mod n_points points keep the fifth view of the port's
    5-view rig, the others drop it; the data seed picks which."""
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba

    prob = ba_ring.make(dict(BA, n_observations=2168, data_seed=seed), 9)
    a = prob.arrays
    assert len(a["obs_cam"]) == 2168 == len(a["uv"]) == len(a["obs_pt"])
    counts = np.bincount(a["obs_pt"], minlength=500)
    assert set(counts) == {4, 5} and (counts == 5).sum() == 168
    assert (np.diff(a["obs_pt"]) >= 0).all()
    data = make_synthetic_ba(20, 500, 5, seed=seed, dtype=np.float64)
    perm = np.random.default_rng(9).permutation(500)
    lengths = ba_ring.track_lengths(500, 2168, seed)[perm]
    np.testing.assert_array_equal(counts, lengths)
    cams = np.concatenate([data.tracks[p].cam_idx[:m] for p, m in zip(perm, lengths)])
    uv = np.concatenate([data.tracks[p].uv[:m] for p, m in zip(perm, lengths)])
    np.testing.assert_array_equal(a["obs_cam"], cams)
    np.testing.assert_array_equal(a["uv"], uv)
    other = ba_ring.track_lengths(500, 2168, seed + 1)
    assert not np.array_equal(other, ba_ring.track_lengths(500, 2168, seed))


def test_large_seed():
    """Seeds past 32 bits work."""
    a = ba_ring.make(dict(BA, n_cameras=8, n_points=40, n_observations=130, data_seed=0),
                     2**31 + 12345)
    assert np.isfinite(a.arrays["uv"]).all() and len(a.arrays["uv"]) == 130
