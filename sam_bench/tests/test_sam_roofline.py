"""The roofline's counts at a few bucket shapes, and its kernel names."""

from types import SimpleNamespace

import numpy as np
import pytest

from sam_bench import roofline


@pytest.mark.parametrize("fd,sd,diag,item,nbytes,flops", [
    # (F11 | F12 rows, F22, g) read; (L, Linv, W, y, U, ug) written; 4 B pivots
    (12, 6, 72, 8, 8 * (12 * 18 + 36 + 18 + 144 + 72 + 72 + 12 + 36 + 6) + 4,
     12 ** 3 / 3 + 144 * 6 + 12 * 36),
    (288, 288, 32 * 81, 8, 8 * (288 * 576 + 288 ** 2 + 576 + 288 ** 2 + 32 * 81 + 288 ** 2 + 288
                                + 288 ** 2 + 288) + 4, 288 ** 3 / 3 + 2 * 288 ** 3),
    (3, 9, 9, 4, 4 * (3 * 12 + 81 + 12 + 9 + 9 + 27 + 3 + 81 + 9) + 4, 9 + 81 + 243),
])
def test_factor_cost(fd, sd, diag, item, nbytes, flops):
    b, f = roofline.factor_cost(fd, sd, diag, item)
    assert b == nbytes and f == pytest.approx(flops, rel=1e-15)


@pytest.mark.parametrize("fd,sd,diag", [(12, 6, 72), (288, 288, 32 * 81), (3, 9, 9)])
def test_backsolve_cost(fd, sd, diag):
    lower = (fd * fd - diag) // 2
    b, f = roofline.backsolve_cost(fd, sd, diag, 8)
    assert b == 8 * (lower + diag + fd * sd + 2 * fd + sd)
    assert f == 2 * fd * sd + 2 * lower + 2 * diag


def _plan(buckets, perm):
    cliques, levels = [], []
    for level in buckets:
        lv = []
        for members in level:
            ids = []
            for frontal, sep in members:
                ids.append(len(cliques))
                cliques.append(SimpleNamespace(frontal=frontal, separator=sep))
            lv.append(SimpleNamespace(cliques=ids))
        levels.append(lv)
    return SimpleNamespace(levels=levels, cliques=cliques, perm=np.asarray(perm))


def test_sweep_bound_counts_native_sizes():
    """Two point leaves (dim 3) under one camera (dim 9) front: each clique
    is counted at its own dims, not the bucket's padded d = 9."""
    perm = [2, 0, 1]  # position -> variable; variables 0, 1 are points, 2 the camera
    dims = roofline.var_dims({"Point3": 2, "SfmCamera": 1}, {"Point3": 3, "SfmCamera": 9})
    assert dims.tolist() == [3, 3, 9]
    plan = _plan([[[([1], [0]), ([2], [0])]], [[([0], [])]]], perm)
    want = 0.0
    for members in ([(3, 9, 9), (3, 9, 9)], [(9, 0, 81)]):
        fb = ff = bb = bf = 0.0
        for fd, sd, diag in members:
            b, f = roofline.factor_cost(fd, sd, diag, 8)
            fb, ff = fb + b, ff + f
            b, f = roofline.backsolve_cost(fd, sd, diag, 8)
            bb, bf = bb + b, bf + f
        want += max(fb / roofline.MEM_BPS, ff / 67e12) + max(bb / roofline.MEM_BPS, bf / 67e12)
    assert roofline.sweep_bound_s(plan, dims, "float64") == pytest.approx(want, rel=1e-15)
    assert roofline.n_buckets(plan) == 2
    padded = [9] * 3
    assert roofline.sweep_bound_s(plan, np.asarray(padded), "float64") > want


@pytest.mark.parametrize("name,hit", [
    ("void factor_kernel<double, 8>(double const*, double*)", True),
    ("void schur_update_kernel<double>(...)", True),
    ("partial_cholesky_blocks_kernel<double, 9, true>", True),
    ("void backsolve_cluster_kernel<float>(float const*)", True),
    ("void backsolve_warp_kernel<double, 6>(double const*)", True),
    ("void at::native::index_elementwise_kernel<128, 4>(...)", False),
    ("void my_solve_kernel2(double*)", False),
    ("Memcpy DtoD (Device -> Device)", False),
])
def test_kernel_names(name, hit):
    assert roofline.is_bucket_kernel(name) is hit
