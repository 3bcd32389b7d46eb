"""The port's bucket kernels (plain PyTorch versions) against the JAX ones.

K1 `partial_cholesky` and K2 `backsolve_bucket` are CUDA kernels on the
card; on a CPU tensor the wrappers in `ops/cholesky_v2.py` run the plain
versions, which are held here against the Pallas kernels in interpret mode
and against the JAX package's XLA kernels. The CUDA kernels themselves are
held against these plain versions by `chip_smoke.py` on the card.
Tolerance: atol 1e-8 in float64 (the Pallas interpret path and the plain
version run the same block algorithm; sums differ in order only).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference import kernels as t_kernels
from gtsam_petercdev_torch.ops import build
from gtsam_petercdev_torch.ops import cholesky_v2 as t_ops
from gtsam_petercdev_tpu.inference import kernels as j_kernels
from gtsam_petercdev_tpu.ops import cholesky_v2 as j_ops

ATOL = 1e-8
KEYS = ("L", "Linv", "W", "y", "U", "ug")


def _spd(rng, B, m, pad=4):
    A = rng.standard_normal((B, m, m + pad))
    return A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(m)


def _check(got, ref):
    for k in KEYS:
        r = np.asarray(ref[k])
        if r.size:
            np.testing.assert_allclose(got[k].numpy(), r, atol=ATOL, rtol=0, err_msg=k)
    assert int(got["bad"]) == int(ref["bad"])


# tests/test_pallas_cholesky.py shapes (:16 and :95), ns=0 leaves included
SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3),
          (5, 2, 4, 6), (2, 4, 0, 3)]


@pytest.mark.parametrize("B,nf,ns,d", SHAPES)
def test_partial_cholesky_matches_pallas_and_xla(B, nf, ns, d, rng):
    m = (nf + ns) * d
    Fm, gm = _spd(rng, B, m), rng.standard_normal((B, m))
    got = t_ops.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    _check(got, j_ops.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d, interpret=True))
    _check(got, j_kernels.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d))


def test_partial_cholesky_large_front_matches_xla(rng):
    """(3, 12, 16, 6) of test_pallas_cholesky.py:95, against the XLA kernel
    only (too slow for interpret mode)."""
    B, nf, ns, d = 3, 12, 16, 6
    m = (nf + ns) * d
    Fm, gm = _spd(rng, B, m), rng.standard_normal((B, m))
    got = t_kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    _check(got, j_kernels.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d))


def test_clamped_pivot_counting(rng):
    """Indefinite frontal blocks (test_pallas_cholesky.py:71-81): clamped
    pivots are counted identically."""
    B, nf, ns, d = 2, 2, 1, 3
    m = (nf + ns) * d
    A = rng.standard_normal((B, m, m))
    Fm = A @ A.transpose(0, 2, 1)
    Fm[0, 0, 0] = -5.0
    gm = rng.standard_normal((B, m))
    got = t_ops.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    ref_p = j_ops.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d, interpret=True)
    ref_x = j_kernels.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d)
    assert int(got["bad"]) == int(ref_p["bad"]) == int(ref_x["bad"]) >= 1


@pytest.mark.parametrize("B,nf,ns,d", [(3, 2, 2, 6), (4, 3, 0, 6), (2, 1, 3, 3)])
def test_backsolve_matches_pallas(B, nf, ns, d, rng):
    """Fused separator subtract + top-down solve, with and without a
    separator (sd = 0 at the roots)."""
    m = (nf + ns) * d
    Fm, gm = _spd(rng, B, m), rng.standard_normal((B, m))
    f = j_kernels.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d)
    xs = rng.standard_normal((B, ns * d))
    ref = j_ops.backsolve_bucket(f["L"], f["Linv"], f["W"], f["y"], jnp.asarray(xs), nf, d,
                                 interpret=True)
    args = [torch.tensor(np.asarray(f[k])) for k in ("L", "Linv", "W", "y")]
    got = t_ops.backsolve_bucket(*args, torch.tensor(xs), nf, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # and it solves L^T x = y - W xs
    L = args[0].numpy()
    rhs = np.asarray(f["y"]) - np.einsum("bfs,bs->bf", np.asarray(f["W"]), xs)
    np.testing.assert_allclose(np.einsum("bfk,bf->bk", L, got.numpy()), rhs, atol=ATOL)


def test_cpu_tensors_take_the_plain_version(rng):
    """On a CPU tensor the wrappers run the plain version and launch nothing."""
    B, nf, ns, d = 2, 2, 1, 6
    m = (nf + ns) * d
    Fm, gm = torch.tensor(_spd(rng, B, m)), torch.tensor(rng.standard_normal((B, m)))
    t_ops.reset_launch_counts()
    got = t_ops.partial_cholesky(Fm, gm, nf, d)
    ref = t_kernels.partial_cholesky(Fm, gm, nf, d)
    for k in KEYS:
        assert torch.equal(got[k], ref[k])
    t_ops.backsolve_bucket(got["L"], got["Linv"], got["W"], got["y"],
                           torch.zeros(B, ns * d, dtype=torch.float64), nf, d)
    assert t_ops.partial_cholesky.launches == 0
    assert t_ops.backsolve_bucket.launches == 0


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Any tensor that is not on the CPU goes to the kernel path, which
    raises for what it cannot launch: there is no fallback to the plain
    version (a meta tensor stands in for a device tensor here)."""
    B, nf, ns, d = 2, 2, 1, 6
    m = (nf + ns) * d
    Fm = torch.empty((B, m, m), dtype=torch.float64, device="meta")
    gm = torch.empty((B, m), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.partial_cholesky(Fm, gm, nf, d)
    L = torch.empty((B, nf * d, nf * d), dtype=torch.float64, device="meta")
    Linv = torch.empty((B, nf, d, d), dtype=torch.float64, device="meta")
    W = torch.empty((B, nf * d, ns * d), dtype=torch.float64, device="meta")
    y = torch.empty((B, nf * d), dtype=torch.float64, device="meta")
    xs = torch.empty((B, ns * d), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.backsolve_bucket(L, Linv, W, y, xs, nf, d)
    assert t_ops.partial_cholesky.launches == 0


def test_kernel_build_is_keyed_by_source():
    """Each kernel library's file name carries its source's hash; without
    nvcc the build raises instead of leaving the kernels out."""
    paths = {build.library_path(name) for name in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all(p.startswith(build.BUILD_DIR) and p.endswith(".so") for p in paths)
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all()
