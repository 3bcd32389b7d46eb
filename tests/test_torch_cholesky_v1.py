"""The port's per-clique partial Cholesky (K3) and its block-pool variant
(K4) against the JAX package's Pallas kernels, and the routing of buckets
to the three factorization kernels.

K3 `ops.cholesky.partial_cholesky` and K4 `partial_cholesky_blocks` are CUDA
kernels on the card; on a CPU tensor the wrappers run the plain versions,
which are held here against the Pallas kernels of
gtsam_petercdev_tpu/ops/cholesky.py in interpret mode, at the shapes of
tests/test_pallas_cholesky.py plus a d = 9 block size (the bundle-adjustment
camera). The CUDA kernels themselves are held against these plain versions
by `chip_smoke.py` on the card and, without a card, by
`tools/cuda_emulate.py`. Tolerance: atol 1e-8 in float64 (the same block
algorithm; sums differ in order only), equal bad-pivot counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_petercdev_torch.inference import elimination as t_elim
from gtsam_petercdev_torch.inference import kernels as t_kernels
from gtsam_petercdev_torch.linear import solve as t_solve
from gtsam_petercdev_torch.ops import build
from gtsam_petercdev_torch.ops import cholesky as t_ops
from gtsam_petercdev_torch.ops import cholesky_v2 as t_ops_v2
from gtsam_petercdev_torch.utils import convert, synthetic
from gtsam_petercdev_tpu.ops import cholesky as j_ops

ATOL = 1e-8
KEYS = ("L", "Linv", "W", "y", "U", "ug")


def _spd(rng, B, m, pad=4):
    A = rng.standard_normal((B, m, m + pad))
    return A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(m)


def _blocks(Fm, gm, mb, d):
    """The pool layout of tests/test_pallas_cholesky.py:40-46, in numpy."""
    B = Fm.shape[0]
    Fb = Fm.reshape(B, mb, d, mb, d).transpose(0, 1, 3, 2, 4).reshape(B * mb * mb, d, d)
    return np.ascontiguousarray(Fb), gm.reshape(B, mb, d)


def _check(got, ref, keys):
    for k in keys:
        r = np.asarray(ref[k])
        if r.size:
            np.testing.assert_allclose(got[k].numpy(), r, atol=ATOL, rtol=0, err_msg=k)
    assert int(got["bad"]) == int(ref["bad"])


# tests/test_pallas_cholesky.py:16 shapes, plus d = 9 with and without a separator
DENSE_SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3), (4, 1, 4, 9), (3, 2, 0, 9)]


@pytest.mark.parametrize("B,nf,ns,d", DENSE_SHAPES)
def test_dense_variant_matches_pallas(B, nf, ns, d, rng):
    m = (nf + ns) * d
    Fm, gm = _spd(rng, B, m), rng.standard_normal((B, m))
    got = t_ops.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    _check(got, j_ops.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d, interpret=True),
           KEYS)


# tests/test_pallas_cholesky.py:32 shapes, plus the BA leaf shape and a d = 9 root
BLOCK_SHAPES = [(3, 2, 1, 6), (2, 4, 3, 6), (4, 1, 4, 9), (3, 2, 0, 9)]


@pytest.mark.parametrize("B,nf,ns,d", BLOCK_SHAPES)
def test_blocks_variant_matches_pallas(B, nf, ns, d, rng):
    mb = nf + ns
    Fm, gm = _spd(rng, B, mb * d), rng.standard_normal((B, mb * d))
    Fb, gb = _blocks(Fm, gm, mb, d)
    got = t_ops.partial_cholesky_blocks(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
    ref = j_ops.partial_cholesky_blocks(jnp.asarray(Fb), jnp.asarray(gb), nf, ns, d,
                                        interpret=True)
    _check(got, ref, ("L", "Linv", "W", "y", "U_blocks", "ug_blocks"))
    assert got["U_blocks"].shape == (B, ns * ns, d, d)
    assert got["ug_blocks"].shape == (B, ns, d)


@pytest.mark.parametrize("B,nf,ns,d", BLOCK_SHAPES)
def test_blocks_variant_is_the_dense_one_relaid(B, nf, ns, d, rng):
    """K4's plain version gives K3's outputs, U and ug cut into blocks."""
    mb = nf + ns
    Fm, gm = _spd(rng, B, mb * d), rng.standard_normal((B, mb * d))
    Fb, gb = _blocks(Fm, gm, mb, d)
    dense = t_ops.partial_cholesky_plain(torch.tensor(Fm), torch.tensor(gm), nf, d)
    blk = t_ops.partial_cholesky_blocks_plain(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
    for k in ("L", "Linv", "W", "y"):
        assert torch.equal(blk[k], dense[k])
    assert torch.equal(t_ops.dense_from_blocks(blk["U_blocks"], B, ns, d), dense["U"])
    assert torch.equal(blk["ug_blocks"].reshape(B, ns * d), dense["ug"])
    assert torch.equal(t_ops.blocks_from_dense(torch.tensor(Fm), mb, d).reshape(-1, d, d),
                       torch.tensor(Fb))


@pytest.mark.parametrize("variant", ["dense", "blocks"])
@pytest.mark.parametrize("d", [3, 9])
def test_clamped_pivot_counting(variant, d, rng):
    """Indefinite frontal blocks (test_pallas_cholesky.py:71-81): clamped
    pivots are counted identically."""
    B, nf, ns = 2, 2, 1
    mb = nf + ns
    A = rng.standard_normal((B, mb * d, mb * d))
    Fm = A @ A.transpose(0, 2, 1)
    Fm[0, 0, 0] = -5.0
    gm = rng.standard_normal((B, mb * d))
    if variant == "dense":
        got = t_ops.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
        ref = j_ops.partial_cholesky(jnp.asarray(Fm), jnp.asarray(gm), nf, d, interpret=True)
    else:
        Fb, gb = _blocks(Fm, gm, mb, d)
        got = t_ops.partial_cholesky_blocks(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
        ref = j_ops.partial_cholesky_blocks(jnp.asarray(Fb), jnp.asarray(gb), nf, ns, d,
                                            interpret=True)
    assert int(got["bad"]) == int(ref["bad"]) >= 1


def test_cpu_tensors_take_the_plain_versions(rng):
    """On CPU tensors the wrappers run the plain versions and launch nothing;
    reset_launch_counts resets all four kernels' counts."""
    B, nf, ns, d = 2, 2, 1, 6
    mb = nf + ns
    Fm, gm = _spd(rng, B, mb * d), rng.standard_normal((B, mb * d))
    Fb, gb = _blocks(Fm, gm, mb, d)
    for fn in (t_ops.partial_cholesky, t_ops.partial_cholesky_blocks,
               t_ops_v2.partial_cholesky, t_ops_v2.backsolve_bucket):
        fn.launches = 7
    t_ops.reset_launch_counts()
    assert set(t_ops.launch_counts().values()) == {0}
    got = t_ops.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    ref = t_kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
    for k in KEYS:
        assert torch.equal(got[k], ref[k])
    t_ops.partial_cholesky_blocks(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
    assert set(t_ops.launch_counts().values()) == {0}
    assert sorted(t_ops.launch_counts()) == ["backsolve_bucket", "partial_cholesky",
                                             "partial_cholesky_blocks", "partial_cholesky_smem"]


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float64, device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel path, which raises
    for what it cannot launch (a meta tensor stands in for a device tensor)."""
    B, nf, ns, d = 2, 2, 1, 6
    mb = nf + ns
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.partial_cholesky(_meta(B, mb * d, mb * d), _meta(B, mb * d), nf, d)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.partial_cholesky_blocks(_meta(B * mb * mb, d, d), _meta(B, mb, d), nf, ns, d)
    with pytest.raises(ValueError, match="bad shapes"):
        t_ops.partial_cholesky_blocks(_meta(B * mb, d, d), _meta(B, mb, d), nf, ns, d)
    assert set(t_ops.launch_counts().values()) == {0}


def test_clique_beyond_shared_memory_raises():
    """fits_smem plays fits_vmem's part, but a device tensor whose clique
    does not fit RAISES: the wrapper hands it to no other kernel."""
    # the sphere plan's root, and the BA plan's largest float64 front
    assert not t_ops.fits_smem(32, 96, 6, 8)
    assert not t_ops.fits_smem(12, 24, 9, 8) and t_ops.fits_smem(12, 24, 9, 4)
    # the BA leaf clique: 3.4 KB in float64
    assert t_ops.smem_bytes(1, 4, 9, 8) == (9 * 46 + 81 + 2 * 81) * 8 + 16
    assert t_ops.fits_smem(1, 4, 9, 8) and not t_ops.fits_smem(1, 4, 17, 8)
    nf, ns, d = 32, 96, 6
    mb = nf + ns
    with pytest.raises(ValueError, match="shared memory"):
        t_ops.partial_cholesky(_meta(1, mb * d, mb * d), _meta(1, mb * d), nf, d)
    with pytest.raises(ValueError, match="shared memory"):
        t_ops.partial_cholesky_blocks(_meta(mb * mb, d, d), _meta(1, mb, d), nf, ns, d)


def test_kernel_library_is_registered():
    """K3 and K4 are two entry points of one source, built like K1 and K2."""
    assert build.SOURCES["partial_cholesky_smem"] == "partial_cholesky_smem.cu"
    assert sorted(build._SIGNATURES["partial_cholesky_smem"]) == [
        "gtsam_partial_cholesky_blocks", "gtsam_partial_cholesky_smem"]
    with open(f"{build.CSRC}/partial_cholesky_smem.cu") as f:
        src = f.read()
    for sfx in ("f32", "f64"):
        assert f"gtsam_partial_cholesky_smem_{sfx}" in src
        assert f"gtsam_partial_cholesky_blocks_{sfx}" in src
    assert len({build.library_path(n) for n in build.SOURCES}) == len(build.SOURCES) == 4


# --- routing ------------------------------------------------------------------------


def test_bucket_route_by_shape():
    bm = lambda nf, ns, ext: t_elim.BucketMaps(
        level=0, B=1, nf=nf, ns=ns, blk_start=0, g_start=0, sep_idx=None, fro_idx=None,
        ext_mm=[(0, None, None)] if ext else None)
    assert t_elim.bucket_route(bm(1, 4, False), 9, 8) == "blocks"
    assert t_elim.bucket_route(bm(1, 4, True), 9, 8) == "smem"
    assert t_elim.bucket_route(bm(32, 96, True), 6, 8) == "global"
    assert t_elim.bucket_route(bm(32, 0, False), 6, 8) == "global"  # a leaf too large
    assert t_elim.bucket_route(bm(12, 24, True), 9, 8) == "global"
    assert t_elim.bucket_route(bm(12, 24, True), 9, 4) == "smem"


@pytest.mark.parametrize("limit", [t_ops.SMEM_LIMIT, 6000, 0])
def test_every_route_is_taken_and_agrees_with_the_dense_oracle(limit, monkeypatch):
    """A small Pose3 plan under three shared-memory limits: the card's (K4
    leaves + K3), a small one (all three kernels) and none (K1 only). The
    solve equals the dense oracle under each, so the block-layout extend-add
    and the dense one agree."""
    va, fa = synthetic.sphere_rings(4, 5, seed=0)
    tg = convert.graph_from_arrays(fa, device="cpu")
    tv = convert.values_from_arrays(va, device="cpu")
    lg = tg.linearize(tv)
    _, maps = t_elim._graph_plan(tg, lg)
    monkeypatch.setattr(t_ops, "SMEM_LIMIT", limit)
    calls = {"blocks": 0, "smem": 0, "global": 0}

    def counted(route, fn):
        def wrapper(*args, **kwargs):
            calls[route] += 1
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(t_ops, "partial_cholesky_blocks",
                        counted("blocks", t_ops.partial_cholesky_blocks))
    monkeypatch.setattr(t_ops, "partial_cholesky", counted("smem", t_ops.partial_cholesky))
    monkeypatch.setattr(t_ops_v2, "partial_cholesky",
                        counted("global", t_ops_v2.partial_cholesky))
    x = t_elim.multifrontal_solve(maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-3)
    routes = [t_elim.bucket_route(bm, 6, 8) for bm in maps.buckets]
    assert calls == {r: routes.count(r) for r in calls}
    if limit == 6000:
        assert all(n > 0 for n in calls.values()), calls
    elif limit == 0:
        assert calls["global"] == len(maps.buckets)
    else:
        assert calls["global"] == 0 and calls["blocks"] > 0 and calls["smem"] > 0
    H, g = t_solve.assemble_dense(lg)
    x_dense = t_solve.dense_solve(H, g, 1e-3).reshape(-1, 6)
    np.testing.assert_allclose(x.numpy(), x_dense.numpy(), atol=ATOL)
