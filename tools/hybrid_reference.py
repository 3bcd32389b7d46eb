#!/usr/bin/env python3
"""Record the JAX package's hybrid inference on small inputs, to
tests/data/hybrid_reference.json, for tests/test_torch_discrete_hybrid.py.

    python3 tools/hybrid_reference.py     (~2 minutes on one CPU core)

The JAX side of these runs costs most of its time in compiles (its sparse
elimination traces the multifrontal solve under vmap, ~15 s for a 4-variable
chain; its ISAM2 compiles per batch shape, ~16 s of a 40-line Hybrid City
run), so the CPU tests read its results from this file and run only the port.
Every input is written beside the result it gave:

  sparse     a 12-variable chain (ten of dim 3, two of dim 2) with three
             hybrid terms over discrete keys of cards 2, 2, 3 (one term over
             two of them) and a discrete potential: the full grid (M = 12)
             and a restricted set of 5 assignments through `eliminate` and
             `eliminate_sparse`
  smoother   the JAX test's switching chain through HybridSmoother at
             max_leaves 8 and 2, and at dense_dim_limit 2 (every update
             through eliminate_sparse)
  city       run_hybrid_city (the JAX harness, host engine) on the first 40
             lines of utils/synthetic.hybrid_city_stream(60, seed=5,
             p_ambiguous=0.0, p_false_loop=0.3) with max_hypotheses 4 (five
             binary loop modes, one loop false): the best hypothesis's
             choices, the unrounded posterior (the weights its final argmax
             reads) and the trajectory; and on the first 12 lines of the
             same stream at p_ambiguous=0.15 (two odometry forks, four tied
             hypotheses)
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "hybrid_reference.json")
CITY = dict(n_poses=60, seed=5, p_ambiguous=0.0, p_false_loop=0.3, lines=40, max_hypotheses=4)
FORKS = dict(n_poses=60, seed=5, p_ambiguous=0.15, p_false_loop=0.3, lines=12, max_hypotheses=4)
RESTRICTED = [[0, 0, 0], [1, 0, 2], [0, 1, 1], [1, 1, 0], [0, 0, 2]]


def sparse_spec(seed=0):
    """The sparse case's graph as plain lists (the test builds the port's
    graph from the same lists)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dims = {k: (2 if k in (4, 8) else 3) for k in range(12)}
    cards = {100: 2, 101: 2, 102: 3}
    terms = []

    def A_of(k, r, lead=()):
        return rng.normal(size=lead + (r, dims[k])) + np.eye(r, dims[k])

    terms.append(([0], [np.eye(3) * 10.0], np.zeros(3), [], 0.0))
    for i in range(11):
        ks, r = [i, i + 1], 3
        if i in (2, 6):  # binary hybrid steps: two step hypotheses
            dk = [100 if i == 2 else 101]
            terms.append((ks, [A_of(k, r, (2,)) for k in ks], rng.normal(size=(2, r)), dk,
                          np.log([1.0, 0.6])))
        elif i == 9:  # a term over two discrete keys (2 x 3 components)
            terms.append((ks, [A_of(k, r, (2, 3)) for k in ks], rng.normal(size=(2, 3, r)),
                          [100, 102], rng.normal(size=(2, 3)) * 0.1))
        else:
            terms.append((ks, [A_of(k, r) for k in ks], rng.normal(size=r), [], 0.0))
    terms.append(([0, 11], [A_of(0, 3), A_of(11, 3)], rng.normal(size=3), [], 0.0))
    discrete = [([101, 102], rng.uniform(0.1, 1.0, size=(2, 3)))]
    to_list = lambda a: np.asarray(a, dtype=np.float64).tolist()
    return dict(cont_dims={str(k): v for k, v in dims.items()},
                disc_cards={str(k): v for k, v in cards.items()},
                terms=[(ck, [to_list(a) for a in A], to_list(b), dk, to_list(ln))
                       for ck, A, b, dk, ln in terms],
                discrete=[(k, to_list(t)) for k, t in discrete])


def jax_hybrid_graph(spec):
    import jax.numpy as jnp

    from gtsam_petercdev_tpu.hybrid.hybrid import HybridGaussianFactorGraph

    dims = {int(k): v for k, v in spec["cont_dims"].items()}
    cards = {int(k): v for k, v in spec["disc_cards"].items()}
    g = HybridGaussianFactorGraph()
    for ck, A, b, dk, ln in spec["terms"]:
        ckd = [(k, dims[k]) for k in ck]
        A = [jnp.asarray(a) for a in A]
        if dk:
            g.add_hybrid(ckd, [(k, cards[k]) for k in dk], A, jnp.asarray(b),
                         log_norm=jnp.asarray(ln))
        else:
            g.add_continuous(ckd, A, jnp.asarray(b), log_norm=ln)
    for keys, t in spec["discrete"]:
        g.add_discrete([(k, cards[k]) for k in keys], jnp.asarray(t))
    return g


def switching_slice(t, xt, HG):
    """The JAX test's switching-chain slice t (tests/test_hybrid.py)."""
    import jax.numpy as jnp

    g = HG()
    if t == 0:
        g.add_continuous([(0, 1)], [jnp.asarray([[100.0]])], jnp.asarray([0.0]))
    g.add_continuous([(t, 1)], [jnp.asarray([[10.0]])], jnp.asarray([10.0 * xt]))
    if t > 0:
        A = jnp.asarray([[[-1.0]], [[-1.0]]])
        A2 = jnp.asarray([[[1.0]], [[1.0]]])
        b = jnp.asarray([[1.0], [-1.0]])
        g.add_hybrid([(t - 1, 1), (t, 1)], [(100 + t, 2)], [A, A2], b)
        g.add_discrete([(100 + t, 2)], [0.5, 0.5])
    return g


SWITCHING_XS = [0.0, 1.0, 2.0, 1.0]


def bn_dict(bn):
    import numpy as np

    asg, cont = bn.optimize()
    return dict(assignments=np.asarray(bn.assignments).tolist(),
                log_probs=np.asarray(bn.log_probs).tolist(),
                solutions=np.asarray(bn.solutions).tolist(),
                mpe={str(k): v for k, v in asg.items()},
                cont={str(k): np.asarray(v).tolist() for k, v in cont.items()})


def city_run(cfg, path):
    """The JAX harness on a written stream, with the weights of its final
    argmax recorded (its result rounds the posterior to 4 digits)."""
    import numpy as np

    from gtsam_petercdev_torch.utils.synthetic import hybrid_city_stream
    from gtsam_petercdev_tpu.models import hybrid_city as jhc

    lines, _, _ = hybrid_city_stream(cfg["n_poses"], cfg["seed"], cfg["p_ambiguous"],
                                     cfg["p_false_loop"])
    with open(path, "w") as f:
        f.write("\n".join(lines[: cfg["lines"]]) + "\n")

    class Recording:
        last = None

        def __getattr__(self, name):
            return getattr(np, name)

        def argmax(self, a, *args, **kw):
            Recording.last = np.array(a)
            return np.argmax(a, *args, **kw)

    jhc.np = Recording()
    try:
        out = jhc.run_hybrid_city(path, cfg["lines"], max_hypotheses=cfg["max_hypotheses"],
                                  progress=0)
    finally:
        jhc.np = np
    return dict(config=cfg, lines=lines[: cfg["lines"]], poses=out["poses"], modes=out["modes"],
                live_hypotheses=out["live_hypotheses"],
                posterior=np.exp(Recording.last).tolist(),
                best_loop_accept_frac=out["best_loop_accept_frac"],
                traj=np.asarray(out["traj"]).tolist())


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tempfile

    from gtsam_petercdev_tpu.hybrid.hybrid import HybridGaussianFactorGraph, eliminate_sparse
    from gtsam_petercdev_tpu.hybrid.incremental import HybridSmoother

    spec = sparse_spec()
    g = jax_hybrid_graph(spec)
    out = {"sparse": dict(spec=spec, restricted=RESTRICTED,
                          dense=bn_dict(g.eliminate()), sparse=bn_dict(eliminate_sparse(g)),
                          dense_restricted=bn_dict(g.eliminate(RESTRICTED)),
                          sparse_restricted=bn_dict(eliminate_sparse(g, RESTRICTED)))}
    runs = {}
    for name, kw in (("leaves8", dict(max_leaves=8)), ("leaves2", dict(max_leaves=2)),
                     ("sparse_route", dict(max_leaves=4, dense_dim_limit=2))):
        sm = HybridSmoother(**kw)
        for t, xt in enumerate(SWITCHING_XS):
            sm.update(switching_slice(t, xt, HybridGaussianFactorGraph))
        runs[name] = dict(kwargs=kw, **bn_dict(sm.bayes_net))
    out["smoother"] = dict(xs=SWITCHING_XS, runs=runs)
    with tempfile.TemporaryDirectory() as tmp:
        out["city"] = city_run(CITY, os.path.join(tmp, "city.txt"))
        out["city_forks"] = city_run(FORKS, os.path.join(tmp, "forks.txt"))
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
