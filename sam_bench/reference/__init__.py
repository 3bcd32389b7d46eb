"""Plain PyTorch reference of the benchmark's problems, written afresh.

It imports neither JAX, the JAX package nor anything of the port, and takes
nothing the port made: it builds its own problem from a generator's numpy
arrays, linearizes it, solves it densely and runs Levenberg-Marquardt with
the semantics of GTSAM's LevenbergMarquardtOptimizer as the port states
them (lm.py). The problem module (`ba`) has
`Problem(arrays, device, dtype)`; a configuration names its module.
"""
