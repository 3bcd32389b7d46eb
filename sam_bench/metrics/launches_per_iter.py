"""launches_per_iter: CUDA kernel launches an LM iteration (moves iter_ms)."""

from sam_bench.readers import launches_per_iter as read  # noqa: F401
