"""bad_pivot_trials_per_iter: trials rejected for clamped pivots an iteration (moves iter_ms)."""

from sam_bench.spans import bad_pivot_trials_per_iter as read  # noqa: F401
