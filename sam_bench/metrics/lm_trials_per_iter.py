"""lm_trials_per_iter: LM's damped trials an iteration, lm.trials (moves iter_ms)."""

from sam_bench.spans import lm_trials_per_iter as read  # noqa: F401
