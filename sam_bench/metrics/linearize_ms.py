"""linearize_ms: one linearization of the start (moves iter_ms)."""

from sam_bench.readers import linearize_ms as read  # noqa: F401
