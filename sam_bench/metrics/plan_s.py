"""plan_s: host planning in the traced set-up (moves setup_s)."""

from sam_bench.readers import plan_s as read  # noqa: F401
