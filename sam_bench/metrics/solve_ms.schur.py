"""solve_ms.schur: one damped landmark-Schur solve (moves iter_ms)."""

from sam_bench.readers import solve_ms_schur as read  # noqa: F401
