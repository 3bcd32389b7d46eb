"""solve_ms.multifrontal: one damped multifrontal solve (moves iter_ms)."""

from sam_bench.readers import solve_ms_multifrontal as read  # noqa: F401
