"""idle_ms.multifrontal: idle under the multifrontal span (moves iter_ms)."""

from sam_bench.spans import idle_ms_multifrontal as read  # noqa: F401
