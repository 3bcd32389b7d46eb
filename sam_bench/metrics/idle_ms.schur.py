"""idle_ms.schur: device idle time under the schur span an iteration (moves iter_ms)."""

from sam_bench.spans import idle_ms_schur as read  # noqa: F401
