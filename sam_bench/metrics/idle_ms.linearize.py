"""idle_ms.linearize: device idle time under the linearize span an iteration (moves iter_ms)."""

from sam_bench.spans import idle_ms_linearize as read  # noqa: F401
