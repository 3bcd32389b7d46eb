"""idle_ms.lm: idle under LM's own code, lm.iteration / lm.trial (moves iter_ms)."""

from sam_bench.spans import idle_ms_lm as read  # noqa: F401
