"""device_ms.multifrontal_glue: multifrontal device time less K1-K4 (moves iter_ms)."""

from sam_bench.spans import device_ms_multifrontal_glue as read  # noqa: F401
