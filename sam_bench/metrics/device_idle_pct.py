"""device_idle_pct: the device's idle share of a profiled solve (moves iter_ms)."""

from sam_bench.readers import device_idle_pct as read  # noqa: F401
