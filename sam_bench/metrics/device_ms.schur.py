"""device_ms.schur: device time under the schur span an iteration (moves iter_ms)."""

from sam_bench.spans import device_ms_schur as read  # noqa: F401
