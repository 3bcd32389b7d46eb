"""device_ms.linearize: device time under the port's linearize span an iteration (moves iter_ms)."""

from sam_bench.spans import device_ms_linearize as read  # noqa: F401
