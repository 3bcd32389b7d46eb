"""host_reads_per_iter: LM's device-to-host scalar reads an iteration (moves iter_ms)."""

from sam_bench.spans import host_reads_per_iter as read  # noqa: F401
