"""bucket_kernels_roofline: K1-K4's share of their roofline (moves iter_ms)."""

from sam_bench.readers import bucket_kernels_roofline as read  # noqa: F401
