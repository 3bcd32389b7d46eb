from gtsam_petercdev_torch.sam.factors import (  # noqa: F401
    bearing_factor_2d,
    bearing_factor_3d,
    bearing_range_factor_2d,
    range_factor,
)
