"""The inputs a generator makes: one problem in the port's numpy carry-across
format (`gtsam_petercdev_torch/utils/convert.py`) and in the reference's."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Problem:
    # {type name: (keys [N] uint64, params)}: the start values
    values: Dict[str, Tuple[np.ndarray, object]]
    # [(factor type name, keys [N, K], params, sqrt_info [N, d, d])]
    factors: List[tuple]
    # the same problem as plain arrays, for the reference
    arrays: Dict[str, np.ndarray]
