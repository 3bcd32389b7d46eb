"""Runtime string-keyed debug flags (reference: gtsam/base/debug.h:45-60,
ISDEBUG macro / debugFlags map). Port of gtsam_petercdev_tpu/utils/debug.py."""

from __future__ import annotations

from typing import Dict

_flags: Dict[str, bool] = {}


def set_debug_flag(name: str, value: bool = True):
    _flags[name] = value


def is_debug(name: str) -> bool:
    return _flags.get(name, False)


def clear_debug_flags():
    _flags.clear()
