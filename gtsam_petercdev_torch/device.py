"""Device and dtype resolution for the port's entry points.

Every public entry point takes `device=` (default "cuda") and resolves it
here. Without a CUDA device a "cuda" request raises: nothing falls back to
the CPU unless the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return a torch.device; raise if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """torch dtype from a torch/numpy dtype or name; default float64."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    table = {"float32": torch.float32, "float64": torch.float64}
    if name not in table:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return table[name]


def check_graph_values(graph, values, device: DeviceLike) -> torch.device:
    """Resolve `device` and raise unless a graph and its Values (anything
    with a `.device`) live on its type: an entry point moves nothing."""
    dev = resolve_device(device)
    for what, d in (("graph", graph.device), ("values", values.device)):
        if d.type != dev.type:
            raise ValueError(f"{what} is on {d}, optimizer asked for {dev}")
    return dev


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless tensor `t` lives on `device` (no silent moves)."""
    if t.device.type != device.type or (
        device.index is not None and t.device.index != device.index
    ):
        raise ValueError(f"{what} is on {t.device}, expected {device}")

